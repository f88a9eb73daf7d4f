"""MusicGen-large decoder over EnCodec tokens [arXiv:2306.05284].

The EnCodec tokenizer / mel frontend is a STUB: inputs are audio codebook
tokens (vocab 2048) plus precomputed conditioning embeddings consumed through
per-layer cross-attention (the T5 text encoder of the paper is stubbed as
``cond_embeds`` in input_specs).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    rope_theta=10_000.0,
    cross_attention=True,
    n_cond_tokens=64,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="[arXiv:2306.05284] MusicGen-large decoder",
).validate()
