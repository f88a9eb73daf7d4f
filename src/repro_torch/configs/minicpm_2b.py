"""MiniCPM-2B llama-like dense decoder, WSD schedule [arXiv:2404.06395].

36 heads (MHA: kv=36).  The WSD (warmup-stable-decay) schedule from the paper
is ``repro_torch.optim.schedule.wsd``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122_753,
    rope_theta=10_000.0,
    tie_embeddings=True,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="[arXiv:2404.06395] MiniCPM; WSD schedule in repro.optim",
).validate()
