"""Qwen2-VL-2B backbone [arXiv:2409.12191] — M-RoPE, dynamic-resolution ViT stub.

The vision encoder is a STUB: ``input_specs`` supplies precomputed patch
embeddings of shape (batch, n_vision_tokens, d_model); this config defines the
language/decoder transformer that consumes them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),      # (t, h, w) split of head_dim/2 = 64
    n_vision_tokens=256,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="[arXiv:2409.12191] Qwen2-VL; M-RoPE sections per model card",
).validate()
