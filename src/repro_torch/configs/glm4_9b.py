"""GLM-4-9B dense GQA decoder [hf:THUDM/glm-4-9b]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151_552,
    rope_theta=10_000.0,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="[hf:THUDM/glm-4-9b] RoPE, GQA kv=2",
).validate()
