"""Granite-3.0-8B dense GQA decoder [hf:ibm-granite/granite-3.0-2b-base family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49_155,
    rope_theta=10_000.0,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="[hf:ibm-granite/granite-3.0-8b-base] GQA kv=8",
).validate()
