"""Yi-6B llama-arch GQA decoder [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="[arXiv:2403.04652] Yi-6B GQA kv=4",
).validate()
