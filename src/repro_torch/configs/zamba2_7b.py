"""Zamba2-7B hybrid: Mamba2 backbone + shared attention block [arXiv:2411.15242].

81 Mamba2 layers with ONE weight-shared attention block applied every 6 layers
(the Zamba2 shared-block pattern).  ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_heads=112,          # d_inner / ssm_head_dim = 7168/64
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    attn_every=6,
    long_context_mode="native",
    sliding_window=8192,    # shared attn blocks use SWA for long_500k
    source="[arXiv:2411.15242] Zamba2; shared attn every 6 Mamba2 blocks",
).validate()
