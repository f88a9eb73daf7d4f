"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2].

Per the assigned paper-table config: 61L, d_model=7168, 64 heads (GQA kv=8),
expert d_ff=2048, vocab 163840, 384 routed experts top-8.  One shared expert
(Kimi K2 model card); first layer dense (DeepSeek-V3-style stack).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,                  # dense first-layer ffn (K2 card)
    vocab_size=163_840,
    rope_theta=50_000.0,
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    d_ff_expert=2048,
    first_dense=1,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="[arXiv:2501.kimi2] Kimi K2 paper table",
).validate()
