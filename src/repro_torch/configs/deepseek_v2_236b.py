"""DeepSeek-V2 236B MoE with MLA [arXiv:2405.04434].

MLA: kv_lora_rank=512, q_lora_rank=1536, qk_nope=128, qk_rope=64, v_head=128.
MoE: 2 shared + 160 routed experts, top-6, expert d_ff=1536; first layer dense.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,                # qk_nope + qk_rope (MLA effective)
    d_ff=12288,                  # dense first-layer ffn
    vocab_size=102_400,
    rope_theta=10_000.0,
    attn_type="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1536,
    first_dense=1,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="[arXiv:2405.04434] DeepSeek-V2 §2",
).validate()
