"""xLSTM-125M: mLSTM + sLSTM blocks [arXiv:2405.04517].

12 blocks, every 4th block is sLSTM (xLSTM[7:1]-like ratio), rest mLSTM.
d_ff=0: the blocks carry their own up/down projections.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    slstm_every=4,
    long_context_mode="native",
    source="[arXiv:2405.04517] xLSTM; sLSTM+mLSTM mix",
).validate()
