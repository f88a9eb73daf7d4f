"""The paper U-Net's configuration.

A copy of ``UNetConfig`` from the reference (``repro/configs/base.py``): the
port keeps its own so that it imports nothing of ``repro``.  The LM
``ModelConfig`` arrives with the LM slice.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """The paper's own DDPM backbone (U-Net w/ ResNet blocks + self-attention)."""

    arch_id: str = "paper-unet"
    family: str = "unet"
    image_size: int = 128
    in_channels: int = 1
    base_channels: int = 64
    channel_mults: Tuple[int, ...] = (1, 2, 4, 8)
    n_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    time_dim: int = 256
    norm_groups: int = 8
    dropout: float = 0.0
    dtype: str = "float32"
    # classifier-free guidance: 0 = unconditional (classic); N > 0 adds an
    # (N+1)-row class embedding to the time embedding, row N being the
    # null label
    num_classes: int = 0
    source = "CollaFuse §4 (Ronneberger'15 U-Net + He'16 ResNet + Vaswani'17 attn)"

    def reduced(self) -> "UNetConfig":
        return dataclasses.replace(
            self, image_size=16, base_channels=16, channel_mults=(1, 2),
            n_res_blocks=1, attn_resolutions=(8,), time_dim=64, norm_groups=4)
