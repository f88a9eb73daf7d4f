"""The CollaFuse paper's own backbone: U-Net DDPM (§4).

U-Net with ResNet blocks for down/up-sampling and self-attention feature
refinement; cosine variance schedule, T=100, 128x128 grayscale MRI.
"""
from repro_torch.configs.base import UNetConfig

CONFIG = UNetConfig()
