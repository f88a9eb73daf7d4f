"""Config registry of the port: ``get_config(arch_id)``, ``list_archs()``
and the input shapes (counterpart of ``repro/configs/__init__.py``).

The port registers every architecture of the reference, in its order: the
dense GQA decoders, Qwen2-VL (vlm), the MoE family (DeepSeek-V2 with MLA,
Kimi-K2 with GQA), MusicGen (audio), the Zamba2 hybrid and xLSTM (ssm),
and the paper U-Net's config.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      UNetConfig)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "UNetConfig",
           "get_config", "list_archs"]

# the reference's order
_ARCH_MODULES = {
    "qwen2-vl-2b": "qwen2_vl_2b",
    "granite-3-8b": "granite_3_8b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "glm4-9b": "glm4_9b",
    "minicpm-2b": "minicpm_2b",
    "musicgen-large": "musicgen_large",
    "zamba2-7b": "zamba2_7b",
    "xlstm-125m": "xlstm_125m",
    "yi-6b": "yi_6b",
    "paper-unet": "paper_unet",
}


def list_archs(include_unet: bool = False):
    """The LM architectures, and the paper U-Net's ``paper-unet`` last
    when ``include_unet``."""
    archs = [a for a in _ARCH_MODULES if a != "paper-unet"]
    if include_unet:
        archs.append("paper-unet")
    return archs


def get_config(arch_id: str):
    """The ``ModelConfig`` of an LM, or the ``UNetConfig`` of
    ``paper-unet``."""
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}").CONFIG
