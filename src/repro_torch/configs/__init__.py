"""Config registry of the port: ``get_config(arch_id)``, ``list_archs()``
and the input shapes (counterpart of ``repro/configs/__init__.py``).

The port serves the dense GQA decoders, the Zamba2 hybrid and the MoE
family (DeepSeek-V2 with MLA, Kimi-K2 with GQA), and registers the paper
U-Net's config; every other architecture of the reference waits for its
own slice (``ROADMAP.md``, Queue 1 item 4).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      UNetConfig)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "UNetConfig",
           "get_config", "list_archs"]

# the reference's order, less the architectures not ported yet
_ARCH_MODULES = {
    "granite-3-8b": "granite_3_8b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "glm4-9b": "glm4_9b",
    "minicpm-2b": "minicpm_2b",
    "zamba2-7b": "zamba2_7b",
    "yi-6b": "yi_6b",
    "paper-unet": "paper_unet",
}


def list_archs(include_unet: bool = False):
    """The LM architectures the port supports, and the paper U-Net's
    ``paper-unet`` last when ``include_unet``."""
    archs = [a for a in _ARCH_MODULES if a != "paper-unet"]
    if include_unet:
        archs.append("paper-unet")
    return archs


def get_config(arch_id: str):
    """The ``ModelConfig`` of an LM, or the ``UNetConfig`` of
    ``paper-unet``."""
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"arch {arch_id!r} is not in the port; it has "
                       f"{sorted(_ARCH_MODULES)} (the other families wait "
                       "for ROADMAP.md Queue 1 item 4)")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}").CONFIG
