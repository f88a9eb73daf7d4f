"""Config registry of the port: ``get_config(arch_id)``, ``list_archs()``
and the input shapes (counterpart of ``repro/configs/__init__.py``).

The port serves the dense GQA decoders and the Zamba2 hybrid; every other
architecture of the reference waits for its own slice (``ROADMAP.md``,
Queue 1 item 6).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      UNetConfig)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "UNetConfig",
           "get_config", "list_archs"]

_ARCH_MODULES = {
    "yi-6b": "yi_6b",
    "granite-3-8b": "granite_3_8b",
    "glm4-9b": "glm4_9b",
    "minicpm-2b": "minicpm_2b",
    "zamba2-7b": "zamba2_7b",
}


def list_archs():
    """The LM architectures the port supports."""
    return list(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"arch {arch_id!r} is not in the port; it has "
                       f"{sorted(_ARCH_MODULES)} (the other families wait "
                       "for ROADMAP.md Queue 1 item 6)")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}").CONFIG
