"""Prefill and decode step functions (counterpart of ``make_prefill_step``
and ``make_decode_step`` in ``repro/launch/steps.py``, without the
sharding plumbing: one card, PyTorch runs eagerly)."""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import transformer as tf


def make_prefill_step(cfg: ModelConfig, *, window: int = 0,
                      kernel: str = "flash"):
    """``prefill_step(params, batch) -> logits (B, S, V)`` under
    ``torch.inference_mode``; ``kernel`` picks the attention core
    (``"flash"``: the CUDA kernel, ``"torch"``: blockwise PyTorch)."""
    def prefill_step(params, batch):
        with torch.inference_mode():
            return tf.prefill(params, batch, cfg, window=window,
                              kernel=kernel)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, window: int = 0):
    """``decode_step(params, cache, batch, pos) -> (logits, cache)`` under
    ``torch.inference_mode``; the cache is written in place."""
    def decode_step(params, cache, batch, pos):
        with torch.inference_mode():
            return tf.decode_step(params, cache, batch, pos, cfg,
                                  window=window)
    return decode_step
