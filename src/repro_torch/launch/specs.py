"""Serving shapes (counterpart of ``serve_window`` in
``repro/launch/specs.py``).  Training needs no input specs here: it runs
eagerly on one card through ``launch/steps.py``'s ``make_train_step`` and
``launch/train.py``.  The abstract input specs of the TPU dry run wait for
the DTensor mesh, ROADMAP.md Queue 1 item 4.5."""
from __future__ import annotations

from repro_torch.configs import InputShape, ModelConfig


def serve_window(cfg: ModelConfig, shape: InputShape) -> int:
    """Sliding-window size for this (arch, shape) pair (0 = full attention).

    long_500k needs sub-quadratic serving: SSM/hybrid archs are natively
    O(1)-state (the hybrid's shared attention blocks still window); every
    other family serves long_500k with the sliding-window variant.
    """
    if shape.name != "long_500k":
        return 0
    if cfg.family == "ssm":
        return 0                      # no attention at all
    return cfg.sliding_window or 8192
