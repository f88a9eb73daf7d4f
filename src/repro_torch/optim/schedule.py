"""LR schedules: constant, cosine, and WSD (warmup-stable-decay) from
MiniCPM [arXiv:2404.06395] (counterpart of ``repro/optim/schedule.py``).

Each schedule is a function of the int32 step tensor that returns a
float32 scalar tensor on the step's device, the multiplier of the peak lr
that :func:`repro_torch.optim.adamw.apply_updates` and ``apply_updates_``
take as ``schedule``.  The reference's float32 expressions are kept in its
order, so the values are its bits, but for ``cos``, which the two
libraries may round differently.
"""
from __future__ import annotations

import math

import torch


def constant():
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=step.device)


def cosine(total_steps: int, warmup: int = 0, final_frac: float = 0.1):
    def fn(step):
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return warm * cos
    return fn


def wsd(total_steps: int, warmup_frac: float = 0.01, decay_frac: float = 0.1,
        final_frac: float = 0.1):
    """Warmup-Stable-Decay: linear warmup, a long stable plateau at the
    peak lr, a short (here linear) decay tail (MiniCPM §4)."""
    warmup = max(1, int(total_steps * warmup_frac))
    decay_start = int(total_steps * (1 - decay_frac))

    def fn(step):
        s = step.to(torch.float32)
        warm = torch.clamp(s / warmup, max=1.0)
        decay = torch.where(
            s <= decay_start, 1.0,
            1.0 - (1 - final_frac) * torch.clamp(
                (s - decay_start) / max(total_steps - decay_start, 1),
                0.0, 1.0))
        return warm * decay
    return fn


def get_schedule(name: str, total_steps: int, **kw):
    if name == "constant":
        return constant()
    if name == "cosine":
        return cosine(total_steps, **kw)
    if name == "wsd":
        return wsd(total_steps, **kw)
    raise ValueError(name)
