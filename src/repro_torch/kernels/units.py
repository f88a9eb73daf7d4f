"""How a work counter sees a kernel wrapper's call as one unit.

A work counter (``launch/counter.py``'s ``WorkCounter``) is a
``TorchDispatchMode`` with ``counts_kernel_units = True`` and a
``unit(name, key, work)`` context.  :func:`active` finds the innermost
such mode; a wrapper of :mod:`repro_torch.kernels.ops` asks it first and
builds the unit's key and formulas only when it gets one, so without a
counter a call costs one look at the length of the dispatch-mode stack.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def active() -> Optional[torch.utils._python_dispatch.TorchDispatchMode]:
    """The innermost active dispatch mode that counts kernel units, or
    None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "counts_kernel_units", False):
            return mode
    return None
