"""Mamba2 (SSD) chunked scan for Hopper: the ctypes binding of
``csrc/ssm_scan.cu``, its raw launcher, its head-block choice and its
operation and byte counts.

Counterpart of ``repro/kernels/ssm_scan.py``.  The kernel replaces the
Pallas ``ssm_scan`` (``repro/kernels/ssm_scan.py:84``, body
``_ssd_kernel``); its source's header gives the contract, the design and
the bound.  Call it through :func:`repro_torch.kernels.ops.ssm_scan`, which
checks its inputs, runs the plain version
(:func:`repro_torch.kernels.ref.ssm_scan_ref`) for CPU tensors, and counts
each launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["CHUNK", "DTYPES", "MAX_WIDTH", "launch_ssm_scan", "head_block_for",
           "sm_count", "ssd_flops", "ssd_flops_executed", "ssd_bytes"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 64          # the kernel's own chunk (kL in the source)
MAX_WIDTH = 64      # the widest N and P a block's tiles hold (kD)


def _lib():
    fn = build.load("ssm_scan").ssm_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def head_block_for(b: int, nh: int, head_block: int, n_sm: int) -> int:
    """The heads a block of the kernel takes: the largest divisor of nh not
    above ``head_block`` that still gives the grid two blocks per SM (1 when
    none does).  More heads a block share more of G = C·Bᵀ; more blocks
    fill the card."""
    hb = max(1, min(head_block, nh))
    while hb > 1 and (nh % hb or b * (nh // hb) < 2 * n_sm):
        hb -= 1
    return hb


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_ssm_scan(x, dt, a, bm, cm, y, *, head_block: int) -> None:
    """Launch the kernel on the current stream (built on first use); raises
    if the launch fails.  The tensors are as :func:`repro_torch.kernels.ops
    .ssm_scan` checks them: CUDA, contiguous; x and y (B, S, nh, P) in one
    dtype of :data:`DTYPES`, bm and cm (B, S, N) in x's dtype, dt (B, S, nh)
    in float32 or x's dtype, a (nh,) float32; P, N <= :data:`MAX_WIDTH`;
    ``head_block`` divides nh."""
    b, s, nh, p = x.shape
    n = bm.shape[-1]
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(DTYPES[x.dtype], DTYPES[dt.dtype], x.data_ptr(),
                 dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                 y.data_ptr(), b, s, nh, p, n, head_block, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan: CUDA launch failed with cudaError "
                           f"{err}")


def _chunked_flops(s: int, nh: int, p: int, n: int, chunk: int, *,
                   least: bool) -> int:
    """Operations of one batch row's chunked SSD form at chunk length
    ``chunk``: per chunk of length L, G = C·Bᵀ once (2·L²·N, shared by every
    head, n_groups = 1); per head the causal W·X (2·P on each of the
    L(L+1)/2 visible pairs), C·state and the state update (2·L·N·P each) and
    the state's decay (N·P).  ``least`` drops what the function does not
    need: C·state in the first chunk (the state is zero) and the update and
    decay in the last (nothing reads that state)."""
    total = 0
    last = (s - 1) // chunk
    for k, lo in enumerate(range(0, s, chunk)):
        ln = min(chunk, s - lo)
        reads = not least or k > 0
        writes = not least or k < last
        total += 2 * ln * ln * n + nh * (
            ln * (ln + 1) * p + 2 * ln * n * p * (reads + writes)
            + n * p * (reads and writes))
    return total


def ssd_flops(x, bm) -> int:
    """The least operations the function needs: the chunked form's count
    (:func:`_chunked_flops`) at the chunk length that minimises it.
    Chunking is exact, so any chunk computes the same y; the count falls
    from the step recurrence's ~5·N·P a step and head (L = 1) to a minimum
    near L = sqrt(N·P / (P + 2·N/nh)) (8 at Zamba2's N = P = 64), then grows
    with the causal W·X.  The elementwise weights (exp, dt) are not
    counted.  This is the count ``bound_ms`` divides."""
    b, s, nh, p = x.shape
    n = bm.shape[-1]
    return b * min(_chunked_flops(s, nh, p, n, c, least=True)
                   for c in range(1, s + 1))


def ssd_flops_executed(x, bm) -> int:
    """The operations the kernel executes: the chunked form at its own
    chunk (:data:`CHUNK`), every term in every chunk.  Its achieved rate is
    read against this count."""
    b, s, nh, p = x.shape
    return b * _chunked_flops(s, nh, p, bm.shape[-1], CHUNK, least=False)


def ssd_bytes(x, dt, a, bm, cm) -> int:
    """Device-memory bytes of one call: x, dt, a, bm and cm read once, y
    (x's shape and dtype) written once."""
    return (2 * x.numel() * x.element_size()
            + sum(t.numel() * t.element_size() for t in (dt, a, bm, cm)))
