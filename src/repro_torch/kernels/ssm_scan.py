"""Mamba2 (SSD) chunked scan for Hopper: the ctypes binding of
``csrc/ssm_scan.cu``, its raw launcher, its grid and its operation and
byte counts.

Counterpart of ``repro/kernels/ssm_scan.py``.  The kernel replaces the
Pallas ``ssm_scan`` (``repro/kernels/ssm_scan.py:84``, body
``_ssd_kernel``); its source's header gives the contract, the design and
the bound.  A call runs two kernels on the current stream: one that writes
a record per (chunk, batch) into a float32 scratch (G = C·Bᵀ, once for
every head, with C and B, padded to the scan's layout), and the scan, one
block per (head, batch), each walking its head's chunks in order with its
four products on the tensor cores in 3xTF32 (float32 accuracy; never
plain TF32).  Call it through :func:`repro_torch.kernels.ops.ssm_scan`,
which checks its inputs, runs the plain version
(:func:`repro_torch.kernels.ref.ssm_scan_ref`) for CPU tensors, and counts
each call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["CHUNK", "DTYPES", "MAX_WIDTH", "blocks_per_sm",
           "grid_for", "launch_ssm_scan", "scratch_numel", "sm_count",
           "smem_bytes", "ssd_flops", "ssd_flops_executed", "ssd_bytes"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 64          # the kernel's own chunk (kL in the source)
MAX_WIDTH = 64      # the widest N and P a block's tiles hold (kD)
WARP_ROWS = 16      # the chunk rows of one warp's band in W·X


def _lib():
    lib = build.load("ssm_scan")
    fn = lib.ssm_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.ssm_scan_smem_bytes.restype = ctypes.c_int
        lib.ssm_scan_blocks_per_sm.argtypes = [i, i]
        lib.ssm_scan_blocks_per_sm.restype = ctypes.c_int
    return lib


def grid_for(b: int, nh: int):
    """The scan kernel's grid: (heads, batch), one block a head."""
    return (nh, b)


def scratch_numel(b: int, s: int) -> int:
    """float32 elements of the scratch of one call: a record per (batch,
    chunk) of G, C and B, each CHUNK rows padded to 68, 68 and 72 floats
    (``kRec`` in the source)."""
    return b * -(-s // CHUNK) * CHUNK * (68 + 68 + 72)


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def smem_bytes() -> int:
    """Dynamic shared memory of one scan block (built on first use)."""
    return _lib().ssm_scan_smem_bytes()


def blocks_per_sm(dtype, dt_dtype) -> int:
    """Scan blocks resident on one SM, from the CUDA occupancy API, for
    x's and dt's dtypes."""
    n = _lib().ssm_scan_blocks_per_sm(DTYPES[dtype], DTYPES[dt_dtype])
    if n <= 0:
        raise RuntimeError(f"ssm_scan: occupancy query failed with "
                           f"cudaError {-n}")
    return n


def launch_ssm_scan(x, dt, a, bm, cm, y) -> None:
    """Launch the kernels on the current stream (built on first use);
    raises if a launch fails.  The tensors are as :func:`repro_torch.kernels
    .ops.ssm_scan` checks them: CUDA, contiguous; x and y (B, S, nh, P) in
    one dtype of :data:`DTYPES`, y 16-byte aligned, bm and cm (B, S, N) in
    x's dtype, dt (B, S, nh) in float32 or x's dtype, a (nh,) float32; P,
    N <= :data:`MAX_WIDTH`."""
    b, s, nh, p = x.shape
    n = bm.shape[-1]
    fn = _lib().ssm_scan
    g = torch.empty(scratch_numel(b, s), dtype=torch.float32,
                    device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(DTYPES[x.dtype], DTYPES[dt.dtype], x.data_ptr(),
                 dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                 g.data_ptr(), y.data_ptr(), b, s, nh, p, n, stream)
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
    """The operations the kernels execute, counted as float32 multiply-adds
    (2 each; the tensor cores run each product three times, in 3xTF32),
    padding included: per (batch, chunk of :data:`CHUNK`) the 136
    lower-triangle 4x4 tiles of G (2·N a product); per head and chunk, on
    P and N padded to :data:`MAX_WIDTH`, W·X over whole 16-row bands (band
    w sees 16(w + 1) keys), C·state, the state update over every step of
    the chunk, and the state's decay.  Its achieved rate is read against
    this count."""
    b, s, nh, _ = x.shape
    n = bm.shape[-1]
    d = MAX_WIDTH
    bands = sum(WARP_ROWS * WARP_ROWS * (w + 1)
                for w in range(CHUNK // WARP_ROWS))
    per_head = d * (2 * bands + 4 * CHUNK * d + d)
    return b * -(-s // CHUNK) * (136 * 16 * 2 * n + nh * per_head)


def ssd_bytes(x, dt, a, bm, cm) -> int:
    """Device-memory bytes of one call: x, dt, a, bm and cm read once, y
    (x's shape and dtype) written once."""
    return (2 * x.numel() * x.element_size()
            + sum(t.numel() * t.element_size() for t in (dt, a, bm, cm)))
