"""Flash attention for Hopper: the ctypes binding of
``csrc/flash_attention.cu`` and its raw launcher.

Counterpart of ``repro/kernels/flash_attention.py``.  The kernel replaces
the Pallas ``flash_attention`` (``repro/kernels/flash_attention.py:124``,
body ``_attn_kernel``); its source's header gives the contract, the design
and the bound.  Call it through :func:`repro_torch.kernels.ops
.flash_attention`, which checks its inputs, runs the plain version
(:func:`repro_torch.kernels.ref.attention_ref`) for CPU tensors, and counts
each launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["DTYPES", "HEAD_DIMS", "BLOCK_Q", "BLOCK_K", "F32_BLOCK_K",
           "F32_WARP_ROWS", "MAX_WORK_ITEMS", "launch_flash_attention",
           "bf16_smem_bytes", "f32_smem_bytes", "visible_pairs", "key_tiles",
           "attention_flops", "attention_flops_executed",
           "attention_flops_executed_f32", "attention_bytes"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 112, 128)
BLOCK_Q = 128       # query positions of one q head an item (kBM), both dtypes
BLOCK_K = 128       # bf16: keys a tile (kBN)
F32_BLOCK_K = 32    # f32: keys a tile (kF32Keys)
F32_WARP_ROWS = 16  # f32: query rows a consumer warp
MAX_WORK_ITEMS = 2 ** 31 - 1  # (q tile, head) items, an int: the bf16
#                               instance's persistent walk, the f32 grid.x
TENSOR_MAP_ERROR = 10000  # the source's kTensorMapError


def _lib():
    fn = build.load("flash_attention").flash_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i,
                       p]
        fn.restype = ctypes.c_int
    return fn


def bf16_smem_bytes(hd: int) -> int:
    """The bfloat16 kernel's dynamic shared memory at head dim ``hd``: q, the
    ring of K and V stages, the mbarriers (from the built library)."""
    fn = build.load("flash_attention").flash_attention_bf16_smem
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(hd)


def f32_smem_bytes(hd: int) -> int:
    """The float32 kernel's dynamic shared memory at head dim ``hd``: q's
    fragments, the ring of K and V hi/lo planes and its mbarriers (from
    the built library)."""
    fn = build.load("flash_attention").flash_attention_f32_smem
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(hd)


def launch_flash_attention(q, k, v, out, *, scale: float, causal: bool,
                           window: int) -> None:
    """Launch the kernel on the current stream (built on first use); raises
    if the launch fails.  The tensors are as :func:`repro_torch.kernels.ops
    .flash_attention` checks them: CUDA, contiguous, 16-byte aligned, one
    dtype of :data:`DTYPES`; q and out (B, Sq, H, hd), k and v
    (B, Skv, KV, hd), hd in :data:`HEAD_DIMS`."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b, sq, skv, h, kvh,
                 float(scale), int(bool(causal)), int(window), stream)
    if err >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed "
                           f"with CUresult {err - TENSOR_MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"cudaError {err}")


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps, row i and key j counted from 0."""
    total = 0
    for i in range(sq):
        hi = min(i, skv - 1) if causal else skv - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def attention_flops(q, k, *, causal: bool = True, window: int = 0) -> int:
    """Operations of one call on the visible (query, key) pairs: 2·hd for
    q·k and 2·hd for p·v, per pair and query head."""
    b, sq, h, hd = q.shape
    return 4 * hd * b * h * visible_pairs(sq, k.shape[1], causal, window)


def key_tiles(pos0: int, sq: int, skv: int, causal: bool, window: int,
              rows: int, keys: int):
    """[begin, end): the key tiles of ``keys`` keys that the kernel visits
    for the q tile of ``rows`` positions starting at ``pos0`` (the source's
    ``key_tiles`` with G = 1)."""
    pos_hi = min(pos0 + rows, sq) - 1
    end = -(-skv // keys)
    if causal:
        end = min(end, pos_hi // keys + 1)
    begin = (pos0 - window + 1) // keys if window and pos0 - window + 1 > 0 \
        else 0
    return begin, end


def _tile_pairs(sq: int, skv: int, causal: bool, window: int, rows: int,
                keys: int) -> int:
    """(query tile of ``rows``, key tile of ``keys``) pairs in range."""
    return sum(max(0, hi - lo) for lo, hi in (
        key_tiles(pos0, sq, skv, causal, window, rows, keys)
        for pos0 in range(0, sq, rows)))


def attention_flops_executed(q, k, *, causal: bool = True, window: int = 0,
                             rows: int = BLOCK_Q, keys: int = BLOCK_K) -> int:
    """Operations the bf16 kernel executes: the (q tile, key tile) pairs it
    visits, times 2·rows·keys·(hd + N) a pair: q·kᵀ at depth hd and p·v at
    width N = max(hd, 64) over whole tiles, masked entries included (hd 32
    runs p·v at 64).  Its achieved rate is read against this count;
    :func:`attention_flops` is the least work."""
    b, sq, h, hd = q.shape
    pairs = _tile_pairs(sq, k.shape[1], causal, window, rows, keys)
    return 2 * rows * keys * (hd + max(hd, 64)) * b * h * pairs


def attention_flops_executed_f32(q, k, *, causal: bool = True,
                                 window: int = 0) -> int:
    """Operations the float32 kernel executes: each consumer warp's
    :data:`F32_WARP_ROWS` rows (inside Sq) visit the tiles of
    :data:`F32_BLOCK_K` keys in their causal and window range
    (:func:`key_tiles`), at 2·rows·keys·2·hd a tile (q·kᵀ at depth hd, p·v
    at width hd), masked entries included; each runs as three TF32
    products."""
    b, sq, h, hd = q.shape
    rows, keys = F32_WARP_ROWS, F32_BLOCK_K
    pairs = _tile_pairs(sq, k.shape[1], causal, window, rows, keys)
    return 2 * rows * keys * 2 * hd * b * h * pairs


def attention_bytes(q, k, v) -> int:
    """Device-memory bytes of one call: q, k and v read once, the output
    (q's shape and dtype) written once."""
    return (2 * q.numel() * q.element_size() + k.numel() * k.element_size()
            + v.numel() * v.element_size())
