"""Fused DDPM denoise-update kernels for Hopper, and their coefficient helpers.

Counterpart of ``repro/kernels/ddpm_step.py``.  Two kernels:

* ``ddpm_step`` — the unmasked fused update
  ``(x − c_eps·ε̂)·inv_sa + keep·σ·z`` with per-sample (B, 4) coefficients
  (c_eps, 1/√ar, σ, keep).  A Triton kernel (``_step_kernel``) replacing the
  Pallas ``ddpm_step`` (``repro/kernels/ddpm_step.py:78``, body
  ``_step_kernel``).  Bound by memory: per sample it reads 4 scalars and
  streams 3 tensors into 1 (16 bytes and 5 flops per f32 element), with no
  tensor-core work, no reuse and no state across blocks — a pure elementwise
  pass, for which Triton serves as well as CUDA C++.  Each program loads its
  sample's four coefficients as scalars and one block of each stream
  (:func:`step_shape`); floating-point contraction is off so products and
  sums round as in the plain version.
* ``traj_masked_step`` — the serving engine's whole masked tick
  (column gather, update, clip, active select) in one pass.  CUDA C++ in
  ``csrc/traj_masked_step.cu`` (see its header for the design), replacing
  the Pallas ``traj_masked_step`` (``repro/kernels/ddpm_step.py:206``).

This module holds the kernels and their raw launchers, which take checked
CUDA tensors and count nothing.  Call them through the wrappers in
:mod:`repro_torch.kernels.ops`, which check their inputs, run the plain
version (:mod:`repro_torch.kernels.ref`) for CPU tensors, and count each
launch.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.diffusion.schedule import ancestral_pair_coefs
from repro_torch.kernels import build

__all__ = ["launch_ddpm_step", "launch_traj_masked_step", "ddpm_step_coefs",
           "masked_step_tables", "index_step_coefs", "masked_step_bytes",
           "lane_meta", "step_shape"]

# ddpm_step's launch shape: (elements a program, warps a program).  1024
# elements on 4 warps, one 16-byte vector a stream a thread in bf16, two in
# float32.  Where that grid is smaller than the card (S = 8 lanes of 16,384:
# 128 programs on 132 SMs), float32 takes one warp of 512 elements (four
# vectors a thread, 256 programs), which reaches the stream floor; two warps
# of 512 do not, and bf16 is at its stream floor already (PERF.md).
STEP_SHAPE = (1024, 4)
STEP_SHAPE_SMALL_F32 = (512, 1)
_SM_COUNT: Dict[torch.device, int] = {}


def step_shape(x: torch.Tensor) -> Tuple[int, int]:
    """(elements a program, warps a program) of ddpm_step over (B, ...) x,
    a CUDA tensor."""
    b = x.shape[0]
    d = x.numel() // b
    if x.dtype == torch.float32:
        if x.device not in _SM_COUNT:
            _SM_COUNT[x.device] = torch.cuda.get_device_properties(
                x.device).multi_processor_count
        if -(-d // STEP_SHAPE[0]) * b < _SM_COUNT[x.device]:
            return STEP_SHAPE_SMALL_F32
    return STEP_SHAPE


# ---------------------------------------------------------------------------
# coefficient helpers
# ---------------------------------------------------------------------------
def ddpm_step_coefs(sched, t: torch.Tensor) -> torch.Tensor:
    """Per-sample coefficients for timesteps t: (B,) -> (B, 4) f32 =
    (c_eps, 1/√α, σ, keep), on t's device."""
    s = sched.to(t.device)
    ti = t.to(torch.int64) - 1
    c_eps = s.betas[ti] / s.sqrt_one_minus_alpha_bar[ti]
    inv_sa = torch.rsqrt(s.alphas[ti])
    sigma = torch.sqrt(s.posterior_var[ti])
    keep = (ti > 0).to(torch.float32)
    return torch.stack([c_eps, inv_sa, sigma, keep], dim=-1)


def masked_step_tables(sched, device="cpu") -> torch.Tensor:
    """(4, T) canonical coefficient table for the DENSE ancestral chain, on
    ``device``: column j holds the trajectory-position-j step (timestep
    t = T - j).  Built once per device and kept with the schedule."""
    def make():
        t = torch.arange(sched.T, 0, -1, dtype=torch.int64)
        return ancestral_pair_coefs(sched, t).to(device)
    return sched.memo(("masked_step_tables", torch.device(device)), make)


def index_step_coefs(tables: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Gather per-sample (c_eps, 1/√ar, σ, keep) from a canonical (4|5, C)
    table — the (B, 4) format :func:`ddpm_step` takes."""
    g = tables[:, cols.to(torch.int64)]
    return torch.stack([g[0], torch.rsqrt(g[1]), g[2], g[3]], dim=-1)


def masked_step_bytes(x: torch.Tensor, C: int, *, rows: int = 4,
                      n_active=None) -> int:
    """Device-memory bytes of one :func:`traj_masked_step` call: each input
    read once, the output written once.  An active lane streams x, ε̂, z
    and out (4 passes of D elements); an inactive lane reads x and writes
    it back (2 passes) — ``n_active=None`` counts every lane active, as the
    reference's ``masked_step_bytes`` does.  Plus the (rows, C) f32 table
    and the per-lane int32 column and bool flag."""
    s = x.shape[0]
    d = x.numel() // max(s, 1)
    n_act = s if n_active is None else int(n_active)
    passes = 4 * n_act + 2 * (s - n_act)
    return passes * d * x.element_size() + rows * C * 4 + s * (4 + 1)


def lane_meta(cols: torch.Tensor, active: torch.Tensor, C: int) -> torch.Tensor:
    """(S, 2) int32 per-lane (clamped column, active flag) — the only
    per-tick scalars the masked kernel reads (it clamps the column
    itself)."""
    col_safe = torch.clamp(cols.to(torch.int32), 0, C - 1)
    return torch.stack([col_safe, active.to(torch.int32)], dim=-1)


# ---------------------------------------------------------------------------
# kernels and their launchers
# ---------------------------------------------------------------------------
# -- ddpm_step: Triton ------------------------------------------------------
def _step_kernel(x_ptr, eps_ptr, z_ptr, coef_ptr, out_ptr, D,
                 BLOCK: "tl.constexpr"):
    """One BLOCK of one sample: out = (x − c_eps·ε̂)·inv_sa + (keep·σ)·z."""
    b = tl.program_id(1)
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < D
    row = b.to(tl.int64) * D
    c_eps = tl.load(coef_ptr + b * 4)
    inv_sa = tl.load(coef_ptr + b * 4 + 1)
    ks = tl.load(coef_ptr + b * 4 + 3) * tl.load(coef_ptr + b * 4 + 2)
    x = tl.load(x_ptr + row + offs, mask=mask).to(tl.float32)
    e = tl.load(eps_ptr + row + offs, mask=mask).to(tl.float32)
    z = tl.load(z_ptr + row + offs, mask=mask).to(tl.float32)
    out = (x - c_eps * e) * inv_sa + ks * z
    tl.store(out_ptr + row + offs, out.to(out_ptr.dtype.element_ty), mask=mask)


_TRITON_KERNELS = {}


def _triton_step_kernel():
    """JIT-wrap :func:`_step_kernel` on first use: ``triton`` is imported
    here, never when this module is imported."""
    if "step" not in _TRITON_KERNELS:
        import triton
        import triton.language
        globals()["tl"] = triton.language      # the kernel body's `tl`
        _TRITON_KERNELS["step"] = (triton, triton.jit(_step_kernel))
    return _TRITON_KERNELS["step"]


def launch_ddpm_step(x_t, eps_hat, noise, coefs, out) -> None:
    """Launch ``_step_kernel`` on the current stream: out = the fused update
    of (B, ...) x_t, eps_hat, noise with (B, 4) f32 coefs.  The tensors are
    CUDA, contiguous and non-empty, as :func:`repro_torch.kernels.ops
    .ddpm_step` checks."""
    b = x_t.shape[0]
    d = x_t.numel() // b
    block, warps = step_shape(x_t)
    triton, kernel = _triton_step_kernel()
    kernel[(triton.cdiv(d, block), b)](x_t, eps_hat, noise, coefs, out, d,
                                       BLOCK=block, num_warps=warps,
                                       enable_fp_fusion=False)


# -- traj_masked_step: CUDA C++ ---------------------------------------------
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _masked_lib():
    lib = build.load("traj_masked_step")
    fn = lib.traj_masked_step
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, p, p, p, p, p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def launch_traj_masked_step(x, cols, eps_hat, noise, active, tables, out,
                            clip: float) -> None:
    """Launch ``csrc/traj_masked_step.cu`` on the current stream (built on
    first use); raises if the launch fails.  The tensors are as
    :func:`repro_torch.kernels.ops.traj_masked_step` checks them: CUDA,
    contiguous, non-empty; x, eps_hat, noise, out (S, ...) of one dtype in
    :data:`DTYPES`; cols (S,) int32; active (S,) bool; tables (4|5, C)
    f32."""
    s = x.shape[0]
    d = x.numel() // s
    vec_ok = int(all(t.data_ptr() % 16 == 0 for t in (x, eps_hat, noise, out))
                 and (d * x.element_size()) % 16 == 0)
    fn = _masked_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(DTYPES[x.dtype], x.data_ptr(), eps_hat.data_ptr(),
                 noise.data_ptr(), out.data_ptr(), cols.data_ptr(),
                 active.data_ptr(), tables.data_ptr(), tables.shape[1], s, d,
                 float(clip), vec_ok, stream)
    if err != 0:
        raise RuntimeError(f"traj_masked_step: CUDA launch failed with "
                           f"cudaError {err}")
