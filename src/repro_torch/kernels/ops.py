"""The kernels' wrappers (counterpart of ``repro/kernels/ops.py``) and their
launch counters.

Each wrapper runs its kernel's plain version (:mod:`repro_torch.kernels.ref`)
for a tensor on the CPU, and only then.  For a CUDA tensor it checks device,
dtype, shape and contiguity, launches its kernel
(:mod:`repro_torch.kernels.ddpm_step`,
:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.ssm_scan`, :mod:`repro_torch.kernels.lane_noise`)
or raises, and adds one to its ``launches`` attribute; nothing falls back.
A CUDA graph that holds kernels launches each of them once a replay: its
owner counts a replay with :func:`add_launches`.  ``flash_attention`` and
``ssm_scan`` also take meta tensors (the dry run's, ``launch/dryrun.py``):
after the checks a card's call makes, they return the output's shape and
launch nothing; under a work counter (``launch/counter.py``, found by
:func:`repro_torch.kernels.units.active`) a call of either is one unit of
its kernel's FLOP and byte formulas, on any device.

No kernel has a backward.  The plain version on the CPU is differentiable;
a kernel writes a fresh tensor outside autograd, so ``flash_attention`` and
``ssm_scan`` raise for a non-CPU input that requires a gradient while
autograd records (:func:`_check_no_grad`) rather than return an output that
cuts the gradient.  Training runs ``kernel="torch"``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import ddpm_step as _ddpm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lane_noise as _ln
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels import units
from repro_torch.kernels.ref import (attention_ref, ddpm_step_ref,
                                     lane_noise_ref, ssm_scan_ref,
                                     traj_masked_step_ref)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel runs on CUDA "
                         "and the plain version only on the CPU")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _check_device(name: str, *tensors: torch.Tensor) -> None:
    """:func:`_check_cuda`, or for a dry run's call (the first tensor on
    meta, which returns the output's shape alone and counts no launch)
    every tensor on meta."""
    if not tensors[0].is_meta:
        _check_cuda(name, *tensors)
    elif not all(t.is_meta for t in tensors):
        raise ValueError(f"{name}: meta and real tensors in one call")
    elif not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


def _check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a kernel call: the kernel has no
    backward, and its output would silently carry no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires a "
            "gradient; train with kernel='torch' (plain PyTorch, "
            "differentiable), as the reference's lm_loss trains with "
            "kernel='jnp', or call it under torch.no_grad() or "
            "torch.inference_mode()")


def _check_streams(name: str, x, eps_hat, noise) -> None:
    if eps_hat.shape != x.shape or noise.shape != x.shape:
        raise ValueError(f"{name}: shapes {tuple(x.shape)}, "
                         f"{tuple(eps_hat.shape)}, {tuple(noise.shape)} differ")


def ddpm_step(x_t: torch.Tensor, eps_hat: torch.Tensor, noise: torch.Tensor,
              coefs: torch.Tensor) -> torch.Tensor:
    """Fused denoise update (the Triton kernel).  x_t/eps_hat/noise: (B, ...);
    coefs: (B, 4) f32 = (c_eps, 1/√ar, σ, keep), from
    :func:`~repro_torch.kernels.ddpm_step.ddpm_step_coefs` or
    :func:`~repro_torch.kernels.ddpm_step.index_step_coefs`.  Output in
    x_t's dtype; no clip."""
    if x_t.device.type == "cpu":
        return ddpm_step_ref(x_t, eps_hat, noise, coefs)
    _check_cuda("ddpm_step", x_t, eps_hat, noise, coefs)
    _check_streams("ddpm_step", x_t, eps_hat, noise)
    b = x_t.shape[0]
    if coefs.shape != (b, 4) or coefs.dtype != torch.float32:
        raise ValueError(f"ddpm_step: coefs must be ({b}, 4) float32, got "
                         f"{tuple(coefs.shape)} {coefs.dtype}")
    out = torch.empty_like(x_t)
    if x_t.numel() == 0:
        return out
    _ddpm.launch_ddpm_step(x_t, eps_hat, noise, coefs, out)
    ddpm_step.launches += 1
    return out


ddpm_step.launches = 0


def traj_masked_step(x: torch.Tensor, cols: torch.Tensor,
                     eps_hat: torch.Tensor, noise: torch.Tensor,
                     active: torch.Tensor, tables: torch.Tensor, *,
                     clip: float = 3.0) -> torch.Tensor:
    """Fused masked trajectory tick over a slot array (the CUDA kernel):
    per-lane column gather, update, clip and active select in one pass.

    x/eps_hat/noise: (S, ...) f32 or bf16, one dtype; cols: (S,) integer
    per-lane table column (any value — clamped into [0, C)); active: (S,)
    bool; tables: canonical (4|5, C) f32 coefficient table.  Active lanes
    take ``clip(step(x, col), ±clip)``; inactive lanes pass through
    bit-unchanged.
    """
    cols = cols.to(torch.int32)
    if x.device.type == "cpu":
        return traj_masked_step_ref(x, cols, eps_hat, noise, active, tables,
                                    clip=clip)
    _check_cuda("traj_masked_step", x, eps_hat, noise, cols, active, tables)
    _check_streams("traj_masked_step", x, eps_hat, noise)
    if x.dtype not in _ddpm.DTYPES or eps_hat.dtype != x.dtype \
            or noise.dtype != x.dtype:
        raise ValueError("traj_masked_step: x, eps_hat and noise must share "
                         "one dtype, float32 or bfloat16; got "
                         f"{x.dtype}, {eps_hat.dtype}, {noise.dtype}")
    s = x.shape[0]
    if cols.shape != (s,):
        raise ValueError(f"traj_masked_step: cols must be ({s},)")
    if active.dtype != torch.bool or active.shape != (s,):
        raise ValueError(f"traj_masked_step: active must be ({s},) bool")
    if tables.dtype != torch.float32 or tables.ndim != 2 \
            or tables.shape[0] < 4 or tables.shape[1] < 1:
        raise ValueError("traj_masked_step: tables must be (4|5, C) float32, "
                         "C >= 1")
    if s > 65535:
        raise ValueError(f"traj_masked_step: {s} lanes > 65535 (grid.y)")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    _ddpm.launch_traj_masked_step(x, cols, eps_hat, noise, active, tables,
                                  out, clip)
    traj_masked_step.launches += 1
    return out


traj_masked_step.launches = 0


def ddpm_masked_step(sched, x_t, t, eps_hat, noise, active, *,
                     clip: float = 3.0, tables=None):
    """Timestep-indexed view of :func:`traj_masked_step` over the dense
    ancestral table (the schedule's, kept on x_t's device, unless
    ``tables`` is given): per-lane t in {1..T} (any value — clamped) maps
    to column T - t."""
    if tables is None:
        tables = _ddpm.masked_step_tables(sched, x_t.device)
    T = tables.shape[1]
    cols = T - torch.clamp(t, 1, T)
    return traj_masked_step(x_t, cols, eps_hat, noise, active, tables,
                            clip=clip)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Causal / sliding-window GQA attention with online softmax (the CUDA
    kernel).  q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), H % KV == 0; one
    dtype, float32 or bfloat16; hd in {32, 64, 112, 128}.  Returns
    (B, Sq, H, hd) in q's dtype.  Any lengths: the kernel masks its ragged
    tiles.  Under a work counter (:func:`repro_torch.kernels.units.active`)
    a call is one unit of :func:`~repro_torch.kernels.flash_attention.
    attention_flops` and ``attention_bytes``; on meta tensors it returns
    the output's shape alone."""
    counter = units.active()
    if counter is None:
        return _flash_attention(q, k, v, causal=causal, window=window,
                                softmax_scale=softmax_scale)
    key = ("flash_attention", tuple(q.shape), tuple(k.shape), q.dtype,
           causal, window)
    with counter.unit("flash_attention", key, lambda: (
            _fa.attention_flops(q, k, causal=causal, window=window),
            _fa.attention_bytes(q, k, v))):
        return _flash_attention(q, k, v, causal=causal, window=window,
                                softmax_scale=softmax_scale)


def _flash_attention(q, k, v, *, causal: bool, window: int,
                     softmax_scale: Optional[float]) -> torch.Tensor:
    if q.device.type == "cpu":
        # in the kernel's layout, so the ops after it run as on a card
        return attention_ref(q, k, v, causal=causal, window=window,
                             softmax_scale=softmax_scale).contiguous()
    _check_no_grad("flash_attention", q, k, v)
    _check_device("flash_attention", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q must be (B, Sq, H, hd) and k, v "
                         f"one (B, Skv, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} need one B and hd, and H % KV == 0")
    if hd not in _fa.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{_fa.HEAD_DIMS}")
    if q.dtype not in _fa.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must share one dtype, "
                         f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if b * h * -(-sq // _fa.BLOCK_Q) > _fa.MAX_WORK_ITEMS:
        raise ValueError(f"flash_attention: B*H*ceil(Sq/{_fa.BLOCK_Q}) "
                         f"work items > {_fa.MAX_WORK_ITEMS}")
    if q.is_meta:
        return torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: tensors must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    _fa.launch_flash_attention(q, k, v, out, scale=scale, causal=causal,
                               window=window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor, *, chunk: int = 128,
             head_block: int = 8) -> torch.Tensor:
    """Mamba2 (SSD) chunked scan, the state-space mixing only (the CUDA
    kernel).  x: (B, S, nh, P); dt: (B, S, nh) softplus'd step sizes;
    a: (nh,) float32 decay rates; bm, cm: (B, S, N) (n_groups = 1).  x, bm
    and cm share one dtype, float32 or bfloat16; dt is float32 or x's dtype;
    P, N <= 64.  Returns y (B, S, nh, P) in x's dtype, bitwise the same from
    call to call.

    ``chunk`` and ``head_block`` are the reference's arguments, kept for its
    signature and checked, but the kernel ignores them: chunking is exact
    in arithmetic, and the kernel scans in chunks of its own (64), any S,
    one block per (head, batch) (see :mod:`repro_torch.kernels.ssm_scan`).
    A call runs the record kernel (G = C·Bᵀ, C and B per chunk) and the
    scan on the current stream, and counts as one launch.  Under a work
    counter a call is one unit of :func:`~repro_torch.kernels.ssm_scan.
    ssd_flops` and ``ssd_bytes``; on meta tensors it returns y's shape
    alone."""
    if chunk < 1 or head_block < 1:
        raise ValueError(f"ssm_scan: chunk {chunk} and head_block "
                         f"{head_block} must be positive")
    counter = units.active()
    if counter is None:
        return _ssm_scan(x, dt, a, bm, cm)
    key = ("ssm_scan",) + tuple((tuple(t.shape), t.dtype)
                                for t in (x, dt, a, bm, cm))
    with counter.unit("ssm_scan", key, lambda: (
            _ssm.ssd_flops(x, bm), _ssm.ssd_bytes(x, dt, a, bm, cm))):
        return _ssm_scan(x, dt, a, bm, cm)


def _ssm_scan(x, dt, a, bm, cm) -> torch.Tensor:
    if x.device.type == "cpu":
        return ssm_scan_ref(x, dt, a, bm, cm).contiguous()
    _check_no_grad("ssm_scan", x, dt, a, bm, cm)
    _check_device("ssm_scan", x, dt, a, bm, cm)
    if x.ndim != 4 or bm.ndim != 3 or cm.shape != bm.shape:
        raise ValueError("ssm_scan: x must be (B, S, nh, P) and bm, cm one "
                         f"(B, S, N); got {tuple(x.shape)}, "
                         f"{tuple(bm.shape)}, {tuple(cm.shape)}")
    b, s, nh, p = x.shape
    n = bm.shape[-1]
    if dt.shape != (b, s, nh) or a.shape != (nh,) or bm.shape[:2] != (b, s):
        raise ValueError(f"ssm_scan: x {tuple(x.shape)} needs dt ({b}, {s}, "
                         f"{nh}), a ({nh},) and bm, cm ({b}, {s}, N); got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(bm.shape)}")
    if x.dtype not in _ssm.DTYPES or bm.dtype != x.dtype \
            or cm.dtype != x.dtype:
        raise ValueError("ssm_scan: x, bm and cm must share one dtype, "
                         f"float32 or bfloat16; got {x.dtype}, {bm.dtype}, "
                         f"{cm.dtype}")
    if dt.dtype not in (torch.float32, x.dtype) or a.dtype != torch.float32:
        raise ValueError("ssm_scan: dt must be float32 or x's dtype and a "
                         f"float32; got {dt.dtype}, {a.dtype}")
    if not (1 <= p <= _ssm.MAX_WIDTH and 1 <= n <= _ssm.MAX_WIDTH):
        raise ValueError(f"ssm_scan: head dim {p} and state {n} must be in "
                         f"[1, {_ssm.MAX_WIDTH}]")
    if b > 65535:
        raise ValueError(f"ssm_scan: B = {b} > 65535 (grid.y)")
    y = torch.empty_like(x)
    if x.is_meta:
        return y
    if x.numel() == 0:
        return y
    _ssm.launch_ssm_scan(x, dt, a, bm, cm, y)
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0


def lane_noise(seeds: torch.Tensor, images: torch.Tensor,
               steps: torch.Tensor, active: torch.Tensor, role: int,
               shape) -> torch.Tensor:
    """Per-lane standard normals (the CUDA kernel): row s of the (S,) +
    ``shape`` float32 result is the draw keyed by (seeds[s], images[s],
    role, steps[s]), zeros where ``active`` is False; on seeds' device.
    seeds (each in [0, 2^63)), images, steps: (S,) int64; active: (S,)
    bool; role: a non-negative int (``collafuse.ROLES``)."""
    shape = tuple(int(n) for n in shape)
    if seeds.device.type == "cpu":
        return lane_noise_ref(seeds, images, steps, active, role, shape)
    _check_cuda("lane_noise", seeds, images, steps, active)
    s = seeds.shape[0]
    for name, t in (("seeds", seeds), ("images", images), ("steps", steps)):
        if t.dtype != torch.int64 or t.shape != (s,):
            raise ValueError(f"lane_noise: {name} must be ({s},) int64")
    if active.dtype != torch.bool or active.shape != (s,):
        raise ValueError(f"lane_noise: active must be ({s},) bool")
    if not 0 <= int(role) < 2 ** 32:
        raise ValueError(f"lane_noise: role {role} outside [0, 2^32)")
    if s > 65535:
        raise ValueError(f"lane_noise: {s} lanes > 65535 (grid.y)")
    out = torch.empty((s,) + shape, dtype=torch.float32, device=seeds.device)
    if out.numel() == 0:
        return out
    _ln.launch_lane_noise(out, seeds, images, steps, active, role)
    lane_noise.launches += 1
    return out


lane_noise.launches = 0


# the kernel wrappers that count their launches, by kernel name
KERNELS = {"ddpm_step": ddpm_step, "traj_masked_step": traj_masked_step,
           "flash_attention": flash_attention, "ssm_scan": ssm_scan,
           "lane_noise": lane_noise}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Put the counters back to ``counts`` (a capture records launches
    without running them)."""
    for name, n in counts.items():
        KERNELS[name].launches = n


def add_launches(counts: Dict[str, int]) -> None:
    """Count one replay of a CUDA graph that holds ``counts`` launches."""
    for name, n in counts.items():
        KERNELS[name].launches += n
