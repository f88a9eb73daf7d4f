"""StepBackend: who executes one denoise tick (counterpart of
``repro/diffusion/backend.py``).

Every hot loop — ``ddpm.sample_range``, the CollaFuse split samplers and the
serving engine's masked lane tick — bottoms out in one reverse-diffusion
update x_t -> x_{t-1}, the reference sampler's post-step clip, and (on slot
arrays) the active-lane select.  A :class:`StepBackend` owns all three.

Registered backends:

``"torch"``        plain PyTorch: ``ddpm.p_sample`` + clip (+ ``torch.where``),
                   the counterpart of the reference's ``"jnp"``.
``"triton"``       the ``ddpm_step`` Triton kernel for the update; clip and
                   the masked select stay plain (counterpart of ``"pallas"``).
``"cuda_masked"``  the ``traj_masked_step`` CUDA kernel: column gather,
                   update, clip and active select in one pass (counterpart of
                   ``"pallas_masked"``).

On CPU tensors the kernel backends run their kernels' plain versions.
Inactive lanes always pass through bit-unchanged, even at out-of-range
columns or timesteps.  ``guided_masked_index_step`` puts the
classifier-free ε̂-combine over cond+uncond lane pairs in front of the
masked step, in plain PyTorch as the reference does in jnp, so mixed guided
and unguided traffic still ends in one step kernel a tick.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.kernels import ddpm_step as kds
from repro_torch.kernels import ops as kops

# Row index of the guidance-scale row in the canonical coefficient table
# (rows 0-3 = c_eps, ar, sigma, keep drive the update; row 4 = the
# classifier-free guidance scale w of the column's sampler).
GUIDANCE_ROW = 4
N_TABLE_ROWS = 5


def _lanes(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


class StepBackend:
    """Owns the denoise update, the post-step clip, and the active select.

    ``step(sched, x, t, eps_hat, noise, clip=...)`` advances every sample;
    ``masked_step`` advances a slot array with per-lane timesteps (t clamped
    into {1..T}); inactive lanes pass through bit-unchanged.  The
    trajectory-indexed pair ``index_step`` / ``masked_index_step`` takes
    per-sample COLUMNS into a canonical (4|5, C) coefficient table.
    """

    name: str = "abstract"

    def step(self, sched, x, t, eps_hat, noise, *, clip: float = 3.0):
        raise NotImplementedError

    def masked_step(self, sched, x, t, eps_hat, noise, active, *,
                    clip: float = 3.0, tables=None):
        del tables                       # only the fused backend takes them
        t_safe = torch.clamp(t, 1, sched.T)
        x_new = self.step(sched, x, t_safe, eps_hat, noise, clip=clip)
        return torch.where(_lanes(active, x.ndim), x_new, x)

    # The base implementation is the plain expression: for dense ancestral
    # tables it reproduces ``ddpm.p_sample`` + clip (same gathered values,
    # same expression tree).
    def index_step(self, x, cols, eps_hat, noise, tables, *,
                   clip: float = 3.0):
        idx = cols.to(torch.int64)

        def row(r):
            return _lanes(tables[r, idx], x.ndim)
        mean = (x - row(0) * eps_hat) / torch.sqrt(row(1))
        x_new = mean + row(3) * row(2) * noise
        if clip:
            x_new = torch.clamp(x_new, -clip, clip)
        return x_new

    def masked_index_step(self, x, cols, eps_hat, noise, active, tables, *,
                          clip: float = 3.0):
        """Masked trajectory tick: active lanes execute their column's step,
        inactive lanes pass through bit-unchanged (cols clamped first)."""
        cols_safe = torch.clamp(cols.to(torch.int64), 0, tables.shape[1] - 1)
        x_new = self.index_step(x, cols_safe, eps_hat, noise, tables,
                                clip=clip)
        return torch.where(_lanes(active, x.ndim), x_new, x)

    def guided_masked_index_step(self, x, cols, eps_hat, noise, active, pair,
                                 cond, tables, *, clip: float = 3.0):
        """:meth:`masked_index_step` with the classifier-free ε̂-combine in
        front of it.

        A guided request occupies a lane PAIR: a primary lane (``cond``
        True, the model saw the request's label) and a shadow lane
        (``cond`` False, the null label); ``pair`` holds each lane's
        partner index (its own for unguided lanes).  Per lane the combine is
        ε̂_u + w·(ε̂_c − ε̂_u), w gathered from row :data:`GUIDANCE_ROW` by
        the lane's column, and the shadow borrows its primary's noise, so
        both lanes of a pair step to the same x.  Solo lanes and w = 0
        columns take ε̂_u through a select: bitwise the plain
        :meth:`masked_index_step`.
        """
        if tables.shape[0] <= GUIDANCE_ROW:          # a bare 4-row table
            return self.masked_index_step(x, cols, eps_hat, noise, active,
                                          tables, clip=clip)
        cols_safe = torch.clamp(cols.to(torch.int64), 0, tables.shape[1] - 1)
        w = _lanes(tables[GUIDANCE_ROW, cols_safe], x.ndim)
        c = _lanes(cond, x.ndim)
        pair = pair.to(torch.int64)
        eps_p = eps_hat[pair]
        eps_c = torch.where(c, eps_hat, eps_p)
        eps_u = torch.where(c, eps_p, eps_hat)
        solo = _lanes(pair == torch.arange(x.shape[0], device=x.device),
                      x.ndim)
        eps = torch.where(solo | (w == 0.0), eps_u,
                          eps_u + w * (eps_c - eps_u))
        z = torch.where(c, noise, noise[pair])
        return self.masked_index_step(x, cols, eps, z, active, tables,
                                      clip=clip)


def make_lane_tick(masked_index: Callable, guided_index: Callable,
                   conditional: bool = False) -> Callable:
    """Build the masked lane tick the engine's server windows and its client
    finisher share (counterpart of ``backend.py:153``), from device inputs:

        x = lane_tick(model, tables, x, t, cols, active, noise, y, pair,
                      cond, guided)

    Every argument but ``model`` and ``guided`` is a tensor on x's device,
    so a window of ticks makes no host-to-device copy and a CUDA graph can
    hold it: ``t`` (S,) the timesteps the model conditions on, ``cols`` (S,)
    each lane's column of the (5, C) coefficient table ``tables``,
    ``active`` (S,) bool the lanes that step (the caller's ``gate & (pos <
    end)``: the host tracks every lane's trajectory position, so no tick
    waits on the device), ``noise`` (S, ...) the tick's draws (rows of
    lanes not stepping are unused).  A lane not stepping HOLDS x bitwise
    (the masked select), so retiring at a window boundary reads the exact
    cut tensor at any window depth.  ``y``/``pair``/``cond`` (S,) are the
    conditional-serving lane state: the class label a ``conditional`` model
    sees (the null label for unguided and shadow lanes), the partner lane
    of a guided pair (own index when solo) and the primary-lane flag.  One
    model call covers both lanes of every pair.  ``masked_index`` and
    ``guided_index`` are a backend's ``masked_index_step`` and
    ``guided_masked_index_step`` with their clip bound: ``guided`` ticks (a
    paired lane in the slot array) take the guided one (the combine and the
    shadow's noise borrow in front of the one step); a tick whose lanes are
    all solo takes the masked step directly, which is what the combine
    reduces to there, bit for bit, without its dozen launches.
    """
    def lane_tick(model, tables, x, t, cols, active, noise, y, pair, cond,
                  guided: bool):
        eps_hat = model(x, t, y) if conditional else model(x, t)
        if guided:
            return guided_index(x, cols, eps_hat, noise, active, pair, cond,
                                tables=tables)
        return masked_index(x, cols, eps_hat, noise, active, tables=tables)
    return lane_tick


_REGISTRY: Dict[str, StepBackend] = {}

BackendLike = Optional[Union[str, StepBackend]]


def register(cls):
    """Class decorator: instantiate and expose under ``cls.name``."""
    _REGISTRY[cls.name] = cls()
    return cls


def get_backend(spec: BackendLike = None) -> StepBackend:
    """Resolve a backend name (or pass an instance through).  None = "torch"."""
    if spec is None:
        return _REGISTRY["torch"]
    if isinstance(spec, StepBackend):
        return spec
    try:
        return _REGISTRY[spec]
    except KeyError:
        raise ValueError(f"unknown step backend {spec!r}; "
                         f"available: {available()}") from None


def available():
    return sorted(_REGISTRY)


@register
class TorchStepBackend(StepBackend):
    """Plain PyTorch path (counterpart of ``JnpStepBackend``)."""

    name = "torch"

    def step(self, sched, x, t, eps_hat, noise, *, clip: float = 3.0):
        from repro_torch.diffusion import ddpm         # import cycle: lazy
        x = ddpm.p_sample(sched, x, t, eps_hat, noise)
        if clip:
            x = torch.clamp(x, -clip, clip)
        return x


@register
class TritonStepBackend(StepBackend):
    """The ``ddpm_step`` Triton kernel; clip and masked select stay plain."""

    name = "triton"

    def step(self, sched, x, t, eps_hat, noise, *, clip: float = 3.0):
        x = kops.ddpm_step(x, eps_hat, noise, kds.ddpm_step_coefs(sched, t))
        if clip:
            x = torch.clamp(x, -clip, clip)
        return x

    def index_step(self, x, cols, eps_hat, noise, tables, *,
                   clip: float = 3.0):
        x = kops.ddpm_step(x, eps_hat, noise,
                           kds.index_step_coefs(tables, cols))
        if clip:
            x = torch.clamp(x, -clip, clip)
        return x


@register
class CudaMaskedStepBackend(StepBackend):
    """One ``traj_masked_step`` CUDA kernel per tick: per-lane column
    gather, update, clip and active select in a single read of (x, ε̂, z)
    and one write."""

    name = "cuda_masked"

    def _ones(self, x):
        return torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)

    def step(self, sched, x, t, eps_hat, noise, *, clip: float = 3.0):
        return self.masked_step(sched, x, t, eps_hat, noise, self._ones(x),
                                clip=clip)

    def masked_step(self, sched, x, t, eps_hat, noise, active, *,
                    clip: float = 3.0, tables=None):
        return kops.ddpm_masked_step(sched, x, t, eps_hat, noise, active,
                                     clip=clip, tables=tables)

    def index_step(self, x, cols, eps_hat, noise, tables, *,
                   clip: float = 3.0):
        return self.masked_index_step(x, cols, eps_hat, noise, self._ones(x),
                                      tables, clip=clip)

    def masked_index_step(self, x, cols, eps_hat, noise, active, tables, *,
                          clip: float = 3.0):
        return kops.traj_masked_step(x, cols, eps_hat, noise, active, tables,
                                     clip=clip)
