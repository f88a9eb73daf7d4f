"""Sampler layer: which timesteps a reverse chain visits (counterpart of
``repro/diffusion/sampler.py``).

* :class:`Trajectory` — a strictly decreasing tuple of timesteps starting at
  T; executing position j moves x from ``t_at(j)`` to ``t_at(j+1)``
  (``t_at(K) == 0``).
* :class:`Sampler` — a trajectory plus the update family (``"ddpm"``
  ancestral on the dense chain, ``"ddim"`` with ``eta`` on any trajectory);
  ``tables(sched)`` emits the canonical (5, K) coefficient table (c_eps, ar,
  σ, keep, w) every StepBackend consumes; w is the sampler's
  classifier-free guidance scale (0 when unguided).
* :func:`sample_trajectory` — runs positions [pos_from, pos_to); position j
  draws its noise as ``noise(j)``.  On a guided sampler each step combines
  ε̂_u + w·(ε̂_c − ε̂_u).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.diffusion.backend import (GUIDANCE_ROW, N_TABLE_ROWS,
                                           BackendLike, get_backend)
from repro_torch.diffusion.ddpm import NoiseAt
from repro_torch.diffusion.schedule import (DiffusionSchedule,
                                            ancestral_pair_coefs,
                                            ddim_pair_coefs)

FAMILIES = ("ddpm", "ddim")

assert GUIDANCE_ROW == N_TABLE_ROWS - 1


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """An ordered timestep subsequence t_0 > t_1 > ... > t_{K-1} of {1..T},
    starting at T and implicitly ending at 0 (clean data)."""

    timesteps: Tuple[int, ...]
    T: int

    def __post_init__(self):
        ts = self.timesteps
        assert len(ts) >= 1, "empty trajectory"
        assert ts[0] == self.T, \
            f"trajectory must start at T={self.T}, got {ts[0]}"
        assert all(a > b for a, b in zip(ts, ts[1:])), \
            "trajectory timesteps must be strictly decreasing"
        assert ts[-1] >= 1, f"trajectory must stay in {{1..T}}, got {ts[-1]}"

    @property
    def K(self) -> int:
        """Number of steps (model calls) a full walk costs."""
        return len(self.timesteps)

    @property
    def is_dense(self) -> bool:
        return self.timesteps == tuple(range(self.T, 0, -1))

    def t_at(self, pos: int) -> int:
        """Timestep x occupies BEFORE executing position pos (0 at pos=K)."""
        return self.timesteps[pos] if pos < self.K else 0

    def t_prev(self) -> Tuple[int, ...]:
        """Target timestep of each position: (t_1, ..., t_{K-1}, 0)."""
        return self.timesteps[1:] + (0,)

    def cut_pos(self, t_split: int) -> int:
        """The position whose occupied timestep is NEAREST t_split; ties
        break toward fewer server steps (the noisier disclosure)."""
        dist = [abs(self.t_at(j) - t_split) for j in range(self.K + 1)]
        return int(np.argmin(dist))

    def describe(self) -> str:
        ts = self.timesteps
        inner = (",".join(map(str, ts)) if self.K <= 6 else
                 f"{ts[0]},{ts[1]},...,{ts[-2]},{ts[-1]}")
        return f"[{inner}] ({self.K} steps over T={self.T})"


def dense_trajectory(T: int) -> Trajectory:
    """The classic DDPM chain T, T-1, ..., 1."""
    return Trajectory(tuple(range(T, 0, -1)), T)


def strided_trajectory(T: int, num_steps: int) -> Trajectory:
    """A K-step DDIM-style subsequence spread evenly over {1..T}, endpoints
    included."""
    assert 1 <= num_steps <= T, (num_steps, T)
    if num_steps == 1:
        return Trajectory((T,), T)
    ts = np.unique(np.round(np.linspace(1, T, num_steps)).astype(int))
    return Trajectory(tuple(int(t) for t in ts[::-1]), T)


@dataclasses.dataclass(frozen=True)
class Sampler:
    """A trajectory + the per-step update family walking it.  ``eta=1`` on
    the dense trajectory routes through the ancestral coefficients, as the
    reference does.

    ``guidance_scale`` makes the sampler classifier-free guided: each step
    combines ε̂ = ε̂_u + w·(ε̂_c − ε̂_u).  ``None`` is unguided; ``0.0`` is
    guided, but its chain is bitwise the unguided one.
    """

    trajectory: Trajectory
    family: str = "ddpm"
    eta: float = 1.0
    guidance_scale: Optional[float] = None

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        assert 0.0 <= self.eta <= 1.0, self.eta
        assert self.guidance_scale is None or self.guidance_scale >= 0.0, \
            self.guidance_scale
        if self.family == "ddpm":
            assert self.trajectory.is_dense, \
                "the DDPM ancestral update is only defined on the dense " \
                "trajectory; use family='ddim' for strided chains"

    @property
    def K(self) -> int:
        return self.trajectory.K

    @property
    def guided(self) -> bool:
        """True when the sampler walks a cond+uncond lane pair."""
        return self.guidance_scale is not None

    @property
    def w(self) -> float:
        """The guidance scale as a float (0.0 when unguided)."""
        return float(self.guidance_scale or 0.0)

    def tables(self, sched: DiffusionSchedule) -> torch.Tensor:
        """(5, K) f32 canonical table (c_eps, ar, sigma, keep, w) on the CPU;
        column j holds the step executed at position j, row
        :data:`GUIDANCE_ROW` the guidance scale."""
        assert sched.T == self.trajectory.T, (sched.T, self.trajectory.T)
        t = torch.tensor(self.trajectory.timesteps, dtype=torch.int64)
        ancestral = self.family == "ddpm" or (self.eta == 1.0 and
                                              self.trajectory.is_dense)
        if ancestral:
            coefs = ancestral_pair_coefs(sched, t)
        else:
            tp = torch.tensor(self.trajectory.t_prev(), dtype=torch.int64)
            coefs = ddim_pair_coefs(sched, t, tp, self.eta)
        wrow = torch.full((1, self.K), self.w, dtype=coefs.dtype)
        return torch.cat([coefs, wrow], dim=0)

    def describe(self) -> str:
        fam = (self.family if self.family == "ddpm"
               else f"ddim(eta={self.eta:g})")
        if self.guided:
            fam += f" cfg(w={self.w:g})"
        return f"{fam} over {self.trajectory.describe()}"


def make_sampler(T: int, family: str = "ddpm", num_steps: int = 0,
                 eta: float = 1.0,
                 guidance: Optional[float] = None) -> Sampler:
    """Build a sampler from launcher-flag-shaped inputs.  ``num_steps`` of 0
    (or T) selects the dense trajectory; ddpm is the eta=1 member.
    ``guidance=w`` makes it classifier-free guided (None: unguided)."""
    k = num_steps if num_steps else T
    if family == "ddpm" and k < T:
        raise ValueError(
            f"the DDPM ancestral update only walks the dense chain; "
            f"num_steps={num_steps} < T={T} needs family='ddim' "
            f"(--sampler ddim on the launcher)")
    traj = dense_trajectory(T) if k >= T else strided_trajectory(T, k)
    if family == "ddpm":
        return Sampler(traj, "ddpm", 1.0, guidance)
    return Sampler(traj, family, eta, guidance)


DEFAULT = "ddpm"                 # registry key engines use for Request.sampler


def default_samplers(T: int):
    """The serving engine's default sampler menu: just the dense chain."""
    return {DEFAULT: make_sampler(T)}


def assert_same_menu(a, b, a_name: str = "menu A", b_name: str = "menu B"):
    """Assert two {name: Sampler} menus are identical (the scheduler that
    prices requests and the engine that runs them must agree)."""
    assert set(a) == set(b), \
        f"sampler menus diverge: {a_name} has {sorted(a)}, " \
        f"{b_name} has {sorted(b)}"
    for name in a:
        assert a[name] == b[name], \
            f"sampler {name!r} differs between {a_name} " \
            f"({a[name].describe()}) and {b_name} ({b[name].describe()})"


@torch.inference_mode()
def sample_trajectory(sched: DiffusionSchedule, sampler: Sampler, model_fn,
                      noise: NoiseAt, x_start, pos_from: int = 0,
                      pos_to: Optional[int] = None,
                      backend: BackendLike = None, clip: float = 3.0,
                      cond_fn=None, label: int = 0):
    """Run trajectory positions [pos_from, pos_to) on ``x_start``; position
    j draws its noise as ``noise(j)``.  On the dense DDPM sampler this is
    :func:`~repro_torch.diffusion.ddpm.sample_range` step for step.

    On a guided sampler with w ≠ 0 each step also evaluates the conditional
    branch ``cond_fn(x, t, y)`` at label ``label`` and combines
    ``ε̂_u + w·(ε̂_c − ε̂_u)``; without a ``cond_fn`` both branches are the
    same call.  At w = 0 the combine is skipped: the chain is bitwise the
    unguided one."""
    K = sampler.K
    pos_to = K if pos_to is None else pos_to
    assert 0 <= pos_from <= K and 0 <= pos_to <= K, (pos_from, pos_to, K)
    if pos_from >= pos_to:
        return x_start
    b = x_start.shape[0]
    dev = x_start.device
    backend = get_backend(backend)
    tables = sampler.tables(sched).to(dev)
    w = sampler.w
    guide = sampler.guided and w != 0.0
    yb = (torch.full((b,), label, dtype=torch.int64, device=dev)
          if guide else None)
    x = x_start
    for pos in range(pos_from, pos_to):
        tb = torch.full((b,), sampler.trajectory.timesteps[pos],
                        dtype=torch.int64, device=dev)
        eps_hat = model_fn(x, tb)
        if guide:
            eps_c = cond_fn(x, tb, yb) if cond_fn is not None else eps_hat
            eps_hat = eps_hat + w * (eps_c - eps_hat)
        z = noise(pos).to(device=dev, dtype=x.dtype)
        cols = torch.full((b,), pos, dtype=torch.int32, device=dev)
        x = backend.index_step(x, cols, eps_hat, z, tables, clip=clip)
    return x
