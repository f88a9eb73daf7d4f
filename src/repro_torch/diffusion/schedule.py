"""Variance schedules for DDPMs (cosine — the paper's choice — and linear).

Counterpart of ``repro/diffusion/schedule.py``.  ``_build`` runs in float64
numpy and casts to float32 last, exactly as the reference does, so the
arrays equal the reference's bit for bit.  Arrays live on the CPU;
``sched.to(device)`` gives a copy on a device, made once and kept.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed DDPM quantities for T steps (Ho et al. 2020, Nichol 2021).

    Index convention: arrays have length T; index t-1 holds the value for
    timestep t ∈ {1..T}.  ``alpha_bar[t-1]`` = ∏_{s<=t} (1-beta_s).
    """

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_bar: torch.Tensor
    sqrt_alpha_bar: torch.Tensor
    sqrt_one_minus_alpha_bar: torch.Tensor
    posterior_var: torch.Tensor
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @property
    def T(self) -> int:
        return int(self.betas.shape[0])

    def memo(self, key, make):
        """``make()``, computed once per ``key`` and kept with this schedule:
        its device copies and the tables derived from it, so a sampling loop
        copies nothing from the host per step."""
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def to(self, device) -> "DiffusionSchedule":
        """This schedule with its arrays on ``device`` (copied once per
        device; the CPU schedule is itself)."""
        device = torch.device(device)
        if device.type == "cpu":
            return self
        return self.memo(("to", device), lambda: DiffusionSchedule(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.init}))


def cosine_schedule(T: int, s: float = 0.008) -> DiffusionSchedule:
    """Nichol & Dhariwal improved-DDPM cosine schedule (the paper uses this)."""
    steps = np.arange(T + 1, dtype=np.float64) / T
    f = np.cos((steps + s) / (1 + s) * np.pi / 2) ** 2
    alpha_bar = f / f[0]
    betas = np.clip(1.0 - alpha_bar[1:] / alpha_bar[:-1], 0.0, 0.999)
    return _build(betas)


def linear_schedule(T: int, beta_start=1e-4, beta_end=0.02) -> DiffusionSchedule:
    """Ho et al. linear schedule, range rescaled by 1000/T (as the reference)."""
    scale = 1000.0 / T
    betas = np.linspace(scale * beta_start, min(scale * beta_end, 0.999), T,
                        dtype=np.float64)
    return _build(betas)


def _build(betas: np.ndarray) -> DiffusionSchedule:
    alphas = 1.0 - betas
    alpha_bar = np.cumprod(alphas)
    alpha_bar_prev = np.concatenate([[1.0], alpha_bar[:-1]])
    posterior_var = betas * (1.0 - alpha_bar_prev) / (1.0 - alpha_bar)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    return DiffusionSchedule(
        betas=f32(betas),
        alphas=f32(alphas),
        alpha_bar=f32(alpha_bar),
        sqrt_alpha_bar=f32(np.sqrt(alpha_bar)),
        sqrt_one_minus_alpha_bar=f32(np.sqrt(1.0 - alpha_bar)),
        posterior_var=f32(posterior_var),
    )


def get_schedule(name: str, T: int) -> DiffusionSchedule:
    if name == "cosine":
        return cosine_schedule(T)
    if name == "linear":
        return linear_schedule(T)
    raise ValueError(name)


# ---------------------------------------------------------------------------
# Generalized (t, t_prev) step-pair coefficients, canonical rows
# (c_eps, ar, sigma, keep):
#
#     x_prev = (x_t - c_eps * eps_hat) / sqrt(ar) + keep * sigma * z
#
# ``t`` / ``t_prev`` are int tensors (CPU); results are float32 on the CPU.
# ---------------------------------------------------------------------------
def alpha_bar_at(sched: DiffusionSchedule, t) -> torch.Tensor:
    """alpha_bar extended to t ∈ {0..T}: ᾱ(0) = 1, ᾱ(t) = alpha_bar[t-1]."""
    t = torch.as_tensor(t)
    return torch.where(t >= 1, sched.alpha_bar[torch.clamp(t, min=1) - 1],
                       torch.ones((), dtype=torch.float32))


def ancestral_pair_coefs(sched: DiffusionSchedule, t) -> torch.Tensor:
    """DDPM ancestral coefficients for the dense pair (t, t-1), (4, ...)."""
    t = torch.as_tensor(t)
    ti = t - 1
    c_eps = sched.betas[ti] / sched.sqrt_one_minus_alpha_bar[ti]
    ar = sched.alphas[ti]
    sigma = torch.sqrt(sched.posterior_var[ti])
    keep = (t > 1).to(torch.float32)
    return torch.stack([c_eps, ar, sigma, keep])


def ddim_pair_coefs(sched: DiffusionSchedule, t, t_prev,
                    eta: float = 0.0) -> torch.Tensor:
    """DDIM (Song et al. 2021, eq. 12) coefficients for arbitrary step pairs
    t -> t_prev (t > t_prev >= 0), canonical (4, ...) rows."""
    ab_t = alpha_bar_at(sched, t)
    ab_p = alpha_bar_at(sched, t_prev)
    sig2 = (eta ** 2) * (1.0 - ab_p) / (1.0 - ab_t) * (1.0 - ab_t / ab_p)
    sigma = torch.sqrt(sig2)
    ar = ab_t / ab_p
    c_eps = (torch.sqrt(1.0 - ab_t) -
             torch.sqrt(ar) * torch.sqrt(torch.clamp(1.0 - ab_p - sig2,
                                                     min=0.0)))
    keep = (sigma > 0).to(torch.float32)
    return torch.stack([c_eps, ar, sigma, keep])
