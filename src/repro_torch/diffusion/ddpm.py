"""DDPM processes: q_sample (forward diffusion), p_sample (denoise step), the
training loss and the partial sampler (counterpart of
``repro/diffusion/ddpm.py``).

Timestep convention as the paper's Figure 1: t ∈ {1..T}; x_T is pure noise;
denoising runs t = T → 1; the CollaFuse cut at ratio c splits the chain at
t_c = (1-c)·T.  ``model_fn(x_t, t) -> eps_hat`` abstracts the backbone.

Noise: where the reference splits a threefry key each step, the samplers
here take ``noise``, a function of the step's trajectory position (T - t on
the dense chain) returning the step's noise for the whole batch; the loss
takes its timesteps and noise as arguments.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.diffusion.backend import BackendLike, get_backend
from repro_torch.diffusion.schedule import DiffusionSchedule

NoiseAt = Callable[[int], torch.Tensor]


def _bcast(a: torch.Tensor, t_idx: torch.Tensor, x: torch.Tensor):
    """Gather per-timestep scalars of ``a`` (on x's device), shaped to
    broadcast against x."""
    v = a[t_idx.to(device=x.device, dtype=torch.int64)]
    return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))


def q_sample(sched: DiffusionSchedule, x0, t, noise):
    """Forward diffusion x_t ~ q(x_t | x_0).  t: (B,) int in {1..T}."""
    sched = sched.to(x0.device)
    ti = t - 1
    return (_bcast(sched.sqrt_alpha_bar, ti, x0) * x0 +
            _bcast(sched.sqrt_one_minus_alpha_bar, ti, x0) * noise)


def ddpm_loss(sched: DiffusionSchedule, model_fn: Callable, x0, t, noise):
    """Simple loss (Ho et al. eq. 14): MSE(noise, eps_hat).

    Where the reference draws t uniformly from {lo..hi} and the noise from a
    threefry key, the caller passes them: ``t`` (B,) ints in the range the
    side trains on (CollaFuse restricts the server to (t_c, T] and the
    clients to [1, t_c]) and ``noise`` of x0's shape.
    """
    x_t = q_sample(sched, x0, t, noise)
    eps_hat = model_fn(x_t, t)
    return torch.mean(torch.square(eps_hat - noise)), {"t": t}


def p_sample(sched: DiffusionSchedule, x_t, t, eps_hat, noise):
    """One reverse step x_{t-1} ~ p(x_{t-1} | x_t) given predicted noise.

    ``noise`` may hold anything where t == 1: the noise term is masked there,
    so the final step is deterministic given (x_t, eps_hat)."""
    sched = sched.to(x_t.device)
    ti = t - 1
    beta = _bcast(sched.betas, ti, x_t)
    alpha = _bcast(sched.alphas, ti, x_t)
    somab = _bcast(sched.sqrt_one_minus_alpha_bar, ti, x_t)
    mean = (x_t - beta / somab * eps_hat) / torch.sqrt(alpha)
    var = _bcast(sched.posterior_var, ti, x_t)
    is_last = (t == 1).to(x_t.device).reshape((-1,) + (1,) * (x_t.ndim - 1))
    return mean + torch.where(is_last, torch.zeros_like(var),
                              torch.sqrt(var)) * noise


def denoise_step(sched: DiffusionSchedule, x, t, eps_hat, noise,
                 backend: BackendLike = None, clip: float = 3.0):
    """One reverse step plus the reference sampler's post-step clip (0
    disables).  ``backend`` names (or is) the StepBackend owning the update:
    "torch" (default), "triton" or "cuda_masked"."""
    return get_backend(backend).step(sched, x, t, eps_hat, noise, clip=clip)


def p_sample_masked(sched: DiffusionSchedule, x, t, eps_hat, noise, active,
                    backend: BackendLike = None, clip: float = 3.0,
                    tables=None):
    """Masked reverse step over a slot array: lanes where ``active`` advance
    x_t -> x_{t-1}; inactive lanes pass through bit-unchanged (t clamped)."""
    return get_backend(backend).masked_step(sched, x, t, eps_hat, noise,
                                            active, clip=clip, tables=tables)


@torch.inference_mode()
def sample_range(sched: DiffusionSchedule, model_fn: Callable,
                 noise: NoiseAt, x_start, t_from: int, t_to: int,
                 backend: BackendLike = None, clip: float = 3.0):
    """Run the reverse chain from t_from down to t_to (inclusive).

    Returns x_{t_to - 1} — after executing steps t_from, ..., t_to.  Step t
    draws its noise as ``noise(T - t)``: the dense trajectory position, the
    same key a sampler and the serving engine use for that step.
    """
    if t_from < t_to:
        return x_start
    b = x_start.shape[0]
    backend = get_backend(backend)
    x = x_start
    for t in range(t_from, t_to - 1, -1):
        tb = torch.full((b,), t, dtype=torch.int64, device=x.device)
        eps_hat = model_fn(x, tb)
        z = noise(sched.T - t).to(device=x.device, dtype=x.dtype)
        x = backend.step(sched, x, tb, eps_hat, z, clip=clip)
    return x
