"""Plain PyTorch versions of the kernels (the allclose ground truth).

Counterpart of ``repro/kernels/ref.py``: the mathematical definitions,
written without any blocking.  The kernel wrappers in
:mod:`repro_torch.kernels.ops` run these for tensors on the CPU, and
the tests and ``chip_smoke.py`` hold each kernel against them on the card.
All compute in float32 and store in the input's dtype.
"""
from __future__ import annotations

import math

import torch


def _lanes(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) per-sample scalars -> (B, 1, ..., 1) for broadcasting."""
    return v.reshape(v.shape + (1,) * (ndim - 1))


def ddpm_step_ref(x_t, eps_hat, noise, coefs):
    """Direct p_sample with precomputed per-sample coefs (B, 4) =
    (c_eps, 1/√ar, σ, keep): ``(x − c_eps·ε̂)·inv_sa + keep·σ·z``."""
    nd = x_t.ndim
    c_eps = _lanes(coefs[:, 0], nd)
    inv_sa = _lanes(coefs[:, 1], nd)
    sigma = _lanes(coefs[:, 2], nd)
    keep = _lanes(coefs[:, 3], nd)
    x = x_t.to(torch.float32)
    mean = (x - c_eps * eps_hat.to(torch.float32)) * inv_sa
    return (mean + keep * sigma * noise.to(torch.float32)).to(x_t.dtype)


def traj_masked_step_ref(x, cols, eps_hat, noise, active, tables, *,
                         clip: float = 3.0):
    """The masked trajectory tick, per lane: col = clip(cols, 0, C−1); where
    ``active``, ``clip((x − c_eps·ε̂)/√ar + keep·σ·z, ±clip)`` from the
    table's column; elsewhere x passes through bit-unchanged.  Rows 0-3 of
    ``tables`` are (c_eps, ar, σ, keep); a fifth (guidance) row rides along
    unused."""
    nd = x.ndim
    col = torch.clamp(cols.to(torch.int64), 0, tables.shape[1] - 1)
    g = tables[:, col]
    xf = x.to(torch.float32)
    mean = (xf - _lanes(g[0], nd) * eps_hat.to(torch.float32)) / \
        torch.sqrt(_lanes(g[1], nd))
    new = mean + _lanes(g[3], nd) * _lanes(g[2], nd) * \
        noise.to(torch.float32)
    if clip:
        new = torch.clamp(new, -clip, clip)
    return torch.where(_lanes(active, nd), new.to(x.dtype), x)


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softmax_scale=None):
    """Materialised softmax attention with GQA, in float32, returned in q's
    dtype.  q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0;
    query row i and key row j both count from 0.  ``window`` > 0 keeps the
    keys j > i - window."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kvh, g, hd).to(torch.float32)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.to(torch.float32)) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(torch.float32))
    return o.reshape(b, sq, h, hd).to(q.dtype)


def ssm_scan_ref(x, dt, a, bm, cm):
    """The stepwise SSM recurrence (the SSD definition, O(S) sequential):

        h_t = exp(dt_t · a) · h_{t-1} + dt_t · x_t ⊗ b_t
        y_t = c_t · h_t

    x: (B, S, nh, P); dt: (B, S, nh); a: (nh,); bm, cm: (B, S, N).  The
    state (B, nh, N, P) is float32; y (B, S, nh, P) comes back in x's
    dtype."""
    b, s, nh, p = x.shape
    n = bm.shape[-1]
    f32 = torch.float32
    xf, dtf = x.to(f32), dt.to(f32)
    bf, cf, af = bm.to(f32), cm.to(f32), a.to(f32)
    state = torch.zeros((b, nh, n, p), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af[None, :])                  # (B, nh)
        upd = torch.einsum("bn,bhp->bhnp", bf[:, t],
                           xf[:, t] * dtf[:, t, :, None])
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype)                   # (B,S,nh,P)
