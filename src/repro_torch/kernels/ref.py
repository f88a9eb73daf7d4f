"""Plain PyTorch versions of the kernels (the allclose ground truth).

Counterpart of ``repro/kernels/ref.py``: the mathematical definitions,
written without any blocking.  The kernel wrappers in
:mod:`repro_torch.kernels.ops` run these for tensors on the CPU, and
the tests and ``chip_smoke.py`` hold each kernel against them on the card.
All compute in float32 and store in the input's dtype.
"""
from __future__ import annotations

import math
import struct

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


# the lane-noise transform's float32 constants, as bit patterns; the same
# patterns are spelled out in csrc/lane_noise.cu
LANE_NOISE_BITS = {
    "S1": 0xbe2aaaab, "S2": 0x3c088889, "S3": 0xb9500d01, "S4": 0x3638ef1d,
    "S5": 0xb2d7322b, "S6": 0x2f309231,
    "C1": 0xbf000000, "C2": 0x3d2aaaab, "C3": 0xbab60b61, "C4": 0x37d00d01,
    "C5": 0xb493f27e, "C6": 0x310f76c7, "C7": 0xad49cba5,
    "L0": 0x40000000, "L1": 0x3f2aaaab, "L2": 0x3ecccccd, "L3": 0x3e924925,
    "L4": 0x3e638e39, "LN2_HI": 0x3f317200, "LN2_LO": 0x35bfbe8e,
    "SQRT2": 0x3fb504f3, "HALF_PI": 0x3fc90fdb}
_K = {n: struct.unpack("<f", struct.pack("<I", b))[0]
      for n, b in LANE_NOISE_BITS.items()}
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a, m: int):
    """(high, low) 32-bit words of a·m for int64 tensors ``a`` holding
    uint32 values and a uint32 constant ``m``, without an int64 overflow:
    ``a`` is split into 16-bit halves (each product < 2^48)."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _U32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(c, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 words: counter words
    ``c`` (four broadcastable tensors), key words ``k0``, ``k1``.  Returns
    the four output words."""
    c0, c1, c2, c3 = c
    for i in range(10):
        if i:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _box_muller(xu, xa):
    """(r·cos θ, r·sin θ) of one pair of Philox words, each operation one
    float32 rounding, in the kernel's order."""
    f32 = torch.float32
    u = ((xu >> 8) + 1).to(f32) * 2.0 ** -24
    b = u.view(torch.int32)
    e = (b >> 23) - 127
    m = ((b & 0x7FFFFF) | 0x3F800000).view(f32)
    big = m > _K["SQRT2"]
    m = torch.where(big, m * 0.5, m)
    e = e + big.to(torch.int32)
    s = (m + -1.0) / (m + 1.0)
    s2 = s * s
    p = _K["L3"] + s2 * _K["L4"]
    for c in ("L2", "L1", "L0"):
        p = _K[c] + s2 * p
    lnm = s * p
    ef = e.to(f32)
    lnu = ef * _K["LN2_HI"] + (ef * _K["LN2_LO"] + lnm)
    # the square root correctly rounded, as the kernel's __fsqrt_rn: the
    # CPU's float32 torch.sqrt is not (it can be 1 ulp off), while a
    # float64 root rounded to float32 is, on any device
    r = torch.sqrt((lnu * -2.0).to(torch.float64)).to(f32)
    n = xa >> 8
    q = n >> 22
    a = ((n & 0x3FFFFF).to(f32) * 2.0 ** -22) * _K["HALF_PI"]
    a2 = a * a
    sp = _K["S5"] + a2 * _K["S6"]
    for c in ("S4", "S3", "S2", "S1"):
        sp = _K[c] + a2 * sp
    sn = a + a * (a2 * sp)
    cp = _K["C6"] + a2 * _K["C7"]
    for c in ("C5", "C4", "C3", "C2", "C1"):
        cp = _K[c] + a2 * cp
    cs = 1.0 + a2 * cp
    cos = torch.where(q == 0, cs, torch.where(q == 1, -sn,
                                              torch.where(q == 2, -cs, sn)))
    sin = torch.where(q == 0, sn, torch.where(q == 1, cs,
                                              torch.where(q == 2, -sn, -cs)))
    return r * cos, r * sin


def lane_noise_ref(seeds, images, steps, active, role: int, shape):
    """Per-lane standard normals: row s is the draw keyed by (seeds[s],
    images[s], role, steps[s]) of ``shape``, zeros where ``active`` is
    False.  Philox4x32-10 keyed by the 64-bit seed, counter (element quad,
    step, image, role), Box-Muller with fixed polynomials for ln, sin and
    cos: see ``csrc/lane_noise.cu``, whose output this equals bit for bit.
    seeds, images, steps: (S,) int64; active: (S,) bool.  Returns (S,) +
    shape float32 on seeds' device."""
    dev = seeds.device
    S = seeds.shape[0]
    D = math.prod(shape)
    quads = -(-D // 4)
    i64 = torch.int64
    seeds = seeds.to(i64)
    k0 = (seeds & _U32)[:, None]
    k1 = ((seeds >> 32) & _U32)[:, None]
    c0 = torch.arange(quads, dtype=i64, device=dev)[None, :]
    c1 = (steps.to(i64) & _U32)[:, None]
    c2 = (images.to(i64) & _U32)[:, None]
    c3 = torch.full((1, 1), int(role) & _U32, dtype=i64, device=dev)
    x0, x1, x2, x3 = philox4x32_10(
        [c0.expand(S, quads), c1.expand(S, quads), c2.expand(S, quads),
         c3.expand(S, quads)], k0, k1)
    z0, z1 = _box_muller(x0, x1)
    z2, z3 = _box_muller(x2, x3)
    z = torch.stack([z0, z1, z2, z3], dim=-1).reshape(S, 4 * quads)[:, :D]
    z = torch.where(active.to(torch.bool)[:, None], z, torch.zeros_like(z))
    return z.reshape((S,) + tuple(shape)).contiguous()
