"""xLSTM blocks: the chunked-parallel mLSTM and the sequential sLSTM
(counterpart of ``repro/models/xlstm.py``).

The mLSTM keeps a matrix memory per head, C_t = f_t·C_{t-1} + i_t·(k_t
v_tᵀ), with sigmoid input and forget gates, and reads h_t = (C_t q_t) /
max(|n_t·q_t|, 1), n_t the gated sum of the keys.  A prefill runs it in
chunks of :func:`mlstm_chunk_len` positions: inside a chunk as a masked
(L, L) product, across chunks through the carried state.  Its decode runs
the recurrence one token at a time.  The sLSTM keeps the paper's
exponential gating with a log-space stabiliser; its prefill is a Python
loop over the sequence (the reference's ``lax.scan``), four (B, d)·(d, d)
float32 products and the gates a step.

The dtype points are the reference's: the up projection and q, k, v are
rounded to x's dtype and the chunks computed in float32; the gate branch
``g`` and the gates (float32 ``w_i``, ``w_f``, ``f_bias``) stay float32;
decode keeps q, k and v in float32 unrounded.  The sLSTM runs in float32
and its GELU is the tanh approximation (``jax.nn.gelu``'s default).  No
Pallas kernel lies on this path in the reference, and none here.

On a model axis (a ``ctx`` with ``model`` > 1) the blocks hold what the
reference's rules give their leaves by name: the mLSTM's w_up and
w_gate_up by column, norm_scale over d_inner and w_down by row, its other
maps whole; the sLSTM's w_z (Mamba2's rule) and w_up by column,
norm_scale over d and w_down by row, its gates' other maps, biases and
recurrent maps whole.  An mLSTM whose heads divide the axis runs its own
heads: u gathered from the column blocks (its gradient reduce-scattered
back), q, k, v and the gates of its heads through its columns of the whole
maps (their gradients summed over ``model``), its cache's state and norm
its heads', the output RMSNorm's sum of squares summed both ways, and
w_down row-parallel with float32 partial sums all-reduced before the cast.
Otherwise (its heads not dividing the axis) the heads run replicated on
the gathered blocks.  The sLSTM's recurrence runs replicated on every
rank: its z input gathered from w_z's columns, its norm_scale gathered,
and its w_up / w_down a tensor-parallel MLP.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import (ShardCtx, copy_to, dense_f32,
                                      fsdp_gather, full_shape, gather_from,
                                      reduce_from, rmsnorm, sharded_rmsnorm,
                                      split_to, tp, trunc_normal_)

# the sLSTM stabiliser's start, as the reference's
M_INIT = -1e9


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
class MLSTM(nn.Module):
    """``mlstm_init``'s leaves (d_inner = 2d, nh heads): w_up and w_gate_up
    (d, di); w_q, w_k, w_v (di, di); w_i, w_f (di, nh) and f_bias (nh,) in
    float32; norm_scale (di,); w_down (di, d)."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        di = 2 * d
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.w_up = nn.Parameter(torch.empty(d, di, **kw))
        self.w_gate_up = nn.Parameter(torch.empty(d, di, **kw))
        self.w_q = nn.Parameter(torch.empty(di, di, **kw))
        self.w_k = nn.Parameter(torch.empty(di, di, **kw))
        self.w_v = nn.Parameter(torch.empty(di, di, **kw))
        self.w_i = nn.Parameter(torch.empty(di, nh, **f32))
        self.w_f = nn.Parameter(torch.empty(di, nh, **f32))
        self.f_bias = nn.Parameter(torch.full((nh,), 3.0, **f32))
        self.norm_scale = nn.Parameter(torch.ones(di, **kw))
        self.w_down = nn.Parameter(torch.empty(di, d, **kw))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fan-in truncated normals (d for the up maps, di for the rest);
        f_bias 3 (a forget gate near 1) and norm_scale ones, as
        ``mlstm_init``."""
        for w in (self.w_up, self.w_gate_up, self.w_q, self.w_k, self.w_v,
                  self.w_i, self.w_f, self.w_down):
            trunc_normal_(w, full_shape(w)[0], generator)
        self.f_bias.fill_(3.0)
        self.norm_scale.fill_(1.0)


def mlstm_chunk_len(s: int) -> int:
    """The reference's ``_mlstm_chunk_len``: 256 positions (all S when
    shorter), doubled until there are at most 32 chunks."""
    c = min(s, 256)
    while s // c > 32:
        c *= 2
    return c


@dataclasses.dataclass(frozen=True)
class MSplit:
    """How an mLSTM lies over the model axis of ``ctx``: ``cols`` when
    d_inner's columns are sharded (w_up, w_gate_up, norm_scale, w_down),
    ``heads`` when the heads divide the axis too (this rank runs its own).
    All False without a model axis."""

    ctx: Optional[ShardCtx] = None
    cols: bool = False
    heads: bool = False

    @classmethod
    def of(cls, p: MLSTM, cfg: ModelConfig,
           ctx: Optional[ShardCtx]) -> "MSplit":
        if not tp(ctx) or p.w_up.shape[1] == 2 * cfg.d_model:
            return cls()
        return cls(ctx, cols=True,
                   heads=cfg.n_heads % ctx.model_size == 0)

    def _args(self):
        return self.ctx.mesh, self.ctx.model_axis

    def up(self, x, p: MLSTM):
        """(u as the rank's heads read it: whole, in x's dtype; g, this
        rank's columns of the gate branch in float32)."""
        if not self.cols:
            return x @ p.w_up, dense_f32(x, p.w_gate_up)
        xs = copy_to(x, *self._args())
        u, g = xs @ p.w_up, dense_f32(xs, p.w_gate_up)
        if self.heads:
            # each rank reads all of u for its heads: the gradient is a
            # part of the whole, summed back onto the owner's block
            return fsdp_gather(u, *self._args(), -1), g
        return gather_from(u, *self._args(), -1), g

    def maps(self, p: MLSTM):
        """(w_q, w_k, w_v, w_i, w_f, f_bias) of the rank's heads: column
        slices of the whole maps, their gradients summed over ``model``."""
        ws = (p.w_q, p.w_k, p.w_v, p.w_i, p.w_f, p.f_bias)
        if not self.heads:
            return ws
        n, r = self.ctx.model_size, self.ctx.model_rank
        out = []
        for w in ws:
            w = copy_to(w, *self._args())
            c = w.shape[-1] // n
            out.append(w[..., r * c:(r + 1) * c])
        return tuple(out)

    def out(self, h, g, p: MLSTM, cfg: ModelConfig, dtype):
        """RMSNorm(h) · silu(g), down-projected, in ``dtype``."""
        if not self.cols:
            h = rmsnorm(h.to(dtype), p.norm_scale, cfg.norm_eps)
            return (h * F.silu(g).to(dtype)) @ p.w_down
        if self.heads:
            h = sharded_rmsnorm(h.to(dtype), p.norm_scale, cfg.norm_eps,
                                2 * cfg.d_model, self.ctx)
        else:
            h = rmsnorm(h.to(dtype), gather_from(p.norm_scale,
                                                 *self._args(), 0),
                        cfg.norm_eps)
            h = split_to(h, *self._args(), -1)
        out = dense_f32(h * F.silu(g).to(dtype), p.w_down)
        return reduce_from(out, *self._args()).to(dtype)


def _mlstm_gates(u: torch.Tensor, w_i, w_f, f_bias):
    """Input and forget gates (..., nh) in float32 from u in x's dtype."""
    uf = u.to(torch.float32)
    return torch.sigmoid(uf @ w_i), torch.sigmoid(uf @ w_f + f_bias)


def mlstm_forward(x, p: MLSTM, cfg: ModelConfig,
                  ctx: Optional[ShardCtx] = None):
    """x: (B, S, d) -> (B, S, d) in x's dtype, in chunks of
    :func:`mlstm_chunk_len` (S must be a whole number of them).  On a
    model axis (``ctx``) the rank's heads (:class:`MSplit`)."""
    b, s, d = x.shape
    sp = MSplit.of(p, cfg, ctx)
    w_q, w_k, w_v, w_i, w_f, f_bias = sp.maps(p)
    di, nh = w_q.shape[1], w_i.shape[1]
    hd = 2 * d // cfg.n_heads
    f32 = torch.float32
    u, g = sp.up(x, p)
    q = (u @ w_q).reshape(b, s, nh, hd) * (hd ** -0.5)
    k = (u @ w_k).reshape(b, s, nh, hd)
    v = (u @ w_v).reshape(b, s, nh, hd)
    ig, fg = _mlstm_gates(u, w_i, w_f, f_bias)                 # (B,S,nh)
    l = mlstm_chunk_len(s)
    nc = s // l
    if nc * l != s:
        raise ValueError(f"mLSTM: S {s} is not a multiple of its chunk {l}")
    state = torch.zeros((b, nh, hd, hd), dtype=f32, device=x.device)
    norm = torch.zeros((b, nh, hd), dtype=f32, device=x.device)
    tri = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    outs = []
    for c in range(nc):
        sl = slice(c * l, (c + 1) * l)
        qc, kc, vc = q[:, sl].to(f32), k[:, sl].to(f32), v[:, sl].to(f32)
        ic = ig[:, sl]                                         # (B,L,nh)
        cum = torch.cumsum(torch.log(torch.clamp_min(fg[:, sl], 1e-9)), 1)
        # intra-chunk: w(t, s) = exp(cum_t - cum_s) · i_s for s <= t; above
        # the diagonal exp overflows, so seg is masked to -inf before the
        # exp (never a mask multiplied in, and no inf for the backward to
        # multiply by a zero)
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # (B,t,s,nh)
        wts = torch.exp(seg.masked_fill(~tri[None, :, :, None], -math.inf)) \
            * ic[:, None, :, :]
        sc = torch.einsum("bthd,bshd->btsh", qc, kc)
        y = torch.einsum("btsh,bshp->bthp", sc * wts, vc)
        decay = torch.exp(cum)                                 # (B,L,nh)
        y = y + torch.einsum("bthd,bhdp->bthp", qc, state) * decay[..., None]
        # normaliser q_t · (Σ_s w(t, s) k_s + decayed carried norm), taken
        # as (w · k) then · q: no (B, L, L, nh, hd) temporary
        wk = torch.einsum("btsh,bshd->bthd", wts, kc)
        nvec = (wk * qc).sum(-1) + \
            torch.einsum("bthd,bhd->bth", qc, norm) * decay
        outs.append(y / torch.clamp_min(nvec.abs(), 1.0)[..., None])
        end = torch.exp(cum[:, -1])                            # (B,nh)
        wstate = ic * torch.exp(cum[:, -1:, :] - cum)          # (B,L,nh)
        state = state * end[:, :, None, None] + torch.einsum(
            "bshd,bshp->bhdp", kc * wstate[..., None], vc)
        norm = norm * end[:, :, None] + torch.einsum("bshd,bsh->bhd", kc,
                                                    wstate)
    h = torch.cat(outs, dim=1).reshape(b, s, di)
    return sp.out(h, g, p, cfg, x.dtype)


def mlstm_init_cache(cfg: ModelConfig, batch: int, device
                     ) -> Dict[str, torch.Tensor]:
    """Zeroed decode cache in float32: state (B, nh, hd, hd) and norm
    (B, nh, hd)."""
    nh = cfg.n_heads
    hd = 2 * cfg.d_model // nh
    return {"state": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                                 device=device),
            "norm": torch.zeros((batch, nh, hd), dtype=torch.float32,
                                device=device)}


def mlstm_decode(x, p: MLSTM, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig, ctx: Optional[ShardCtx] = None):
    """One token of the recurrence.  x: (B, 1, d).  Returns (out (B, 1, d),
    cache), the cache's entries replaced by their next values.  On a model
    axis the rank's heads, as :func:`mlstm_forward`."""
    b = x.shape[0]
    sp = MSplit.of(p, cfg, ctx)
    w_q, w_k, w_v, w_i, w_f, f_bias = sp.maps(p)
    di, nh = w_q.shape[1], w_i.shape[1]
    hd = 2 * cfg.d_model // cfg.n_heads
    u, g = (t[:, 0] for t in sp.up(x, p))
    q = dense_f32(u, w_q).reshape(b, nh, hd) * (hd ** -0.5)
    k = dense_f32(u, w_k).reshape(b, nh, hd)
    v = dense_f32(u, w_v).reshape(b, nh, hd)
    ig, fg = _mlstm_gates(u, w_i, w_f, f_bias)                 # (B,nh)
    state = cache["state"] * fg[:, :, None, None] + \
        ig[:, :, None, None] * torch.einsum("bhd,bhp->bhdp", k, v)
    norm = cache["norm"] * fg[:, :, None] + ig[:, :, None] * k
    y = torch.einsum("bhd,bhdp->bhp", q, state)
    nv = torch.einsum("bhd,bhd->bh", q, norm)
    h = (y / torch.clamp_min(nv.abs(), 1.0)[..., None]).reshape(b, di)
    cache["state"], cache["norm"] = state, norm
    return sp.out(h, g, p, cfg, x.dtype)[:, None], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
GATES = ("i", "f", "z", "o")


class SLSTM(nn.Module):
    """``slstm_init``'s leaves: b (4, d) float32 (the gates' biases in the
    order i, f, z, o); norm_scale (d,); w_up (d, 2d); w_down (2d, d); and
    for each gate an input map w_<g> and a recurrent map r_<g> (d, d)."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        d = cfg.d_model
        kw = dict(dtype=dtype, device=device)
        self.b = nn.Parameter(torch.zeros(4, d, dtype=torch.float32,
                                          device=device))
        self.norm_scale = nn.Parameter(torch.ones(d, **kw))
        self.w_up = nn.Parameter(torch.empty(d, 2 * d, **kw))
        self.w_down = nn.Parameter(torch.empty(2 * d, d, **kw))
        for name in GATES:
            setattr(self, f"w_{name}", nn.Parameter(torch.empty(d, d, **kw)))
            setattr(self, f"r_{name}", nn.Parameter(torch.empty(d, d, **kw)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fan-in truncated normals for the maps, zero biases and unit
        norm scale, as ``slstm_init``."""
        for name in GATES:
            for w in (getattr(self, f"w_{name}"), getattr(self, f"r_{name}")):
                trunc_normal_(w, full_shape(w)[0], generator)
        trunc_normal_(self.w_up, full_shape(self.w_up)[0], generator)
        trunc_normal_(self.w_down, full_shape(self.w_down)[0], generator)
        self.b.zero_()
        self.norm_scale.fill_(1.0)

    def recurrent(self):
        """The four recurrent maps in float32, in gate order."""
        return [getattr(self, f"r_{n}").to(torch.float32) for n in GATES]


def _slstm_pre(xf: torch.Tensor, p: SLSTM,
               ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The gates' input parts (4, ..., d) in float32 from float32 x; a
    gate map held by column on a model axis (w_z) gathered."""
    out = []
    for i, n in enumerate(GATES):
        w = getattr(p, f"w_{n}").to(torch.float32)
        if w.shape[1] != w.shape[0]:
            mesh, axis = ctx.mesh, ctx.model_axis
            pre = gather_from(copy_to(xf, mesh, axis) @ w, mesh, axis, -1)
        else:
            pre = xf @ w
        out.append(pre + p.b[i])
    return torch.stack(out)


def _slstm_step(r, carry, xt):
    """One step of the stabilised recurrence.  r: the recurrent maps; carry
    (c, n, h, m) and each of xt's four gate inputs (B, d) in float32."""
    c, n, h, m = carry
    wi, wf, wz, wo = xt
    it = wi + h @ r[0]
    ft = wf + h @ r[1]
    zt = torch.tanh(wz + h @ r[2])
    ot = torch.sigmoid(wo + h @ r[3])
    m_new = torch.maximum(ft + m, it)              # stabiliser (log space)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m - m_new)
    c = f_ * c + i_ * zt
    n = f_ * n + i_
    h = ot * c / torch.clamp_min(n, 1.0)
    return c, n, h, m_new


def _slstm_out(hs: torch.Tensor, p: SLSTM, cfg: ModelConfig, dtype,
               ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """RMSNorm, the up map with a float32 result, tanh GELU, the down map,
    in ``dtype``.  On a model axis the norm's scale is gathered and the
    up and down maps run tensor-parallel, the down map's float32 partial
    sums all-reduced before the cast."""
    d = cfg.d_model
    scale = p.norm_scale
    if tp(ctx) and scale.shape[0] != d:
        scale = gather_from(scale, ctx.mesh, ctx.model_axis, 0)
    hs = rmsnorm(hs.to(dtype), scale, cfg.norm_eps)
    if not tp(ctx) or p.w_up.shape[1] == 2 * d:
        u = F.gelu(dense_f32(hs, p.w_up), approximate="tanh").to(dtype)
        return u @ p.w_down
    mesh, axis = ctx.mesh, ctx.model_axis
    u = F.gelu(dense_f32(copy_to(hs, mesh, axis), p.w_up),
               approximate="tanh").to(dtype)
    return reduce_from(dense_f32(u, p.w_down), mesh, axis).to(dtype)


def slstm_init_cache(cfg: ModelConfig, batch: int, device
                     ) -> Dict[str, torch.Tensor]:
    """c, n, h zeros and the stabiliser m at ``M_INIT``, (B, d) float32."""
    shape = (batch, cfg.d_model)

    def z():
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full(shape, M_INIT, dtype=torch.float32,
                            device=device)}


def slstm_forward(x, p: SLSTM, cfg: ModelConfig,
                  ctx: Optional[ShardCtx] = None):
    """x: (B, S, d) -> (B, S, d) in x's dtype: the recurrence over S, one
    step at a time (on every rank of a model axis)."""
    b = x.shape[0]
    pre = _slstm_pre(x.to(torch.float32), p, ctx)              # (4,B,S,d)
    r = p.recurrent()
    st = slstm_init_cache(cfg, b, x.device)
    carry = (st["c"], st["n"], st["h"], st["m"])
    hs = []
    for xt in pre.unbind(2):                    # one op, not S selects
        carry = _slstm_step(r, carry, xt)
        hs.append(carry[2])
    return _slstm_out(torch.stack(hs, dim=1), p, cfg, x.dtype, ctx)


def slstm_decode(x, p: SLSTM, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig, ctx: Optional[ShardCtx] = None):
    """One step.  x: (B, 1, d).  Returns (out (B, 1, d), cache), the cache's
    entries replaced by their next values."""
    pre = _slstm_pre(x.to(torch.float32)[:, 0], p, ctx)        # (4,B,d)
    carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    c, n, h, m = _slstm_step(p.recurrent(), carry, pre)
    cache.update(c=c, n=n, h=h, m=m)
    return _slstm_out(h, p, cfg, x.dtype, ctx)[:, None], cache
