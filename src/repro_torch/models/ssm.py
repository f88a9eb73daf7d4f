"""Mamba2 (SSD) block: the chunked scan for prefill and the O(1) decode step
(counterpart of ``repro/models/ssm.py``).

``ssm_forward`` computes the state-space mixing one of two ways:
``kernel="flash"`` (the default, the port's name for its hand-written
kernels) calls :func:`repro_torch.kernels.ops.ssm_scan`, the CUDA kernel on
a card and its plain version on the CPU; ``kernel="torch"`` is the
reference's own chunk loop, line for line, in plain PyTorch.  The rest of
the block (projections, causal conv, D skip, gated RMSNorm, output map) is
the same on both.

The dtype points are the reference's: the projections accumulate in float32
and are cast to x's dtype, except dt, which stays float32 through softplus;
the conv and silu run in float32 and are cast; the mixing and the D skip run
in float32, on float32 copies of x, B and C (the kernel is fed float32, so
it rounds y nowhere); the gated RMSNorm runs in float32 and is cast.

Layout: n_groups = 1 (B and C shared by every head, the Mamba2 default).
The decode step replaces the cache's entries, where the reference returns a
new cache.

On a model axis (a ``ctx`` with ``model`` > 1) the layer holds the slices
``param_specs`` gives it: w_z, w_x and w_dt by column, dt_bias, A_log, D
and norm_scale over the heads, w_out by row, w_B and w_C whole, and conv_w
/ conv_b as one contiguous block of the C = d_inner + 2N channels, which
does not line up with the heads.  Where the heads divide the axis a rank
runs its own heads (:class:`Split`): its z, x and dt columns, B and C
computed whole (their gradient summed over ``model``), its conv channels
[x_r, B, C] cut from the conv weights gathered for the call (all-gather,
the gradient reduce-scattered back to the spec's block), ``ssm_scan`` on
its heads, the gated RMSNorm's sum of squares summed over ``model`` both
ways, and a row-parallel w_out whose float32 partial sums are all-reduced
before the cast (the reference's einsum keeps float32 there).  Its decode
cache holds its heads' state and its own conv channels [x_r, B, C].  Where
the heads do not divide the axis they run replicated: the sharded weights'
blocks are gathered and only w_out stays row-parallel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (ShardCtx, copy_to, dense_f32,
                                      fsdp_gather, full_shape, gather_from,
                                      reduce_from, sharded_rmsnorm, split_to,
                                      tp, trunc_normal_)

KERNELS = ("flash", "torch")


class Mamba2(nn.Module):
    """The twelve parameters of ``ssm_init`` in the reference's layouts:
    w_z, w_x (d, d_inner); w_B, w_C (d, N); w_dt (d, nh); conv_w (W, C) and
    conv_b (C,) with C = d_inner + 2N; w_out (d_inner, d); norm_scale
    (d_inner,); dt_bias, A_log and D (nh,) in float32."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner_ssm
        nh, n = cfg.ssm_heads, cfg.ssm_state
        conv_c = di + 2 * n
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.w_z = nn.Parameter(torch.empty(d, di, **kw))
        self.w_x = nn.Parameter(torch.empty(d, di, **kw))
        self.w_B = nn.Parameter(torch.empty(d, n, **kw))
        self.w_C = nn.Parameter(torch.empty(d, n, **kw))
        self.w_dt = nn.Parameter(torch.empty(d, nh, **kw))
        self.dt_bias = nn.Parameter(torch.zeros(nh, **f32))
        self.conv_w = nn.Parameter(torch.empty(cfg.conv_width, conv_c, **kw))
        self.conv_b = nn.Parameter(torch.zeros(conv_c, **kw))
        self.A_log = nn.Parameter(torch.zeros(nh, **f32))   # A = -exp(0) = -1
        self.D = nn.Parameter(torch.ones(nh, **f32))
        self.norm_scale = nn.Parameter(torch.ones(di, **kw))
        self.w_out = nn.Parameter(torch.empty(di, d, **kw))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fan-in truncated normals for the matrices (fan-in d, the conv's
        width W, d_inner for w_out); zeros for dt_bias, A_log and conv_b;
        ones for D and norm_scale, as ``ssm_init``."""
        d = full_shape(self.w_z)[0]
        for w in (self.w_z, self.w_x, self.w_B, self.w_C, self.w_dt):
            trunc_normal_(w, d, generator)
        trunc_normal_(self.conv_w, full_shape(self.conv_w)[0], generator)
        trunc_normal_(self.w_out, full_shape(self.w_out)[0], generator)
        for z in (self.dt_bias, self.A_log, self.conv_b):
            z.zero_()
        self.D.fill_(1.0)
        self.norm_scale.fill_(1.0)


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv along S in float32, cast to xbc's dtype.
    xbc: (B, S, C); conv_w: (W, C)."""
    w, s = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(w):
        out = out + pad[:, i:i + s].to(torch.float32) * \
            conv_w[i].to(torch.float32)
    return (out + conv_b.to(torch.float32)).to(xbc.dtype)


def _gated_rmsnorm(y, z, scale, eps=1e-5):
    """Mamba2 output norm: RMSNorm(y · silu(z)) · scale, in float32."""
    return _rms(y.to(torch.float32) * F.silu(z.to(torch.float32)), scale,
                eps)


def _rms(y, scale, eps):
    """float32 y / rms(y) · scale."""
    var = y.square().mean(dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * scale.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Split:
    """How a Mamba2 layer lies over the model axis of ``ctx``: ``cols``
    when d_inner's columns are sharded (w_z, w_x, norm_scale, w_out),
    ``heads`` when the heads are too (w_dt, dt_bias, A_log, D: this rank
    runs its own), ``conv`` when conv_w and conv_b hold the spec's block
    of the channels.  All False without a model axis."""

    ctx: Optional[ShardCtx] = None
    cols: bool = False
    heads: bool = False
    conv: bool = False

    @classmethod
    def of(cls, p: "Mamba2", cfg: ModelConfig,
           ctx: Optional[ShardCtx]) -> "Split":
        if not tp(ctx):
            return cls()
        di, n = cfg.d_inner_ssm, cfg.ssm_state
        return cls(ctx, cols=p.w_x.shape[1] != di,
                   heads=heads_split(cfg, ctx),
                   conv=p.conv_w.shape[1] != di + 2 * n)

    def _args(self):
        return self.ctx.mesh, self.ctx.model_axis

    def proj_input(self, x):
        """x as the column-parallel maps take it: its gradient summed over
        ``model``."""
        return copy_to(x, *self._args()) if self.cols else x

    def whole(self, t, dim: int = -1):
        """A column block made whole for replicated work (the heads not
        dividing the axis)."""
        return gather_from(t, *self._args(), dim) if self.cols and \
            not self.heads else t

    def conv_weights(self, p: "Mamba2", cfg: ModelConfig):
        """(conv_w, conv_b) of the channels this rank convolves: all C of
        them, or with its own heads [x_r, B, C]."""
        # the bias rides as the weights' last row: one collective a call
        wb = torch.cat([p.conv_w, p.conv_b[None]])             # (W + 1, C)
        if self.heads:
            # every rank reads B and C: gathered for the call, the
            # gradient reduce-scattered (or, held whole, summed)
            wb = fsdp_gather(wb, *self._args(), 1) if self.conv \
                else copy_to(wb, *self._args())
            di = cfg.d_inner_ssm
            wl = di // self.ctx.model_size
            lo = self.ctx.model_rank * wl
            wb = torch.cat([wb[:, lo:lo + wl], wb[:, di:]], dim=1)
        elif self.conv:
            wb = gather_from(wb, *self._args(), 1)
        else:
            return p.conv_w, p.conv_b
        return wb[:-1], wb[-1]

    def shared_bc(self, bc):
        """B and C (whole) as the rank's heads read them: their gradient
        summed over ``model``."""
        return copy_to(bc, *self._args()) if self.heads else bc

    def norm_out(self, y, z, p: "Mamba2", cfg: ModelConfig, dtype):
        """The gated RMSNorm and w_out: (B, ..., d) in ``dtype``."""
        if not self.cols:
            y = _gated_rmsnorm(y, z, p.norm_scale, cfg.norm_eps).to(dtype)
            return y @ p.w_out
        y = y.to(torch.float32) * F.silu(z.to(torch.float32))
        if self.heads:
            y = sharded_rmsnorm(y, p.norm_scale, cfg.norm_eps,
                                cfg.d_inner_ssm, self.ctx)
        else:
            y = split_to(_rms(y, self.whole(p.norm_scale, 0), cfg.norm_eps),
                         *self._args(), -1)
        out = dense_f32(y.to(dtype), p.w_out)
        return reduce_from(out, *self._args()).to(dtype)


def heads_split(cfg: ModelConfig, ctx: Optional[ShardCtx]) -> bool:
    """Whether a rank runs its own heads on the model axis of ``ctx``:
    ``param_specs`` (and ``cache_specs``) split the heads' leaves over
    ``model`` where the heads divide it."""
    return tp(ctx) and cfg.ssm_heads % ctx.model_size == 0


def conv_channels(cfg: ModelConfig, ctx: Optional[ShardCtx]) -> int:
    """The channels of the conv history a rank's decode cache holds (its
    "conv" leaf's last dim): d_inner + 2N, or with its own heads on a model
    axis d_inner / M + 2N ([x_r, B, C])."""
    di, n = cfg.d_inner_ssm, cfg.ssm_state
    if heads_split(cfg, ctx):
        return di // ctx.model_size + 2 * n
    return di + 2 * n


def _chunk_len(s: int, cfg: ModelConfig) -> int:
    c = cfg.ssm_chunk
    while s // c > 32:            # cap the chunk count, as the reference
        c *= 2
    return min(c, s)


def _in_proj(x, p: Mamba2, sp: Split = Split()):
    """z, x_in, B, C in x's dtype and dt in float32 (pre-softplus); on a
    model axis z, x_in and dt as the rank's heads read them (its columns,
    or whole)."""
    xs = sp.proj_input(x)
    z = sp.whole(xs @ p.w_z)
    xi = sp.whole(xs @ p.w_x)
    bm = x @ p.w_B
    cm = x @ p.w_C
    dt = (xs if sp.heads else x).to(torch.float32) @ \
        p.w_dt.to(torch.float32)
    return z, xi, bm, cm, dt


def _chunked_mixing(xh, dt, a, bm, cm, l: int):
    """The reference's chunk loop (``repro/models/ssm.py:94-122``): y
    (B, S, nh, P) in float32."""
    b, s, nh, hd = xh.shape
    n = bm.shape[-1]
    nc = s // l
    if nc * l != s:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {l}")
    f32 = torch.float32
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=xh.device))
    state = torch.zeros((b, nh, n, hd), dtype=f32, device=xh.device)
    y_chunks = []
    for c in range(nc):
        sl = slice(c * l, (c + 1) * l)
        dtc = dt[:, sl]                                        # (B,L,nh)
        cum = torch.cumsum(dtc * a, dim=1)                     # inclusive
        xc = xh[:, sl].to(f32)                                 # (B,L,nh,hd)
        bc = bm[:, sl].to(f32)                                 # (B,L,n)
        cc = cm[:, sl].to(f32)
        # intra-chunk quadratic term
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # (B,L,L,nh) t,s
        # above the diagonal seg > 0 and exp may overflow: masked to -inf
        # before the exp (the reference selects after it, the same values),
        # so the backward multiplies no zero by an inf
        m = torch.exp(seg.masked_fill(~tri[None, :, :, None], -math.inf))
        g = torch.einsum("btn,bsn->bts", cc, bc)               # (B,L,L)
        w = g[:, :, :, None] * m * dtc[:, None, :, :]          # (B,t,s,nh)
        y = torch.einsum("btsh,bshp->bthp", w, xc)             # (B,L,nh,hd)
        # inter-chunk contribution from the carried state
        y = y + torch.einsum("btn,bhnp->bthp", cc, state) * \
            torch.exp(cum)[:, :, :, None]
        # state update to the end of the chunk
        decay_end = torch.exp(cum[:, -1:, :] - cum)            # (B,L,nh)
        upd = torch.einsum("bsn,bshp->bhnp", bc,
                           xc * (dtc * decay_end)[..., None])
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + upd
        y_chunks.append(y)
    return torch.cat(y_chunks, dim=1)                          # (B,S,nh,hd)


def ssm_forward(x, p: Mamba2, cfg: ModelConfig, *, kernel: str = "flash",
                ctx: Optional[ShardCtx] = None):
    """x: (B, S, d) -> (B, S, d) in x's dtype.  Full-sequence (prefill)
    path; ``kernel`` picks the mixing ("flash": ``ops.ssm_scan``; "torch":
    the reference's chunk loop).  On a model axis (``ctx``) the rank runs
    its heads (:class:`Split`)."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
    b, s, _ = x.shape
    sp = Split.of(p, cfg, ctx)
    f32 = torch.float32
    z, xi, bm, cm, dt = _in_proj(x, p, sp)
    di, nh, n, hd = xi.shape[-1], dt.shape[-1], cfg.ssm_state, \
        cfg.ssm_head_dim
    xbc = torch.cat([xi, sp.shared_bc(torch.cat([bm, cm], dim=-1))], dim=-1)
    conv_w, conv_b = sp.conv_weights(p, cfg)
    xbc = F.silu(_causal_conv(xbc, conv_w, conv_b).to(f32)).to(x.dtype)
    xi, bm, cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt + p.dt_bias)                            # (B,S,nh) f32
    a = -torch.exp(p.A_log)                                    # (nh,) f32
    xh = xi.reshape(b, s, nh, hd)
    if kernel == "flash":
        y = ops.ssm_scan(xh.to(f32).contiguous(), dt, a,
                         bm.to(f32).contiguous(), cm.to(f32).contiguous())
    else:
        y = _chunked_mixing(xh, dt, a, bm, cm, _chunk_len(s, cfg))
    y = y + p.D[None, None, :, None] * xh.to(f32)
    return sp.norm_out(y.reshape(b, s, di), z, p, cfg, x.dtype)


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    """Zeroed decode cache: state (B, nh, N, P) float32 and the conv's
    history (B, W - 1, d_inner + 2N) in ``dtype`` (on a model axis a rank
    holds its heads' state and :func:`conv_channels` channels)."""
    di, nh, n = cfg.d_inner_ssm, cfg.ssm_heads, cfg.ssm_state
    return {"state": torch.zeros((batch, nh, n, cfg.ssm_head_dim),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * n),
                                dtype=dtype, device=device)}


def ssm_decode(x, p: Mamba2, cache: Dict[str, torch.Tensor],
               cfg: ModelConfig, ctx: Optional[ShardCtx] = None):
    """One token.  x: (B, 1, d).  Returns (out (B, 1, d), cache), the
    cache's ``state`` and ``conv`` replaced by their next values.  On a
    model axis the rank's heads, as :func:`ssm_forward`."""
    b = x.shape[0]
    sp = Split.of(p, cfg, ctx)
    f32 = torch.float32
    z, xi, bm, cm, dt = (t[:, 0] for t in _in_proj(x, p, sp))
    di, nh, n, hd = xi.shape[-1], dt.shape[-1], cfg.ssm_state, \
        cfg.ssm_head_dim
    xbc = torch.cat([xi, sp.shared_bc(torch.cat([bm, cm], dim=-1))],
                    dim=-1)                                    # (B,C)
    conv_hist = torch.cat([cache["conv"], xbc[:, None]], dim=1)
    conv_w, conv_b = sp.conv_weights(p, cfg)
    out = (conv_hist.to(f32) * conv_w.to(f32)[None]).sum(dim=1) + \
        conv_b.to(f32)
    xbc = F.silu(out).to(x.dtype)
    xi, bm, cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt + p.dt_bias)                            # (B,nh)
    a = -torch.exp(p.A_log)
    xhead = xi.reshape(b, nh, hd).to(f32)
    decay = torch.exp(dt * a)                                  # (B,nh)
    upd = torch.einsum("bn,bhp->bhnp", bm.to(f32), xhead * dt[..., None])
    state = cache["state"] * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", cm.to(f32), state)
    y = y + p.D[None, :, None] * xhead
    out = sp.norm_out(y.reshape(b, di), z, p, cfg, x.dtype)
    cache["state"] = state
    cache["conv"] = conv_hist[:, 1:]
    return out[:, None], cache
