"""Mixture-of-Experts layer: the top-k router and capacity-limited dispatch
on one device (counterpart of the single-device path of
``repro/models/moe.py``).

A token's router logits are ``x · router`` in float32 (the router stays
float32 in a bf16 model); softmax over the E experts, the top ``k``, and
the k probabilities renormalised.  Each expert takes at most ``capacity =
max(1, ceil(N·k·cf / E))`` of the N·k assignments: an assignment's slot is
the count of earlier assignments to the same expert, row-major over
(token, k) (the Switch/t5x convention), and one whose slot reaches the
capacity is dropped and contributes exactly zero.  The kept tokens are
scattered into an (E, C, d) buffer, the experts run as batched SwiGLU
products over E, and each token gathers its k outputs back, weighted by
its renormalised probabilities, in float32.  The shared experts, if any,
are one SwiGLU over every token, added after.  The aux loss is Switch's
``E · Σ_e f_e · p_e`` (f_e the share of assignments routed to e, p_e its
mean router probability).

The dtype points are the reference's: the gate and up products come out in
float32 (bf16 operands accumulate in float32, the result is not rounded),
silu·up is cast to the activation dtype, the down product is rounded once
to it; the combine weights are rounded to the activation dtype and summed
in float32.  The expert products are plain batched matrix products, as in
the reference, which computes them outside any Pallas kernel.

On a mesh whose model axis divides E the experts are sharded over
``model`` (E/ep a rank) and ``moe_forward`` takes the reference's two
expert-parallel paths, by its conditions (``repro/models/moe.py:206-245``)
on the global token count n:

* **all-to-all** (n divides into data·ep blocks of at least ep tokens):
  the flattened tokens are cut into data·ep contiguous blocks, data-major;
  a rank routes its block at the block's own capacity, scatters it into
  (E, C, d), exchanges it (``all_to_all`` over ``model``) so that it holds
  its experts' rows from every block, runs its experts, exchanges back and
  combines; the aux loss is averaged over ``model``.  Tokens drop by each
  block's capacity, not the whole batch's: the reference's EP semantics.
* **replicated** (decode): the tokens stay whole over ``model`` (cut over
  the data axes where n divides), every rank routes them all at their
  capacity, keeps the assignments to its own experts (``keep & mine``),
  and the outputs are summed over ``model``.

Otherwise (no mesh, one model rank, or E not dividing it) the single
device path runs over every token of the global batch.  The shared
experts take the MLP's tensor parallelism.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import (MLP, ShardCtx, copy_to, exchange,
                                      full_shape, gather_from, matmul_f32,
                                      reduce_from, split_to, trunc_normal_)


class MoE(nn.Module):
    """``moe_init``'s parameters in the reference's layouts: the router
    (d, E) in float32; w_gate and w_up (E, d, f), w_down (E, f, d); and,
    with shared experts, ``shared`` (an :class:`MLP` of width
    n_shared · f)."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
        kw = dict(dtype=dtype, device=device)
        self.router = nn.Parameter(torch.empty(d, e, dtype=torch.float32,
                                               device=device))
        self.w_gate = nn.Parameter(torch.empty(e, d, f, **kw))
        self.w_up = nn.Parameter(torch.empty(e, d, f, **kw))
        self.w_down = nn.Parameter(torch.empty(e, f, d, **kw))
        self.shared = MLP(d, cfg.n_shared_experts * f, dtype, device) \
            if cfg.n_shared_experts else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fan-in truncated normals: d for the router, w_gate and w_up, f
        for w_down (each expert's own fan-in, not E).  ``shared`` is an
        :class:`MLP` and draws its own."""
        d, f = full_shape(self.w_gate)[1], full_shape(self.w_gate)[2]
        for w in (self.router, self.w_gate, self.w_up):
            trunc_normal_(w, d, generator)
        trunc_normal_(self.w_down, f, generator)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------
def router_topk(x_flat: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """x_flat (N, d) -> (top_p (N, k) float32, top_i (N, k) int32, aux).

    ``torch.topk(sorted=True)`` orders the k winners by probability as
    ``lax.top_k`` does; only on exact ties may the two pick or order
    experts differently."""
    logits = x_flat.to(torch.float32) @ w_router
    probs = torch.softmax(logits, dim=-1)                     # (N, E)
    top_p, top_i = torch.topk(probs, top_k, dim=-1, sorted=True)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    e = logits.shape[-1]
    counts = torch.bincount(top_i.reshape(-1), minlength=e)
    f_e = counts.to(torch.float32) / x_flat.shape[0] / top_k
    p_e = probs.mean(dim=0)
    aux = e * torch.sum(f_e * p_e)
    return top_p, top_i.to(torch.int32), aux


def capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    """Slots an expert holds: ``max(1, ceil(N·k·cf / E))``."""
    return max(1, int(math.ceil(n_tokens * top_k * cf / n_experts)))


def dispatch_indices(top_i: torch.Tensor, n_experts: int, capacity: int):
    """top_i (N, k) -> (pos (N, k) int32, keep (N, k) bool): an
    assignment's slot is the running count of earlier assignments to the
    same expert, row-major over (token, k); it is kept when the slot is
    below ``capacity``."""
    n, k = top_i.shape
    flat = top_i.reshape(-1).long()
    # F.one_hot's values without its range checks, which read the ids on
    # the host on some devices (not CUDA) and cannot on meta
    onehot = torch.zeros((n * k, n_experts), dtype=torch.int32,
                         device=flat.device).scatter_(1, flat[:, None], 1)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = pos_in_e.gather(1, flat[:, None])[:, 0]
    return pos.reshape(n, k), (pos < capacity).reshape(n, k)


def scatter_dispatch(x_flat, top_i, pos, keep, n_experts: int,
                     capacity: int) -> torch.Tensor:
    """The (E, C, d) buffer of kept tokens in x's dtype: token n's row at
    [top_i[n, j], pos[n, j]] for each kept j, zeros elsewhere (a dropped
    assignment adds zeros at [0, 0])."""
    n, k = top_i.shape
    buf = torch.zeros((n_experts, capacity, x_flat.shape[-1]),
                      dtype=x_flat.dtype, device=x_flat.device)
    e_flat = torch.where(keep, top_i, 0).reshape(-1).long()
    p_flat = torch.where(keep, pos, 0).reshape(-1).long()
    w_flat = keep.reshape(-1).to(x_flat.dtype)
    rows = x_flat.repeat_interleave(k, dim=0) * w_flat[:, None]
    return buf.index_put_((e_flat, p_flat), rows, accumulate=True)


def expert_ffn(xs, w_gate, w_up, w_down) -> torch.Tensor:
    """Batched SwiGLU experts: xs (E, C, d), weights (E, d, f) / (E, f, d)
    -> (E, C, d) in xs's dtype."""
    h = matmul_f32(xs, w_gate)
    u = matmul_f32(xs, w_up)
    h = (F.silu(h) * u).to(xs.dtype)
    return torch.bmm(h, w_down)


def gather_combine(buf, top_i, top_p, pos, keep) -> torch.Tensor:
    """buf (E, C, d) expert outputs -> (N, d): each token's k outputs
    weighted by ``top_p · keep`` (rounded to buf's dtype), summed in
    float32 and returned in buf's dtype."""
    n, k = top_i.shape
    e_flat = torch.where(keep, top_i, 0).reshape(-1).long()
    p_flat = torch.where(keep, pos, 0).reshape(-1).long()
    out = buf[e_flat, p_flat].reshape(n, k, -1)                 # (N, k, d)
    w = (top_p * keep).to(buf.dtype)                            # dropped -> 0
    comb = torch.bmm(w.to(torch.float32)[:, None, :],
                     out.to(torch.float32))[:, 0]
    return comb.to(buf.dtype)


def moe_local(x_flat, p: MoE, cfg: ModelConfig, capacity: int):
    """Router, dispatch, experts and combine on one device: x_flat (N, d)
    -> (out (N, d), aux)."""
    top_p, top_i, aux = router_topk(x_flat, p.router, cfg.top_k)
    pos, keep = dispatch_indices(top_i, cfg.n_experts, capacity)
    buf = scatter_dispatch(x_flat, top_i, pos, keep, cfg.n_experts,
                           capacity)
    buf = expert_ffn(buf, p.w_gate, p.w_up, p.w_down)
    return gather_combine(buf, top_i, top_p, pos, keep), aux


def shared_expert(x_flat, p: MLP,
                  ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The shared experts' SwiGLU: gate and up in float32, silu·up cast to
    x's dtype, the down product rounded once; with the width sharded over
    ``model``, this rank's columns and the partial sums all-reduced."""
    sharded = p.w_gate.shape[1] != p.d_ff
    if sharded:
        x_flat = copy_to(x_flat, ctx.mesh, ctx.model_axis)
    h = matmul_f32(x_flat, p.w_gate)
    u = matmul_f32(x_flat, p.w_up)
    h = (F.silu(h) * u).to(x_flat.dtype)
    out = h @ p.w_down
    return reduce_from(out, ctx.mesh, ctx.model_axis) if sharded else out


class _ScaleGrad(torch.autograd.Function):
    """x; its gradient times ``k``."""

    @staticmethod
    def forward(c, x, k):
        c.k = k
        return x.view_as(x)

    @staticmethod
    def backward(c, g):
        return g * c.k, None


# a list to record each expert-parallel call's (path, kept, dropped)
# assignment counts in (device tensors); None records nothing
RECORD: Optional[list] = None


def _record(path: str, kept: torch.Tensor, dropped: torch.Tensor) -> None:
    if RECORD is not None:
        RECORD.append((path, kept.sum(), dropped.sum()))


def _moe_all_to_all(x_flat, p: MoE, cfg: ModelConfig, ctx: ShardCtx,
                    split_axes):
    """The all-to-all path on this rank's block of ``x_flat`` (its block
    over ``split_axes``); returns (the block's output, aux averaged over
    ``model``)."""
    mesh, axis, ep = ctx.mesh, ctx.model_axis, ctx.model_size
    xs = split_to(x_flat, mesh, split_axes, 0)
    nb, d = xs.shape
    e = cfg.n_experts
    el = e // ep
    cap = capacity(nb, cfg.top_k, e, cfg.capacity_factor)
    top_p, top_i, aux = router_topk(xs, copy_to(p.router, mesh, axis),
                                    cfg.top_k)
    pos, keep = dispatch_indices(top_i, e, cap)
    _record("all_to_all", keep, ~keep)
    buf = scatter_dispatch(xs, top_i, pos, keep, e, cap)
    # (E, C, d) = (ep, E_local, C, d): block j goes to rank j, block i of
    # the result came from rank i
    buf = exchange(buf, mesh, axis)
    xe = buf.reshape(ep, el, cap, d).transpose(0, 1).reshape(el, ep * cap, d)
    ye = expert_ffn(xe, p.w_gate, p.w_up, p.w_down)
    ye = ye.reshape(el, ep, cap, d).transpose(0, 1).reshape(e, cap, d)
    ye = exchange(ye, mesh, axis)
    out = gather_combine(ye, top_i, top_p, pos, keep)
    aux = reduce_from(aux, mesh, axis) / ep
    return gather_from(out, mesh, split_axes, 0), aux


def _moe_replicated(x_flat, p: MoE, cfg: ModelConfig, ctx: ShardCtx,
                    data_axes):
    """The decode path: the tokens (this rank's block over ``data_axes``,
    or all) routed on every model rank, each rank's own experts' share
    computed and the shares summed over ``model``.  The aux loss is each
    rank's (the same on all); its gradient is scaled by 1/ep, since the
    ranks' gradients are summed."""
    mesh, axis, ep = ctx.mesh, ctx.model_axis, ctx.model_size
    xs = split_to(x_flat, mesh, data_axes, 0) if data_axes else x_flat
    xs = copy_to(xs, mesh, axis)
    n = xs.shape[0]
    e = cfg.n_experts
    el = e // ep
    cap = capacity(n, cfg.top_k, e, cfg.capacity_factor)
    top_p, top_i, aux = router_topk(xs, copy_to(p.router, mesh, axis),
                                    cfg.top_k)
    pos, keep = dispatch_indices(top_i, e, cap)
    lo = ctx.model_rank * el
    mine = (top_i >= lo) & (top_i < lo + el)
    keep_l = keep & mine
    _record("replicated", keep_l, mine & ~keep)
    top_l = torch.where(mine, top_i - lo, 0)
    buf = scatter_dispatch(xs, top_l, pos, keep_l, el, cap)
    buf = expert_ffn(buf, p.w_gate, p.w_up, p.w_down)
    out = reduce_from(gather_combine(buf, top_l, top_p, pos, keep_l), mesh,
                      axis)
    if data_axes:
        out = gather_from(out, mesh, data_axes, 0)
    return out, _ScaleGrad.apply(aux, 1.0 / ep)


def moe_forward(x: torch.Tensor, p: MoE, cfg: ModelConfig,
                ctx: Optional[ShardCtx] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss, a float32
    scalar).  The capacity counts the B·S tokens of this call: a decode
    step's B tokens get ``ceil(B·k·cf / E)`` slots an expert.

    On a mesh x holds this rank's block of the global batch over the data
    axes when ``ctx.rows_sharded``, else the whole batch; the path and the
    capacities follow from the global token count, as in the reference
    (:data:`RECORD` records each expert-parallel call's counts)."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    if ctx is None or ctx.mesh is None:
        cap = capacity(b * s, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        out, aux = moe_local(x_flat, p, cfg, cap)
    else:
        out, aux = _moe_mesh(x_flat, p, cfg, ctx)
    if p.shared is not None:
        out = out + shared_expert(x_flat, p.shared, ctx)
    return out.reshape(b, s, d), aux


def _moe_mesh(x_flat, p: MoE, cfg: ModelConfig, ctx: ShardCtx):
    """The reference's choice of path (``moe.py:206-245``) on the global
    token count; returns (this rank's rows' output, aux)."""
    mesh, batch = ctx.mesh, tuple(ctx.batch_axes)
    ep, dd = ctx.model_size, ctx.data_size
    rows = ctx.rows_sharded and dd > 1
    n_tok = x_flat.shape[0] * (dd if rows else 1)
    if ep == 1 or cfg.n_experts % ep:
        # one dispatch over every token of the global batch
        xg = gather_from(x_flat, mesh, batch, 0) if rows else x_flat
        cap = capacity(n_tok, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        out, aux = moe_local(xg, p, cfg, cap)
        return (split_to(out, mesh, batch, 0) if rows else out), aux
    shards = dd * ep
    if n_tok % shards == 0 and n_tok // shards >= ep:
        split = (ctx.model_axis,) if rows else (*batch, ctx.model_axis)
        return _moe_all_to_all(x_flat, p, cfg, ctx, split)
    data_axes = batch if (n_tok % dd == 0 and dd > 1 and not rows) else ()
    return _moe_replicated(x_flat, p, cfg, ctx, data_axes)
