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

The expert-parallel paths of the reference (``shard_map`` with
``all_to_all`` and ``psum``) wait for the port's DTensor mesh (``ROADMAP.md``
Queue 1 item 4.5).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import MLP, matmul_f32, trunc_normal_


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
        d, f = self.w_gate.shape[1], self.w_gate.shape[2]
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
    onehot = F.one_hot(flat, n_experts).to(torch.int32)        # (N·k, E)
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


def shared_expert(x_flat, p: MLP) -> torch.Tensor:
    """The shared experts' SwiGLU: gate and up in float32, silu·up cast to
    x's dtype, the down product rounded once."""
    h = matmul_f32(x_flat, p.w_gate)
    u = matmul_f32(x_flat, p.w_up)
    h = (F.silu(h) * u).to(x_flat.dtype)
    return h @ p.w_down


def moe_forward(x: torch.Tensor, p: MoE,
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss, a float32
    scalar).  The capacity counts the B·S tokens of this call: a decode
    step's B tokens get ``ceil(B·k·cf / E)`` slots an expert."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    cap = capacity(b * s, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    out, aux = moe_local(x_flat, p, cfg, cap)
    if p.shared is not None:
        out = out + shared_expert(x_flat, p.shared)
    return out.reshape(b, s, d), aux
