"""AdamW with decoupled weight decay and global-norm clipping, written out
by hand (counterpart of ``repro/optim/adamw.py``).

``torch.optim.AdamW`` is not this optimizer: its default ``b2`` is 0.999
where the reference's is 0.95, it clips nothing, and it folds the decay
into the parameter before the step.  Here the reference's expression order
is kept: ``mu_hat / (sqrt(nu_hat) + eps)``, the decay added to that delta,
and the update taken on a float32 master copy.

A parameter set is a ``{name: tensor}`` dict (``named_parameters`` of a
module, the tree ``torch.func.functional_call`` takes); the optimizer state
is ``{"step": int32 tensor, "mu": {name: tensor}, "nu": {name: tensor}}``.
Every function but :func:`apply_updates_` is functional: it returns new
tensors and never writes to its inputs.  The stacked variants take a
leading member axis ([n, ...] leaves, an [n] step counter): each member
clips on its OWN global norm, as n separate calls would.

:func:`apply_updates_` is the in-place counterpart for a model too large
for whole-model temporaries (an LM on one card): it writes the parameters
and the state, one leaf at a time after the global norm over all leaves,
as the reference's jitted per-leaf ``upd`` with its state donated does.
Its temporaries are a few of the largest leaf's size, in float32, where
:func:`apply_updates` builds float32 lists of the whole model.  Its results
are bitwise :func:`apply_updates`' for float32 moments (the default
``mu_dtype``).

On a mesh each rank holds its shards of the parameters, gradients and
moments, and the update stays per shard.  Only the clipping norm needs
the mesh: :func:`global_norm` with a ``ctx`` and the leaves' specs sums the
squares of each leaf's local shard, all-reduces the sums over the axes the
leaves are sharded on, and counts a replicated leaf once, so the norm (and
the clipping) does not depend on the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.parallel import comm

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3                     # peak lr; scaled by schedule(step)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0               # 0 = off
    mu_dtype: str = "float32"


def _zeros(params: Params, cfg: AdamWConfig) -> Params:
    dt = getattr(torch, cfg.mu_dtype)
    return {k: torch.zeros(p.shape, dtype=dt, device=p.device)
            for k, p in params.items()}


def _step_counter(shape, params: Params) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros(shape, dtype=torch.int32, device=dev)


def init_state(params: Params, cfg: AdamWConfig):
    return {"step": _step_counter((), params), "mu": _zeros(params, cfg),
            "nu": _zeros(params, cfg)}


def init_stacked_state(stacked_params: Params, cfg: AdamWConfig):
    """State for a leading-axis stack of n parameter sets: a per-member
    step counter [n] and stacked mu/nu."""
    n = next(iter(stacked_params.values())).shape[0]
    return {"step": _step_counter((n,), stacked_params),
            "mu": _zeros(stacked_params, cfg),
            "nu": _zeros(stacked_params, cfg)}


def tree_stack(trees: List[dict]) -> dict:
    """Stack identically-keyed (nested) dicts of tensors along a new leading
    axis; the inverse of ``tree_unstack(.., k)``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def tree_unstack(tree: dict, k: int) -> dict:
    """Entry ``k`` of a leading-axis-stacked (nested) dict, as views."""
    if isinstance(tree, dict):
        return {name: tree_unstack(v, k) for name, v in tree.items()}
    return tree[k]


def _sq_norms(grads: Params, lead: int) -> torch.Tensor:
    """Sum of squares of every leaf, per member of the first ``lead``
    axes (0: one scalar; 1: one per member)."""
    total = None
    for g in grads.values():
        s = torch.sum(torch.square(g.to(torch.float32)),
                      dim=tuple(range(lead, g.ndim)))
        total = s if total is None else total + s
    return total


def _spec_axes(spec, mesh) -> tuple:
    """The mesh axes a spec shards over, in the mesh's order."""
    used = set()
    for entry in spec:
        if entry:
            used.update((entry,) if isinstance(entry, str) else entry)
    return tuple(a for a in mesh.axis_names if a in used)


def global_norm(grads: Params, ctx=None, specs=None) -> torch.Tensor:
    """The L2 norm of every gradient together.  On a mesh (``ctx``,
    ``specs`` the leaves' specs) the local shards' squares are summed
    leaf group by leaf group, each group all-reduced over the axes its
    leaves are sharded on, replicated leaves counted once."""
    if ctx is None or ctx.mesh is None or ctx.mesh.world == 1:
        return torch.sqrt(_sq_norms(grads, 0))
    mesh = ctx.mesh
    groups: Dict[tuple, torch.Tensor] = {}
    for k, g in grads.items():
        axes = _spec_axes(specs[k], mesh)
        sq = torch.sum(torch.square(g.to(torch.float32)))
        groups[axes] = sq if axes not in groups else groups[axes] + sq
    total = None
    for axes, sq in groups.items():
        sq = comm.all_reduce(sq, mesh, axes) if axes else sq
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply_updates(params: Params, grads: Params, state, cfg: AdamWConfig,
                  schedule: Optional[Callable] = None):
    """Returns (new_params, new_state, metrics)."""
    return _update(params, grads, state, cfg, schedule, lead=0)


def apply_updates_stacked(stacked_params: Params, stacked_grads: Params,
                          stacked_state, cfg: AdamWConfig,
                          schedule: Optional[Callable] = None):
    """:func:`apply_updates` for every member of the leading axis at once.
    Clipping and metrics are per member; the metrics are [n]-shaped."""
    return _update(stacked_params, stacked_grads, stacked_state, cfg,
                   schedule, lead=1)


def _update(params, grads, state, cfg: AdamWConfig, schedule, lead: int):
    names = list(params)
    p = [params[k] for k in names]
    mu_dt = state["mu"][names[0]].dtype
    g = [grads[k].to(mu_dt) for k in names]

    def per_leaf(v: torch.Tensor) -> List[torch.Tensor]:
        """A per-member scalar ([] or [n]) shaped to broadcast against each
        leaf."""
        return [v.reshape(v.shape + (1,) * (x.ndim - lead)) for x in p]

    step = state["step"] + 1
    gnorm = torch.sqrt(_sq_norms(grads, lead))
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        g = torch._foreach_mul(g, per_leaf(scale))
    stepf = step.to(torch.float32)
    lr = cfg.lr * (schedule(step) if schedule is not None
                   else torch.ones_like(stepf))
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    mu = torch._foreach_add(
        torch._foreach_mul([state["mu"][k] for k in names], cfg.b1),
        torch._foreach_mul(g, 1 - cfg.b1))
    nu = torch._foreach_add(
        torch._foreach_mul([state["nu"][k] for k in names], cfg.b2),
        torch._foreach_mul(torch._foreach_mul(g, g), 1 - cfg.b2))
    mu_hat = torch._foreach_div(mu, per_leaf(b1c))
    nu_hat = torch._foreach_div(nu, per_leaf(b2c))
    delta = torch._foreach_div(
        mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), cfg.eps))
    if cfg.weight_decay:
        delta = torch._foreach_add(
            delta, torch._foreach_mul([x.to(mu_dt) for x in p],
                                      cfg.weight_decay))
    master = torch._foreach_sub([x.to(torch.float32) for x in p],
                                torch._foreach_mul(delta, per_leaf(lr)))
    new_p = {k: m.to(x.dtype) for k, m, x in zip(names, master, p)}
    return new_p, {"step": step, "mu": dict(zip(names, mu)),
                   "nu": dict(zip(names, nu))}, {"grad_norm": gnorm,
                                                 "lr": lr}


@torch.no_grad()
def apply_updates_(params: Params, grads: Params, state, cfg: AdamWConfig,
                   schedule: Optional[Callable] = None, ctx=None,
                   specs=None):
    """:func:`apply_updates` in place: ``params`` (``{name: tensor}``, the
    tensors written with their new values), ``state["mu"]``, ``state["nu"]``
    and ``state["step"]`` are updated leaf by leaf, in the same operations
    and order as :func:`apply_updates`, so the results are its bits.
    Returns the metrics ``{"grad_norm", "lr"}``.  On a mesh (``ctx`` and
    the leaves' ``specs``) the clipping norm is :func:`global_norm`'s."""
    names = list(params)
    mu_dt = state["mu"][names[0]].dtype
    step = state["step"] + 1
    gnorm = global_norm(grads, ctx, specs)
    scale = None
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    stepf = step.to(torch.float32)
    lr = cfg.lr * (schedule(step) if schedule is not None
                   else torch.ones_like(stepf))
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    for k in names:
        p, mu, nu = params[k], state["mu"][k], state["nu"][k]

        def per_leaf(v):
            """A scalar shaped as :func:`_update` shapes it for this leaf
            (its dtype promotion is a dimensioned tensor's)."""
            return v.reshape((1,) * p.ndim)
        g = grads[k].to(mu_dt)
        if scale is not None:
            g = g * per_leaf(scale)
        mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        nu.mul_(cfg.b2).add_((g * g).mul_(1 - cfg.b2))
        del g
        delta = mu / per_leaf(b1c)
        denom = (nu / per_leaf(b2c)).sqrt_().add_(cfg.eps)
        delta.div_(denom)
        del denom
        if cfg.weight_decay:
            delta.add_(p.to(mu_dt) * cfg.weight_decay)
        delta.mul_(per_leaf(lr))
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.to(torch.float32).sub_(delta))
        del delta
    state["step"].copy_(step)
    return {"grad_norm": gnorm, "lr": lr}
