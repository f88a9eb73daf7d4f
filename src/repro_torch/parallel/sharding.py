"""Parameter, cache and batch sharding specs (counterpart of
``repro/parallel/sharding.py``), as pure functions of shapes.

A spec is a tuple with one entry a dim: ``None`` (replicated), an axis
name, or a tuple of axis names (the dim cut over their product, the first
major).  Rules are keyed by the leaf's name; each gives the spec of the
*base* (per-layer) rank.  The reference stacks layers and pads its leading
stack dims with ``None``; the port's leaves are per layer, so a rule
applies to the leaf as it is.  Any dim whose size does not divide the
product of its axes is demoted to replicated (Qwen2-VL's 12 heads or a
batch of 1 on an 8-way axis).  With FSDP the first free dim that the data
axis divides is sharded over ``data``.  :func:`to_placements` turns a spec
into DTensor placements (the reference's ``to_shardings``);
:func:`shard_slices` gives the slice of the whole leaf a rank holds.

The serving engine's lanes: the slot axis is sharded over ``data``
(``slot_specs``), so lane i's rows live on the host that owns lane i
(:func:`lane_owners`, :func:`host_block`); the port's pod hosts are
processes, each holding its block of lanes in its own slot array.
``gathered_sharding`` has no counterpart.  The reference replicates its
(k, slots) done stack across the pod, the one collective of its serving
loop, because its hosts learn from the device which lanes finished.  The
port's host plans every lane's done tick from the positions it tracks
before the window runs, so every host already holds the whole stack and a
window needs no collective.  What the gathered stack enforced, that every
host retires the same lanes at the same boundary, the engine checks once at
the end of a serve instead, by all-gathering each host's schedule digest.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.models.layers import ShardCtx

M = "model"
B = "batch"

Spec = Tuple

# leaf name -> (base_rank, base_spec); specs use logical tags resolved by ctx
_PARAM_RULES = {
    # embeddings
    "embedding": (2, (M, None)),
    "lm_head": (2, (None, M)),
    # attention (GQA)
    "wq": (3, (None, M, None)),
    "wk": (3, (None, M, None)),
    "wv": (3, (None, M, None)),
    "wo": (3, (M, None, None)),
    # MLA
    "w_dkv": (2, (None, None)),
    "w_krope": (2, (None, None)),
    "w_uk": (3, (None, M, None)),
    "w_uv": (3, (None, M, None)),
    "w_dq": (2, (None, None)),
    "w_uq": (3, (None, M, None)),
    # dense mlp / moe shared expert
    "w_gate": (2, (None, M)),
    "w_up": (2, (None, M)),
    "w_down": (2, (M, None)),
    # moe (expert-stacked weights carry their own leading E dim)
    "router": (2, (None, None)),
    "moe:w_gate": (3, (M, None, None)),
    "moe:w_up": (3, (M, None, None)),
    "moe:w_down": (3, (M, None, None)),
    # mamba2
    "w_z": (2, (None, M)),
    "w_x": (2, (None, M)),
    "w_B": (2, (None, None)),
    "w_C": (2, (None, None)),
    "w_dt": (2, (None, M)),
    "dt_bias": (1, (M,)),
    "conv_w": (2, (None, M)),
    "conv_b": (1, (M,)),
    "A_log": (1, (M,)),
    "D": (1, (M,)),
    "norm_scale": (1, (M,)),
    "w_out": (2, (M, None)),
    # xlstm (small model: replicated)
    "w_q": (2, (None, None)),
    "w_k": (2, (None, None)),
    "w_v": (2, (None, None)),
    "w_i": (2, (None, None)),
    "w_f": (2, (None, None)),
    "f_bias": (1, (None,)),
    "w_gate_up": (2, (None, M)),
    "b": (2, (None, None)),
    "r_i": (2, (None, None)),
    "r_f": (2, (None, None)),
    "r_z": (2, (None, None)),
    "r_o": (2, (None, None)),
    "w_z_xl": (2, (None, None)),
    "w_o": (2, (None, None)),
    # norms
    "scale": (1, (None,)),
    # U-Net convs: the output-channel dim of rank-4 HWIO kernels
    "w": (4, (None, None, None, M)),
}

_CACHE_RULES = {
    "k": (4, (B, None, M, None)),
    "v": (4, (B, None, M, None)),
    "c_kv": (3, (B, None, None)),
    "k_rope": (3, (B, None, None)),
    "state": (4, (B, M, None, None)),     # ssm / mlstm state (B,nh,·,·)
    "conv": (3, (B, None, M)),
    "norm": (3, (B, M, None)),            # mlstm normalizer
    "c": (2, (B, None)),
    "n": (2, (B, None)),
    "h": (2, (B, None)),
    "m": (2, (B, None)),
}

# flash-decoding layout (ctx.cache_seq_shard): the KV cache sharded over its
# sequence dim on the model axis
_CACHE_RULES_SEQSHARD = {
    "k": (4, (B, M, None, None)),
    "v": (4, (B, M, None, None)),
    "c_kv": (3, (B, M, None)),
    "k_rope": (3, (B, M, None)),
}


def _axis_size(ctx: ShardCtx, tag) -> int:
    axes = ctx.resolve(tag)
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= ctx.mesh.shape[a]
    return n


def _fit_spec(shape, base_rank: int, base_spec, ctx: ShardCtx,
              fsdp: bool = False, fsdp_axis: str = "data") -> Spec:
    """The spec of a leaf of ``shape`` under a rule: lead dims (the shape's
    rank above the rule's) replicated, non-divisible dims demoted, and with
    ``fsdp`` the first free dim after the lead dims that the data axis
    divides sharded over it.  A leaf of lower rank than its rule is
    replicated."""
    lead = len(shape) - base_rank
    if lead < 0:
        return (None,) * len(shape)
    spec = [None] * lead + list(base_spec)
    for i, tag in enumerate(spec):
        if tag is not None and shape[i] % _axis_size(ctx, tag) != 0:
            spec[i] = None
    if fsdp:
        fs = ctx.mesh.shape.get(fsdp_axis, 1) if ctx.mesh else 1
        for i in range(lead, len(spec)):
            if spec[i] is None and shape[i] % fs == 0 and shape[i] >= fs:
                spec[i] = fsdp_axis
                break
    return tuple(ctx.resolve(t) if t not in (None, fsdp_axis) else t
                 for t in spec)


def _leaf_rule(name: str) -> Optional[tuple]:
    """The rule of a dotted leaf name (``layers.3.moe.w_gate``): the
    expert-stacked rules inside an MoE (its shared expert takes the dense
    ones), else by the last key."""
    keys = name.split(".")
    last = keys[-1]
    if "moe" in keys and last in ("w_gate", "w_up", "w_down") and \
            "shared" not in keys:
        return _PARAM_RULES[f"moe:{last}"]
    return _PARAM_RULES.get(last)


def param_specs(shapes: Mapping[str, Sequence[int]], ctx: ShardCtx,
                fsdp: bool = False) -> Dict[str, Spec]:
    """``{name: spec}`` for ``{name: shape}`` (``named_parameters`` of a
    model, meta tensors from ``launch/specs.py``'s ``params_abstract``)."""
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        r = _leaf_rule(name)
        out[name] = (None,) * len(shape) if r is None else \
            _fit_spec(shape, r[0], r[1], ctx, fsdp=fsdp)
    return out


def _map_tree(tree, fn, path=()):
    """``fn(path, leaf)`` over a nested dict/list tree (None kept)."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn, path + (i,)) for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(path, tree)


def cache_specs(cache, ctx: ShardCtx):
    """The cache tree (:func:`~repro_torch.models.transformer.init_cache`'s
    nested dicts and lists) with each leaf's spec in its place: by the
    leaf's key, the flash-decoding rules first with ``cache_seq_shard``."""
    def rule(path, leaf):
        name = str(path[-1]) if path else ""
        r = None
        if ctx.cache_seq_shard:
            r = _CACHE_RULES_SEQSHARD.get(name)
        if r is None:
            r = _CACHE_RULES.get(name)
        if r is None:
            return (None,) * len(leaf.shape)
        return _fit_spec(tuple(leaf.shape), r[0], r[1], ctx)
    return _map_tree(cache, rule)


def batch_specs(batch, ctx: ShardCtx):
    """Input batches: the leading dim is the global batch, over the batch
    axes where they divide it."""
    def rule(_path, leaf):
        n = len(leaf.shape)
        return _fit_spec(tuple(leaf.shape), n, [B] + [None] * (n - 1), ctx)
    return _map_tree(batch, rule)


def pooled_server_batch_specs(batch, ctx: ShardCtx):
    """The pooled server upload {x_t, t, eps}: its flattened [n_clients·b]
    sample axis over the data axes, demoted when it does not divide: the
    input-batch rule."""
    return batch_specs(batch, ctx)


def client_stack_specs(stack, ctx: ShardCtx):
    """Leading-axis client stacks (params, opt, batches [n_clients, ...]):
    the client axis over the data axes, so each data group owns a subset of
    clients and no client model all-reduces."""
    def rule(_path, leaf):
        n = len(leaf.shape)
        if n == 0:
            return ()
        return _fit_spec(tuple(leaf.shape), n, [B] + [None] * (n - 1), ctx)
    return _map_tree(stack, rule)


def slot_specs(state, ctx: ShardCtx):
    """Serving-engine slot state ([slots, ...] leaves): the slot axis over
    the data axes, the client-stack rule."""
    return client_stack_specs(state, ctx)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh axis:
    ``Shard(dim)`` on each axis a dim is cut over, ``Replicate()`` on the
    rest."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.axis_names]
    names = list(mesh.axis_names)
    for dim, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[names.index(a)] = Shard(dim)
    return out


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's slice of a leaf of ``shape``."""
    return tuple(n // mesh.size(_entry_axes(e)) if e else n
                 for n, e in zip(shape, spec))


def shard_slices(shape, spec: Spec, mesh) -> Tuple[slice, ...]:
    """The slice of a whole leaf of ``shape`` this rank of ``mesh`` holds
    under ``spec``: along each cut dim the block of its index over the
    dim's axes (the first major)."""
    out = []
    for n, e in zip(shape, spec):
        axes = _entry_axes(e)
        if not axes:
            out.append(slice(None))
            continue
        w = n // mesh.size(axes)
        i = mesh.index(axes)
        out.append(slice(i * w, (i + 1) * w))
    return tuple(out)


def lane_owners(slots: int, hosts: int) -> np.ndarray:
    """Owner host of every serving-engine lane: contiguous blocks of
    ``slots // hosts`` lanes in host order (``sharding.py:233``)."""
    assert hosts >= 1 and slots % hosts == 0, (slots, hosts)
    return np.repeat(np.arange(hosts), slots // hosts)


def host_block(slots: int, hosts: int, host_id: int) -> slice:
    """The lanes host ``host_id`` owns, as a slice of the slot axis: the
    block the reference's ``slot_specs`` lays on that host's ``data``
    shard."""
    assert 0 <= host_id < hosts, (host_id, hosts)
    width = int((lane_owners(slots, hosts) == host_id).sum())
    return slice(host_id * width, (host_id + 1) * width)
