"""The port's sharding specs against the reference's, for every arch at full
width with no memory: the port's parameter shapes from its meta-device
``params_abstract``, the reference's from ``jax.eval_shape``, on the meshes
2x4, 1x8, 4x2, 16x16 and 2x16x16 (with ``pod``).  The reference's
``ShardCtx`` takes a stand-in mesh with a ``.shape`` dict, which is all
its spec functions read.  The port's leaves are per layer where the
reference stacks layers, so the reference's leading stack dims are
dropped before the comparison.  Also: the cache specs with
``cache_seq_shard`` off and on, the batch specs of every input shape, the
client-stack, pooled and slot specs, ``to_placements`` and the slices a
rank holds."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import ShardCtx as JCtx  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import (batch_axes_of, make_demo_mesh,  # noqa: E402
                                     make_mesh, make_production_mesh,
                                     mesh_context)
from repro_torch.launch.steps import make_ctx  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.parallel import sharding as tshd  # noqa: E402

MESHES = {"2x4": (2, 4), "1x8": (1, 8), "4x2": (4, 2), "16x16": (16, 16),
          "2x16x16": (2, 16, 16)}


@dataclasses.dataclass(frozen=True)
class StandIn:
    """What the reference's spec functions read of a mesh."""
    shape: dict


def _ctxs(name, **levers):
    dims = MESHES[name]
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    mesh = make_mesh(dims, axes)
    tctx = make_ctx(mesh, **levers)
    jctx = JCtx(mesh=StandIn(dict(zip(axes, dims))),
                batch_axes=batch_axes_of(mesh), **levers)
    return jctx, tctx


def _entry(e):
    return tuple(e) if isinstance(e, (list, tuple)) else e


def _norm(spec, ndim, lead=0):
    """A reference PartitionSpec padded to ``ndim`` entries, its ``lead``
    stack dims dropped."""
    full = [_entry(e) for e in spec] + [None] * (ndim - len(spec))
    assert all(e is None for e in full[:lead]), spec
    return tuple(full[lead:])


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    """(reference abstract params, reference leaf of each port name, port
    {name: shape})."""
    jcfg = jget_config(arch)
    jparams = jax.eval_shape(lambda k: jtf.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    # a tree of leaf ids the port's params_from_jax can split: the ids of a
    # stacked leaf repeated over its stack dims
    flat, treedef = jax.tree_util.tree_flatten_with_path(jparams)
    stacked = ("layers", "groups", "rem", "norms")
    ids = []
    for i, (path, leaf) in enumerate(flat):
        top = path[0].key
        shape = leaf.shape[:2] if top in stacked else ()
        ids.append(np.full(shape, i, np.float32))
    by_name = ttf.params_from_jax(jax.tree_util.tree_unflatten(treedef, ids))
    leaf_of = {n: int(t.reshape(-1)[0]) for n, t in by_name.items()}
    shapes = {n: tuple(p.shape) for n, p in
              tspecs.params_abstract(get_config(arch)).items()}
    assert set(shapes) == set(leaf_of)
    return jparams, leaf_of, shapes


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference_at_full_width(arch, mesh):
    jparams, leaf_of, shapes = _abstract(arch)
    jctx, tctx = _ctxs(mesh)
    flat_shapes = [leaf.shape for _, leaf in
                   jax.tree_util.tree_flatten_with_path(jparams)[0]]
    for fsdp in (False, True):
        want = jax.tree_util.tree_leaves(
            jshd.param_specs(jparams, jctx, fsdp=fsdp),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got = tshd.param_specs(shapes, tctx, fsdp=fsdp)
        for name, spec in got.items():
            i = leaf_of[name]
            ndim = len(shapes[name])
            lead = len(flat_shapes[i]) - ndim
            assert flat_shapes[i][lead:] == shapes[name], name
            assert spec == _norm(want[i], len(flat_shapes[i]), lead), \
                (name, fsdp, spec, want[i])


def test_param_specs_demote_what_does_not_divide():
    """Qwen2-VL's 12 heads (KV 2) on 8 model ranks: wq, wk, wv and wo
    replicated; the MLP's 8960 columns shard; MiniCPM's vocabulary of
    122,753 leaves the tied embedding whole; FSDP takes the first free dim
    the data axis divides."""
    _, tctx = _ctxs("1x8")
    shapes = {n: tuple(p.shape) for n, p in
              tspecs.params_abstract(get_config("qwen2-vl-2b")).items()}
    specs = tshd.param_specs(shapes, tctx)
    assert specs["layers.0.attn.wq"] == (None, None, None)
    assert specs["layers.0.attn.wo"] == (None, None, None)
    assert specs["layers.0.mlp.w_gate"] == (None, "model")
    mini = {n: tuple(p.shape) for n, p in
            tspecs.params_abstract(get_config("minicpm-2b")).items()}
    assert tshd.param_specs(mini, tctx)["embed.embedding"] == (None, None)
    _, ctx16 = _ctxs("16x16")
    fs = tshd.param_specs(mini, ctx16, fsdp=True)
    assert fs["embed.embedding"] == (None, "data")
    assert fs["layers.0.attn.wq"] == ("data", None, None)      # 36 heads


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("mesh", ["2x4", "1x8", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_reference(arch, mesh, seq_shard):
    """Every cache leaf's (name, per-layer shape, spec) against the
    reference's, at the decode_32k shape (and long_500k's window)."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jctx, tctx = _ctxs(mesh, cache_seq_shard=seq_shard)
    for shape_name in ("decode_32k", "long_500k"):
        jshape, tshape = JSHAPES[shape_name], INPUT_SHAPES[shape_name]
        window = jspecs.serve_window(jcfg, jshape)
        jcache = jspecs.cache_abstract(jcfg, jshape, window)
        tcache = tspecs.cache_abstract(tcfg, tshape, window)
        jspec = jshd.cache_specs(jcache, jctx)
        tspec = tshd.cache_specs(tcache, tctx)
        got = set()
        for (path, leaf), (_, spec) in zip(_leaves(tcache), _leaves(tspec)):
            got.add((path[-1], tuple(leaf.shape), spec))
        want = set()
        ranks = {name: len(shape) for name, shape, _ in got}
        jl = jax.tree_util.tree_flatten_with_path(jcache)[0]
        js = jax.tree_util.tree_leaves(
            jspec, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                PartitionSpec))
        for (path, leaf), spec in zip(jl, js):
            name = path[-1].key
            lead = leaf.ndim - ranks[name]
            want.add((name, tuple(leaf.shape[lead:]),
                      _norm(spec, leaf.ndim, lead)))
        assert got == want, (shape_name, got ^ want)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-vl-2b", "musicgen-large"])
def test_batch_specs_match_reference(arch, mesh):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jctx, tctx = _ctxs(mesh)
    for name in JSHAPES:
        jb = jspecs.batch_specs_abstract(jcfg, JSHAPES[name])
        tb = tspecs.batch_specs_abstract(tcfg, INPUT_SHAPES[name])
        assert set(jb) == set(tb)
        js = jshd.batch_specs(jb, jctx)
        ts = tshd.batch_specs(tb, tctx)
        for k in jb:
            assert tuple(tb[k].shape) == jb[k].shape
            assert ts[k] == _norm(js[k], jb[k].ndim), (name, k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_client_pooled_and_slot_specs_match_reference(mesh):
    jctx, tctx = _ctxs(mesh)
    stacks = {"w": (8, 3, 3, 4, 16), "b": (8, 16), "step": (8,),
              "odd": (3, 5), "scalar": ()}
    pooled = {"x_t": (64, 32, 32, 1), "t": (64,), "eps": (64, 32, 32, 1),
              "few": (6, 4)}
    slots = {"x": (32, 16, 16, 1), "t": (32,), "key": (32, 2),
             "active": (32,)}
    cases = [(jshd.client_stack_specs, tshd.client_stack_specs, stacks),
             (jshd.pooled_server_batch_specs, tshd.pooled_server_batch_specs,
              pooled),
             (jshd.slot_specs, tshd.slot_specs, slots)]
    for jfn, tfn, shapes in cases:
        jtree = {k: jax.ShapeDtypeStruct(v, np.float32)
                 for k, v in shapes.items()}
        ttree = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
        js, ts = jfn(jtree, jctx), tfn(ttree, tctx)
        for k, v in shapes.items():
            assert ts[k] == _norm(js[k], len(v)), (k, ts[k], js[k])


def test_placements_and_slices():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_mesh((2, 2, 4), ("pod", "data", "model"))
    assert tshd.to_placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert tshd.to_placements((None, None), mesh) == [Replicate()] * 3
    mesh.coords = {"pod": 1, "data": 0, "model": 3}
    spec = (("pod", "data"), None, "model")
    assert tshd.local_shape((8, 5, 16), spec, mesh) == (2, 5, 4)
    assert tshd.shard_slices((8, 5, 16), spec, mesh) == \
        (slice(4, 6), slice(None), slice(12, 16))


def test_collectives_refuse_a_dim_that_does_not_split():
    """reduce_scatter and all_to_all raise before any transport runs when
    the dim does not split over the ranks (the CUDA IPC exchange would
    drop or misplace its tail rows)."""
    from repro_torch.parallel import comm
    mesh = make_mesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        comm.reduce_scatter(torch.zeros(4, 3), mesh, "model", 1)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        comm.all_to_all(torch.zeros(5, 2), mesh, "model")


def test_meshes():
    prod = make_production_mesh()
    assert prod.shape == {"data": 2, "model": 8}
    assert make_production_mesh(multi_pod=True).axis_names == \
        ("pod", "data", "model")
    assert batch_axes_of(make_production_mesh(multi_pod=True)) == \
        ("pod", "data")
    assert make_demo_mesh().shape == {"data": 2, "model": 4}
    with mesh_context(prod) as m:
        assert m is prod


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_input_specs_are_meta_tensors_of_the_steps_inputs(shape):
    cfg = get_config("deepseek-v2-236b")
    ins = tspecs.input_specs(cfg, INPUT_SHAPES[shape])
    params = tspecs.params_abstract(cfg)
    assert {n: p.shape for n, p in ins["params"].items()} == \
        {n: p.shape for n, p in params.items()}
    leaves = [t for _, t in _leaves(ins)]
    assert leaves and all(t.is_meta for t in leaves)
    if shape == "train_4k":
        assert set(ins) == {"batch", "params", "opt_state"}
        assert all(ins["opt_state"][m][n].shape == params[n].shape and
                   ins["opt_state"][m][n].dtype == torch.float32
                   for m in ("mu", "nu") for n in params)
    else:
        assert set(ins) == {"batch", "params", "cache", "pos"}
        assert tuple(ins["batch"]["tokens"].shape) == (128, 1)

