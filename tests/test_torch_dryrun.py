"""The dry run (``repro_torch/launch/dryrun.py``): a step on the meta
device counts exactly what the same rank's real step counts.

At ``reduced()``, one arch a family (dense, hybrid, moe with MLA, vlm,
audio, ssm): the counted FLOPs, bytes and peak live bytes of a meta
prefill, decode and train step against the work counter over the real
CPU step; the probes, scaled to the depth, against the full-depth count;
a dry 1x2 prefill and a dry 2x1 FSDP train step against rank 0 of a real
two-rank gloo world (``tests/_torch_dryrun_worker.py``): the collectives'
calls and bytes, and the counter's.  At full width: a combination's
record has the reference's keys, the CLI writes it, a sweep survives a
failed combination, and no CUDA call is made."""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_dryrun_worker import ARCHS, BATCH, SEQ, real_batch  # noqa: E402
from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ops, units  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.launch.counter import WorkCounter  # noqa: E402
from repro_torch.launch.steps import (make_ctx, make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step)
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel.comm import Mesh  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KINDS = ("prefill", "decode", "train")
# the reference's record (repro/launch/dryrun.py:84-137)
RECORD_KEYS = {"arch", "shape", "mesh", "mesh_shape", "kind", "window",
               "params", "active_params", "fsdp", "remat", "seq_shard_attn",
               "cache_seq_shard", "capacity_factor", "full", "probes",
               "n_units", "scaled", "roofline"}
FULL_KEYS = {"lower_s", "compile_s", "flops", "bytes_accessed",
             "utilization_ops", "memory"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "code_bytes"}
ROOFLINE_KEYS = {"compute_s", "compute_hlo_s", "memory_s",
                 "memory_analytic_s", "collective_s", "analytic_flops",
                 "hlo_flops", "model_flops_6nd", "useful_ratio",
                 "hlo_bytes_per_chip", "link_bytes_per_chip", "dominant",
                 "bound_fraction"}


def _mesh_1x1():
    return Mesh(shape={"data": 1, "model": 1},
                coords={"data": 0, "model": 0}, device=torch.device("cpu"),
                transport="gloo")


def _real_count(cfg, shape, mesh):
    """The counter over the real CPU step (``mesh`` None: no mesh)."""
    window = sp.serve_window(cfg, shape)
    ctx = make_ctx(mesh) if mesh is not None else None
    model = tf.init_params(cfg, seed=0, device="cpu", ctx=ctx)
    batch = real_batch(cfg, shape)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, window=window, ctx=ctx)

        def run():
            step(model, batch)
    elif shape.kind == "decode":
        cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                              window=window, device="cpu", ctx=ctx)
        step = make_decode_step(cfg, window=window, ctx=ctx)

        def run():
            step(model, cache, batch, shape.seq_len - 1)
    else:
        opt = adamw.init_state(dict(model.named_parameters()),
                               adamw.AdamWConfig())
        step = make_train_step(cfg, window=window, ctx=ctx)

        def run():
            step(model, opt, batch)
    with WorkCounter() as counter:
        run()
    return counter


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_a_meta_step_counts_the_real_cpu_step(arch, kind):
    cfg = get_config(arch).reduced()
    shape = InputShape("t", SEQ, BATCH, kind)
    dry = dr.count_step(cfg, shape, dr.dry_mesh("1x1"))
    meshes = [_mesh_1x1()] + ([None] if kind != "train" else [])
    for mesh in meshes:
        real = _real_count(cfg, shape, mesh)
        assert dry["flops"] == real.flops > 0, mesh
        assert dry["bytes_accessed"] == real.bytes, mesh
        assert dry["ops"] == real.ops
        assert dry["utilization_ops"]["transcendentals"] == \
            real.transcendentals
        assert dry["kernels"] == real.units
        if real.units:
            # a kernel's plain version allocates temporaries on the CPU
            # that the kernel (and its meta branch) does not
            assert dry["memory"]["temp_bytes"] <= real.peak_bytes
        else:
            assert dry["memory"]["temp_bytes"] == real.peak_bytes
    if kind == "prefill" and cfg.family != "ssm" and cfg.attn_type == "gqa":
        assert dry["kernels"]["flash_attention"]["calls"] > 0
    if kind == "prefill" and arch == "zamba2-7b":
        assert dry["kernels"]["ssm_scan"]["calls"] == cfg.n_layers


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_scaled_probes_equal_the_full_depth(arch, kind):
    """Probes at 1 and 2 stack units scaled to 3 units: the
    full-depth FLOPs, bytes and link bytes (an eager count has no fusion
    noise)."""
    cfg = get_config(arch).reduced()
    (u1, u2), _ = rl.probe_units(cfg)
    # three stack units: the probes' one and two scaled to a third
    cfg = dataclasses.replace(cfg, n_layers=u1 + 2 * (u2 - u1))
    shape = InputShape("t", 8, 2, kind)
    rec = dr.run_combo(arch, shape, "1x2", cfg=cfg)
    full, scaled = rec["full"], rec["scaled"]
    coll = full["collectives"]
    assert scaled["flops"] == pytest.approx(full["flops"], rel=1e-9)
    assert scaled["bytes"] == pytest.approx(full["bytes_accessed"], rel=1e-9)
    assert scaled["link_bytes"] == pytest.approx(coll["total_link_bytes"],
                                                 rel=1e-9, abs=1e-6)
    for c, v in coll["link_bytes_by_class"].items():
        assert scaled[f"class:{c}"] == pytest.approx(v, rel=1e-9, abs=1e-6)
    assert coll["total_link_bytes"] > 0
    assert coll["link_bytes_by_class"]["net"] == 0
    assert rec["roofline"]["hlo_flops"] == pytest.approx(
        scaled["flops"] * 2, rel=1e-12)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_worlds(tmp_path_factory):
    """A 1x2 world of prefills and a 2x1 world of FSDP train steps, all
    four ranks at once; {dims: rank 0's results, or a failed rank's
    stderr}."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]), OMP_NUM_THREADS="1",
        MKL_NUM_THREADS="1")
    procs = {}
    for dims, kind in (("1x2", "prefill"), ("2x1", "train")):
        port = _free_port()
        procs[dims] = [subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_torch_dryrun_worker.py"),
             "--dims", dims, "--kind", kind, "--rank", str(r), "--port",
             str(port), "--out", str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
            for r in range(2)]
    deadline = time.monotonic() + 240
    res = {}
    for dims, ps in procs.items():
        err = None
        for p in ps:
            try:
                _, e = p.communicate(timeout=max(1.0, deadline -
                                                 time.monotonic()))
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, 9)
                _, e = p.communicate()
            if p.returncode:
                err = e[-3000:]
        res[dims] = err if err else json.loads(
            (out / f"{dims}.json").read_text())
    return res


@pytest.mark.parametrize("dims,kind", [("1x2", "prefill"), ("2x1", "train")])
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_collectives_equal_rank_0_of_a_gloo_world(gloo_worlds, arch,
                                                      dims, kind):
    real = gloo_worlds[dims]
    assert isinstance(real, dict), real
    real = real[arch]
    cfg = get_config(arch).reduced()
    shape = InputShape("t", SEQ, BATCH, kind)
    dry = dr.count_step(cfg, shape, dr.dry_mesh(dims), fsdp=kind == "train")
    assert dry["stats"] == {"calls": real["calls"], "bytes": real["bytes"]}
    assert dry["stats"]["calls"] > 0
    assert dry["collectives"]["counts"] and \
        sum(dry["collectives"]["counts"].values()) == real["calls"]
    assert dry["flops"] == real["flops"]
    if kind == "prefill":
        # (gloo's reduce-scatter copies its result through aten.copy_ on
        # the CPU: the transport's own work, which NCCL does in its kernel)
        assert dry["bytes_accessed"] == real["moved"]


def _no_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the dry run touched CUDA")
    for name in ("_lazy_init", "is_available", "device_count",
                 "current_device", "synchronize", "set_device",
                 "memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, refuse)


def test_a_full_width_record_has_the_reference_keys_and_no_cuda_call(
        monkeypatch, tmp_path):
    _no_cuda(monkeypatch)
    monkeypatch.setattr(dr, "RESULTS_DIR", str(tmp_path))
    dr.main(["--arch", "yi-6b", "--shape", "decode_32k", "--mesh", "single"])
    rec = json.loads((tmp_path / "yi-6b__decode_32k__single.json")
                     .read_text())
    assert RECORD_KEYS | {"wall_s"} <= set(rec)
    assert FULL_KEYS <= set(rec["full"])
    assert set(rec["full"]["memory"]) == MEMORY_KEYS
    assert ROOFLINE_KEYS <= set(rec["roofline"])
    assert set(rec["probes"]) == {"probe1", "probe2"}
    assert rec["mesh_shape"] == {"data": 32, "model": 8}
    assert rec["n_units"] == 32
    cfg = get_config("yi-6b")
    mem = rec["full"]["memory"]
    # the rank's params: its eighth of the weights (model axis), the
    # embedding and head sliced too; the cache its rows and KV heads
    assert mem["argument_bytes"] > cfg.param_count() * 2 / 8
    assert mem["alias_bytes"] > 0 and mem["code_bytes"] == 0
    assert rec["full"]["stats"]["calls"] > 0
    r = rec["roofline"]
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["link_bytes_by_class"]["net"] == 0      # no data collective


def test_a_multi_pod_train_record_crosses_the_network(monkeypatch):
    """FSDP over ``data`` on 2 pods of 2 nodes (Yi-6B at full width, 2
    layers): the gathers cross nodes, the model axis's all-reduces do
    not."""
    _no_cuda(monkeypatch)
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=2)
    rec = dr.run_combo("yi-6b", InputShape("t", 16, 4, "train"), "multi",
                       fsdp=True, nodes=2, probes=False, cfg=cfg)
    assert rec["mesh_shape"] == {"pod": 2, "data": 2, "model": 8}
    by = rec["full"]["collectives"]["link_bytes_by_class"]
    assert by["net"] > 0 and by["nvlink"] > 0


def test_a_sweep_survives_a_failed_combination(monkeypatch, tmp_path,
                                               capsys):
    monkeypatch.setattr(dr, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(dr, "list_archs", lambda: ["yi-6b", "glm4-9b"])

    def combo(arch, shape, mesh_name, **kw):
        if arch == "glm4-9b" and shape == "train_4k":
            raise RuntimeError("a failed combination")
        return {"arch": arch, "shape": shape}
    monkeypatch.setattr(dr, "run_combo", combo)
    with pytest.raises(SystemExit) as e:
        dr.main(["--sweep"])
    assert e.value.code == 1
    assert len(list(tmp_path.glob("*.json"))) == 7
    assert "1 FAILURES" in capsys.readouterr().out


def test_a_dry_mesh_takes_meta_tensors_and_only_it():
    dry = Mesh.dry({"data": 1, "model": 2})
    with pytest.raises(ValueError, match="dry mesh"):
        comm.all_reduce(torch.ones(4), dry, "model")
    real = Mesh(shape={"data": 1, "model": 2}, coords={"data": 0, "model": 0},
                device=torch.device("cpu"), transport="gloo")
    with pytest.raises(ValueError, match="dry mesh"):
        comm.all_gather(torch.empty(4, device="meta"), real, "model")
    comm.reset_stats()
    x = torch.empty(4, 6, dtype=torch.bfloat16, device="meta")
    assert comm.all_gather(x, dry, "model", 1).shape == (4, 12)
    assert comm.reduce_scatter(x, dry, "model", 0).shape == (2, 6)
    assert comm.all_reduce(x, dry, "model").shape == (4, 6)
    assert comm.all_to_all(x, dry, "model").shape == (4, 6)
    comm.barrier(dry)
    assert comm.STATS["calls"] == 4 and comm.STATS["bytes"] == 4 * 48
    assert [(op, n, b) for op, _, n, b in dry.records] == [
        ("all_gather", 2, 96), ("reduce_scatter", 2, 24),
        ("all_reduce", 2, 48), ("all_to_all", 2, 48)]


def test_the_wrappers_on_meta_are_one_unit_and_no_launch():
    q = torch.empty(2, 64, 8, 32, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 64, 2, 32, dtype=torch.bfloat16, device="meta")
    x = torch.empty(2, 64, 4, 16, device="meta")
    dt = torch.empty(2, 64, 4, device="meta")
    a = torch.empty(4, device="meta")
    bm = torch.empty(2, 64, 8, device="meta")
    ops.reset_launch_counts()
    with WorkCounter() as c:
        out = ops.flash_attention(q, k, k, window=16)
        y = ops.ssm_scan(x, dt, a, bm, bm)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert y.is_meta and y.shape == x.shape
    assert set(ops.launch_counts().values()) == {0}
    assert c.units["flash_attention"] == {
        "calls": 1, "flops": kfa.attention_flops(q, k, window=16),
        "bytes": kfa.attention_bytes(q, k, k)}
    assert c.units["ssm_scan"]["calls"] == 1 and c.ops == 0
    with pytest.raises(ValueError, match="meta and real"):
        ops.flash_attention(q, torch.empty(2, 64, 2, 32), k)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), k, k)


def test_the_unit_hook_finds_only_a_work_counter():
    """``kernels/units.active`` is None without a counter (a wrapper's call
    then builds no unit), the innermost counter inside one, and ignores
    another dispatch mode; a wrapper's unit goes to that counter alone."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Passthrough(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    q = torch.empty(1, 8, 2, 32, device="meta")
    assert units.active() is None
    with Passthrough():
        assert units.active() is None
    with WorkCounter() as outer:
        assert units.active() is outer
        with Passthrough(), WorkCounter() as inner:
            assert units.active() is inner
            ops.flash_attention(q, q, q)
        assert units.active() is outer
    assert units.active() is None
    assert inner.units["flash_attention"]["calls"] == 1
    assert "flash_attention" not in outer.units
