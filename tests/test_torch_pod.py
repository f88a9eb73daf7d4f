"""Pod mode in one process: lane ownership and the engine's host settings
against the reference, simulated hosts (``pod=None``) on the reference
test's workload (``tests/test_serve.py``'s two simulated hosts, ported to the
port's requests), the port's single host against the reference engine with
the reference's draws injected, pod hosts that hold only their block (a
loopback pod handle in this process) with guided pairs across the blocks,
and the schedule digest's check."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (TinyEps, reference_lane_noise,  # noqa: E402
                           set_torch_cpu, tiny_apply_jax, tiny_params)
from repro import serve as jserve  # noqa: E402
from repro.diffusion import sampler as jsm  # noqa: E402
from repro.diffusion import schedule as jsch  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import collafuse as tcf  # noqa: E402
from repro_torch.diffusion import sampler as tsm  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402
from repro_torch.launch import pod_smoke  # noqa: E402
from repro_torch.launch.mesh import Pod, host_mesh  # noqa: E402
from repro_torch.parallel import sharding as tshd  # noqa: E402
from repro_torch.serve.engine import schedule_digest  # noqa: E402

torch.set_float32_matmul_precision("highest")
set_torch_cpu()

REPO = Path(__file__).resolve().parents[1]
# the port's engine against the reference engine: test_torch_serve's bound
# (f32 on both sides, matmuls summed in another order, the first dense
# step divides by √(1−β_T))
TOL = dict(rtol=0, atol=1e-4)
T = 12
SHAPE = (6, 6, 1)
N_CLIENTS = 3


# ---------------------------------------------------------------------------
# lane ownership
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("slots,hosts", [(1, 1), (4, 1), (4, 2), (8, 2),
                                         (8, 4), (12, 3), (32, 8), (6, 6)])
def test_lane_owners_match_reference(slots, hosts):
    want = np.asarray(jshd.lane_owners(slots, hosts))
    got = tshd.lane_owners(slots, hosts)
    np.testing.assert_array_equal(got, want)
    for h in range(hosts):
        block = tshd.host_block(slots, hosts, h)
        np.testing.assert_array_equal(np.nonzero(want == h)[0],
                                      np.arange(block.start, block.stop))


@pytest.mark.parametrize("slots,hosts", [(6, 4), (3, 2), (4, 0)])
def test_lane_owners_reject_uneven_blocks_as_the_reference(slots, hosts):
    with pytest.raises(AssertionError):
        jshd.lane_owners(slots, hosts)
    with pytest.raises(AssertionError):
        tshd.lane_owners(slots, hosts)


def test_mesh_shape_parses_and_refuses_a_model_axis(tmp_path, capfd):
    """A model axis parses, and serve_diffusion no longer refuses one: a
    2x2 mesh serves two pod hosts of two model ranks each, each host's
    rows the same bits on its model ranks."""
    import json

    from repro_torch.launch import serve_diffusion
    assert host_mesh("2x1", 2) == (2, 1)
    assert host_mesh("", 3) == (3, 1)
    assert host_mesh("2x2", 4) == (2, 2)
    assert host_mesh("1x8") == (1, 8)
    out = tmp_path / "pod.json"
    serve_diffusion.main(["--device", "cpu", "--devices", "4",
                          "--mesh-shape", "2x2", "--config", "launcher",
                          "--T", "6", "--requests", "4", "--slots", "4",
                          "--clients", "2", "--json", str(out)])
    assert "serve_diffusion OK" in capfd.readouterr().out
    summary = json.loads(out.read_text())
    assert summary["mesh"] == "data:2xmodel:2"
    assert [h["host"] for h in summary["hosts"]] == [0, 1]
    assert all(h["model_bitwise"] for h in summary["hosts"])
    with pytest.raises(ValueError, match="does not cover"):
        host_mesh("2x1", 4)
    with pytest.raises(ValueError, match="is not DxM"):
        host_mesh("2x", 2)


# ---------------------------------------------------------------------------
# EngineConfig's pod settings, case for case with the reference
# ---------------------------------------------------------------------------
def _tiny_server():
    return TinyEps(tiny_params(SHAPE, 0)).eval()


@pytest.mark.parametrize("kw,ok", [
    (dict(hosts=2, host_id=1), True),
    (dict(hosts=2, host_id=0), True),
    (dict(hosts=2), True),
    (dict(hosts=1, host_id=0), True),
    (dict(hosts=4, host_id=3, slots=8), True),
    (dict(hosts=0), False),
    (dict(hosts=3), False),             # 4 slots do not split in 3 blocks
    (dict(hosts=2, host_id=2), False),
    (dict(hosts=2, host_id=-1), False),
    (dict(hosts=1, host_id=1), False)])
def test_engine_config_validation_as_the_reference(kw, ok):
    kw = dict(kw)
    slots = kw.pop("slots", 4)
    jsched, tsched = jsch.cosine_schedule(T), tsch.cosine_schedule(T)
    if ok:
        jserve.EngineConfig(sched=jsched, apply_fn=tiny_apply_jax,
                            image_shape=SHAPE, slots=slots, **kw)
        cfg = tserve.EngineConfig(sched=tsched, image_shape=SHAPE,
                                  slots=slots, device="cpu", **kw)
        eng = tserve.ServeEngine(cfg, _tiny_server())
        want = kw.get("host_id") or 0
        assert eng.host_id == want
        np.testing.assert_array_equal(
            eng._lane_owned,
            np.asarray(jshd.lane_owners(slots, kw["hosts"])) == want)
    else:
        with pytest.raises((AssertionError, ZeroDivisionError)):
            jserve.EngineConfig(sched=jsched, apply_fn=tiny_apply_jax,
                                image_shape=SHAPE, slots=slots, **kw)
        with pytest.raises(ValueError):
            tserve.EngineConfig(sched=tsched, image_shape=SHAPE, slots=slots,
                                device="cpu", **kw)


def test_explicit_host_id_zero_is_honoured_and_pod_must_match():
    tsched = tsch.cosine_schedule(T)
    base = dict(sched=tsched, image_shape=SHAPE, slots=4, device="cpu")
    cfg = tserve.EngineConfig(hosts=2, host_id=0, **base)
    eng = tserve.ServeEngine(cfg, _tiny_server())
    assert eng.host_id == 0 and eng._lane_owned.tolist() == [True, True,
                                                              False, False]
    pod = Pod(hosts=2, host_id=1)
    assert tserve.EngineConfig(hosts=2, pod=pod, **base).resolved_host_id() \
        == 1
    with pytest.raises(ValueError, match="pod of 2 hosts"):
        tserve.EngineConfig(hosts=4, pod=pod, **base)
    with pytest.raises(ValueError, match="pod's host 1"):
        tserve.EngineConfig(hosts=2, host_id=0, pod=pod, **base)


# ---------------------------------------------------------------------------
# simulated hosts on the reference test's workload
# ---------------------------------------------------------------------------
def _menus():
    args = {"ddpm": (T,), "ddim6": (T, "ddim", 6, 0.0)}
    return ({k: jsm.make_sampler(*a) for k, a in args.items()},
            {k: tsm.make_sampler(*a) for k, a in args.items()})


def _traffic():
    """test_serve.py's pod workload: 5 requests of 2 images, cuts 0.25 and
    0.5, clients i % 3, DDPM and DDIM K = 6; seeds 900 + i."""
    return [(900 + i, 2, (0.25, 0.5)[i % 2], i % 3, ("ddpm", "ddim6")[i % 2])
            for i in range(5)]


@pytest.fixture(scope="module")
def world():
    params = [tiny_params(SHAPE, s) for s in range(1 + N_CLIENTS)]
    modules = [TinyEps(p).eval() for p in params]
    _, tmenu = _menus()
    draws = {}
    for seed, b, c, _, smp in _traffic():
        s = tmenu[smp]
        reference_lane_noise(seed, b, SHAPE, tcf.CutPlan(T, c).cut_index(s),
                             s.K, draws)
    return params, modules, tcf.InjectedNoise(draws)


def _port_serve(world, **kw):
    _, (server, *clients), noise = world
    _, tmenu = _menus()
    reqs = [tserve.Request(req_id=i, seed=s, batch=b, cut_ratio=c,
                           client_idx=ci, sampler=smp)
            for i, (s, b, c, ci, smp) in enumerate(_traffic())]
    cfg = tserve.EngineConfig(sched=tsch.cosine_schedule(T),
                              image_shape=SHAPE, slots=4, samplers=tmenu,
                              device="cpu", **kw)
    return tserve.ServeEngine(cfg, server).serve(reqs, clients, noise=noise)


def _ref_serve(world, **kw):
    params, _, _ = world
    jmenu, _ = _menus()
    reqs = [jserve.Request(req_id=i, key=jax.random.PRNGKey(s), batch=b,
                           cut_ratio=c, client_idx=ci, sampler=smp)
            for i, (s, b, c, ci, smp) in enumerate(_traffic())]
    cfg = jserve.EngineConfig(sched=jsch.cosine_schedule(T),
                              apply_fn=tiny_apply_jax, image_shape=SHAPE,
                              slots=4, samplers=jmenu, step_backend="jnp",
                              **kw)
    return jserve.ServeEngine(cfg, params[0]).serve(
        reqs, adamw.tree_stack(params[1:]))


@pytest.fixture(scope="module")
def simulated(world):
    single = _port_serve(world)
    hosts = [_port_serve(world, hosts=2, host_id=h, ticks_per_dispatch=2,
                         async_depth=2) for h in (0, 1)]
    return single, hosts


def test_simulated_hosts_partition_and_reassemble_the_single_host(
        simulated):
    single, hosts = simulated
    assert all(set(h.completions) == set(single.completions) for h in hosts)
    for rid, comp in single.completions.items():
        c0, c1 = hosts[0].completions[rid], hosts[1].completions[rid]
        assert (c0.owned ^ c1.owned).all(), f"ownership of req {rid}"
        for attr in ("x_mid", "x0"):
            merged = np.where(c0.owned[:, None, None, None],
                              getattr(c0, attr), getattr(c1, attr))
            np.testing.assert_array_equal(merged, getattr(comp, attr),
                                          err_msg=f"{attr} req {rid}")
        for c in (c0, c1):
            assert not np.any(c.x_mid[~c.owned])
            assert not np.any(c.x0[~c.owned])
            assert c.client_finished
        assert c0.retire_tick == c1.retire_tick
    assert all(c.owned.all() for c in single.completions.values())
    assert schedule_digest(hosts[0]) == schedule_digest(hosts[1])


def test_simulated_host_matches_the_reference_host(world, simulated):
    """Simulated host 0 against the reference's host 0 on the same weights
    and draws: the same owned masks and ticks, the owned rows within TOL
    (host 1's masks are their complement, above, and the smoke's world
    checks a reference host 1 and single host too)."""
    _, hosts = simulated
    ref = _ref_serve(world, hosts=2, host_id=0, ticks_per_dispatch=2,
                     async_depth=2)
    assert set(hosts[0].completions) == set(ref.completions)
    for rid, rc in ref.completions.items():
        pc = hosts[0].completions[rid]
        np.testing.assert_array_equal(pc.owned, np.asarray(rc.owned),
                                      err_msg=f"req {rid}")
        assert (pc.admit_tick, pc.retire_tick) == (int(rc.admit_tick),
                                                   int(rc.retire_tick))
        np.testing.assert_allclose(pc.x_mid, rc.x_mid, **TOL)
        np.testing.assert_allclose(pc.x0[pc.owned], rc.x0[pc.owned], **TOL)


# ---------------------------------------------------------------------------
# pod hosts that hold their block only, through a loopback pod handle
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LoopbackPod(Pod):
    """A pod handle in one process: every host's object is this one's, or
    ``others`` in place of the other hosts'."""

    others: object = None

    def all_gather_object(self, obj):
        other = obj if self.others is None else self.others
        return [obj if h == self.host_id else other
                for h in range(self.hosts)]

    def barrier(self):
        pass


def straddling_pairs(res, block=4):
    """(req_id, primary lane, shadow lane) of every guided pair whose
    lanes lie in two blocks, from the admission timelines."""
    out = []
    for rid, events in sorted(res.timelines.items()):
        b = res.completions[rid].request.batch
        for e in events:
            if e["stage"] == "admitted" and len(e.get("lanes", ())) == 2 * b:
                ln = e["lanes"]
                out += [(rid, ln[i], ln[b + i]) for i in range(b)
                        if ln[i] // block != ln[b + i] // block]
    return out


def _pod_smoke(h=0, hosts=1, pod=None, n=7, **kw):
    return pod_smoke.serve_pod(hosts, h, 8, n, 4, 2, pod=pod, device="cpu",
                               **kw)


@pytest.mark.parametrize("mode,pack", [("stream", False), ("drain", True)])
def test_pod_hosts_hold_their_block_and_reassemble_the_single_host(
        mode, pack):
    kw = dict(clients=2, finish_mode=mode, pack=pack)
    single = _pod_smoke(**kw,
                        obs=tserve.ObsConfig(trace=False, timelines=True))
    assert straddling_pairs(single) == [(5, 2, 4), (5, 3, 5)]
    arts = [pod_smoke.artifact(_pod_smoke(
        h, 2, LoopbackPod(hosts=2, host_id=h), **kw), h) for h in (0, 1)]
    assert pod_smoke.union(arts) == pod_smoke.artifact(single, 0)


def test_pod_host_steps_halo_lanes_of_straddling_pairs_only():
    from repro_torch.serve import ServeEngine
    engines = []
    orig = ServeEngine.close
    try:
        ServeEngine.close = lambda self: engines.append(self) or orig(self)
        _pod_smoke(0, 2, LoopbackPod(hosts=2, host_id=0), n=7)
        _pod_smoke(0, 2, LoopbackPod(hosts=2, host_id=0), n=6)
    finally:
        ServeEngine.close = orig
    straddled, unstraddled = engines
    assert straddled._width == 8 and straddled._own_width == 4
    assert straddled.halo_lanes > 0 and unstraddled.halo_lanes == 0


def test_schedule_digest_mismatch_raises():
    other = schedule_digest(_pod_smoke(1, 2, LoopbackPod(hosts=2,
                                                         host_id=1), n=5))
    with pytest.raises(RuntimeError, match=r"pod hosts \[1\]"):
        _pod_smoke(0, 2, LoopbackPod(hosts=2, host_id=0, others=other), n=6)


def test_pod_modules_import_no_jax_and_no_reference():
    code = ("import sys; import repro_torch.parallel.sharding, "
            "repro_torch.launch.mesh, repro_torch.launch.pod_smoke; "
            "print(sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO / "src",
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# the pod smoke's world on the reference's weights and draws
# ---------------------------------------------------------------------------
def _smoke_draws(n):
    """The reference smoke's threefry draws (request i keyed by
    fold_in(PRNGKey(7), i)) keyed as the port's request seeds."""
    from repro.core import collafuse as jcf
    from repro.launch import pod_smoke as jsmoke
    tmenu = pod_smoke.build_world()[2]
    draws = {}
    for r in pod_smoke.build_requests(n):
        s = tmenu[r.sampler]
        cut = tcf.CutPlan(pod_smoke.T, r.cut_ratio).cut_index(s)
        key = jsmoke.build_requests(n)[r.req_id].key
        k_init, k_srv, k_cli = jcf.lane_keys(key, r.batch)
        for i in range(r.batch):
            draws[(r.seed, i, "init", 0)] = np.asarray(
                jax.random.normal(k_init[i], pod_smoke.SHAPE))
            for role, k, steps in (("server", k_srv[i], range(cut)),
                                   ("client", k_cli[i], range(cut, s.K))):
                for pos in steps:
                    k, k_n = jax.random.split(k)
                    draws[(r.seed, i, role, pos)] = np.asarray(
                        jax.random.normal(k_n, pod_smoke.SHAPE))
    return tcf.InjectedNoise(draws)


def test_pod_smoke_world_matches_the_reference_smoke():
    """The port's smoke on the reference's weights (``build_world`` and
    ``build_client_stack`` as arrays) and draws against the reference's
    in-process smoke: ticks equal, x_mid and x0 within TOL; a simulated host
    owns the reference host's rows."""
    from repro.launch import pod_smoke as jsmoke
    n, clients = 6, 2
    server = {k: np.asarray(v) for k, v in jsmoke.build_world()[2].items()}
    stack = {k: np.asarray(v)
             for k, v in jsmoke.build_client_stack(clients).items()}
    kw = dict(clients=clients, finish_mode="drain")
    noise = _smoke_draws(n)
    for hosts, h in ((1, 0), (2, 1)):
        ref = jsmoke.serve_pod(hosts, h, 8, n, 4, 2, **kw)
        port = pod_smoke.serve_pod(
            hosts, h, 8, n, 4, 2, device="cpu", server_params=server,
            client_models=pod_smoke.clients_from_arrays(stack), noise=noise,
            **kw)
        assert set(port.completions) == set(ref.completions)
        for rid, rc in ref.completions.items():
            pc = port.completions[rid]
            assert (pc.admit_tick, pc.retire_tick) == (int(rc.admit_tick),
                                                       int(rc.retire_tick))
            np.testing.assert_array_equal(pc.owned, np.asarray(rc.owned))
            own = pc.owned
            np.testing.assert_allclose(pc.x_mid[own], rc.x_mid[own], **TOL)
            np.testing.assert_allclose(pc.x0[own], rc.x0[own], **TOL)
        for key in ("served", "images", "ticks", "windows"):
            assert port.summary[key] == ref.summary[key], key
