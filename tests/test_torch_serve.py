"""Port parity for the whole slice: ``ServeEngine.serve()`` against the
reference engine (plain backends, drain finisher, the reference's threefry
noise injected), window depth k=3 against k=1 inside the port, the host-side
scheduler and metrics, and the launcher."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (reference_lane_noise, set_torch_cpu,  # noqa: E402
                           unet_params)
from repro.configs.base import UNetConfig as JaxUNetConfig  # noqa: E402
from repro.core.collafuse import CutPlan as JaxCutPlan  # noqa: E402
from repro.diffusion import sampler as jsm  # noqa: E402
from repro.diffusion import schedule as jsch  # noqa: E402
from repro.models import unet as junet  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro_torch.core import collafuse as tcf  # noqa: E402
from repro_torch.diffusion import sampler as tsm  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402
from repro_torch.launch.serve_diffusion import launcher_config  # noqa: E402
from repro_torch.models.unet import UNet, params_from_jax  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402

set_torch_cpu()

REPO = Path(__file__).resolve().parents[1]
# f32 on both sides, but the convolutions sum in another order (another
# framework, or another batch size inside the port), and the first dense
# step at T=10 divides by √(1−β_T) ≈ 0.032 before the clip
TOL = dict(rtol=0, atol=1e-4)
# an engine lane (3 slots) against its batch-1 replay: the CPU picks other
# convolution kernels for another batch size, and two amplified first steps
# (the server's and, at c=1, the client's) separate them
LANE_TOL = dict(rtol=0, atol=3e-4)
T = 10
SHAPE = (8, 8, 1)
# (seed, batch, cut_ratio, client, arrival, sampler): mixed batch, cut
# (incl. the local-only c=1 and the all-server c=0), sampler and client
TRAFFIC = [(100, 1, 0.25, 0, 0, "ddpm"), (101, 2, 0.5, 1, 0, "ddim"),
           (102, 1, 0.75, 1, 1, "ddpm"), (103, 2, 1.0, 0, 2, "ddpm"),
           (104, 1, 0.0, 0, 2, "ddim"), (105, 2, 0.5, 0, 5, "ddpm"),
           (106, 1, 0.25, 1, 6, "ddim")]


def _menus():
    args = {"ddpm": (T,), "ddim": (T, "ddim", 4, 0.3)}
    return ({k: jsm.make_sampler(*a) for k, a in args.items()},
            {k: tsm.make_sampler(*a) for k, a in args.items()})


@pytest.fixture(scope="module")
def slice_models():
    """The tiny test U-Net (the reference launcher's model), one set of
    numpy weights for both frameworks: server + 2 clients, drawn like the
    reference's init (fan-in weights, zero biases, unit norms)."""
    port_cfg = launcher_config(SHAPE[0])
    ref_cfg = JaxUNetConfig(**{f.name: getattr(port_cfg, f.name)
                               for f in dataclasses.fields(JaxUNetConfig)})
    params = [unet_params(ref_cfg, s, perturb=False) for s in (0, 1, 2)]
    modules = []
    for p in params:
        m = UNet(port_cfg)
        m.load_state_dict(params_from_jax(p))
        modules.append(m.eval())
    return ref_cfg, params, modules


def _noise():
    _, tmenu = _menus()
    draws = {}
    for seed, b, c, _, _, smp in TRAFFIC:
        s = tmenu[smp]
        reference_lane_noise(seed, b, SHAPE, tcf.CutPlan(T, c).cut_index(s),
                             s.K, draws)
    return tcf.InjectedNoise(draws)


def _port_requests():
    return [tserve.Request(req_id=i, seed=s, batch=b, cut_ratio=c,
                           client_idx=ci, arrival_tick=a, sampler=smp)
            for i, (s, b, c, ci, a, smp) in enumerate(TRAFFIC)]


def _port_engine(server, k=1, slots=3, **kw):
    _, tmenu = _menus()
    cfg = tserve.EngineConfig(
        sched=tsch.cosine_schedule(T), image_shape=SHAPE, slots=slots,
        scheduler=tserve.make_scheduler("cut_ratio", T, samplers=tmenu),
        step_backend=kw.pop("step_backend", "torch"), samplers=tmenu,
        ticks_per_dispatch=k, device="cpu", **kw)
    return tserve.ServeEngine(cfg, server)


@pytest.fixture(scope="module")
def port_k1(slice_models):
    _, _, (server, *clients) = slice_models
    return _port_engine(server, finish_mode="drain").serve(
        _port_requests(), clients, noise=_noise())


def test_serve_matches_reference_engine(slice_models, port_k1):
    ref_cfg, params, _ = slice_models
    jmenu, _ = _menus()
    cfg = jserve.EngineConfig(
        sched=jsch.cosine_schedule(T),
        apply_fn=lambda p, x, t: junet.forward(p, x, t, ref_cfg),
        image_shape=SHAPE, slots=3,
        scheduler=jserve.make_scheduler("cut_ratio", T, samplers=jmenu),
        step_backend="jnp", samplers=jmenu, finish_mode="drain")
    reqs = [jserve.Request(req_id=i, key=jax.random.PRNGKey(s), batch=b,
                           cut_ratio=c, client_idx=ci, arrival_tick=a,
                           sampler=smp)
            for i, (s, b, c, ci, a, smp) in enumerate(TRAFFIC)]
    ref = jserve.ServeEngine(cfg, params[0]).serve(
        reqs, adamw.tree_stack(params[1:]))
    assert set(port_k1.completions) == set(ref.completions) == \
        set(range(len(TRAFFIC)))
    for rid, rc in ref.completions.items():
        pc = port_k1.completions[rid]
        assert (pc.admit_tick, pc.retire_tick) == \
            (int(rc.admit_tick), int(rc.retire_tick)), rid
        np.testing.assert_allclose(pc.x_mid, rc.x_mid, **TOL,
                                   err_msg=f"x_mid req {rid}")
        np.testing.assert_allclose(pc.x0, rc.x0, **TOL,
                                   err_msg=f"x0 req {rid}")
        assert pc.client_finished
    for key in ("requests", "images", "ticks", "latency_ticks_p50",
                "latency_ticks_p95", "utilization_mean", "finish_mode",
                "overlap_frac"):
        assert port_k1.summary[key] == pytest.approx(ref.summary[key]), key
    for key in ("server_flops", "client_flops", "client_fraction"):
        # both count 2 FLOP per parameter per model call
        assert port_k1.summary[key] == pytest.approx(ref.summary[key],
                                                     rel=1e-6), key


@pytest.mark.parametrize("k", [3])
def test_window_depth_is_bitwise_invisible(slice_models, port_k1, k):
    _, _, (server, *clients) = slice_models
    res = _port_engine(server, k=k).serve(_port_requests(), clients,
                                          noise=_noise())
    for rid, c1 in port_k1.completions.items():
        ck = res.completions[rid]
        np.testing.assert_array_equal(ck.x_mid, c1.x_mid)
        np.testing.assert_array_equal(ck.x0, c1.x0)
        assert ck.retire_tick % k == 0 or ck.retire_tick == ck.admit_tick
    # retirement waits for the window boundary: at most k-1 ticks late
    assert res.summary["boundary_lag_p100"] <= k - 1


@pytest.mark.parametrize("backend", ["triton", "cuda_masked"])
def test_kernel_backends_serve_like_the_plain_one(slice_models, port_k1,
                                                  backend):
    """On the CPU the kernel backends run their kernels' plain versions:
    the cuda_masked one is the plain expression bit for bit; the triton one
    multiplies by 1/√ar instead of dividing by √ar (rounding only)."""
    _, _, (server, *clients) = slice_models
    res = _port_engine(server, step_backend=backend).serve(
        _port_requests(), clients, noise=_noise())
    for rid, c1 in port_k1.completions.items():
        if backend == "cuda_masked":
            np.testing.assert_array_equal(res.completions[rid].x0, c1.x0)
        np.testing.assert_allclose(res.completions[rid].x0, c1.x0, **TOL)


def test_engine_lane_replays_split_sample_lane(slice_models, port_k1):
    _, _, (server, *clients) = slice_models
    _, tmenu = _menus()
    noise = _noise()
    for rid in (1, 3, 4):                       # ddim, local-only, all-server
        comp = port_k1.completions[rid]
        r = comp.request
        for i in range(r.batch):
            x0, mid = tcf.split_sample_lane(
                tsch.cosine_schedule(T), tcf.CutPlan(T, r.cut_ratio), server,
                clients[r.client_idx], r.seed, i, SHAPE,
                return_intermediate=True, sampler=tmenu[r.sampler],
                noise=noise, device="cpu")
            np.testing.assert_allclose(comp.x_mid[i], mid.numpy(),
                                       **LANE_TOL)
            np.testing.assert_allclose(comp.x0[i], x0.numpy(), **LANE_TOL)


def test_serve_sequential_matches_engine_lanes(slice_models, port_k1):
    _, _, (server, *clients) = slice_models
    _, tmenu = _menus()
    cfg = tserve.EngineConfig(sched=tsch.cosine_schedule(T),
                              image_shape=SHAPE, slots=3, samplers=tmenu,
                              device="cpu")
    outs = tserve.serve_sequential(cfg, _port_requests(), server, clients,
                                   noise=_noise())
    for rid, (x0, mid) in outs.items():
        np.testing.assert_allclose(mid, port_k1.completions[rid].x_mid,
                                   **LANE_TOL)
        np.testing.assert_allclose(x0, port_k1.completions[rid].x0,
                                   **LANE_TOL)


# ---------------------------------------------------------------------------
# engine and scheduler units
# ---------------------------------------------------------------------------
def test_engine_config_validation(slice_models):
    _, _, (server, *_) = slice_models
    sched = tsch.cosine_schedule(T)
    with pytest.raises(ValueError, match="finish_mode"):
        tserve.EngineConfig(sched=sched, image_shape=SHAPE,
                            finish_mode="eager", device="cpu")
    with pytest.raises(ValueError, match="ticks_per_dispatch"):
        tserve.EngineConfig(sched=sched, image_shape=SHAPE,
                            ticks_per_dispatch=0, device="cpu")
    with pytest.raises(ValueError, match="T=12"):
        tserve.EngineConfig(sched=sched, image_shape=SHAPE, device="cpu",
                            samplers={"ddpm": tsm.make_sampler(12)})
    eng = _port_engine(server, slots=2)
    with pytest.raises(ValueError, match="capacity"):
        eng.serve([tserve.Request(req_id=0, seed=0, batch=3)])
    with pytest.raises(ValueError, match="names sampler"):
        eng.serve([tserve.Request(req_id=0, seed=0, sampler="nope")])


def test_idle_gap_jumps_to_next_arrival(slice_models):
    _, _, (server, *_) = slice_models
    reqs = [tserve.Request(req_id=0, seed=1, cut_ratio=0.5),
            tserve.Request(req_id=1, seed=2, cut_ratio=0.5,
                           arrival_tick=40)]
    res = _port_engine(server).serve(reqs)
    assert res.completions[1].admit_tick == 40
    assert res.summary["idle_ticks"] > 0
    assert res.completions[0].x0 is None          # no client models given


def _sreq(i, c, arrival=0, batch=1):
    return tserve.Request(req_id=i, seed=i, batch=batch, cut_ratio=c,
                          arrival_tick=arrival)


def test_fifo_blocks_at_head_of_line():
    sch = tserve.FIFOScheduler()
    for r in (_sreq(0, 0.5, batch=3), _sreq(1, 0.5)):
        sch.add(r)
    assert sch.select(2, 0) == []                 # head needs 3 lanes
    assert [r.req_id for r in sch.select(4, 0)] == [0, 1]


def test_sjf_orders_by_trajectory_cost_and_ages():
    menu = {"ddpm": tsm.make_sampler(T), "ddim": tsm.make_sampler(T, "ddim",
                                                                  4)}
    sch = tserve.CutRatioScheduler(T, aging=1.0, samplers=menu)
    reqs = [_sreq(0, 0.0), _sreq(1, 0.75), _sreq(2, 0.5)]
    reqs.append(tserve.Request(req_id=3, seed=3, cut_ratio=0.0,
                               sampler="ddim"))
    for r in reqs:
        sch.add(r)
    assert [r.req_id for r in sch.select(2, 0)] == [1, 3]
    # a long job that waited T ticks outranks a fresh short one
    sch2 = tserve.CutRatioScheduler(T, aging=1.0, samplers=menu)
    sch2.add(_sreq(0, 0.0))
    sch2.add(_sreq(1, 0.75, arrival=T))
    assert [r.req_id for r in sch2.select(1, T)] == [0]
    assert sch2.aging_promotions == 1


def test_retired_callbacks_fire_and_unsubscribe():
    sch = tserve.FIFOScheduler()
    seen = []
    unsub = sch.on_retired(lambda r, t: seen.append((r.req_id, t)))
    sch.notify_retired(_sreq(4, 0.5), 7)
    unsub()
    unsub()
    sch.notify_retired(_sreq(5, 0.5), 8)
    assert seen == [(4, 7)]


def test_metrics_exact_occupancy_and_finish_summary():
    m = tserve.ServeMetrics(4)
    m.on_admit(0, 0)
    m.on_window_exact(3, [0, 2, 1])        # active 3, 3, 1 over the window
    m.on_retire(0, 3)
    s = m.summary(1.0, T, 1.0, [_sreq(0, 0.5)])
    assert s["ticks"] == 3 and s["latency_ticks_p50"] == 3
    assert s["utilization_mean"] == pytest.approx((3 + 3 + 1) / 12)
    f = tserve.finish_summary("drain", 0.5, batches=2, lanes=3)
    assert f["overlap_frac"] == 0.0 and f["finish_tail_s"] == 0.5
    f = tserve.finish_summary("stream", 0.5, 0.125, batches=2, lanes=3)
    assert f["overlap_frac"] == 0.75 and f["finish_tail_s"] == 0.125
    with pytest.raises(ValueError, match="finish mode"):
        tserve.finish_summary("eager", 0.5)


def test_flops_split_matches_reference():
    from repro.core import collafuse as jcf
    for c in (0.0, 0.3, 1.0):
        assert tcf.flops_split(tcf.CutPlan(T, c), 5.0, 2) == \
            jcf.flops_split(JaxCutPlan(T, c), 5.0, 2)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
def test_launcher_runs_on_cpu(tmp_path):
    out = tmp_path / "summary.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_diffusion",
         "--device", "cpu", "--config", "launcher", "--T", "10",
         "--requests", "5", "--slots", "3", "--clients", "2", "--mix",
         "--ticks-per-dispatch", "2", "--arrival-every", "1",
         "--json", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "serve_diffusion OK"
    assert "engine: 5 requests" in proc.stdout
    assert out.exists()
