"""The engine's host path against itself, bitwise, under the default noise
source (``lane_philox``, drawn inside each window): windows in flight
against the synchronous engine, the streamed finisher against the drain
one, window depth k against k=1, a lane against ``split_sample_lane``'s
replay, a staged host source against the same draws made in the window; the
same under a KID gate with guided traffic; and the new knobs' validation."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import set_torch_cpu  # noqa: E402
from repro_torch.core import collafuse as tcf  # noqa: E402
from repro_torch.data.synthetic import (ClientDataConfig,  # noqa: E402
                                        make_client_datasets)
from repro_torch.diffusion import sampler as tsm  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402
from repro_torch.launch.serve_diffusion import launcher_config  # noqa: E402
from repro_torch.models.unet import UNet  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402

set_torch_cpu()

T = 10
SHAPE = (8, 8, 1)
NC = 4
# an engine lane against its batch-1 replay: the CPU picks other
# convolution kernels for another batch size (test_torch_serve.py)
LANE_TOL = dict(rtol=0, atol=3e-4)
MENU = {"ddpm": ((T,), {}), "ddim": ((T, "ddim", 4, 0.3), {}),
        "ddpm_g": ((T,), {"guidance": 1.5}),
        "ddim_g": ((T, "ddim", 4, 0.0), {"guidance": 2.0})}


def _menu(names=("ddpm", "ddim")):
    return {n: tsm.make_sampler(*MENU[n][0], **MENU[n][1]) for n in names}


@pytest.fixture(scope="module")
def unets():
    """Server + 2 clients: the launcher's U-Net, unconditional and with a
    4-class label embedding."""
    plain = [UNet(launcher_config(SHAPE[0]), seed=s).eval() for s in range(3)]
    cond = [UNet(launcher_config(SHAPE[0], NC), seed=s).eval()
            for s in range(3, 6)]
    return plain, cond


def _requests(names=("ddpm", "ddim"), n=9):
    """Mixed samplers and cuts (a local-only c=1 among them), batch 1-2,
    staggered arrivals, three clients' worth of lanes over two models."""
    return [tserve.Request(req_id=i, seed=500 + i, batch=1 + i % 2,
                           cut_ratio=(0.25, 0.5, 0.75, 1.0)[i % 4],
                           client_idx=i % 2, arrival_tick=i % 5,
                           sampler=names[i % len(names)], label=i % NC)
            for i in range(n)]


def _engine(server, menu, k=1, depth=1, mode="drain", fdepth=1, slots=3,
            **kw):
    return tserve.ServeEngine(tserve.EngineConfig(
        sched=tsch.cosine_schedule(T), image_shape=SHAPE, slots=slots,
        scheduler=tserve.make_scheduler("cut_ratio", T, samplers=menu),
        step_backend=kw.pop("backend", "cuda_masked"), samplers=menu,
        ticks_per_dispatch=k, async_depth=depth, finish_mode=mode,
        finish_async_depth=fdepth, device="cpu", **kw), server)


def _bitwise(a, b):
    assert set(a.completions) == set(b.completions)
    for rid, ca in a.completions.items():
        cb = b.completions[rid]
        np.testing.assert_array_equal(cb.x_mid, ca.x_mid,
                                      err_msg=f"x_mid {rid}")
        np.testing.assert_array_equal(cb.x0, ca.x0, err_msg=f"x0 {rid}")
        assert ca.client_finished and cb.client_finished


@pytest.fixture(scope="module")
def sync_drain(unets):
    (server, *clients), _ = unets
    return _engine(server, _menu()).serve(_requests(), clients)


@pytest.mark.parametrize("k,depth,mode,fdepth", [
    (1, 1, "stream", 1), (1, 2, "drain", 1), (3, 2, "stream", 2),
    (4, 3, "stream", 1), (2, 1, "stream", 3)])
def test_async_and_stream_are_bitwise_the_sync_drain_engine(
        unets, sync_drain, k, depth, mode, fdepth):
    (server, *clients), _ = unets
    res = _engine(server, _menu(), k, depth, mode, fdepth).serve(
        _requests(), clients)
    _bitwise(sync_drain, res)
    s = res.summary
    assert (s["async_depth"], s["finish_mode"], s["finish_async_depth"]) == \
        (depth, mode, fdepth)
    assert s.get("boundary_lag_p100", 0) <= k - 1
    if mode == "stream":
        assert s["finish_batches"] >= 1 and 0.0 <= s["overlap_frac"] <= 1.0
    assert s["finish_lanes"] == sum(r.batch for r in _requests())


def test_async_windows_keep_the_reference_admission_ticks(unets):
    """Depth 2 frees a finished lane one window later (at its window's
    sync), as the reference does: its requests retire at the same window
    boundaries and later admissions shift, never earlier."""
    (server, *_), _ = unets
    a = _engine(server, _menu(), k=2).serve(_requests())
    b = _engine(server, _menu(), k=2, depth=2).serve(_requests())
    for rid, ca in a.completions.items():
        cb = b.completions[rid]
        assert cb.admit_tick >= ca.admit_tick
        assert (cb.retire_tick - cb.admit_tick) == \
            (ca.retire_tick - ca.admit_tick)
    assert b.summary["windows"] >= a.summary["windows"]


def test_lane_replays_split_sample_lane_under_the_default_source(
        unets, sync_drain):
    (server, *clients), _ = unets
    menu = _menu()
    for rid in (1, 3, 4):                  # ddim, local-only, ddpm c=0.25
        comp = sync_drain.completions[rid]
        r = comp.request
        for i in range(r.batch):
            x0, mid = tcf.split_sample_lane(
                tsch.cosine_schedule(T), tcf.CutPlan(T, r.cut_ratio), server,
                clients[r.client_idx], r.seed, i, SHAPE,
                return_intermediate=True, sampler=menu[r.sampler],
                device="cpu")
            np.testing.assert_allclose(comp.x_mid[i], mid.numpy(),
                                       **LANE_TOL)
            np.testing.assert_allclose(comp.x0[i], x0.numpy(), **LANE_TOL)


def test_staged_host_draws_are_bitwise_the_window_draws(unets, sync_drain):
    """The same Philox draws given as a host source (no batched form):
    staged into each window and finisher chunk from pinned memory, the
    completions are bitwise the in-window draws'."""
    (server, *clients), _ = unets

    class Host:
        def __call__(self, *key):
            return tcf.lane_philox(*key)
    res = _engine(server, _menu()).serve(_requests(), clients, noise=Host())
    _bitwise(sync_drain, res)


@pytest.fixture(scope="module")
def gated(unets):
    """A KID gate on the conditional U-Net, its floor at the median of the
    guided DDPM profile (some requests admit, some bump), and the synchronous
    drain run of guided and unguided traffic through it."""
    _, (server, *clients) = unets
    menu = _menu(tuple(MENU))
    calib = make_client_datasets(ClientDataConfig(
        n_clients=1, per_client=4, image_size=SHAPE[0], holdout=2,
        seed=0))[0][0]
    probe = tserve.AdmissionPolicy(tsch.cosine_schedule(T), calib,
                                   min_kid=float("-inf"), samplers=menu)
    _engine(server, menu, num_classes=NC, admission=probe)   # binds it
    floor = float(np.median(probe.profile("ddpm_g")))
    ref = _engine(server, _menu(tuple(MENU)), slots=4, num_classes=NC,
                  admission=probe.with_min_kid(floor)).serve(
                      _requests(tuple(MENU), 10), clients)
    assert any(d.action != "admit" for d in ref.decisions.values()), \
        "the floor must gate"
    assert any(c.request.sampler.endswith("_g")
               for c in ref.completions.values())
    return probe, floor, ref


@pytest.mark.parametrize("k,depth,mode,fdepth", [
    (1, 1, "stream", 1), (3, 2, "stream", 2), (2, 3, "drain", 1)])
def test_gated_guided_traffic_async_and_stream_bitwise(unets, gated, k,
                                                       depth, mode, fdepth):
    _, (server, *clients) = unets
    probe, floor, ref = gated
    res = _engine(server, _menu(tuple(MENU)), k, depth, mode, fdepth,
                  slots=4, num_classes=NC,
                  admission=probe.with_min_kid(floor)).serve(
                      _requests(tuple(MENU), 10), clients)
    assert res.decisions == ref.decisions
    _bitwise(ref, res)


# ---------------------------------------------------------------------------
# the knobs' validation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("knob,value", [
    ("async_depth", 0), ("async_depth", 33), ("finish_async_depth", 0),
    ("finish_async_depth", 33), ("finish_mode", "eager"),
    ("spare_columns", -1), ("spare_columns", 4097)])
def test_engine_config_host_path_knob_validation(knob, value):
    with pytest.raises(ValueError, match=knob):
        tserve.EngineConfig(sched=tsch.cosine_schedule(T), image_shape=SHAPE,
                            device="cpu", **{knob: value})


def test_engine_config_host_path_defaults():
    cfg = tserve.EngineConfig(sched=tsch.cosine_schedule(T),
                              image_shape=SHAPE, device="cpu")
    assert (cfg.async_depth, cfg.finish_mode, cfg.finish_async_depth,
            cfg.spare_columns, cfg.cuda_graphs) == (1, "stream", 1, 0, True)
    assert dataclasses.replace(cfg, finish_mode="drain").finish_mode == \
        "drain"
