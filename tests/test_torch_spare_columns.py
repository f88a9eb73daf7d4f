"""Spare menu columns and ``ServeEngine.register_sampler`` (counterpart of
the reference's dynamic sampler menus): a sampler registered into spare
columns serves bitwise like the same sampler in the static menu, the least
recently served entries are evicted with their extents merged, registration
validates its input and refuses to run inside ``serve()``, and the admission
policy and the scheduler learn the entry."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import set_torch_cpu  # noqa: E402
from repro_torch.diffusion import sampler as tsm  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402
from repro_torch.launch.serve_diffusion import launcher_config  # noqa: E402
from repro_torch.models.unet import UNet  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402

set_torch_cpu()

T = 10
SHAPE = (8, 8, 1)


@pytest.fixture(scope="module")
def unets():
    return [UNet(launcher_config(SHAPE[0]), seed=s).eval() for s in (0, 1)]


def _engine(server, menu, **kw):
    return tserve.ServeEngine(tserve.EngineConfig(
        sched=tsch.cosine_schedule(T), image_shape=SHAPE, slots=3,
        scheduler=tserve.make_scheduler("cut_ratio", T), samplers=menu,
        step_backend="cuda_masked", device="cpu", **kw), server)


def _ddim(K):
    return tsm.make_sampler(T, "ddim", K, eta=0.0)


def _requests(sampler):
    return [tserve.Request(req_id=i, seed=123 + i, batch=1 + i % 2,
                           cut_ratio=0.5, sampler=sampler, arrival_tick=i)
            for i in range(3)]


def test_register_sampler_matches_static_menu_bitwise(unets):
    server, client = unets
    static = _engine(server, {"ddpm": tsm.make_sampler(T), "dyn": _ddim(4)})
    ref = static.serve(_requests("dyn"), [client])
    eng = _engine(server, {"ddpm": tsm.make_sampler(T)}, spare_columns=8)
    eng.serve(_requests("ddpm"), [client])
    tid = eng.register_sampler("dyn", _ddim(4))
    assert eng.registered_samplers() == {"dyn": tid}
    assert eng.scheduler.samplers["dyn"] is eng.samplers["dyn"]
    res = eng.serve(_requests("dyn"), [client])
    for rid, c in ref.completions.items():
        np.testing.assert_array_equal(res.completions[rid].x_mid, c.x_mid)
        np.testing.assert_array_equal(res.completions[rid].x0, c.x0)
    assert eng.captures == 0          # no graph on the CPU; never a new one


def test_register_sampler_lru_eviction_and_extent_merge(unets):
    server, _ = unets
    eng = _engine(server, {"ddpm": tsm.make_sampler(T)}, spare_columns=8)
    eng.register_sampler("s1", _ddim(4))
    eng.register_sampler("s2", _ddim(4))          # spare region now full
    assert set(eng.registered_samplers()) == {"s1", "s2"}
    # serving s1 makes s2 the least recently served
    eng.serve([tserve.Request(req_id=0, seed=1, sampler="s1")])
    eng.register_sampler("s3", _ddim(4))
    assert set(eng.registered_samplers()) == {"s1", "s3"}
    assert "s2" not in eng.samplers and "s2" not in eng.scheduler.samplers
    # a full-width entry evicts both and needs their extents merged
    eng.register_sampler("wide", _ddim(8))
    assert set(eng.registered_samplers()) == {"wide"}
    assert eng._dyn_free == []
    res = eng.serve([tserve.Request(req_id=1, seed=2, cut_ratio=0.5,
                                    sampler="wide")])
    assert np.isfinite(res.completions[1].x_mid).all()


def test_register_sampler_validation(unets):
    server, _ = unets
    eng0 = _engine(server, {"ddpm": tsm.make_sampler(T)})
    with pytest.raises(ValueError, match="spare_columns"):
        eng0.register_sampler("d", _ddim(4))
    eng = _engine(server, {"ddpm": tsm.make_sampler(T)}, spare_columns=4)
    with pytest.raises(ValueError, match="static"):
        eng.register_sampler("ddpm", tsm.make_sampler(T))
    with pytest.raises(ValueError, match="T="):
        eng.register_sampler("d", tsm.make_sampler(T + 1))
    with pytest.raises(ValueError, match="spare columns"):
        eng.register_sampler("d", _ddim(6))
    with pytest.raises(ValueError, match="guided"):
        eng.register_sampler("g", tsm.make_sampler(T, "ddim", 4,
                                                   guidance=1.5))
    # re-registration under one name replaces the entry in full
    eng.register_sampler("d", _ddim(4))
    tid = eng.register_sampler("d", _ddim(4))
    assert eng.registered_samplers() == {"d": tid}


def test_register_sampler_refuses_to_run_inside_serve(unets):
    server, _ = unets
    eng = _engine(server, {"ddpm": tsm.make_sampler(T)}, spare_columns=4)
    seen = []

    def register(req, tick):
        with pytest.raises(RuntimeError, match="between serve"):
            eng.register_sampler("d", _ddim(4))
        seen.append(req.req_id)
    eng.scheduler.on_retired(register)
    eng.serve([tserve.Request(req_id=0, seed=1, cut_ratio=0.5)])
    assert seen == [0] and eng.registered_samplers() == {}


def test_register_sampler_updates_the_admission_policy(unets):
    server, _ = unets
    calib = torch.zeros((2,) + SHAPE)
    policy = tserve.AdmissionPolicy(tsch.cosine_schedule(T), calib,
                                    min_kid=float("-inf"))
    eng = _engine(server, {"ddpm": tsm.make_sampler(T)}, spare_columns=4,
                  admission=policy)
    eng.register_sampler("d", _ddim(4))
    assert "d" in policy.samplers
    d = policy.decide(tserve.Request(req_id=0, seed=1, cut_ratio=0.5,
                                     sampler="d"))
    assert d.served
    eng.register_sampler("e", _ddim(4))            # evicts d
    assert "d" not in policy.samplers and "e" in policy.samplers
