"""Port parity for the engine's host path against the reference engine:
windows in flight (``async_depth``), the streamed client finisher and its
``finish_async_depth``, with the reference's threefry noise injected (staged
from the host into each window).  Admission and retirement ticks must be
exactly the reference's at the same (k, async_depth); the tensors agree to
the tolerance of ``test_torch_serve.py`` (the two frameworks sum the
convolutions in another order)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (reference_lane_noise, set_torch_cpu,  # noqa: E402
                           unet_params)
from repro.configs.base import UNetConfig as JaxUNetConfig  # noqa: E402
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

# f32 on both sides, convolutions summed in another order, and the first
# dense step at T=10 divides by √(1−β_T) ≈ 0.032 before the clip (as
# test_torch_serve.py's TOL)
TOL = dict(rtol=0, atol=1e-4)
T = 10
SHAPE = (8, 8, 1)
# (seed, batch, cut_ratio, client, arrival, sampler): more lanes than the 3
# slots, staggered arrivals, a local-only c=1 and an all-server c=0 request
TRAFFIC = [(200, 1, 0.25, 0, 0, "ddpm"), (201, 2, 0.5, 1, 0, "ddim"),
           (202, 1, 0.75, 1, 1, "ddpm"), (203, 2, 1.0, 0, 2, "ddpm"),
           (204, 1, 0.0, 0, 2, "ddim"), (205, 2, 0.5, 0, 5, "ddpm"),
           (206, 1, 0.25, 1, 6, "ddim"), (207, 1, 0.5, 0, 7, "ddim")]


def _menus():
    args = {"ddpm": (T,), "ddim": (T, "ddim", 4, 0.3)}
    return ({k: jsm.make_sampler(*a) for k, a in args.items()},
            {k: tsm.make_sampler(*a) for k, a in args.items()})


@pytest.fixture(scope="module")
def models():
    """The reference launcher's U-Net, one set of numpy weights for both
    frameworks: server and 2 clients."""
    port_cfg = launcher_config(SHAPE[0])
    ref_cfg = JaxUNetConfig(**{f.name: getattr(port_cfg, f.name)
                               for f in dataclasses.fields(JaxUNetConfig)})
    params = [unet_params(ref_cfg, s, perturb=False) for s in (10, 11, 12)]
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


@pytest.mark.parametrize("k,depth,mode,fdepth", [
    (1, 2, "stream", 1), (3, 2, "stream", 2), (3, 3, "drain", 1)])
def test_async_and_streamed_serve_matches_reference(models, k, depth, mode,
                                                    fdepth):
    ref_cfg, params, (server, *clients) = models
    jmenu, tmenu = _menus()
    knobs = dict(ticks_per_dispatch=k, async_depth=depth, finish_mode=mode,
                 finish_async_depth=fdepth)
    ref = jserve.ServeEngine(jserve.EngineConfig(
        sched=jsch.cosine_schedule(T),
        apply_fn=lambda p, x, t: junet.forward(p, x, t, ref_cfg),
        image_shape=SHAPE, slots=3,
        scheduler=jserve.make_scheduler("cut_ratio", T, samplers=jmenu),
        step_backend="jnp", samplers=jmenu, **knobs), params[0]).serve(
            [jserve.Request(req_id=i, key=jax.random.PRNGKey(s), batch=b,
                            cut_ratio=c, client_idx=ci, arrival_tick=a,
                            sampler=smp)
             for i, (s, b, c, ci, a, smp) in enumerate(TRAFFIC)],
            adamw.tree_stack(params[1:]))
    port = tserve.ServeEngine(tserve.EngineConfig(
        sched=tsch.cosine_schedule(T), image_shape=SHAPE, slots=3,
        scheduler=tserve.make_scheduler("cut_ratio", T, samplers=tmenu),
        step_backend="cuda_masked", samplers=tmenu, device="cpu", **knobs),
        server).serve(
            [tserve.Request(req_id=i, seed=s, batch=b, cut_ratio=c,
                            client_idx=ci, arrival_tick=a, sampler=smp)
             for i, (s, b, c, ci, a, smp) in enumerate(TRAFFIC)],
            clients, noise=_noise())
    assert set(port.completions) == set(ref.completions) == \
        set(range(len(TRAFFIC)))
    for rid, rc in ref.completions.items():
        pc = port.completions[rid]
        assert (pc.admit_tick, pc.retire_tick) == \
            (int(rc.admit_tick), int(rc.retire_tick)), rid
        np.testing.assert_allclose(pc.x_mid, rc.x_mid, **TOL,
                                   err_msg=f"x_mid req {rid}")
        np.testing.assert_allclose(pc.x0, rc.x0, **TOL,
                                   err_msg=f"x0 req {rid}")
        assert pc.client_finished
    for key in ("async_depth", "finish_async_depth", "finish_mode",
                "ticks_per_dispatch", "ticks", "windows", "idle_ticks",
                "latency_ticks_p50", "latency_ticks_p95", "utilization_mean",
                "boundary_lag_p100", "finish_lanes"):
        assert port.summary[key] == pytest.approx(ref.summary[key]), key
    assert 0.0 <= port.summary["overlap_frac"] <= 1.0
    if mode == "stream":
        # the same waves: per-class buckets of 2·slots lanes, whole requests
        assert port.summary["finish_batches"] == ref.summary["finish_batches"]
    else:
        assert port.summary["overlap_frac"] == 0.0
