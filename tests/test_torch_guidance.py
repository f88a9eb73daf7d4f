"""Port parity for classifier-free guidance: guided coefficient tables,
``guided_masked_index_step`` on every backend, guided ``sample_trajectory``
and ``disclosed_at_pos``, and a guided serve of the conditional launcher
U-Net against the reference engine (its threefry noise injected); inside
the port, k = 3 ≡ k = 1, w = 0 twins ≡ unguided, shadow ≡ primary, one step
a tick, bitwise.

Tolerances, each beside its assert:
* tables rtol 1e-6 (as ``test_torch_schedule.py``), the w row exact;
* the guided step against the reference's jnp one: atol/rtol 1e-6 for the
  plain and cuda_masked backends (the combine and the update are the same
  f32 expressions; ~1e-7 where XLA contracts a multiply-add), 1e-5 for
  triton's plain version (x·(1/√ar) in place of x/√ar);
* guided chains atol 1e-4: the tiny model's ε̂ differs by ~4e-7 across
  the frameworks (matmuls summed in another order), the combine scales a
  gap by up to 1 + 2w (5 at w = 2) and the first step divides by
  √ar ≈ 0.032 (×31) before the clip: ~6e-5 (3e-5 to 5e-5 measured);
* the engine: ``test_torch_serve.py``'s TOL for unguided requests, and
  TOL·(1 + 2w) for guided ones, as the combine scales an ε̂ gap by up to
  1 + 2w (measured: 6.9e-5 in x_mid and 1.6e-4 in x0 at w = 2, c = 0.75,
  where the unguided requests stay under 3e-5).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (TinyCondEps, reference_chain_noise,  # noqa: E402
                           reference_disclosure_noise, reference_lane_noise,
                           set_torch_cpu, tiny_cond_apply_jax,
                           tiny_cond_params, unet_params)
from repro.configs.base import UNetConfig as JaxUNetConfig  # noqa: E402
from repro.core import collafuse as jcf  # noqa: E402
from repro.diffusion import backend as jbk  # noqa: E402
from repro.diffusion import sampler as jsm  # noqa: E402
from repro.diffusion import schedule as jsch  # noqa: E402
from repro.models import unet as junet  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro_torch.core import collafuse as tcf  # noqa: E402
from repro_torch.diffusion import backend as tbk  # noqa: E402
from repro_torch.diffusion import sampler as tsm  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402
from repro_torch.launch.serve_diffusion import launcher_config  # noqa: E402
from repro_torch.models.unet import UNet, params_from_jax  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402

set_torch_cpu()

T = 10
SHAPE = (8, 8, 1)
NC = 4
BACKENDS = ["torch", "triton", "cuda_masked"]      # plain versions on the CPU
STEP_TOL = {"torch": dict(rtol=1e-6, atol=1e-6),
            "cuda_masked": dict(rtol=1e-6, atol=1e-6),
            "triton": dict(rtol=1e-5, atol=1e-5)}
CHAIN_TOL = dict(rtol=0, atol=1e-4)
# test_torch_serve.py's TOL: f32 convolutions summing in another order,
# amplified by the first dense step's 1/√(1−β_T) ≈ 31 at T = 10
TOL = dict(rtol=0, atol=1e-4)
MENU_ARGS = {"ddpm": ((T,), {}), "ddim": ((T, "ddim", 4, 0.3), {}),
             "ddpm_g": ((T,), {"guidance": 1.5}),
             "ddim_g": ((T, "ddim", 4, 0.3), {"guidance": 2.0}),
             "ddpm_g0": ((T,), {"guidance": 0.0}),
             "ddim_g0": ((T, "ddim", 4, 0.3), {"guidance": 0.0})}
# (seed, batch, cut_ratio, client, arrival, sampler, label): guided and
# unguided lanes in the same ticks, a local-only guided request (c = 1),
# an all-server one (c = 0), and queueing (a guided batch 2 takes 4 lanes)
TRAFFIC = [(200, 2, 0.5, 0, 0, "ddpm_g", 1), (201, 1, 0.25, 1, 0, "ddpm", 0),
           (202, 1, 0.5, 1, 1, "ddim_g", 3), (203, 2, 1.0, 0, 1, "ddpm_g", 2),
           (204, 1, 0.0, 0, 2, "ddim", 0), (205, 2, 0.75, 1, 3, "ddim_g", 0),
           (206, 1, 0.25, 0, 4, "ddpm_g", 2)]
TWINS = {"ddpm": "ddpm_g0", "ddim": "ddim_g0"}


def _menus(names=MENU_ARGS):
    return ({n: jsm.make_sampler(*MENU_ARGS[n][0], **MENU_ARGS[n][1])
             for n in names},
            {n: tsm.make_sampler(*MENU_ARGS[n][0], **MENU_ARGS[n][1])
             for n in names})


# ---------------------------------------------------------------------------
# tables and the guided step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["ddpm_g", "ddim_g", "ddpm_g0", "ddim"])
def test_guided_tables_match_reference(name):
    jmenu, tmenu = _menus()
    ref = np.asarray(jmenu[name].tables(jsch.cosine_schedule(T)))
    port = tmenu[name].tables(tsch.cosine_schedule(T)).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(port[4], ref[4])          # w row exact
    assert tmenu[name].guided == jmenu[name].guided
    assert tmenu[name].w == jmenu[name].w
    assert tmenu[name].describe() == jmenu[name].describe()


def _step_inputs(w):
    """Seven lanes over an unguided (K=10) and a guided table (K=4, scale
    ``w``): a pair (0 primary, 4 shadow), a pair (5 primary, 1 shadow), a
    solo lane on a guided column (2), a solo lane on an unguided column (3),
    and an inactive lane at an out-of-range column (6)."""
    sched = tsch.cosine_schedule(T)
    tables = torch.cat([tsm.make_sampler(T).tables(sched),
                        tsm.make_sampler(T, "ddim", 4, 0.3,
                                         guidance=w).tables(sched)], dim=1)
    rng = np.random.default_rng(3)
    x, eps, z = (rng.standard_normal((7,) + SHAPE).astype(np.float32)
                 for _ in range(3))
    x[4] = x[0]                                # a pair shares its x
    x[1] = x[5]
    cols = np.array([11, 12, 10, 3, 11, 12, 99], np.int32)
    active = np.array([True, True, True, True, True, True, False])
    pair = np.array([4, 5, 2, 3, 0, 1, 6], np.int64)
    cond = np.array([True, False, True, True, False, True, True])
    return tables, x, cols, eps, z, active, pair, cond


@pytest.mark.parametrize("w", [0.0, 1.5])
@pytest.mark.parametrize("backend", BACKENDS)
def test_guided_masked_index_step_matches_reference(backend, w):
    tables, x, cols, eps, z, active, pair, cond = _step_inputs(w)
    ref = np.asarray(jbk.get_backend("jnp").guided_masked_index_step(
        jnp.asarray(x), jnp.asarray(cols), jnp.asarray(eps), jnp.asarray(z),
        jnp.asarray(active), jnp.asarray(pair, np.int32), jnp.asarray(cond),
        jnp.asarray(tables.numpy())))
    args = [torch.from_numpy(a) for a in (x, cols, eps, z, active, pair,
                                          cond)]
    be = tbk.get_backend(backend)
    out = be.guided_masked_index_step(*args, tables)
    np.testing.assert_allclose(out.numpy(), ref, **STEP_TOL[backend])
    assert torch.equal(out[6], args[0][6])              # inactive: bitwise
    torch.testing.assert_close(out[4], out[0], rtol=0, atol=0)   # pairs
    torch.testing.assert_close(out[1], out[5], rtol=0, atol=0)
    plain = be.masked_index_step(args[0], args[1], args[2], args[3],
                                 args[4], tables)
    for lane in (2, 3, 6):                    # solo lanes: the plain step
        assert torch.equal(out[lane], plain[lane])
    if w == 0.0:
        # w = 0: the primaries' ε̂ is their shadows' (ε̂_u), and the step
        # is otherwise the plain one
        e = args[2].clone()
        e[0], e[5] = e[4], e[1]
        zz = args[3].clone()
        zz[4], zz[1] = zz[0], zz[5]
        want = be.masked_index_step(args[0], args[1], e, zz, args[4], tables)
        assert torch.equal(out, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_guided_step_all_solo_is_bitwise_the_masked_step(backend):
    tables, x, cols, eps, z, active, _, _ = _step_inputs(1.5)
    args = [torch.from_numpy(a) for a in (x, cols, eps, z, active)]
    be = tbk.get_backend(backend)
    out = be.guided_masked_index_step(
        *args, torch.arange(7), torch.ones(7, dtype=torch.bool), tables)
    assert torch.equal(out, be.masked_index_step(*args, tables))
    # a bare 4-row table goes straight to the masked step
    out4 = be.guided_masked_index_step(
        *args, torch.tensor([4, 5, 2, 3, 0, 1, 6]),
        torch.ones(7, dtype=torch.bool), tables[:4])
    assert torch.equal(out4, be.masked_index_step(*args, tables[:4]))


# ---------------------------------------------------------------------------
# guided chains
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cond_models():
    p = tiny_cond_params(SHAPE, 7, NC)
    ref = (jax.jit(functools.partial(tiny_cond_apply_jax, p)),
           jax.jit(lambda x, t, y: tiny_cond_apply_jax(p, x, t, y)))
    port = TinyCondEps(p).eval()
    return ref, port


@pytest.mark.parametrize("name", ["ddpm_g", "ddim_g"])
def test_guided_sample_trajectory_matches_reference(cond_models, name):
    (juncond, jcond), port = cond_models
    jmenu, tmenu = _menus()
    K = tmenu[name].K
    x = np.random.default_rng(5).standard_normal((2,) + SHAPE)
    x = x.astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jsm.sample_trajectory(
        jsch.cosine_schedule(T), jmenu[name], juncond, key, jnp.asarray(x),
        0, K, cond_fn=jcond, label=2))
    chain = reference_chain_noise(key, K, x.shape)
    out = tsm.sample_trajectory(
        tsch.cosine_schedule(T), tmenu[name], port,
        lambda j: torch.from_numpy(chain[j].copy()), torch.from_numpy(x), 0, K,
        cond_fn=port, label=2)
    np.testing.assert_allclose(out.numpy(), ref, **CHAIN_TOL)


@pytest.mark.parametrize("pos", [0, 3, 6])
def test_guided_disclosed_at_pos_matches_reference(cond_models, pos):
    (juncond, jcond), port = cond_models
    jmenu, tmenu = _menus()
    x0 = np.tanh(np.random.default_rng(6).standard_normal((3,) + SHAPE))
    x0 = x0.astype(np.float32)
    key = jax.random.PRNGKey(4242)
    ref = np.asarray(jcf.disclosed_at_pos(
        jsch.cosine_schedule(T), jmenu["ddpm_g"], juncond, key,
        jnp.asarray(x0), pos, cond_fn=jcond, label=0))
    noise = tcf.InjectedNoise(reference_disclosure_noise(key, 9, x0.shape,
                                                         pos))
    out = tcf.disclosed_at_pos(tsch.cosine_schedule(T), tmenu["ddpm_g"],
                               port, 9, torch.from_numpy(x0), pos,
                               noise=noise, cond_fn=port, label=0)
    np.testing.assert_allclose(out.numpy(), ref, **CHAIN_TOL)


def test_w0_chain_is_bitwise_the_unguided_one(cond_models):
    _, port = cond_models
    _, tmenu = _menus()
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2,) + SHAPE).astype(np.float32))
    for name, twin in TWINS.items():
        K = tmenu[name].K
        outs = [tsm.sample_trajectory(
            tsch.cosine_schedule(T), tmenu[n], port,
            lambda j: tcf.lane_normal(1, 0, "server", j, (2,) + SHAPE), x,
            0, K, cond_fn=port, label=3) for n in (name, twin)]
        assert torch.equal(outs[0], outs[1]), name


def test_guided_flops_double_the_server_segment():
    g = tcf.flops_split_steps(6, 4, 5.0, 3, guided=True)
    u = tcf.flops_split_steps(6, 4, 5.0, 3)
    assert g["server_flops"] == 2 * u["server_flops"]
    assert g["client_flops"] == u["client_flops"]
    assert g == jcf.flops_split_steps(6, 4, 5.0, 3, guided=True)


# ---------------------------------------------------------------------------
# the guided engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cond_unets():
    """The conditional launcher U-Net (4 classes + null), one set of numpy
    weights for both frameworks: server + 2 clients."""
    port_cfg = launcher_config(SHAPE[0], NC)
    ref_cfg = JaxUNetConfig(**{f.name: getattr(port_cfg, f.name)
                               for f in dataclasses.fields(JaxUNetConfig)})
    params = [unet_params(ref_cfg, s, perturb=False) for s in (0, 1, 2)]
    modules = []
    for p in params:
        m = UNet(port_cfg)
        m.load_state_dict(params_from_jax(p))
        modules.append(m.eval())
    return ref_cfg, params, modules


def _traffic(rename=None):
    rename = rename or {}
    return [tserve.Request(req_id=i, seed=s, batch=b, cut_ratio=c,
                           client_idx=ci, arrival_tick=a,
                           sampler=rename.get(smp, smp), label=y)
            for i, (s, b, c, ci, a, smp, y) in enumerate(TRAFFIC)]


def _noise():
    _, tmenu = _menus()
    draws = {}
    for seed, b, c, _, _, smp, _ in TRAFFIC:
        s = tmenu[smp]
        reference_lane_noise(seed, b, SHAPE, tcf.CutPlan(T, c).cut_index(s),
                             s.K, draws)
    return tcf.InjectedNoise(draws)


def _engine(server, k=1, backend="torch", slots=6, **kw):
    _, tmenu = _menus()
    cfg = tserve.EngineConfig(
        sched=tsch.cosine_schedule(T), image_shape=SHAPE, slots=slots,
        scheduler=tserve.make_scheduler("cut_ratio", T, samplers=tmenu),
        step_backend=backend, samplers=tmenu, ticks_per_dispatch=k,
        device="cpu", num_classes=NC, **kw)
    return tserve.ServeEngine(cfg, server)


@pytest.fixture(scope="module")
def guided_k1(cond_unets):
    _, _, (server, *clients) = cond_unets
    return _engine(server).serve(_traffic(), clients, noise=_noise())


def test_guided_serve_matches_reference_engine(cond_unets, guided_k1):
    ref_cfg, params, _ = cond_unets
    jmenu, _ = _menus()
    cfg = jserve.EngineConfig(
        sched=jsch.cosine_schedule(T),
        apply_fn=lambda p, x, t, y: junet.forward(p, x, t, ref_cfg, y),
        image_shape=SHAPE, slots=6,
        scheduler=jserve.make_scheduler("cut_ratio", T, samplers=jmenu),
        step_backend="jnp", samplers=jmenu, finish_mode="drain",
        num_classes=NC)
    reqs = [jserve.Request(req_id=i, key=jax.random.PRNGKey(s), batch=b,
                           cut_ratio=c, client_idx=ci, arrival_tick=a,
                           sampler=smp, label=y)
            for i, (s, b, c, ci, a, smp, y) in enumerate(TRAFFIC)]
    ref = jserve.ServeEngine(cfg, params[0]).serve(
        reqs, adamw.tree_stack(params[1:]))
    port = guided_k1
    _, tmenu = _menus()
    assert set(port.completions) == set(ref.completions) == \
        set(range(len(TRAFFIC)))
    for rid, rc in ref.completions.items():
        pc = port.completions[rid]
        assert (pc.admit_tick, pc.retire_tick) == \
            (int(rc.admit_tick), int(rc.retire_tick)), rid
        assert pc.x_mid.shape == rc.x_mid.shape
        tol = dict(rtol=0, atol=TOL["atol"] * (
            1 + 2 * tmenu[pc.request.sampler].w))
        np.testing.assert_allclose(pc.x_mid, rc.x_mid, **tol,
                                   err_msg=f"x_mid req {rid}")
        np.testing.assert_allclose(pc.x0, rc.x0, **tol,
                                   err_msg=f"x0 req {rid}")
    for key in ("requests", "served", "images", "ticks", "latency_ticks_p50",
                "latency_ticks_p95", "utilization_mean",
                "boundary_lag_mean"):
        assert port.summary[key] == pytest.approx(ref.summary[key]), key
    for key in ("server_flops", "client_flops", "client_fraction"):
        # both count 2 FLOP per parameter per model call, 2x guided server
        assert port.summary[key] == pytest.approx(ref.summary[key],
                                                  rel=1e-6), key


def test_guided_server_flops_are_twice_the_unguided(cond_unets):
    _, _, (server, *_) = cond_unets
    guided = [r for r in _traffic() if r.sampler.endswith("_g")]
    unguided = [dataclasses.replace(r, sampler=r.sampler[:4])
                for r in guided]
    g = _engine(server).serve(guided, noise=_noise()).summary
    u = _engine(server).serve(unguided, noise=_noise()).summary
    assert g["server_flops"] == 2 * u["server_flops"] > 0
    assert g["client_flops"] == u["client_flops"]
    assert g["images"] == u["images"] == sum(r.batch for r in guided)


def test_guided_window_depth_is_bitwise_invisible(cond_unets, guided_k1):
    _, _, (server, *clients) = cond_unets
    res = _engine(server, k=3).serve(_traffic(), clients, noise=_noise())
    for rid, c1 in guided_k1.completions.items():
        np.testing.assert_array_equal(res.completions[rid].x_mid, c1.x_mid)
        np.testing.assert_array_equal(res.completions[rid].x0, c1.x0)


@pytest.mark.parametrize("backend", ["torch", "cuda_masked"])
def test_w0_twins_serve_bitwise_the_unguided_traffic(cond_unets, backend):
    _, _, (server, *clients) = cond_unets
    plain = [r for r in _traffic() if r.sampler in ("ddpm", "ddim")]
    plain += [dataclasses.replace(r, sampler=r.sampler[:4])
              for r in _traffic() if r.sampler.endswith("_g")]
    twins = [dataclasses.replace(r, sampler=TWINS[r.sampler])
             for r in plain]
    noise = tcf.lane_normal
    a = _engine(server, backend=backend).serve(plain, clients, noise=noise)
    b = _engine(server, backend=backend).serve(twins, clients, noise=noise)
    assert set(a.completions) == set(b.completions)
    for rid, ca in a.completions.items():
        np.testing.assert_array_equal(b.completions[rid].x_mid, ca.x_mid)
        np.testing.assert_array_equal(b.completions[rid].x0, ca.x0)


def test_shadow_lanes_match_primaries_and_are_never_emitted(
        cond_unets, guided_k1, monkeypatch):
    """At every retirement a shadow's x is bitwise its primary's; only
    primary lanes emit rows (one boundary-lag sample an image), and the
    completions equal the fixture's."""
    _, _, (server, *clients) = cond_unets
    eng = _engine(server, backend="cuda_masked")
    shadows, lags = [], []
    retire = eng._retire

    def spy(done_seq, x, start, n_active, inflight, lanes, *rest):
        done = np.nonzero(done_seq.any(axis=0) & lanes.shadow)[0]
        for ln in done.tolist():
            shadows.append(torch.equal(x[ln], x[lanes.pair[ln]]))
        return retire(done_seq, x, start, n_active, inflight, lanes, *rest)
    monkeypatch.setattr(eng, "_retire", spy)
    monkeypatch.setattr(tserve.ServeMetrics, "on_boundary_lag",
                        lambda self, lag: lags.append(lag))
    res = eng.serve(_traffic(), clients, noise=_noise())
    slot_images = sum(r.batch for r in _traffic() if r.cut_ratio < 1.0)
    guided_images = sum(r.batch for r in _traffic()
                        if r.cut_ratio < 1.0 and r.sampler.endswith("_g"))
    assert len(shadows) == guided_images and all(shadows)
    assert len(lags) == slot_images
    for rid, c in guided_k1.completions.items():
        assert res.completions[rid].x_mid.shape[0] == c.request.batch
        np.testing.assert_array_equal(res.completions[rid].x0, c.x0)


def test_mixed_lanes_take_one_step_a_tick(cond_unets, monkeypatch):
    _, _, (server, *_) = cond_unets
    be = tbk.get_backend("cuda_masked")
    calls = []
    step = be.masked_index_step
    monkeypatch.setattr(be, "masked_index_step",
                        lambda *a, **kw: calls.append(1) or step(*a, **kw))
    res = _engine(server, backend="cuda_masked").serve(_traffic(),
                                                      noise=_noise())
    assert len(calls) == res.summary["ticks"]


# ---------------------------------------------------------------------------
# construction errors
# ---------------------------------------------------------------------------
def test_guided_sampler_needs_a_conditional_engine(cond_unets):
    _, tmenu = _menus(["ddpm", "ddpm_g"])
    with pytest.raises(ValueError, match="guided"):
        tserve.EngineConfig(sched=tsch.cosine_schedule(T), image_shape=SHAPE,
                            samplers=tmenu, device="cpu")
    with pytest.raises(ValueError, match="num_classes"):
        tserve.EngineConfig(sched=tsch.cosine_schedule(T), image_shape=SHAPE,
                            device="cpu", num_classes=-1)


def test_admission_policy_for_another_T_is_refused(cond_unets):
    _, _, (server, *_) = cond_unets
    calib = torch.zeros((2,) + SHAPE)
    policy = tserve.AdmissionPolicy(tsch.cosine_schedule(12), calib)
    with pytest.raises(ValueError, match="T=12"):
        _engine(server, admission=policy)
