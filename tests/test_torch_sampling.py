"""Port parity: the DDPM step functions, ``sample_range``,
``sample_trajectory``, ``split_sample_lane`` and the disclosure functions
against the reference, fed the reference's threefry noise.

Tolerance atol/rtol 1e-5: the ε-model's matmuls sum in another order, and
the strided DDIM chain's first step divides by √ar ≈ 0.01 before the clip."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (TinyEps, reference_chain_noise,  # noqa: E402
                           reference_lane_noise, set_torch_cpu, tiny_apply_jax,
                           tiny_params)
from repro.core import collafuse as jcf  # noqa: E402
from repro.diffusion import ddpm as jddpm  # noqa: E402
from repro.diffusion import sampler as jsm  # noqa: E402
from repro.diffusion import schedule as jsch  # noqa: E402
from repro_torch.core import collafuse as tcf  # noqa: E402
from repro_torch.diffusion import ddpm as tddpm  # noqa: E402
from repro_torch.diffusion import sampler as tsm  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402

set_torch_cpu()

T = 12
SHAPE = (6, 6, 1)
TOL = dict(rtol=1e-5, atol=1e-5)
BACKENDS = ["torch", "triton", "cuda_masked"]     # plain versions on the CPU


@pytest.fixture(scope="module")
def models():
    ps, pc = tiny_params(SHAPE, 0), tiny_params(SHAPE, 1)
    ref = (jax.jit(functools.partial(tiny_apply_jax, ps)),
           jax.jit(functools.partial(tiny_apply_jax, pc)))
    port = (TinyEps(ps).eval(), TinyEps(pc).eval())
    return ref, port


def _samplers(kind):
    if kind == "dense":
        return None, None
    return (jsm.make_sampler(T, "ddim", 4, eta=0.3),
            tsm.make_sampler(T, "ddim", 4, eta=0.3))


def test_q_sample_and_masked_step_match_reference():
    js, ts = jsch.cosine_schedule(T), tsch.cosine_schedule(T)
    rng = np.random.default_rng(0)
    x, eps, z = (rng.standard_normal((5,) + SHAPE).astype(np.float32)
                 for _ in range(3))
    t = np.array([T, 0, 3, -2, 1], np.int32)
    active = np.array([True, False, True, False, True])
    tt = np.clip(t, 1, T)
    np.testing.assert_allclose(
        tddpm.q_sample(ts, torch.from_numpy(x), torch.from_numpy(tt),
                       torch.from_numpy(eps)).numpy(),
        np.asarray(jddpm.q_sample(js, x, tt, eps)), **TOL)
    ref = np.asarray(jddpm.p_sample_masked(js, x, t, eps, z, active))
    for backend in BACKENDS:
        out = tddpm.p_sample_masked(
            ts, torch.from_numpy(x), torch.from_numpy(t),
            torch.from_numpy(eps), torch.from_numpy(z),
            torch.from_numpy(active), backend=backend).numpy()
        np.testing.assert_allclose(out, ref, **TOL, err_msg=backend)
        for ln in (1, 3):
            np.testing.assert_array_equal(out[ln], x[ln])


@functools.lru_cache(maxsize=None)
def _reference_range(t_to):
    """(x_start, reference x after steps T..t_to, its per-step noise)."""
    ps = tiny_params(SHAPE, 0)
    x0 = np.random.default_rng(1).standard_normal((2,) + SHAPE)
    x0 = x0.astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jddpm.sample_range(
        jsch.cosine_schedule(T), functools.partial(tiny_apply_jax, ps), key,
        jnp.asarray(x0), T, t_to))
    return x0, ref, reference_chain_noise(key, T - t_to + 1, x0.shape)


@functools.lru_cache(maxsize=None)
def _reference_trajectory(kind, lo, hi):
    ps = tiny_params(SHAPE, 0)
    args = (T,) if kind == "ddpm" else (T, "ddim", 4, 0.3)
    x0 = np.random.default_rng(2).standard_normal((3,) + SHAPE)
    x0 = x0.astype(np.float32)
    key = jax.random.PRNGKey(6)
    ref = np.asarray(jsm.sample_trajectory(
        jsch.cosine_schedule(T), jsm.make_sampler(*args),
        functools.partial(tiny_apply_jax, ps), key, jnp.asarray(x0), lo, hi))
    return x0, ref, reference_chain_noise(key, hi - lo, x0.shape)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("t_to", [1, 5])
def test_sample_range_matches_reference(models, backend, t_to):
    _, (tfn, _) = models
    x0, ref, chain = _reference_range(t_to)
    out = tddpm.sample_range(tsch.cosine_schedule(T), tfn,
                             lambda pos: torch.tensor(chain[pos]),
                             torch.from_numpy(x0), T, t_to, backend=backend)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind,span", [("ddpm", (0, T)), ("ddpm", (3, 9)),
                                       ("ddim", (0, 4)), ("ddim", (1, 3))])
def test_sample_trajectory_matches_reference(models, backend, kind, span):
    _, (tfn, _) = models
    lo, hi = span
    x0, ref, chain = _reference_trajectory(kind, lo, hi)
    args = (T,) if kind == "ddpm" else (T, "ddim", 4, 0.3)
    out = tsm.sample_trajectory(
        tsch.cosine_schedule(T), tsm.make_sampler(*args), tfn,
        lambda pos: torch.tensor(chain[pos - lo]), torch.from_numpy(x0), lo,
        hi, backend=backend)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("kind", ["dense", "ddim"])
@pytest.mark.parametrize("cut_ratio", [0.0, 0.5, 1.0])
def test_split_sample_lane_matches_reference(models, kind, cut_ratio):
    (jsrv, jcli), (tsrv, tcli) = models
    js, ts = jsch.cosine_schedule(T), tsch.cosine_schedule(T)
    jsmp, tsmp = _samplers(kind)
    seed, image = 11, 1
    jplan, tplan = jcf.CutPlan(T, cut_ratio), tcf.CutPlan(T, cut_ratio)
    walk = tsmp or tsm.make_sampler(T)
    draws = reference_lane_noise(seed, image + 1, SHAPE,
                                 tplan.cut_index(walk), walk.K)
    ref_x0, ref_mid = jcf.split_sample_lane(
        js, jplan, jsrv, jcli,
        jax.random.fold_in(jax.random.PRNGKey(seed), image), SHAPE,
        return_intermediate=True, sampler=jsmp)
    x0, mid = tcf.split_sample_lane(
        ts, tplan, tsrv, tcli, seed, image, SHAPE, return_intermediate=True,
        sampler=tsmp, noise=tcf.InjectedNoise(draws), device="cpu")
    np.testing.assert_allclose(mid.numpy(), np.asarray(ref_mid), **TOL)
    np.testing.assert_allclose(x0.numpy(), np.asarray(ref_x0), **TOL)


def test_split_sample_batch_is_its_lanes(models):
    """Image i of ``split_sample`` draws what lane i draws (under
    ``lane_normal``, the source this check was written for)."""
    _, (tsrv, tcli) = models
    ts = tsch.cosine_schedule(T)
    plan = tcf.CutPlan(T, 0.5)
    x0, mid = tcf.split_sample(ts, plan, tsrv, tcli, 3, (2,) + SHAPE,
                               return_intermediate=True, device="cpu",
                               noise=tcf.lane_normal)
    for i in range(2):
        l0, lmid = tcf.split_sample_lane(ts, plan, tsrv, tcli, 3, i, SHAPE,
                                         return_intermediate=True,
                                         device="cpu", noise=tcf.lane_normal)
        torch.testing.assert_close(mid[i], lmid, **TOL)
        torch.testing.assert_close(x0[i], l0, **TOL)


@pytest.mark.parametrize("pos", [0, 2, 4])
def test_disclosed_at_pos_matches_reference(models, pos):
    (jsrv, _), (tsrv, _) = models
    js, ts = jsch.cosine_schedule(T), tsch.cosine_schedule(T)
    args = (T, "ddim", 4, 0.3)
    jsmp, tsmp = jsm.make_sampler(*args), tsm.make_sampler(*args)
    x0 = np.random.default_rng(4).standard_normal((2,) + SHAPE)
    x0 = x0.astype(np.float32)
    key = jax.random.PRNGKey(8)
    ref = np.asarray(jcf.disclosed_at_pos(js, jsmp, jsrv, key,
                                          jnp.asarray(x0), pos))
    # the reference draws batch-shaped: eps from k_n, the chain from k_s
    k_n, k_s = jax.random.split(key)
    eps = np.asarray(jax.random.normal(k_n, x0.shape))
    chain = reference_chain_noise(k_s, pos, x0.shape)
    draws = {}
    for i in range(2):
        draws[(9, i, "init", 0)] = eps[i]
        for p in range(pos):
            draws[(9, i, "server", p)] = chain[p][i]
    out = tcf.disclosed_at_pos(ts, tsmp, tsrv, 9, torch.from_numpy(x0), pos,
                               noise=tcf.InjectedNoise(draws))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_lane_noise_is_a_function_of_its_key():
    a = tcf.lane_normal(5, 1, "server", 3, SHAPE)
    assert torch.equal(a, tcf.lane_normal(5, 1, "server", 3, SHAPE))
    for other in [(6, 1, "server", 3), (5, 0, "server", 3),
                  (5, 1, "client", 3), (5, 1, "server", 4)]:
        assert not torch.equal(a, tcf.lane_normal(*other, SHAPE))
    with pytest.raises(KeyError):
        tcf.InjectedNoise({})(5, 1, "server", 3, SHAPE)
