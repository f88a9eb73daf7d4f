"""Port parity for KID-gated admission: scores and decisions against the
reference ``AdmissionPolicy`` (same weights, calibration set, feature
weights and draws); inside the port, the one-pass scores bitwise equal to
from-scratch ``disclosed_at_pos``, O(menu × cuts) scoring, the shared cache,
weight swaps and menu changes, the scheduler's gate and its SJF costs, the
gated engine (gate off ≡ clearing gate, served KIDs above the floor, bumps
as ungated serves at the effective cut, all rejected), the summary, and the
launcher.

Tolerances, each beside its assert:
* SCORE_TOL, rtol 1e-4 against the reference: the disclosed x differs by
  up to 1.5e-5 across frameworks here (the tiny model's matmuls summed in
  another order, then the guided combine and the first step's ×31), the
  features by ~1e-7 relative on equal images (``test_torch_privacy.py``),
  and a KID of ~0.15 is a difference of kernel means near 1, so an absolute
  gap of ~1e-7 to 1e-6 in the means is ~1e-6 to 1e-5 of the score;
  measured up to 7.0e-6 relative (2.4e-7 absolute), 14× inside.
* Decisions are held equal only at floors halfway between adjacent distinct
  reference scores whose gap is at least 10 × SCORE_TOL of the score.
* Everything inside the port is bitwise.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (TinyCondEps, np_tree,  # noqa: E402
                           reference_disclosure_noise, set_torch_cpu,
                           tiny_cond_apply_jax, tiny_cond_params)
from repro import serve as jserve  # noqa: E402
from repro.core import privacy as jpriv  # noqa: E402
from repro.diffusion import sampler as jsm  # noqa: E402
from repro.diffusion import schedule as jsch  # noqa: E402
from repro_torch.core import collafuse as tcf  # noqa: E402
from repro_torch.core import privacy as tpriv  # noqa: E402
from repro_torch.data.synthetic import (ClientDataConfig,  # noqa: E402
                                        make_client_datasets)
from repro_torch.diffusion import sampler as tsm  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.serve import admission as tadm  # noqa: E402

set_torch_cpu()

REPO = Path(__file__).resolve().parents[1]
T = 10
SHAPE = (8, 8, 1)
NC = 4
N_CALIB = 4
SCORE_TOL = 1e-4
MENU_ARGS = {"ddpm": ((T,), {}), "ddim": ((T, "ddim", 4, 0.0), {}),
             "ddpm_g": ((T,), {"guidance": 1.5}),
             "ddim_g": ((T, "ddim", 4, 0.0), {"guidance": 2.0}),
             "ddpm_g0": ((T,), {"guidance": 0.0})}
# the reference positions scored (each is one compiled program there)
REF_POS = {"ddpm": 6, "ddpm_g": 3}


def _menus():
    return ({n: jsm.make_sampler(*a, **kw) for n, (a, kw) in
             MENU_ARGS.items()},
            {n: tsm.make_sampler(*a, **kw) for n, (a, kw) in
             MENU_ARGS.items()})


@pytest.fixture(scope="module")
def world():
    p = tiny_cond_params(SHAPE, 7, NC)
    clients = [TinyCondEps(tiny_cond_params(SHAPE, s, NC)).eval()
               for s in (8, 9)]
    calib = make_client_datasets(ClientDataConfig(
        n_clients=1, per_client=N_CALIB, image_size=SHAPE[0], holdout=2,
        seed=0))[0][0]
    return p, TinyCondEps(p).eval(), clients, calib, \
        np_tree(jpriv.feature_params())


def _uncond(model):
    return lambda x, t: model(x, t)


def _policy(world, min_kid=float("-inf"), noise=None, **kw):
    _, server, _, calib, feats = world
    _, tmenu = _menus()
    return tserve.AdmissionPolicy(
        tsch.cosine_schedule(T), calib, min_kid=min_kid, samplers=tmenu,
        server_fn=_uncond(server), cond_server_fn=server, feat_params=feats,
        noise=noise, **kw)


@pytest.fixture(scope="module")
def ref_policy(world):
    p, _, _, calib, feats = world
    jmenu, _ = _menus()
    pol = jserve.AdmissionPolicy(
        jsch.cosine_schedule(T), calib.numpy(), min_kid=float("-inf"),
        samplers=jmenu, server_fn=functools.partial(tiny_cond_apply_jax, p),
        cond_server_fn=lambda x, t, y: tiny_cond_apply_jax(p, x, t, y),
        feat_params=feats)
    scores = {n: pol.profile(n, hi) for n, hi in REF_POS.items()}
    return pol, scores


@pytest.fixture(scope="module")
def injected(world):
    """A port policy on the reference's calibration draws."""
    draws = reference_disclosure_noise(jax.random.PRNGKey(4242),
                                       tadm.CALIB_SEED, (N_CALIB,) + SHAPE,
                                       T)
    return _policy(world, noise=tcf.InjectedNoise(draws))


# ---------------------------------------------------------------------------
# scores and decisions against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(REF_POS))
def test_scores_match_reference(ref_policy, injected, name):
    _, scores = ref_policy
    port = injected.profile(name, REF_POS[name])
    np.testing.assert_allclose(port, scores[name], rtol=SCORE_TOL, atol=0)


def _midpoint_floors(scores):
    s = sorted(set(scores))
    return [0.5 * (a + b) for a, b in zip(s, s[1:])
            if b - a >= 10 * SCORE_TOL * abs(b)]


@pytest.mark.parametrize("name,cut", [("ddpm", 0.5), ("ddpm", 0.6),
                                      ("ddpm_g", 0.8)])
def test_decisions_match_reference_at_midpoint_floors(ref_policy, injected,
                                                      name, cut):
    pol, scores = ref_policy
    floors = _midpoint_floors(scores[name])
    actions = set()
    for floor in floors:
        want = pol.with_min_kid(floor)._decide(name, cut)
        got = injected.with_min_kid(floor)._decide(name, cut)
        assert (got.action, got.nominal_cut, got.effective_cut) == \
            (want.action, want.nominal_cut, want.effective_cut), floor
        np.testing.assert_allclose(got.kid, want.kid, rtol=SCORE_TOL)
        actions.add(got.action)
    assert actions >= {"admit", "reject"}
    if (name, cut) == ("ddpm", 0.5):
        assert "bump" in actions


# ---------------------------------------------------------------------------
# the port's own scoring
# ---------------------------------------------------------------------------
def test_one_pass_scores_are_bitwise_from_scratch(world):
    _, server, _, calib, feats = world
    _, tmenu = _menus()
    pol = _policy(world)
    sched = tsch.cosine_schedule(T)
    calib_f = tpriv.extract_features(feats, calib)
    for name, smp in tmenu.items():
        prof = pol.profile(name)
        cond = server if smp.guided else None
        for pos in range(smp.K + 1):
            x = tcf.disclosed_at_pos(sched, smp, _uncond(server),
                                     tadm.CALIB_SEED, calib, pos,
                                     cond_fn=cond, label=0)
            kid = float(tpriv.kid_from_features(
                calib_f, tpriv.extract_features(feats, x)))
            assert prof[pos] == kid, (name, pos)
    # w = 0 walks the unguided chain: the same landscape, bit for bit
    assert pol.profile("ddpm_g0") == pol.profile("ddpm")


def test_scoring_runs_one_chain_per_sampler(world):
    """O(menu × cuts): however many requests, each sampler's chain runs once
    to its deepest nominal cut (2 calls a step when guided)."""
    pol = _policy(world)
    _, tmenu = _menus()
    cuts = (0.75, 0.25, 0.5)
    reqs = [tserve.Request(req_id=i, seed=i, cut_ratio=c, sampler=n)
            for i, (n, c) in enumerate(
                [(n, c) for _ in range(3) for n in tmenu for c in cuts])]
    for r in reqs:
        pol.decide(r)
    deepest = {n: max(tcf.CutPlan(T, c).cut_index(s) for c in cuts)
               for n, s in tmenu.items()}
    want = sum(d * (2 if tmenu[n].guided and tmenu[n].w else 1)
               for n, d in deepest.items())
    assert pol.model_calls == want
    for r in reqs:
        pol.decide(r)
    assert pol.model_calls == want                  # all cached now


def test_with_min_kid_shares_the_score_cache(world):
    pol = _policy(world)
    low = pol.with_min_kid(float("-inf"))
    d_low = low._decide("ddpm", 0.5)
    calls = low.model_calls
    assert calls > 0 and pol.model_calls == 0
    high = pol.with_min_kid(d_low.kid + 1.0)
    assert high._decide("ddpm", 0.5).action == "reject"
    assert high.model_calls == 0 and pol.model_calls == 0
    assert pol.disclosure_kid("ddpm", 5) == d_low.kid


def test_rebinding_other_weights_bumps_the_version(world):
    _, server, _, _, _ = world
    pol = _policy(world)
    before = pol.disclosure_kid("ddpm_g", 3)
    same = TinyCondEps(tiny_cond_params(SHAPE, 7, NC)).eval()
    pol.bind(server_fn=_uncond(same), cond_server_fn=same)
    assert pol.params_version == 0 and pol.disclosure_kid("ddpm_g", 3) \
        == before
    other = TinyCondEps(tiny_cond_params(SHAPE, 17, NC)).eval()
    clone = pol.with_min_kid(0.0)
    pol.bind(server_fn=_uncond(other))
    assert pol.params_version == 1 and not pol._kid_cache
    assert not clone._kid_cache                     # cleared in place
    pol.bind(cond_server_fn=other)
    assert pol.params_version == 2
    assert pol.disclosure_kid("ddpm_g", 3) != before
    # a conditional model bound after guided scores were cached re-scores
    late = _policy(world)
    late.cond_server_fn = None
    late.disclosure_kid("ddpm_g", 2)
    late.bind(cond_server_fn=server)
    assert late.params_version == 1


def test_register_and_unregister_invalidate_in_place(world):
    pol = _policy(world)
    clone = pol.with_min_kid(0.0)
    pol.profile("ddim", 2)
    pol.profile("ddpm", 2)
    pol.register_sampler("ddim", tsm.make_sampler(T, "ddim", 5, 0.0))
    assert not any(k[0] == "ddim" for k in clone._kid_cache)
    assert any(k[0] == "ddpm" for k in clone._kid_cache)
    assert len(pol.profile("ddim")) == 6
    pol.unregister_sampler("ddim")
    assert not any(k[0] == "ddim" for k in pol._kid_cache)
    with pytest.raises(KeyError, match="unknown sampler"):
        pol.disclosure_kid("ddim", 1)


def test_calibration_of_fewer_than_two_images_raises(world):
    with pytest.raises(ValueError, match=">= 2"):
        tserve.AdmissionPolicy(tsch.cosine_schedule(T),
                               torch.zeros((1,) + SHAPE))


def test_admission_summary_matches_reference(world):
    pol = _policy(world)
    kid = pol._decide("ddpm", 0.5).kid
    gate = pol.with_min_kid(kid)
    ds = [dataclasses.replace(gate._decide(n, c), req_id=i)
          for i, (n, c) in enumerate([("ddpm", 0.5), ("ddpm", 0.25),
                                      ("ddim", 0.5), ("ddpm_g", 0.3)])]
    as_ref = [jserve.AdmissionDecision(**dataclasses.asdict(d)) for d in ds]
    assert tserve.admission_summary(ds) == jserve.admission_summary(as_ref)
    rejects = [d for d in ds if not d.served] or [dataclasses.replace(
        ds[0], action="reject", effective_cut=-1)]
    got = tserve.admission_summary(rejects)
    assert "disclosure_kid" not in got
    assert got == jserve.admission_summary(
        [jserve.AdmissionDecision(**dataclasses.asdict(d)) for d in rejects])


# ---------------------------------------------------------------------------
# the scheduler's gate
# ---------------------------------------------------------------------------
class _Gate:
    """A stand-in policy: fixed (action, effective cut) per request id."""

    def __init__(self, table):
        self.table = table

    def decide(self, req):
        action, cut = self.table.get(req.req_id, ("admit", None))
        return tserve.AdmissionDecision(
            req_id=req.req_id, sampler=req.sampler, cut_ratio=req.cut_ratio,
            nominal_cut=-1, effective_cut=-1 if cut is None else cut,
            kid=0.0, min_kid=0.0, action=action)


def _sreq(i, c, batch=1, sampler="ddpm", arrival=0):
    return tserve.Request(req_id=i, seed=i, batch=batch, cut_ratio=c,
                          sampler=sampler, arrival_tick=arrival)


def test_select_gate_drops_rejected_without_blocking():
    sch = tserve.FIFOScheduler(admission=_Gate({0: ("reject", None)}))
    for r in (_sreq(0, 0.5, batch=3), _sreq(1, 0.5), _sreq(2, 0.5)):
        sch.add(r)
    # the rejected head needs 3 lanes: it would block FIFO, but it leaves
    assert [r.req_id for r in sch.select(2, 0)] == [1, 2]
    assert len(sch) == 0
    assert [d.req_id for d in sch.take_rejections()] == [0]
    assert sch.take_rejections() == []


def test_sjf_orders_by_nominal_cost_and_prices_the_effective_cut():
    _, tmenu = _menus()
    # request 0 asks for 8 server steps and is bumped to 1; request 1 asks
    # for 3: the bump must not improve request 0's place
    gate = _Gate({0: ("bump", 1), 1: ("admit", 3), 2: ("admit", 3),
                  4: ("admit", 5)})
    sch = tserve.CutRatioScheduler(T, samplers=tmenu, admission=gate)
    r0, r1 = _sreq(0, 0.2), _sreq(1, 0.7)
    r2 = _sreq(2, 0.7, sampler="ddpm_g")
    assert sch.nominal_cost(r0) == 8 and sch.server_cost(r0) == 1
    assert sch.nominal_cost(r2) == 6 and sch.lanes_of(r2) == 2
    for r in (r0, r1, r2):
        sch.add(r)
    assert [r.req_id for r in sch.select(1, 0)] == [1]
    assert [r.req_id for r in sch.select(3, 0)] == [2, 0]
    # request 0 aged to the head; it costs 1 server step (bumped), not 8,
    # so taking it before request 4 (5 steps) is no aging promotion
    sch2 = tserve.CutRatioScheduler(T, samplers=tmenu, admission=gate)
    sch2.add(r0)
    sch2.add(_sreq(4, 0.5, arrival=T))
    assert [r.req_id for r in sch2.select(1, T)] == [0]
    assert sch2.aging_promotions == 0


# ---------------------------------------------------------------------------
# the gated engine
# ---------------------------------------------------------------------------
TRAFFIC = [(300, 1, 0.5, 0, 0, "ddpm", 1), (301, 2, 0.6, 1, 0, "ddpm_g", 2),
           (302, 1, 0.5, 1, 1, "ddim", 0), (303, 1, 0.25, 0, 2, "ddim_g", 3),
           (304, 2, 0.8, 0, 2, "ddpm", 0), (305, 1, 1.0, 1, 3, "ddpm_g", 1)]


def _traffic():
    return [tserve.Request(req_id=i, seed=s, batch=b, cut_ratio=c,
                           client_idx=ci, arrival_tick=a, sampler=smp,
                           label=y)
            for i, (s, b, c, ci, a, smp, y) in enumerate(TRAFFIC)]


def _engine(world, admission=None, k=1):
    _, server, _, _, _ = world
    _, tmenu = _menus()
    cfg = tserve.EngineConfig(
        sched=tsch.cosine_schedule(T), image_shape=SHAPE, slots=6,
        scheduler=tserve.make_scheduler("cut_ratio", T, samplers=tmenu),
        step_backend="cuda_masked", samplers=tmenu, ticks_per_dispatch=k,
        device="cpu", num_classes=NC, admission=admission)
    return tserve.ServeEngine(cfg, server)


def _same(a, b):
    assert set(a.completions) == set(b.completions)
    for rid, ca in a.completions.items():
        cb = b.completions[rid]
        assert (ca.admit_tick, ca.retire_tick) == (cb.admit_tick,
                                                   cb.retire_tick)
        np.testing.assert_array_equal(ca.x_mid, cb.x_mid)
        np.testing.assert_array_equal(ca.x0, cb.x0)


@pytest.fixture(scope="module")
def gate_off(world):
    return _engine(world).serve(_traffic(), world[2])


def test_clearing_gate_is_bitwise_gate_off(world, gate_off):
    res = _engine(world, _policy(world)).serve(_traffic(), world[2])
    _same(res, gate_off)
    assert gate_off.decisions == {} and "admission" not in gate_off.summary
    assert all(d.action == "admit" for d in res.decisions.values())
    assert res.summary["admission"]["admitted"] == len(TRAFFIC)
    for key in ("server_flops", "client_flops", "ticks", "images"):
        assert res.summary[key] == gate_off.summary[key]


@pytest.fixture(scope="module")
def landscape(world):
    """A shared probe and a floor at which a request bumps: halfway between
    the first request's nominal score that lies below a noisier position's
    and the best of those."""
    probe = _policy(world)
    for r in _traffic():
        d = probe.decide(r)
        prof = [probe.disclosure_kid(r.sampler, p)
                for p in range(d.nominal_cut + 1)]
        if max(prof) > prof[-1]:
            return probe, 0.5 * (prof[-1] + max(prof))
    raise AssertionError("no request of the traffic can bump")


def test_gated_engine_serves_only_above_the_floor(world, landscape):
    probe, floor = landscape
    gate = probe.with_min_kid(floor)
    res = _engine(world, gate).serve(_traffic(), world[2])
    assert set(res.decisions) == set(range(len(TRAFFIC)))
    actions = [d.action for d in res.decisions.values()]
    assert "bump" in actions
    for rid, d in res.decisions.items():
        if d.served:
            assert d.kid >= floor and rid in res.completions
            assert d.kid == probe.disclosure_kid(d.sampler, d.effective_cut)
    assert res.summary["admission"]["bumped"] == actions.count("bump")
    # a fresh policy and k = 3: the same decisions and completions
    fresh = _policy(world, min_kid=floor)
    res2 = _engine(world, fresh, k=3).serve(_traffic(), world[2])
    assert res2.decisions == res.decisions
    assert set(res2.completions) == set(res.completions)
    for rid, c in res.completions.items():
        np.testing.assert_array_equal(res2.completions[rid].x_mid, c.x_mid)
        np.testing.assert_array_equal(res2.completions[rid].x0, c.x0)


def test_bumped_request_is_the_ungated_one_at_its_effective_cut(
        world, landscape):
    probe, floor = landscape
    gate = probe.with_min_kid(floor)
    _, tmenu = _menus()
    bumped = [r for r in _traffic() if gate.decide(r).bumped]
    assert bumped
    for r in bumped:
        d = gate.decide(r)
        got = _engine(world, gate).serve([r], world[2]).completions[r.req_id]
        # the cut ratio whose nominal position is the effective cut
        c = next(c / 100 for c in range(101)
                 if tcf.CutPlan(T, c / 100).cut_index(tmenu[r.sampler])
                 == d.effective_cut)
        want = _engine(world).serve([dataclasses.replace(r, cut_ratio=c)],
                                    world[2]).completions[r.req_id]
        np.testing.assert_array_equal(got.x_mid, want.x_mid)
        np.testing.assert_array_equal(got.x0, want.x0)


def test_all_rejected_empties_the_engine(world, landscape):
    probe, _ = landscape
    top = max(probe._kid_cache.values())
    res = _engine(world, probe.with_min_kid(top + 1.0)).serve(_traffic(),
                                                             world[2])
    assert res.completions == {} and res.summary["ticks"] == 0
    assert set(res.rejected) == set(range(len(TRAFFIC)))
    assert res.summary["served"] == 0 and res.summary["server_flops"] == 0
    assert "disclosure_kid" not in res.summary["admission"]


def test_engine_refuses_a_calibration_set_elsewhere(world):
    pol = _policy(world)
    pol.calib = pol.calib.to("meta")
    with pytest.raises(ValueError, match="calibration"):
        _engine(world, pol)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
def test_launcher_guided_and_gated_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_diffusion",
         "--device", "cpu", "--config", "launcher", "--T", "10",
         "--requests", "6", "--slots", "4", "--clients", "2",
         "--num-classes", "4", "--guidance", "1.5", "--min-kid", "0.15",
         "--calib", "4", "--mix"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert out.strip().splitlines()[-1] == "serve_diffusion OK"
    line = next(ln for ln in out.splitlines()
                if ln.startswith("admission (min_kid=0.15)"))
    n = [int(w) for w in line.replace(",", "").split()
         if w.isdigit()][:3]
    assert sum(n) == 6, line
