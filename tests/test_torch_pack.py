"""Wave packing in the port (``pack=True``) against the reference: the
schedulers' picks at every boundary on seeded random streams (FIFO and SJF,
pack on and off, guided samplers and a bumping, rejecting gate), the
reference's packing unit tests and properties, the pack-on engine against
the reference engine (admit and retire ticks, x_mid, fragmentation and
occupancy by class), and pack on ≡ off bitwise in the port with gated and
guided traffic."""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from _torch_parity import (TinyCondEps, TinyEps, np_tree,  # noqa: E402
                           reference_lane_noise, set_torch_cpu,
                           tiny_cond_params, tiny_params, unet_params)
from repro import serve as jserve  # noqa: E402
from repro.configs.base import UNetConfig as JaxUNetConfig  # noqa: E402
from repro.core import privacy as jpriv  # noqa: E402
from repro.diffusion import sampler as jsm  # noqa: E402
from repro.diffusion import schedule as jsch  # noqa: E402
from repro.models import unet as junet  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import collafuse as tcf  # noqa: E402
from repro_torch.data.synthetic import (ClientDataConfig,  # noqa: E402
                                        make_client_datasets)
from repro_torch.diffusion import sampler as tsm  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402
from repro_torch.launch.serve_diffusion import launcher_config  # noqa: E402
from repro_torch.models.unet import UNet, params_from_jax  # noqa: E402

set_torch_cpu()

T = 10
SHAPE = (8, 8, 1)
# the pack-on engine against the reference: the test_torch_serve tolerance
# (f32 on both sides, convolutions summed in another order, and the first
# dense step at T=10 divides by √(1−β_T) ≈ 0.032)
TOL = dict(rtol=0, atol=1e-4)
MENU_ARGS = {"ddpm": ((T,), {}), "ddim": ((T, "ddim", 4, 0.3), {}),
             "ddpm_g": ((T,), {"guidance": 1.5})}


def _menus(names=("ddpm", "ddim", "ddpm_g")):
    return ({n: jsm.make_sampler(*MENU_ARGS[n][0], **MENU_ARGS[n][1])
             for n in names},
            {n: tsm.make_sampler(*MENU_ARGS[n][0], **MENU_ARGS[n][1])
             for n in names})


# ---------------------------------------------------------------------------
# the schedulers, pick for pick
# ---------------------------------------------------------------------------
class _Gate:
    """Admission stub for both packages' schedulers: every 7th request is
    rejected, a request at cut < 0.3 is bumped to a cheaper effective cut,
    the rest are admitted at their nominal cut."""

    def decide(self, req):
        nominal = int(round((1.0 - req.cut_ratio) * T))
        if req.req_id % 7 == 6:
            return types.SimpleNamespace(req_id=req.req_id, served=False,
                                         effective_cut=-1)
        cut = max(1, nominal // 2) if req.cut_ratio < 0.3 else nominal
        return types.SimpleNamespace(req_id=req.req_id, served=True,
                                     effective_cut=cut)


def _stream(seed, n=24):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        smp = ("ddpm", "ddim", "ddpm_g")[rng.integers(3)]
        batch = int(rng.integers(1, 5 if smp == "ddpm_g" else 9))
        out.append(dict(req_id=i, batch=batch,
                        cut_ratio=float(rng.choice([0.0, 0.25, 0.5, 0.75])),
                        arrival_tick=int(rng.integers(0, 20)), sampler=smp))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("policy", ["fifo", "cut_ratio"])
def test_scheduler_picks_match_reference(policy, pack, gated, seed):
    """8 slots, windows of k = 2, each admitted request holding its lanes
    for a duration drawn from its id: at every boundary both schedulers get
    the same free lanes and must pick the same requests; the aging
    promotions and the gate's rejections agree at the end."""
    jmenu, tmenu = _menus()
    gate = _Gate() if gated else None
    ref = jserve.make_scheduler(policy, T, samplers=jmenu, admission=gate,
                                pack=pack)
    port = tserve.make_scheduler(policy, T, samplers=tmenu, admission=gate,
                                 pack=pack)
    for kw in _stream(seed):
        ref.add(jserve.Request(key=None, **kw))
        port.add(tserve.Request(seed=kw["req_id"], **kw))
    S, k, busy, now = 8, 2, [], 0
    while len(ref) or len(port) or busy:
        busy = [(t, n) for t, n in busy if t > now]
        free = S - sum(n for _, n in busy)
        got_ref = ref.select_window(free, now, k)
        got = port.select_window(free, now, k)
        assert [r.req_id for r in got] == [r.req_id for r in got_ref], now
        for r in got:
            assert port.lanes_of(r) == ref.lanes_of(
                next(x for x in got_ref if x.req_id == r.req_id))
            busy.append((now + 2 + (3 * r.req_id) % 9, port.lanes_of(r)))
        now += k
        assert now < 2000
    assert port.aging_promotions == ref.aging_promotions
    assert [d.req_id for d in port.take_rejections()] == \
        [d.req_id for d in ref.take_rejections()]


def _sreq(i, batch, cut, arrival=0):
    return tserve.Request(req_id=i, seed=i, batch=batch, cut_ratio=cut,
                          arrival_tick=arrival)


def test_fifo_pack_waves_backfill_same_class():
    """(the reference's ``tests/test_serve.py`` test of the same name) An
    admitted head's spare budget back-fills with same-class candidates from
    behind a blocked big request, never skipping the head of the order."""
    def load(sch):
        for r in (_sreq(0, 1, 0.5), _sreq(1, 8, 0.25), _sreq(2, 1, 0.5),
                  _sreq(3, 1, 0.25)):
            sch.add(r)
        return sch
    plain = load(tserve.FIFOScheduler())
    assert [r.req_id for r in plain.select(2, now=0)] == [0]
    packed = load(tserve.FIFOScheduler(pack=True))
    assert [r.req_id for r in packed.select(2, now=0)] == [0, 2]
    assert packed.select(4, now=0) == []
    assert [r.req_id for r in packed.select(8, now=0)] == [1]
    assert [r.req_id for r in packed.select(1, now=0)] == [3]


def test_pack_preserves_large_batch_liveness():
    """(the reference's test of the same name) An aged batch-4 head under
    pack=True is not starved by a stream of cheap arrivals."""
    sch = tserve.CutRatioScheduler(T=100, aging=1.0, pack=True)
    sch.add(_sreq(0, 4, 0.0))
    free, admitted_at = 1, None
    for now in range(400):
        sch.add(_sreq(1000 + now, 1, 0.99, arrival=now))
        picked = sch.select(free, now)
        if any(r.req_id == 0 for r in picked):
            admitted_at = now
            break
        free = free - sum(r.batch for r in picked) + 1
    assert admitted_at is not None and admitted_at <= 110


def test_aging_promotions_publish_to_the_registry():
    from repro_torch.obs import MetricsRegistry
    sch = tserve.CutRatioScheduler(T, aging=1.0)
    sch.registry = MetricsRegistry()
    sch.add(_sreq(0, 1, 0.0))
    sch.add(_sreq(1, 1, 0.75, arrival=T))
    assert [r.req_id for r in sch.select(1, T)] == [0]
    snap = sch.registry.snapshot()["serve_aging_promotions_total"]
    assert snap["series"][0]["value"] == sch.aging_promotions == 1


@given(data=st.data())
@settings(max_examples=25, deadline=None)
def test_packed_scheduler_liveness_property(data):
    """(the reference's ``tests/test_properties.py`` property) With one lane
    retiring a tick, every request is admitted within the bound."""
    policy = data.draw(st.sampled_from(["fifo", "cut_ratio"]))
    cap, n = 4, data.draw(st.integers(1, 12))
    sch = tserve.make_scheduler(policy, T, pack=True)
    reqs = [tserve.Request(
        req_id=i, seed=i, batch=data.draw(st.sampled_from([1, 2, 4])),
        cut_ratio=data.draw(st.sampled_from([0.25, 0.5, 0.75])),
        arrival_tick=data.draw(st.integers(0, 8))) for i in range(n)]
    for r in reqs:
        sch.add(r)
    bound = 8 + T + 2 * sum(r.batch for r in reqs) + cap + 4
    occupied, admitted = 0, set()
    for now in range(bound):
        picked = sch.select(cap - occupied, now)
        occupied += sum(r.batch for r in picked)
        admitted.update(r.req_id for r in picked)
        if len(admitted) == n:
            break
        occupied = max(0, occupied - 1)
    assert len(admitted) == n, f"{policy}: starved past {bound} ticks"


# ---------------------------------------------------------------------------
# the engine: pack on against the reference engine
# ---------------------------------------------------------------------------
# (seed, batch, cut_ratio, arrival, sampler): a batch-4 head blocking
# same-class singles behind it, mixed samplers and cuts, staggered arrivals
HET = [(200, 1, 0.5, 0, "ddpm"), (201, 4, 0.25, 0, "ddpm"),
       (202, 1, 0.5, 0, "ddpm"), (203, 1, 0.25, 1, "ddim"),
       (204, 2, 0.5, 1, "ddim"), (205, 1, 0.75, 2, "ddpm"),
       (206, 1, 0.5, 2, "ddpm"), (207, 3, 0.25, 3, "ddim"),
       (208, 1, 0.75, 4, "ddim"), (209, 1, 0.5, 4, "ddpm")]


@pytest.fixture(scope="module")
def unet():
    """The launcher's tiny U-Net, one set of numpy weights for both."""
    port_cfg = launcher_config(SHAPE[0])
    ref_cfg = JaxUNetConfig(**{f.name: getattr(port_cfg, f.name)
                               for f in dataclasses.fields(JaxUNetConfig)})
    params = unet_params(ref_cfg, 0, perturb=False)
    m = UNet(port_cfg)
    m.load_state_dict(params_from_jax(params))
    return ref_cfg, params, m.eval()


def _het_noise():
    _, tmenu = _menus()
    draws = {}
    for seed, b, c, _, smp in HET:
        s = tmenu[smp]
        reference_lane_noise(seed, b, SHAPE, tcf.CutPlan(T, c).cut_index(s),
                             s.K, draws)
    return tcf.InjectedNoise(draws)


def _port_het_engine(server, policy, pack, **kw):
    _, tmenu = _menus(("ddpm", "ddim"))
    return tserve.ServeEngine(tserve.EngineConfig(
        sched=tsch.cosine_schedule(T), image_shape=SHAPE, slots=4,
        scheduler=tserve.make_scheduler(policy, T, samplers=tmenu,
                                        pack=pack),
        step_backend="cuda_masked", samplers=tmenu, ticks_per_dispatch=2,
        device="cpu", **kw), server)


def _het_requests():
    return [tserve.Request(req_id=i, seed=s, batch=b, cut_ratio=c,
                           arrival_tick=a, sampler=smp)
            for i, (s, b, c, a, smp) in enumerate(HET)]


@pytest.mark.parametrize("policy", ["fifo", "cut_ratio"])
def test_pack_engine_matches_reference_engine(unet, policy):
    ref_cfg, params, server = unet
    jmenu, _ = _menus(("ddpm", "ddim"))
    cfg = jserve.EngineConfig(
        sched=jsch.cosine_schedule(T),
        apply_fn=lambda p, x, t: junet.forward(p, x, t, ref_cfg),
        image_shape=SHAPE, slots=4, ticks_per_dispatch=2,
        scheduler=jserve.make_scheduler(policy, T, samplers=jmenu,
                                        pack=True),
        step_backend="jnp", samplers=jmenu)
    reqs = [jserve.Request(req_id=i, key=jax.random.PRNGKey(s), batch=b,
                           cut_ratio=c, arrival_tick=a, sampler=smp)
            for i, (s, b, c, a, smp) in enumerate(HET)]
    ref = jserve.ServeEngine(cfg, params).serve(reqs)
    res = _port_het_engine(server, policy, True).serve(
        _het_requests(), noise=_het_noise())
    assert set(res.completions) == set(ref.completions) == set(range(len(HET)))
    for rid, rc in ref.completions.items():
        pc = res.completions[rid]
        assert (pc.admit_tick, pc.retire_tick) == \
            (int(rc.admit_tick), int(rc.retire_tick)), rid
        np.testing.assert_allclose(pc.x_mid, np.asarray(rc.x_mid), **TOL,
                                   err_msg=f"x_mid req {rid}")
    s, rs = res.summary, ref.summary
    assert s["fragmentation_frac"] == rs["fragmentation_frac"]
    assert s["occupancy_by_class"] == rs["occupancy_by_class"]
    for key in ("ticks", "windows", "utilization_mean", "aging_promotions"):
        assert s[key] == rs[key], key
    if policy == "fifo":
        # packing reordered the admissions against the unpacked run
        plain = _port_het_engine(server, policy, False).serve(
            _het_requests(), noise=_het_noise())
        assert [plain.completions[i].admit_tick for i in range(len(HET))] \
            != [res.completions[i].admit_tick for i in range(len(HET))]


def test_fragmentation_metrics_surface_in_summary(unet):
    """(the reference's test of the same name) Waiting demand behind a
    blocked batch head shows as fragmentation; the occupancy classes carry
    the reference's labels."""
    server = unet[2]
    reqs = [tserve.Request(req_id=0, seed=10, batch=1, cut_ratio=0.25),
            tserve.Request(req_id=1, seed=11, batch=4, cut_ratio=0.5),
            tserve.Request(req_id=2, seed=12, batch=1, cut_ratio=0.75)]
    res = _port_het_engine(server, "fifo", False).serve(reqs)
    assert 0.0 < res.summary["fragmentation_frac"] <= 1.0
    occ = res.summary["occupancy_by_class"]
    assert occ and all(v > 0 for v in occ.values())
    ddpm = _menus(("ddpm",))[1]["ddpm"]
    assert set(occ) == {f"ddpm@{tcf.CutPlan(T, r.cut_ratio).cut_index(ddpm)}@0"
                        for r in reqs}


# ---------------------------------------------------------------------------
# pack on ≡ off in the port, bitwise: gated and guided traffic
# ---------------------------------------------------------------------------
NC = 4
N_CALIB = 8


@pytest.fixture(scope="module")
def cond_world():
    server = TinyCondEps(tiny_cond_params(SHAPE, 7, NC)).eval()
    clients = [TinyCondEps(tiny_cond_params(SHAPE, s, NC)).eval()
               for s in (8, 9)]
    calib = make_client_datasets(ClientDataConfig(
        n_clients=1, per_client=N_CALIB, image_size=SHAPE[0], holdout=2,
        seed=0))[0][0]
    return server, clients, calib, np_tree(jpriv.feature_params())


def _mixed_traffic():
    names = ("ddpm", "ddim", "ddpm_g")
    return [tserve.Request(req_id=i, seed=300 + i,
                           batch=(1, 2, 1, 3)[i % 4] if i % 3 != 2 else 1,
                           cut_ratio=(0.25, 0.5, 0.75)[i % 3],
                           client_idx=i % 2, arrival_tick=i // 3,
                           sampler=names[(i // 2) % 3], label=i % NC)
            for i in range(12)]


def _gate(world, min_kid):
    server, _, calib, feats = world
    _, tmenu = _menus()
    return tserve.AdmissionPolicy(
        tsch.cosine_schedule(T), calib, min_kid=min_kid, samplers=tmenu,
        server_fn=lambda x, t: server(x, t), cond_server_fn=server,
        feat_params=feats)


def _cond_engine(world, pack, gate=None, **kw):
    server = world[0]
    _, tmenu = _menus()
    return tserve.ServeEngine(tserve.EngineConfig(
        sched=tsch.cosine_schedule(T), image_shape=SHAPE, slots=4,
        scheduler=tserve.make_scheduler("cut_ratio", T, samplers=tmenu,
                                        pack=pack),
        step_backend="cuda_masked", samplers=tmenu, ticks_per_dispatch=2,
        async_depth=2, device="cpu", num_classes=NC, admission=gate, **kw),
        server)


def _same_completions(a, b):
    assert set(a.completions) == set(b.completions)
    for rid, ca in a.completions.items():
        np.testing.assert_array_equal(ca.x_mid, b.completions[rid].x_mid)
        np.testing.assert_array_equal(ca.x0, b.completions[rid].x0)


@pytest.mark.parametrize("gated", [False, True])
def test_pack_on_is_bitwise_pack_off(cond_world, gated):
    """Packing moves lanes to other slots beside other neighbours; a lane's
    bits do not depend on its slot, so x_mid and x0 are bitwise the same,
    under a gate that bumps and rejects too."""
    clients = cond_world[1]
    gate = None
    if gated:
        probe = _gate(cond_world, float("-inf"))
        kids = sorted(probe.decide(r).kid for r in _mixed_traffic())
        gate = probe.with_min_kid(kids[len(kids) // 2])
    off = _cond_engine(cond_world, False, gate).serve(_mixed_traffic(),
                                                      clients)
    on = _cond_engine(cond_world, True, gate).serve(_mixed_traffic(),
                                                    clients)
    _same_completions(on, off)
    assert on.decisions == off.decisions
    if gated:
        assert {d.action for d in on.decisions.values()} - {"admit"}
    assert any(on.completions[r].admit_tick != off.completions[r].admit_tick
               for r in on.completions)
    assert set(on.summary["occupancy_by_class"]) == \
        set(off.summary["occupancy_by_class"])
    assert any(c.endswith("@1.5") for c in on.summary["occupancy_by_class"])


_SRV = {}


def _srv_engines():
    if not _SRV:
        server = TinyEps(tiny_params((4, 4, 1), 1, hidden=16)).eval()
        _, tmenu = _menus(("ddpm", "ddim"))
        for pack in (False, True):
            _SRV[pack] = tserve.ServeEngine(tserve.EngineConfig(
                sched=tsch.cosine_schedule(T), image_shape=(4, 4, 1),
                slots=3, ticks_per_dispatch=2, samplers=tmenu,
                scheduler=tserve.FIFOScheduler(pack=pack),
                device="cpu"), server)
    return _SRV[False], _SRV[True]


@given(data=st.data())
@settings(max_examples=10, deadline=None)
def test_packing_never_changes_completions_property(data):
    """(the reference's ``tests/test_properties.py`` property) For random
    request mixes the packed engine completes the same requests with
    bitwise the same tensors."""
    n = data.draw(st.integers(1, 6))
    reqs = [dict(req_id=i, seed=data.draw(st.integers(0, 2 ** 16)),
                 batch=data.draw(st.sampled_from([1, 2, 3])),
                 cut_ratio=data.draw(st.sampled_from([0.25, 0.5, 0.75])),
                 sampler=data.draw(st.sampled_from(["ddpm", "ddim"])),
                 arrival_tick=data.draw(st.integers(0, 3)))
            for i in range(n)]
    plain, packed = _srv_engines()
    a = plain.serve([tserve.Request(**r) for r in reqs])
    b = packed.serve([tserve.Request(**r) for r in reqs])
    assert set(a.completions) == set(b.completions)
    for rid, c in a.completions.items():
        np.testing.assert_array_equal(b.completions[rid].x_mid, c.x_mid)
