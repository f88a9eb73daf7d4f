"""The port's observability (``repro_torch.obs``): the tracer, registry,
timeline and facade units of the reference's ``tests/test_obs.py``, JSON-lines
that each package's reader parses from the other, and obs threaded through
the engine, the gate, the trainer and both launchers — obs off ≡ obs on
bitwise, one ``dispatch`` span a window, lifecycles in stage order with the
reference's exact retire ticks, snapshots at window boundaries."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (TinyEps, set_torch_cpu, tiny_apply_jax,  # noqa
                           tiny_params)
from repro import obs as jobs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.diffusion import schedule as jsch  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import trainer as ttr  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402
from repro_torch.launch.serve_diffusion import launcher_config  # noqa: E402
from repro_torch.models.unet import UNet  # noqa: E402
from repro_torch.obs import (DEFAULT_BUCKETS, NULL_OBS,  # noqa: E402
                             NULL_REGISTRY, NULL_TRACER, MetricsRegistry,
                             NullTracer, Observability, ObsConfig,
                             TimelineRecorder, Tracer, load_trace,
                             merge_traces, read_jsonl, resolve_obs,
                             validate_events)
from repro_torch.serve.admission import AdmissionDecision  # noqa: E402
from repro_torch.serve.metrics import admission_summary  # noqa: E402

set_torch_cpu()

REPO = Path(__file__).resolve().parents[1]
T = 10
SHAPE = (6, 6, 1)


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------
class TestTracer:
    def test_span_records_complete_event(self):
        tr = Tracer()
        with tr.span("work", cat="test", n=3):
            pass
        evs = [e for e in tr.events() if e["ph"] == "X"]
        assert len(evs) == 1
        e = evs[0]
        assert e["name"] == "work" and e["cat"] == "test"
        assert e["dur"] >= 0 and e["args"]["n"] == 3
        validate_events(tr.events())

    def test_decorator_and_instant_and_counter(self):
        tr = Tracer()

        @tr.trace("fn")
        def fn(x):
            return x + 1

        assert fn(1) == 2
        tr.instant("mark", detail="x")
        tr.counter("occupancy", lanes=4, queued=2)
        assert {"X", "i", "C"} <= {e["ph"] for e in tr.events()}
        validate_events(tr.events())

    def test_async_track_and_export_roundtrip(self, tmp_path):
        tr = Tracer(pid=3, process_name="hostA")
        tr.async_begin("req0", id=0)
        tr.async_instant("req0", id=0, stage="scored")
        tr.async_end("req0", id=0)
        p = tmp_path / "t.json"
        tr.export(str(p))
        evs = load_trace(str(p))
        assert validate_events(evs) == len(evs)
        assert all(e["pid"] == 3 for e in evs)
        assert [e["ph"] for e in evs if e["ph"] in "bie"] == ["b", "i", "e"]
        assert "traceEvents" in json.loads(p.read_text())

    def test_clear_keeps_process_metadata(self):
        tr = Tracer(process_name="svc")
        with tr.span("x"):
            pass
        tr.clear()
        assert all(e["ph"] == "M" for e in tr.events())
        assert len(tr.events()) == 2

    def test_merge_traces_unions_pids(self, tmp_path):
        paths = []
        for pid in (0, 1):
            tr = Tracer(pid=pid, process_name=f"host{pid}")
            with tr.span("dispatch", host=pid):
                pass
            paths.append(str(tmp_path / f"trace.host{pid}"))
            tr.export(paths[-1])
        out = tmp_path / "merged.json"
        n = merge_traces(paths, str(out))
        merged = load_trace(str(out))
        assert validate_events(merged) == len(merged) == n
        assert {e["pid"] for e in merged} == {0, 1}

    def test_validate_rejects_malformed(self):
        with pytest.raises(AssertionError):
            validate_events([{"name": "x", "ph": "Z", "pid": 0, "tid": 0,
                              "ts": 0.0}])
        with pytest.raises(AssertionError):
            validate_events([{"ph": "i", "pid": 0, "tid": 0, "ts": 0.0}])

    def test_null_tracer_is_free_and_falsy(self):
        assert not NULL_TRACER and isinstance(NULL_TRACER, NullTracer)
        s1 = NULL_TRACER.span("a", big=list(range(10)))
        assert s1 is NULL_TRACER.span("b")     # one shared no-op manager
        with s1:
            pass
        NULL_TRACER.instant("x")
        NULL_TRACER.async_begin("y", id=0)
        NULL_TRACER.clear()
        assert NULL_TRACER.events() == []


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
class TestRegistry:
    def test_counter_monotone(self):
        reg = MetricsRegistry()
        c = reg.counter("jobs_total", "jobs")
        c.inc()
        c.inc(4)
        with pytest.raises(AssertionError):
            c.inc(-1)
        snap = reg.snapshot()
        assert snap["jobs_total"]["kind"] == "counter"
        assert snap["jobs_total"]["series"][0]["value"] == 5

    def test_labels_and_reregistration_checks(self):
        reg = MetricsRegistry()
        c = reg.counter("actions_total", "acts", labels=("action",))
        c.labels(action="admit").inc(2)
        c.labels(action="bump").inc()
        assert reg.counter("actions_total", "acts",
                           labels=("action",)) is c
        with pytest.raises(AssertionError):
            reg.gauge("actions_total", "wrong kind")
        series = {s["labels"]["action"]: s["value"]
                  for s in reg.snapshot()["actions_total"]["series"]}
        assert series == {"admit": 2, "bump": 1}

    def test_histogram_buckets_cumulative(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat", "latency", buckets=(1, 5, 10))
        for v in (0.5, 3, 7, 100):
            h.observe(v)
        s = reg.snapshot()["lat"]["series"][0]["value"]
        assert s["buckets"] == [1.0, 5.0, 10.0]
        assert s["counts"] == [1, 1, 1, 1]      # per bin + the +inf tail
        assert s["count"] == 4 and s["sum"] == pytest.approx(110.5)
        assert DEFAULT_BUCKETS == tuple(sorted(DEFAULT_BUCKETS))

    def test_jsonl_roundtrip(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("ticks_total", "ticks").inc(8)
        p = tmp_path / "m.jsonl"
        reg.write_jsonl(str(p), host=0, window=1)
        reg.counter("ticks_total", "ticks").inc(8)
        reg.write_jsonl(str(p), host=0, window=2, final=True)
        lines = read_jsonl(str(p))
        assert len(lines) == 2 and lines[-1]["final"]
        assert lines[0]["metrics"]["ticks_total"]["series"][0]["value"] == 8
        assert lines[1]["metrics"]["ticks_total"]["series"][0]["value"] == 16
        assert all("ts" in ln for ln in lines)

    def test_null_registry_free_and_falsy(self):
        assert not NULL_REGISTRY
        c = NULL_REGISTRY.counter("x", "y")
        c.inc(5)
        NULL_REGISTRY.histogram("h", "z").observe(1)
        assert NULL_REGISTRY.gauge("g", "w") is c   # one shared no-op
        assert NULL_REGISTRY.snapshot() == {}


def _fill(registry_cls):
    reg = registry_cls()
    reg.counter("serve_windows_total", "windows").inc(3)
    reg.gauge("serve_queue_depth", "queued").set(2)
    reg.histogram("serve_latency_ticks", "lat").observe(7)
    reg.counter("serve_admission_actions_total", "acts",
                labels=("action",)).labels(action="bump").inc()
    return reg


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_jsonl_parses_with_the_other_packages_reader(tmp_path, writer):
    """One schema: a snapshot line either package writes parses with the
    other's reader into the same snapshot."""
    p = tmp_path / "m.jsonl"
    ours, theirs = _fill(MetricsRegistry), _fill(jobs.MetricsRegistry)
    src, reader = (ours, jobs.read_jsonl) if writer == "port" \
        else (theirs, read_jsonl)
    src.write_jsonl(str(p), host=0, window=4, final=True)
    (line,) = reader(str(p))
    assert line["host"] == 0 and line["window"] == 4 and line["final"]
    assert line["metrics"] == ours.snapshot() == theirs.snapshot()


# ---------------------------------------------------------------------------
# timelines and the facade
# ---------------------------------------------------------------------------
class TestTimelines:
    def test_stage_order_and_details(self):
        tl = TimelineRecorder()
        tl.record(0, "queued", tick=0, batch=2)
        tl.record(0, "admitted", tick=1)
        tl.record(0, "retired", tick=8, exact_tick=6)
        assert tl.stages_of(0) == ["queued", "admitted", "retired"]
        assert tl.of(0)[0]["batch"] == 2
        assert tl.of(0)[-1]["exact_tick"] == 6
        assert all("wall" in e for e in tl.of(0))

    def test_stage_never_twice_and_unknown_rejected(self):
        tl = TimelineRecorder()
        tl.record(1, "queued")
        with pytest.raises(AssertionError):
            tl.record(1, "queued")
        with pytest.raises(AssertionError):
            tl.record(1, "warp")

    def test_reset_allows_reused_req_ids(self):
        tl = TimelineRecorder()
        tl.record(0, "queued")
        tl.reset()
        tl.record(0, "queued")
        assert set(tl.snapshot()) == {0}

    def test_mirrors_async_events_onto_tracer(self):
        tr = Tracer()
        tl = TimelineRecorder(tracer=tr)
        tl.record(0, "queued")
        tl.record(0, "first_tick", tick=3)
        tl.record(0, "retired", tick=5)
        tl.record(0, "client_finished")
        assert [e["ph"] for e in tr.events() if e["ph"] in "bie"] == \
            ["b", "i", "e", "i"]
        validate_events(tr.events())


class TestObservability:
    def test_resolve_and_truthiness(self):
        assert resolve_obs(None) is NULL_OBS and not NULL_OBS
        obs = resolve_obs(ObsConfig())
        assert isinstance(obs, Observability) and obs
        assert resolve_obs(obs) is obs
        with pytest.raises(TypeError):
            resolve_obs("yes please")

    def test_null_obs_surface(self):
        NULL_OBS.request(0, "queued", tick=0)
        assert NULL_OBS.tracer is NULL_TRACER
        assert NULL_OBS.registry is NULL_REGISTRY
        assert NULL_OBS.trace_path_for_host(2) is None
        assert NULL_OBS.window_profiler(torch.device("cpu")) is None

    def test_per_host_trace_paths(self, tmp_path):
        p = str(tmp_path / "trace.json")
        solo = Observability(ObsConfig(trace_path=p))
        assert solo.trace_path_for_host(1) == p
        pod = Observability(ObsConfig(trace_path=p), host_id=1)
        assert pod.trace_path_for_host(2) == p + ".host1"
        assert pod.tracer.events()[0]["pid"] == 1

    def test_config_validation(self):
        with pytest.raises(AssertionError):
            ObsConfig(metrics_every=0)
        with pytest.raises(AssertionError):
            ObsConfig(profile_windows=0)
        with pytest.raises(TypeError):
            tserve.EngineConfig(sched=tsch.cosine_schedule(T),
                                image_shape=SHAPE, device="cpu", obs="on")


def test_admission_summary_publishes_action_counters():
    reg = MetricsRegistry()
    ds = [AdmissionDecision(req_id=0, sampler="ddpm", cut_ratio=0.5,
                            nominal_cut=5, effective_cut=5, kid=1.0,
                            min_kid=0.5, action="admit"),
          AdmissionDecision(req_id=1, sampler="ddpm", cut_ratio=0.5,
                            nominal_cut=5, effective_cut=3, kid=0.9,
                            min_kid=0.5, action="bump")]
    rec = admission_summary(ds, registry=reg)
    assert rec["admitted"] == 1 and rec["bumped"] == 1
    series = reg.snapshot()["serve_admission_actions_total"]["series"]
    assert {s["labels"]["action"]: s["value"] for s in series} == \
        {"admit": 1, "bump": 1, "reject": 0}


def test_exact_occupancy_publishes_trailing_active_gauge():
    reg = MetricsRegistry()
    m = tserve.ServeMetrics(capacity=4, registry=reg)
    m.on_window_exact(4, [0, 1, 0, 1])
    snap = reg.snapshot()
    assert snap["serve_active_lanes"]["series"][0]["value"] == 2
    assert snap["serve_ticks_total"]["series"][0]["value"] == 4


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    server = TinyEps(tiny_params(SHAPE, 0)).eval()
    clients = [TinyEps(tiny_params(SHAPE, s)).eval() for s in (1, 2)]
    return server, clients


def _requests(n):
    return [tserve.Request(req_id=i, seed=700 + i, batch=1 + i % 2,
                           cut_ratio=(0.25, 0.5, 0.75)[i % 3],
                           client_idx=i % 2, arrival_tick=i % 3)
            for i in range(n)]


def _engine(server, obs, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("ticks_per_dispatch", 3)
    kw.setdefault("async_depth", 2)
    return tserve.ServeEngine(tserve.EngineConfig(
        sched=tsch.cosine_schedule(T), image_shape=SHAPE,
        step_backend="cuda_masked", device="cpu", obs=obs, **kw), server)


def _bitwise(a, b):
    assert set(a.completions) == set(b.completions)
    for rid, ca in a.completions.items():
        np.testing.assert_array_equal(ca.x_mid, b.completions[rid].x_mid)
        if ca.x0 is not None or b.completions[rid].x0 is not None:
            np.testing.assert_array_equal(ca.x0, b.completions[rid].x0)


@pytest.mark.parametrize("mode", ["stream", "drain"])
def test_obs_off_matches_obs_on_bitwise(models, tmp_path, mode):
    server, clients = models
    off_eng = _engine(server, None, finish_mode=mode)
    res_off = off_eng.serve(_requests(8), clients)
    on_eng = _engine(server, ObsConfig(
        trace_path=str(tmp_path / "trace.json"),
        metrics_path=str(tmp_path / "m.jsonl"), metrics_every=2),
        finish_mode=mode)
    res_on = on_eng.serve(_requests(8), clients)
    _bitwise(res_on, res_off)
    for key in ("ticks", "windows", "utilization_mean", "served"):
        assert res_on.summary[key] == res_off.summary[key], key
    assert (on_eng.captures, on_eng.h2d_copies) == \
        (off_eng.captures, off_eng.h2d_copies)
    assert res_off.timelines == {} and off_eng.obs is NULL_OBS
    assert off_eng.scheduler.registry is None
    # every lifecycle ends with the client segment, in both finish modes
    for rid, tl in res_on.timelines.items():
        assert tl[-1]["stage"] == "client_finished", rid
        assert res_on.completions[rid].client_finished
    names = {e["name"] for e in load_trace(str(tmp_path / "trace.json"))
             if e.get("ph") == "X"}
    assert "finish_clients" in names


def test_trace_schema_and_span_per_window(models, tmp_path):
    path = str(tmp_path / "trace.json")
    res = _engine(models[0], ObsConfig(trace_path=path)).serve(
        _requests(6), models[1])
    evs = load_trace(path)
    assert validate_events(evs) == len(evs)
    spans = [e for e in evs if e.get("ph") == "X"]
    dispatch = [e for e in spans if e["name"] == "dispatch"]
    assert len(dispatch) == res.summary["windows"]
    assert sum(e["args"]["lanes"] for e in dispatch) > 0
    assert {"sync_wait", "retire", "admit", "finish_clients",
            "client_finish_dispatch"} <= {e["name"] for e in spans}
    assert any(e["ph"] == "C" and e["name"] == "serve_occupancy"
               for e in evs)


def test_timelines_match_the_reference_engine(models):
    """Stage order, and each request's retire boundary and exact finish
    tick equal to the reference engine's timeline on the same traffic (the
    schedule depends on the host alone, so the noise need not match)."""
    k = 3
    res = _engine(models[0], ObsConfig(trace=False),
                  ticks_per_dispatch=k).serve(_requests(6))
    ref_eng = jserve.ServeEngine(jserve.EngineConfig(
        sched=jsch.cosine_schedule(T), apply_fn=tiny_apply_jax,
        image_shape=SHAPE, slots=4, ticks_per_dispatch=k, async_depth=2,
        obs=jobs.ObsConfig(trace=False)), tiny_params(SHAPE, 0))
    ref = ref_eng.serve([
        jserve.Request(req_id=r.req_id, key=jax.random.PRNGKey(r.seed),
                       batch=r.batch, cut_ratio=r.cut_ratio,
                       client_idx=r.client_idx, arrival_tick=r.arrival_tick)
        for r in _requests(6)])
    assert set(res.timelines) == set(ref.timelines) == set(range(6))
    for rid, tl in res.timelines.items():
        stages = [e["stage"] for e in tl]
        assert stages == [e["stage"] for e in ref.timelines[rid]]
        assert stages.index("queued") < stages.index("admitted") < \
            stages.index("first_tick") < stages.index("retired")
        ret = tl[stages.index("retired")]
        want = ref.timelines[rid][stages.index("retired")]
        assert (ret["tick"], ret["exact_tick"]) == \
            (want["tick"], want["exact_tick"]), rid
        assert ret["tick"] == res.completions[rid].retire_tick
        assert 0 <= ret["tick"] - ret["exact_tick"] <= k - 1


def test_metrics_jsonl_written_at_boundaries(models, tmp_path):
    p = str(tmp_path / "m.jsonl")
    res = _engine(models[0], ObsConfig(trace=False, metrics_path=p,
                                       metrics_every=2)).serve(_requests(6))
    lines = read_jsonl(p)
    assert len(lines) == res.summary["windows"] // 2 + 1
    assert lines[-1]["final"] and all(ln["host"] == 0 for ln in lines)
    names = set(lines[-1]["metrics"])
    assert {"serve_ticks_total", "serve_retired_total", "serve_admitted_total",
            "serve_windows_total", "serve_latency_ticks",
            "serve_queue_depth", "serve_inflight_requests",
            "serve_active_lanes", "serve_boundary_lag_ticks",
            "serve_fragmentation_free_lanes"} <= names
    m = lines[-1]["metrics"]
    assert m["serve_retired_total"]["series"][0]["value"] == \
        res.summary["served"]
    assert m["serve_ticks_total"]["series"][0]["value"] == \
        res.summary["ticks"]


def test_profile_windows_write_a_torch_profile(models, tmp_path):
    d = tmp_path / "prof"
    eng = _engine(models[0], ObsConfig(trace=False, profile_dir=str(d),
                                       profile_windows=2))
    res = eng.serve(_requests(4))
    _bitwise(res, _engine(models[0], None).serve(_requests(4)))
    eng.serve(_requests(2))
    files = sorted(os.listdir(d))
    assert files == ["serve0.host0.pt.trace.json",
                     "serve1.host0.pt.trace.json"]
    evs = json.loads((d / files[0]).read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in evs)


def test_gate_scores_show_as_admission_spans(tmp_path):
    from repro_torch.data.synthetic import (ClientDataConfig,
                                            make_client_datasets)
    server = TinyEps(tiny_params((8, 8, 1), 3)).eval()
    calib = make_client_datasets(ClientDataConfig(
        n_clients=1, per_client=6, image_size=8, holdout=2, seed=0))[0][0]
    gate = tserve.AdmissionPolicy(tsch.cosine_schedule(T), calib,
                                  min_kid=float("-inf"))
    eng = tserve.ServeEngine(tserve.EngineConfig(
        sched=tsch.cosine_schedule(T), image_shape=(8, 8, 1), slots=4,
        admission=gate, device="cpu", obs=ObsConfig()), server)
    res = eng.serve([tserve.Request(req_id=i, seed=i, cut_ratio=c)
                     for i, c in enumerate((0.25, 0.5))])
    spans = [e for e in eng.obs.tracer.events()
             if e.get("ph") == "X" and e["name"] == "admission_score"]
    assert spans and all(e["cat"] == "admission" for e in spans)
    for rid, tl in res.timelines.items():
        assert [e["stage"] for e in tl][:2] == ["queued", "scored"]
        assert tl[1]["action"] == res.decisions[rid].action


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _trainer(obs):
    cfg = launcher_config(8)
    return ttr.CollaFuseTrainer(
        ttr.TrainerConfig(n_clients=2, T=T, cut_ratio=0.5, seed=0),
        lambda s: UNet(cfg, seed=s % 997), device="cpu", obs=obs)


def test_trainer_obs_is_bitwise_and_publishes_losses():
    data = [torch.randn((2, 8, 8, 1), generator=torch.Generator()
                        .manual_seed(s)) for s in (0, 1)]
    off, on = _trainer(None), _trainer(ObsConfig())
    assert off.obs is NULL_OBS
    m_off = off.train_round(data)
    m_on = on.train_round(data)
    assert m_on["server_loss"] == m_off["server_loss"]
    assert m_on["client_losses"] == m_off["client_losses"]
    for name, p in off.server_params.items():
        assert torch.equal(p, on.server_params[name]), name
    for a, b in zip(off.client_params, on.client_params):
        assert all(torch.equal(a[n], b[n]) for n in a)
    m_on2 = on.train_round(data)
    spans = [e for e in on.obs.tracer.events()
             if e.get("ph") == "X" and e["name"] == "train_round"]
    assert [(s["cat"], s["args"]["round"]) for s in spans] == \
        [("train", 0), ("train", 1)]
    snap = on.obs.registry.snapshot()
    assert snap["train_rounds_total"]["series"][0]["value"] == 2
    assert snap["train_server_loss"]["series"][0]["value"] == \
        m_on2["server_loss"]
    assert snap["train_client_loss_mean"]["series"][0]["value"] == \
        m_on2["client_loss_mean"]
    validate_events(on.obs.tracer.events())


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
def _run(args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_serve_diffusion_launcher_pack_and_obs(tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "m.jsonl"
    out = _run(["repro_torch.launch.serve_diffusion", "--device", "cpu",
                "--config", "launcher", "--T", "10", "--requests", "6",
                "--slots", "4", "--clients", "2", "--mix", "--pack",
                "--ticks-per-dispatch", "2", "--trace-out", str(trace),
                "--metrics-out", str(metrics), "--metrics-every", "2"])
    assert out.strip().splitlines()[-1] == "serve_diffusion OK"
    assert "slot pool (pack=True): fragmentation_frac" in out
    assert "lifecycle: queued@t0 -> admitted" in out
    evs = load_trace(str(trace))
    assert validate_events(evs) == len(evs)
    assert any(e.get("ph") == "X" and e["name"] == "dispatch" for e in evs)
    assert read_jsonl(str(metrics))[-1]["final"]


def test_lm_launcher_trace_out(tmp_path):
    trace = tmp_path / "lm.json"
    out = _run(["repro_torch.launch.serve", "--device", "cpu", "--arch",
                "yi-6b", "--requests", "2", "--batch", "2", "--prompt-len",
                "4", "--tokens", "3", "--trace-out", str(trace)])
    assert out.strip().splitlines()[-1] == "serving loop OK"
    evs = load_trace(str(trace))
    validate_events(evs)
    spans = [(e["name"], e["args"]["request"]) for e in evs
             if e.get("ph") == "X"]
    assert spans == [("prefill", 0), ("decode", 0), ("prefill", 1),
                     ("decode", 1)]
    assert all(e["cat"] == "llm" for e in evs if e.get("ph") == "X")
