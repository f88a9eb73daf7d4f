"""Serving telemetry: per-request latency, tick utilization, FLOP split,
the slot pool's fragmentation and occupancy by class, and the admission
gate's outcomes (counterpart of ``repro/serve/metrics.py``).

The engine reports one event per admission and retirement, the exact
per-tick occupancy of every window and, before each dispatch, the window's
class mix; :meth:`ServeMetrics.summary` folds them into the run record, and
:func:`finish_summary` adds the client segment's accounting.  With a
``registry`` (:class:`repro_torch.obs.MetricsRegistry`) every event is also
published live into the reference's named instruments.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.collafuse import CutPlan, flops_split_steps
from repro_torch.obs.registry import NULL_REGISTRY


class ServeMetrics:
    """Event sink for one engine run.  ``registry`` (default: the disabled
    one) receives every event live, so a running engine is observable
    through the registry's JSON-lines snapshots."""

    def __init__(self, capacity: int, registry=None):
        self.capacity = capacity
        self.registry = registry if registry is not None else NULL_REGISTRY
        self._admit: Dict[int, Dict] = {}       # req_id -> {tick, wall}
        self._retire: Dict[int, Dict] = {}
        self._util: List[float] = []            # active lanes / capacity
        self._t0: Optional[float] = None
        self._windows = 0
        self._idle_ticks = 0
        self._lags: List[int] = []
        # on_window_mix: lane-ticks per trajectory class, and lane-ticks
        # that sat EMPTY while arrived demand waited (fragmentation)
        self._occ_by_class: Dict[str, int] = {}
        self._frag_slot_ticks = 0
        self._mix_ticks = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def _now(self) -> float:
        if self._t0 is None:
            self.start()
        return time.perf_counter() - self._t0

    def on_admit(self, req_id: int, tick: int) -> None:
        self._admit[req_id] = {"tick": tick, "wall": self._now()}
        self.registry.counter(
            "serve_admitted_total", "requests admitted into slots").inc()

    def on_retire(self, req_id: int, tick: int) -> None:
        self._retire[req_id] = {"tick": tick, "wall": self._now()}
        self.registry.counter(
            "serve_retired_total", "requests retired at the cut").inc()
        self.registry.histogram(
            "serve_latency_ticks", "admit->retire residency in ticks"
        ).observe(tick - self._admit[req_id]["tick"])

    def on_window_exact(self, active_start: int, done_counts) -> None:
        """Exact per-tick occupancy of one window: ``done_counts[j]`` lanes
        finished AT window tick j, and a lane counts as active through its
        finish tick."""
        counts = np.asarray(done_counts, np.int64)
        assert int(counts.sum()) <= active_start, \
            f"{counts.sum()} lanes done in a window that started with " \
            f"{active_start} active"
        self._windows += 1
        self.registry.counter("serve_windows_total",
                              "fused scan windows dispatched").inc()
        self.registry.counter("serve_ticks_total",
                              "scan ticks executed").inc(counts.size)
        retired_before = np.concatenate(([0], np.cumsum(counts[:-1])))
        act = active_start - retired_before
        self._util.extend((act / max(self.capacity, 1)).tolist())
        self.registry.gauge(
            "serve_active_lanes", "live lanes at the window's last tick"
        ).set(int(act[-1] - counts[-1]))

    def on_window_mix(self, class_lanes: Dict[str, int], free: int,
                      starved: bool, ticks: int) -> None:
        """One window's class mix, reported before its dispatch:
        ``class_lanes`` maps a class label (``"<sampler>@<effective
        cut>@<guidance w>"``) to its live lanes (a guided image counts its
        two), ``free`` is the empty slots, ``starved`` whether ARRIVED
        demand waited in the queue.  Free slots in a starved window are
        FRAGMENTATION: capacity the scheduler could not shape the queue
        into.  Folded into ``fragmentation_frac`` and
        ``occupancy_by_class``."""
        for cls, lanes in class_lanes.items():
            self._occ_by_class[cls] = \
                self._occ_by_class.get(cls, 0) + lanes * ticks
        if starved and free > 0:
            self._frag_slot_ticks += free * ticks
        self._mix_ticks += ticks
        self.registry.gauge(
            "serve_fragmentation_free_lanes",
            "empty slots entering a window while arrived demand waits"
        ).set(free if starved else 0)

    def on_idle_gap(self, gap: int) -> None:
        """Ticks skipped because no lane was in flight."""
        if gap > 0:
            self._idle_ticks += gap
            self.registry.counter(
                "serve_idle_ticks_total",
                "ticks skipped with no lane in flight").inc(gap)

    def on_finish_dispatch(self, n_requests: int, lanes: int) -> None:
        """One streamed client-finish wave launched: ``n_requests`` retired
        requests, ``lanes`` lanes (published to the registry; the summary
        takes its counts from the finisher)."""
        self.registry.counter(
            "serve_finish_batches_total",
            "streamed client-finish batches dispatched").inc()
        self.registry.counter(
            "serve_finish_lanes_total",
            "lanes handed to the streaming client finisher").inc(lanes)
        self.registry.histogram(
            "serve_finish_batch_requests",
            "requests per streamed client-finish batch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128)).observe(n_requests)

    def on_boundary_lag(self, lag: int) -> None:
        """Ticks between a lane reaching its cut and the window boundary
        that retired it (≤ ticks_per_dispatch − 1)."""
        self._lags.append(lag)
        self.registry.histogram(
            "serve_boundary_lag_ticks",
            "retire boundary minus exact finish tick, per lane",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64)).observe(lag)

    @property
    def ticks(self) -> int:
        return len(self._util)

    def latency_ticks(self, req_id: int) -> Optional[int]:
        """Server-segment residency: admission tick -> retirement tick."""
        if req_id not in self._retire:
            return None
        return self._retire[req_id]["tick"] - self._admit[req_id]["tick"]

    def summary(self, wall_s: float, T: int, flops_per_call: float,
                requests, steps_of: Optional[Callable] = None,
                decisions: Optional[Dict] = None,
                guided_of: Optional[Callable] = None) -> Dict:
        """Aggregate one run over ``requests``.  ``steps_of(req) ->
        (n_server_steps, n_client_steps)`` gives the per-request model-call
        split (default: the dense CutPlan split).  ``guided_of(req)`` marks
        guided requests, whose server segment counts at exactly 2× FLOPs
        (their images count once).  ``decisions`` ({req_id:
        AdmissionDecision}) adds the ``admission`` section and leaves the
        rejected requests out of the FLOPs and the throughput."""
        decisions = decisions or {}
        lat_t = np.array([self.latency_ticks(r.req_id) for r in requests
                          if self.latency_ticks(r.req_id) is not None],
                         dtype=np.float64)
        lat_w = np.array([self._retire[r.req_id]["wall"] -
                          self._admit[r.req_id]["wall"]
                          for r in requests if r.req_id in self._retire],
                         dtype=np.float64)
        if steps_of is None:
            def steps_of(r):
                plan = CutPlan(T, r.cut_ratio)
                return plan.n_server_steps, plan.n_client_steps
        server_f = client_f = 0.0
        images = n_served = 0
        for r in requests:
            d = decisions.get(r.req_id)
            if d is not None and not d.served:
                continue
            n_served += 1
            n_srv, n_cli = steps_of(r)
            split = flops_split_steps(
                n_srv, n_cli, flops_per_call, r.batch,
                guided=bool(guided_of(r)) if guided_of is not None else False)
            server_f += split["server_flops"]
            client_f += split["client_flops"]
            images += r.batch       # a guided pair's shadow emits no image
        total = max(server_f + client_f, 1.0)

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else 0.0
        out = {
            "requests": len(requests),
            "served": n_served,
            "images": images,
            "ticks": self.ticks,
            "windows": self._windows,
            "ticks_per_s": self.ticks / max(wall_s, 1e-9),
            "idle_ticks": self._idle_ticks,
            "requests_per_s": n_served / max(wall_s, 1e-9),
            "images_per_s": images / max(wall_s, 1e-9),
            "latency_ticks_p50": pct(lat_t, 50),
            "latency_ticks_p95": pct(lat_t, 95),
            "latency_s_p50": pct(lat_w, 50),
            "latency_s_p95": pct(lat_w, 95),
            "utilization_mean": float(np.mean(self._util))
            if self._util else 0.0,
            "server_flops": server_f,
            "client_flops": client_f,
            "client_fraction": client_f / total,
        }
        if self._mix_ticks:
            # share of dispatched lane-ticks that sat empty while arrived
            # demand waited: 0.0 is fragmentation-proof packing
            out["fragmentation_frac"] = self._frag_slot_ticks / (
                self.capacity * self._mix_ticks)
            out["occupancy_by_class"] = dict(
                sorted(self._occ_by_class.items()))
        if self._lags:
            lags = np.array(self._lags, np.float64)
            out["boundary_lag_mean"] = float(lags.mean())
            out["boundary_lag_p100"] = int(lags.max())
        if decisions:
            out["admission"] = admission_summary(decisions.values(),
                                                 registry=self.registry)
        return out


def finish_summary(mode: str, finish_s: float, tail_s: float = 0.0,
                   batches: int = 0, lanes: int = 0) -> Dict:
    """Accounting of the client-finish segment, merged into the serve
    summary.  ``finish_s`` is the host time spent in the finish path (stage,
    launch, reap).  In ``"stream"`` mode most of it runs while server
    windows are in flight; only ``tail_s``, the drain after the last window
    retired, is serial, so ``overlap_frac = 1 − tail_s / finish_s``.  In
    ``"drain"`` mode the whole segment runs after the server loop
    (``overlap_frac`` 0) and the caller adds ``finish_s`` to the wall; in
    stream mode the loop's wall already covers it."""
    if mode not in ("stream", "drain"):
        raise ValueError(f"finish mode {mode!r} not in ('stream', 'drain')")
    if mode == "drain":
        overlap = 0.0
        tail_s = finish_s
    else:
        overlap = 1.0 - tail_s / finish_s if finish_s > 1e-12 else 1.0
    return {
        "finish_mode": mode,
        "finish_s": finish_s,
        "finish_tail_s": tail_s,
        "overlap_frac": float(min(1.0, max(0.0, overlap))),
        "finish_batches": batches,
        "finish_lanes": lanes,
    }


def admission_summary(decisions, bins: int = 8, registry=None) -> Dict:
    """Fold AdmissionDecisions into a JSON-able record: action counts and a
    histogram of the SERVED disclosure KIDs (bumps included).  With rejects
    only there is no ``disclosure_kid`` key.  An enabled ``registry``
    receives the counts as ``serve_admission_actions_total{action=}``."""
    ds = list(decisions)
    kids = np.array([d.kid for d in ds if d.served], np.float64)
    rec = {
        "min_kid": ds[0].min_kid if ds else 0.0,
        "admitted": sum(1 for d in ds if d.action == "admit"),
        "bumped": sum(1 for d in ds if d.action == "bump"),
        "rejected": sum(1 for d in ds if d.action == "reject"),
    }
    if registry is not None and registry:
        actions = registry.counter("serve_admission_actions_total",
                                   "admission gate outcomes",
                                   labels=("action",))
        for act in ("admit", "bump", "reject"):
            actions.labels(action=act).inc(
                sum(1 for d in ds if d.action == act))
    if kids.size:
        counts, edges = np.histogram(kids, bins=bins)
        rec["disclosure_kid"] = {
            "min": float(kids.min()),
            "mean": float(kids.mean()),
            "max": float(kids.max()),
            "hist_counts": [int(c) for c in counts],
            "hist_edges": [float(e) for e in edges],
        }
    return rec
