"""repro_torch.obs — observability for the serve/train stack (counterpart of
``repro/obs/``, kept as the port's own copy).

Three pillars, one facade:

* ``trace``    — span tracer exporting Chrome trace-event JSON (Perfetto):
                 host-loop phases, trainer rounds, admission cache fills,
                 per-request async tracks; per-host ``pid`` tagging so
                 traces of several processes merge into one timeline.
* ``registry`` — typed counters/gauges/histograms with labels, snapshotted
                 to JSON-lines at window boundaries (live metrics for
                 long-lived engines).
* ``timeline`` — per-request lifecycle records (queued → scored →
                 admitted → first tick → retired-at-cut → client-finished)
                 with wall timestamps and exact finish ticks from the
                 window plans the engine's host makes.

Usage — hand an :class:`ObsConfig` to the engine (or trainer)::

    cfg = EngineConfig(..., obs=ObsConfig(trace_path="trace.json",
                                          metrics_path="metrics.jsonl"))
    res = ServeEngine(cfg, server).serve(requests)
    res.timelines[req_id]       # the lifecycle record

Everything is opt-in and zero-cost when off: ``obs=None`` (the default)
resolves to :data:`NULL_OBS`, whose tracer/registry/timeline answer every
call with cached no-op singletons — no allocation, no clock reads, no
branches beyond one attribute hop.  Nothing here reads the device: spans,
gauges and timelines take the host's clock and the host's lane state, so
obs on changes neither what a window launches nor what it copies.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Optional

import torch

from repro_torch.obs.registry import (DEFAULT_BUCKETS, Counter, Gauge,
                                      Histogram, MetricsRegistry,
                                      NULL_REGISTRY, NullRegistry,
                                      read_jsonl)
from repro_torch.obs.timeline import (NULL_TIMELINES, STAGES, NullTimelines,
                                      TimelineRecorder)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Tracer,
                                   load_trace, merge_traces, validate_events)

__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_OBS", "NULL_REGISTRY", "NULL_TIMELINES", "NULL_TRACER",
    "NullRegistry", "NullTimelines", "NullTracer", "ObsConfig",
    "Observability", "STAGES", "TimelineRecorder", "Tracer",
    "WindowProfiler", "load_trace", "merge_traces", "read_jsonl",
    "resolve_obs", "validate_events",
]


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Declarative observability knobs (frozen, like EngineConfig).

    ``trace``          span tracing on/off (forced on by ``trace_path``).
    ``trace_path``     export the Chrome trace JSON here after each
                       ``serve()``; with ``hosts > 1`` the path gets
                       ``.host<i>`` appended (one host for now).
    ``metrics_path``   append one registry snapshot line per
                       ``metrics_every`` window boundaries (JSON-lines).
    ``metrics_every``  snapshot cadence in windows.
    ``timelines``      record per-request lifecycle events.
    ``profile_dir``    capture a ``torch.profiler`` trace (CPU and CUDA
                       activities) of the first ``profile_windows``
                       dispatches of each ``serve()`` into this directory,
                       one Chrome trace file a serve
                       (``serve<n>.host<i>.pt.trace.json``).  The profiler
                       starts before the first dispatch, so a window kind's
                       first window (run eagerly, then captured as a CUDA
                       graph) is captured under it; it stops after
                       synchronizing the device behind the last profiled
                       window, so the file holds those windows' kernels.
    """

    trace: bool = True
    trace_path: Optional[str] = None
    metrics_path: Optional[str] = None
    metrics_every: int = 1
    timelines: bool = True
    profile_dir: Optional[str] = None
    profile_windows: int = 4

    def __post_init__(self):
        assert self.metrics_every >= 1, self.metrics_every
        assert self.profile_windows >= 1, self.profile_windows


class WindowProfiler:
    """``torch.profiler`` over the first ``windows`` dispatches of one
    serve (the counterpart of the reference's ``jax.profiler`` window
    capture).  :meth:`before` starts it ahead of a dispatch, :meth:`after`
    counts the dispatch and, at the last one, synchronizes ``device``,
    stops and writes ``path``; :meth:`close` does the same for a serve
    that ran fewer windows.  A failure to start or stop raises."""

    def __init__(self, path: str, windows: int, device: torch.device):
        self.path = path
        self.device = device
        self._left = windows
        self._prof = None

    def before(self) -> None:
        if self._left <= 0 or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    def after(self) -> None:
        if self._prof is None:
            return
        self._left -= 1
        if self._left <= 0:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        self._left = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        prof.export_chrome_trace(self.path)


class Observability:
    """The bundle a subsystem threads: ``.tracer``, ``.registry``,
    ``.timelines``, plus the request-lifecycle helper shared by the engine
    and the metrics sink."""

    enabled = True

    def __init__(self, config: Optional[ObsConfig] = None, *,
                 host_id: int = 0):
        self.config = config if config is not None else ObsConfig()
        self.host_id = int(host_id)
        trace_on = self.config.trace or self.config.trace_path is not None
        self.tracer = Tracer(pid=self.host_id) if trace_on else NULL_TRACER
        self.registry = MetricsRegistry()
        self.timelines = (TimelineRecorder(tracer=self.tracer)
                          if self.config.timelines else NULL_TIMELINES)
        self._profiles = itertools.count()

    def __bool__(self) -> bool:
        return True

    # ------------------------------------------------------------------
    def request(self, req_id: int, stage: str,
                tick: Optional[int] = None, **detail) -> None:
        """Record one lifecycle stage (timeline + async trace event)."""
        self.timelines.record(req_id, stage, tick=tick, **detail)

    def trace_path_for_host(self, hosts: int = 1) -> Optional[str]:
        """The per-host trace export path (several hosts must not clobber
        each other's files; events stay pid-tagged for a later merge)."""
        p = self.config.trace_path
        if p is None or hosts <= 1:
            return p
        return f"{p}.host{self.host_id}"

    def window_profiler(self, device: torch.device
                        ) -> Optional[WindowProfiler]:
        """A fresh :class:`WindowProfiler` for one serve, or None when
        ``profile_dir`` is unset."""
        cfg = self.config
        if cfg.profile_dir is None:
            return None
        name = f"serve{next(self._profiles)}.host{self.host_id}.pt.trace.json"
        return WindowProfiler(os.path.join(cfg.profile_dir, name),
                              cfg.profile_windows, device)


class _NullObs:
    """Disabled facade: one shared instance, all pillars no-op."""

    enabled = False
    config = None
    host_id = 0
    tracer = NULL_TRACER
    registry = NULL_REGISTRY
    timelines = NULL_TIMELINES

    def __bool__(self) -> bool:
        return False

    def request(self, req_id, stage, tick=None, **detail) -> None:
        pass

    def trace_path_for_host(self, hosts: int = 1) -> Optional[str]:
        return None

    def window_profiler(self, device) -> None:
        return None


NULL_OBS = _NullObs()


def resolve_obs(spec, *, host_id: int = 0):
    """None -> NULL_OBS; ObsConfig -> fresh Observability; an
    Observability instance passes through (shared by engine + trainer)."""
    if spec is None:
        return NULL_OBS
    if isinstance(spec, (Observability, _NullObs)):
        return spec
    if isinstance(spec, ObsConfig):
        return Observability(spec, host_id=host_id)
    raise TypeError(f"obs must be None, ObsConfig or Observability; "
                    f"got {type(spec).__name__}")
