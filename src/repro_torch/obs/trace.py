"""Span-based tracer exporting Chrome trace-event JSON (Perfetto-loadable);
counterpart of ``repro/obs/trace.py``.

The serve/train host loops are phase machines — boundary admission,
window dispatch, oldest-window sync, retire/refill, client finish — and
the only way to see where a window's wall time went is a timeline, not a
post-hoc mean.  :class:`Tracer` records each phase as a complete ("X")
trace event with microsecond timestamps; :meth:`Tracer.export` writes the
`Chrome trace-event format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
JSON that ``chrome://tracing`` and https://ui.perfetto.dev load directly.

Multi-host runs tag every event with the host's ``pid`` (and a
``process_name`` metadata event), so concatenating the per-host event
lists — :func:`merge_traces` — yields ONE pod timeline with a lane per
host.

Disabled tracing must cost nothing on the serve hot path: the module-level
:data:`NULL_TRACER` singleton answers every API with cached no-op objects
(``span`` returns ONE shared context manager — no allocation, no clock
read) and is falsy, so ``if tracer:`` guards work too.  The engine's
obs-off run is held bitwise to its obs-on run (``tests/test_torch_obs.py``
on the CPU, ``chip_smoke.py`` phase 4e on the card).

Spans read the HOST clock only: no span synchronizes the device or reads a
device tensor.  On a CUDA device a span therefore measures host time.  The
engine's ``dispatch`` span covers planning a window, staging its one copy
and launching (or replaying) it, not the window's device time; with
``async_depth`` > 1 that device time shows up in the ``sync_wait`` span of
a later boundary, which waits on the window's event.

Event phases emitted here (the subset of the spec we use):

``X``  complete span (ts + dur)        — host-loop phases, trainer rounds
``i``  instant                         — request lifecycle stage marks
``b``/``e``  async nestable begin/end  — one open span per in-flight request
``C``  counter                         — queue depth / in-flight lanes
``M``  metadata                        — process/thread names
"""
from __future__ import annotations

import functools
import json
import time
from typing import Any, Callable, Dict, List, Optional

# every phase code this tracer may emit; validate_events enforces it
_KNOWN_PHASES = frozenset("XibeCM")
# metadata event names the spec defines (we emit the first two)
_METADATA_NAMES = frozenset({"process_name", "thread_name",
                             "process_labels", "process_sort_index",
                             "thread_sort_index"})


class _Span:
    """One open "X" span; created by :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "_event", "_t0")

    def __init__(self, tracer: "Tracer", event: Dict[str, Any]):
        self._tracer = tracer
        self._event = event

    def __enter__(self):
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, *exc):
        ev = self._event
        ev["ts"] = self._t0
        ev["dur"] = self._tracer._now_us() - self._t0
        self._tracer._events.append(ev)
        return False


class _NullSpan:
    """The ONE shared no-op context manager disabled tracing returns."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Zero-cost disabled tracer: every method is a no-op returning cached
    singletons; falsy so ``if tracer:`` guards skip argument building."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def span(self, name, cat="serve", tid=0, **args):
        return _NULL_SPAN

    def trace(self, name=None, cat="serve"):
        return lambda fn: fn

    def instant(self, name, cat="serve", tid=0, **args):
        pass

    def async_begin(self, name, id, cat="request", **args):
        pass

    def async_instant(self, name, id, cat="request", **args):
        pass

    def async_end(self, name, id, cat="request", **args):
        pass

    def counter(self, name, **values):
        pass

    def events(self) -> List[Dict[str, Any]]:
        return []

    def clear(self) -> None:
        pass

    def export(self, path) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Collects Chrome trace events for ONE process (``pid`` = host id).

    Timestamps are microseconds from a shared epoch: ``epoch_s`` (host
    wall clock, ``time.time()``-style) anchors the perf-counter clock so
    traces from different processes of one pod run line up when merged.
    """

    enabled = True

    def __init__(self, pid: int = 0, process_name: Optional[str] = None):
        self.pid = int(pid)
        self._events: List[Dict[str, Any]] = []
        # perf_counter gives monotonic sub-us resolution; the wall-clock
        # anchor makes cross-process merges line up (~ms skew is fine for
        # host-loop phases that run 10s of ms)
        self._anchor_us = time.time() * 1e6 - time.perf_counter() * 1e6
        self._events.append({
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": process_name or f"host{self.pid}"}})
        self._events.append({
            "name": "thread_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": "host-loop"}})

    def __bool__(self) -> bool:
        return True

    def _now_us(self) -> float:
        return self._anchor_us + time.perf_counter() * 1e6

    # ------------------------------------------------------------------
    def span(self, name: str, cat: str = "serve", tid: int = 0,
             **args) -> _Span:
        """Context manager recording one complete ("X") event."""
        return _Span(self, {"name": name, "cat": cat, "ph": "X",
                            "pid": self.pid, "tid": int(tid),
                            "args": args})

    def trace(self, name: Optional[str] = None,
              cat: str = "serve") -> Callable:
        """Decorator form of :meth:`span` (one event per call)."""
        def deco(fn):
            label = name or fn.__name__

            @functools.wraps(fn)
            def wrapped(*a, **kw):
                with self.span(label, cat=cat):
                    return fn(*a, **kw)
            return wrapped
        return deco

    def instant(self, name: str, cat: str = "serve", tid: int = 0,
                **args) -> None:
        self._events.append({"name": name, "cat": cat, "ph": "i",
                             "ts": self._now_us(), "pid": self.pid,
                             "tid": int(tid), "s": "t", "args": args})

    # -- async (nestable) events: one open track per in-flight request ---
    def _async(self, ph: str, name: str, id: int, cat: str, args) -> None:
        self._events.append({"name": name, "cat": cat, "ph": ph,
                             "ts": self._now_us(), "pid": self.pid,
                             "tid": 0, "id": int(id), "args": args})

    def async_begin(self, name: str, id: int, cat: str = "request",
                    **args) -> None:
        self._async("b", name, id, cat, args)

    def async_instant(self, name: str, id: int, cat: str = "request",
                      **args) -> None:
        # nestable instant is "n" in newer spec revisions; "i" with an id
        # renders more widely — use instant-with-id
        self._async("i", name, id, cat, args)

    def async_end(self, name: str, id: int, cat: str = "request",
                  **args) -> None:
        self._async("e", name, id, cat, args)

    def counter(self, name: str, **values) -> None:
        """One "C" sample; each kwarg becomes a series in the counter
        track."""
        self._events.append({"name": name, "cat": "serve", "ph": "C",
                             "ts": self._now_us(), "pid": self.pid,
                             "tid": 0,
                             "args": {k: float(v)
                                      for k, v in values.items()}})

    # ------------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def clear(self) -> None:
        self._events = self._events[:2]        # keep the metadata events

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON object form; returns ``path``."""
        payload = {"traceEvents": self._events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


# ---------------------------------------------------------------------------
# schema validation + multi-host merge
# ---------------------------------------------------------------------------
def validate_events(events) -> int:
    """Assert every event parses under the Chrome trace-event format
    (the fields Perfetto's importer requires); returns the event count.

    Checked per event: dict shape, ``name`` str, ``ph`` in the emitted
    phase set, int ``pid``/``tid``, numeric ``ts`` (except metadata, where
    it is optional), non-negative numeric ``dur`` on "X", ``id`` on async
    phases, JSON-serializable ``args``.
    """
    assert isinstance(events, list) and events, "empty trace"
    for i, ev in enumerate(events):
        ctx = f"event {i}: {ev!r}"
        assert isinstance(ev, dict), ctx
        assert isinstance(ev.get("name"), str) and ev["name"], ctx
        ph = ev.get("ph")
        assert ph in _KNOWN_PHASES, f"unknown phase {ph!r} — {ctx}"
        assert isinstance(ev.get("pid"), int), ctx
        assert isinstance(ev.get("tid"), int), ctx
        if ph == "M":
            assert ev["name"] in _METADATA_NAMES, ctx
        else:
            assert isinstance(ev.get("ts"), (int, float)), ctx
        if ph == "X":
            assert isinstance(ev.get("dur"), (int, float)) \
                and ev["dur"] >= 0, ctx
        if ph in ("b", "e"):
            assert isinstance(ev.get("id"), int), ctx
        json.dumps(ev.get("args", {}))         # args must serialize
    return len(events)


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Read a trace file written by :meth:`Tracer.export` (object form)
    or a bare event array; returns the event list."""
    with open(path) as f:
        payload = json.load(f)
    return payload["traceEvents"] if isinstance(payload, dict) else payload


def merge_traces(paths, out_path: str) -> int:
    """Concatenate per-host trace files into ONE pod timeline (events are
    already pid-tagged per host, so merging is a concat); returns the
    merged event count."""
    merged: List[Dict[str, Any]] = []
    for p in paths:
        merged.extend(load_trace(p))
    validate_events(merged)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f)
    return len(merged)
