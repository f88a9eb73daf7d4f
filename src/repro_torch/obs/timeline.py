"""Per-request lifecycle timelines: queued → scored → admitted → first
tick → retired-at-cut → client-finished (counterpart of
``repro/obs/timeline.py``).

``ServeMetrics`` keeps two timestamps per request (admit, retire); a
production serve needs the whole lifecycle — when did the request enter
the queue, what did admission decide, which window boundary retired it,
and (from the ``(k, slots)`` done stack the engine's host plans for each
window) the EXACT tick each lane reached its cut, not just the boundary.  The recorder stores one
ordered event list per request:

    {"stage": "retired", "wall": 0.0123, "tick": 24,
     "exact_tick": 22, ...}

``wall`` is seconds since the recorder epoch (aligned with the owning
:class:`repro_torch.obs.Observability`'s tracer); ``tick`` the engine tick where
known.  Stage vocabulary is :data:`STAGES` — monotone per request, and the
recorder asserts a stage is never recorded twice for one request.

The recorder optionally mirrors every stage into a tracer as async
("b"/"e") events, so Perfetto shows one open track per in-flight request
alongside the host-loop phase spans.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

# canonical stage order; "scored" only under a KID gate, "client_finished"
# only when serve() ran the client segment
STAGES = ("queued", "scored", "admitted", "first_tick", "retired",
          "client_finished", "rejected")
_OPENING = "queued"
# the async track spans the queue + server residency; the client segment
# runs after the drain and is marked as an instant on the closed track
_CLOSING = frozenset({"retired", "rejected"})


class NullTimelines:
    """Zero-cost disabled recorder (falsy, no storage)."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def record(self, req_id, stage, tick=None, **detail):
        pass

    def reset(self):
        pass

    def snapshot(self) -> Dict[int, List[Dict]]:
        return {}

    def of(self, req_id):
        return []


NULL_TIMELINES = NullTimelines()


class TimelineRecorder:
    """One ordered event list per request id."""

    enabled = True

    def __init__(self, tracer=None):
        self._tracer = tracer           # optional: mirrors async events
        self._t0 = time.perf_counter()
        self._by_req: Dict[int, List[Dict]] = {}

    def __bool__(self) -> bool:
        return True

    def record(self, req_id: int, stage: str,
               tick: Optional[int] = None, **detail) -> None:
        assert stage in STAGES, f"unknown stage {stage!r}; use {STAGES}"
        events = self._by_req.setdefault(int(req_id), [])
        assert all(e["stage"] != stage for e in events), \
            f"request {req_id}: stage {stage!r} recorded twice"
        ev = {"stage": stage,
              "wall": time.perf_counter() - self._t0}
        if tick is not None:
            ev["tick"] = int(tick)
        ev.update(detail)
        events.append(ev)
        tr = self._tracer
        if tr:
            args = {k: v for k, v in ev.items() if k != "stage"}
            if stage == _OPENING:
                tr.async_begin(f"req{req_id}", id=req_id, **args)
            elif stage in _CLOSING:
                tr.async_end(f"req{req_id}", id=req_id, stage=stage,
                             **args)
            else:
                tr.async_instant(stage, id=req_id, **args)

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Drop all recorded lifecycles (the engine resets per serve()
        call — req_ids are only unique within one call)."""
        self._by_req = {}

    def of(self, req_id: int) -> List[Dict]:
        return list(self._by_req.get(int(req_id), []))

    def stages_of(self, req_id: int) -> List[str]:
        return [e["stage"] for e in self.of(req_id)]

    def snapshot(self) -> Dict[int, List[Dict]]:
        """{req_id: [event, ...]} — events in recording order; JSON-able."""
        return {rid: [dict(e) for e in evs]
                for rid, evs in self._by_req.items()}
