"""Admission order for the continuous-batching serving engine (counterpart
of ``repro/serve/scheduler.py``; admission gating and wave packing arrive
with their own slices).

A :class:`Request` asks for ``batch`` generated images at cut-ratio
``cut_ratio``, finished by client ``client_idx``'s private model.  At each
window boundary the engine asks its scheduler which arrived requests to
admit into the free slots:

* :class:`FIFOScheduler` — strict arrival order with head-of-line blocking.
* :class:`CutRatioScheduler` — shortest-server-job-first over the request's
  trajectory steps above the cut, aged (``score = server_steps − aging ·
  wait``) so no request starves: after at most ``T / aging`` ticks of
  waiting a request outranks any fresh arrival.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request.  ``eq=False``: requests compare by identity,
    so two same-content requests never alias each other in the queue.
    ``seed`` keys every noise draw of the request's lanes (see
    :mod:`repro_torch.core.collafuse`)."""

    req_id: int
    seed: int                   # lane i draws (seed, i, role, step)
    batch: int = 1              # images requested (slots occupied)
    cut_ratio: float = 0.5      # c: server runs (1-c)·T steps, client c·T
    client_idx: int = 0         # which private model finishes the chain
    arrival_tick: int = 0       # not visible to the engine before this tick
    sampler: str = "ddpm"       # trajectory/update family from the menu

    def __post_init__(self):
        assert self.batch >= 1, self.batch
        assert 0.0 <= self.cut_ratio <= 1.0, self.cut_ratio
        assert self.client_idx >= 0, self.client_idx
        assert self.seed >= 0, self.seed


class FIFOScheduler:
    """Strict arrival order (head-of-line blocking).  ``samplers`` is the
    engine's menu (injected by the engine when absent)."""

    def __init__(self, samplers: Optional[Dict[str, Any]] = None):
        self._queue: List[Request] = []
        self._seq = itertools.count()
        self._order: Dict[int, int] = {}
        self.samplers = samplers
        self.aging_promotions = 0           # FIFO never reorders: stays 0
        self._retired_cbs: List[Callable] = []

    # -- retired-request callbacks --------------------------------------
    def on_retired(self, cb: Callable) -> Callable[[], None]:
        """Register ``cb(request, tick)`` to fire when a request's last lane
        retires; returns an idempotent unsubscribe callable."""
        self._retired_cbs.append(cb)

        def _unsubscribe():
            try:
                self._retired_cbs.remove(cb)
            except ValueError:
                pass
        return _unsubscribe

    def notify_retired(self, req: Request, tick: int) -> None:
        """Fire every :meth:`on_retired` callback for one retired request."""
        for cb in tuple(self._retired_cbs):
            cb(req, tick)

    def add(self, req: Request) -> None:
        self._order[req.req_id] = next(self._seq)
        self._queue.append(req)
        self._queue.sort(key=lambda r: (r.arrival_tick,
                                        self._order[r.req_id]))

    def __len__(self) -> int:
        return len(self._queue)

    def arrived(self, now: int) -> List[Request]:
        return [r for r in self._queue if r.arrival_tick <= now]

    def next_arrival(self) -> Optional[int]:
        return min((r.arrival_tick for r in self._queue), default=None)

    def _candidates(self, now: int) -> List[Request]:
        """Admission order — the only thing policies override."""
        return self.arrived(now)

    def lanes_of(self, req: Request) -> int:
        """Slot-pool lanes the request occupies: one per image."""
        return req.batch

    def select(self, free_slots: int, now: int) -> List[Request]:
        """One-tick admission — :meth:`select_window` with window=1."""
        return self.select_window(free_slots, now, 1)

    def select_window(self, free_slots: int, now: int,
                      window: int) -> List[Request]:
        """Admission at a window boundary: candidates arrived by ``now``, in
        policy order, until one does not fit — which BLOCKS everything ranked
        behind it, so freed slots accumulate for the head (the liveness
        guarantee for batch > 1 requests)."""
        assert window >= 1, window
        picked = []
        for r in self._candidates(now):
            if self.lanes_of(r) > free_slots:
                break
            picked.append(r)
            free_slots -= self.lanes_of(r)
        if picked:
            gone = set(picked)
            self._queue = [r for r in self._queue if r not in gone]
        return picked


class CutRatioScheduler(FIFOScheduler):
    """Shortest-server-job-first over trajectory server steps, with aging.
    Unknown sampler names fall back to the dense (1-c)·T estimate."""

    def __init__(self, T: int, aging: float = 1.0,
                 samplers: Optional[Dict[str, Any]] = None):
        super().__init__(samplers=samplers)
        assert aging > 0.0, "aging=0 reintroduces starvation"
        self.T = T
        self.aging = aging

    def server_cost(self, req: Request) -> float:
        """Server model calls the request needs: its trajectory's step count
        above the cut (== (1-c)·T only for the dense chain)."""
        if self.samplers and req.sampler in self.samplers:
            from repro_torch.core.collafuse import CutPlan
            s = self.samplers[req.sampler]
            return float(CutPlan(self.T, req.cut_ratio).traj_server_steps(s))
        return (1.0 - req.cut_ratio) * self.T

    def _score(self, req: Request, now: int) -> float:
        wait = max(0, now - req.arrival_tick)
        return self.server_cost(req) - self.aging * wait

    def _candidates(self, now: int) -> List[Request]:
        return sorted(
            self.arrived(now),
            key=lambda r: (self._score(r, now), self._order[r.req_id]))

    def select_window(self, free_slots: int, now: int,
                      window: int) -> List[Request]:
        picked = super().select_window(free_slots, now, window)
        # aging promotions: picks that outranked a strictly cheaper arrived
        # candidate still queued — the anti-starvation guarantee, counted
        if picked:
            left = self.arrived(now)
            if left:
                floor = min(self.server_cost(r) for r in left)
                self.aging_promotions += sum(
                    1 for r in picked if self.server_cost(r) > floor)
        return picked


def make_scheduler(policy: str, T: int, aging: float = 1.0, samplers=None):
    if policy == "fifo":
        return FIFOScheduler(samplers=samplers)
    if policy == "cut_ratio":
        return CutRatioScheduler(T, aging=aging, samplers=samplers)
    raise ValueError(f"unknown scheduling policy: {policy!r}")
