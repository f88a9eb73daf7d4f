"""Admission order for the continuous-batching serving engine (counterpart
of ``repro/serve/scheduler.py``).

A :class:`Request` asks for ``batch`` generated images at cut-ratio
``cut_ratio``, finished by client ``client_idx``'s private model.  At each
window boundary the engine asks its scheduler which arrived requests to
admit into the free slots:

* :class:`FIFOScheduler` — strict arrival order with head-of-line blocking.
* :class:`CutRatioScheduler` — shortest-server-job-first over the request's
  NOMINAL trajectory steps above the cut (2× for a guided sampler), aged
  (``score = nominal_cost − aging · wait``) so no request starves: after at
  most ``2T / aging`` ticks of waiting a request outranks any fresh arrival.

With an ``admission`` policy (:mod:`repro_torch.serve.admission`) every
candidate is gated at selection: a rejected request leaves the queue
without taking a slot or blocking those behind it.

``pack=True`` is trajectory-aware WAVE PACKING for the engine's k-tick
windows: after admitting the head of the order, the selection sweeps the
candidates behind it for same-CLASS requests (lanes that retire at the same
boundary when admitted together) that fit the remaining budget, so each
window runs step-homogeneous cohorts whose slots free in chunks.  Packing
never skips the head: when it does not fit, nothing is admitted and freed
slots accumulate for it (the blocking rule above), so every request's
position still strictly decreases (FIFO) or is aging-bounded (SJF).
Packing changes WHEN a request is admitted, never its numbers: a lane's
noise depends only on (seed, image, role, step), so completions are bitwise
those of the unpacked run.
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
    sampler: str = "ddpm"       # trajectory/update family from the menu (a
    #                             guided entry takes 2 lanes an image)
    label: int = 0              # class label, read by a conditional engine

    def __post_init__(self):
        assert self.batch >= 1, self.batch
        assert 0.0 <= self.cut_ratio <= 1.0, self.cut_ratio
        assert self.client_idx >= 0, self.client_idx
        assert self.seed >= 0, self.seed
        assert self.label >= 0, self.label


class FIFOScheduler:
    """Strict arrival order (head-of-line blocking).  ``samplers`` is the
    engine's menu (injected by the engine when absent); ``admission`` an
    optional :class:`~repro_torch.serve.admission.AdmissionPolicy` (the
    engine shares its own); ``pack`` turns on wave packing (FIFO's class is
    (sampler, cut_ratio, guidance w)).  ``registry`` is the engine's
    metrics registry when observability is on, else None."""

    def __init__(self, samplers: Optional[Dict[str, Any]] = None,
                 admission=None, pack: bool = False):
        self._queue: List[Request] = []
        self._seq = itertools.count()
        self._order: Dict[int, int] = {}
        self.samplers = samplers
        self.admission = admission
        self.pack = bool(pack)
        self._rejections: List[Any] = []    # decisions dropped at select
        self.aging_promotions = 0           # FIFO never reorders: stays 0
        self.registry = None                # obs: the engine attaches its own
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

    def _guidance_of(self, req: Request) -> float:
        """Guidance scale w of the request's sampler (0.0 for unguided or
        unknown samplers).  It keys wave classes: guided pairs and solo
        lanes must not coalesce even at equal trajectory cost."""
        s = (self.samplers or {}).get(req.sampler)
        return float(s.w) if s is not None and s.guided else 0.0

    def lanes_of(self, req: Request) -> int:
        """Slot-pool lanes the request occupies: one per image, two for a
        guided sampler (a cond+uncond lane pair an image)."""
        s = (self.samplers or {}).get(req.sampler)
        return req.batch * (2 if s is not None and s.guided else 1)

    def _class_of(self, req: Request):
        """Wave-packing class: (sampler, cut_ratio, guidance w), requests
        that run the same server steps with the same lane geometry.
        :class:`CutRatioScheduler` refines the cut to the effective cost."""
        return (req.sampler, req.cut_ratio, self._guidance_of(req))

    def select(self, free_slots: int, now: int) -> List[Request]:
        """One-tick admission — :meth:`select_window` with window=1."""
        return self.select_window(free_slots, now, 1)

    def select_window(self, free_slots: int, now: int,
                      window: int) -> List[Request]:
        """Admission at a window boundary: candidates arrived by ``now``, in
        policy order, until one does not fit — which BLOCKS everything ranked
        behind it, so freed slots accumulate for the head (the liveness
        guarantee for batch > 1 requests).  Under an ``admission`` policy a
        rejected candidate is dropped from the queue and recorded for
        :meth:`take_rejections`; it blocks nothing.  ``pack`` replaces the
        walk with :meth:`_pack_waves`, under the same blocking rule."""
        assert window >= 1, window
        served, dropped = [], []
        for r in self._candidates(now):
            if self.admission is not None:
                d = self.admission.decide(r)
                if not d.served:
                    dropped.append((r, d))
                    continue
            served.append(r)
        if self.pack:
            picked = self._pack_waves(served, free_slots)
        else:
            picked = []
            for r in served:
                if self.lanes_of(r) > free_slots:
                    break
                picked.append(r)
                free_slots -= self.lanes_of(r)
        gone = set(picked)
        gone.update(r for r, _ in dropped)
        if gone:
            self._queue = [r for r in self._queue if r not in gone]
        self._rejections.extend(d for _, d in dropped)
        return picked

    def _pack_waves(self, cands: List[Request],
                    free_slots: int) -> List[Request]:
        """Wave packing over the gated candidate order.  Loop: the first
        remaining candidate is the HEAD; if it does not fit the remaining
        budget, stop (it blocks, and slots accumulate for it); otherwise
        admit it and sweep the candidates behind it, admitting every
        same-class one that fits and leaving the rest, in order, for the
        next head."""
        remaining = list(cands)
        picked: List[Request] = []
        while remaining:
            head = remaining[0]
            if self.lanes_of(head) > free_slots:
                break
            picked.append(head)
            free_slots -= self.lanes_of(head)
            cls = self._class_of(head)
            rest: List[Request] = []
            for r in remaining[1:]:
                if self._class_of(r) == cls and \
                        self.lanes_of(r) <= free_slots:
                    picked.append(r)
                    free_slots -= self.lanes_of(r)
                else:
                    rest.append(r)
            remaining = rest
        return picked

    def take_rejections(self) -> List[Any]:
        """Drain the decisions of the requests the select gate dropped since
        the last call."""
        out, self._rejections = self._rejections, []
        return out


class CutRatioScheduler(FIFOScheduler):
    """Shortest-server-job-first over trajectory server steps, with aging.
    Unknown sampler names fall back to the dense (1-c)·T estimate.

    The ordering score uses the NOMINAL cost (what the request asked for):
    under a KID gate a bumped request runs fewer server steps
    (:meth:`server_cost` prices that), but letting the discount improve its
    queue position would let expensive requests bumped cheap outrank an
    honest cheap one."""

    def __init__(self, T: int, aging: float = 1.0,
                 samplers: Optional[Dict[str, Any]] = None, admission=None,
                 pack: bool = False):
        super().__init__(samplers=samplers, admission=admission, pack=pack)
        assert aging > 0.0, "aging=0 reintroduces starvation"
        self.T = T
        self.aging = aging

    def server_cost(self, req: Request) -> float:
        """Server steps the request runs: the effective cut under an
        admission policy, else :meth:`nominal_cost`."""
        if self.admission is not None:
            d = self.admission.decide(req)
            if d.served:
                return float(d.effective_cut)
        return self.nominal_cost(req)

    def nominal_cost(self, req: Request) -> float:
        """The trajectory's step count above the NOMINAL cut (== (1-c)·T
        only for the dense chain), doubled for a guided sampler (two model
        evaluations a step)."""
        if self.samplers and req.sampler in self.samplers:
            from repro_torch.core.collafuse import CutPlan
            s = self.samplers[req.sampler]
            steps = float(CutPlan(self.T, req.cut_ratio).traj_server_steps(s))
            return steps * (2.0 if s.guided else 1.0)
        return (1.0 - req.cut_ratio) * self.T

    def _score(self, req: Request, now: int) -> float:
        # waiting offsets the NOMINAL cost: a bump never improves a
        # request's queue position
        wait = max(0, now - req.arrival_tick)
        return self.nominal_cost(req) - self.aging * wait

    def _class_of(self, req: Request):
        """SJF wave class: (sampler, effective server cost, guidance w), so
        a bumped request packs with the cohort it actually runs with."""
        return (req.sampler, self.server_cost(req), self._guidance_of(req))

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
                promos = sum(1 for r in picked
                             if self.server_cost(r) > floor)
                if promos:
                    self.aging_promotions += promos
                    if self.registry is not None:
                        self.registry.counter(
                            "serve_aging_promotions_total",
                            "SJF picks that overtook a cheaper queued "
                            "request on aged score").inc(promos)
        return picked


def make_scheduler(policy: str, T: int, aging: float = 1.0, samplers=None,
                   admission=None, pack: bool = False):
    if policy == "fifo":
        return FIFOScheduler(samplers=samplers, admission=admission,
                             pack=pack)
    if policy == "cut_ratio":
        return CutRatioScheduler(T, aging=aging, samplers=samplers,
                                 admission=admission, pack=pack)
    raise ValueError(f"unknown scheduling policy: {policy!r}")
