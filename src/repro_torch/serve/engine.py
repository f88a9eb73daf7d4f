"""Continuous-batching split-inference engine for the CollaFuse server
(counterpart of ``repro/serve/engine.py``).

* Requests (mixed cut-ratios, batch sizes, arrival ticks and samplers) queue
  in a scheduler and are admitted, at window boundaries, into a fixed array
  of SLOTS, one image ("lane") per slot.
* Every lane walks a trajectory from the engine's sampler menu; the host
  tracks each lane's trajectory position, so no tick waits on the device.
* A WINDOW is ``ticks_per_dispatch`` masked lane ticks in a Python loop
  (the reference's ``lax.scan``): each tick runs the server model on the
  whole slot array and one ``StepBackend`` masked step
  (:func:`repro_torch.diffusion.backend.make_lane_tick`).  A lane reaching
  its cut mid-window holds x bitwise, so retiring at the boundary reads the
  exact cut tensor at any window depth; the (k, slots) done stack gives each
  lane's exact finish tick.
* A GUIDED request (a sampler with a guidance scale, on a conditional
  engine) takes a cond+uncond lane PAIR an image: the primary lane sees the
  request's label, its shadow the null label; one model call covers both,
  and the classifier-free combine runs in front of the one step
  (``StepBackend.guided_masked_index_step``).  Shadows are never emitted.
* Under a KID gate (:mod:`repro_torch.serve.admission`) every request gets
  an admission decision: admitted at its nominal cut, bumped to a noisier
  one, or rejected at selection without taking a slot.
* Requests with no server steps (effective cut 0) complete at arrival with
  x_mid = x_T, without a slot.
* The drain finisher runs after the server queue empties: lanes grouped by
  client, each group stepped by its client's private model to the end of
  its trajectory, unguided (every finisher lane solo, the null label).

Noise: lane i of a request draws ``source(seed, i, role, step)`` — x_T with
role "init", server steps "server", client steps "client", keyed by the
trajectory position — so lanes never depend on slot, tick or window depth
and :func:`repro_torch.core.collafuse.split_sample_lane` replays each one.
A guided pair's shadow lane steps with its primary's draw.

Waiting for later slices: async windows, the streamed finisher, spare menu
columns, wave packing, pod mode and observability.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import collafuse
from repro_torch.core.collafuse import CutPlan, NoiseSource, lane_normal
from repro_torch.device import (check_on_device, check_tensor_on_device,
                                resolve_device)
from repro_torch.diffusion.backend import (BackendLike, get_backend,
                                           make_lane_tick)
from repro_torch.diffusion.sampler import (Sampler, assert_same_menu,
                                           default_samplers)
from repro_torch.diffusion.schedule import DiffusionSchedule
from repro_torch.serve.admission import AdmissionDecision, AdmissionPolicy
from repro_torch.serve.metrics import ServeMetrics, finish_summary
from repro_torch.serve.scheduler import FIFOScheduler, Request


@dataclasses.dataclass
class Completion:
    """One finished request: the disclosed tensor and (after the client
    finisher) the final images."""

    request: Request
    x_mid: np.ndarray                  # [batch, H, W, C] at the cut
    admit_tick: int
    retire_tick: int                   # window boundary the lane retired at
    x0: Optional[np.ndarray] = None    # filled by the client finish
    client_finished: bool = False


@dataclasses.dataclass
class ServeResult:
    completions: Dict[int, Completion]
    summary: Dict
    wall_s: float
    # one decision per request under a KID gate (empty ungated); rejected
    # requests appear here and not in completions
    decisions: Dict[int, AdmissionDecision] = \
        dataclasses.field(default_factory=dict)

    @property
    def rejected(self) -> Dict[int, AdmissionDecision]:
        return {rid: d for rid, d in self.decisions.items() if not d.served}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything a :class:`ServeEngine` is, minus the server model.

    ``device`` is where the slot array and the models live: CUDA by default,
    and the engine raises without a card unless ``device="cpu"``.
    ``ticks_per_dispatch`` (k) is the window depth: admission and retirement
    happen at window boundaries only.  ``finish_mode`` accepts only
    ``"drain"`` for now (the streamed finisher arrives later).
    ``num_classes`` > 0 makes the engine CONDITIONAL: models are called
    ``model(x, t, y)`` (label ``num_classes`` is the null one) and requests
    may name guided samplers.  ``admission`` is an optional KID gate,
    calibrated for the same T; the engine binds its server model and menu
    into it and shares it with the scheduler.
    """

    sched: DiffusionSchedule
    image_shape: Any
    slots: int = 32
    scheduler: Any = None
    clip: float = 3.0
    step_backend: BackendLike = None
    samplers: Optional[Dict[str, Sampler]] = None
    flops_per_call: Optional[float] = None
    ticks_per_dispatch: int = 1
    finish_mode: str = "drain"
    device: Any = "cuda"
    num_classes: int = 0
    admission: Optional[AdmissionPolicy] = None

    def __post_init__(self):
        object.__setattr__(self, "image_shape", tuple(self.image_shape))
        if self.slots < 1:
            raise ValueError(f"slots={self.slots} must be >= 1")
        if not 1 <= self.ticks_per_dispatch <= 512:
            raise ValueError(f"ticks_per_dispatch={self.ticks_per_dispatch} "
                             "outside [1, 512]")
        if self.finish_mode != "drain":
            raise ValueError(f"finish_mode={self.finish_mode!r}: only "
                             "'drain' is ported so far")
        if self.num_classes < 0:
            raise ValueError(f"num_classes={self.num_classes} < 0")
        for name, s in (self.samplers or {}).items():
            if s.trajectory.T != self.sched.T:
                raise ValueError(f"sampler {name!r} built for T="
                                 f"{s.trajectory.T}, engine schedule has "
                                 f"T={self.sched.T}")
            if s.guided and self.num_classes == 0:
                raise ValueError(
                    f"sampler {name!r} is guided (w={s.w:g}) but "
                    "num_classes == 0: classifier-free guidance needs a "
                    "conditional engine (EngineConfig(num_classes=N))")
        if self.admission is not None and \
                self.admission.sched.T != self.sched.T:
            raise ValueError(f"admission policy calibrated for T="
                             f"{self.admission.sched.T}, engine schedule "
                             f"has T={self.sched.T}")


@dataclasses.dataclass
class _Lanes:
    """The host's record of the slot array, one entry a lane: trajectory
    position, retire position, menu row and liveness; the owning request,
    its image and seed; the conditional-serving state (label, guided-pair
    partner, primary flag) and the shadow flag of a pair's uncond lane."""

    pos: np.ndarray
    end: np.ndarray
    traj: np.ndarray
    active: np.ndarray
    req: np.ndarray
    img: np.ndarray
    seed: np.ndarray
    y: np.ndarray
    pair: np.ndarray
    cond: np.ndarray
    shadow: np.ndarray

    @classmethod
    def empty(cls, n: int, null_label: int) -> "_Lanes":
        return cls(pos=np.zeros(n, np.int64), end=np.zeros(n, np.int64),
                   traj=np.zeros(n, np.int64), active=np.zeros(n, bool),
                   req=np.full(n, -1, np.int64), img=np.full(n, -1, np.int64),
                   seed=np.zeros(n, np.int64),
                   y=np.full(n, null_label, np.int64),
                   pair=np.arange(n, dtype=np.int64),
                   cond=np.ones(n, bool), shadow=np.zeros(n, bool))

    def free(self, lane: int, null_label: int) -> None:
        """Return a retired lane to the idle state: solo, null label."""
        self.req[lane] = self.img[lane] = -1
        self.y[lane] = null_label
        self.pair[lane] = lane
        self.cond[lane] = True
        self.shadow[lane] = False


class ServeEngine:
    """Fixed-capacity slot array + k-tick windows + boundary retire/refill.
    ``ServeEngine(EngineConfig(...), server_model)``, then :meth:`serve`."""

    def __init__(self, config: EngineConfig, server_model: torch.nn.Module):
        cfg = config
        self.config = cfg
        self.device = resolve_device(cfg.device)
        check_on_device(server_model, self.device, "server model")
        self.sched = cfg.sched
        self.server_model = server_model
        self.image_shape = cfg.image_shape
        self.slots = cfg.slots
        self.scheduler = cfg.scheduler if cfg.scheduler is not None \
            else FIFOScheduler()
        self.clip = cfg.clip
        self.backend = get_backend(cfg.step_backend)
        self.ticks_per_dispatch = cfg.ticks_per_dispatch
        self.num_classes = cfg.num_classes
        self._conditional = cfg.num_classes > 0
        self.samplers = dict(cfg.samplers) if cfg.samplers is not None \
            else default_samplers(self.sched.T)
        if getattr(self.scheduler, "samplers", None) is None:
            self.scheduler.samplers = self.samplers
        else:
            assert_same_menu(self.scheduler.samplers, self.samplers,
                             "scheduler", "engine")
        self._bind_admission(cfg.admission)
        # the sampler menu as data: every trajectory's (5, K) table
        # concatenated column-wise on the device (gathered per lane by
        # column), each trajectory's first column, and the padded timestep
        # rows the model conditions on (host side)
        self._traj_ids = {n: i for i, n in enumerate(self.samplers)}
        menu = list(self.samplers.values())
        lens = [s.K for s in menu]
        self._kmax = max(lens)
        ts_pad = np.ones((len(menu), self._kmax), np.int32)
        for i, s in enumerate(menu):
            ts_pad[i, :s.K] = s.trajectory.timesteps
        self._menu = {
            "tables": torch.cat([s.tables(self.sched) for s in menu],
                                dim=1).to(self.device),
            "offsets": np.cumsum([0] + lens[:-1]).astype(np.int64),
            "ts_pad": ts_pad,
        }
        # a tick with a guided pair takes guided_masked_index_step (its solo
        # lanes step on their raw ε̂: mixed traffic is one step a tick); an
        # all-solo tick takes the masked step the combine reduces to there
        self._lane_tick = make_lane_tick(
            functools.partial(self.backend.masked_index_step, clip=self.clip),
            functools.partial(self.backend.guided_masked_index_step,
                              clip=self.clip),
            self._kmax, conditional=self._conditional)
        n_params = sum(p.numel() for p in server_model.parameters())
        # forward-only proxy, as the reference: ~2 FLOP per param per call
        self.flops_per_call = (cfg.flops_per_call
                               if cfg.flops_per_call is not None
                               else 2.0 * n_params)

    def _bind_admission(self, admission: Optional[AdmissionPolicy]) -> None:
        """Share ONE policy between engine and scheduler: the scheduler
        gates at selection, the engine reads each request's effective cut
        from the same cached decisions.  A conditional engine binds the
        null-label view of its model as the unconditional server function
        and the (x, t, y) view as the conditional one."""
        if admission is None:
            admission = getattr(self.scheduler, "admission", None)
        self.admission = admission
        if admission is None:
            return
        if admission.sched.T != self.sched.T:
            raise ValueError(f"admission policy calibrated for T="
                             f"{admission.sched.T}, engine schedule has "
                             f"T={self.sched.T}")
        check_tensor_on_device(admission.calib, self.device,
                               "admission calibration batch")
        model = self.server_model
        if self._conditional:
            nc = self.num_classes

            def uncond(x, t):
                return model(x, t, torch.full(x.shape[:1], nc,
                                              dtype=torch.int64,
                                              device=x.device))
            admission.bind(server_fn=uncond, samplers=self.samplers,
                           cond_server_fn=model)
        else:
            admission.bind(server_fn=model, samplers=self.samplers)
        if getattr(self.scheduler, "admission", None) is None:
            self.scheduler.admission = admission
        if self.scheduler.admission is not admission:
            raise ValueError("engine and scheduler must share one "
                             "AdmissionPolicy")

    # ------------------------------------------------------------------
    def _sampler_of(self, req: Request) -> Sampler:
        if req.sampler not in self.samplers:
            raise ValueError(f"request {req.req_id} names sampler "
                             f"{req.sampler!r}; engine menu: "
                             f"{sorted(self.samplers)}")
        return self.samplers[req.sampler]

    def _decision(self, req: Request) -> Optional[AdmissionDecision]:
        """The (cached) admission decision of a request; None ungated."""
        return self.admission.decide(req) if self.admission is not None \
            else None

    def _effective_cut(self, req: Request) -> int:
        """Trajectory position the request's lanes retire at: the decision's
        effective cut under a KID gate, else the nominal CutPlan cut."""
        d = self._decision(req)
        if d is not None:
            assert d.served, f"request {req.req_id} was rejected " \
                f"({d.describe()}): it has no serving cut"
            return d.effective_cut
        return CutPlan(self.sched.T, req.cut_ratio).cut_index(
            self._sampler_of(req))

    def _steps_of(self, req: Request):
        cut = self._effective_cut(req)
        return cut, self._sampler_of(req).K - cut

    def _lanes_of(self, req: Request) -> int:
        """Slot lanes the request takes: one an image, two if guided."""
        return req.batch * (2 if self._sampler_of(req).guided else 1)

    def _lane_noise(self, source: NoiseSource, lanes: _Lanes, role: str):
        """The lane tick's noise: each stepping lane's draw at its
        trajectory position, zeros for the others, on the engine device.  A
        shadow lane reads its primary's row (which steps with it), so it
        draws nothing."""
        def draw(pos: np.ndarray, stepping: np.ndarray) -> torch.Tensor:
            z = torch.zeros((len(pos),) + self.image_shape)
            for ln in np.nonzero(stepping & ~lanes.shadow)[0]:
                z[ln] = source(int(lanes.seed[ln]), int(lanes.img[ln]), role,
                               int(pos[ln]), self.image_shape)
            return z.to(self.device)
        return draw

    def _admit(self, req: Request, slots: List[int], lanes: _Lanes, x,
               x_T: np.ndarray) -> None:
        """Write one admitted request into its slots.  A guided request's
        ``slots[:b]`` are primaries (the request's label), ``slots[b:]``
        their shadows (the null label, the same x_T), paired both ways."""
        b = req.batch
        idx = np.asarray(slots, np.int64)
        imgs = np.arange(b)
        if self._sampler_of(req).guided:
            imgs = np.concatenate([imgs, imgs])
            x_T = np.concatenate([x_T, x_T])
            lanes.y[idx] = np.concatenate([np.full(b, req.label),
                                           np.full(b, self.num_classes)])
            lanes.pair[idx] = np.concatenate([idx[b:], idx[:b]])
            lanes.cond[idx] = np.arange(2 * b) < b
            lanes.shadow[idx] = np.arange(2 * b) >= b
        lanes.req[idx] = req.req_id
        lanes.img[idx] = imgs
        lanes.seed[idx] = req.seed
        lanes.pos[idx] = 0
        lanes.end[idx] = self._effective_cut(req)
        lanes.traj[idx] = self._traj_ids[req.sampler]
        lanes.active[idx] = True
        x[torch.from_numpy(idx).to(x.device)] = \
            torch.from_numpy(x_T).to(x.device)

    # ------------------------------------------------------------------
    def _serve_server(self, requests: List[Request], source: NoiseSource,
                      max_ticks: Optional[int]) -> ServeResult:
        """Server segment of every request: gate, admit at window
        boundaries, run k-tick windows, retire at boundaries until
        drained."""
        assert len({r.req_id for r in requests}) == len(requests), \
            "duplicate req_ids: completions are keyed by req_id"
        k = self.ticks_per_dispatch
        decisions: Dict[int, AdmissionDecision] = {}
        for r in requests:
            if self._lanes_of(r) > self.slots:    # also fails on bad names
                raise ValueError(f"request {r.req_id} needs "
                                 f"{self._lanes_of(r)} lanes > capacity "
                                 f"{self.slots}")
            d = self._decision(r)                  # cached; gate once here
            if d is not None:
                decisions[r.req_id] = d
        if self.admission is not None:
            self.admission.release_chains()        # the scores stay

        def served(r):
            return r.req_id not in decisions or decisions[r.req_id].served

        # effective cut 0 (c = 1, or bumped to full concealment): complete
        # at arrival with x_mid = x_T; rejected requests still queue, and
        # the select gate drops them
        local_only = collections.deque(sorted(
            (r for r in requests if served(r) and self._effective_cut(r) == 0),
            key=lambda r: r.arrival_tick))
        for r in requests:
            if not served(r) or self._effective_cut(r) > 0:
                self.scheduler.add(r)
        if max_ticks is None:
            span = max((r.arrival_tick for r in requests), default=0)
            total = sum(self._effective_cut(r) for r in requests
                        if served(r))
            max_ticks = span + total + self._kmax + 16 + \
                2 * k * max(1, len(requests))

        S, shape = self.slots, self.image_shape
        x = torch.zeros((S,) + shape, dtype=torch.float32, device=self.device)
        lanes = _Lanes.empty(S, self.num_classes)
        inflight: Dict[int, Dict] = {}
        completions: Dict[int, Completion] = {}
        metrics = ServeMetrics(S)
        metrics.start()
        t0 = time.perf_counter()
        now = 0

        def init_draws(req: Request) -> np.ndarray:
            return np.stack([source(req.seed, i, "init", 0, shape).numpy()
                             for i in range(req.batch)])

        def drain_local(now: int) -> None:
            while local_only and local_only[0].arrival_tick <= now:
                r = local_only.popleft()
                metrics.on_admit(r.req_id, now)
                metrics.on_retire(r.req_id, now)
                completions[r.req_id] = Completion(
                    request=r, x_mid=init_draws(r), admit_tick=now,
                    retire_tick=now)
                self.scheduler.notify_retired(r, now)

        server_noise = self._lane_noise(source, lanes, "server")
        while True:
            # ---- admission: refill freed slots at the boundary ----------
            drain_local(now)
            free = np.nonzero(lanes.req < 0)[0].tolist()
            for req in self.scheduler.select_window(len(free), now, k):
                need = self._lanes_of(req)
                slots, free = free[:need], free[need:]
                self._admit(req, slots, lanes, x, init_draws(req))
                inflight[req.req_id] = {
                    "request": req, "remaining": need, "admit_tick": now,
                    "x_mid": np.zeros((req.batch,) + shape, np.float32)}
                metrics.on_admit(req.req_id, now)
            n_active = int((lanes.req >= 0).sum())
            if n_active == 0:
                if len(self.scheduler) == 0 and not local_only:
                    break
                # idle: jump to the next arrival instead of spinning
                nxt = [self.scheduler.next_arrival()]
                if local_only:
                    nxt.append(local_only[0].arrival_tick)
                target = max(now + 1, min(t for t in nxt if t is not None))
                metrics.on_idle_gap(target - (now + 1))
                now = target
                if now > max_ticks:
                    raise RuntimeError(
                        f"engine exceeded liveness bound ({max_ticks} ticks) "
                        f"with {len(self.scheduler)} queued / 0 in flight")
                continue
            # ---- one window: k lane ticks over every lane ----------------
            done_seq = np.zeros((k, S), bool)
            for j in range(k):
                x, lanes.pos, done = self._lane_tick(
                    self.server_model, self._menu, x, lanes.pos, lanes.end,
                    lanes.traj, lanes.active, server_noise, lanes.y,
                    lanes.pair, lanes.cond)
                lanes.active &= ~done
                done_seq[j] = done
            self._retire(done_seq, x, now, n_active, inflight, lanes,
                         completions, metrics)
            now += k
            if now > max_ticks:
                raise RuntimeError(
                    f"engine exceeded liveness bound ({max_ticks} ticks) "
                    f"with {len(self.scheduler)} queued / "
                    f"{int((lanes.req >= 0).sum())} in flight")
        wall = time.perf_counter() - t0
        # every rejected request was dropped by the select gate
        dropped = {d.req_id for d in self.scheduler.take_rejections()}
        assert dropped == {rid for rid, d in decisions.items()
                           if not d.served}, \
            f"select-gate rejections {sorted(dropped)} disagree with the " \
            "admission decisions"
        summary = metrics.summary(
            wall, self.sched.T, self.flops_per_call, requests,
            steps_of=self._steps_of, decisions=decisions or None,
            guided_of=lambda r: self._sampler_of(r).guided)
        summary["ticks_per_dispatch"] = k
        summary["aging_promotions"] = getattr(self.scheduler,
                                              "aging_promotions", 0)
        return ServeResult(completions=completions, summary=summary,
                           wall_s=wall, decisions=decisions)

    def _retire(self, done_seq, x, start, n_active, inflight, lanes: _Lanes,
                completions, metrics) -> None:
        """Retire-at-boundary bookkeeping of one window: copy the cut
        tensors of the primary lanes that finished in it to the host, record
        each one's boundary lag, free every finished lane, and close
        requests whose last lane retired.  A shadow lane frees its slot but
        emits nothing: a pair is one image."""
        k = done_seq.shape[0]
        boundary = start + k
        metrics.on_window_exact(n_active, done_seq.sum(axis=1))
        done = np.nonzero(done_seq.any(axis=0))[0]
        if not done.size:
            return
        first = done_seq.argmax(axis=0)           # first done tick per lane
        emit = done[~lanes.shadow[done]]
        rows = dict(zip(emit.tolist(), x[torch.from_numpy(emit).to(
            x.device)].cpu().numpy()))
        for lane in done.tolist():
            rec = inflight[int(lanes.req[lane])]
            if lane in rows:
                metrics.on_boundary_lag(int(k - 1 - first[lane]))
                rec["x_mid"][int(lanes.img[lane])] = rows[lane]
            rec["remaining"] -= 1
            if rec["remaining"] == 0:
                r = rec["request"]
                del inflight[r.req_id]
                metrics.on_retire(r.req_id, boundary)
                completions[r.req_id] = Completion(
                    request=r, x_mid=rec["x_mid"],
                    admit_tick=rec["admit_tick"], retire_tick=boundary)
                self.scheduler.notify_retired(r, boundary)
            lanes.free(lane, self.num_classes)

    # ------------------------------------------------------------------
    def _finish_clients(self, result: ServeResult,
                        client_models: Sequence[torch.nn.Module],
                        source: NoiseSource) -> int:
        """Drain finisher: every completion's lanes grouped by client, each
        group stepped by its client's private model through the remaining
        trajectory positions with the shared lane tick, unguided: every
        lane solo, the null label.  Fills ``Completion.x0``; returns the
        number of client groups run."""
        by_client: Dict[int, List] = {}
        for rid in sorted(result.completions):
            comp = result.completions[rid]
            r = comp.request
            if not 0 <= r.client_idx < len(client_models):
                raise ValueError(f"request {r.req_id} names client "
                                 f"{r.client_idx}; {len(client_models)} "
                                 "client models given")
            comp.x0 = np.zeros_like(comp.x_mid)
            for i in range(r.batch):
                by_client.setdefault(r.client_idx, []).append((comp, i))
        for ci in sorted(by_client):
            group = by_client[ci]
            model = client_models[ci]
            check_on_device(model, self.device, f"client model {ci}")
            reqs = [c.request for c, _ in group]
            x = torch.from_numpy(np.stack([c.x_mid[i] for c, i in group]))
            x = x.to(self.device)
            lanes = _Lanes.empty(len(group), self.num_classes)
            lanes.pos[:] = [self._effective_cut(r) for r in reqs]
            lanes.end[:] = [self._sampler_of(r).K for r in reqs]
            lanes.traj[:] = [self._traj_ids[r.sampler] for r in reqs]
            lanes.active[:] = True
            lanes.seed[:] = [r.seed for r in reqs]
            lanes.img[:] = [i for _, i in group]
            noise = self._lane_noise(source, lanes, "client")
            for _ in range(int((lanes.end - lanes.pos).max())):
                x, lanes.pos, _ = self._lane_tick(
                    model, self._menu, x, lanes.pos, lanes.end, lanes.traj,
                    lanes.active, noise, lanes.y, lanes.pair, lanes.cond)
            for (comp, i), row in zip(group, x.cpu().numpy()):
                comp.x0[i] = row
        for comp in result.completions.values():
            comp.client_finished = True
        return len(by_client)

    @torch.inference_mode()
    def serve(self, requests: List[Request],
              client_models: Optional[Sequence[torch.nn.Module]] = None,
              noise: Optional[NoiseSource] = None,
              max_ticks: Optional[int] = None) -> ServeResult:
        """THE entry point: serve the server segment of ``requests`` and,
        when ``client_models`` (one private model per client index) are
        given, finish every completion's client segment.

        ``noise`` is the noise source (default
        :func:`~repro_torch.core.collafuse.lane_normal`); ``max_ticks``
        overrides the liveness bound.  ``completions[req_id].x_mid`` is the
        disclosed tensor at the cut, ``.x0`` the finished images; under a
        KID gate ``decisions`` holds every request's decision."""
        source = noise or lane_normal
        result = self._serve_server(requests, source, max_ticks)
        if client_models is not None:
            t0 = time.perf_counter()
            groups = self._finish_clients(result, client_models, source)
            finish_s = time.perf_counter() - t0
            # the drain finish runs after the server loop's wall timer, so
            # it is added to the wall and throughput recomputed once
            result.wall_s += finish_s
            s = result.summary
            s.update(finish_summary(
                "drain", finish_s, batches=groups,
                lanes=sum(c.request.batch
                          for c in result.completions.values())))
            s["requests_per_s"] = s["served"] / max(result.wall_s, 1e-9)
            s["images_per_s"] = s["images"] / max(result.wall_s, 1e-9)
        return result


# ---------------------------------------------------------------------------
# sequential reference service (the baseline)
# ---------------------------------------------------------------------------
@torch.inference_mode()
def serve_sequential(config: EngineConfig, requests: List[Request],
                     server_model: torch.nn.Module,
                     client_models: Sequence[torch.nn.Module],
                     noise: Optional[NoiseSource] = None) -> Dict[int, Any]:
    """One ``split_sample`` call per request, in arrival order — the
    pre-engine serving path.  Returns {req_id: (x0, x_mid)} on the host."""
    outs = {}
    for r in sorted(requests, key=lambda r: (r.arrival_tick, r.req_id)):
        plan = CutPlan(config.sched.T, r.cut_ratio)
        smp = config.samplers[r.sampler] if config.samplers is not None \
            else None
        x0, x_mid = collafuse.split_sample(
            config.sched, plan, server_model, client_models[r.client_idx],
            r.seed, (r.batch,) + tuple(config.image_shape),
            return_intermediate=True, backend=config.step_backend,
            sampler=smp, noise=noise, device=config.device)
        outs[r.req_id] = (x0.cpu().numpy(), x_mid.cpu().numpy())
    return outs
