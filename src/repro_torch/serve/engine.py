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
* Requests with no server steps (cut position 0) complete at arrival with
  x_mid = x_T, without a slot.
* The drain finisher runs after the server queue empties: lanes grouped by
  client, each group stepped by its client's private model to the end of
  its trajectory.

Noise: lane i of a request draws ``source(seed, i, role, step)`` — x_T with
role "init", server steps "server", client steps "client", keyed by the
trajectory position — so lanes never depend on slot, tick or window depth
and :func:`repro_torch.core.collafuse.split_sample_lane` replays each one.

Waiting for later slices: async windows, the streamed finisher, spare menu
columns, guidance, admission gating, pod mode and observability.
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
from repro_torch.device import check_on_device, resolve_device
from repro_torch.diffusion.backend import (BackendLike, get_backend,
                                           make_lane_tick)
from repro_torch.diffusion.sampler import (Sampler, assert_same_menu,
                                           default_samplers)
from repro_torch.diffusion.schedule import DiffusionSchedule
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


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything a :class:`ServeEngine` is, minus the server model.

    ``device`` is where the slot array and the models live: CUDA by default,
    and the engine raises without a card unless ``device="cpu"``.
    ``ticks_per_dispatch`` (k) is the window depth: admission and retirement
    happen at window boundaries only.  ``finish_mode`` accepts only
    ``"drain"`` for now (the streamed finisher arrives later).
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
        for name, s in (self.samplers or {}).items():
            if s.trajectory.T != self.sched.T:
                raise ValueError(f"sampler {name!r} built for T="
                                 f"{s.trajectory.T}, engine schedule has "
                                 f"T={self.sched.T}")


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
        self.samplers = dict(cfg.samplers) if cfg.samplers is not None \
            else default_samplers(self.sched.T)
        if getattr(self.scheduler, "samplers", None) is None:
            self.scheduler.samplers = self.samplers
        else:
            assert_same_menu(self.scheduler.samplers, self.samplers,
                             "scheduler", "engine")
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
        self._lane_tick = make_lane_tick(
            functools.partial(self.backend.masked_index_step, clip=self.clip),
            self._kmax)
        n_params = sum(p.numel() for p in server_model.parameters())
        # forward-only proxy, as the reference: ~2 FLOP per param per call
        self.flops_per_call = (cfg.flops_per_call
                               if cfg.flops_per_call is not None
                               else 2.0 * n_params)

    # ------------------------------------------------------------------
    def _sampler_of(self, req: Request) -> Sampler:
        if req.sampler not in self.samplers:
            raise ValueError(f"request {req.req_id} names sampler "
                             f"{req.sampler!r}; engine menu: "
                             f"{sorted(self.samplers)}")
        return self.samplers[req.sampler]

    def _cut_of(self, req: Request) -> int:
        """Trajectory position the request's lanes retire at."""
        return CutPlan(self.sched.T, req.cut_ratio).cut_index(
            self._sampler_of(req))

    def _steps_of(self, req: Request):
        cut = self._cut_of(req)
        return cut, self._sampler_of(req).K - cut

    def _lane_noise(self, source: NoiseSource, seeds: np.ndarray,
                    images: np.ndarray, role: str):
        """The lane tick's noise: each stepping lane's draw at its
        trajectory position, zeros for the others, on the engine device."""
        def draw(pos: np.ndarray, stepping: np.ndarray) -> torch.Tensor:
            z = torch.zeros((len(pos),) + self.image_shape)
            for ln in np.nonzero(stepping)[0]:
                z[ln] = source(int(seeds[ln]), int(images[ln]), role,
                               int(pos[ln]), self.image_shape)
            return z.to(self.device)
        return draw

    # ------------------------------------------------------------------
    def _serve_server(self, requests: List[Request], source: NoiseSource,
                      max_ticks: Optional[int]) -> ServeResult:
        """Server segment of every request: admit at window boundaries, run
        k-tick windows, retire at boundaries until drained."""
        assert len({r.req_id for r in requests}) == len(requests), \
            "duplicate req_ids: completions are keyed by req_id"
        k = self.ticks_per_dispatch
        for r in requests:
            if r.batch > self.slots:
                raise ValueError(f"request {r.req_id} needs {r.batch} lanes "
                                 f"> capacity {self.slots}")
            self._sampler_of(r)                  # fail fast on bad names
        local_only = collections.deque(sorted(
            (r for r in requests if self._cut_of(r) == 0),
            key=lambda r: r.arrival_tick))
        for r in requests:
            if self._cut_of(r) > 0:
                self.scheduler.add(r)
        if max_ticks is None:
            span = max((r.arrival_tick for r in requests), default=0)
            total = sum(self._cut_of(r) for r in requests)
            max_ticks = span + total + self._kmax + 16 + \
                2 * k * max(1, len(requests))

        S, shape = self.slots, self.image_shape
        x = torch.zeros((S,) + shape, dtype=torch.float32, device=self.device)
        pos = np.zeros(S, np.int64)
        end = np.zeros(S, np.int64)
        traj = np.zeros(S, np.int64)
        active = np.zeros(S, bool)
        lane_req = np.full(S, -1, np.int64)
        lane_img = np.full(S, -1, np.int64)
        lane_seed = np.zeros(S, np.int64)
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

        server_noise = self._lane_noise(source, lane_seed, lane_img, "server")
        while True:
            # ---- admission: refill freed slots at the boundary ----------
            drain_local(now)
            free = np.nonzero(lane_req < 0)[0].tolist()
            for req in self.scheduler.select_window(len(free), now, k):
                lanes, free = free[:req.batch], free[req.batch:]
                lane_req[lanes] = req.req_id
                lane_img[lanes] = np.arange(req.batch)
                lane_seed[lanes] = req.seed
                pos[lanes] = 0
                end[lanes] = self._cut_of(req)
                traj[lanes] = self._traj_ids[req.sampler]
                active[lanes] = True
                x[lanes] = torch.from_numpy(init_draws(req)).to(self.device)
                inflight[req.req_id] = {
                    "request": req, "remaining": req.batch,
                    "admit_tick": now,
                    "x_mid": np.zeros((req.batch,) + shape, np.float32)}
                metrics.on_admit(req.req_id, now)
            n_active = int((lane_req >= 0).sum())
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
                x, pos, done = self._lane_tick(
                    self.server_model, self._menu, x, pos, end, traj, active,
                    server_noise)
                active &= ~done
                done_seq[j] = done
            self._retire(done_seq, x, now, n_active, inflight, lane_req,
                         lane_img, completions, metrics)
            now += k
            if now > max_ticks:
                raise RuntimeError(
                    f"engine exceeded liveness bound ({max_ticks} ticks) "
                    f"with {len(self.scheduler)} queued / "
                    f"{int((lane_req >= 0).sum())} in flight")
        wall = time.perf_counter() - t0
        summary = metrics.summary(wall, self.sched.T, self.flops_per_call,
                                  requests, steps_of=self._steps_of)
        summary["ticks_per_dispatch"] = k
        summary["aging_promotions"] = getattr(self.scheduler,
                                              "aging_promotions", 0)
        return ServeResult(completions=completions, summary=summary,
                           wall_s=wall)

    def _retire(self, done_seq, x, start, n_active, inflight, lane_req,
                lane_img, completions, metrics) -> None:
        """Retire-at-boundary bookkeeping of one window: copy the cut
        tensors of the lanes that finished in it to the host, record each
        lane's boundary lag, and close requests whose last lane retired."""
        k = done_seq.shape[0]
        boundary = start + k
        metrics.on_window_exact(n_active, done_seq.sum(axis=1))
        lanes = np.nonzero(done_seq.any(axis=0))[0]
        if not lanes.size:
            return
        first = done_seq.argmax(axis=0)           # first done tick per lane
        rows = x[torch.from_numpy(lanes).to(x.device)].cpu().numpy()
        for row, lane in zip(rows, lanes.tolist()):
            rec = inflight[int(lane_req[lane])]
            metrics.on_boundary_lag(int(k - 1 - first[lane]))
            rec["x_mid"][int(lane_img[lane])] = row
            rec["remaining"] -= 1
            if rec["remaining"] == 0:
                r = rec["request"]
                del inflight[r.req_id]
                metrics.on_retire(r.req_id, boundary)
                completions[r.req_id] = Completion(
                    request=r, x_mid=rec["x_mid"],
                    admit_tick=rec["admit_tick"], retire_tick=boundary)
                self.scheduler.notify_retired(r, boundary)
            lane_req[lane] = lane_img[lane] = -1

    # ------------------------------------------------------------------
    def _finish_clients(self, result: ServeResult,
                        client_models: Sequence[torch.nn.Module],
                        source: NoiseSource) -> int:
        """Drain finisher: every completion's lanes grouped by client, each
        group stepped by its client's private model through the remaining
        trajectory positions with the shared lane tick.  Fills
        ``Completion.x0``; returns the number of client groups run."""
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
            pos = np.array([self._cut_of(r) for r in reqs], np.int64)
            end = np.array([self._sampler_of(r).K for r in reqs], np.int64)
            traj = np.array([self._traj_ids[r.sampler] for r in reqs],
                            np.int64)
            gate = np.ones(len(group), bool)
            noise = self._lane_noise(
                source, np.array([r.seed for r in reqs], np.int64),
                np.array([i for _, i in group], np.int64), "client")
            for _ in range(int((end - pos).max())):
                x, pos, _ = self._lane_tick(model, self._menu, x, pos, end,
                                            traj, gate, noise)
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
        disclosed tensor at the cut, ``.x0`` the finished images."""
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
            s["requests_per_s"] = s["requests"] / max(result.wall_s, 1e-9)
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
