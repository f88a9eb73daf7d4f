"""Continuous-batching split-inference engine for the CollaFuse server
(counterpart of ``repro/serve/engine.py``).

* Requests (mixed cut-ratios, batch sizes, arrival ticks and samplers) queue
  in a scheduler and are admitted, at window boundaries, into a fixed array
  of SLOTS, one image ("lane") per slot.
* Every lane walks a trajectory from the engine's sampler menu.  The host
  tracks each lane's trajectory position, so it PLANS a window before the
  device runs it: for each tick, every lane's timestep, table column,
  stepping flag and noise step, written with the lane state into one
  buffer (pinned on the card) that reaches the device in one non-blocking
  copy.  No tick waits on the device and no tick copies from the host.
* A WINDOW is ``ticks_per_dispatch`` (k) masked lane ticks, the reference's
  ``lax.scan``: the admitted lanes' x_T, then per tick the server model on
  the whole slot array, the tick's lane noise and one ``StepBackend``
  masked step (:func:`repro_torch.diffusion.backend.make_lane_tick`), then
  the rows to retire gathered.  On the card each window kind (all lanes
  solo or some guided pairs; noise drawn on the card or staged from the
  host) is one CUDA graph: its first window runs eagerly, then the kind is
  captured and every later window replays it.  On the CPU the same window
  runs eagerly.  A lane reaching its cut mid-window holds x bitwise, so
  retiring at the boundary reads the exact cut tensor at any k; the host's
  (k, slots) done stack gives each lane's exact finish tick.
* Up to ``async_depth`` windows are in flight.  A window's retirement waits
  on the copy of its rows to the host once ``async_depth`` windows are
  queued, and frees its lanes then (the reference's ``pending`` deque).
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
* The client finisher steps every completion's lanes through the rest of
  its trajectory on its client's private model, unguided (every lane solo,
  the null label), each client's lanes in chunks of ``slots`` lanes: every
  client-model call has one width, so a lane's bits do not depend on the
  chunk that carried it.  ``finish_mode="stream"`` (the default) stages
  each retired request by class (sampler, cut) and launches waves of
  ``2·slots`` lanes while later server windows run, on a CUDA stream of its
  own, ``finish_async_depth`` waves in flight; ``"drain"`` finishes
  everything after the server loop.  Both give the same bits.
* ``spare_columns`` preallocates identity columns in the coefficient table;
  :meth:`ServeEngine.register_sampler` writes an ad-hoc sampler into them
  in place, and the captured graphs serve it without a new capture.
* A scheduler built with ``pack=True`` admits step-homogeneous WAVES (same
  sampler, cut and guidance behind the head of the order).  Before each
  dispatch the engine reports the window's class mix
  (``"<sampler>@<effective cut>@<w>"`` lanes), its free lanes and whether
  arrived demand waited, from the host's lane state:
  ``fragmentation_frac`` and ``occupancy_by_class`` in the summary.
* ``EngineConfig.obs`` (:mod:`repro_torch.obs`) adds host-loop spans
  (``admit``, ``dispatch`` with the graph's ``launch`` inside it,
  ``sync_wait``, ``retire``, ``finish_clients``),
  a live metrics registry snapshotted to JSON-lines, per-request
  timelines and ``torch.profiler`` windows.  Spans take the host's clock:
  ``dispatch`` is the host's time to plan, stage and launch a window, and
  the window's device time shows in the ``sync_wait`` of the boundary that
  waits for it.  Obs off is the default and costs nothing; obs on reads no
  device value and changes no launch, copy or capture.

Noise: lane i of a request draws ``source(seed, i, role, step)`` — x_T with
role "init", server steps "server", client steps "client", keyed by the
trajectory position — so lanes never depend on slot, tick or window depth
and :func:`repro_torch.core.collafuse.split_sample_lane` replays each one.
The default source, :data:`~repro_torch.core.collafuse.lane_philox`, draws
inside the window (the ``lane_noise`` kernel on the card); a source without
a batched form (``InjectedNoise``, ``lane_normal``) is drawn on the host and
staged, one more copy a window.  A guided pair's shadow lane steps with its
primary's draw.

POD MODE (``hosts`` > 1): the ``slots`` lanes split into contiguous blocks,
one a host (:func:`repro_torch.parallel.sharding.lane_owners`).  Every host
runs the same deterministic loop over the one shared queue: admission, the
scheduler, packing, the gate and the plan of every lane stay replicated over
all ``slots`` lanes, so every host retires the same lanes at the same
boundary.  Each host keeps the cut tensors of its OWNED lanes only
(``Completion.owned``; an unowned row stays zero) and finishes only those on
the client models, still at width ``slots`` a call.  With ``pod=None`` the
hosts are simulated: one process steps the whole slot array and keeps its
block.  With a pod handle (:func:`repro_torch.launch.mesh.init_pod`) each
host process holds and steps only its block on its own device, no collective
runs inside a window, and a guided pair whose partner lies in another host's
block steps its partner there too as a HALO lane, from the replicated plan
(the same x_T, label and noise), so its combine needs nothing from across
the pod.  At the end of a serve the hosts all-gather the digest of their
schedules (every request's admit and retire tick, ticks, windows) and raise
if any differs.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import collafuse
from repro_torch.core.collafuse import CutPlan, NoiseSource, lane_philox
from repro_torch.device import (check_on_device, check_tensor_on_device,
                                resolve_device)
from repro_torch.diffusion.backend import (N_TABLE_ROWS, BackendLike,
                                           get_backend, make_lane_tick)
from repro_torch.diffusion.sampler import (Sampler, assert_same_menu,
                                           default_samplers)
from repro_torch.diffusion.schedule import DiffusionSchedule
from repro_torch.kernels import ops
from repro_torch.obs import NULL_OBS, Observability, ObsConfig, resolve_obs
from repro_torch.parallel import sharding
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
    owned: Optional[np.ndarray] = None  # [batch] bool: rows this host holds
    #                                     (all True off-pod)


@dataclasses.dataclass
class ServeResult:
    completions: Dict[int, Completion]
    summary: Dict
    wall_s: float
    # one decision per request under a KID gate (empty ungated); rejected
    # requests appear here and not in completions
    decisions: Dict[int, AdmissionDecision] = \
        dataclasses.field(default_factory=dict)
    # per-request lifecycle records (empty unless obs timelines are on)
    timelines: Dict[int, List[Dict]] = dataclasses.field(default_factory=dict)

    @property
    def rejected(self) -> Dict[int, AdmissionDecision]:
        return {rid: d for rid, d in self.decisions.items() if not d.served}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything a :class:`ServeEngine` is, minus the server model.

    ``device`` is where the slot array and the models live: CUDA by default,
    and the engine raises without a card unless ``device="cpu"``.
    ``ticks_per_dispatch`` (k, 1-512) is the window depth: admission and
    retirement happen at window boundaries only.  ``async_depth`` (1-32)
    windows are in flight: 1 waits for each window, 2 plans and launches
    window N+1 while N runs.  ``finish_mode`` is ``"stream"`` (the client
    segment overlaps later server windows) or ``"drain"`` (after the server
    loop); ``finish_async_depth`` (1-32) finish waves are in flight.
    ``spare_columns`` (0-4096) identity columns wait in the coefficient
    table for :meth:`ServeEngine.register_sampler`.  ``cuda_graphs`` runs
    each window on the card as a replayed CUDA graph; False runs it eagerly
    (for measurements that time the kernels inside a tick).  None of these
    changes a completion's bits.  ``num_classes`` > 0 makes the engine
    CONDITIONAL: models are called ``model(x, t, y)`` (label
    ``num_classes`` is the null one) and requests may name guided
    samplers.  ``admission`` is an optional KID gate, calibrated for the
    same T; the engine binds its server model and menu into it and shares
    it with the scheduler.  ``obs`` is None (off, the default), an
    :class:`~repro_torch.obs.ObsConfig` or a shared
    :class:`~repro_torch.obs.Observability`.

    Pod mode: ``hosts`` > 1 splits the lanes into contiguous equal blocks
    (``slots % hosts == 0``) and this engine is host ``host_id``.  ``pod``
    is this host's :class:`~repro_torch.launch.mesh.Pod` handle, whose
    ``hosts`` must match; None simulates the hosts in one process.
    ``host_id`` defaults to the pod's, else 0; an explicit 0 is honoured
    (a None check, not truthiness).

    Model axis: a server model whose parameters are a rank's slices
    (``models/unet.py``'s :func:`~repro_torch.models.unet.shard_unet`) is
    served by its model ranks in lockstep, each running this engine: the
    same lanes, schedule and model calls, each call gathering the
    convolutions' output channels.  Their windows run eagerly: a CUDA
    graph cannot hold the gloo barriers of the ranks' exchange, so
    :class:`ServeEngine` refuses such a model with ``cuda_graphs``.
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
    async_depth: int = 1
    finish_mode: str = "stream"
    finish_async_depth: int = 1
    spare_columns: int = 0
    cuda_graphs: bool = True
    device: Any = "cuda"
    num_classes: int = 0
    admission: Optional[AdmissionPolicy] = None
    obs: Any = None
    hosts: int = 1
    host_id: Optional[int] = None
    pod: Any = None

    def __post_init__(self):
        if self.obs is not None and not (
                isinstance(self.obs, (ObsConfig, Observability))
                or self.obs is NULL_OBS):
            raise TypeError(f"obs must be None, ObsConfig or Observability; "
                            f"got {type(self.obs).__name__}")
        object.__setattr__(self, "image_shape", tuple(self.image_shape))
        if self.slots < 1:
            raise ValueError(f"slots={self.slots} must be >= 1")
        for name, hi in (("ticks_per_dispatch", 512), ("async_depth", 32),
                         ("finish_async_depth", 32)):
            if not 1 <= getattr(self, name) <= hi:
                raise ValueError(f"{name}={getattr(self, name)} outside "
                                 f"[1, {hi}]")
        if self.finish_mode not in ("stream", "drain"):
            raise ValueError(f"finish_mode={self.finish_mode!r} not in "
                             "('stream', 'drain')")
        if not 0 <= self.spare_columns <= 4096:
            raise ValueError(f"spare_columns={self.spare_columns} outside "
                             "[0, 4096]")
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
        if self.hosts < 1:
            raise ValueError(f"hosts={self.hosts} must be >= 1")
        if self.slots % self.hosts:
            raise ValueError(f"slots={self.slots} not divisible by hosts="
                             f"{self.hosts}: lane ownership is contiguous "
                             "equal blocks")
        if self.host_id is not None and not 0 <= self.host_id < self.hosts:
            raise ValueError(f"host_id={self.host_id} outside [0, "
                             f"{self.hosts})")
        if self.pod is not None:
            if self.pod.hosts != self.hosts:
                raise ValueError(f"pod of {self.pod.hosts} hosts, engine "
                                 f"configured for hosts={self.hosts}")
            if self.host_id is not None and self.host_id != self.pod.host_id:
                raise ValueError(f"host_id={self.host_id} but this process "
                                 f"is the pod's host {self.pod.host_id}")

    def resolved_host_id(self) -> int:
        """This engine's host: ``host_id``, else the pod's, else 0."""
        if self.host_id is not None:
            return self.host_id
        return self.pod.host_id if self.pod is not None else 0


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


# ---------------------------------------------------------------------------
# staging: typed fields packed into one byte buffer, one copy to the device
# ---------------------------------------------------------------------------
def _nbytes(dtype, shape) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _layout(fields):
    """Pack ``fields`` ((name, dtype, shape) each) into one byte buffer,
    each field 16-byte aligned.  Returns ({name: (offset, dtype, shape)},
    total bytes)."""
    out, off = {}, 0
    for name, dtype, shape in fields:
        out[name] = (off, dtype, tuple(shape))
        off += -(-_nbytes(dtype, shape) // 16) * 16
    return out, max(off, 16)


def _views(buf: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """Typed views of ``layout``'s fields over the byte tensor ``buf``."""
    return {name: buf[off:off + _nbytes(dt, shape)].view(dt).view(shape)
            for name, (off, dt, shape) in layout.items()}


def _host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A host tensor, pinned when it feeds or drains a CUDA device (PyTorch's
    pinned-memory cache keeps a block until the copies using it are done,
    so the caller may drop it once it has launched them)."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _window_fields(k: int, S: int):
    i64, i32, b = torch.int64, torch.int32, torch.bool
    return [("t", i64, (k, S)), ("step", i64, (k, S)), ("seed", i64, (S,)),
            ("img", i64, (S,)), ("y", i64, (S,)), ("pair", i64, (S,)),
            ("emit", i64, (S,)), ("zero", i64, (S,)), ("cols", i32, (k, S)),
            ("active", b, (k, S)), ("draw", b, (k, S)), ("cond", b, (S,)),
            ("admit", b, (S,))]


def _batched(source: NoiseSource) -> bool:
    """Whether ``source`` draws a batch of lanes on their device."""
    return hasattr(source, "batch")


def _owned_rows(comp: Completion) -> List[int]:
    """The images of ``comp`` this host finishes: the rows it holds."""
    return np.nonzero(comp.owned)[0].tolist()


class _FinishPipeline:
    """The streamed client finisher (``finish_mode="stream"``, counterpart of
    the reference's ``_FinishPipeline``).  At each window boundary the
    engine stages freshly retired requests here (through the scheduler's
    ``on_retired`` hook) into per-class buckets — class = (trajectory, cut,
    K): lanes that run the same number of client steps.  :meth:`flush`
    launches a wave of ``2·slots`` lanes from every bucket that holds one,
    while later server windows are in flight, reaps the waves the device has
    finished without waiting, and waits only while ``finish_async_depth``
    waves are in flight; once the queue has drained the wave threshold
    halves.  :meth:`drain` closes the tail after the server loop, step-sorted
    waves of the leftovers: the only stretch that overlaps no server window,
    so ``overlap_frac = 1 − tail_s / finish_s``."""

    def __init__(self, engine: "ServeEngine",
                 client_models: Sequence[torch.nn.Module],
                 source: NoiseSource, metrics: ServeMetrics):
        self._eng = engine
        self._models = client_models
        self._source = source
        self._metrics = metrics
        self._tracer = engine.obs.tracer
        self._depth = engine.finish_async_depth
        self._wave_lanes = 2 * engine.slots
        self._ready: Dict[tuple, List] = {}     # class -> [(steps, comp)]
        self._staged: Dict[tuple, int] = {}     # staged lanes a class
        self._pending: collections.deque = collections.deque()
        self.batches = 0
        self.lanes = 0
        self.host_s = 0.0                       # host time in the finisher
        self.tail_s = 0.0                       # of it after the server loop

    def stage(self, comp: Completion) -> None:
        r = comp.request
        cut = self._eng._effective_cut(r)
        K = self._eng._sampler_of(r).K
        key = (self._eng._traj_ids[r.sampler], cut, K)
        self._ready.setdefault(key, []).append((K - cut, comp))
        self._staged[key] = self._staged.get(key, 0) + \
            len(_owned_rows(comp))

    def _take_wave(self, key) -> List[Completion]:
        """Pop one wave off a class bucket, whole requests only."""
        bucket, taken, lanes = self._ready[key], [], 0
        while bucket and lanes < self._wave_lanes:
            _, comp = bucket.pop()
            taken.append(comp)
            lanes += len(_owned_rows(comp))
        if not bucket:
            del self._ready[key]
            del self._staged[key]
        else:
            self._staged[key] -= lanes
        return taken

    def _dispatch(self, comps: List[Completion]) -> None:
        lanes = sum(len(_owned_rows(c)) for c in comps)
        with self._tracer.span("client_finish_dispatch",
                               requests=len(comps), lanes=lanes):
            self._pending.append(self._eng._launch_finish(
                comps, self._models, self._source))
        self.batches += 1
        self.lanes += lanes
        self._metrics.on_finish_dispatch(len(comps), lanes)

    def _collect(self) -> None:
        fin = self._pending.popleft()
        with self._tracer.span("client_finish_sync",
                               lanes=len(fin.placement)):
            self._eng._collect_finish(fin)

    def flush(self, queue_drained: bool = False) -> None:
        if not self._ready and not self._pending:
            return
        t0 = time.perf_counter()
        with self._tracer.span("finish_clients", mode="stream"):
            while self._pending and self._pending[0].ready():
                self._collect()
            floor = self._wave_lanes // 2 if queue_drained \
                else self._wave_lanes
            for key in [k for k, n in self._staged.items() if n >= floor]:
                self._dispatch(self._take_wave(key))
                while len(self._pending) >= self._depth:
                    self._collect()
        self.host_s += time.perf_counter() - t0

    def drain(self) -> None:
        if not self._ready and not self._pending:
            return
        t0 = time.perf_counter()
        with self._tracer.span("finish_clients", mode="stream", tail=True):
            rest = sorted((item for b in self._ready.values() for item in b),
                          key=lambda sc: -sc[0])
            self._ready.clear()
            self._staged.clear()
            while rest:
                comps, lanes = [], 0
                while rest and lanes < self._wave_lanes:
                    _, comp = rest.pop(0)
                    comps.append(comp)
                    lanes += len(_owned_rows(comp))
                self._dispatch(comps)
            while self._pending:
                self._collect()
        dt = time.perf_counter() - t0
        self.host_s += dt
        self.tail_s += dt

    def summary(self) -> Dict:
        return finish_summary("stream", self.host_s, self.tail_s,
                              batches=self.batches, lanes=self.lanes)


@dataclasses.dataclass
class _Finish:
    """One launched finish batch of the completions ``comps``: their owned
    rows on their way to ``rows`` (host, in ``placement`` order, each
    (completion, image)) behind ``event``."""

    rows: torch.Tensor
    placement: List
    event: Optional[Any]
    comps: List[Completion]

    def ready(self) -> bool:
        return self.event is None or self.event.query()


class ServeEngine:
    """Fixed-capacity slot array + k-tick windows + boundary retire/refill.
    ``ServeEngine(EngineConfig(...), server_model)``, then :meth:`serve`.

    ``captures`` counts the CUDA graphs captured over the engine's life,
    ``h2d_copies`` the host-to-device copies its server loop made (one a
    window, two with a staged noise source), ``halo_lanes`` the halo lanes
    a pod host stepped, summed over its windows."""

    def __init__(self, config: EngineConfig, server_model: torch.nn.Module):
        cfg = config
        self.config = cfg
        self.device = resolve_device(cfg.device)
        check_on_device(server_model, self.device, "server model")
        if cfg.cuda_graphs and any(hasattr(p, "shard_slices")
                                   for p in server_model.parameters()):
            raise ValueError(
                "a server model sharded over a model axis with "
                "cuda_graphs=True: a CUDA graph cannot hold the gloo "
                "barriers around the model ranks' exchange of each "
                "convolution's channels; run the windows eagerly "
                "(cuda_graphs=False)")
        self.sched = cfg.sched
        self.server_model = server_model
        self.image_shape = cfg.image_shape
        self.slots = cfg.slots
        self.hosts = cfg.hosts
        self.host_id = cfg.resolved_host_id()
        self.pod = cfg.pod
        self._lane_owned = \
            sharding.lane_owners(cfg.slots, cfg.hosts) == self.host_id
        # the device's lanes: every lane off a pod; on a pod host its block
        # (``_own_width``), then on a conditional engine one halo lane for
        # each owned lane's guided partner (``_width``)
        if cfg.pod is not None:
            self._block = sharding.host_block(cfg.slots, cfg.hosts,
                                              self.host_id)
            self._own_width = self._block.stop - self._block.start
            self._width = self._own_width * (2 if cfg.num_classes else 1)
        else:
            self._block = slice(0, cfg.slots)
            self._own_width = self._width = cfg.slots
        self.scheduler = cfg.scheduler if cfg.scheduler is not None \
            else FIFOScheduler()
        self.clip = cfg.clip
        self.backend = get_backend(cfg.step_backend)
        self.ticks_per_dispatch = cfg.ticks_per_dispatch
        self.async_depth = cfg.async_depth
        self.finish_mode = cfg.finish_mode
        self.finish_async_depth = cfg.finish_async_depth
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
        # observability, resolved once: NULL_OBS (falsy, every pillar a
        # cached no-op) when cfg.obs is None
        self.obs = resolve_obs(cfg.obs, host_id=self.host_id)
        if self.admission is not None:
            self.admission.tracer = self.obs.tracer
        self.scheduler.registry = self.obs.registry if self.obs else None
        # the sampler menu as data: every trajectory's (5, K) table
        # concatenated column-wise on the device (gathered per lane by
        # column), then the spare identity columns (c_eps 0, ar 1, σ 0,
        # keep 0, w 0: a stray gather passes x through); on the host each
        # menu row's first column and padded timestep row, which the
        # planner reads
        self._traj_ids = {n: i for i, n in enumerate(self.samplers)}
        menu = list(self.samplers.values())
        lens = [s.K for s in menu]
        self._kmax = max(lens)
        self.spare_columns = cfg.spare_columns
        self._static_names = frozenset(self.samplers)
        self._static_cols = sum(lens)
        n_rows = len(menu) + cfg.spare_columns
        tables = torch.zeros((N_TABLE_ROWS,
                              self._static_cols + cfg.spare_columns))
        tables[:, :self._static_cols] = torch.cat(
            [s.tables(self.sched) for s in menu], dim=1)
        tables[1, self._static_cols:] = 1.0
        self._tables = tables.to(self.device)
        self._offsets = np.zeros(n_rows, np.int64)
        self._offsets[:len(menu)] = np.cumsum([0] + lens[:-1])
        self._ts_pad = np.ones((n_rows, self._kmax), np.int64)
        for i, s in enumerate(menu):
            self._ts_pad[i, :s.K] = s.trajectory.timesteps
        # dynamic menu entries (register_sampler): free column extents,
        # free menu rows, LRU stamps
        self._dyn: Dict[str, Dict] = {}
        self._dyn_rows = list(range(len(menu), n_rows))
        self._dyn_free = [(self._static_cols, cfg.spare_columns)] \
            if cfg.spare_columns else []
        self._use_clock = itertools.count(1)
        self._serving = False
        # a tick with a guided pair takes guided_masked_index_step (its solo
        # lanes step on their raw ε̂: mixed traffic is one step a tick); an
        # all-solo tick takes the masked step the combine reduces to there
        self._lane_tick = make_lane_tick(
            functools.partial(self.backend.masked_index_step, clip=self.clip),
            functools.partial(self.backend.guided_masked_index_step,
                              clip=self.clip),
            conditional=self._conditional)
        # a model-axis rank's slices count as the whole weights they cut
        n_params = sum(math.prod(getattr(p, "full_shape", p.shape))
                       for p in server_model.parameters())
        # forward-only proxy, as the reference: ~2 FLOP per param per call
        self.flops_per_call = (cfg.flops_per_call
                               if cfg.flops_per_call is not None
                               else 2.0 * n_params)
        # the window's static device buffers (made by the first serve) and
        # its graphs, one a kind, sharing one memory pool
        self._plan_layout, self._plan_bytes = _layout(
            _window_fields(self.ticks_per_dispatch, self._width))
        self._x = self._xo = self._plan_buf = self._plan = None
        self._noise = None                   # staged draws, (k + 1, S, ...)
        self._graphs: Dict[tuple, tuple] = {}
        self._pool = None
        self._finish_stream = None
        self.captures = 0
        self.h2d_copies = 0
        self.halo_lanes = 0

    def close(self) -> None:
        """Drop the captured graphs and the window's device buffers, and
        hand their memory back to the card (the engine makes them again if
        it serves once more)."""
        self._graphs.clear()
        self._pool = None
        self._x = self._xo = self._plan_buf = self._plan = None
        self._noise = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

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
    # dynamic sampler menus (EngineConfig.spare_columns)
    # ------------------------------------------------------------------
    def register_sampler(self, name: str, sampler: Sampler) -> int:
        """Register an ad-hoc trajectory into the live engine.  Its (5, K)
        coefficient block is written in place into spare columns of the
        device table the captured graphs read, and its first column and
        padded timestep row fill a spare menu row on the host: no new
        capture.  When the spare region is full, the least recently served
        dynamic entries are evicted (their extents merge with free
        neighbours); static entries never are.  The scheduler's menu and the
        admission policy learn the entry in the same call.  Call it between
        :meth:`serve` calls.  Returns the trajectory id."""
        if self._serving:
            raise RuntimeError("register_sampler must run between serve() "
                               "calls, at a window boundary")
        if self.spare_columns == 0:
            raise ValueError("EngineConfig.spare_columns == 0: no spare "
                             "table columns for dynamic registration")
        if name in self._static_names:
            raise ValueError(f"sampler {name!r} is a static menu entry: "
                             "static trajectories are fixed for the "
                             "engine's life")
        if sampler.trajectory.T != self.sched.T:
            raise ValueError(f"sampler {name!r} built for T="
                             f"{sampler.trajectory.T}, engine schedule has "
                             f"T={self.sched.T}")
        if sampler.guided and not self._conditional:
            raise ValueError(f"sampler {name!r} is guided (w={sampler.w:g}) "
                             "but the engine is unconditional")
        if sampler.K > self._kmax:
            raise ValueError(f"dynamic sampler {name!r} has K={sampler.K} > "
                             f"kmax={self._kmax}: the padded timestep rows "
                             "are as long as the static menu's longest")
        if sampler.K > self.spare_columns:
            raise ValueError(f"dynamic sampler {name!r} needs {sampler.K} "
                             f"columns; only {self.spare_columns} spare "
                             "columns were preallocated")
        if name in self._dyn:
            self._evict(name)             # re-registration replaces in full
        col = self._alloc_extent(sampler.K)
        tid = self._dyn_rows.pop(0)
        self._tables[:, col:col + sampler.K].copy_(
            sampler.tables(self.sched).to(self.device))
        self._offsets[tid] = col
        self._ts_pad[tid] = 1
        self._ts_pad[tid, :sampler.K] = sampler.trajectory.timesteps
        self._dyn[name] = {"tid": tid, "col": col, "K": sampler.K,
                           "stamp": next(self._use_clock)}
        self.samplers[name] = sampler
        self._traj_ids[name] = tid
        sched_menu = getattr(self.scheduler, "samplers", None)
        if sched_menu is not None and sched_menu is not self.samplers:
            sched_menu[name] = sampler
        if self.admission is not None:
            self.admission.register_sampler(name, sampler)
        return tid

    def registered_samplers(self) -> Dict[str, int]:
        """Live dynamic menu entries: name -> trajectory id."""
        return {n: e["tid"] for n, e in self._dyn.items()}

    def _alloc_extent(self, K: int) -> int:
        """First-fit a K-column extent in the spare region, evicting the
        least recently served dynamic entries until one exists."""
        while True:
            for i, (start, length) in enumerate(self._dyn_free):
                if length >= K:
                    if length == K:
                        del self._dyn_free[i]
                    else:
                        self._dyn_free[i] = (start + K, length - K)
                    return start
            lru = min(self._dyn, key=lambda n: self._dyn[n]["stamp"])
            self._evict(lru)

    def _evict(self, name: str) -> None:
        """Drop one dynamic entry: its extent (merged with adjacent free
        ones) and menu row go back, and its name leaves the menus and the
        admission caches.  Its stale columns need no write: no trajectory id
        points at them until the extent is taken again."""
        e = self._dyn.pop(name)
        self._dyn_rows.append(e["tid"])
        merged = []
        for start, length in sorted(self._dyn_free + [(e["col"], e["K"])]):
            if merged and merged[-1][0] + merged[-1][1] == start:
                merged[-1] = (merged[-1][0], merged[-1][1] + length)
            else:
                merged.append((start, length))
        self._dyn_free = merged
        del self.samplers[name]
        del self._traj_ids[name]
        sched_menu = getattr(self.scheduler, "samplers", None)
        if sched_menu is not None and sched_menu is not self.samplers:
            sched_menu.pop(name, None)
        if self.admission is not None:
            self.admission.unregister_sampler(name)

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

    def _admit(self, req: Request, slots: List[int], lanes: _Lanes) -> None:
        """Write one admitted request into the host's lane record (its x_T
        enters the slot array at the start of the next window).  A guided
        request's ``slots[:b]`` are primaries (the request's label),
        ``slots[b:]`` their shadows (the null label, the same x_T), paired
        both ways."""
        b = req.batch
        idx = np.asarray(slots, np.int64)
        imgs = np.arange(b)
        if self._sampler_of(req).guided:
            imgs = np.concatenate([imgs, imgs])
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

    # ------------------------------------------------------------------
    # the window: planned on the host, run from static device buffers
    # ------------------------------------------------------------------
    def _static_buffers(self, staged: bool) -> None:
        if self._x is None:
            S, shape = self._width, self.image_shape
            self._x = torch.zeros((S,) + shape, device=self.device)
            self._xo = torch.zeros_like(self._x)
            self._plan_buf = torch.zeros(self._plan_bytes, dtype=torch.uint8,
                                         device=self.device)
            self._plan = _views(self._plan_buf, self._plan_layout)
        if staged and self._noise is None:
            self._noise = torch.zeros(
                (self.ticks_per_dispatch + 1, self._width) + self.image_shape,
                device=self.device)

    def _plan_window(self, lanes: _Lanes, admitted: np.ndarray,
                     hv: Dict[str, np.ndarray]):
        """Plan one window over every lane of the slot array, advance the
        host's lane record through it and write this host's device lanes'
        part into the host views ``hv``.  Per tick a lane steps while
        ``active & (pos < end)`` at its position clipped to kmax − 1, the
        latch of the lane tick; a shadow lane draws nothing (it borrows its
        primary's noise).  Returns the (k, slots) done stack and the lanes
        whose rows the window emits (finished primaries this host owns), in
        the order of their rows."""
        k, S = self.ticks_per_dispatch, self.slots
        pos, gate = lanes.pos.copy(), lanes.active.copy()
        done_seq = np.zeros((k, S), bool)
        plan = {"t": np.empty((k, S), np.int64),
                "cols": np.empty((k, S), np.int64),
                "step": np.empty((k, S), np.int64),
                "active": np.empty((k, S), bool),
                "draw": np.empty((k, S), bool)}
        for j in range(k):
            stepping = gate & (pos < lanes.end)
            pos_c = np.clip(pos, 0, self._kmax - 1)
            plan["t"][j] = self._ts_pad[lanes.traj, pos_c]
            plan["cols"][j] = self._offsets[lanes.traj] + pos_c
            plan["step"][j] = pos_c
            plan["active"][j] = stepping
            plan["draw"][j] = stepping & ~lanes.shadow
            pos = np.where(stepping, pos + 1, pos)
            done_seq[j] = stepping & (pos >= lanes.end)
            gate = gate & ~done_seq[j]
        lanes.pos, lanes.active = pos, gate
        for name in ("seed", "img", "y", "pair", "cond"):
            plan[name] = getattr(lanes, name)
        plan["admit"] = admitted
        emit = np.nonzero(done_seq.any(axis=0) & ~lanes.shadow
                          & self._lane_owned)[0]
        lmap = self._device_lanes(lanes)
        self.halo_lanes += int((lmap[self._own_width:] >= 0).sum())
        self._localize(plan, emit, lmap, hv)
        return done_seq, emit

    def _device_lanes(self, lanes: _Lanes) -> np.ndarray:
        """The slot-array lane each device lane carries this window, -1 for
        an idle one: every lane off a pod; on a pod host its block, then
        (conditional engine) at ``own_width + j`` the partner of owned lane
        j when that partner lies in another host's block, the HALO lane.
        A pair keeps its halo position for its life."""
        own = np.arange(self._block.start, self._block.stop)
        if self._width == own.size:
            return own
        partner = lanes.pair[own]
        return np.concatenate([own, np.where(self._lane_owned[partner], -1,
                                             partner)])

    def _localize(self, plan: Dict[str, np.ndarray], emit: np.ndarray,
                  lmap: np.ndarray, hv: Dict[str, np.ndarray]) -> None:
        """Write the slot array's ``plan`` for the device lanes ``lmap``
        into ``hv``: each live device lane its lane's entries, with the
        partner index and the emitted rows mapped to device lanes; an idle
        lane stays solo and inactive at the null label."""
        live = lmap >= 0
        src = np.where(live, lmap, 0)
        to_dev = np.full(self.slots, -1, np.int64)
        to_dev[lmap[live]] = np.nonzero(live)[0]
        idle = {"t": 1, "cols": 0, "step": 0, "active": False,
                "draw": False, "seed": 0, "img": 0, "y": self.num_classes,
                "cond": True, "admit": False}
        for name, value in idle.items():
            hv[name][:] = np.where(live, plan[name][..., src], value)
        pair = to_dev[plan["pair"][src]]
        assert (pair[live] >= 0).all(), "a live lane's partner is off-device"
        hv["pair"][:] = np.where(live, pair, np.arange(lmap.size))
        hv["zero"][:] = 0
        hv["emit"][:] = 0
        hv["emit"][:emit.size] = to_dev[emit]

    def _stage_noise(self, source: NoiseSource,
                     hv: Dict[str, np.ndarray]) -> torch.Tensor:
        """A host source's draws for one window: row j < k the tick's
        server draws, row k the admitted lanes' x_T; zeros elsewhere."""
        k, shape = self.ticks_per_dispatch, self.image_shape
        z = _host_buffer((k + 1, self._width) + shape, torch.float32,
                         self.device)
        z.zero_()

        def put(j, ln, role, step):
            z[j, ln] = source(int(hv["seed"][ln]), int(hv["img"][ln]), role,
                              int(step), shape)
        for j in range(k):
            for ln in np.nonzero(hv["draw"][j])[0]:
                put(j, ln, "server", hv["step"][j, ln])
        for ln in np.nonzero(hv["admit"])[0]:
            put(k, ln, "init", 0)
        return z

    def _window(self, guided: bool, source: Optional[NoiseSource]) -> None:
        """One window from the staged plan: the admitted lanes' x_T, k lane
        ticks, the boundary x into the static slot array and the rows to
        retire gathered into the static ``_xo``.  ``source`` draws on the
        device, or is None for draws staged from the host.  It reads and
        writes only the engine's static buffers, so a CUDA graph can hold
        it.  A pod host's solo window steps its own block only; its guided
        one adds the halo lanes, so the model's width is fixed a kind."""
        n = self._width if guided else self._own_width
        P = {name: v[..., :n] for name, v in self._plan.items()}
        shape, k = self.image_shape, self.ticks_per_dispatch
        if source is None:
            z0 = self._noise[k, :n]
        else:
            z0 = source.batch(P["seed"], P["img"], "init", P["zero"],
                              P["admit"], shape)
        x = torch.where(P["admit"].view((-1,) + (1,) * len(shape)), z0,
                        self._x[:n])
        y = P["y"] if self._conditional else None
        for j in range(k):
            z = self._noise[j, :n] if source is None else source.batch(
                P["seed"], P["img"], "server", P["step"][j], P["draw"][j],
                shape)
            x = self._lane_tick(self.server_model, self._tables, x, P["t"][j],
                                P["cols"][j], P["active"][j], z, y,
                                P["pair"], P["cond"], guided)
        self._x[:n].copy_(x)
        torch.index_select(self._x, 0, self._plan["emit"], out=self._xo)

    def _run_window(self, guided: bool,
                    source: Optional[NoiseSource]) -> None:
        """Run one window: eagerly on the CPU (or without graphs); on the
        card the kind's graph, captured after the kind's first window ran
        eagerly on a side stream (that window builds the kernels and lets
        the libraries choose their algorithms, so none of it happens inside
        the capture).  A replay counts each kernel the graph holds as one
        launch; the capture itself counts none."""
        if self.device.type != "cuda" or not self.config.cuda_graphs:
            self._window(guided, source)
            return
        kind = (guided, source)
        hit = self._graphs.get(kind)
        if hit is not None:
            hit[0].replay()
            ops.add_launches(hit[1])
            return
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._window(guided, source)
        main.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            self._window(guided, source)
        after = ops.launch_counts()
        ops.set_launch_counts(before)
        self._graphs[kind] = (graph, {n: after[n] - before[n]
                                      for n in after})
        self.captures += 1

    def _dispatch(self, lanes: _Lanes, admitted: np.ndarray,
                  source: NoiseSource, start: int, n_active: int) -> tuple:
        """Plan, stage and run one window, and start the copy of its
        emitted rows to the host.  Returns the pending window: (done stack,
        emitted lanes, their host rows, the event behind them, start tick,
        lanes in use at its start)."""
        host = _host_buffer(self._plan_bytes, torch.uint8, self.device)
        hv = {n: v.numpy() for n, v in _views(host,
                                              self._plan_layout).items()}
        done_seq, emit = self._plan_window(lanes, admitted, hv)
        batched = _batched(source)
        self._plan_buf.copy_(host, non_blocking=True)
        self.h2d_copies += 1
        if not batched:
            self._noise.copy_(self._stage_noise(source, hv),
                              non_blocking=True)
            self.h2d_copies += 1
        guided = bool((hv["pair"] != np.arange(self._width)).any())
        with self.obs.tracer.span("launch", start_tick=start):
            self._run_window(guided, source if batched else None)
        rows = None
        if emit.size:
            rows = _host_buffer((emit.size,) + self.image_shape,
                                torch.float32, self.device)
            rows.copy_(self._xo[:emit.size], non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return done_seq, emit, rows, event, start, n_active

    def _sync_window(self, win: tuple, inflight, lanes: _Lanes, completions,
                     metrics) -> None:
        """Wait for one window's rows on the host and retire it."""
        done_seq, emit, rows, event, start, n_active = win
        with self.obs.tracer.span("sync_wait", start_tick=start):
            if event is not None:
                event.synchronize()
        host_rows = {} if rows is None else dict(zip(emit.tolist(),
                                                     rows.numpy()))
        self._retire(done_seq, self._x, start, n_active, inflight, lanes,
                     completions, metrics, host_rows)

    def _retire(self, done_seq, x, start, n_active, inflight, lanes: _Lanes,
                completions, metrics, rows) -> None:
        """Retire-at-boundary bookkeeping of one synced window: record each
        emitted lane's cut tensor (``rows``, copied behind the window) and
        boundary lag, free every finished lane, and close requests whose
        last lane retired.  ``x`` is the slot array, where a lane finished
        in this window holds its cut until it is freed here.  A shadow lane
        frees its slot but emits nothing: a pair is one image.  A request's
        exact finish tick (the timeline's ``exact_tick``) is the latest of
        its lanes' first done ticks in the host's plan."""
        del x                     # the retirement reads ``rows``
        k = done_seq.shape[0]
        boundary = start + k
        metrics.on_window_exact(n_active, done_seq.sum(axis=1))
        done = np.nonzero(done_seq.any(axis=0))[0]
        if not done.size:
            return
        first = done_seq.argmax(axis=0)           # first done tick per lane
        with self.obs.tracer.span("retire", start_tick=start,
                                  lanes=int(done.size)):
            for lane in done.tolist():
                rec = inflight[int(lanes.req[lane])]
                if not lanes.shadow[lane]:
                    metrics.on_boundary_lag(int(k - 1 - first[lane]))
                if lane in rows:
                    rec["x_mid"][int(lanes.img[lane])] = rows[lane]
                    rec["owned"][int(lanes.img[lane])] = True
                rec["remaining"] -= 1
                rec["exact_tick"] = max(rec["exact_tick"],
                                        start + int(first[lane]))
                if rec["remaining"] == 0:
                    r = rec["request"]
                    del inflight[r.req_id]
                    metrics.on_retire(r.req_id, boundary)
                    self.obs.request(r.req_id, "retired", tick=boundary,
                                     exact_tick=rec["exact_tick"])
                    completions[r.req_id] = Completion(
                        request=r, x_mid=rec["x_mid"],
                        admit_tick=rec["admit_tick"], retire_tick=boundary,
                        owned=rec["owned"])
                    self.scheduler.notify_retired(r, boundary)
                lanes.free(lane, self.num_classes)

    # ------------------------------------------------------------------
    def _serve_server(self, requests: List[Request], source: NoiseSource,
                      max_ticks: Optional[int],
                      client_models: Optional[Sequence] = None
                      ) -> ServeResult:
        """Server segment of every request: gate, admit at window
        boundaries, run k-tick windows (up to ``async_depth`` in flight),
        retire at boundaries until drained.  With ``client_models`` (stream
        mode) a :class:`_FinishPipeline` finishes retired requests inside
        this loop, and the loop's wall covers both segments."""
        if len({r.req_id for r in requests}) != len(requests):
            raise ValueError("duplicate req_ids: completions are keyed by "
                             "req_id")
        k = self.ticks_per_dispatch
        for r in requests:               # a served dynamic entry is fresh
            if r.sampler in self._dyn:
                self._dyn[r.sampler]["stamp"] = next(self._use_clock)
        obs = self.obs
        tracer = obs.tracer
        obs.timelines.reset()            # lifecycles are per serve() call
        decisions: Dict[int, AdmissionDecision] = {}
        for r in requests:
            if self._lanes_of(r) > self.slots:    # also fails on bad names
                raise ValueError(f"request {r.req_id} needs "
                                 f"{self._lanes_of(r)} lanes > capacity "
                                 f"{self.slots}")
            obs.request(r.req_id, "queued", tick=r.arrival_tick,
                        batch=r.batch, cut_ratio=r.cut_ratio,
                        sampler=r.sampler)
            d = self._decision(r)                  # cached; gate once here
            if d is not None:
                decisions[r.req_id] = d
                obs.request(r.req_id, "scored", action=d.action,
                            kid=d.kid, effective_cut=d.effective_cut)
                if not d.served:
                    obs.request(r.req_id, "rejected")
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
            # a finished lane idles up to k·async_depth ticks until the
            # sync that frees it
            overhead = k * (self.async_depth + 1)
            max_ticks = span + total + self._kmax + 16 + \
                overhead * max(1, len(requests))

        S, shape = self.slots, self.image_shape
        self._static_buffers(staged=not _batched(source))
        self._x.zero_()
        lanes = _Lanes.empty(S, self.num_classes)
        admitted = np.zeros(S, bool)
        inflight: Dict[int, Dict] = {}
        completions: Dict[int, Completion] = {}
        pending: collections.deque = collections.deque()
        metrics = ServeMetrics(S, registry=obs.registry if obs else None)
        # obs plumbing resolved before the loop: the JSON-lines cadence,
        # the profiler windows and the live queue and in-flight gauges
        metrics_path = obs.config.metrics_path if obs else None
        metrics_every = obs.config.metrics_every if obs else 1
        profiler = obs.window_profiler(self.device)
        if obs:
            g_queue = obs.registry.gauge(
                "serve_queue_depth", "requests waiting in the scheduler")
            g_inflight = obs.registry.gauge(
                "serve_inflight_requests", "requests occupying slots")
        windows_synced = 0
        finisher = unsubscribe = None
        if client_models is not None:
            finisher = _FinishPipeline(self, client_models, source, metrics)
            unsubscribe = self.scheduler.on_retired(
                lambda req, tick: finisher.stage(completions[req.req_id]))
        self._serving = True
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
                if obs:
                    obs.request(r.req_id, "admitted", tick=now, local=True)
                    obs.request(r.req_id, "retired", tick=now,
                                exact_tick=now)
                completions[r.req_id] = Completion(
                    request=r, x_mid=init_draws(r), admit_tick=now,
                    retire_tick=now, owned=np.ones(r.batch, bool))
                self.scheduler.notify_retired(r, now)

        def more_server_work() -> bool:
            return bool(pending) or bool((lanes.req >= 0).any()) \
                or len(self.scheduler) > 0 or bool(local_only)

        def sync_oldest() -> None:
            nonlocal windows_synced
            self._sync_window(pending.popleft(), inflight, lanes, completions,
                              metrics)
            windows_synced += 1
            if metrics_path and windows_synced % metrics_every == 0:
                obs.registry.write_jsonl(metrics_path, host=obs.host_id,
                                         window=windows_synced)

        def flush_finisher() -> None:
            if finisher is not None and more_server_work():
                finisher.flush(queue_drained=len(self.scheduler) == 0)

        try:
            while True:
                # ---- admission: refill freed slots at the boundary ------
                with tracer.span("admit", tick=now):
                    drain_local(now)
                    free = np.nonzero(lanes.req < 0)[0].tolist()
                    admits = self.scheduler.select_window(len(free), now, k)
                    for req in admits:
                        need = self._lanes_of(req)
                        slots, free = free[:need], free[need:]
                        self._admit(req, slots, lanes)
                        admitted[slots] = True
                        # the class of the window mix: lanes sharing it
                        # retire at one boundary when admitted together
                        inflight[req.req_id] = {
                            "request": req, "remaining": need,
                            "admit_tick": now, "exact_tick": -1,
                            "cls": f"{req.sampler}@"
                                   f"{self._effective_cut(req)}@"
                                   f"{self._sampler_of(req).w:g}",
                            "x_mid": np.zeros((req.batch,) + shape,
                                              np.float32),
                            "owned": np.zeros(req.batch, bool)}
                        metrics.on_admit(req.req_id, now)
                        if obs:
                            obs.request(req.req_id, "admitted", tick=now,
                                        lanes=[int(x) for x in slots])
                n_active = int((lanes.req >= 0).sum())
                if obs:
                    g_queue.set(len(self.scheduler))
                    g_inflight.set(len(inflight))
                    tracer.counter("serve_occupancy", lanes=n_active,
                                   queued=len(self.scheduler))
                if n_active == 0:
                    if pending:
                        # every lane waits on a window in flight: its sync
                        # frees them; time does not move
                        sync_oldest()
                        flush_finisher()
                        continue
                    if len(self.scheduler) == 0 and not local_only:
                        break
                    # idle: jump to the next arrival instead of spinning
                    nxt = [self.scheduler.next_arrival()]
                    if local_only:
                        nxt.append(local_only[0].arrival_tick)
                    target = max(now + 1, min(t for t in nxt
                                              if t is not None))
                    metrics.on_idle_gap(target - (now + 1))
                    if obs:
                        tracer.instant("idle_jump", from_tick=now,
                                       to_tick=target)
                    now = target
                    if now > max_ticks:
                        raise RuntimeError(
                            f"engine exceeded liveness bound ({max_ticks} "
                            f"ticks) with {len(self.scheduler)} queued / 0 "
                            "in flight")
                    continue
                # ---- the window's class mix and fragmentation, from the
                # host's lane state: free lanes entering a window while
                # arrived demand waits are fragmentation
                mix: Dict[str, int] = {}
                for rec in inflight.values():
                    mix[rec["cls"]] = mix.get(rec["cls"], 0) + \
                        rec["remaining"]
                starved = bool(self.scheduler.arrived(now))
                metrics.on_window_mix(mix, S - n_active, starved, k)
                # ---- one window: k lane ticks over every lane -----------
                if profiler is not None:
                    profiler.before()
                with tracer.span("dispatch", tick=now, lanes=n_active):
                    pending.append(self._dispatch(lanes, admitted, source,
                                                  now, n_active))
                if profiler is not None:
                    profiler.after()
                if obs:
                    for req in admits:
                        obs.request(req.req_id, "first_tick", tick=now)
                admitted[:] = False
                now += k
                # ---- the pipeline down to async_depth - 1 windows -------
                while len(pending) >= self.async_depth:
                    sync_oldest()
                flush_finisher()
                if now > max_ticks:
                    raise RuntimeError(
                        f"engine exceeded liveness bound ({max_ticks} ticks) "
                        f"with {len(self.scheduler)} queued / "
                        f"{int((lanes.req >= 0).sum())} in flight")
        finally:
            self._serving = False
            if unsubscribe is not None:
                unsubscribe()
            if profiler is not None:
                profiler.close()
        if finisher is not None:
            finisher.drain()
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
        summary["async_depth"] = self.async_depth
        summary["aging_promotions"] = getattr(self.scheduler,
                                              "aging_promotions", 0)
        if finisher is not None:
            # the loop's wall covers the streamed segment: throughput is
            # not recomputed
            summary.update(finisher.summary())
            summary["finish_async_depth"] = self.finish_async_depth
        timelines: Dict[int, List[Dict]] = {}
        if obs:
            if metrics_path:
                obs.registry.write_jsonl(metrics_path, host=obs.host_id,
                                         window=windows_synced, final=True)
            path = obs.trace_path_for_host(self.hosts)
            if path:
                obs.tracer.export(path)
            timelines = obs.timelines.snapshot()
        return ServeResult(completions=completions, summary=summary,
                           wall_s=wall, decisions=decisions,
                           timelines=timelines)

    # ------------------------------------------------------------------
    # the client segment: both finish modes launch and collect the same way
    # ------------------------------------------------------------------
    def _launch_finish(self, comps: List[Completion],
                       client_models: Sequence[torch.nn.Module],
                       source: NoiseSource) -> _Finish:
        """Stage and launch the client segment of every owned lane of
        ``comps`` without waiting: each client's lanes in chunks of
        ``slots`` lanes (the single host's width, on a pod host too)
        (padded with idle lanes), a chunk stepped by the lane tick to its
        longest lane's end (finished lanes hold bitwise), every lane solo at
        the null label.  The inputs of all chunks reach the device in one
        copy.  On the card it runs on the finisher's own stream and the rows
        come back to pinned host memory behind an event."""
        W, shape = self.slots, self.image_shape
        by_client: Dict[int, List] = {}
        for comp in comps:
            r = comp.request
            if not 0 <= r.client_idx < len(client_models):
                raise ValueError(f"request {r.req_id} names client "
                                 f"{r.client_idx}; {len(client_models)} "
                                 "client models given")
            for i in _owned_rows(comp):
                by_client.setdefault(r.client_idx, []).append((comp, i))
        chunks = [(ci, group[a:a + W]) for ci, group in sorted(
            by_client.items()) for a in range(0, len(group), W)]
        staged = not _batched(source)
        plans, fields = [], []
        i64, b = torch.int64, torch.bool
        for c, (ci, members) in enumerate(chunks):
            reqs = [comp.request for comp, _ in members]
            pos = np.zeros(W, np.int64)
            end = np.zeros(W, np.int64)
            traj = np.zeros(W, np.int64)
            m = len(members)
            pos[:m] = [self._effective_cut(r) for r in reqs]
            end[:m] = [self._sampler_of(r).K for r in reqs]
            traj[:m] = [self._traj_ids[r.sampler] for r in reqs]
            n = int((end - pos).max())
            plans.append((ci, members, pos, end, traj, n))
            fields += [(f"x{c}", torch.float32, (W,) + shape),
                       (f"t{c}", i64, (n, W)), (f"step{c}", i64, (n, W)),
                       (f"seed{c}", i64, (W,)), (f"img{c}", i64, (W,)),
                       (f"cols{c}", torch.int32, (n, W)),
                       (f"act{c}", b, (n, W))]
            if staged:
                fields.append((f"z{c}", torch.float32, (n, W) + shape))
        layout, nbytes = _layout(fields)
        host = _host_buffer(nbytes, torch.uint8, self.device)
        hv = {n: v.numpy() for n, v in _views(host, layout).items()}
        placement = []
        for c, (ci, members, pos, end, traj, n) in enumerate(plans):
            m = len(members)
            hv[f"x{c}"][:] = 0
            hv[f"seed{c}"][:] = 0
            hv[f"img{c}"][:] = 0
            for j, (comp, i) in enumerate(members):
                hv[f"x{c}"][j] = comp.x_mid[i]
                hv[f"seed{c}"][j] = comp.request.seed
                hv[f"img{c}"][j] = i
                placement.append((comp, i))
            valid = np.arange(W) < m
            for j in range(n):
                stepping = valid & (pos < end)
                pos_c = np.clip(pos, 0, self._kmax - 1)
                hv[f"t{c}"][j] = self._ts_pad[traj, pos_c]
                hv[f"cols{c}"][j] = self._offsets[traj] + pos_c
                hv[f"step{c}"][j] = pos_c
                hv[f"act{c}"][j] = stepping
                if staged:
                    z = hv[f"z{c}"][j]
                    z[:] = 0
                    for ln in np.nonzero(stepping)[0]:
                        z[ln] = source(int(hv[f"seed{c}"][ln]),
                                       int(hv[f"img{c}"][ln]), "client",
                                       int(pos_c[ln]), shape).numpy()
                pos = np.where(stepping, pos + 1, pos)
        rows = _host_buffer((len(placement),) + shape, torch.float32,
                            self.device)
        cuda = self.device.type == "cuda"
        ctx = torch.cuda.stream(self._finish_stream) if cuda \
            else contextlib.nullcontext()
        with ctx:
            dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            dev.copy_(host, non_blocking=True)
            dv = _views(dev, layout)
            y = torch.full((W,), self.num_classes, dtype=i64,
                           device=self.device)
            pair = torch.arange(W, dtype=i64, device=self.device)
            cond = torch.ones((W,), dtype=b, device=self.device)
            off = 0
            for c, (ci, members, _, _, _, n) in enumerate(plans):
                model = client_models[ci]
                check_on_device(model, self.device, f"client model {ci}")
                x = dv[f"x{c}"]
                for j in range(n):
                    z = dv[f"z{c}"][j] if staged else source.batch(
                        dv[f"seed{c}"], dv[f"img{c}"], "client",
                        dv[f"step{c}"][j], dv[f"act{c}"][j], shape)
                    x = self._lane_tick(model, self._tables, x, dv[f"t{c}"][j],
                                        dv[f"cols{c}"][j], dv[f"act{c}"][j],
                                        z, y, pair, cond, False)
                rows[off:off + len(members)].copy_(x[:len(members)],
                                                   non_blocking=True)
                off += len(members)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
        return _Finish(rows=rows, placement=placement, event=event,
                       comps=list(comps))

    def _collect_finish(self, fin: _Finish) -> None:
        """Wait for one finish batch and scatter its rows into the
        completions' ``x0`` (an unowned row stays zero)."""
        if fin.event is not None:
            fin.event.synchronize()
        for comp in fin.comps:
            comp.x0 = np.zeros((comp.request.batch,) + self.image_shape,
                               np.float32)
        for (comp, i), row in zip(fin.placement, fin.rows.numpy()):
            comp.x0[i] = row
        # a request's images all travel in one finish batch
        for comp in fin.comps:
            comp.client_finished = True
            self.obs.request(comp.request.req_id, "client_finished")

    def _finish_clients(self, result: ServeResult,
                        client_models: Sequence[torch.nn.Module],
                        source: NoiseSource) -> None:
        """Drain finisher: every completion's lanes, after the server loop,
        in one launch of :meth:`_launch_finish` (the same chunks of
        ``slots`` lanes as the streamed waves)."""
        comps = [result.completions[rid] for rid in sorted(result.completions)]
        if comps:
            self._collect_finish(self._launch_finish(comps, client_models,
                                                     source))

    @torch.inference_mode()
    def serve(self, requests: List[Request],
              client_models: Optional[Sequence[torch.nn.Module]] = None,
              noise: Optional[NoiseSource] = None,
              max_ticks: Optional[int] = None) -> ServeResult:
        """THE entry point: serve the server segment of ``requests`` and,
        when ``client_models`` (one private model per client index) are
        given, finish every completion's client segment (streamed or after
        the server loop, by ``finish_mode``; the same bits either way).

        ``noise`` is the noise source (default
        :data:`~repro_torch.core.collafuse.lane_philox`); ``max_ticks``
        overrides the liveness bound.  ``completions[req_id].x_mid`` is the
        disclosed tensor at the cut, ``.x0`` the finished images; under a
        KID gate ``decisions`` holds every request's decision."""
        source = noise or lane_philox
        if self.device.type == "cuda" and client_models is not None:
            # the client segment runs on a stream of its own, which sees the
            # models as they stand now
            if self._finish_stream is None:
                self._finish_stream = torch.cuda.Stream(self.device)
            self._finish_stream.wait_stream(
                torch.cuda.current_stream(self.device))
        if client_models is not None and self.finish_mode == "stream":
            result = self._serve_server(requests, source, max_ticks,
                                        client_models)
        else:
            result = self._serve_drained(requests, client_models, source,
                                         max_ticks)
        if self.pod is not None:
            self._check_pod_agrees(result)
        return result

    def _serve_drained(self, requests, client_models, source,
                       max_ticks) -> ServeResult:
        """The server loop, then the drain finisher when ``client_models``
        are given."""
        result = self._serve_server(requests, source, max_ticks)
        if client_models is not None:
            t0 = time.perf_counter()
            with self.obs.tracer.span("finish_clients", mode="drain",
                                      requests=len(result.completions)):
                self._finish_clients(result, client_models, source)
            finish_s = time.perf_counter() - t0
            # the drain finish runs after the server loop's wall timer, so
            # it is added to the wall and throughput recomputed once
            result.wall_s += finish_s
            s = result.summary
            s.update(finish_summary(
                "drain", finish_s, batches=1 if result.completions else 0,
                lanes=sum(len(_owned_rows(c))
                          for c in result.completions.values())))
            s["finish_async_depth"] = self.finish_async_depth
            s["requests_per_s"] = s["served"] / max(result.wall_s, 1e-9)
            s["images_per_s"] = s["images"] / max(result.wall_s, 1e-9)
            if self.obs:
                # the finish span and the client_finished stages landed
                # after the server loop's export
                result.timelines = self.obs.timelines.snapshot()
                path = self.obs.trace_path_for_host(self.hosts)
                if path:
                    self.obs.tracer.export(path)
        return result

    def _check_pod_agrees(self, result: ServeResult) -> None:
        """All-gather every host's :func:`schedule_digest` and raise unless
        they are one: the agreement the reference's gathered done stack
        enforced window by window, checked once a serve."""
        digests = self.pod.all_gather_object(schedule_digest(result))
        bad = [h for h, d in enumerate(digests) if d != digests[0]]
        if bad:
            raise RuntimeError(f"pod hosts {bad} served another schedule "
                               f"than host 0 (host {self.host_id} of "
                               f"{self.hosts}): the hosts' queues differ")


def schedule_digest(result: ServeResult) -> Dict[str, Any]:
    """What every pod host must agree on after a serve: each served
    request's (req_id, admit tick, retire tick), the rejected ids, the
    ticks and the windows."""
    return {"requests": sorted((rid, int(c.admit_tick), int(c.retire_tick))
                               for rid, c in result.completions.items()),
            "rejected": sorted(result.rejected),
            "ticks": int(result.summary["ticks"]),
            "windows": int(result.summary["windows"])}


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
