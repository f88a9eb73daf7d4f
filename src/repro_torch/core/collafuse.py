"""CollaFuse: cut-ratio governed split of the DDPM denoising chain
(counterpart of ``repro/core/collafuse.py``): the split losses and upload
builders of training, and split inference.

Counting denoising steps (s = 1 is the noisiest, at t = T), the server runs
the first (1-c)·T steps and the client the remaining c·T on its private
model.  In timestep coordinates the cut falls at t_split = round(c·T); the
partially denoised x at the cut is what the server hands back — the
disclosed tensor.

Noise.  The reference draws every normal from threefry keys (``lane_keys``,
then ``k, k_n = split(k)`` each step).  The port does not reproduce
threefry: each draw is a function of (request seed, image, role, step)
alone, with role ∈ {"init", "server", "client"} and step the trajectory
position (0 for the x_T draw).  A *noise source* is any callable
``source(seed, image, role, step, shape) -> float32 CPU tensor``.
:data:`lane_philox` is the default: a counter-based draw (Philox4x32-10)
that also has a batched form on the device, ``source.batch(seeds, images,
role, steps, active, shape)``, which the serving engine calls inside its
window (the ``lane_noise`` kernel on the card, its plain version on the
CPU, bit for bit the same).  :func:`lane_normal` (a CPU
``torch.Generator``) and :class:`InjectedNoise` (replays given draws: the
parity tests feed it the reference's threefry noise) stay as named sources
without a batched form; the engine stages their draws from the host.
Because a draw never depends on the slot, the tick or the window depth, an
engine lane is replayed by :func:`split_sample_lane`.

Training draws follow the same rule: each is a function of (seed, round,
client, role) alone, with role one of server-t, server-ε, server label
drop, client-t, client-ε and client label drop (:class:`TrainDraws`;
:class:`InjectedTrainDraws` replays given ones).  So the batched and the
looped trainer see the same draws by construction, whatever the order
they ask in.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.diffusion import ddpm
from repro_torch.diffusion.backend import BackendLike
from repro_torch.diffusion.sampler import (Sampler, make_sampler,
                                           sample_trajectory)
from repro_torch.diffusion.schedule import DiffusionSchedule


@dataclasses.dataclass(frozen=True)
class CutPlan:
    """The split of a T-step chain at cut-ratio c."""

    T: int
    cut_ratio: float                       # c ∈ [0, 1]

    def __post_init__(self):
        assert 0.0 <= self.cut_ratio <= 1.0, self.cut_ratio

    @property
    def t_split(self) -> int:
        return int(round(self.cut_ratio * self.T))

    @property
    def server_range(self) -> Tuple[int, int]:
        return (self.t_split + 1, self.T)

    @property
    def client_range(self) -> Tuple[int, int]:
        return (1, self.t_split)

    @property
    def n_server_steps(self) -> int:
        return self.T - self.t_split

    @property
    def n_client_steps(self) -> int:
        return self.t_split

    @property
    def server_fraction(self) -> float:
        return self.n_server_steps / self.T

    def describe(self) -> str:
        return (f"c={self.cut_ratio:.2f}: server denoises t∈({self.t_split},"
                f"{self.T}] ({self.n_server_steps} steps), client t∈[1,"
                f"{self.t_split}] ({self.n_client_steps} steps)")

    def cut_index(self, sampler: Sampler) -> int:
        """Trajectory position of the cut: the server executes positions
        [0, cut_index), the client [cut_index, K)."""
        assert sampler.trajectory.T == self.T, (sampler.trajectory.T, self.T)
        return sampler.trajectory.cut_pos(self.t_split)

    def traj_server_steps(self, sampler: Sampler) -> int:
        return self.cut_index(sampler)

    def traj_client_steps(self, sampler: Sampler) -> int:
        return sampler.K - self.cut_index(sampler)


# ---------------------------------------------------------------------------
# per-lane noise (the counterpart of lane_keys)
# ---------------------------------------------------------------------------
ROLES = {"init": 0, "server": 1, "client": 2}

NoiseSource = Callable[[int, int, str, int, Tuple[int, ...]], torch.Tensor]


def hash_seed(*values: int) -> int:
    """A 63-bit generator seed hashed from non-negative ``values``."""
    ss = np.random.SeedSequence(list(values))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def lane_seed(seed: int, image: int, role: str, step: int) -> int:
    """The generator seed of one draw: a hash of (seed, image, role, step)."""
    return hash_seed(seed, image, ROLES[role], step)


def lane_normal(seed: int, image: int, role: str, step: int,
                shape) -> torch.Tensor:
    """A noise source drawing a standard normal of ``shape`` from a CPU
    ``torch.Generator`` seeded by :func:`lane_seed` — the same numbers on
    every device (the default before :data:`lane_philox`)."""
    g = torch.Generator().manual_seed(lane_seed(seed, image, role, step))
    return torch.randn(tuple(shape), generator=g, dtype=torch.float32)


class LanePhilox:
    """The default noise source: each element is a Philox4x32-10 draw keyed
    by the request seed, counter (element quad, step, image, role), turned
    normal by Box-Muller (:func:`repro_torch.kernels.ops.lane_noise`).  A
    seed must lie in [0, 2^63).

    ``source(seed, image, role, step, shape)`` is one draw on the CPU (the
    kernel's plain version); ``device=`` draws it on another device.
    :meth:`batch` draws one row a lane on the lanes' device, in one launch
    of the kernel on the card."""

    def __call__(self, seed: int, image: int, role: str, step: int, shape,
                 device: DeviceLike = "cpu") -> torch.Tensor:
        dev = torch.device(device)

        def one(v):
            return torch.full((1,), int(v), dtype=torch.int64, device=dev)
        return self.batch(one(seed), one(image), role, one(step),
                          torch.ones((1,), dtype=torch.bool, device=dev),
                          shape)[0]

    def batch(self, seeds, images, role: str, steps, active,
              shape) -> torch.Tensor:
        """(S,) + shape: row s the draw of (seeds[s], images[s], role,
        steps[s]) where ``active``, zeros elsewhere.  seeds, images, steps
        (S,) int64 and active (S,) bool, all on one device."""
        from repro_torch.kernels import ops
        return ops.lane_noise(seeds, images, steps, active, ROLES[role],
                              tuple(shape))


lane_philox = LanePhilox()


class InjectedNoise:
    """A noise source that replays given draws, keyed by
    (seed, image, role, step); a missing key raises ``KeyError``."""

    def __init__(self, draws: Mapping[tuple, np.ndarray]):
        self.draws = draws

    def __call__(self, seed, image, role, step, shape) -> torch.Tensor:
        a = np.asarray(self.draws[(seed, image, role, step)], np.float32)
        return torch.from_numpy(a.reshape(tuple(shape)).copy())


def _batch_noise(source: NoiseSource, seed: int, images, role: str,
                 shape, device: DeviceLike = "cpu"
                 ) -> Callable[[int], torch.Tensor]:
    """Step-noise function of a batch of a request's images: drawn on
    ``device`` by a source with a batched form, else stacked on the CPU."""
    images = list(images)
    if not hasattr(source, "batch"):
        return lambda step: torch.stack(
            [source(seed, i, role, step, shape) for i in images])
    dev = torch.device(device)
    n = len(images)
    seeds = torch.full((n,), seed, dtype=torch.int64, device=dev)
    imgs = torch.tensor(images, dtype=torch.int64, device=dev)
    on = torch.ones((n,), dtype=torch.bool, device=dev)
    return lambda step: source.batch(
        seeds, imgs, role, torch.full((n,), step, dtype=torch.int64,
                                      device=dev), on, shape)


# ---------------------------------------------------------------------------
# training draws (the counterpart of the trainer's key chain)
# ---------------------------------------------------------------------------
TRAIN_ROLES = {"server_t": 0, "server_eps": 1, "server_drop": 2,
               "client_t": 3, "client_eps": 4, "client_drop": 5}
_TRAIN_TAG = 0x747261696E          # keeps training seeds apart from lanes'


def train_seed(seed: int, rnd: int, client: int, role: str) -> int:
    """The generator seed of one training draw: a hash of (seed, round,
    client, role)."""
    return hash_seed(_TRAIN_TAG, seed, rnd, client, TRAIN_ROLES[role])


class TrainDraws:
    """The default training draw source: each draw comes from a CPU
    ``torch.Generator`` seeded by :func:`train_seed`, so every device gets
    the same numbers.  ``side`` is "server" or "client"."""

    def __init__(self, seed: int):
        self.seed = seed

    def _gen(self, rnd, client, role) -> torch.Generator:
        return torch.Generator().manual_seed(
            train_seed(self.seed, rnd, client, role))

    def timesteps(self, rnd, client, side, b, lo, hi) -> torch.Tensor:
        """(b,) int64 uniform on {lo..hi}."""
        return torch.randint(lo, hi + 1, (b,),
                             generator=self._gen(rnd, client, side + "_t"))

    def noise(self, rnd, client, side, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), dtype=torch.float32,
                           generator=self._gen(rnd, client, side + "_eps"))

    def drop(self, rnd, client, side, b, p) -> torch.Tensor:
        """(b,) bool, each True with probability ``p``."""
        return torch.rand((b,), generator=self._gen(
            rnd, client, side + "_drop")) < p


class InjectedTrainDraws:
    """A training draw source that replays given draws, keyed by (round,
    client, role); a missing key raises ``KeyError``."""

    def __init__(self, draws: Mapping[tuple, np.ndarray]):
        self.draws = draws

    def _get(self, rnd, client, role, dtype) -> torch.Tensor:
        return torch.from_numpy(np.array(self.draws[(rnd, client, role)],
                                         dtype))

    def timesteps(self, rnd, client, side, b, lo, hi) -> torch.Tensor:
        return self._get(rnd, client, side + "_t", np.int64).reshape(b)

    def noise(self, rnd, client, side, shape) -> torch.Tensor:
        return self._get(rnd, client, side + "_eps",
                         np.float32).reshape(tuple(shape))

    def drop(self, rnd, client, side, b, p) -> torch.Tensor:
        return self._get(rnd, client, side + "_drop", bool).reshape(b)


def side_draws(source, plan: CutPlan, rnd: int, client: int, side: str,
               shape, labeled: bool, label_drop: float):
    """One client's draws for one side of a round: (t, eps, drop) as CPU
    tensors, t held to the side's range ({t_split+1..T} for the server,
    {1..t_split} for the client).  ``drop`` is None unless the round is
    labeled and ``label_drop`` > 0."""
    lo, hi = plan.server_range if side == "server" else plan.client_range
    b = shape[0]
    t = source.timesteps(rnd, client, side, b, lo, hi)
    if t.shape != (b,) or int(t.min()) < lo or int(t.max()) > hi:
        raise ValueError(f"{side} timesteps {t.tolist()} outside "
                         f"[{lo}, {hi}] or not of shape ({b},)")
    eps = source.noise(rnd, client, side, shape)
    drop = (source.drop(rnd, client, side, b, label_drop)
            if labeled and label_drop > 0.0 else None)
    return t, eps, drop


# ---------------------------------------------------------------------------
# split losses and uploads (training)
# ---------------------------------------------------------------------------
def server_loss_fn(model_fn: Callable):
    """DDPM loss over the samples clients uploaded (protocol steps 3-4): the
    server never touches x_0.  ``model_fn(params, x_t, t[, y]) -> eps_hat``;
    the server range is enforced where the uploads are drawn."""
    def loss(params, x_t, t, eps, y=None):
        eps_hat = (model_fn(params, x_t, t) if y is None
                   else model_fn(params, x_t, t, y))
        return torch.mean(torch.square(eps_hat - eps))
    return loss


def client_loss_fn(sched: DiffusionSchedule, model_fn: Callable,
                   num_classes: int = 0):
    """DDPM loss over the client's private range, from local x_0 and the
    given draws.  With labels ``y`` it trains classifier-free: where
    ``drop`` is True the label becomes the null index ``num_classes``."""
    def loss(params, x0, t, noise, y=None, drop=None):
        if y is None:
            return ddpm.ddpm_loss(
                sched, lambda x_t, tt: model_fn(params, x_t, tt), x0, t,
                noise)[0]
        yd = drop_labels(y, drop, num_classes)
        return ddpm.ddpm_loss(
            sched, lambda x_t, tt: model_fn(params, x_t, tt, yd), x0, t,
            noise)[0]
    return loss


def drop_labels(y, drop, num_classes: int):
    """Classifier-free label dropout: the null index ``num_classes`` where
    ``drop``; ``drop=None`` keeps every label."""
    if drop is None:
        return y
    return torch.where(drop, torch.full_like(y, num_classes), y)


def make_server_batch(sched: DiffusionSchedule, x0, t, eps, y=None,
                      drop=None, num_classes: int = 0):
    """Client-side protocol steps 2-3: noise locally at server-range t and
    emit only (x_t, t, eps) — never x_0 — plus the labels, dropped
    client-side, when there are any."""
    up = {"x_t": ddpm.q_sample(sched, x0, t, eps), "t": t, "eps": eps}
    if y is not None:
        up["y"] = drop_labels(y, drop, num_classes)
    return up


def make_pooled_server_batch(sched: DiffusionSchedule, x0_stack, t_stack,
                             eps_stack, y_stack=None, drop_stack=None,
                             num_classes: int = 0):
    """Protocol steps 2-3 for all clients at once: [n, b, ...] inputs
    flattened client-major to the pooled [n·b, ...] server batch, which is
    the concatenation of the per-client :func:`make_server_batch` uploads
    (the noising is per image)."""
    def flat(a):
        return None if a is None else a.reshape((-1,) + a.shape[2:])
    return make_server_batch(sched, flat(x0_stack), flat(t_stack),
                             flat(eps_stack), flat(y_stack),
                             flat(drop_stack), num_classes)


# ---------------------------------------------------------------------------
# split inference (sampling)
# ---------------------------------------------------------------------------
def _server_segment(sched, plan, sampler, server_fn, noise, x, backend):
    """Server prefix: dense t = T … t_split+1, or trajectory positions
    [0, cut_index) under a sampler."""
    if sampler is None:
        if plan.n_server_steps == 0:
            return x
        return ddpm.sample_range(sched, server_fn, noise, x, plan.T,
                                 plan.t_split + 1, backend=backend)
    return sample_trajectory(sched, sampler, server_fn, noise, x, 0,
                             plan.cut_index(sampler), backend=backend)


def _client_segment(sched, plan, sampler, client_fn, noise, x, backend):
    """Client suffix: dense t = t_split … 1, or positions [cut_index, K)."""
    if sampler is None:
        if plan.n_client_steps == 0:
            return x
        return ddpm.sample_range(sched, client_fn, noise, x, plan.t_split, 1,
                                 backend=backend)
    return sample_trajectory(sched, sampler, client_fn, noise, x,
                             plan.cut_index(sampler), sampler.K,
                             backend=backend)


def split_sample(sched: DiffusionSchedule, plan: CutPlan,
                 server_fn: Callable, client_fn: Callable, seed: int, shape,
                 return_intermediate: bool = False,
                 backend: BackendLike = None,
                 sampler: Optional[Sampler] = None,
                 noise: Optional[NoiseSource] = None,
                 device: DeviceLike = "cuda"):
    """Full CollaFuse generation of ``shape[0]`` images of request ``seed``:
    the client draws x_T, the server denoises down to the cut, the disclosed
    x crosses back, the client finishes.  Image i draws what lane i of the
    serving engine draws.  Returns x_0 (and the disclosed tensor if
    ``return_intermediate``)."""
    dev = resolve_device(device)
    src = noise or lane_philox
    images, img_shape = range(shape[0]), tuple(shape[1:])
    x_t = _batch_noise(src, seed, images, "init", img_shape, dev)(0).to(dev)
    x_mid = _server_segment(sched, plan, sampler, server_fn,
                            _batch_noise(src, seed, images, "server",
                                         img_shape, dev), x_t, backend)
    x0 = _client_segment(sched, plan, sampler, client_fn,
                         _batch_noise(src, seed, images, "client", img_shape,
                                      dev), x_mid, backend)
    if return_intermediate:
        return x0, x_mid
    return x0


def split_sample_lane(sched: DiffusionSchedule, plan: CutPlan,
                      server_fn: Callable, client_fn: Callable, seed: int,
                      image: int, shape, return_intermediate: bool = False,
                      backend: BackendLike = None,
                      sampler: Optional[Sampler] = None,
                      noise: Optional[NoiseSource] = None,
                      device: DeviceLike = "cuda"):
    """Single-image reference for one engine lane: image ``image`` of
    request ``seed``, ``shape`` the image shape (H, W, C).  The serving
    tests compare engine lanes against this."""
    x0, x_mid = split_sample(sched, plan, server_fn, client_fn, seed,
                             (1,) + tuple(shape), True, backend, sampler,
                             _OneImage(noise or lane_philox, image), device)
    if return_intermediate:
        return x0[0], x_mid[0]
    return x0[0]


class _OneImage:
    """View of a noise source whose image 0 is ``image`` (its batched form
    too, where the source has one)."""

    def __init__(self, source: NoiseSource, image: int):
        self.source, self.image = source, image
        if hasattr(source, "batch"):
            self.batch = self._batch

    def __call__(self, seed, _image, role, step, shape):
        return self.source(seed, self.image, role, step, shape)

    def _batch(self, seeds, images, role, steps, active, shape):
        return self.source.batch(seeds, torch.full_like(images, self.image),
                                 role, steps, active, shape)


def disclosure_start(sched: DiffusionSchedule, seed: int, x0_client,
                     noise: Optional[NoiseSource] = None):
    """The start of a disclosure chain: x_0 noised to x_T with the "init"
    draws, and the step-noise function of its "server" draws.  Runs on
    x0_client's device."""
    src = noise or lane_philox
    images, img_shape = range(x0_client.shape[0]), tuple(x0_client.shape[1:])
    dev = x0_client.device
    eps = _batch_noise(src, seed, images, "init", img_shape, dev)(0).to(dev)
    t_top = torch.full((x0_client.shape[0],), sched.T, dtype=torch.int64,
                       device=dev)
    return (ddpm.q_sample(sched, x0_client, t_top, eps),
            _batch_noise(src, seed, images, "server", img_shape, dev))


def disclosed_at_pos(sched: DiffusionSchedule, sampler: Sampler,
                     server_fn: Callable, seed: int, x0_client, pos: int,
                     backend: BackendLike = None,
                     noise: Optional[NoiseSource] = None, cond_fn=None,
                     label: int = 0):
    """What the server could reconstruct of real client images: noise x_0
    to x_T with the "init" draws, then denoise positions [0, pos) on the
    server with the "server" draws.  Runs on x0_client's device.

    On a guided sampler the prefix runs under classifier-free guidance:
    ``cond_fn(x, t, y)`` at ``label`` is the conditional branch,
    ``server_fn`` the unconditional one (see :func:`sample_trajectory`)."""
    assert 0 <= pos <= sampler.K, (pos, sampler.K)
    x_T, server_noise = disclosure_start(sched, seed, x0_client, noise)
    return sample_trajectory(sched, sampler, server_fn, server_noise, x_T, 0,
                             pos, backend=backend, cond_fn=cond_fn,
                             label=label)


def disclosed_at_split(sched: DiffusionSchedule, plan: CutPlan,
                       server_fn: Callable, seed: int, x0_client,
                       backend: BackendLike = None,
                       sampler: Optional[Sampler] = None,
                       noise: Optional[NoiseSource] = None):
    """:func:`disclosed_at_pos` at the plan's cut (the dense chain when
    ``sampler`` is None)."""
    sampler = sampler or make_sampler(plan.T)
    return disclosed_at_pos(sched, sampler, server_fn, seed, x0_client,
                            plan.cut_index(sampler), backend, noise)


# ---------------------------------------------------------------------------
# compute split accounting (paper H2c — GPU energy proxy)
# ---------------------------------------------------------------------------
def flops_split_steps(n_server_steps: int, n_client_steps: int,
                      flops_per_model_call: float, batch: int,
                      guided: bool = False) -> dict:
    """FLOP split from raw per-side step counts.  ``guided`` doubles the
    server segment exactly (a cond+uncond lane pair a server step); the
    client finishes unguided."""
    server = n_server_steps * flops_per_model_call * batch
    if guided:
        server *= 2
    client = n_client_steps * flops_per_model_call * batch
    diffusion_pass = 10.0 * batch  # q_sample: a handful of elementwise ops
    return {
        "server_flops": server,
        "client_flops": client + diffusion_pass,
        "client_fraction": (client + diffusion_pass) /
                           max(server + client + diffusion_pass, 1.0),
    }


def flops_split(plan: CutPlan, flops_per_model_call: float,
                batch: int) -> dict:
    """Denoising FLOPs executed per side for one generated batch, plus the
    client's (cheap) diffusion pass."""
    return flops_split_steps(plan.n_server_steps, plan.n_client_steps,
                             flops_per_model_call, batch)
