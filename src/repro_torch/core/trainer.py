"""CollaFuse collaborative trainer — the paper's 6-step protocol (Fig. 2);
counterpart of ``repro/core/trainer.py``.

Roles:
* ``server``: ONE shared backbone ε_s, trained on noised samples from ALL
  clients, timesteps t ∈ (t_split, T].
* ``clients[k]``: private model ε_k per client, trained on local data only,
  timesteps t ∈ [1, t_split].

One ``train_round``:
  (1) server triggers each client                      [control flow]
  (2) client runs forward diffusion on a local batch   [cheap, local]
  (3) client uploads (x_t, t, ε) for server-range t    [network hop]
  (4) server takes a gradient step on the shared model [heavy, shared]
  (5) server returns partially-denoised x_{t_split}    [network hop]
  (6) client takes a gradient step on its local model  [local]

Engine modes (``TrainerConfig.batched``):

* **batched** (default): client parameters and optimizer state are stacks
  along a leading client axis ([n_clients, ...] leaves).  Steps 2-4 are one
  pooled server step: every client's upload noised at once and flattened
  client-major into the pooled batch.  Step 6 is one ``torch.func.vmap`` of
  ``grad_and_value`` over ``functional_call`` of the backbone, then the
  stacked AdamW (each client clips on its own norm).
* **looped**: one update per client and host-side pooling; the equivalence
  baseline.  Ragged per-client batches, which cannot stack, always take it.

Draws: every t, ε and label-drop mask is a function of (seed, round,
client, role) (``collafuse.TrainDraws``), so both engines see the same
draws by construction.  Parameters are ``{name: tensor}`` dicts on the
trainer's device; ``model_factory(seed) -> nn.Module`` supplies the
backbone (built on the CPU, its parameters copied to the device; the module
itself stays the CPU template ``functional_call`` runs).  ``obs``
(:mod:`repro_torch.obs`) makes each round a ``train_round`` span and
publishes ``train_rounds_total`` and the round's losses; the losses are
host floats already, so it adds no device sync.

``micro_batch`` runs a step's batch in chunks, one after the other, and
sums their gradients before the step's single AdamW update.  At most
``micro_batch`` images go through one forward and backward: the server's
pooled batch in chunks of ``micro_batch`` images, the vmapped client step
in chunks of ``micro_batch // n_clients`` images a client (at least one),
a looped client's batch in chunks of ``micro_batch``; the last chunk may
be shorter.  Each chunk's loss is weighted by its share of the batch, so
the summed loss is the batch's mean and the clip sees the whole batch's
global norm.  The draws are made for the whole batch before it is cut, so
chunking regroups the arithmetic and changes nothing drawn.  ``None`` (the
default), or a chunk no smaller than the batch, runs the batch in one
piece.

``mesh`` (a :class:`~repro_torch.parallel.comm.Mesh` of processes, the
reference's ``CollaFuseTrainer(mesh=)``) places the batched engine's state
as the reference's specs do, every rank a process of one program: the
client stacks and their AdamW states over the data axes
(``client_stack_specs``: a rank holds its block of clients and updates
only those; with ``n_clients`` not dividing the axes every rank holds and
updates all of them), and the pooled server batch over the data axes
(``pooled_server_batch_specs``: a rank draws and noises only its rows).
The server's parameters and AdamW state are replicated: each rank's
gradient is its rows' mean, all-reduced over the data axes (one flat
buffer) and divided by their size, so the clip sees the global norm and
every rank makes the same update, bit for bit.  ``micro_batch`` chunks a
rank's block.  :meth:`train_round` returns every client's loss on every
rank; :attr:`client_stack`, :attr:`client_params`, :meth:`state_tree`
and :meth:`save` gather the whole state, so a mesh's checkpoint restores
on one process, and :meth:`restore` keeps a rank's block of a whole
checkpoint; :meth:`model_fns`, :meth:`cond_model_fns`,
:meth:`client_model`, :meth:`sample` and :meth:`disclosed` broadcast one
client's parameters from the rank holding them.  All of these are
collective calls: every rank of the data axes makes them.  A model axis
replicates the trainer, as the reference's replicated server does; the
looped engine (and ragged batches) runs replicated on every rank.

:meth:`save` and :meth:`restore` write and read the whole training state
(parameters, AdamW states, the round counter) through
:mod:`repro_torch.checkpoint.io`.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.func import functional_call, grad_and_value, vmap

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import collafuse
from repro_torch.core.collafuse import CutPlan, NoiseSource, TrainDraws
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.diffusion.backend import get_backend
from repro_torch.diffusion.sampler import make_sampler
from repro_torch.diffusion.schedule import DiffusionSchedule, get_schedule
from repro_torch.models.layers import ShardCtx
from repro_torch.obs import resolve_obs
from repro_torch.optim import adamw
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    n_clients: int = 3
    T: int = 50
    cut_ratio: float = 0.8
    schedule: str = "cosine"             # paper: cosine variance schedule
    lr: float = 1e-3                     # paper: 0.001
    grad_clip: float = 1.0
    seed: int = 0
    batched: bool = True                 # vmapped multi-client engine
    step_backend: str = "torch"          # denoise-tick StepBackend (sampling)
    # sampling trajectory: "ddpm" walks the dense chain; "ddim" with
    # sampler_steps = K a strided K-step subsequence at stochasticity eta.
    # Only sample()/disclosed() read these.
    sampler: str = "ddpm"                # "ddpm" | "ddim"
    sampler_steps: int = 0               # 0 = dense (T steps)
    eta: float = 1.0                     # DDIM stochasticity in [0, 1]
    # classifier-free guidance training: num_classes > 0 switches the
    # backbone call to ``model(x_t, t, y)`` and drops each label to the
    # null index ``num_classes`` with probability ``label_drop``
    num_classes: int = 0
    label_drop: float = 0.1              # ignored when num_classes == 0


def member_seed(seed: int, member: int) -> int:
    """The seed ``model_factory`` gets for member 0 (the server) and 1 + k
    (client k)."""
    return collafuse.hash_seed(seed, member)


class CollaFuseTrainer:
    """Holds the server's parameters and the clients' (stacked or listed)
    parameters and AdamW states, and runs protocol rounds."""

    def __init__(self, cfg: TrainerConfig,
                 model_factory: Callable[[int], torch.nn.Module],
                 device: DeviceLike = "cuda",
                 flops_per_call: Optional[float] = None,
                 draws: Any = None, obs=None,
                 micro_batch: Optional[int] = None, mesh=None):
        self.cfg = cfg
        if micro_batch is not None and micro_batch < 1:
            raise ValueError(f"micro_batch={micro_batch}: must be >= 1")
        self.micro_batch = micro_batch
        # on a mesh the rank's device; the data axes (and "pod") place the
        # client stacks and the pooled server batch
        self.mesh = mesh
        self._axes = () if mesh is None else tuple(
            a for a in mesh.axis_names if a in ("pod", "data"))
        self._ranks = 1 if mesh is None else mesh.size(self._axes)
        self._index = 0 if mesh is None else mesh.index(self._axes)
        self._ctx = None if mesh is None else ShardCtx(mesh=mesh,
                                                        batch_axes=self._axes)
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        # None (off), an ObsConfig, or an Observability shared with an
        # engine
        self.obs = resolve_obs(obs)
        if cfg.num_classes < 0:
            raise ValueError("num_classes must be >= 0")
        if not 0.0 <= cfg.label_drop < 1.0:
            raise ValueError("label_drop must be in [0, 1)")
        self._conditional = cfg.num_classes > 0
        self.sched: DiffusionSchedule = get_schedule(cfg.schedule, cfg.T)
        self.plan = CutPlan(cfg.T, cfg.cut_ratio)
        self.step_backend = get_backend(cfg.step_backend)
        self.sampler = (None if cfg.sampler == "ddpm" and not cfg.sampler_steps
                        else make_sampler(cfg.T, cfg.sampler,
                                          cfg.sampler_steps, cfg.eta))
        self.opt_cfg = adamw.AdamWConfig(lr=cfg.lr, grad_clip=cfg.grad_clip)
        self.draws = draws if draws is not None else TrainDraws(cfg.seed)

        modules = [model_factory(member_seed(cfg.seed, m))
                   for m in range(cfg.n_clients + 1)]
        self.template = modules[0]
        self.server_params = self._params_of(modules[0])
        self.server_opt = adamw.init_state(self.server_params, self.opt_cfg)
        # per-client state follows the engine: stacked for the batched
        # engine, a list for the looped one; the accessors convert
        clients = [self._params_of(m) for m in modules[1:]]
        # this rank's clients [lo, hi): a block over the data axes where
        # the client_stack_specs rule shards the stacks, else all
        n = cfg.n_clients
        self._stacks_sharded = cfg.batched and self._ranks > 1 and \
            shd.client_stack_specs({"c": torch.empty((n, 1), device="meta")},
                                   self._ctx)["c"][0] is not None
        w = n // self._ranks if self._stacks_sharded else n
        self._clients = range(self._index * w, self._index * w + w) \
            if self._stacks_sharded else range(n)
        if cfg.batched:
            self._client_stack = adamw.tree_stack(
                [clients[c] for c in self._clients])
            self._client_opt_stack = adamw.init_stacked_state(
                self._client_stack, self.opt_cfg)
            self._client_list = self._client_opt_list = None
        else:
            self._client_list = clients
            self._client_opt_list = [adamw.init_state(p, self.opt_cfg)
                                     for p in clients]
            self._client_stack = self._client_opt_stack = None
        n_params = sum(p.numel() for p in self.server_params.values())
        # forward+backward proxy when no analytic estimate is supplied
        self.flops_per_call = (flops_per_call if flops_per_call is not None
                               else 6.0 * n_params)
        self.metrics_history: List[Dict] = []
        self.round = 0                    # rounds trained; keys the draws
        self._server_loss = collafuse.server_loss_fn(self._apply)
        self._client_loss = collafuse.client_loss_fn(
            self.sched, self._apply, num_classes=cfg.num_classes)

    def _gather_clients(self, tree):
        """A stack tree of this rank's clients made whole over the data
        axes (the tree itself when every rank holds all of them)."""
        if not self._stacks_sharded:
            return tree
        if isinstance(tree, dict):
            return {k: self._gather_clients(v) for k, v in tree.items()}
        return comm.all_gather(tree, self.mesh, self._axes, 0)

    def _keep_clients(self, tree):
        """This rank's block of a whole stack tree."""
        if not self._stacks_sharded:
            return tree
        if isinstance(tree, dict):
            return {k: self._keep_clients(v) for k, v in tree.items()}
        return tree[self._clients.start:self._clients.stop].contiguous()

    def _params_of(self, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
        return {k: v.detach().to(self.device, torch.float32, copy=True)
                for k, v in module.named_parameters()}

    def _apply(self, params, x_t, t, y=None):
        args = (x_t, t) if y is None else (x_t, t, y)
        return functional_call(self.template, params, args)

    # ------------------------------------------------------------------
    # per-client views
    # ------------------------------------------------------------------
    @property
    def client_params(self) -> List[Dict[str, torch.Tensor]]:
        """List view of the per-client parameters; assigning into it does
        not write back (use :meth:`set_client_params`)."""
        if self._client_list is not None:
            return list(self._client_list)
        stack = self.client_stack
        return [adamw.tree_unstack(stack, k)
                for k in range(self.cfg.n_clients)]

    def set_client_params(self, client_idx: int, params) -> None:
        """Replace one client's parameters in whichever representation is
        live (e.g. to inject a restored private model); on a mesh the rank
        that holds the client takes them."""
        if self._client_list is not None:
            self._client_list[client_idx] = {
                k: v.to(self.device, torch.float32) for k, v in params.items()}
            return
        if client_idx not in self._clients:
            return
        stack = {}
        for k, s in self._client_stack.items():
            s = s.clone()
            s[client_idx - self._clients.start] = params[k]
            stack[k] = s
        self._client_stack = stack

    @property
    def client_opts(self) -> List[Any]:
        if self._client_opt_list is not None:
            return list(self._client_opt_list)
        stack = self.client_opt_stack
        return [adamw.tree_unstack(stack, k)
                for k in range(self.cfg.n_clients)]

    @property
    def client_stack(self):
        """[n_clients, ...] stacked view of the client parameters (on a
        mesh gathered whole: every rank reads it)."""
        if self._client_stack is not None:
            return self._gather_clients(self._client_stack)
        return adamw.tree_stack(self._client_list)

    @property
    def client_opt_stack(self):
        if self._client_opt_stack is not None:
            return self._gather_clients(self._client_opt_stack)
        return adamw.tree_stack(self._client_opt_list)

    def _client_param(self, client_idx: int):
        """One client's parameters; where the ranks hold blocks of the
        clients, broadcast over the data axes from the rank holding it (a
        collective: every rank there makes the call)."""
        if self._client_list is not None:
            return self._client_list[client_idx]
        if not self._stacks_sharded:
            return adamw.tree_unstack(self._client_stack, client_idx)
        src, k = divmod(client_idx, len(self._clients))
        # row k of every rank's block: the source's is the client, the
        # others' only the broadcast's buffers
        return {name: comm.broadcast(t, self.mesh, self._axes, src)
                for name, t in adamw.tree_unstack(self._client_stack,
                                                  k).items()}

    # ------------------------------------------------------------------
    # draws
    # ------------------------------------------------------------------
    def _side_draws(self, side: str, rnd: int, batches, labels,
                    clients=None):
        """Per-client (t, eps, drop) of one side of round ``rnd``, on the
        device, for ``clients`` (a range; all of them by default)."""
        out = []
        for k in clients or range(len(batches)):
            x0 = batches[k]
            t, eps, drop = collafuse.side_draws(
                self.draws, self.plan, rnd, k, side, tuple(x0.shape),
                labels is not None, self.cfg.label_drop)
            out.append((t.to(self.device), eps.to(self.device),
                        None if drop is None else drop.to(self.device)))
        return out

    # ------------------------------------------------------------------
    # updates
    # ------------------------------------------------------------------
    def _server_update(self, x_t, t, eps, y, rows_sharded: bool = False):
        """One AdamW step of the server on a batch; with ``rows_sharded``
        the batch is this rank's rows of the pooled batch, and the
        gradient and loss are averaged over the data axes."""
        grads, loss = _chunked_grads(grad_and_value, self._server_loss,
                                     self.server_params, (x_t, t, eps, y),
                                     0, self.micro_batch)
        if rows_sharded:
            grads, loss = self._mean_over_data(grads, loss)
        self.server_params, self.server_opt, m = adamw.apply_updates(
            self.server_params, grads, self.server_opt, self.opt_cfg)
        return loss, m["grad_norm"]

    def _mean_over_data(self, grads, loss):
        """The ranks' gradients and loss averaged over the data axes: one
        all-reduce of a flat buffer, the same bits on every rank."""
        names = list(grads)
        flat = torch.cat([grads[k].reshape(-1) for k in names] +
                         [loss.reshape(1).to(grads[names[0]].dtype)])
        flat = comm.all_reduce(flat, self.mesh, self._axes) / self._ranks
        out, at = {}, 0
        for k in names:
            n = grads[k].numel()
            out[k] = flat[at:at + n].view_as(grads[k])
            at += n
        return out, flat[at]

    def _client_round(self, x0_stack, t, eps, y_stack, drop):
        """Step 6 for every client at once: one vmapped loss and gradient
        over the stacked state, then the stacked AdamW.  Returns the [n]
        losses."""
        # labels and drop masks ride along only where they exist
        extra = tuple(a for a in (y_stack, drop) if a is not None)
        per_client = (None if self.micro_batch is None
                      else max(1, self.micro_batch // x0_stack.shape[0]))
        grads, losses = _chunked_grads(
            lambda f: vmap(grad_and_value(f)), self._client_loss,
            self._client_stack, (x0_stack, t, eps) + extra, 1, per_client)
        (self._client_stack, self._client_opt_stack,
         _) = adamw.apply_updates_stacked(self._client_stack, grads,
                                          self._client_opt_stack,
                                          self.opt_cfg)
        self._client_list = self._client_opt_list = None
        return losses

    def _client_update(self, params, opt, x0, t, eps, y, drop):
        grads, loss = _chunked_grads(grad_and_value, self._client_loss,
                                     params, (x0, t, eps, y, drop), 0,
                                     self.micro_batch)
        params, opt, _ = adamw.apply_updates(params, grads, opt,
                                             self.opt_cfg)
        return params, opt, loss

    # ------------------------------------------------------------------
    # engines
    # ------------------------------------------------------------------
    def train_round(self, client_batches: List[torch.Tensor],
                    client_labels: Optional[List[torch.Tensor]] = None
                    ) -> Dict:
        """One full protocol round over all clients.

        ``client_labels``: per-client int label tensors of shape [b], only
        on a conditional trainer; omitted there, every image trains under
        the null label.
        """
        n = self.cfg.n_clients
        if len(client_batches) != n:
            raise ValueError(f"{len(client_batches)} batches for {n} clients")
        batches = [torch.as_tensor(b).to(self.device, torch.float32)
                   for b in client_batches]
        if client_labels is not None:
            if not self._conditional:
                raise ValueError("labels supplied but "
                                 "TrainerConfig.num_classes == 0")
            if len(client_labels) != n:
                raise ValueError(f"{len(client_labels)} label sets for {n} "
                                 "clients")
            labels = [torch.as_tensor(y).to(self.device, torch.int64)
                      for y in client_labels]
        elif self._conditional:
            labels = [torch.full((b.shape[0],), self.cfg.num_classes,
                                 dtype=torch.int64, device=self.device)
                      for b in batches]
        else:
            labels = None
        uniform = len({tuple(b.shape) for b in batches}) == 1
        rnd = self.round
        with self.obs.tracer.span("train_round", cat="train", round=rnd):
            if self.cfg.batched and uniform:
                metrics = self._train_round_batched(batches, labels)
            else:
                # ragged batches cannot stack on a client axis: the looped
                # engine pools them by concatenation (same results)
                metrics = self._train_round_looped(batches, labels)
        metrics.update(collafuse.flops_split(self.plan, self.flops_per_call,
                                             batches[0].shape[0]))
        self.metrics_history.append(metrics)
        self.round += 1
        if self.obs:
            reg = self.obs.registry
            reg.counter("train_rounds_total",
                        "protocol rounds completed").inc()
            if "server_loss" in metrics:
                reg.gauge("train_server_loss",
                          "shared-backbone loss, last round"
                          ).set(metrics["server_loss"])
            if "client_loss_mean" in metrics:
                reg.gauge("train_client_loss_mean",
                          "mean private-model loss, last round"
                          ).set(metrics["client_loss_mean"])
        return metrics

    def _pool_rows(self, b: int):
        """(this rank's rows of the pooled [n·b] server batch as a range,
        whether they are a block of it): the pooled_server_batch_specs
        rule."""
        n = self.cfg.n_clients * b
        if self._ranks > 1 and shd.pooled_server_batch_specs(
                {"t": torch.empty((n,), device="meta")},
                self._ctx)["t"][0] is not None:
            w = n // self._ranks
            return range(self._index * w, self._index * w + w), True
        return range(n), False

    def _train_round_batched(self, batches, labels) -> Dict:
        rnd = self.round
        x0_stack = torch.stack(batches)
        y_stack = None if labels is None else torch.stack(labels)
        metrics: Dict[str, Any] = {}
        if self.plan.n_server_steps > 0:
            # this rank's rows: the draws and uploads of the clients they
            # fall in, cut to the rows
            b = x0_stack.shape[1]
            rows, sharded = self._pool_rows(b)
            cs = range(rows.start // b, -(-rows.stop // b))
            t, eps, drop = _stack_draws(self._side_draws(
                "server", rnd, batches, labels, cs))
            up = collafuse.make_pooled_server_batch(
                self.sched, x0_stack[cs.start:cs.stop], t, eps,
                None if y_stack is None else y_stack[cs.start:cs.stop],
                drop, self.cfg.num_classes)
            lo = rows.start - cs.start * b
            up = {k: v[lo:lo + len(rows)] for k, v in up.items()}
            s_loss, s_gnorm = self._server_update(up["x_t"], up["t"],
                                                  up["eps"], up.get("y"),
                                                  sharded)
            metrics["server_loss"] = float(s_loss)
            metrics["server_grad_norm"] = float(s_gnorm)
        if self.plan.n_client_steps > 0:
            cs = self._clients
            t, eps, drop = _stack_draws(self._side_draws(
                "client", rnd, batches, labels, cs))
            losses = self._client_round(
                x0_stack[cs.start:cs.stop], t, eps,
                None if y_stack is None else y_stack[cs.start:cs.stop], drop)
            if self._stacks_sharded:
                losses = comm.all_gather(losses.detach(), self.mesh,
                                         self._axes, 0)
            closses = losses.double().cpu().tolist()
            metrics["client_loss_mean"] = sum(closses) / len(closses)
            metrics["client_losses"] = closses
        return metrics

    def _train_round_looped(self, batches, labels) -> Dict:
        """Reference engine: one update per client (O(n_clients)
        dispatches)."""
        rnd = self.round
        ys = labels if labels is not None else [None] * self.cfg.n_clients
        metrics: Dict[str, Any] = {}
        if self.plan.n_server_steps > 0:
            uploads = [collafuse.make_server_batch(self.sched, x0, t, eps, y,
                                                   drop, self.cfg.num_classes)
                       for x0, y, (t, eps, drop) in zip(
                           batches, ys,
                           self._side_draws("server", rnd, batches, labels))]
            # step 4: ONE shared backbone update on the pooled uploads
            pool = {k: torch.cat([u[k] for u in uploads]) for k in uploads[0]}
            s_loss, s_gnorm = self._server_update(pool["x_t"], pool["t"],
                                                  pool["eps"], pool.get("y"))
            metrics["server_loss"] = float(s_loss)
            metrics["server_grad_norm"] = float(s_gnorm)
        if self.plan.n_client_steps > 0:
            closses = []
            clients, opts = self.client_params, self.client_opts
            draws = self._side_draws("client", rnd, batches, labels)
            for k, x0 in enumerate(batches):
                t, eps, drop = draws[k]
                clients[k], opts[k], loss = self._client_update(
                    clients[k], opts[k], x0, t, eps, ys[k], drop)
                closses.append(float(loss))
            if self._client_stack is not None:     # batched trainer on
                self._client_stack = self._keep_clients(   # ragged input
                    adamw.tree_stack(clients))
                self._client_opt_stack = self._keep_clients(
                    adamw.tree_stack(opts))
            else:
                self._client_list = clients
                self._client_opt_list = opts
            metrics["client_loss_mean"] = sum(closses) / len(closses)
            metrics["client_losses"] = closses
        return metrics

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def state_tree(self) -> Dict:
        """The training state as one tree of tensors: the server's
        parameters and AdamW state, and the clients' as [n_clients, ...]
        stacks (whichever engine runs)."""
        return {"server": {"params": self.server_params,
                           "opt": self.server_opt},
                "clients": {"params": self.client_stack,
                            "opt": self.client_opt_stack}}

    def save(self, path: str) -> None:
        """Write :meth:`state_tree` to ``path`` (.npz), the rounds trained
        as its step; on a mesh every rank gathers and the mesh's first
        rank writes."""
        tree = self.state_tree()
        if self.mesh is None or self.mesh.index(self.mesh.axis_names) == 0:
            ckpt_io.save_checkpoint(path, tree, step=self.round)

    def restore(self, path: str) -> None:
        """Read a checkpoint written by :meth:`save` (by a trainer of either
        engine with the same backbone and ``n_clients``) into this trainer:
        parameters and AdamW states bitwise, on this trainer's device, and
        the round counter, so the next round draws what the saved trainer's
        next round would have drawn."""
        tree = ckpt_io.restore_checkpoint(path, self.state_tree())
        self.server_params = tree["server"]["params"]
        self.server_opt = tree["server"]["opt"]
        stack, opt_stack = tree["clients"]["params"], tree["clients"]["opt"]
        if self._client_list is not None:
            n = self.cfg.n_clients
            self._client_list = [_clone_tree(adamw.tree_unstack(stack, c))
                                 for c in range(n)]
            self._client_opt_list = [
                _clone_tree(adamw.tree_unstack(opt_stack, c))
                for c in range(n)]
        else:
            self._client_stack = self._keep_clients(stack)
            self._client_opt_stack = self._keep_clients(opt_stack)
        self.round = ckpt_io.checkpoint_step(path) or 0
        self.metrics_history = []

    # ------------------------------------------------------------------
    # the trained models
    # ------------------------------------------------------------------
    def model_fns(self, client_idx: int):
        """(server_fn, client_fn) with signature ``fn(x_t, t) -> eps_hat``.
        On a conditional trainer both condition on the null label (the ε̂_u
        branch); :meth:`cond_model_fns` gives the conditional ones."""
        sp, cp = self.server_params, self._client_param(client_idx)
        if not self._conditional:
            return (lambda x, t: self._apply(sp, x, t),
                    lambda x, t: self._apply(cp, x, t))
        nc = self.cfg.num_classes

        def null_wrap(params):
            def fn(x, t):
                yn = torch.full(x.shape[:1], nc, dtype=torch.int64,
                                device=x.device)
                return self._apply(params, x, t, yn)
            return fn
        return null_wrap(sp), null_wrap(cp)

    def cond_model_fns(self, client_idx: int):
        """Conditional branches ``fn(x_t, t, y) -> eps_hat`` (ε̂_c)."""
        if not self._conditional:
            raise ValueError("TrainerConfig.num_classes == 0")
        sp, cp = self.server_params, self._client_param(client_idx)
        return (lambda x, t, y: self._apply(sp, x, t, y),
                lambda x, t, y: self._apply(cp, x, t, y))

    def _module(self, params) -> torch.nn.Module:
        m = copy.deepcopy(self.template).to(self.device)
        m.load_state_dict(params)
        return m.eval()

    def server_model(self) -> torch.nn.Module:
        """The server's parameters in a module of their own on the device
        (what ``ServeEngine`` takes)."""
        return self._module(self.server_params)

    def client_model(self, client_idx: int) -> torch.nn.Module:
        return self._module(self._client_param(client_idx))

    def sample(self, seed: int, shape, client_idx: int = 0,
               return_intermediate: bool = False,
               noise: Optional[NoiseSource] = None):
        """Split inference: server prefix + client's private suffix, on the
        configured sampler's trajectory, with the configured step backend
        (``triton`` runs ``ddpm_step`` on the card, ``cuda_masked``
        ``traj_masked_step``)."""
        server_fn, client_fn = self.model_fns(client_idx)
        return collafuse.split_sample(
            self.sched, self.plan, server_fn, client_fn, seed, shape,
            return_intermediate=return_intermediate,
            backend=self.step_backend, sampler=self.sampler, noise=noise,
            device=self.device)

    def disclosed(self, seed: int, x0_client, client_idx: int = 0,
                  noise: Optional[NoiseSource] = None):
        """x at the cut as the server reconstructs it from a client's
        upload (the trajectory point nearest t_split under a strided
        sampler)."""
        server_fn, _ = self.model_fns(client_idx)
        x0 = torch.as_tensor(x0_client).to(self.device, torch.float32)
        return collafuse.disclosed_at_split(
            self.sched, self.plan, server_fn, seed, x0,
            backend=self.step_backend, sampler=self.sampler, noise=noise)


def _pieces(n: int, size: Optional[int]):
    """[(start, stop)] cutting range(n) into pieces of at most ``size``
    (the last one shorter); one piece when ``size`` is None."""
    if size is None or size >= n:
        return [(0, n)]
    return [(lo, min(lo + size, n)) for lo in range(0, n, size)]


def _chunked_grads(transform, loss_fn, params, args, axis: int,
                   size: Optional[int]):
    """(gradients, loss) of ``transform(loss_fn)`` (``grad_and_value``,
    or that under ``vmap``) on a batch along ``axis`` of every tensor of
    ``args`` (None rides along), run in pieces of at most ``size``: each
    piece's loss weighted by its share of the batch, the gradients and
    losses summed, so the sums are the whole batch's mean loss and its
    gradient.  One piece is the plain call."""
    n = args[0].shape[axis]
    pieces = _pieces(n, size)
    if len(pieces) == 1:
        return transform(loss_fn)(params, *args)
    grads = loss = None
    for lo, hi in pieces:
        w = (hi - lo) / n
        part = [None if a is None else a.narrow(axis, lo, hi - lo)
                for a in args]
        g, v = transform(lambda p, *a: w * loss_fn(p, *a))(params, *part)
        if grads is None:
            grads, loss = g, v
        else:
            torch._foreach_add_(list(grads.values()),
                                [g[k] for k in grads])
            loss = loss + v
    return grads, loss


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _stack_draws(per_client):
    """[(t, eps, drop)] per client -> stacked (t, eps, drop)."""
    ts, epss, drops = zip(*per_client)
    return (torch.stack(ts), torch.stack(epss),
            None if drops[0] is None else torch.stack(drops))
