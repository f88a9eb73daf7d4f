"""LM training launcher (counterpart of ``repro/launch/train.py``)::

    python -m repro_torch.launch.train --arch minicpm-2b --steps 8 \
        --batch 4 --seq 256
    python -m repro_torch.launch.train --device cpu --arch yi-6b --reduced \
        --steps 8 --batch 8 --seq 32
    python -m repro_torch.launch.train --device cpu --arch yi-6b --reduced \
        --devices 4 --mesh-shape 2x2 --fsdp --steps 8 --batch 8 --seq 32

Runs real training steps of an architecture: weights drawn from seed 0
(``init_params``), ``token_batches`` (the reference's structured synthetic
data), ``launch/steps.py``'s ``make_train_step`` (``lm_loss`` through plain
PyTorch, autograd, ``apply_updates_`` in place) with ``AdamWConfig(lr=
--lr)``; it prints the loss every ``--log-every`` steps and the last (on
a card also the peak device memory), and asserts that the loss fell, as
the reference does.  ``--reduced`` trains
the config's tiny member; without it the full config, as in the reference.

``--ckpt`` saves the parameters and the AdamW state after the last step
through ``checkpoint/io.py`` (``{"params", "opt"}``; the reference's help
says "params+opt", but it writes the parameters only); ``--resume``
restores both before the first step and skips the batches the checkpoint's
steps consumed, so a run resumed from a run of N steps goes on as one run
would (bitwise on the CPU).

``--devices N --mesh-shape DxM`` trains on a (data, model) mesh of N
ranks, processes started with the ``spawn`` start method, each in its own
session and killed at a deadline (``launch/mesh.py``'s ``run_ranks``):
tensor parallelism over ``model``, the batch's rows over ``data``, and with
``--fsdp`` the parameters, gradients and moments sharded over ``data`` too
(``launch/steps.py``).  A rank owns a card over NCCL when the machine has
a card a rank, else the ranks share card 0 ("gloo+ipc": NCCL refuses two
ranks on one GPU); on the CPU the group is gloo.  Rank 0 prints
``mesh=data:Dxmodel:M`` and the transport.  ``--ckpt`` writes the
one-card format, gathered on rank 0; ``--resume`` restores it onto any
mesh, every family on any (data, model) shape.

What it refuses, with a ``ValueError`` before it allocates:

* the vlm and audio archs: the launcher feeds tokens and labels only, as
  the reference's does; ``make_train_step`` trains them with a batch that
  carries their stubbed ``vision_embeds`` or ``cond_embeds``;
* a config whose parameters, gradients and two AdamW moments
  (:func:`train_state_bytes`, 12 bytes a bf16 parameter; on a mesh the
  rank's shards) exceed the card's free memory, or the rank's share of it
  when ranks share a card (on the CPU: ``CPU_STATE_BYTES``), as GLM4-9B's
  (112.8 GB), Granite-3-8B's (100.5 GB) and the full MoE configs' do on one
  80 GB card.  The activations come on top and are not counted: Yi-6B's
  72.7 GB and Zamba2-7B's 79.2 GB pass on an H100 80GB HBM3 (84.5 GB free)
  and train at a small batch only (Yi-6B at the default 8 x 64 peaked at
  74.9 GB).

The default device is CUDA; without a card the launcher raises unless
``--device cpu`` is given.
"""
import argparse

# the most bytes of training state the launcher allocates on the CPU
CPU_STATE_BYTES = 64 << 30
# the deadline of a mesh run's ranks
MESH_TIMEOUT_S = 3000.0


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices (ranks) to train on; 0 = one")
    ap.add_argument("--mesh-shape", default="",
                    help="DxM; empty = every device on the data axis")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--ckpt", default="",
                    help="save final params+opt to this .npz path")
    ap.add_argument("--resume", default="", help="restore from .npz path")
    return ap.parse_args(argv)


def mesh_dims(args):
    """(D, M) of the run: ``--mesh-shape`` over ``--devices``."""
    from repro_torch.launch.mesh import host_mesh
    return host_mesh(args.mesh_shape, args.devices or None)


def train_state_bytes(cfg, ctx=None, fsdp: bool = False) -> int:
    """The bytes of a training state: parameters and gradients in the
    config's dtype, and AdamW's float32 ``mu`` and ``nu``; on a mesh
    (``ctx``) the rank's shards of them."""
    import torch
    p_bytes = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    return local_params(cfg, ctx, fsdp) * (2 * p_bytes + 2 * 4)


def local_params(cfg, ctx=None, fsdp: bool = False) -> int:
    """The parameters a rank holds: all without a mesh, else its shards
    under ``param_specs``."""
    if ctx is None or ctx.mesh is None:
        return cfg.param_count()
    import math

    from repro_torch.launch.specs import params_abstract
    from repro_torch.parallel import sharding as shd
    shapes = {n: p.shape for n, p in params_abstract(cfg).items()}
    specs = shd.param_specs(shapes, ctx, fsdp=fsdp)
    return sum(math.prod(shd.local_shape(shapes[n], specs[n], ctx.mesh))
               for n in shapes)


def card_room(device, ctx=None):
    """(bytes a rank may allocate, its description): the card's free
    memory, shared out among the ranks when they share the card; on the
    CPU ``CPU_STATE_BYTES``."""
    import torch
    if device.type != "cuda":
        return CPU_STATE_BYTES, f"the CPU limit of {CPU_STATE_BYTES} bytes"
    room = torch.cuda.mem_get_info(device)[0]
    if ctx is not None and ctx.mesh is not None and \
            ctx.mesh.transport == "gloo+ipc":
        n = ctx.mesh.world
        return room // n, f"a 1/{n} share of the card's {room} free bytes"
    return room, f"the card's {room} free bytes"


def check_state_fits(cfg, device, ctx=None, fsdp: bool = False) -> int:
    """:func:`train_state_bytes`; raises ``ValueError`` when it exceeds
    :func:`card_room`.  The activations come on top and are not
    counted."""
    need = train_state_bytes(cfg, ctx, fsdp)
    room, where = card_room(device, ctx)
    if need > room:
        raise ValueError(
            f"{cfg.arch_id}: {cfg.param_count()} parameters need {need} "
            f"bytes of training state a rank (parameters and gradients in "
            f"{cfg.dtype}, float32 AdamW moments), more than {where}; "
            "shard it over more cards (--devices, --mesh-shape, --fsdp)")
    return need


def params_tree(model):
    """The parameters as the ``{name: tensor}`` tree a checkpoint holds."""
    return dict(model.named_parameters())


def save_state(path: str, model, opt, ctx=None) -> None:
    """Write ``{"params", "opt"}`` to ``path`` at the state's step, in the
    one-card format: on a mesh every rank gathers the whole leaves and rank
    0 writes them."""
    from repro_torch.checkpoint import io as ckpt_io
    tree = {"params": params_tree(model), "opt": opt}
    if ctx is not None and ctx.mesh is not None:
        from repro_torch.models.transformer import full_state, gather_full
        specs, mesh = model.param_specs, ctx.mesh
        tree = {"params": full_state(model, ctx),
                "opt": {"step": opt["step"], **{
                    m: {n: gather_full(t, specs[n], mesh)
                        for n, t in opt[m].items()}
                    for m in ("mu", "nu")}}}
        if any(mesh.coords.values()):
            return
    ckpt_io.save_checkpoint(path, tree, step=int(opt["step"]))


def restore_state(path: str, model, opt):
    """Read ``path`` (the one-card format) into ``model``'s parameters and
    ``opt`` in place (their dtypes and devices), each leaf cut to the
    slice the parameter holds on a mesh; returns the restored tree."""
    import torch

    from repro_torch.checkpoint import io as ckpt_io
    live = {"params": params_tree(model), "opt": opt}
    tree = ckpt_io.restore_checkpoint(path, live)

    def cut(name, t):
        p = live["params"][name]
        return t[p.shard_slices] if hasattr(p, "shard_slices") else t
    with torch.no_grad():
        for name, p in live["params"].items():
            p.copy_(cut(name, tree["params"][name]))
        opt["step"].copy_(tree["opt"]["step"])
        for moment in ("mu", "nu"):
            for name, m in opt[moment].items():
                m.copy_(cut(name, tree["opt"][moment][name]))
    return tree


def main(argv=None):
    """Train; returns ``{"model", "opt", "losses"}`` (the logged losses)
    on one device, None after a mesh run (its ranks print)."""
    args = _parse_args(argv)
    dims = mesh_dims(args)
    if dims[0] * dims[1] > 1:
        from repro_torch.launch.mesh import run_ranks
        _check_arch(args)
        if args.device == "cuda":
            import torch
            torch.cuda.empty_cache()
        run_ranks(_rank_main, dims[0] * dims[1], (args, dims),
                  timeout_s=MESH_TIMEOUT_S)
        return None
    return _train(args)


def _check_arch(args):
    from repro_torch.configs import get_config
    cfg = get_config(args.arch)
    if cfg.family in ("vlm", "audio"):
        raise ValueError(
            f"{args.arch}: a {cfg.family} model needs "
            f"{'vision_embeds' if cfg.family == 'vlm' else 'cond_embeds'} "
            "beside its tokens; the launcher feeds tokens and labels only, "
            "as the reference's does: train it through "
            "launch.steps.make_train_step with stubbed embeddings")


def _rank_main(rank: int, port: int, args, dims) -> None:
    """One rank of a mesh run: open the mesh, train, close it; ranks
    other than 0 print nothing."""
    from repro_torch.launch.mesh import launcher_rank
    from repro_torch.launch.steps import make_ctx
    with launcher_rank(rank, port, dims, args.device) as mesh:
        _train(args, make_ctx(mesh))


def _train(args, ctx=None):
    """The training run, on one device or (``ctx``) as a rank of a
    mesh."""
    import time

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    mesh = ctx.mesh if ctx is not None else None
    device = mesh.device if mesh is not None else resolve_device(args.device)
    _check_arch(args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    check_state_fits(cfg, device, ctx, args.fsdp)
    where = (f"mesh=data:{ctx.data_size}xmodel:{ctx.model_size} "
             f"transport={mesh.transport}") if mesh is not None else \
        "mesh=data:1xmodel:1"
    print(f"arch={args.arch} reduced={args.reduced} {where} "
          f"fsdp={args.fsdp} device={device}", flush=True)

    model = tf.init_params(cfg, seed=0, device=device, ctx=ctx,
                           fsdp=args.fsdp)
    opt_cfg = adamw.AdamWConfig(lr=args.lr)
    opt = adamw.init_state(params_tree(model), opt_cfg)
    data = token_batches(cfg.vocab_size, args.batch, args.seq,
                         device=device)
    if args.resume:
        restore_state(args.resume, model, opt)
        done = int(opt["step"])
        for _ in range(done):                 # the batches already trained on
            next(data)
        print(f"restored params and optimizer state from {args.resume} "
              f"(step {done})", flush=True)
    step_fn = make_train_step(cfg, opt_cfg, remat=args.remat, ctx=ctx)

    n = cfg.param_count() if mesh is not None else \
        sum(p.numel() for p in model.parameters())
    print(f"params: {n / 1e6:.1f}M; starting {args.steps} steps", flush=True)
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        model, opt, metrics = step_fn(model, opt, next(data))
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"step {i:4d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    if device.type == "cuda":
        print(f"peak device memory{' a rank' if mesh is not None else ''} "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB",
              flush=True)
    assert losses[-1] < losses[0], \
        f"loss did not improve: {losses[0]} -> {losses[-1]}"
    if args.ckpt:
        save_state(args.ckpt, model, opt, ctx)
        print(f"saved {args.ckpt}", flush=True)
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"in {time.time() - t0:.1f}s", flush=True)
    return {"model": model, "opt": opt, "losses": losses}


if __name__ == "__main__":
    main()
