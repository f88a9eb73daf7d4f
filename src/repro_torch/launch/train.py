"""LM training launcher on one card (counterpart of
``repro/launch/train.py``)::

    python -m repro_torch.launch.train --arch minicpm-2b --steps 8 \
        --batch 4 --seq 256
    python -m repro_torch.launch.train --device cpu --arch yi-6b --reduced \
        --steps 8 --batch 8 --seq 32

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

What it refuses, with a ``ValueError`` before it allocates:

* more than one device (``--devices`` above 1, a mesh other than 1x1) and
  ``--fsdp``: the DTensor mesh and sharded training are ROADMAP.md Queue 1
  item 4.5;
* the vlm and audio archs: the launcher feeds tokens and labels only, as
  the reference's does; ``make_train_step`` trains them with a batch that
  carries their stubbed ``vision_embeds`` or ``cond_embeds``;
* a config whose parameters, gradients and two AdamW moments
  (:func:`train_state_bytes`, 12 bytes a bf16 parameter) exceed the card's
  free memory (on the CPU: ``CPU_STATE_BYTES``), as GLM4-9B's (112.8 GB),
  Granite-3-8B's (100.5 GB) and the full MoE configs' do on an 80 GB card.
  The activations come on top and are not counted: Yi-6B's 72.7 GB and
  Zamba2-7B's 79.2 GB pass on an H100 80GB HBM3 (84.5 GB free) and train
  at a small batch only (Yi-6B at the default 8 x 64 peaked at 74.9 GB).

The default device is CUDA; without a card the launcher raises unless
``--device cpu`` is given.
"""
import argparse

# the most bytes of training state the launcher allocates on the CPU
CPU_STATE_BYTES = 64 << 30
# what the one-card launcher does not train yet
QUEUE = "ROADMAP.md Queue 1 item 4.5, the DTensor mesh"


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices to train on; one card only")
    ap.add_argument("--mesh-shape", default="",
                    help="DxM; only 1x1 (or empty) on one card")
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


def check_one_device(args) -> None:
    """Raise ``ValueError`` for a run on more than one device or with
    FSDP."""
    if args.devices > 1:
        raise ValueError(f"--devices {args.devices}: the launcher trains on "
                         f"one card; several cards are {QUEUE}")
    if args.mesh_shape and args.mesh_shape.lower() != "1x1":
        raise ValueError(f"--mesh-shape {args.mesh_shape}: the launcher "
                         f"trains on one card (1x1); a mesh is {QUEUE}")
    if args.fsdp:
        raise ValueError(f"--fsdp: sharded parameters are {QUEUE}")


def train_state_bytes(cfg) -> int:
    """The bytes of a training state: parameters and gradients in the
    config's dtype, and AdamW's float32 ``mu`` and ``nu``."""
    import torch
    p_bytes = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    return cfg.param_count() * (2 * p_bytes + 2 * 4)


def check_state_fits(cfg, device) -> int:
    """:func:`train_state_bytes`; raises ``ValueError`` when it exceeds the
    card's free memory, or ``CPU_STATE_BYTES`` on the CPU.  The
    activations come on top and are not counted."""
    import torch
    need = train_state_bytes(cfg)
    if device.type == "cuda":
        room = torch.cuda.mem_get_info(device)[0]
        where = f"the card's {room} free bytes"
    else:
        room = CPU_STATE_BYTES
        where = f"the CPU limit of {room} bytes"
    if need > room:
        raise ValueError(
            f"{cfg.arch_id}: {cfg.param_count()} parameters need {need} "
            f"bytes of training state (parameters and gradients in "
            f"{cfg.dtype}, float32 AdamW moments), more than {where}; "
            f"training it needs the state sharded over cards ({QUEUE})")
    return need


def params_tree(model):
    """The parameters as the ``{name: tensor}`` tree a checkpoint holds."""
    return dict(model.named_parameters())


def save_state(path: str, model, opt) -> None:
    """Write ``{"params", "opt"}`` to ``path`` at the state's step."""
    from repro_torch.checkpoint import io as ckpt_io
    ckpt_io.save_checkpoint(path, {"params": params_tree(model), "opt": opt},
                            step=int(opt["step"]))


def restore_state(path: str, model, opt):
    """Read ``path`` into ``model``'s parameters and ``opt`` in place
    (their dtypes and devices); returns the restored tree."""
    import torch

    from repro_torch.checkpoint import io as ckpt_io
    live = {"params": params_tree(model), "opt": opt}
    tree = ckpt_io.restore_checkpoint(path, live)
    with torch.no_grad():
        for name, p in live["params"].items():
            p.copy_(tree["params"][name])
        opt["step"].copy_(tree["opt"]["step"])
        for moment in ("mu", "nu"):
            for name, m in opt[moment].items():
                m.copy_(tree["opt"][moment][name])
    return tree


def main(argv=None):
    """Train; returns ``{"model", "opt", "losses"}`` (the logged
    losses)."""
    args = _parse_args(argv)
    check_one_device(args)
    import time

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("vlm", "audio"):
        raise ValueError(
            f"{args.arch}: a {cfg.family} model needs "
            f"{'vision_embeds' if cfg.family == 'vlm' else 'cond_embeds'} "
            "beside its tokens; the launcher feeds tokens and labels only, "
            "as the reference's does: train it through "
            "launch.steps.make_train_step with stubbed embeddings")
    check_state_fits(cfg, device)
    print(f"arch={args.arch} reduced={args.reduced} mesh=data:1xmodel:1 "
          f"fsdp={args.fsdp} device={device}", flush=True)

    model = tf.init_params(cfg, seed=0, device=device)
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
    step_fn = make_train_step(cfg, opt_cfg, remat=args.remat)

    n = sum(p.numel() for p in model.parameters())
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
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB",
              flush=True)
    assert losses[-1] < losses[0], \
        f"loss did not improve: {losses[0]} -> {losses[-1]}"
    if args.ckpt:
        save_state(args.ckpt, model, opt)
        print(f"saved {args.ckpt}", flush=True)
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"in {time.time() - t0:.1f}s", flush=True)
    return {"model": model, "opt": opt, "losses": losses}


if __name__ == "__main__":
    main()
