"""The paper's healthcare experiment on the port (counterpart of the
reference's ``examples/collafuse_healthcare.py``).

Faithful to §4 of the paper in structure: 3 clients with disjoint
"patient" distributions, one shared server, cosine schedule, fixed lr.
The default size is cut down (32x32 synthetic MRI-like images, T = 50, a
~1.1M-parameter U-Net, batch 32); ``--full`` runs the paper's own
configuration: the 128x128 U-Net (``UNetConfig()``), T = 100 and 150
images a client, whose pooled server batch of 450 runs in chunks of
``--micro-batch`` images (default :data:`FULL_MICRO_BATCH`).

Outputs per run (``<out-dir>/healthcare/c<cut>.json``):
  * KID(client data, generated)      — performance   (paper Fig. 3 left)
  * KID/MSE(client data, x_{t_c})    — disclosure    (paper Fig. 3 right)
  * client/server FLOP split         — energy proxy  (paper H2c)

    python -m repro_torch.examples.collafuse_healthcare --rounds 300
    python -m repro_torch.examples.collafuse_healthcare --full --rounds 10
    python -m repro_torch.examples.collafuse_healthcare --device cpu \\
        --rounds 2 --per-client 8 --holdout 8 --batch 4 --n-gen 4

The default device is CUDA (TF32 off: the reference computes in f32);
without a card the example raises unless ``--device cpu`` is given.
``--save PATH`` writes the trained trainer (``PATH.npz``, through
:mod:`repro_torch.checkpoint.io`) and its configuration (``PATH.json``);
:func:`load_trained` reads both back.
"""
import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs import UNetConfig
from repro_torch.core import privacy
from repro_torch.core.collafuse import hash_seed
from repro_torch.core.trainer import CollaFuseTrainer, TrainerConfig
from repro_torch.data.synthetic import (ClientDataConfig, image_batches,
                                        make_client_datasets)
from repro_torch.device import resolve_device
from repro_torch.models.unet import UNet

# the chunk --full trains in when --micro-batch is not given: 32 images a
# forward and backward.  At 150 images a client in these chunks a looped
# round peaked at 62.31 GB allocated, 72.11 GB reserved of an NVIDIA H100
# 80GB HBM3's 85.0 GB (700 W; chip_smoke.py phase 4f (c) prints it).  In
# chunks of 48 it peaked at 75.77 to 82.83 GB and once ran out of memory:
# cuDNN takes much of what is free as convolution workspace, and 16-image
# chunks still peak near 39 GB (phase 4f (a))
FULL_MICRO_BATCH = 32
# the seed evaluate() keys its generated and disclosed noise by (the
# reference's PRNGKey(99))
EVAL_SEED = 99


def unet_config(full: bool) -> UNetConfig:
    if full:                            # paper-exact §4 config
        return UNetConfig()             # 128x128, base 64, mults (1,2,4,8)
    return dataclasses.replace(
        UNetConfig().reduced(), image_size=32, base_channels=32,
        channel_mults=(1, 2, 4), attn_resolutions=(8,))


def build(args):
    """(trainer, ucfg, clients, holdout, batch): the reference's build() on
    ``args.device`` (CUDA when absent)."""
    ucfg = unet_config(args.full)
    if args.full:
        T, batch = 100, args.batch or 150
    else:
        T, batch = 50, args.batch or 32
    micro = getattr(args, "micro_batch", None)
    if micro is None and args.full:
        micro = FULL_MICRO_BATCH
    tcfg = TrainerConfig(n_clients=args.clients, T=T,
                         cut_ratio=args.cut_ratio, lr=1e-3, seed=args.seed,
                         step_backend=getattr(args, "step_backend", "torch"),
                         sampler=getattr(args, "sampler", "ddpm"),
                         sampler_steps=getattr(args, "num_steps", 0),
                         eta=getattr(args, "eta", 0.0))
    trainer = _trainer(tcfg, ucfg, getattr(args, "device", "cuda"), micro)
    dcfg = ClientDataConfig(n_clients=args.clients,
                            per_client=args.per_client,
                            image_size=ucfg.image_size,
                            holdout=args.holdout, seed=args.seed)
    clients, holdout = make_client_datasets(dcfg)
    return trainer, ucfg, clients, holdout, batch


def _trainer(tcfg, ucfg, device, micro_batch):
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the reference computes in f32: no TF32 in convolutions or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return CollaFuseTrainer(tcfg, lambda seed: UNet(ucfg, seed=seed),
                            device=dev, micro_batch=micro_batch)


def save_trained(trainer, ucfg, path: str) -> str:
    """Write ``trainer``'s state to ``<path>.npz`` and its configuration to
    ``<path>.json``; returns the .npz path."""
    base = path[:-4] if path.endswith(".npz") else path
    trainer.save(base)
    with open(base + ".json", "w") as f:
        json.dump({"unet": dataclasses.asdict(ucfg),
                   "trainer": dataclasses.asdict(trainer.cfg),
                   "micro_batch": trainer.micro_batch}, f, indent=1)
    return base + ".npz"


def load_trained(path: str, device="cuda"):
    """(trainer, ucfg) rebuilt from :func:`save_trained`'s files on
    ``device``, its state restored bitwise."""
    base = path[:-4] if path.endswith(".npz") else path
    with open(base + ".json") as f:
        cfg = json.load(f)
    ucfg = UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cfg["unet"].items()})
    trainer = _trainer(TrainerConfig(**cfg["trainer"]), ucfg, device,
                       cfg["micro_batch"])
    trainer.restore(base)
    return trainer, ucfg


def evaluate(trainer, ucfg, clients, holdout, n_gen=32):
    """KID performance + disclosure metrics per client (paper Fig. 3), on
    the trainer's device."""
    fp = privacy.feature_params(in_ch=1)
    dev = trainer.device
    holdout = holdout.to(dev)
    out = {"per_client": []}
    shape = (n_gen, ucfg.image_size, ucfg.image_size, 1)
    for k in range(trainer.cfg.n_clients):
        real = clients[k].to(dev)
        gen, _ = trainer.sample(hash_seed(EVAL_SEED, k, 0), shape,
                                client_idx=k, return_intermediate=True)
        disclosed = trainer.disclosed(hash_seed(EVAL_SEED, k, 1),
                                      real[:n_gen], client_idx=k)
        rec = {
            "kid_train": float(privacy.kid(fp, real[:128], gen)),
            "kid_holdout": float(privacy.kid(fp, holdout, gen)),
            "disclosure": privacy.disclosure_report(fp, real[:n_gen],
                                                    disclosed),
        }
        out["per_client"].append(rec)
    for name in ("kid_train", "kid_holdout"):
        out[name + "_sum"] = sum(r[name] for r in out["per_client"])
    out["disclosure_mse_mean"] = (
        sum(r["disclosure"]["mse"] for r in out["per_client"])
        / len(out["per_client"]))
    return out


def add_common_args(ap: argparse.ArgumentParser) -> None:
    """The flags this example shares with ``cut_ratio_sweep``."""
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="paper-exact 128x128 / T=100 / batch 150")
    ap.add_argument("--micro-batch", type=int, default=None,
                    help="most images one forward and backward holds (the "
                         "pooled batch runs in chunks); --full defaults to "
                         f"{FULL_MICRO_BATCH}")
    ap.add_argument("--step-backend", default="torch",
                    choices=["torch", "triton", "cuda_masked"],
                    help="StepBackend for evaluation sampling")
    ap.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim"],
                    help="evaluation sampling trajectory (ddim strides the "
                         "chain to --num-steps model calls)")
    ap.add_argument("--num-steps", type=int, default=0,
                    help="DDIM trajectory length K (0 = dense T steps)")
    ap.add_argument("--eta", type=float, default=0.0,
                    help="DDIM stochasticity in [0,1]")
    ap.add_argument("--n-gen", type=int, default=32,
                    help="images generated a client for the KIDs")
    ap.add_argument("--out-dir", default=os.path.join("results", "torch"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--cut-ratio", type=float, default=0.8)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--per-client", type=int, default=256)
    ap.add_argument("--holdout", type=int, default=128)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--save", default="",
                    help="write the trained models to SAVE.npz and their "
                         "configuration to SAVE.json")
    add_common_args(ap)
    args = ap.parse_args(argv)

    trainer, ucfg, clients, holdout, batch = build(args)
    n_params = sum(p.numel() for p in trainer.server_params.values())
    print(f"backbone: {n_params/1e6:.2f}M params | {trainer.plan.describe()}"
          f" | device {trainer.device} | batch {batch} a client, "
          f"micro_batch {trainer.micro_batch}")
    if trainer.sampler is not None:
        print(f"sampling: {trainer.sampler.describe()} | "
              f"backend={trainer.step_backend.name}")
    iters = [image_batches(c, batch, seed=i) for i, c in enumerate(clients)]

    t0 = time.time()
    for r in range(args.rounds):
        m = trainer.train_round([next(it) for it in iters])
        if r % args.log_every == 0 or r == args.rounds - 1:
            print(f"[{time.time()-t0:7.1f}s] round {r:4d} "
                  f"server={m.get('server_loss', float('nan')):.4f} "
                  f"client={m.get('client_loss_mean', float('nan')):.4f}",
                  flush=True)

    print("evaluating ...")
    ev = evaluate(trainer, ucfg, clients, holdout, n_gen=args.n_gen)
    ev["cut_ratio"] = args.cut_ratio
    ev["rounds"] = args.rounds
    ev["train_wall_s"] = round(time.time() - t0, 1)
    ev["flops_split"] = trainer.metrics_history[-1]["client_fraction"]
    ev["device"] = str(trainer.device)
    if args.save:
        print(f"saved the trained models to "
              f"{save_trained(trainer, ucfg, args.save)}")
    results = os.path.join(args.out_dir, "healthcare")
    os.makedirs(results, exist_ok=True)
    path = os.path.join(results, f"c{args.cut_ratio:.1f}.json")
    with open(path, "w") as f:
        json.dump(ev, f, indent=1)
    print(json.dumps({k: v for k, v in ev.items() if k != "per_client"},
                     indent=1))
    print(f"wrote {path}")
    return ev


if __name__ == "__main__":
    main()
