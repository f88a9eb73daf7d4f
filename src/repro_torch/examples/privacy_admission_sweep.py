"""Sweep the KID-admission floor and watch the serving engine trade
traffic for privacy (counterpart of the reference's
``examples/privacy_admission_sweep.py``).

For a fixed stream of mixed DDPM/DDIM requests, each ``--min-kid`` value
is one gated engine run: as the floor rises, requests first ADMIT at
their nominal cut, then BUMP to noisier trajectory positions (the
disclosed tensor moves earlier in the chain — more concealment, fewer
server steps), and finally REJECT when no position on their trajectory
clears.  The sweep shares ONE score cache across floors
(``AdmissionPolicy.with_min_kid``), so the disclosure landscape is
computed once.  ``--ckpt`` serves (and scores) models trained and saved
by ``collafuse_healthcare --save`` instead of a small random U-Net; T,
the image size and the clients are then the checkpoint's::

    python -m repro_torch.examples.privacy_admission_sweep
    python -m repro_torch.examples.privacy_admission_sweep --device cpu \\
        --floors 0.0 0.1 0.2 --requests 12
    python -m repro_torch.examples.privacy_admission_sweep --ckpt PATH

Writes ``<out-dir>/privacy_admission_sweep.json``.
"""
import argparse
import dataclasses
import json
import os

import torch

from repro_torch.configs import UNetConfig
from repro_torch.core.collafuse import hash_seed
from repro_torch.data.synthetic import ClientDataConfig, make_client_datasets
from repro_torch.device import resolve_device
from repro_torch.diffusion.sampler import make_sampler
from repro_torch.diffusion.schedule import cosine_schedule, get_schedule
from repro_torch.examples.collafuse_healthcare import load_trained
from repro_torch.models.unet import UNet
from repro_torch.serve import (AdmissionPolicy, EngineConfig, Request,
                               ServeEngine, make_scheduler)


def _models(args, dev):
    """(server, clients, sched, T, image size) of the random U-Net or of
    the checkpoint."""
    if args.ckpt:
        trainer, ucfg = load_trained(args.ckpt, dev)
        server = trainer.server_model()
        clients = [trainer.client_model(k)
                   for k in range(trainer.cfg.n_clients)]
        return (server, clients, get_schedule(trainer.cfg.schedule,
                                              trainer.cfg.T),
                trainer.cfg.T, ucfg.image_size)
    ucfg = dataclasses.replace(
        UNetConfig().reduced(), image_size=args.image, base_channels=8,
        channel_mults=(1, 2), n_res_blocks=1, attn_resolutions=(),
        time_dim=32, norm_groups=4)
    server = UNet(ucfg, seed=hash_seed(args.seed, 0)).to(dev).eval()
    clients = [UNet(ucfg, seed=hash_seed(args.seed, 1 + k)).to(dev).eval()
               for k in range(args.clients)]
    return server, clients, cosine_schedule(args.T), args.T, args.image


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--T", type=int, default=20)
    ap.add_argument("--num-steps", type=int, default=6,
                    help="strided DDIM trajectory length in the menu")
    ap.add_argument("--image", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=9)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--calib", type=int, default=8)
    ap.add_argument("--cut-ratios", type=float, nargs="+",
                    default=[0.1, 0.4, 0.7])
    ap.add_argument("--floors", type=float, nargs="+", default=None,
                    help="min_kid floors to sweep; default = quartiles of "
                         "the measured disclosure landscape")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="",
                    help="serve the models collafuse_healthcare --save "
                         "wrote (CKPT.npz and CKPT.json)")
    ap.add_argument("--out-dir", default=os.path.join("results", "torch"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    server, clients, sched, T, image = _models(args, dev)
    samplers = {"ddpm": make_sampler(T),
                "ddim": make_sampler(T, "ddim", args.num_steps, 0.0)}
    calib_sets, _ = make_client_datasets(ClientDataConfig(
        n_clients=1, per_client=args.calib, image_size=image, holdout=2,
        seed=args.seed))

    probe = AdmissionPolicy(sched, calib_sets[0].to(dev),
                            min_kid=float("-inf"), samplers=samplers,
                            server_fn=server)
    landscape = sorted(v for name in samplers for v in probe.profile(name))
    # ascending floors: the monotonicity check below keys on sweep order
    floors = sorted(args.floors) if args.floors is not None else None
    if floors is None:
        def q(f):
            return landscape[min(int(f * len(landscape)),
                                 len(landscape) - 1)]
        floors = [landscape[0] - 1.0, q(0.25), q(0.5), q(0.75),
                  landscape[-1] + 1.0]
    print(f"disclosure landscape over {sorted(samplers)}: "
          f"min {landscape[0]:.4f} max {landscape[-1]:.4f} "
          f"({'checkpoint ' + args.ckpt if args.ckpt else 'random U-Net'}, "
          f"T={T}, {image}x{image}, device {dev})")

    requests = [Request(req_id=i, seed=args.seed * 1_000_003 + i, batch=1,
                        cut_ratio=args.cut_ratios[i % len(args.cut_ratios)],
                        client_idx=i % len(clients),
                        sampler=("ddpm", "ddim")[i % 2])
                for i in range(args.requests)]

    print("min_kid,served,admitted,bumped,rejected,ticks,"
          "served_kid_min,mean_effective_cut")
    rows = []
    for floor in floors:
        pol = probe.with_min_kid(floor)
        cfg = EngineConfig(
            sched=sched, image_shape=(image, image, 1), slots=args.slots,
            scheduler=make_scheduler("cut_ratio", T, samplers=samplers),
            samplers=samplers, admission=pol, device=dev)
        eng = ServeEngine(cfg, server)
        res = eng.serve(list(requests), clients)
        eng.close()
        adm = res.summary["admission"]
        dk = adm.get("disclosure_kid", {})
        served = [d for d in res.decisions.values() if d.served]
        mean_cut = (sum(d.effective_cut for d in served) / len(served)
                    if served else 0.0)
        rows.append({"min_kid": floor, "served": res.summary["served"],
                     "admitted": adm["admitted"], "bumped": adm["bumped"],
                     "rejected": adm["rejected"],
                     "ticks": res.summary["ticks"],
                     "served_kid_min": dk.get("min"),
                     "mean_effective_cut": mean_cut})
        kid_min = dk.get("min")
        print(f"{floor:+.4f},{res.summary['served']},{adm['admitted']},"
              f"{adm['bumped']},{adm['rejected']},{res.summary['ticks']},"
              f"{'-' if kid_min is None else format(kid_min, '.4f')},"
              f"{mean_cut:.2f}", flush=True)

    # the trade-off the gate enforces: raising the floor never serves more
    # requests (admit ⊇ bump ⊇ reject transitions are one-way in min_kid)
    served_counts = [r["served"] for r in rows]
    if any(a < b for a, b in zip(served_counts, served_counts[1:])):
        raise AssertionError(f"a higher floor served more requests: "
                             f"{served_counts}")
    print(f"scoring: {probe.model_calls} model calls on {args.calib} "
          f"images, {probe.score_s:.2f}s, shared by {len(floors)} floors")
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "privacy_admission_sweep.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {path}")
    print("privacy_admission_sweep OK")
    return rows


if __name__ == "__main__":
    main()
