"""Multi-client round-scaling launcher — the batched CollaFuse trainer on
one card (counterpart of ``repro/launch/clients_sweep.py``).

Runs REAL collaborative rounds of a small U-Net (the reference launcher's:
base 8, mults (1, 2), no attention) while sweeping ``n_clients``: client
parameters and AdamW state ride as [n_clients, ...] stacks, the pooled
server step noises every client's upload at once, and the client step is
one ``torch.func.vmap`` over the stack::

    python -m repro_torch.launch.clients_sweep --clients 2 8 32 --rounds 3
    python -m repro_torch.launch.clients_sweep --device cpu --clients 2 \
        --rounds 1 --T 10

The default device is CUDA; without a card the launcher raises unless
``--device cpu`` is given.  ``--compare-looped`` also times the per-client
loop, printing the batched engine's speed-up per sweep point.  The records
are the reference's, with ``device`` where it had ``mesh``.
"""
import argparse
import json


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--clients", type=int, nargs="+", default=[2, 8, 32])
    ap.add_argument("--rounds", type=int, default=3,
                    help="timed rounds per sweep point (after 1 warmup)")
    ap.add_argument("--batch", type=int, default=4, help="per-client batch")
    ap.add_argument("--image", type=int, default=8)
    ap.add_argument("--T", type=int, default=20)
    ap.add_argument("--cut-ratio", type=float, default=0.8)
    ap.add_argument("--step-backend", default="torch",
                    choices=["torch", "triton", "cuda_masked"],
                    help="denoise-tick StepBackend used by trainer.sample")
    ap.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim"],
                    help="trajectory family trainer.sample walks (ddim "
                         "strides the chain to --num-steps)")
    ap.add_argument("--num-steps", type=int, default=0,
                    help="DDIM trajectory length K (0 = dense T steps)")
    ap.add_argument("--eta", type=float, default=0.0,
                    help="DDIM stochasticity in [0,1]")
    ap.add_argument("--compare-looped", action="store_true",
                    help="also time the per-client reference loop")
    ap.add_argument("--json", default="",
                    help="write the sweep records to this path")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    import dataclasses
    import time

    import torch

    from repro_torch.core.trainer import CollaFuseTrainer, TrainerConfig
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve_diffusion import launcher_config
    from repro_torch.models.unet import UNet

    dev = resolve_device(args.device)
    print(f"clients_sweep: device={dev} batch={args.batch} "
          f"image={args.image} T={args.T} c={args.cut_ratio}")
    ucfg = launcher_config(args.image)

    def factory(seed):
        return UNet(ucfg, seed=seed)

    def data_for(n):
        g = torch.Generator().manual_seed(42)
        return [torch.randn((args.batch, args.image, args.image, 1),
                            generator=g) for _ in range(n)]

    def timed_rounds(trainer, batches):
        trainer.train_round(batches)                      # warmup
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(args.rounds):
            metrics = trainer.train_round(batches)       # syncs on the losses
        return (time.perf_counter() - t0) / args.rounds, metrics

    records = []
    print("n_clients,round_s,server_gflops,client_gflops,server_loss,"
          "speedup_vs_looped")
    for n in args.clients:
        cfg = TrainerConfig(n_clients=n, T=args.T, cut_ratio=args.cut_ratio,
                            step_backend=args.step_backend,
                            sampler=args.sampler,
                            sampler_steps=args.num_steps, eta=args.eta)
        tr = CollaFuseTrainer(cfg, factory, device=dev)
        batches = data_for(n)
        sec, metrics = timed_rounds(tr, batches)
        losses = (metrics.get("client_losses", []) +
                  [metrics[k] for k in ("server_loss",) if k in metrics])
        if not losses or not all(v == v for v in losses):
            raise RuntimeError(f"NaN/absent losses: {losses}")
        # exercise the sampling seam the flags configure: split inference
        # on the chosen trajectory/backend must stay finite
        gen = tr.sample(5, (2, args.image, args.image, 1))
        if not bool(torch.isfinite(gen).all()):
            raise RuntimeError("non-finite split sample")
        speedup = None                    # null in the JSON artefact
        if args.compare_looped:
            looped = CollaFuseTrainer(dataclasses.replace(cfg, batched=False),
                                      factory, device=dev)
            lsec, _ = timed_rounds(looped, batches)
            speedup = lsec / sec
        rec = {"n_clients": n, "round_s": sec,
               "server_flops": metrics["server_flops"],
               "client_flops": metrics["client_flops"],
               "server_loss": metrics.get("server_loss"),
               "speedup_vs_looped": speedup, "device": str(dev)}
        records.append(rec)
        print(f"{n},{sec:.4f},{metrics['server_flops'] / 1e9:.3f},"
              f"{metrics['client_flops'] / 1e9:.3f},"
              f"{metrics.get('server_loss', float('nan')):.4f},"
              + (f"{speedup:.2f}" if speedup is not None else "-"),
              flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.json}")
    print(f"clients sweep OK: {len(records)} points")


if __name__ == "__main__":
    main()
