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
are the reference's, with ``device`` where it had ``mesh`` (and ``mesh``
beside it on a mesh).

``--devices N --mesh-shape DxM`` runs the trainer on a (data, model) mesh
of N ranks (``launch/mesh.py``'s ``run_ranks``; ``CollaFuseTrainer(mesh=)``:
the client stacks over ``data``, the pooled server batch over ``data``, a
model axis replicating the trainer); rank 0 prints the reference's
``mesh=data:Dxmodel:M`` line and the records::

    python -m repro_torch.launch.clients_sweep --device cpu --devices 2 \
        --mesh-shape 2x1 --clients 2 4 --rounds 1 --T 10
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
    ap.add_argument("--devices", type=int, default=0,
                    help="N ranks on a (data, model) mesh (0 = one "
                         "process, no mesh)")
    ap.add_argument("--mesh-shape", default="",
                    help="DxM, e.g. 2x1; default = all devices on the data "
                         "axis")
    ap.add_argument("--compare-looped", action="store_true",
                    help="also time the per-client reference loop")
    ap.add_argument("--json", default="",
                    help="write the sweep records to this path")
    return ap.parse_args(argv)


# a mesh sweep's deadline (its ranks are killed after it)
MESH_TIMEOUT_S = 3000.0


def main(argv=None):
    args = _parse_args(argv)
    if args.devices or args.mesh_shape:
        from repro_torch.launch.mesh import host_mesh, run_ranks
        dims = host_mesh(args.mesh_shape, args.devices or None)
        if dims[0] * dims[1] > 1:
            run_ranks(_rank_main, dims[0] * dims[1], (args, dims),
                      timeout_s=MESH_TIMEOUT_S)
            return
    _sweep(args)


def _rank_main(rank: int, port: int, args, dims) -> None:
    from repro_torch.launch.mesh import launcher_rank
    with launcher_rank(rank, port, dims, args.device) as mesh:
        _sweep(args, mesh)


def _sweep(args, mesh=None):
    """The sweep on one process, or as one rank of ``mesh``."""
    import dataclasses
    import time

    import torch

    from repro_torch.core.trainer import CollaFuseTrainer, TrainerConfig
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve_diffusion import launcher_config
    from repro_torch.models.unet import UNet

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    d, m = (mesh.shape["data"], mesh.shape["model"]) if mesh is not None \
        else (1, 1)
    print(f"clients_sweep: mesh=data:{d}xmodel:{m} device={dev} "
          f"batch={args.batch} image={args.image} T={args.T} "
          f"c={args.cut_ratio}")
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
        tr = CollaFuseTrainer(cfg, factory, device=dev, mesh=mesh)
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
                                      factory, device=dev, mesh=mesh)
            lsec, _ = timed_rounds(looped, batches)
            speedup = lsec / sec
        rec = {"n_clients": n, "round_s": sec,
               "server_flops": metrics["server_flops"],
               "client_flops": metrics["client_flops"],
               "server_loss": metrics.get("server_loss"),
               "speedup_vs_looped": speedup, "device": str(dev)}
        if mesh is not None:
            rec["mesh"] = f"{d}x{m}"
        records.append(rec)
        print(f"{n},{sec:.4f},{metrics['server_flops'] / 1e9:.3f},"
              f"{metrics['client_flops'] / 1e9:.3f},"
              f"{metrics.get('server_loss', float('nan')):.4f},"
              + (f"{speedup:.2f}" if speedup is not None else "-"),
              flush=True)

    if args.json and (mesh is None or
                      mesh.index(mesh.axis_names) == 0):
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.json}")
    print(f"clients sweep OK: {len(records)} points")


if __name__ == "__main__":
    main()
