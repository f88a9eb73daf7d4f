"""Quickstart on the port: CollaFuse split training and split inference in
about a minute on the CPU (counterpart of the reference's
``examples/quickstart.py``).

Runs the paper's 6-step protocol (Fig. 2) for a handful of rounds with 3
clients and a reduced U-Net, generates images with the split sampler
(server prefix -> client suffix), the same split on a DDIM-10 trajectory,
and reports the disclosure metrics at the cut::

    python -m repro_torch.examples.quickstart              # on the card
    python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

import torch

from repro_torch.configs import UNetConfig
from repro_torch.core import collafuse, privacy
from repro_torch.core.trainer import CollaFuseTrainer, TrainerConfig
from repro_torch.data.synthetic import (ClientDataConfig, image_batches,
                                        make_client_datasets)
from repro_torch.device import resolve_device
from repro_torch.diffusion.sampler import make_sampler
from repro_torch.models.unet import UNet


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    # --- reduced paper backbone (16x16 images so the CPU is fast) ---------
    ucfg = UNetConfig().reduced()
    tcfg = TrainerConfig(n_clients=3, T=50, cut_ratio=0.8, lr=1e-3)
    trainer = CollaFuseTrainer(tcfg, lambda seed: UNet(ucfg, seed=seed),
                               device=dev)
    print(trainer.plan.describe())

    # --- per-client synthetic "MRI" data ----------------------------------
    dcfg = ClientDataConfig(n_clients=3, per_client=64,
                            image_size=ucfg.image_size, holdout=32)
    clients, _ = make_client_datasets(dcfg)
    iters = [image_batches(c, batch=16, seed=i) for i, c in enumerate(clients)]

    # --- a few protocol rounds --------------------------------------------
    for r in range(args.rounds):
        m = trainer.train_round([next(it) for it in iters])
        print(f"round {r}: server_loss={m.get('server_loss', float('nan')):.4f} "
              f"client_loss={m.get('client_loss_mean', float('nan')):.4f} "
              f"client_flop_fraction={m['client_fraction']:.2f}", flush=True)

    # --- split inference ----------------------------------------------------
    shape = (8, ucfg.image_size, ucfg.image_size, 1)
    x0, _ = trainer.sample(42, shape, client_idx=0, return_intermediate=True)
    print(f"generated {tuple(x0.shape)}, "
          f"finite={bool(torch.isfinite(x0).all())}")

    # --- the same split on a strided DDIM trajectory ------------------------
    # 10 model calls instead of T=50: the sampler layer owns WHICH
    # timesteps the chain visits; the cut maps to the nearest trajectory
    # point, so server/client still split the work at ~t_split.
    ddim = make_sampler(tcfg.T, "ddim", num_steps=10, eta=0.0)
    server_fn, client_fn = trainer.model_fns(0)
    x0_fast = collafuse.split_sample(
        trainer.sched, trainer.plan, server_fn, client_fn, 42, shape,
        sampler=ddim, device=dev)
    cut = trainer.plan.cut_index(ddim)
    print(f"DDIM-10 split ({ddim.describe()}): server {cut} + client "
          f"{ddim.K - cut} model calls (vs {tcfg.T} dense), "
          f"finite={bool(torch.isfinite(x0_fast).all())}")

    # --- what does the server actually see at the cut? ----------------------
    fp = privacy.feature_params()
    real = clients[0][:16].to(dev)
    disclosed = trainer.disclosed(7, real, client_idx=0)
    rep = privacy.disclosure_report(fp, real, disclosed)
    print(f"disclosure at t_split: mse={rep['mse']:.3f} kid={rep['kid']:.4f} "
          f"(higher = more concealed)")
    return rep


if __name__ == "__main__":
    main()
