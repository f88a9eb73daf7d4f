"""One rank of a CPU (data, model) world for
``tests/test_torch_trainer_mesh.py``::

    python tests/_torch_trainer_mesh_worker.py --dims 2x1 --rank R --port P \\
        --dir D

Every rank trains :data:`ROUNDS` rounds of the batched CollaFuse trainer on
the mesh (``CollaFuseTrainer(mesh=)``) for each client count of
:data:`CLIENTS`, and writes its losses, its server parameters and the whole
client stack to ``D/<dims>/<n>.rank<R>.npz``; the trainers save their
checkpoints to ``D/<dims>/<n>.ckpt.npz``.  The port only: no JAX here.
"""
import argparse
import os
import sys

import numpy as np
import torch

from repro_torch.core.trainer import CollaFuseTrainer, TrainerConfig
from repro_torch.launch.mesh import init_mesh, parse_mesh_shape
from repro_torch.launch.serve_diffusion import launcher_config
from repro_torch.models.unet import UNet
from repro_torch.parallel import comm

ROUNDS = 2
BATCH = 4
# 4 clients divide a data axis of 2 (a block of stacks a rank); 3 do not
CLIENTS = (4, 3)


def trainer(n: int, mesh=None) -> CollaFuseTrainer:
    """The launcher's U-Net, labeled rounds of a conditional trainer."""
    ucfg = launcher_config(8, num_classes=2)
    cfg = TrainerConfig(n_clients=n, T=10, num_classes=2, label_drop=0.25)
    return CollaFuseTrainer(cfg, lambda s: UNet(ucfg, seed=s),
                            device="cpu", mesh=mesh)


def data(n: int):
    g = torch.Generator().manual_seed(42)
    batches = [torch.randn((BATCH, 8, 8, 1), generator=g) for _ in range(n)]
    labels = [torch.randint(0, 2, (BATCH,), generator=g) for _ in range(n)]
    return batches, labels


def run(tr: CollaFuseTrainer, n: int) -> dict:
    """ROUNDS rounds: each round's losses, then the state."""
    batches, labels = data(n)
    out = {}
    for r in range(ROUNDS):
        m = tr.train_round(batches, labels)
        out[f"server_loss.{r}"] = np.array(m["server_loss"])
        out[f"client_losses.{r}"] = np.array(m["client_losses"])
    for k, v in tr.server_params.items():
        out["server." + k] = v.numpy()
    for k, v in tr.client_stack.items():
        out["clients." + k] = v.numpy()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    mesh = init_mesh(parse_mesh_shape(args.dims), args.rank,
                     f"127.0.0.1:{args.port}", device_type="cpu",
                     timeout_s=300)
    out_dir = os.path.join(args.dir, args.dims)
    os.makedirs(out_dir, exist_ok=True)
    for n in CLIENTS:
        tr = trainer(n, mesh)
        out = run(tr, n)
        out["stacks_sharded"] = np.array(tr._stacks_sharded)
        np.savez(os.path.join(out_dir, f"{n}.rank{args.rank}.npz"), **out)
        tr.save(os.path.join(out_dir, f"{n}.ckpt.npz"))
    comm.barrier(mesh)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
