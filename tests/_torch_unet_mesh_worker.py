"""One rank of a CPU (data, model) world for ``tests/test_torch_unet_mesh.py``::

    python tests/_torch_unet_mesh_worker.py --dims 1x2 --rank R --port P --dir D

Every rank shards the U-Nets of ``D/forward.pt`` over its model axis and
runs their forwards on the inputs there, then serves the launcher's
conditional U-Net through the engine in lockstep with its model peers,
once a variant (:data:`VARIANTS`).  Each rank writes its outputs to
``D/rank<R>.npz``.  The port only: no JAX here.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.diffusion.sampler import make_sampler
from repro_torch.diffusion.schedule import cosine_schedule
from repro_torch.launch.mesh import init_mesh, parse_mesh_shape
from repro_torch.launch.serve_diffusion import launcher_config
from repro_torch.launch.steps import make_ctx
from repro_torch.models.unet import UNet, shard_unet
from repro_torch.parallel import comm
from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                               make_scheduler)

T = 10
NUM_CLASSES = 3
SLOTS = 8
# name -> (ticks per window, finish mode, wave packing, w = 0 twins)
VARIANTS = {"base": (1, "stream", False, False),
            "k4": (4, "stream", False, False),
            "drain": (1, "drain", False, False),
            "pack": (1, "stream", True, False),
            "w0": (1, "stream", False, True)}


def menu():
    return {"ddpm": make_sampler(T), "ddim": make_sampler(T, "ddim", 5, 0.0),
            "ddpm_g": make_sampler(T, guidance=1.5),
            "ddpm_g0": make_sampler(T, guidance=0.0)}


def requests(w0: bool = False):
    """Six requests over the menu; with ``w0`` the unguided ``ddpm`` ones
    name their w = 0 twin ``ddpm_g0``."""
    names = ("ddpm", "ddim", "ddpm_g")
    out = []
    for i in range(6):
        s = names[i % 3]
        if w0 and s == "ddpm":
            s = "ddpm_g0"
        out.append(Request(req_id=i, seed=100 + i, batch=1 + i % 2,
                           cut_ratio=(0.25, 0.5, 0.75)[i % 3],
                           client_idx=i % 2, sampler=s, label=i % 3))
    return out


def serve(variant: str, ctx=None):
    """A serve of :func:`requests` on the launcher's conditional U-Net
    (weights from seeds), its server sharded over ``ctx``'s model axis."""
    k, finish, pack, w0 = VARIANTS[variant]
    ucfg = launcher_config(8, NUM_CLASSES)
    server = UNet(ucfg, seed=0).eval()
    ranks = 1 if ctx is None else ctx.model_size
    if ranks > 1:
        shard_unet(server, ctx)
    clients = [UNet(ucfg, seed=1 + c).eval() for c in range(2)]
    samplers = menu()
    cfg = EngineConfig(
        sched=cosine_schedule(T), image_shape=(8, 8, 1), slots=SLOTS,
        scheduler=make_scheduler("cut_ratio", T, samplers=samplers,
                                 pack=pack),
        step_backend="cuda_masked", samplers=samplers, ticks_per_dispatch=k,
        finish_mode=finish, device="cpu", num_classes=NUM_CLASSES,
        cuda_graphs=ranks == 1)
    with torch.no_grad():
        return ServeEngine(cfg, server).serve(requests(w0), clients)


def rows(res, variant: str) -> dict:
    out = {}
    for rid, c in res.completions.items():
        out[f"{variant}.x_mid.{rid}"] = c.x_mid
        out[f"{variant}.x0.{rid}"] = c.x0
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
    ctx = make_ctx(mesh)
    out = {}
    for name, case in torch.load(f"{args.dir}/forward.pt",
                                 weights_only=False).items():
        model = UNet(case["cfg"]).eval()
        model.load_state_dict(case["state"])
        shard_unet(model, ctx)
        with torch.no_grad():
            out[f"forward.{name}"] = model(case["x"], case["t"],
                                           case.get("y")).numpy()
        out[f"sharded.{name}"] = np.array(sum(
            hasattr(p, "full_shape") for p in model.parameters()))
    comm.reset_stats()
    for variant in VARIANTS:
        out.update(rows(serve(variant, ctx), variant))
    out["collective_calls"] = np.array(comm.STATS["calls"])
    np.savez(f"{args.dir}/rank{args.rank}.npz", **out)
    comm.barrier(mesh)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
