"""One rank of a CPU gloo world for ``tests/test_torch_dryrun.py``::

    python tests/_torch_dryrun_worker.py --dims 1x2 --kind prefill \
        --rank R --port P --out D

Each rank runs the real step of every case (each family's ``reduced()``
member at the test's shape, weights drawn on the mesh from seed 0, the
batch from seed 1) once under the work counter; rank 0 writes, for each
arch, its collectives' calls and bytes (``comm.STATS``) and the counter's
FLOPs and bytes to ``D/<dims>.json``.  The port only: no JAX here.
"""
import argparse
import json
import os
import sys

import torch

from repro_torch.configs import InputShape, get_config
from repro_torch.launch import specs as sp
from repro_torch.launch.counter import WorkCounter
from repro_torch.launch.mesh import init_mesh, parse_mesh_shape
from repro_torch.launch.steps import (make_ctx, make_prefill_step,
                                      make_train_step)
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.parallel import comm

ARCHS = ("yi-6b", "zamba2-7b", "deepseek-v2-236b", "qwen2-vl-2b",
         "musicgen-large", "xlstm-125m")
SEQ, BATCH = 16, 4


def real_batch(cfg, shape, seed: int = 1):
    """The step's global batch, the same on every rank."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, t in sp.batch_specs_abstract(cfg, shape).items():
        if t.dtype == torch.int64:
            out[k] = torch.randint(0, cfg.vocab_size, t.shape, generator=g)
        else:
            out[k] = torch.randn(t.shape, generator=g).to(t.dtype)
    return out


def run(arch: str, kind: str, mesh):
    cfg = get_config(arch).reduced()
    shape = InputShape("t", SEQ, BATCH, kind)
    fsdp = kind == "train"
    ctx = make_ctx(mesh)
    model = tf.init_params(cfg, seed=0, ctx=ctx, fsdp=fsdp)
    batch = real_batch(cfg, shape)
    if kind == "train":
        opt = adamw.init_state(dict(model.named_parameters()),
                               adamw.AdamWConfig())
        step = make_train_step(cfg, ctx=ctx)

        def go():
            step(model, opt, batch)
    else:
        step = make_prefill_step(cfg, ctx=ctx)

        def go():
            step(model, batch)
    comm.reset_stats()
    with WorkCounter() as counter:
        go()
    return {"calls": int(comm.STATS["calls"]),
            "bytes": int(comm.STATS["bytes"]), "flops": counter.flops,
            "moved": counter.bytes}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", required=True)
    ap.add_argument("--kind", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    mesh = init_mesh(parse_mesh_shape(args.dims), args.rank,
                     f"127.0.0.1:{args.port}", device_type="cpu",
                     timeout_s=300)
    res = {arch: run(arch, args.kind, mesh) for arch in ARCHS}
    if args.rank == 0:
        with open(os.path.join(args.out, args.dims + ".json"), "w") as f:
            json.dump(res, f)
    comm.barrier(mesh)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
