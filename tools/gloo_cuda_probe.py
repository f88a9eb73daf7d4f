"""Which collectives the installed gloo backend runs on CUDA tensors, and
what they cost beside the same collective staged through pinned host
memory, for two ranks sharing one card::

    python tools/gloo_cuda_probe.py [--ranks 2] [--mb 32] [--out F.json]

Each rank opens a gloo group over ``tcp://localhost``, calls every
collective the mesh needs on CUDA tensors and checks its result against
the values the ranks put in.  A collective that raises or returns wrong
values is reported as such.  Then ``all_reduce`` of ``--mb`` MiB of
bfloat16 is timed directly (where gloo takes CUDA tensors) and staged (the
tensor copied to pinned host memory, reduced there, copied back), ten
times each, in turns, and ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` of ``--mb`` MiB a rank directly.  It also tries
``init_device_mesh`` with a gloo group for the device types "cuda" and
"cpu".  Rank 0 prints one JSON object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _checks(dist, torch, rank: int, world: int, dev):
    """{name: "ok" | error text} for each collective on CUDA tensors."""
    out = {}

    def run(name, fn):
        try:
            fn()
            torch.cuda.synchronize(dev)
            out[name] = "ok"
        except Exception as e:                      # noqa: BLE001 - reported
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"

    def expect(got, want):
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"wrong values {got.flatten()[:4].tolist()}"
                                 f" != {want.flatten()[:4].tolist()}")

    base = torch.arange(8, dtype=torch.float32, device=dev)

    def all_reduce_sum():
        x = base + rank
        dist.all_reduce(x)
        expect(x, base * world + sum(range(world)))

    def all_reduce_max():
        x = base + rank
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        expect(x, base + world - 1)

    def all_reduce_bf16():
        x = (base + rank).to(torch.bfloat16)
        dist.all_reduce(x)
        expect(x, (base * world + sum(range(world))).to(torch.bfloat16))

    def broadcast():
        x = base + rank
        dist.broadcast(x, 0)
        expect(x, base)

    def all_gather():
        xs = [torch.empty_like(base) for _ in range(world)]
        dist.all_gather(xs, base + rank)
        for r, x in enumerate(xs):
            expect(x, base + r)

    def all_gather_into_tensor():
        x = torch.empty(world * 8, device=dev)
        dist.all_gather_into_tensor(x, base + rank)
        expect(x, torch.cat([base + r for r in range(world)]))

    def reduce_scatter():
        x = torch.empty(8 // world, device=dev)
        dist.reduce_scatter(x, list((base + rank).chunk(world)))
        want = (base * world + sum(range(world))).chunk(world)[rank]
        expect(x, want)

    def reduce_scatter_tensor():
        x = torch.empty(8 // world, device=dev)
        dist.reduce_scatter_tensor(x, base + rank)
        want = (base * world + sum(range(world))).chunk(world)[rank]
        expect(x, want)

    def all_to_all():
        ins = list((base + 100 * rank).chunk(world))
        outs = [torch.empty_like(c) for c in ins]
        dist.all_to_all(outs, ins)
        for r, x in enumerate(outs):
            expect(x, (base + 100 * r).chunk(world)[rank])

    def all_to_all_single():
        x = torch.empty_like(base)
        dist.all_to_all_single(x, base + 100 * rank)
        want = torch.cat([(base + 100 * r).chunk(world)[rank]
                          for r in range(world)])
        expect(x, want)

    for name, fn in [("all_reduce_sum", all_reduce_sum),
                     ("all_reduce_max", all_reduce_max),
                     ("all_reduce_bf16", all_reduce_bf16),
                     ("broadcast", broadcast), ("all_gather", all_gather),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter", reduce_scatter),
                     ("reduce_scatter_tensor", reduce_scatter_tensor),
                     ("all_to_all", all_to_all),
                     ("all_to_all_single", all_to_all_single)]:
        run(name, fn)
        dist.barrier()
    return out


def _time_all_reduce(dist, torch, dev, mb: int, direct_ok: bool):
    """Median ms of ``all_reduce`` on ``mb`` MiB of bf16, direct and
    staged through pinned host memory, ten of each in turns."""
    n = mb * (1 << 20) // 2
    x = torch.ones(n, dtype=torch.bfloat16, device=dev)
    host = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
    direct, staged = [], []
    for i in range(11):
        if direct_ok:
            torch.cuda.synchronize(dev)
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_reduce(x)
            torch.cuda.synchronize(dev)
            if i:
                direct.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        host.copy_(x, non_blocking=True)
        torch.cuda.synchronize(dev)
        dist.all_reduce(host)
        x.copy_(host, non_blocking=True)
        torch.cuda.synchronize(dev)
        if i:
            staged.append((time.perf_counter() - t0) * 1e3)

    def med(v):
        return sorted(v)[len(v) // 2] if v else None
    return {"mb": mb, "direct_ms": med(direct), "staged_ms": med(staged)}


def _time_gather_scatter(dist, torch, dev, mb: int, world: int):
    """Median ms of ``all_gather_into_tensor`` (each rank's ``mb`` MiB of
    bf16 into world times that) and ``reduce_scatter_tensor`` (world times
    ``mb`` MiB into ``mb``) on CUDA tensors, ten of each."""
    n = mb * (1 << 20) // 2
    x = torch.ones(n, dtype=torch.bfloat16, device=dev)
    big = torch.empty(world * n, dtype=torch.bfloat16, device=dev)
    out = {}
    for name, fn in (("all_gather_ms",
                      lambda: dist.all_gather_into_tensor(big, x)),
                     ("reduce_scatter_ms",
                      lambda: dist.reduce_scatter_tensor(x, big))):
        times = []
        for i in range(11):
            torch.cuda.synchronize(dev)
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = sorted(times)[len(times) // 2]
    return out


def _mesh_probe(torch, world: int):
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    for kind in ("cuda", "cpu"):
        try:
            m = init_device_mesh(kind, (1, world),
                                 mesh_dim_names=("data", "model"))
            g = m.get_group("model")
            out[kind] = f"ok: model group of {g.size()}"
        except Exception as e:                      # noqa: BLE001 - reported
            out[kind] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def _rank(rank: int, world: int, port: int, mb: int, out: str) -> None:
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    res = {"rank": rank, "world": world, "gloo_on_cuda": {}}
    try:
        res["gloo_on_cuda"] = _checks(dist, torch, rank, world, dev)
        direct_ok = res["gloo_on_cuda"]["all_reduce_bf16"] == "ok"
        res["all_reduce_time"] = _time_all_reduce(dist, torch, dev, mb,
                                                  direct_ok)
        res["all_reduce_time"].update(
            _time_gather_scatter(dist, torch, dev, mb, world))
        res["device_mesh"] = _mesh_probe(torch, world)
    except Exception:                               # noqa: BLE001 - reported
        res["error"] = traceback.format_exc()[-2000:]
    if rank == 0:
        res["torch"] = torch.__version__
        res["cuda"] = torch.version.cuda
        res["python"] = sys.version.split()[0]
        res["card"] = torch.cuda.get_device_name(0)
        res["device_count"] = torch.cuda.device_count()
        res["nccl_available"] = dist.is_nccl_available()
        print(json.dumps(res), flush=True)
        if out:
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            with open(out, "w") as f:
                json.dump(res, f, indent=1)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--mb", type=int, default=32)
    ap.add_argument("--out", default="results/gloo_probe.json")
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank >= 0:
        _rank(args.rank, args.ranks, args.port, args.mb, args.out)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               "--ranks", str(args.ranks), "--port",
                               str(port), "--mb", str(args.mb), "--out",
                               args.out], start_new_session=True)
             for r in range(args.ranks)]
    rcs = []
    deadline = time.time() + 240
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.time())))
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            rcs.append(p.wait())
    print(f"rank exit codes {rcs}", flush=True)
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
