"""Multi-process pod serving smoke (counterpart of
``repro/launch/pod_smoke.py``): N host processes joined by a gloo
``torch.distributed`` group, ONE shared request queue, lanes owned per host.

Every process runs the same deterministic loop over the queue (admission,
retirement and every window's plan are replicated), but each host holds and
steps only its own block of lanes (``parallel.sharding.lane_owners``) on its
device, plus the halo partners of guided pairs that straddle two blocks.
Each process writes a JSON artifact of its owned rows; the union across
hosts must be bitwise the single-host artifact.

One process a host (the CPU, or two processes on one card)::

    PYTHONPATH=src python -m repro_torch.launch.pod_smoke --device cpu \\
        --coordinator 127.0.0.1:12355 --num-processes 2 --process-id 0 \\
        --out /tmp/pod0.json &
    PYTHONPATH=src python -m repro_torch.launch.pod_smoke --device cpu \\
        --coordinator 127.0.0.1:12355 --num-processes 2 --process-id 1 \\
        --out /tmp/pod1.json

``--num-processes 1`` serves the same workload in-process: the reference
artifact.  The world is the reference's: a 6x6x1 class-conditional MLP
(3 classes and a null label), T = 10, the menu ``ddpm``, ``ddim5`` and
``ddpm_g`` (w 1.5), weights drawn from numpy seeds.  The default device is
CUDA; without a card the smoke raises unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence

import numpy as np
import torch

T = 10
SIZE = 6
SHAPE = (SIZE, SIZE, 1)
NUM_CLASSES = 3          # conditional world: labels 0..2, null row 3
GUIDANCE_W = 1.5         # the menu's guided entry (ddpm_g)
HIDDEN = 32
WORLD_SEED = 0
CLIENT_SEED = 3
REQUEST_SEED = 7


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="127.0.0.1:12355")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--ticks-per-dispatch", type=int, default=4)
    ap.add_argument("--async-depth", type=int, default=2)
    ap.add_argument("--clients", type=int, default=0,
                    help="serve with this many client models so the client "
                         "segment runs too (0 = server segment only)")
    ap.add_argument("--finish-mode", choices=["stream", "drain"],
                    default="stream",
                    help="with --clients: stream = finish waves during the "
                         "server windows; drain = after the server loop "
                         "(the same bits)")
    ap.add_argument("--finish-async-depth", type=int, default=1,
                    help="streamed finish waves in flight before the oldest "
                         "is waited on")
    ap.add_argument("--pack", action="store_true",
                    help="wave packing at admission: the scheduler's walk "
                         "replays alike on every host, so only admission "
                         "ticks move")
    ap.add_argument("--trace-out", default="",
                    help="Chrome trace of each host: host i writes "
                         "<path>.host<i> with pid i, which "
                         "repro_torch.obs.merge_traces joins into one "
                         "timeline (one track a host)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


class PodEps(torch.nn.Module):
    """The smoke's ε-model: a class-conditional MLP on 6x6x1 images.  The
    8-dim time embedding (sin and cos of t at 4 frequencies) plus the
    label's embedding row (row ``NUM_CLASSES`` is the null label) joins the
    flat image, then silu(· @ w1) @ w2."""

    def __init__(self, w1: np.ndarray, w2: np.ndarray, yemb: np.ndarray):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.from_numpy(np.array(w1,
                                                               np.float32)))
        self.w2 = torch.nn.Parameter(torch.from_numpy(np.array(w2,
                                                               np.float32)))
        self.yemb = torch.nn.Parameter(torch.from_numpy(
            np.array(yemb, np.float32)))

    def forward(self, x, t, y=None):
        b = x.shape[0]
        nc = self.yemb.shape[0] - 1
        freqs = torch.exp(torch.linspace(0.0, 3.0, 4, device=x.device))
        ang = t[:, None].to(torch.float32) * freqs[None]
        temb = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
        yc = (torch.full((b,), nc, dtype=torch.int64, device=x.device)
              if y is None else torch.clamp(y.to(torch.int64), 0, nc))
        temb = temb + self.yemb[yc]
        h = torch.nn.functional.silu(
            torch.cat([x.reshape(b, -1), temb], -1) @ self.w1)
        return (h @ self.w2).reshape(x.shape)


def _draw(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    d = SIZE * SIZE
    return {"w1": rng.standard_normal((d + 8, HIDDEN)) / 6.0,
            "w2": rng.standard_normal((HIDDEN, d)) / 6.0,
            "yemb": rng.standard_normal((NUM_CLASSES + 1, 8)) / 6.0}


def model_from_arrays(params: Dict[str, np.ndarray],
                      device="cpu") -> PodEps:
    """A :class:`PodEps` from arrays named as the reference's params
    (``w1``, ``w2``, ``yemb``), e.g. ``np.asarray`` of the reference's
    ``build_world()`` server."""
    return PodEps(params["w1"], params["w2"], params["yemb"]).to(device)


def clients_from_arrays(stack: Dict[str, np.ndarray],
                        device="cpu") -> List[PodEps]:
    """One :class:`PodEps` a row of a stacked client tree (leaves
    [n_clients, ...]), e.g. the reference's ``build_client_stack(n)``."""
    n = len(stack["w1"])
    return [model_from_arrays({k: v[i] for k, v in stack.items()}, device)
            for i in range(n)]


def build_world(device="cpu", server_params=None):
    """(sched, server model, samplers), the same on every process;
    ``server_params`` (arrays) replaces the seeded draw."""
    from repro_torch.diffusion.sampler import make_sampler
    from repro_torch.diffusion.schedule import cosine_schedule
    if server_params is None:
        server_params = _draw(np.random.default_rng(WORLD_SEED))
    samplers = {"ddpm": make_sampler(T),
                "ddim5": make_sampler(T, "ddim", 5, eta=0.0),
                "ddpm_g": make_sampler(T, guidance=GUIDANCE_W)}
    return (cosine_schedule(T), model_from_arrays(server_params, device),
            samplers)


def build_client_stack(n_clients: int, device="cpu") -> List[PodEps]:
    """``n_clients`` private models for :func:`build_world`'s world, the
    same on every process, so the client finish replays across the pod."""
    rng = np.random.default_rng(CLIENT_SEED)
    return [model_from_arrays(_draw(rng), device) for _ in range(n_clients)]


def build_requests(n: int):
    """The smoke's queue, the reference's: request i has batch 1 + i % 2,
    cut 0.25, 0.5 or 0.75 and sampler ddpm, ddim5 or ddpm_g by i % 3 (every
    third request takes the guided pair of lanes an image), arrives at tick
    i % 3 and is finished by client 0; its seed is 7000 + i."""
    from repro_torch.serve import Request
    return [Request(req_id=i, seed=REQUEST_SEED * 1000 + i,
                    batch=1 + i % 2, cut_ratio=(0.25, 0.5, 0.75)[i % 3],
                    client_idx=0, arrival_tick=i % 3,
                    sampler=("ddpm", "ddim5", "ddpm_g")[i % 3],
                    label=i % NUM_CLASSES)
            for i in range(n)]


def serve_pod(num_processes: int, process_id: int, slots: int,
              n_requests: int, k: int, depth: int, pod=None,
              trace_out: str = "", clients: int = 0,
              finish_mode: str = "stream", finish_async_depth: int = 1,
              pack: bool = False, device="cuda", server_params=None,
              client_models: Sequence = None, obs=None, noise=None):
    """Build host ``process_id``'s engine of ``num_processes`` and serve the
    smoke's queue; returns the ServeResult.  ``pod`` is the host's
    :class:`~repro_torch.launch.mesh.Pod` (None: one process, simulated
    hosts when ``num_processes`` > 1).  ``trace_out`` turns tracing on (one
    ``<path>.host<i>`` a host), or ``obs`` is the engine's obs config.
    ``clients`` > 0 runs the client segment on :func:`build_client_stack`'s
    models, or on ``client_models``.  ``server_params`` replaces the
    server's seeded weights and ``noise`` the default noise source."""
    from repro_torch.device import resolve_device
    from repro_torch.serve import (EngineConfig, FIFOScheduler, ObsConfig,
                                   ServeEngine)
    device = resolve_device(device)
    sched, server, samplers = build_world(device, server_params)
    if obs is None and trace_out:
        obs = ObsConfig(trace_path=trace_out)
    cfg = EngineConfig(sched=sched, image_shape=SHAPE, slots=slots,
                       samplers=samplers,
                       scheduler=FIFOScheduler(pack=pack) if pack else None,
                       ticks_per_dispatch=k, async_depth=depth,
                       hosts=num_processes, host_id=process_id, pod=pod,
                       finish_mode=finish_mode,
                       finish_async_depth=finish_async_depth,
                       obs=obs, num_classes=NUM_CLASSES, device=device)
    if clients and client_models is None:
        client_models = build_client_stack(clients, device)
    eng = ServeEngine(cfg, server)
    try:
        return eng.serve(build_requests(n_requests),
                         client_models if clients else None, noise=noise)
    finally:
        eng.close()


def artifact(res, process_id: int) -> Dict:
    """Owned rows only, exact float lists: what this host disclosed (the
    reference's JSON format)."""
    out = {"process_id": process_id, "completions": {}}
    for rid, comp in sorted(res.completions.items()):
        owned = [int(i) for i in range(comp.request.batch)
                 if bool(comp.owned[i])]
        rec = {
            "owned": owned,
            "retire_tick": int(comp.retire_tick),
            "rows": {str(i): [float(v) for v in comp.x_mid[i].ravel()]
                     for i in owned},
        }
        if comp.client_finished:
            rec["x0_rows"] = {
                str(i): [float(v) for v in comp.x0[i].ravel()]
                for i in owned}
        out["completions"][str(rid)] = rec
    out["summary"] = {kk: res.summary[kk]
                      for kk in ("served", "images", "ticks", "windows")}
    return out


def union(artifacts: Sequence[Dict]) -> Dict:
    """The pod's artifacts joined into one single-host artifact: each
    request's rows from the host that owns them.  Raises when two hosts
    own one row, or the hosts disagree on a retire tick or the summary."""
    first = artifacts[0]
    out = {"process_id": 0, "completions": {},
           "summary": dict(first["summary"])}
    for art in artifacts:
        if art["summary"] != first["summary"]:
            raise ValueError(f"host {art['process_id']}'s summary "
                             f"{art['summary']} != host 0's "
                             f"{first['summary']}")
        for rid, rec in art["completions"].items():
            dst = out["completions"].setdefault(rid, {
                "owned": [], "retire_tick": rec["retire_tick"],
                "rows": {}})
            if rec["retire_tick"] != dst["retire_tick"]:
                raise ValueError(f"request {rid} retired at "
                                 f"{rec['retire_tick']} on host "
                                 f"{art['process_id']}, "
                                 f"{dst['retire_tick']} elsewhere")
            for i in rec["owned"]:
                if i in dst["owned"]:
                    raise ValueError(f"request {rid} row {i} owned twice")
            dst["owned"] = sorted(dst["owned"] + rec["owned"])
            dst["rows"].update(rec["rows"])
            if "x0_rows" in rec:
                dst.setdefault("x0_rows", {}).update(rec["x0_rows"])
    return out


def main(argv=None):
    args = _parse_args(argv)
    from repro_torch.launch.mesh import init_pod
    if args.device == "cpu":
        # the hosts share the machine's cores
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // args.num_processes))
    pod = init_pod(args.coordinator, args.num_processes, args.process_id)
    try:
        res = serve_pod(args.num_processes, args.process_id, args.slots,
                        args.requests, args.ticks_per_dispatch,
                        args.async_depth, pod=pod, trace_out=args.trace_out,
                        clients=args.clients, finish_mode=args.finish_mode,
                        finish_async_depth=args.finish_async_depth,
                        pack=args.pack, device=args.device)
    finally:
        if pod is not None:
            pod.close()
    if args.clients:
        s = res.summary
        print(f"client finish ({s['finish_mode']}): "
              f"{s['finish_batches']} batch(es), "
              f"overlap_frac {s['overlap_frac']:.2f}", flush=True)
    if args.trace_out:
        suffix = f".host{args.process_id}" if args.num_processes > 1 else ""
        print(f"wrote trace {args.trace_out}{suffix}", flush=True)
    art = artifact(res, args.process_id)
    n_rows = sum(len(c["rows"]) for c in art["completions"].values())
    print(f"pod_smoke host {args.process_id}/{args.num_processes}: "
          f"{art['summary']['served']} served over "
          f"{art['summary']['ticks']} ticks "
          f"({art['summary']['windows']} windows), {n_rows} owned rows",
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(art, f)
        print(f"wrote {args.out}", flush=True)
    print("pod_smoke OK", flush=True)


if __name__ == "__main__":
    main()
