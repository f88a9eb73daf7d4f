"""Diffusion serving launcher — the continuous-batching engine on one card
(or a pod of host processes, ``--devices``).

Runs the CollaFuse server segment for a stream of generation requests
(mixed cut-ratios / batch sizes / arrival ticks / samplers) through the
serving engine, then finishes every request on its client's private model::

    python -m repro_torch.launch.serve_diffusion                # paper U-Net
    python -m repro_torch.launch.serve_diffusion --device cpu --config \
        launcher --T 10 --requests 4 --slots 4
    python -m repro_torch.launch.serve_diffusion --num-classes 4 \
        --guidance 1.5 --min-kid 0.5 --calib 16   # guided, KID-gated
    python -m repro_torch.launch.serve_diffusion --ticks-per-dispatch 4 \
        --async-depth 2 --finish-async-depth 2 --spare-columns 32 --mix
    python -m repro_torch.launch.serve_diffusion --mix --pack \
        --trace-out trace.json --metrics-out metrics.jsonl

``--config paper`` is the paper's U-Net (128x128x1, base 64, mults
(1,2,4,8), 2 res blocks, attention at 16); ``--config launcher`` is the
reference launcher's small model.  Weights are random, drawn from
``--seed``.  ``--num-classes N`` makes the model class-conditional (labels
cycle over the requests); ``--guidance w`` adds a classifier-free guided
``ddpm_g`` menu entry and routes requests through it; ``--min-kid`` gates
admission on the disclosure KID, calibrated on ``--calib`` synthetic
images.  ``--async-depth`` windows are in flight; the client segment streams
(``--finish-mode stream``, the default) or drains after the server loop;
``--spare-columns`` leaves room for an ad-hoc ``dyn`` sampler, registered
between the warm-up and the measured serve without a new graph capture.
``--pack`` turns on wave packing and the launcher prints the slot pool's
fragmentation and occupancy by class.  ``--trace-out`` exports the
measured serve's Chrome trace (host-loop spans, one track a request),
``--metrics-out`` appends registry snapshots every ``--metrics-every``
windows, and ``--profile-dir`` writes a ``torch.profiler`` trace of each
serve's first ``--profile-windows`` windows.  The default device is CUDA;
without a card the launcher raises unless ``--device cpu`` is given.

Pod mode: ``--devices N --mesh-shape Nx1`` starts N host processes (the
``spawn`` start method, which CUDA needs) joined by a gloo group, each a pod
host with ``slots / N`` lanes on the device (all on the one card, or the
CPU) over one shared queue.  Host 0 prints ``mesh=data:Nxmodel:1``, each
host's ms a tick, images/s, kernel launches and peak memory, whether its
measured serve is bitwise its warm-up serve of the same requests
(``repeat_bitwise``), and the pod's images/s, and writes the merged
``--json`` and ``--out``.  Two hosts::

    python -m repro_torch.launch.serve_diffusion --devices 2 \
        --mesh-shape 2x1 --device cpu --config launcher --T 10 \
        --requests 6 --slots 4

A model axis: ``--devices D·M --mesh-shape DxM`` with M > 1 starts D·M
ranks (``launch/mesh.py``'s ``run_ranks``); the M ranks of one data
coordinate are one pod host, whose server U-Net holds its block of each
convolution's output channels (``models/unet.py``'s ``shard_unet``) and
whose engines run in lockstep, their windows eager (a CUDA graph cannot
hold the ranks' gloo barriers; the first line says so).  Each host's
record also says whether its completions are the same bits on all its
model ranks (``model_bitwise``) and counts the collectives of its measured
serve; model rank 0 of each host reports, and rank 0 writes.  One host
over two model ranks::

    python -m repro_torch.launch.serve_diffusion --devices 2 \
        --mesh-shape 1x2 --device cpu --config launcher --T 10 \
        --requests 6 --slots 4
"""
import argparse
import contextlib
import dataclasses
import io
import json
import socket
import time


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--config", choices=["paper", "launcher"],
                    default="paper")
    ap.add_argument("--T", type=int, default=100,
                    help="diffusion steps (paper §4: 100)")
    ap.add_argument("--image", type=int, default=0,
                    help="image size (0 = the config's own)")
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=2,
                    help="request batch sizes cycle 1..max-batch")
    ap.add_argument("--cut-ratios", type=float, nargs="+",
                    default=[0.25, 0.5, 0.75])
    ap.add_argument("--clients", type=int, default=4,
                    help="private client models finishing the chain")
    ap.add_argument("--policy", choices=["fifo", "cut_ratio"],
                    default="cut_ratio")
    ap.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim"],
                    help="ddpm = dense T-step chain; ddim = strided "
                         "--num-steps subsequence")
    ap.add_argument("--num-steps", type=int, default=0,
                    help="DDIM trajectory length K (0 = dense T steps)")
    ap.add_argument("--eta", type=float, default=0.0,
                    help="DDIM stochasticity in [0,1]")
    ap.add_argument("--guidance", type=float, default=None,
                    help="classifier-free guidance scale w: adds a guided "
                         "'ddpm_g' menu entry and routes requests through it "
                         "(all of them, or cycled with the others under "
                         "--mix); a guided request takes a cond+uncond lane "
                         "pair an image.  Needs --num-classes > 0")
    ap.add_argument("--num-classes", type=int, default=0,
                    help="class-conditional U-Net: N labels + a null one "
                         "(0 = unconditional)")
    ap.add_argument("--mix", action="store_true",
                    help="requests cycle over the whole menu (dense ddpm + "
                         "a strided ddim, + ddpm_g under --guidance) instead "
                         "of one --sampler")
    ap.add_argument("--pack", action="store_true",
                    help="wave packing in the scheduler: same-(sampler, "
                         "cut, guidance) candidates behind the head fill "
                         "each window's freed slots (admission order "
                         "changes, completions are bitwise the same)")
    ap.add_argument("--min-kid", type=float, default=None,
                    help="KID-gated admission floor: each request's "
                         "disclosure is scored on a calibration batch before "
                         "it takes a slot; below the floor it is bumped to a "
                         "noisier cut or rejected (default: no gate)")
    ap.add_argument("--calib", type=int, default=16,
                    help="calibration images of the admission gate "
                         "(synthetic client images, >= 2)")
    ap.add_argument("--step-backend", default="cuda_masked",
                    choices=["torch", "triton", "cuda_masked"],
                    help="denoise-tick StepBackend; cuda_masked runs the "
                         "whole masked tick as one CUDA kernel")
    ap.add_argument("--ticks-per-dispatch", type=int, default=1,
                    help="k lane ticks per window; admission and retirement "
                         "happen at window boundaries")
    ap.add_argument("--async-depth", type=int, default=1,
                    help="windows in flight: 1 = synchronous, 2 = plan and "
                         "launch window N+1 while window N runs")
    ap.add_argument("--finish-mode", choices=["stream", "drain"],
                    default="stream",
                    help="client segment: stream = finish waves launched at "
                         "window boundaries while later server windows run "
                         "(default); drain = one pass after the server "
                         "queue empties.  x0 is bitwise the same")
    ap.add_argument("--finish-async-depth", type=int, default=1,
                    help="streamed finish waves in flight before the oldest "
                         "is waited on")
    ap.add_argument("--spare-columns", type=int, default=0,
                    help="preallocate N spare coefficient-table columns; "
                         "the launcher registers a 'dyn' DDIM trajectory "
                         "into them (again between its two serves, with no "
                         "new graph capture) and, with --mix, routes "
                         "requests through it")
    ap.add_argument("--compare-sequential", action="store_true",
                    help="also time one split_sample call per request "
                         "(serve_sequential) and print the engine's "
                         "speed-up")
    ap.add_argument("--arrival-every", type=int, default=0,
                    help="0 = all at tick 0; k = one request every k ticks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="",
                    help="write the serve summary to this path")
    ap.add_argument("--trace-out", default="",
                    help="export a Chrome trace-event JSON of the host "
                         "loop's spans and one track a request (load in "
                         "chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default="",
                    help="append registry snapshots (JSON-lines) every "
                         "--metrics-every windows")
    ap.add_argument("--metrics-every", type=int, default=1,
                    help="snapshot cadence in windows for --metrics-out")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace of each serve's "
                         "first --profile-windows windows into this "
                         "directory")
    ap.add_argument("--profile-windows", type=int, default=4)
    ap.add_argument("--devices", type=int, default=0,
                    help="pod mode: N host processes (torch.multiprocessing, "
                         "spawn), each a pod host with slots/N lanes on its "
                         "device (the same card, or the CPU), over one "
                         "shared queue; 0 = one process, no pod")
    ap.add_argument("--mesh-shape", default="",
                    help="DxM, e.g. 2x1: D pod hosts on the data axis, each "
                         "over M model ranks that split the server U-Net's "
                         "convolutions by output channel")
    ap.add_argument("--out", default="",
                    help="write every completion's x_mid and x0 (the pod's "
                         "owned rows joined on host 0) and its admit and "
                         "retire ticks to this .npz")
    return ap.parse_args(argv)


def launcher_config(image: int = 8, num_classes: int = 0):
    """The reference launcher's small U-Net (``serve_diffusion.py:190``)."""
    from repro_torch.configs import UNetConfig
    return dataclasses.replace(
        UNetConfig().reduced(), image_size=image, base_channels=8,
        channel_mults=(1, 2), n_res_blocks=1, attn_resolutions=(),
        time_dim=32, norm_groups=4, num_classes=num_classes)


def main(argv=None):
    args = _parse_args(argv)
    if not (args.devices or args.mesh_shape):
        _serve(args)
        return
    from repro_torch.launch.mesh import host_mesh
    mesh = host_mesh(args.mesh_shape, args.devices or None)
    if mesh[1] > 1:
        from repro_torch.launch.mesh import run_ranks
        run_ranks(_model_rank, mesh[0] * mesh[1], (args, mesh),
                  timeout_s=MESH_TIMEOUT_S)
        return
    if mesh[0] == 1:
        _serve(args, mesh=mesh)
        return
    import torch.multiprocessing as mp
    # CUDA needs fresh interpreters: the spawn start method
    mp.start_processes(_pod_host, args=(args, mesh, _free_port()),
                       nprocs=mesh[0], start_method="spawn")


# a model-axis serve's deadline (its ranks are killed after it)
MESH_TIMEOUT_S = 3000.0


def _model_rank(rank: int, port: int, args, mesh) -> None:
    """One rank of a model-axis serve: open the (data, model) mesh, then
    serve as model rank ``model`` of pod host ``data`` (the data axis's
    group is the pod's)."""
    from repro_torch.launch.mesh import Pod, launcher_rank
    from repro_torch.launch.steps import make_ctx
    with launcher_rank(rank, port, mesh, args.device) as m:
        pod = None
        if mesh[0] > 1:
            pod = Pod(hosts=mesh[0], host_id=m.coords["data"],
                      group=m.group("data"))
        _serve(args, pod, mesh, ctx=make_ctx(m))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _pod_host(rank: int, args, mesh, port: int) -> None:
    """One pod host: join the gloo group, then serve as host ``rank``."""
    import torch

    from repro_torch.launch.mesh import init_pod
    if args.device == "cpu":
        # the hosts share the machine's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // mesh[0]))
    pod = init_pod(f"127.0.0.1:{port}", mesh[0], rank)
    try:
        if rank == 0:
            _serve(args, pod, mesh)
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                _serve(args, pod, mesh)
    finally:
        pod.close()


def _owned(res) -> dict:
    """This host's rows of every completion: {req_id: (admit tick, retire
    tick, batch, owned images, their x_mid rows, their x0 rows)}."""
    out = {}
    for rid, comp in res.completions.items():
        own = [int(i) for i in range(comp.request.batch) if comp.owned[i]]
        out[rid] = (int(comp.admit_tick), int(comp.retire_tick),
                    comp.request.batch, own, comp.x_mid[own],
                    None if comp.x0 is None else comp.x0[own])
    return out


def _same_owned(a: dict, b: dict) -> bool:
    """Whether two serves' :func:`_owned` rows and ticks are the same
    bits."""
    import numpy as np
    if sorted(a) != sorted(b):
        return False
    for rid in a:
        *head_a, xm_a, x0_a = a[rid]
        *head_b, xm_b, x0_b = b[rid]
        if head_a != head_b or not np.array_equal(xm_a, xm_b):
            return False
        if (x0_a is None) != (x0_b is None) or \
                (x0_a is not None and not np.array_equal(x0_a, x0_b)):
            return False
    return True


def _merge_rows(parts, path: str) -> None:
    """Join the hosts' :func:`_owned` rows into one ``.npz``: per request
    ``x_mid_<id>``, ``x0_<id>`` and ``ticks_<id>`` (admit, retire).  Raises
    when hosts disagree on a request's ticks or leave a row unowned."""
    import numpy as np
    arrays = {}
    for rid in sorted(parts[0]):
        admit, retire, batch, _, xm, x0 = parts[0][rid]
        x_mid = np.zeros((batch,) + xm.shape[1:], np.float32)
        x_0 = None if x0 is None else np.zeros_like(x_mid)
        seen = np.zeros(batch, bool)
        for part in parts:
            a, r, _, own, xm, x0 = part[rid]
            if (a, r) != (admit, retire):
                raise RuntimeError(f"request {rid}: hosts disagree on its "
                                   f"ticks ({a}, {r}) != ({admit}, {retire})")
            seen[own] = True
            x_mid[own] = xm
            if x_0 is not None:
                x_0[own] = x0
        if not seen.all():
            raise RuntimeError(f"request {rid}: rows {np.nonzero(~seen)[0]} "
                               "owned by no host")
        arrays[f"x_mid_{rid}"] = x_mid
        if x_0 is not None:
            arrays[f"x0_{rid}"] = x_0
        arrays[f"ticks_{rid}"] = np.array([admit, retire])
    np.savez(path, **arrays)


def _rows_digest(owned: dict) -> str:
    """A digest of :func:`_owned`'s rows and ticks."""
    import hashlib
    h = hashlib.sha256()
    for rid in sorted(owned):
        *head, xm, x0 = owned[rid]
        h.update(repr((rid, head)).encode())
        h.update(xm.tobytes())
        if x0 is not None:
            h.update(x0.tobytes())
    return h.hexdigest()


def _serve(args, pod=None, mesh=None, ctx=None):
    """The launcher on one process: the single host, or host
    ``pod.host_id`` of a pod over the ``mesh`` (data, model) shape, and
    with ``ctx`` (a model axis above 1) one of that host's model ranks."""
    import numpy as np
    import torch

    from repro_torch.parallel import comm

    from repro_torch.configs import UNetConfig
    from repro_torch.device import resolve_device
    from repro_torch.diffusion.sampler import make_sampler
    from repro_torch.diffusion.schedule import cosine_schedule
    from repro_torch.kernels import ops
    from repro_torch.models.unet import UNet, shard_unet
    from repro_torch.serve import (AdmissionPolicy, EngineConfig,
                                   ObsConfig, Request, ServeEngine,
                                   make_scheduler, serve_sequential)

    device = resolve_device(args.device)
    if device.type == "cuda":
        # the reference computes in f32: no TF32 in convolutions or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.sampler == "ddpm" and args.num_steps:
        raise SystemExit("--num-steps strides the chain, which needs "
                         "--sampler ddim (ddpm is dense-only)")
    if args.guidance is not None and args.num_classes <= 0:
        raise SystemExit("--guidance needs a conditional model: pass "
                         "--num-classes N (labels 0..N-1, null label N)")
    if args.config == "paper":
        ucfg = dataclasses.replace(UNetConfig(),
                                   num_classes=args.num_classes)
        if args.image:
            ucfg = dataclasses.replace(ucfg, image_size=args.image)
    else:
        ucfg = launcher_config(args.image or 8, args.num_classes)
    samplers = {"ddpm": make_sampler(args.T)}
    if args.sampler == "ddim" or args.mix:
        samplers["ddim"] = make_sampler(
            args.T, "ddim", args.num_steps or max(2, args.T // 2), args.eta)
    if args.guidance is not None:
        samplers["ddpm_g"] = make_sampler(args.T, guidance=args.guidance)
    dyn_sampler = None
    if args.spare_columns:
        dyn_sampler = make_sampler(args.T, "ddim",
                                   min(args.spare_columns,
                                       max(2, args.T // 4)), args.eta)
    request_samplers = (list(samplers) + (["dyn"] if dyn_sampler else [])
                        if args.mix else
                        ["ddpm_g" if args.guidance is not None
                         else args.sampler])
    traffic = ("mix of " + "/".join(request_samplers) if args.mix
               else samplers[request_samplers[0]].describe())
    model_ranks = mesh[1] if mesh else 1
    mesh_text = f"mesh=data:{mesh[0]}xmodel:{mesh[1]} " if mesh else ""
    if model_ranks > 1:
        mesh_text += ("windows=eager (a CUDA graph cannot hold the model "
                      "ranks' gloo barriers) ")
    print(f"serve_diffusion: {mesh_text}device={device} config={args.config} "
          f"image={ucfg.image_size} slots={args.slots} "
          f"requests={args.requests} T={args.T} policy={args.policy} "
          f"backend={args.step_backend} sampler={traffic} "
          f"k={args.ticks_per_dispatch} async_depth={args.async_depth} "
          f"finish={args.finish_mode}/{args.finish_async_depth} "
          f"spare_columns={args.spare_columns} pack={args.pack} "
          f"num_classes={args.num_classes} guidance={args.guidance} "
          f"min_kid={args.min_kid}", flush=True)

    server = UNet(ucfg, seed=args.seed).to(device).eval()
    if model_ranks > 1:
        shard_unet(server, ctx)
    clients = [UNet(ucfg, seed=args.seed + 1 + c).to(device).eval()
               for c in range(args.clients)]
    requests = [
        Request(req_id=i, seed=args.seed * 1_000_003 + i,
                batch=1 + i % args.max_batch,
                cut_ratio=args.cut_ratios[i % len(args.cut_ratios)],
                client_idx=i % args.clients,
                arrival_tick=i * args.arrival_every,
                sampler=request_samplers[i % len(request_samplers)],
                label=i % args.num_classes if args.num_classes else 0)
        for i in range(args.requests)]
    sched = cosine_schedule(args.T)
    admission = None
    if args.min_kid is not None:
        from repro_torch.data.synthetic import (ClientDataConfig,
                                                make_client_datasets)
        calib_sets, _ = make_client_datasets(ClientDataConfig(
            n_clients=1, per_client=args.calib, image_size=ucfg.image_size,
            holdout=2, seed=args.seed))
        admission = AdmissionPolicy(sched, calib_sets[0].to(device),
                                    min_kid=args.min_kid, samplers=samplers)

    obs = None
    if args.trace_out or args.metrics_out or args.profile_dir:
        obs = ObsConfig(trace_path=args.trace_out or None,
                        metrics_path=args.metrics_out or None,
                        metrics_every=args.metrics_every,
                        profile_dir=args.profile_dir or None,
                        profile_windows=args.profile_windows)
    cfg = EngineConfig(
        sched=sched, image_shape=(ucfg.image_size, ucfg.image_size,
                                  ucfg.in_channels),
        slots=args.slots,
        scheduler=make_scheduler(args.policy, args.T, samplers=samplers,
                                 pack=args.pack),
        step_backend=args.step_backend, samplers=samplers,
        ticks_per_dispatch=args.ticks_per_dispatch,
        async_depth=args.async_depth, finish_mode=args.finish_mode,
        finish_async_depth=args.finish_async_depth,
        spare_columns=args.spare_columns, device=device,
        num_classes=args.num_classes, admission=admission, obs=obs,
        hosts=mesh[0] if mesh else 1, pod=pod,
        cuda_graphs=model_ranks == 1)
    eng = ServeEngine(cfg, server)
    if dyn_sampler is not None:
        eng.register_sampler("dyn", dyn_sampler)
    # warm-up: builds the kernels, captures the window graphs, fills the
    # gate's score cache
    warm = eng.serve(list(requests), clients)
    captures = eng.captures
    if dyn_sampler is not None:
        # registered again at the serve boundary: written in place into
        # the spare columns the captured graphs read
        eng.register_sampler("dyn", dyn_sampler)
    before = ops.launch_counts()
    comm.reset_stats()
    res = eng.serve(list(requests), clients)
    launches = {n: c - before[n] for n, c in ops.launch_counts().items()}
    collectives = dict(comm.STATS)
    if eng.captures != captures:
        raise RuntimeError(f"the measured serve captured "
                           f"{eng.captures - captures} new graph(s)")
    if dyn_sampler is not None:
        print(f"dynamic menu: {eng.registered_samplers()} "
              f"(dyn={dyn_sampler.describe()}, 0 new graph captures)",
              flush=True)
    s = res.summary
    print(f"engine: {s['requests']} requests ({s['images']} images) in "
          f"{res.wall_s:.2f}s over {s['ticks']} ticks | "
          f"{s['requests_per_s']:.1f} req/s | "
          f"p50/p95 latency {s['latency_ticks_p50']:.0f}/"
          f"{s['latency_ticks_p95']:.0f} ticks | "
          f"util {s['utilization_mean']:.2f}", flush=True)
    print(f"windows: {s['windows']} of k={s['ticks_per_dispatch']}, "
          f"async_depth {s['async_depth']}, {eng.captures} graph(s) "
          f"captured, {eng.h2d_copies} host-to-device copies over both "
          "serves", flush=True)
    print(f"client finish ({s['finish_mode']}): "
          f"{s['finish_s'] * 1e3:.1f}ms in {s['finish_batches']} "
          f"batch(es), overlap_frac {s['overlap_frac']:.2f} "
          f"(tail {s['finish_tail_s'] * 1e3:.1f}ms)", flush=True)
    print(f"flops: server {s['server_flops']:.3g} client "
          f"{s['client_flops']:.3g} (client_fraction "
          f"{s['client_fraction']:.3f})", flush=True)
    if "fragmentation_frac" in s:
        top = ", ".join(f"{c}:{v}" for c, v in sorted(
            s["occupancy_by_class"].items(), key=lambda kv: -kv[1])[:4])
        print(f"slot pool (pack={args.pack}): fragmentation_frac "
              f"{s['fragmentation_frac']:.4f} | occupancy by class "
              f"(lane-ticks): {top}", flush=True)
    if admission is not None:
        a = s["admission"]
        dk = a.get("disclosure_kid", {})
        print(f"admission (min_kid={args.min_kid}): {a['admitted']} "
              f"admitted, {a['bumped']} bumped, {a['rejected']} rejected | "
              f"served disclosure KID min/mean {dk.get('min', 0):.4f}/"
              f"{dk.get('mean', 0):.4f} | scoring {admission.model_calls} "
              f"model calls on {args.calib} images, "
              f"{admission.score_s:.2f}s", flush=True)
        for d in res.rejected.values():
            print(f"  rejected req {d.req_id}: {d.describe()}", flush=True)
    for comp in res.completions.values():
        assert comp.x0 is not None and np.isfinite(comp.x0).all(), \
            f"non-finite output for request {comp.request.req_id}"
    if res.timelines:
        rid = min(res.timelines)
        print(f"request {rid} lifecycle: " + " -> ".join(
            f"{e['stage']}@t{e['tick']}" if "tick" in e else e["stage"]
            for e in res.timelines[rid]), flush=True)
    if args.trace_out:
        print(f"wrote trace {args.trace_out} "
              f"({len(eng.obs.tracer.events())} events)", flush=True)
    if args.metrics_out:
        print(f"wrote metrics {args.metrics_out}", flush=True)
    if args.profile_dir:
        print(f"wrote profiles into {args.profile_dir}", flush=True)
    if args.compare_sequential:
        seq_cfg = dataclasses.replace(cfg, samplers=dict(eng.samplers))
        serve_sequential(seq_cfg, requests[:1], server, clients)   # warm
        t0 = time.perf_counter()
        serve_sequential(seq_cfg, requests, server, clients)
        seq_s = time.perf_counter() - t0
        s["sequential_s"] = seq_s
        s["speedup_vs_sequential"] = seq_s / res.wall_s
        print(f"sequential split_sample: {seq_s:.2f}s -> speedup "
              f"{seq_s / res.wall_s:.2f}x", flush=True)
    if mesh:
        # every host's record and rows, merged on host 0
        cuda = device.type == "cuda"
        record = {"host": eng.host_id, "wall_s": res.wall_s,
                  "ticks": s["ticks"],
                  "ms_per_tick": res.wall_s * 1e3 / max(s["ticks"], 1),
                  "images_per_s": s["images_per_s"],
                  "finish_lanes": s.get("finish_lanes", 0),
                  "halo_lanes": eng.halo_lanes,
                  # the measured serve repeats the warm-up's requests: a
                  # host's rows and ticks must be the same bits
                  "repeat_bitwise": _same_owned(_owned(warm), _owned(res)),
                  "launches": {n: launches[n] for n in ("traj_masked_step",
                                                        "lane_noise")},
                  "collectives": collectives,
                  "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                              if cuda else None),
                  "peak_reserved_gb": (torch.cuda.max_memory_reserved(device)
                                       / 1e9 if cuda else None)}
        if ctx is not None:
            # the host's model ranks ran in lockstep: the same bits
            digests = [None] * model_ranks
            torch.distributed.all_gather_object(
                digests, _rows_digest(_owned(res)),
                group=ctx.mesh.group(ctx.model_axis))
            record["model_bitwise"] = len(set(digests)) == 1
        gather = pod.all_gather_object if pod is not None \
            else (lambda obj: [obj])
        records = gather(record)
        parts = gather(_owned(res))
        s["mesh"] = f"data:{mesh[0]}xmodel:{mesh[1]}"
        s["hosts"] = records
        s["pod_images_per_s"] = s["images"] / max(r["wall_s"]
                                                  for r in records)
        for r in records:
            print(f"host {r['host']}/{mesh[0]}: {r['ms_per_tick']:.2f} ms a "
                  f"tick over {r['ticks']} ticks, {r['images_per_s']:.2f} "
                  f"images/s, {r['finish_lanes']} finish lanes, "
                  f"{r['halo_lanes']} halo lane-windows, rows bitwise the "
                  f"warm-up's {r['repeat_bitwise']}"
                  + (f", on its {model_ranks} model ranks "
                     f"{r['model_bitwise']}" if "model_bitwise" in r else "")
                  + f", launches {r['launches']}, collectives "
                  f"{r['collectives']['calls']} calls "
                  f"{r['collectives']['bytes'] / 1e6:.1f} MB "
                  f"{r['collectives']['ms']:.1f} ms, peak "
                  + ("n/a" if r["peak_gb"] is None else
                     f"{r['peak_gb']:.2f} GB allocated / "
                     f"{r['peak_reserved_gb']:.2f} reserved"), flush=True)
        print(f"pod: {s['images']} images, {s['pod_images_per_s']:.3f} "
              "images/s over the slowest host's wall", flush=True)
        writer = eng.host_id == 0 and (ctx is None or ctx.model_rank == 0)
        if args.out and writer:
            _merge_rows(parts, args.out)
            print(f"wrote {args.out}", flush=True)
    elif args.out:
        _merge_rows([_owned(res)], args.out)
        print(f"wrote {args.out}", flush=True)
    eng.close()
    if args.json and eng.host_id == 0 and (ctx is None or
                                           ctx.model_rank == 0):
        with open(args.json, "w") as f:
            json.dump(s, f, indent=1)
        print(f"wrote {args.json}")
    print("serve_diffusion OK")


if __name__ == "__main__":
    main()
