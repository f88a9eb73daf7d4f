"""LM serving launcher: cache-filling prefill + decode service loop
(counterpart of ``repro/launch/serve.py``)::

    python -m repro_torch.launch.serve --arch yi-6b --no-reduced \
        --requests 2 --batch 4 --prompt-len 128 --tokens 32
    python -m repro_torch.launch.serve --device cpu --arch yi-6b \
        --requests 2 --batch 2 --prompt-len 8 --tokens 4
    python -m repro_torch.launch.serve --arch yi-6b --no-reduced \
        --devices 2 --mesh-shape 1x2 --requests 2 --batch 4 --prompt-len 32

Each request wave is a batch of random prompts.  The service fills a fresh
KV cache by chaining ``decode_step`` over the prompt positions, as the
reference does, takes the first new token by argmax, and then decodes the
rest, sampling each token from the logits with a ``torch.Generator``.  ``--trace-out`` exports a
Chrome trace with a ``prefill`` and a ``decode`` span a request; each span
ends after the device is synchronized, so it covers the device's work.
``--reduced`` (the default, as in the reference) serves the config's tiny
member; ``--no-reduced`` serves it at full width and depth, and raises a
``ValueError`` before it allocates anything when the config's weights
(``param_count()`` times the dtype's bytes) exceed the card's free memory
(on the CPU: ``CPU_WEIGHT_BYTES``), as DeepSeek-V2's and Kimi-K2's do on
one card.  Weights are random, drawn from ``--seed``.  The default device
is CUDA; without a card the launcher raises unless ``--device cpu`` is
given.

``--devices N --mesh-shape DxM`` serves on a (data, model) mesh of N ranks
(``launch/mesh.py``'s ``run_ranks``): the weights sharded by
``param_specs`` (tensor parallelism over ``model``, the experts over
``model`` for an MoE), the request's rows over ``data``, the cache by
``cache_specs``; ``--seq-shard-attn`` and ``--cache-seq-shard`` are the
reference's two sequence levers.  Every rank samples the same tokens from
the logits gathered over ``data``.  The weight guard counts a rank's shard
against its share of the card.  Rank 0 prints ``mesh=data:Dxmodel:M`` and
the transport.
"""
import argparse

# the most bytes of weights the launcher allocates on the CPU
CPU_WEIGHT_BYTES = 64 << 30
# the deadline of a mesh run's ranks
MESH_TIMEOUT_S = 3000.0


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=0,
                    help="devices (ranks) to serve on; 0 = one")
    ap.add_argument("--mesh-shape", default="",
                    help="DxM; empty = every device on the data axis")
    ap.add_argument("--seq-shard-attn", action="store_true")
    ap.add_argument("--cache-seq-shard", action="store_true")
    ap.add_argument("--trace-out", default="",
                    help="export a Chrome trace-event JSON with one span "
                         "per prefill and decode wave (Perfetto-loadable)")
    return ap.parse_args(argv)


def check_weights_fit(cfg, device, ctx=None) -> int:
    """The bytes of ``cfg``'s weights a rank holds (all of them without a
    mesh); raises ``ValueError`` when they exceed the card's free memory,
    or the rank's share of it when ranks share a card, or
    ``CPU_WEIGHT_BYTES`` on the CPU."""
    import torch

    from repro_torch.launch.train import card_room, local_params
    need = local_params(cfg, ctx) * \
        (torch.finfo(getattr(torch, cfg.dtype)).bits // 8)
    if device.type == "cuda":
        room, where = card_room(device, ctx)
    else:
        room, where = CPU_WEIGHT_BYTES, \
            f"the CPU limit of {CPU_WEIGHT_BYTES} bytes"
    if need > room:
        raise ValueError(
            f"{cfg.arch_id}: {cfg.param_count()} parameters need {need} bytes "
            f"of {cfg.dtype} weights a rank, more than {where}; shard them "
            "over more cards (--devices, --mesh-shape)")
    return need


def main(argv=None):
    """Serve the waves; returns the per-request timings
    ``[{"prefill_s", "decode_s", "tok_s"}, ...]``, tok_s counting the
    tokens of the decode steps after the first token (None after a mesh
    run, whose rank 0 prints them)."""
    args = _parse_args(argv)
    from repro_torch.launch.mesh import host_mesh
    dims = host_mesh(args.mesh_shape, args.devices or None)
    if dims[0] * dims[1] > 1:
        from repro_torch.launch.mesh import run_ranks
        if args.device == "cuda":
            import torch
            torch.cuda.empty_cache()
        run_ranks(_rank_main, dims[0] * dims[1], (args, dims),
                  timeout_s=MESH_TIMEOUT_S)
        return None
    return _serve(args)


def _rank_main(rank: int, port: int, args, dims) -> None:
    """One rank of a mesh run; ranks other than 0 print nothing."""
    from repro_torch.launch.mesh import launcher_rank
    from repro_torch.launch.steps import make_ctx
    with launcher_rank(rank, port, dims, args.device) as mesh:
        _serve(args, make_ctx(mesh, seq_shard_attn=args.seq_shard_attn,
                              cache_seq_shard=args.cache_seq_shard))


def _serve(args, ctx=None):
    """The serving loop, on one device or (``ctx``) as a rank of a
    mesh."""
    import time

    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import transformer as tf
    from repro_torch.obs import NULL_TRACER, Tracer

    mesh = ctx.mesh if ctx is not None else None
    device = mesh.device if mesh is not None else resolve_device(args.device)
    tracer = Tracer(process_name="llm-serve") if args.trace_out \
        else NULL_TRACER
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    check_weights_fit(cfg, device, ctx)
    where = (f" mesh=data:{ctx.data_size}xmodel:{ctx.model_size} "
             f"transport={mesh.transport}") if mesh is not None else ""
    print(f"serving {args.arch} ({'reduced' if args.reduced else 'full'}, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}) on "
          f"{device} (window={args.window or 'full'}){where}", flush=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    params = tf.init_params(cfg, seed=args.seed, device=device, ctx=ctx)
    decode = make_decode_step(cfg, window=args.window, ctx=ctx)

    def whole(logits):
        """The logits of every row: a mesh rank's rows gathered."""
        if mesh is None or args.batch % ctx.data_size:
            return logits
        from repro_torch.parallel import comm
        return comm.all_gather(logits, mesh, ctx.batch_axes, 0)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    b, s = args.batch, args.prompt_len
    max_len = s + args.tokens
    stats = []
    for req in range(args.requests):
        prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                device=device)
        cache = tf.init_cache(cfg, b, max_len, window=args.window,
                              device=device, ctx=ctx)
        sync()
        t0 = time.perf_counter()
        with tracer.span("prefill", cat="llm", request=req, batch=b,
                         prompt_len=s):
            for pos in range(s):        # fill the cache, a position a step
                logits, cache = decode(params, cache,
                                       {"tokens": prompts[:, pos:pos + 1]},
                                       pos)
            last = whole(logits)[:, -1]
            sync()
        t_prefill = time.perf_counter() - t0
        tok = torch.argmax(last, dim=-1)[:, None]
        t0 = time.perf_counter()
        with tracer.span("decode", cat="llm", request=req,
                         tokens=args.tokens):
            for i in range(args.tokens - 1):
                logits, cache = decode(params, cache, {"tokens": tok}, s + i)
                logits = whole(logits)
                probs = torch.softmax(logits[:, -1].to(torch.float32),
                                      dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)
            sync()
        t_dec = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"request {req}: non-finite logits")
        steps = args.tokens - 1
        tok_s = steps * b / max(t_dec, 1e-9)
        stats.append({"prefill_s": t_prefill, "decode_s": t_dec,
                      "tok_s": tok_s})
        print(f"request {req}: prefill {b}x{s} {t_prefill:.2f}s | "
              f"decode {steps} steps x {b} {t_dec:.2f}s ({tok_s:.1f} tok/s)",
              flush=True)
    if args.trace_out and not (mesh is not None and any(
            mesh.coords.values())):
        tracer.export(args.trace_out)
        print(f"wrote trace {args.trace_out} "
              f"({len(tracer.events())} events)", flush=True)
    print("serving loop OK", flush=True)
    return stats


if __name__ == "__main__":
    main()
