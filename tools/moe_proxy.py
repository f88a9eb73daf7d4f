"""How far apart may two correct paths of an MoE model land in bf16?

A proxy for ``chip_smoke.py``'s phase 7 at the models' own widths (d_model,
heads, MLA ranks, the number of experts, top-k, the capacity factor), with
each expert's width (``d_ff_expert``) and the vocabulary cut so that a
model fits a CPU's memory, at phase 7's depth, bf16, random weights from a
seed.  For DeepSeek-V2 and Kimi-K2 it prints what phase 7 holds to a
tolerance:

- (b) the first MoE layer on the prefill's hidden states against
  ``chip_smoke.plain_moe`` (a per-expert loop): kept and dropped counts,
  and max |Δ| / max |out| and mean |Δ| / mean |out|;
- (b) Kimi-K2's prefill through ``kernel="torch"`` against
  ``kernel="flash"`` (the kernel's plain version here): the share of
  routing decisions that agree, and the logits' max and mean |Δ|;
- (c) the batch-1 decode chain against the prefill of the same tokens at
  the dropless capacity factor: the logits' max and mean |Δ|.

``--parts`` instead builds one MoE layer (random weights and a random bf16
input of batch x seq tokens from a seed) and holds each part against the
same math in exact float32 (the operands upcast): the whole layer against
``chip_smoke.plain_moe``, the expert products, the gate product with a
float32 result, the rounded silu·up, the down product, the shared experts
and the combine; for each, max |Δ| / max, mean |Δ| / mean and the share of
elements that differ.  This is where the card's bf16 products part from
exact float32 sums.

::

    PYTHONPATH=src python tools/moe_proxy.py --device cpu
    python tools/moe_proxy.py --parts --arch deepseek-v2-236b \
        --d-ff-expert 0 --batch 4 --seq 2048               # the card

``--d-ff-expert 0`` and ``--vocab 0`` keep the config's own.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402


def gap(a, b):
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(d.mean())


def proxy(arch, layers, args, dev):
    cfg = cs.moe_config(arch, layers)
    cut = {k: v for k, v in (("d_ff_expert", args.d_ff_expert),
                             ("vocab_size", args.vocab)) if v}
    cfg = dataclasses.replace(cfg, **cut)
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device=dev)
    print(f"{arch}: {layers} layers, cut {cut or 'nothing'}, "
          f"{cfg.param_count()} params, drawn in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    g = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                           generator=g, device=dev)
    batch = {"tokens": tokens}
    with cs.moe_recorder() as rec:
        logits = make_prefill_step(cfg, kernel="flash")(model, batch)
    x, p = rec["inputs"][0]
    with torch.inference_mode():
        got, _ = moe_mod.moe_forward(x, p, cfg)
        want, kept, dropped = cs.plain_moe(x, p, cfg)
    keep = rec["routes"][0][1]
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    print(f"  (b) layer vs per-expert loop: kept {int(keep.sum())} / {kept}, "
          f"dropped {int((~keep).sum())} / {dropped}; max |d| "
          f"{float(d.max() / w.max()):.5f} of max |out| "
          f"{float(w.max()):.4f}, mean {float(d.mean() / w.mean()):.6f} of "
          f"mean |out|", flush=True)
    if cfg.attn_type == "gqa":
        with cs.moe_recorder() as rec_t:
            logits_t = make_prefill_step(cfg, kernel="torch")(model, batch)
        shares = [cs.route_agreement(a[0], b[0])
                  for a, b in zip(rec["routes"], rec_t["routes"])]
        mx, mean = gap(logits, logits_t)
        print(f"  (b) torch vs flash: routing agrees "
              + ", ".join(f"{v:.4%}" for v in shares)
              + f"; logits max |d| {mx:.4f} mean {mean:.5f} (logits max "
              f"{float(logits.float().abs().max()):.3f}, mean |logit| "
              f"{float(logits.float().abs().mean()):.4f})", flush=True)
    n = args.decode
    dropless = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    first = {"tokens": tokens[:1, :n]}
    ref = make_prefill_step(dropless)(model, first)
    decode = make_decode_step(cfg)
    cache = tf.init_cache(cfg, 1, n, device=dev)
    outs = []
    for pos in range(n):
        lg, cache = decode(model, cache,
                           {"tokens": first["tokens"][:, pos:pos + 1]}, pos)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    mx, mean = gap(dec, ref)
    first_bad = int(((dec.float() - ref.float()).abs().amax(-1) > 0.5)
                    .float().argmax()) if mx > 0.5 else None
    print(f"  (c) decode chain vs dropless prefill, {n} steps: max |d| "
          f"{mx:.4f} mean {mean:.5f}"
          + (f" (first position off by > 0.5: {first_bad})"
             if first_bad is not None else ""), flush=True)


def rel(a, b) -> str:
    d = (a.float() - b.float()).abs()
    w = b.float().abs()
    return (f"max {float(d.max() / w.max()):.5f} mean "
            f"{float(d.mean() / w.mean()):.6f} differ "
            f"{float((d > 0).float().mean()):.4f}")


def parts(arch, args, dev):
    cfg = get_config(arch)
    if args.d_ff_expert:
        cfg = dataclasses.replace(cfg, d_ff_expert=args.d_ff_expert)
    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    p = moe_mod.MoE(cfg, dtype=bf16, device=dev)
    p.reset_parameters(g)
    p.shared.reset_parameters(g)
    x = torch.randn((args.batch, args.seq, cfg.d_model), generator=g,
                    device=dev).to(bf16)
    print(f"{arch} MoE layer, d_ff_expert {cfg.d_ff_expert}, "
          f"{args.batch}x{args.seq} tokens, on {dev}", flush=True)
    with torch.inference_mode():
        got, _ = moe_mod.moe_forward(x, p, cfg)
        want, _, _ = cs.plain_moe(x, p, cfg)
        print(f"  whole vs per-expert loop: {rel(got, want)}")
        xf = x.reshape(-1, cfg.d_model)
        e = cfg.n_experts
        cap = moe_mod.capacity(xf.shape[0], cfg.top_k, e, cfg.capacity_factor)
        tp, ti, _ = moe_mod.router_topk(xf, p.router, cfg.top_k)
        pos, keep = moe_mod.dispatch_indices(ti, e, cap)
        buf = moe_mod.scatter_dispatch(xf, ti, pos, keep, e, cap)

        def swiglu32(xs, wg, wu):
            return (F.silu(xs.to(f32) @ wg.to(f32)) *
                    (xs.to(f32) @ wu.to(f32))).to(bf16)
        ys = moe_mod.expert_ffn(buf, p.w_gate, p.w_up, p.w_down)
        h32 = swiglu32(buf, p.w_gate, p.w_up)
        ys32 = (h32.to(f32) @ p.w_down.to(f32)).to(bf16)
        print(f"  expert products: {rel(ys, ys32)}")
        gate = moe_mod.matmul_f32(buf, p.w_gate)
        gate32 = buf.to(f32) @ p.w_gate.to(f32)
        print(f"  gate product (float32 result): max |d| "
              f"{float((gate - gate32).abs().max()):.3e} at max "
              f"{float(gate32.abs().max()):.3f}")
        h = (F.silu(gate) * moe_mod.matmul_f32(buf, p.w_up)).to(bf16)
        print(f"  rounded silu·up: {rel(h, h32)}")
        print(f"  down product on the same silu·up: "
              f"{rel(torch.bmm(h, p.w_down), (h.to(f32) @ p.w_down.to(f32)).to(bf16))}")
        sh = moe_mod.shared_expert(xf, p.shared)
        sh32 = (swiglu32(xf, p.shared.w_gate, p.shared.w_up).to(f32)
                @ p.shared.w_down.to(f32)).to(bf16)
        print(f"  shared experts: {rel(sh, sh32)}")
        comb = moe_mod.gather_combine(ys32, ti, tp, pos, keep)
        e_flat = torch.where(keep, ti, 0).reshape(-1).long()
        p_flat = torch.where(keep, pos, 0).reshape(-1).long()
        rows = ys32[e_flat, p_flat].reshape(xf.shape[0], cfg.top_k, -1)
        w = (tp * keep).to(bf16).to(f32)
        comb32 = (rows.to(f32) * w[..., None]).sum(1).to(bf16)
        print(f"  combine: {rel(comb, comb32)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--arch", nargs="*", default=[a for a, _ in cs.MOE_MODELS])
    ap.add_argument("--d-ff-expert", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=32_000)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--decode", type=int, default=64)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--parts", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.threads:
        torch.set_num_threads(args.threads)
    for arch, layers in cs.MOE_MODELS:
        if arch in args.arch:
            if args.parts:
                parts(arch, args, dev)
            else:
                proxy(arch, layers, args, dev)


if __name__ == "__main__":
    main()
