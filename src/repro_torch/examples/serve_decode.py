"""Serve a small LM with batched requests: prefill and autoregressive
decode (counterpart of the reference's ``examples/serve_decode.py``).

Serves the REDUCED member of an architecture the port supports (default
the yi-6b family): draws its weights from ``--seed``, fills the KV cache by
chaining the single-token ``decode_step`` over the prompt positions (a
Python loop where the reference scans), takes the first new token by
argmax, then samples the rest at ``--temperature`` from a
``torch.Generator``::

    python -m repro_torch.examples.serve_decode --arch yi-6b --tokens 16
    python -m repro_torch.examples.serve_decode --arch deepseek-v2-236b
    python -m repro_torch.examples.serve_decode --device cpu --arch zamba2-7b

Prints the reference's lines and raises on non-finite logits or token ids
out of range.  The default device is CUDA; without a card it raises unless
``--device cpu`` is given.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import transformer as tf


def main(argv=None):
    """Serve one batch; returns the generated token ids (B, tokens)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = get_config(args.arch).reduced()
    params = tf.init_params(cfg, seed=args.seed, device=dev)
    n = sum(p.numel() for p in params.parameters())
    print(f"{args.arch} (reduced): {n/1e6:.1f}M params, family={cfg.family}")

    b, s = args.batch, args.prompt_len
    max_len = s + args.tokens
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device=dev)
    cache = tf.init_cache(cfg, b, max_len, device=dev)
    decode = make_decode_step(cfg)

    # ---- prefill: decode_step chained over the prompt positions ----------
    t0 = time.time()
    for pos in range(s):
        logits, cache = decode(params, cache,
                               {"tokens": prompts[:, pos:pos + 1]}, pos)
    last = logits[:, -1]
    sync()
    print(f"prefill {b}x{s}: {time.time()-t0:.2f}s")

    # ---- batched sampling loop -------------------------------------------
    tok = torch.argmax(last, dim=-1)[:, None]
    logits = last[:, None]
    generated = [tok]
    t0 = time.time()
    for i in range(args.tokens - 1):
        logits, cache = decode(params, cache, {"tokens": tok}, s + i)
        probs = torch.softmax(
            logits[:, -1].to(torch.float32) / args.temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=gen)
        generated.append(tok)
    sync()
    dt = time.time() - t0
    out = torch.cat(generated, dim=1)
    print(f"decoded {args.tokens} tokens x {b} seqs in {dt:.2f}s "
          f"({args.tokens * b / max(dt, 1e-9):.1f} tok/s)")
    print("sample token ids:", out[0].tolist())
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise RuntimeError("token ids out of the vocabulary")
    print("OK")
    return out


if __name__ == "__main__":
    main()
