"""Paper Fig. 3 on the port: sweep the cut-ratio c over {0.0, 0.2, ...,
1.0} (counterpart of the reference's ``examples/cut_ratio_sweep.py``).

For each c, trains the CollaFuse protocol on 3 synthetic-MRI clients and
reports the three trade-off dimensions the paper plots:

  performance  — summed KID(client data, generated)  -> U-shape over c (H1)
  disclosure   — KID/MSE(client data, x_{t_c})       -> high until c small (H2b)
  energy proxy — client share of denoising FLOPs     -> monotone in c (H2c)

    python -m repro_torch.examples.cut_ratio_sweep --rounds 120
    python -m repro_torch.examples.cut_ratio_sweep --device cpu --rounds 1 \\
        --cuts 0.0 0.8 1.0 --per-client 8 --holdout 8 --batch 4 --n-gen 4

Writes ``<out-dir>/cut_ratio_sweep.json``.
"""
import argparse
import json
import os

from repro_torch.data.synthetic import image_batches
from repro_torch.examples.collafuse_healthcare import (add_common_args,
                                                       build, evaluate)


def hypotheses(rows):
    """(H1 line, H2c line, H2c held): the paper's §5 checks on the rows."""
    h1 = None
    by_c = {r["cut_ratio"]: r for r in rows}
    if 1.0 in by_c and len(by_c) > 1:
        local = by_c[1.0]["kid_train_sum"]
        best = min(r["kid_train_sum"] for r in rows if r["cut_ratio"] < 1.0)
        h1 = (f"H1  collaborative best {best:+.4f} vs local(c=1) "
              f"{local:+.4f} -> "
              f"{'SUPPORTED' if best < local else 'NOT SUPPORTED'}")
    fr = [r["client_flop_fraction"]
          for r in sorted(rows, key=lambda r: -r["cut_ratio"])]
    mono = all(a >= b for a, b in zip(fr, fr[1:]))
    h2c = (f"H2c client FLOP share monotone in c -> "
           f"{'SUPPORTED' if mono else 'NOT SUPPORTED'}")
    return h1, h2c, mono


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--cuts", type=float, nargs="+",
                    default=[0.0, 0.2, 0.4, 0.6, 0.8, 1.0])
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--per-client", type=int, default=128)
    ap.add_argument("--holdout", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.rounds < 1:
        raise SystemExit("--rounds must be >= 1")

    rows = []
    for c in args.cuts:
        args.cut_ratio = c
        trainer, ucfg, clients, holdout, batch = build(args)
        iters = [image_batches(cl, batch, seed=i)
                 for i, cl in enumerate(clients)]
        for _ in range(args.rounds):
            m = trainer.train_round([next(it) for it in iters])
        ev = evaluate(trainer, ucfg, clients, holdout, n_gen=args.n_gen)
        row = {
            "cut_ratio": c,
            "kid_train_sum": ev["kid_train_sum"],
            "kid_holdout_sum": ev["kid_holdout_sum"],
            "disclosure_mse": ev["disclosure_mse_mean"],
            "disclosure_kid": sum(r["disclosure"]["kid"]
                                  for r in ev["per_client"]) / args.clients,
            "client_flop_fraction": m["client_fraction"],
        }
        rows.append(row)
        print(f"c={c:.1f}  KID(train)={row['kid_train_sum']:+.4f}  "
              f"KID(holdout)={row['kid_holdout_sum']:+.4f}  "
              f"disclosure_mse={row['disclosure_mse']:.3f}  "
              f"client_flops={row['client_flop_fraction']:.2f}", flush=True)
        del trainer

    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "cut_ratio_sweep.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {path}")

    # --- hypothesis checks (paper §5) --------------------------------------
    h1, h2c, _ = hypotheses(rows)
    if h1 is not None:
        print(h1)
    print(h2c)
    return rows


if __name__ == "__main__":
    main()
