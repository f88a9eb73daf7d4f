#!/usr/bin/env python3
"""The dry run's records as a table: the argument bytes a card (with
``--peak``, argument + temp bytes: the most the step holds) and the
dominant roofline term of every arch × shape (× tag) record under
``results/dryrun_torch/`` (``python -m repro_torch.launch.dryrun``)::

    python tools/dryrun_table.py [--dir DIR] [--mesh single] [--peak]

A cell reads "GB (term)"; ** marks bytes above the card's 80 GB.
The dry run counts and runs nothing on a card, so these are the model's
and the port's counts, not measurements.
"""
import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TERMS = {"compute_s": "compute", "memory_s": "memory",
         "collective_s": "collective"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(ROOT / "results" / "dryrun_torch"))
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--card-gb", type=float, default=80.0)
    ap.add_argument("--peak", action="store_true")
    args = ap.parse_args(argv)
    cells, archs, cols = {}, [], []
    for path in sorted(Path(args.dir).glob("*.json")):
        rec = json.loads(path.read_text())
        if rec.get("mesh") != args.mesh or "full" not in rec:
            continue
        tag = path.stem.split("__")[3] if path.stem.count("__") == 3 else ""
        col = rec["shape"] + (f" {tag}" if tag else "")
        mem = rec["full"]["memory"]
        gb = (mem["argument_bytes"] +
              (mem["temp_bytes"] if args.peak else 0)) / 1e9
        dom = TERMS.get(rec.get("roofline", {}).get("dominant"), "-")
        mark = "**" if gb > args.card_gb else ""
        cells[(rec["arch"], col)] = f"{mark}{gb:.2f}{mark} ({dom})"
        if rec["arch"] not in archs:
            archs.append(rec["arch"])
        if col not in cols:
            cols.append(col)
    print("| arch | " + " | ".join(cols) + " |")
    print("|---|" + "---|" * len(cols))
    for a in archs:
        print(f"| {a} | " + " | ".join(cells.get((a, c), "-") for c in cols)
              + " |")


if __name__ == "__main__":
    main()
