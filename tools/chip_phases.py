"""Run ``chip_smoke.py``'s phases (its ``PHASES``, in its order), each
one's failure printed with its traceback and the next phase run, with a
``[time]`` line a phase (its wall and the running total).  For finding
every failing phase of a tree in one call to the card, and each phase's
time, where ``chip_smoke.py`` stops at the first failure::

    python3 tools/chip_phases.py                 # every phase
    python3 tools/chip_phases.py mesh pod        # only those phases

A phase that reads an earlier one's result (guided and host read slice's)
fails when that phase was left out or failed.  It prints no kernels line
and no device line.
"""
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402
import chip_smoke as c  # noqa: E402


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lap = t0
    card = c.phase_device()
    c.phase_build(dev)
    res = {}
    only = sys.argv[1:]
    for name, fresh, fn in c.PHASES:
        if only and name not in only:
            continue
        if fresh:
            torch.cuda.empty_cache()
        try:
            res[name] = fn(dev, card, res)
        except Exception:
            traceback.print_exc()
            print(f"[FAILED] {name}", flush=True)
        now = time.perf_counter()
        print(f"[time] {name} {now - lap:.1f}s, total {now - t0:.1f}s",
              flush=True)
        lap = now


if __name__ == "__main__":      # the mesh phase's ranks import this module
    main()
