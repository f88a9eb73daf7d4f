"""Does a lane's ε̂ keep its bits when the model call that carries it
changes width?

A pod host calls the server model on its own block of lanes (plus halo
lanes in a guided window) where the single host calls it on every lane, so
a pod reassembles the single host bitwise only if each lane's output does
not depend on the call's width.  This runs S lanes (random x, timesteps and
labels from a seed) through the model in one call, then in calls of width
w for each w dividing S, and reports each width's max |Δ| against the
one-call output and whether it is bitwise; then the same S-wide call with
the lanes rolled by one, which moves every lane to another position.

Models: the pod smoke's MLP (``repro_torch.launch.pod_smoke.PodEps``,
6x6x1) and the paper U-Net (``UNetConfig()`` with 4 classes, random
weights from a seed), float32 without TF32::

    python tools/pod_width.py                        # the card, 128x128
    PYTHONPATH=src python tools/pod_width.py --device cpu --image 32

``--image`` shrinks the U-Net's images (its channel widths stay the
paper's); ``--json`` writes the rows.
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import UNetConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import pod_smoke  # noqa: E402
from repro_torch.models.unet import UNet  # noqa: E402


def width_rows(name, model, shape, n_classes, S, device, seed=0):
    """One row a call width w (and one for the rolled call): max |Δ| of
    the lanes against the S-wide call, and whether they are bitwise."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((S,) + shape, generator=g).to(device)
    t = torch.randint(1, 100, (S,), generator=g).to(device)
    y = torch.randint(0, n_classes + 1, (S,), generator=g).to(device)
    rows = []
    with torch.inference_mode():
        ref = model(x, t, y)
        for w in [w for w in range(1, S + 1) if S % w == 0]:
            out = torch.cat([model(x[a:a + w], t[a:a + w], y[a:a + w])
                             for a in range(0, S, w)])
            rows.append((name, w, "chunks", out, ref))
        rolled = model(x.roll(1, 0), t.roll(1, 0), y.roll(1, 0)).roll(-1, 0)
        rows.append((name, S, "rolled", rolled, ref))
    out = []
    for name, w, how, got, want in rows:
        d = (got - want).abs().max().item()
        out.append({"model": name, "width": w, "how": how, "max_abs": d,
                    "bitwise": bool(torch.equal(got, want))})
        print(f"{name} width {w} ({how}): max |d| {d:.3g}, bitwise "
              f"{out[-1]['bitwise']}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--image", type=int, default=0,
                    help="the U-Net's image size (0 = the paper's 128)")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, mlp, _ = pod_smoke.build_world(device)
    rows = width_rows("pod_mlp", mlp, pod_smoke.SHAPE,
                      pod_smoke.NUM_CLASSES, args.slots, device)
    ucfg = dataclasses.replace(UNetConfig(), num_classes=4)
    if args.image:
        ucfg = dataclasses.replace(ucfg, image_size=args.image)
    unet = UNet(ucfg, seed=0).to(device).eval()
    rows += width_rows("paper_unet", unet,
                       (ucfg.image_size, ucfg.image_size, ucfg.in_channels),
                       4, args.slots, device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": str(device), "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
