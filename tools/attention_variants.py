"""Locate the costs of the float32 ``flash_attention`` kernel on the card.

A kernel has no profiler inside it, so this builds variants of
``src/repro_torch/kernels/csrc/flash_attention.cu`` that each drop one part
of the work (text patches of a copy, compiled by nvcc with the kernel's own
flags into ``build/attention_variants/``, called through ctypes) and times
them with the kernel in turns, at one Yi-6B layer's prefill (q
4x2048x32x128, k and v 4x2048x4x128) and at Zamba2-7B's shared block (q, k,
v 4x2048x32x112), causal, float32.  The variants:

* ``kernel``: the source as it is (its max |err| against ``attention_ref``);
* ``producers_only``: the consumer warps wait for each stage and release it
  but compute nothing: the producers' loads, splits and stores alone;
* ``consumers_only``: the producers release each stage without loading or
  storing anything: the consumers' products and softmax alone;
* ``one_product``: a_hi b_hi alone in both products (two thirds of the mma
  gone; its result misses the tolerance): the tensor cores' share.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 tools/attention_variants.py
"""
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, ref  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "attention_variants"
SHAPES = {"Yi layer": (4, 2048, 32, 4, 128),
          "Zamba2 block": (4, 2048, 32, 32, 112)}
PRODUCE = ("      store_tile<HD>(planes + s * T::STAGE_UNITS, x, p);\n",
           "    if (n > 0)\n      load_tile<HD>(x, k + kv0, v + kv0, row, "
           "t_begin * kF32Keys, Skv, p);\n",
           "      if (i + 1 < n)\n        load_tile<HD>(x, k + kv0, v + kv0, "
           "row, (t_begin + i + 1) * kF32Keys,\n                      Skv, "
           "p);\n")
VARIANTS = {
    "kernel": [],
    "producers_only": [("    if (!none) {\n", "    if (false) {\n")],
    "consumers_only": [(line, "") for line in PRODUCE],
    "one_product": [
        ("          mma_tf32(small[j], al, h0, h1);\n          mma_tf32(small"
         "[j], ah, __float_as_uint(u.z), __float_as_uint(u.w));\n", ""),
        ("          mma_tf32(o[nt], pl, h0, h1);\n          mma_tf32(o[nt], "
         "ph, __float_as_uint(u.z), __float_as_uint(u.w));\n", "")],
}


def build_variant(name):
    """(name, library path or None, nvcc's output)."""
    src = (CSRC / "flash_attention.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the patch no longer matches the "
                             f"source:\n{old}")
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    (d / "flash_attention.cu").write_text(src)
    so = d / "libflash_attention.so"
    proc = subprocess.run([build.find_nvcc(),
                           *build.nvcc_flags("flash_attention"), "-o",
                           str(so), str(d / "flash_attention.cu")],
                          capture_output=True, text=True)
    return name, (so if proc.returncode == 0 else None), \
        proc.stdout + proc.stderr


def ptxas_f32(log):
    """'hd H: R registers, spill line' of each float32 instance."""
    rows = re.findall(r"f32_kernelILi(\d+)E[^\n]*\n[^\n]*\n\s*([^\n]*spill"
                      r"[^\n]*)\n[^\n]*Used (\d+) registers", log)
    return "; ".join(f"hd {hd}: {regs} registers, {spills}"
                     for hd, spills, regs in rows)


def bind(so):
    fn = ctypes.CDLL(str(so)).flash_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, q, k, v, out):
    b, s, h, hd = q.shape
    err = fn(0, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, k.shape[1], h, k.shape[2], hd ** -0.5, 1, 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")


def time_ms(fn, args, iters=10):
    for _ in range(2):
        launch(fn, *args)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        launch(fn, *args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main():
    if not torch.cuda.is_available():
        print("attention_variants: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:      # one nvcc each
        built = list(pool.map(build_variant, VARIANTS))
    fns = {}
    for name, so, log in built:
        if so is None:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        print(f"[build] {name}: {ptxas_f32(log)}", flush=True)
        fns[name] = bind(so)
    dev = torch.device("cuda", 0)
    for label, (b, s, h, kv, hd) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(7)
        q = torch.randn((b, s, h, hd), generator=g, device=dev)
        k = torch.randn((b, s, kv, hd), generator=g, device=dev)
        v = torch.randn((b, s, kv, hd), generator=g, device=dev)
        out = torch.empty_like(q)
        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):       # in turns
            for name in order:
                times[name].append(time_ms(fns[name], (q, k, v, out)))
        launch(fns["kernel"], q, k, v, out)
        err = float((out - ref.attention_ref(q, k, v)).abs().max())
        for name, ts in times.items():
            extra = f" max|err| {err:.3e}" if name == "kernel" else ""
            print(f"[{label}] {name}: {sum(ts) / len(ts):.3f} ms (runs "
                  + " ".join(f"{t:.3f}" for t in ts) + f"){extra}",
                  flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
