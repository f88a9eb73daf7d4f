"""The lane-noise kernel's raw launcher (``csrc/lane_noise.cu``).

Not a TPU kernel: the port's counterpart of the reference's on-device
``jax.random.normal`` inside its jitted tick
(``repro/diffusion/backend.py:214``).  One launch fills an (S, ...) float32
tensor with each lane's standard normals, keyed by (seed, image, role, step)
(see the source's header), so the serving engine draws its window's noise on
the card and a CUDA graph can hold the draw.  Call it through
:func:`repro_torch.kernels.ops.lane_noise`, which checks its inputs, runs the
plain version (:func:`repro_torch.kernels.ref.lane_noise_ref`) for CPU
tensors, and counts each launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["launch_lane_noise", "noise_bytes", "noise_ops"]

# per element: the ten Philox rounds (2 multiply-high, 2 multiply, 4 xor, 2
# key adds) shared by a quad's four elements; the transform (its float
# multiplies, adds, one division and one square root, 53 operations a pair)
# shared by two
INT_OPS_PER_ELEMENT = 10 * 10 / 4
FLOAT_OPS_PER_ELEMENT = 53 / 2


def _lib():
    fn = build.load("lane_noise").lane_noise
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_uint, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def launch_lane_noise(out, seeds, images, steps, active, role: int) -> None:
    """Launch ``csrc/lane_noise.cu`` on the current stream (built on first
    use); raises if the launch fails.  The tensors are as
    :func:`repro_torch.kernels.ops.lane_noise` checks them: CUDA,
    contiguous; out (S, ...) float32, non-empty; seeds, images, steps (S,)
    int64; active (S,) bool."""
    s = out.shape[0]
    d = out.numel() // s
    vec_ok = int(out.data_ptr() % 16 == 0 and d % 4 == 0)
    fn = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(out.data_ptr(), seeds.data_ptr(), images.data_ptr(),
                 steps.data_ptr(), active.data_ptr(), int(role), s, d,
                 vec_ok, stream)
    if err != 0:
        raise RuntimeError(f"lane_noise: CUDA launch failed with cudaError "
                           f"{err}")


def noise_bytes(out) -> int:
    """Device-memory bytes of one draw: the output written once, the four
    per-lane words read once."""
    s = out.shape[0]
    return out.numel() * out.element_size() + s * (3 * 8 + 1)


def noise_ops(out, n_active: int):
    """(integer, float) operations of one draw over ``n_active`` drawing
    lanes (an inactive lane stores zeros and draws nothing)."""
    d = out.numel() // max(out.shape[0], 1)
    return (INT_OPS_PER_ELEMENT * n_active * d,
            FLOAT_OPS_PER_ELEMENT * n_active * d)
