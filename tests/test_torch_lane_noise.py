"""The lane-noise draw's plain version (``kernels/ref.py``
``lane_noise_ref``, what the ``lane_noise`` CUDA kernel computes bit for
bit) and the default noise source built on it (``collafuse.lane_philox``):
Philox4x32-10's known answers, standard-normal moments and a KS test on
over 10^6 samples, a draw that depends on its key alone, a one-lane draw
equal to its row of a batched draw, the transform's constants equal to the
kernel source's, and the sampling entry points drawing what an engine lane
draws."""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from scipy import stats  # noqa: E402

from _torch_parity import TinyEps, set_torch_cpu, tiny_params  # noqa: E402
from repro_torch.core import collafuse as tcf  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

set_torch_cpu()

REPO = Path(__file__).resolve().parents[1]
SHAPE = (128, 128, 1)


def _draw(seeds, images, steps, active, role=1, shape=SHAPE):
    t = lambda v: torch.tensor(v, dtype=torch.int64)    # noqa: E731
    return ops.lane_noise(t(seeds), t(images), t(steps),
                          torch.tensor(active), role, shape)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    z = torch.tensor(0, dtype=torch.int64)
    f = torch.tensor(0xFFFFFFFF, dtype=torch.int64)
    assert [int(v) for v in kref.philox4x32_10([z] * 4, z, z)] == \
        [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert [int(v) for v in kref.philox4x32_10([f] * 4, f, f)] == \
        [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    c = [torch.tensor(v, dtype=torch.int64) for v in
         (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)]
    k0, k1 = (torch.tensor(v, dtype=torch.int64)
              for v in (0xA4093822, 0x299F31D0))
    assert [int(v) for v in kref.philox4x32_10(c, k0, k1)] == \
        [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_plain_draw_is_standard_normal():
    """Mean, variance and a Kolmogorov-Smirnov test on 64 lanes of
    128x128 (1,048,576 samples): at this size a mean off by 0.003 or a
    variance off by 0.005 (about 3 and 4 standard errors) fails."""
    S = 64
    z = _draw([7 + 1000 * (s % 5) for s in range(S)], list(range(S)),
              [s % 3 for s in range(S)], [True] * S).numpy().ravel()
    assert z.size >= 10 ** 6
    assert abs(z.mean()) < 0.003
    assert abs(z.var() - 1.0) < 0.005
    assert stats.kstest(z, "norm").pvalue > 1e-3
    assert np.isfinite(z).all() and np.abs(z).max() < 6.0


def test_transform_matches_double_precision_box_muller():
    """The fixed polynomials for ln, sin and cos against float64 Box-Muller
    on the same Philox words: within 1e-6 (a few float32 ulp of |z| < 6)."""
    q = 20000
    c = [torch.arange(q, dtype=torch.int64)] + \
        [torch.full((q,), v, dtype=torch.int64) for v in (3, 1, 2)]
    x0, x1, _, _ = kref.philox4x32_10(c, torch.tensor(11), torch.tensor(0))
    z0, z1 = kref._box_muller(x0, x1)
    u = (x0.numpy() // 256 + 1) / 2.0 ** 24
    n = x1.numpy() // 256
    theta = (n // 2 ** 22 + (n % 2 ** 22) / 2.0 ** 22) * np.pi / 2
    r = np.sqrt(-2 * np.log(u))
    np.testing.assert_allclose(z0.numpy(), r * np.cos(theta), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(z1.numpy(), r * np.sin(theta), rtol=0,
                               atol=1e-6)


def _box_muller_ieee(xu, xa):
    """The transform in numpy float32, one IEEE rounding an operation (what
    the kernel's __fmul_rn, __fadd_rn, __fdiv_rn and __fsqrt_rn do)."""
    f, K = np.float32, {n: np.float32(v) for n, v in kref._K.items()}
    u = ((xu >> 8) + 1).astype(f) * f(2.0 ** -24)
    b = u.view(np.int32)
    big = ((b & 0x7FFFFF) | 0x3F800000).astype(np.int32).view(f) > K["SQRT2"]
    m = ((b & 0x7FFFFF) | 0x3F800000).astype(np.int32).view(f)
    m = np.where(big, m * f(0.5), m)
    e = ((b >> 23) - 127 + big).astype(f)
    s = (m + f(-1.0)) / (m + f(1.0))
    s2 = s * s
    p = K["L3"] + s2 * K["L4"]
    for c in ("L2", "L1", "L0"):
        p = K[c] + s2 * p
    r = np.sqrt((e * K["LN2_HI"] + (e * K["LN2_LO"] + s * p)) * f(-2.0))
    n = xa >> 8
    a = ((n & 0x3FFFFF).astype(f) * f(2.0 ** -22)) * K["HALF_PI"]
    a2 = a * a
    sp = K["S5"] + a2 * K["S6"]
    for c in ("S4", "S3", "S2", "S1"):
        sp = K[c] + a2 * sp
    sn = a + a * (a2 * sp)
    cp = K["C6"] + a2 * K["C7"]
    for c in ("C5", "C4", "C3", "C2", "C1"):
        cp = K[c] + a2 * cp
    cs = f(1.0) + a2 * cp
    q = n >> 22
    cos = np.select([q == 0, q == 1, q == 2], [cs, -sn, -cs], sn)
    sin = np.select([q == 0, q == 1, q == 2], [sn, cs, -sn], -cs)
    return r * cos, r * sin


def test_plain_transform_rounds_as_ieee_float32():
    """Bit for bit the numpy float32 transform on 2^21 normals: every
    operation of the plain version rounds once, as the kernel's do (a
    float32 torch.sqrt on the CPU would not: it can be 1 ulp off)."""
    q = 1 << 20
    c = [torch.arange(q, dtype=torch.int64)] + \
        [torch.full((q,), v, dtype=torch.int64) for v in (3, 1, 2)]
    x0, x1, _, _ = kref.philox4x32_10(c, torch.tensor(11), torch.tensor(5))
    for got, want in zip(kref._box_muller(x0, x1),
                         _box_muller_ieee(x0.numpy(), x1.numpy())):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


def test_draw_depends_only_on_its_key():
    a = tcf.lane_philox(5, 1, "server", 3, (6, 6, 1))
    assert a.dtype == torch.float32 and a.shape == (6, 6, 1)
    assert torch.equal(a, tcf.lane_philox(5, 1, "server", 3, (6, 6, 1)))
    for other in [(6, 1, "server", 3), (5, 0, "server", 3),
                  (5, 1, "client", 3), (5, 1, "init", 3),
                  (5, 1, "server", 4), (5 + 2 ** 32, 1, "server", 3)]:
        assert not torch.equal(a, tcf.lane_philox(*other, (6, 6, 1)))
    # a shape's first elements are another shape's first elements
    big = tcf.lane_philox(5, 1, "server", 3, (8, 8, 1)).reshape(-1)
    assert torch.equal(a.reshape(-1), big[:36])


@pytest.mark.parametrize("shape", [SHAPE, (5, 3, 1)])
def test_one_lane_draw_is_its_row_of_a_batched_draw(shape):
    seeds, images = [3, 2 ** 62 + 9, 3, 77], [0, 4, 1, 2]
    steps, active = [0, 5, 9, 2], [True, True, False, True]
    batch = _draw(seeds, images, steps, active, 2, shape)
    assert batch.shape == (4,) + shape
    for s in range(4):
        one = _draw([seeds[s]], [images[s]], [steps[s]], [True], 2, shape)[0]
        if active[s]:
            assert torch.equal(batch[s], one)
        else:
            assert torch.equal(batch[s], torch.zeros(shape))
    assert torch.equal(batch[1], tcf.lane_philox(2 ** 62 + 9, 4, "client", 5,
                                                 shape))


def test_transform_constants_are_the_kernel_sources():
    src = (REPO / "src/repro_torch/kernels/csrc/lane_noise.cu").read_text()
    found = {m.group(1): int(m.group(2), 16) for m in re.finditer(
        r"#define (\w+) (0x[0-9a-fA-F]+)u", src)}
    assert found == kref.LANE_NOISE_BITS


def test_split_sample_draws_what_its_lanes_draw():
    """``split_sample`` under the default source: each image's draws are
    bitwise its lane's (``split_sample_lane``), and the images agree with
    their one-image replays to 1e-4 (the tiny model's batch-2 and batch-1
    products round differently, and the first dense step at T = 12
    multiplies that by ~30: 2.3e-5 at this seed, where the same check at
    1e-5 under this source failed on 1 of 36 elements)."""
    shape = (6, 6, 1)
    srv, cli = (TinyEps(tiny_params(shape, s)).eval() for s in (0, 1))
    ts, plan = tsch.cosine_schedule(12), tcf.CutPlan(12, 0.5)
    for role in ("init", "server", "client"):
        batch = tcf._batch_noise(tcf.lane_philox, 3, range(2), role, shape)
        for step in (0, 4):
            for i in range(2):
                lane = tcf._batch_noise(tcf._OneImage(tcf.lane_philox, i), 3,
                                        range(1), role, shape)
                assert torch.equal(batch(step)[i], lane(step)[0])
    x0, mid = tcf.split_sample(ts, plan, srv, cli, 3, (2,) + shape,
                               return_intermediate=True, device="cpu")
    for i in range(2):
        l0, lmid = tcf.split_sample_lane(ts, plan, srv, cli, 3, i, shape,
                                         return_intermediate=True,
                                         device="cpu")
        torch.testing.assert_close(mid[i], lmid, rtol=0, atol=1e-4)
        torch.testing.assert_close(x0[i], l0, rtol=0, atol=1e-4)


def test_lane_noise_of_an_empty_shape_is_empty():
    z = _draw([1], [0], [0], [True], 1, (0, 4, 1))
    assert z.shape == (1, 0, 4, 1)
