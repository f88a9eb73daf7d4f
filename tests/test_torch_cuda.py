"""The port's hand-written kernels against their plain versions, on the
card.  Marked ``cuda``; without a card every test skips.  Imports neither
jax nor the JAX package, so it runs on a machine that has only the port's
dependencies::

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.diffusion import sampler as tsm  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402
from repro_torch.kernels import ddpm_step as tds  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(2)

def _cuda_inputs(S, dtype):
    sched = tsch.cosine_schedule(100)
    tables = torch.cat([tsm.make_sampler(100).tables(sched),
                        tsm.make_sampler(100, "ddim", 20, 0.3).tables(sched)],
                       dim=1).cuda()
    g = torch.Generator().manual_seed(S)
    cols = torch.randint(0, tables.shape[1], (S,), generator=g,
                         dtype=torch.int32)
    cols[:3] = torch.tensor([100, 0, 99], dtype=torch.int32)
    active = torch.ones(S, dtype=torch.bool)
    active[3::4] = False
    cols[3] = -7
    x, eps, z = (torch.randn((S, 128, 128, 1), generator=g).to(dtype)
                 for _ in range(3))
    return [t.cuda() for t in (x, cols, eps, z, active)] + [tables]


def _require_cuda(triton=False):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    if triton and importlib.util.find_spec("triton") is None:
        pytest.skip("needs the triton package")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_traj_masked_step_kernel_matches_plain_on_cuda(S, dtype):
    _require_cuda()
    dt = getattr(torch, dtype)
    x, cols, eps, z, active, tables = _cuda_inputs(S, dt)
    before = ops.traj_masked_step.launches
    out = ops.traj_masked_step(x, cols, eps, z, active, tables)
    ref = kref.traj_masked_step_ref(x, cols, eps, z, active, tables)
    torch.cuda.synchronize()
    assert ops.traj_masked_step.launches == before + 1
    assert torch.equal(out[~active], x[~active])
    if dt == torch.float32:        # -fmad=false: the plain arithmetic, bitwise
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddpm_step_kernel_matches_plain_on_cuda(dtype):
    _require_cuda(triton=True)
    dt = getattr(torch, dtype)
    x, cols, eps, z, _, tables = _cuda_inputs(8, dt)
    coefs = tds.index_step_coefs(tables, torch.clamp(cols, 0, 119))
    before = ops.ddpm_step.launches
    out = ops.ddpm_step(x, eps, z, coefs)
    ref = kref.ddpm_step_ref(x, eps, z, coefs)
    torch.cuda.synchronize()
    assert ops.ddpm_step.launches == before + 1
    if dt == torch.float32:        # fp fusion off: the plain arithmetic
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


def _masked_case(S, shape, dtype, tables, seed=0, active=None, offset=0):
    """(x, cols, eps, z, active) for S lanes of ``shape``: columns over the
    whole table and out of range, every fourth lane inactive unless
    ``active`` is given; x, eps and z are views ``offset`` elements into
    larger buffers (16-byte vectors off when that is not aligned)."""
    g = torch.Generator().manual_seed(seed)
    C = tables.shape[1]
    cols = torch.randint(0, C, (S,), generator=g, dtype=torch.int32)
    cols[: min(S, 4)] = torch.tensor([C - 1, 0, -7, C + 50],
                                     dtype=torch.int32)[: min(S, 4)]
    if active is None:
        active = torch.ones(S, dtype=torch.bool)
        active[3::4] = False
    n = S * int(torch.tensor(shape).prod())

    def stream():
        buf = torch.randn(n + offset, generator=g).to(dtype).cuda()
        return buf[offset:].view((S,) + tuple(shape))
    x, eps, z = stream(), stream(), stream()
    return x, cols.cuda(), eps, z, active.cuda()


def _check_masked(out, ref, x, active):
    """Inactive lanes x bit for bit; float32 bitwise equal to the plain
    version, bf16 within 2^-7."""
    torch.cuda.synchronize()
    assert torch.equal(out[~active], x[~active])
    if out.dtype == torch.float32:   # -fmad=false: the plain arithmetic
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


def _tables(kind):
    """The phase-3 (5, 120) table staged in shared memory; 40 of them side
    by side (4,800 columns, past the 32 KB staging budget), gathered from
    device memory; or the small one as a view 4 bytes into a buffer (not
    16-byte aligned), gathered too."""
    sched = tsch.cosine_schedule(100)
    tables = torch.cat([tsm.make_sampler(100).tables(sched),
                        tsm.make_sampler(100, "ddim", 20, 0.3).tables(sched)],
                       dim=1).cuda()
    if kind == "over_budget":
        return torch.cat([tables * (1 + 0.01 * i) for i in range(40)], dim=1)
    if kind == "unaligned":
        buf = torch.empty(tables.numel() + 1, device="cuda")
        view = buf[1:].view(tables.shape)
        view.copy_(tables)
        return view
    return tables


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["staged", "over_budget", "unaligned"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_traj_masked_step_kernel_both_table_paths_on_cuda(kind, dtype):
    _require_cuda()
    tables = _tables(kind)
    x, cols, eps, z, active = _masked_case(16, (128, 128, 1),
                                           getattr(torch, dtype), tables)
    out = ops.traj_masked_step(x, cols, eps, z, active, tables)
    ref = kref.traj_masked_step_ref(x, cols, eps, z, active, tables)
    _check_masked(out, ref, x, active)


@pytest.mark.cuda
@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_traj_masked_step_kernel_all_lanes_inactive_or_active_on_cuda(
        on, dtype):
    _require_cuda()
    tables = _tables("staged")
    act = torch.full((8,), on, dtype=torch.bool)
    x, cols, eps, z, active = _masked_case(8, (128, 128, 1),
                                           getattr(torch, dtype), tables,
                                           active=act)
    out = ops.traj_masked_step(x, cols, eps, z, active, tables)
    ref = kref.traj_masked_step_ref(x, cols, eps, z, active, tables)
    _check_masked(out, ref, x, active)
    if not on:
        assert torch.equal(out, x)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_traj_masked_step_kernel_lane_counts_on_cuda(S, dtype):
    _require_cuda()
    tables = _tables("staged")
    x, cols, eps, z, active = _masked_case(S, (128, 128, 1),
                                           getattr(torch, dtype), tables,
                                           seed=S)
    out = ops.traj_masked_step(x, cols, eps, z, active, tables)
    ref = kref.traj_masked_step_ref(x, cols, eps, z, active, tables)
    _check_masked(out, ref, x, active)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((127, 129, 1), 0),
                                          ((128, 128, 1), 1)],
                         ids=["ragged", "offset_view"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_traj_masked_step_kernel_without_vectors_on_cuda(shape, offset,
                                                         dtype):
    """vec_ok = 0: D·size not a multiple of 16 bytes, or views 4 bytes
    (bf16: 2 elements, one f32) into larger buffers."""
    _require_cuda()
    dt = getattr(torch, dtype)
    tables = _tables("staged")
    x, cols, eps, z, active = _masked_case(
        8, shape, dt, tables, offset=offset * 32 // torch.finfo(dt).bits)
    assert offset == 0 or x.data_ptr() % 16 == 4
    out = ops.traj_masked_step(x, cols, eps, z, active, tables)
    ref = kref.traj_masked_step_ref(x, cols, eps, z, active, tables)
    _check_masked(out, ref, x, active)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_traj_masked_step_kernel_nan_in_eps_on_cuda(dtype):
    """A NaN in ε̂: an inactive lane returns x bit for bit, an active lane
    what the plain version gives (NaN, which the clip leaves as it is)."""
    _require_cuda()
    tables = _tables("staged")
    x, cols, eps, z, active = _masked_case(8, (128, 128, 1),
                                           getattr(torch, dtype), tables)
    assert bool(active[0]) and not bool(active[3])
    eps[0, 5, 7, 0] = float("nan")
    eps[3, 5, 7, 0] = float("nan")
    out = ops.traj_masked_step(x, cols, eps, z, active, tables)
    ref = kref.traj_masked_step_ref(x, cols, eps, z, active, tables)
    torch.cuda.synchronize()
    assert torch.equal(out[~active], x[~active])
    assert bool(torch.isnan(out[0, 5, 7, 0]))
    tol = 0.0 if out.dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_traj_masked_step_kernel_is_bitwise_repeatable_on_cuda(dtype):
    _require_cuda()
    tables = _tables("staged")
    args = _masked_case(32, (128, 128, 1), getattr(torch, dtype), tables)
    a = ops.traj_masked_step(*args, tables)
    b = ops.traj_masked_step(*args, tables)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_traj_masked_step_wrapper_raises_on_an_empty_table_on_cuda():
    """A (5, 0) table has no column to clamp into: the plain version
    raises on it, and the kernel would read outside it."""
    _require_cuda()
    x, cols, eps, z, active = _masked_case(2, (8, 8, 1), torch.float32,
                                           _tables("staged"))
    with pytest.raises(ValueError, match="C >= 1"):
        ops.traj_masked_step(x, cols, eps, z, active,
                             torch.zeros((5, 0), device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddpm_step_kernel_ragged_lanes_on_cuda(dtype):
    """The Triton kernel's launch shape over lanes of 127x129x1 (ragged
    blocks, 16-byte vectors off) and one lane."""
    _require_cuda(triton=True)
    dt = getattr(torch, dtype)
    tables = _tables("staged")
    for S, shape in ((8, (127, 129, 1)), (1, (128, 128, 1))):
        x, cols, eps, z, _ = _masked_case(S, shape, dt, tables, seed=S)
        coefs = tds.index_step_coefs(tables, torch.clamp(cols, 0, 119))
        out = ops.ddpm_step(x, eps, z, coefs)
        ref = kref.ddpm_step_ref(x, eps, z, coefs)
        torch.cuda.synchronize()
        if dt == torch.float32:
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out.float(), ref.float(),
                                       rtol=2 ** -7, atol=2 ** -7)


def _attn_inputs(b, s, h, kv, hd, dtype, seed=0, skv=None):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g).to(dtype)
    k = torch.randn((b, skv or s, kv, hd), generator=g).to(dtype)
    v = torch.randn((b, skv or s, kv, hd), generator=g).to(dtype)
    return q.cuda(), k.cuda(), v.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (1, 128, 4, 4, 32, 0),        # MHA
    (1, 130, 4, 1, 32, 50),       # hd 32 (a TMA box past hd, p v at N = 64
    (2, 300, 8, 2, 32, 0),        # over zero columns): several tiles, a
                                  # window, ragged ends
    (2, 256, 8, 2, 64, 0),        # GQA G=4
    (1, 512, 4, 1, 64, 0),        # MQA
    (1, 384, 6, 3, 64, 0),        # non-pow2 heads
    (2, 256, 4, 2, 64, 32),       # windows, incl. rows whose first visible
    (2, 256, 4, 2, 64, 200),      # tile holds only masked keys
    (1, 200, 32, 4, 128, 0),      # ragged tiles, Yi's heads
    (1, 1024, 32, 4, 128, 100),
    (1, 300, 32, 32, 112, 0),     # Zamba2's shared block: hd 112, MHA,
    (2, 256, 8, 8, 112, 64),      # ragged, and windowed
    (1, 256, 4, 2, 112, 200),     # GQA at hd 112
    (1, 2048 + 37, 32, 4, 128, 0),   # Yi's and Zamba2's full tile geometry
    (2, 520, 32, 32, 112, 0),        # with ragged ends: TMA's zero fill
    (16, 512, 32, 4, 128, 0),     # B*H*Sq/128 = 2048 blocks: many waves of
                                  # the longest-first launch order
    (4, 2048, 12, 2, 128, 0),     # a Qwen2-VL-2B layer's prefill: H/KV = 6
    (4, 2048, 32, 32, 64, 0),     # a MusicGen-large layer's: MHA at hd 64
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain_on_cuda(b, s, h, kv, hd, window,
                                                      dtype):
    _require_cuda()
    dt = getattr(torch, dtype)
    q, k, v = _attn_inputs(b, s, h, kv, hd, dt)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    ref = kref.attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5    # tests/test_kernels.py
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_non_causal_and_shorter_queries_on_cuda(dtype):
    _require_cuda()
    dt = getattr(torch, dtype)
    q, _, _ = _attn_inputs(2, 96, 8, 2, 64, dt, seed=1)
    _, k, v = _attn_inputs(2, 96, 8, 2, 64, dt, seed=2, skv=160)
    out = ops.flash_attention(q, k, v, causal=False)
    ref = kref.attention_ref(q, k, v, causal=False)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,window", [(128, 0), (64, 40)])
def test_flash_attention_kernel_negative_scale_on_cuda(hd, window, dtype):
    """A negative softmax scale reverses the order of the raw scores: the
    bf16 kernel must not take the row max on them unscaled."""
    _require_cuda()
    dt = getattr(torch, dtype)
    q, k, v = _attn_inputs(2, 300, 8, 2, hd, dt, seed=6)
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              softmax_scale=-0.2)
    ref = kref.attention_ref(q, k, v, causal=True, window=window,
                             softmax_scale=-0.2)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_items_without_visible_keys_on_cuda(dtype):
    """Sq > Skv with a window: whole q tiles see no key (an empty key-tile
    range), and the ring of stages must not lose step over them; the f32
    instance's warps skip the tiles that mask all their rows."""
    _require_cuda()
    dt = getattr(torch, dtype)
    q, _, _ = _attn_inputs(1, 1000, 4, 2, 64, dt, seed=4)
    _, k, v = _attn_inputs(1, 1000, 4, 2, 64, dt, seed=5, skv=100)
    out = ops.flash_attention(q, k, v, causal=True, window=10)
    ref = kref.attention_ref(q, k, v, causal=True, window=10)
    torch.cuda.synchronize()
    seen = 100 + 10 - 1           # rows below see at least one key
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out[:, :seen].float(), ref[:, :seen].float(),
                               rtol=0, atol=tol)
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,kv", [(128, 4), (112, 32)])
def test_flash_attention_kernel_is_deterministic_on_cuda(hd, kv, dtype):
    """No atomics, a fixed order of tiles: two calls give the same bits."""
    _require_cuda()
    q, k, v = _attn_inputs(2, 1000, 32, kv, hd, getattr(torch, dtype), seed=3)
    a = ops.flash_attention(q, k, v, causal=True)
    b = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 112, 128])
def test_flash_attention_f32_kernel_shared_memory_on_cuda(hd):
    """The float32 kernel's shared memory (8 warps' q fragments, a ring of
    2 stages of K and V hi/lo planes, 4 mbarriers) fits a block's 232,448
    bytes."""
    _require_cuda()
    from repro_torch.kernels import flash_attention as kfa
    q_frags = 16 * 8 * (hd // 8) * 32
    stage = 16 * (32 * (hd // 2 + 4) + 16 * (hd + 2))
    assert kfa.f32_smem_bytes(hd) == q_frags + 2 * stage + 32 <= 232448


@pytest.mark.cuda
def test_flash_attention_wrapper_raises_on_what_the_kernel_does_not_take():
    _require_cuda()
    q, k, v = _attn_inputs(1, 64, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                            v[..., :48].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="H % KV"):
        ops.flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1).contiguous(),
                            v[:, :, :1].expand(-1, -1, 3, -1).contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), k, v)


def _ssm_inputs(b, s, nh, p, n, dtype, dt_dtype=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, nh, p), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, nh), generator=g))
    a = -torch.exp(0.3 * torch.randn(nh, generator=g))
    bm = torch.randn((b, s, n), generator=g)
    cm = torch.randn((b, s, n), generator=g)
    return (x.to(dtype).cuda(), dt.to(dt_dtype or dtype).cuda(), a.cuda(),
            bm.to(dtype).cuda(), cm.to(dtype).cuda())


def _ssm_rel_err(y, ref):
    return float((y.float() - ref.float()).abs().max()) / (
        float(ref.float().abs().max()) + 1e-6)


SSM_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}  # test_kernels.py


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,nh,p,n,chunk,hb", [
    (1, 64, 4, 16, 8, 16, 4),        # tests/test_kernels.py:77-82
    (2, 128, 8, 32, 16, 32, 8),
    (2, 96, 6, 16, 8, 32, 2),
    (1, 256, 16, 64, 64, 128, 8),
    (1, 200, 4, 64, 64, 128, 8),     # a ragged last chunk
    (96, 128, 12, 64, 64, 128, 4),   # a grid big enough for 4 heads a block
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernel_matches_plain_on_cuda(b, s, nh, p, n, chunk, hb,
                                               dtype):
    _require_cuda()
    dt = getattr(torch, dtype)
    args = _ssm_inputs(b, s, nh, p, n, dt, seed=s + nh)
    before = ops.ssm_scan.launches
    y = ops.ssm_scan(*args, chunk=chunk, head_block=hb)
    ref = kref.ssm_scan_ref(*args)
    torch.cuda.synchronize()
    assert ops.ssm_scan.launches == before + 1
    assert y.dtype == dt and y.shape == args[0].shape
    assert bool(torch.isfinite(y).all())
    assert _ssm_rel_err(y, ref) < SSM_TOL[dt]


@pytest.mark.cuda
def test_ssm_scan_kernel_float32_dt_with_bfloat16_x_on_cuda():
    """ssm_forward's mix with a bf16 model keeps dt in float32."""
    _require_cuda()
    args = _ssm_inputs(2, 320, 8, 64, 64, torch.bfloat16, torch.float32)
    y = ops.ssm_scan(*args)
    ref = kref.ssm_scan_ref(*args)
    assert y.dtype == torch.bfloat16
    assert _ssm_rel_err(y, ref) < SSM_TOL[torch.bfloat16]


@pytest.mark.cuda
def test_ssm_scan_kernel_at_full_length_and_any_chunk_on_cuda():
    """S = 2048 (32 chunks of the kernel): the scan's fixed-order cumsum
    feeds every decay; and the caller's chunk changes nothing."""
    _require_cuda()
    args = _ssm_inputs(1, 2048, 8, 64, 64, torch.float32, seed=9)
    y = ops.ssm_scan(*args, chunk=128)
    assert _ssm_rel_err(y, kref.ssm_scan_ref(*args)) < SSM_TOL[torch.float32]
    assert torch.equal(y, ops.ssm_scan(*args, chunk=16))
    assert torch.equal(y, ops.ssm_scan(*args, chunk=256, head_block=1))


SSM_DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
              ("bfloat16", "float32")]      # (x, bm, cm) and dt


def _ssm_check(args, dtype):
    before = ops.ssm_scan.launches
    y = ops.ssm_scan(*args)
    ref = kref.ssm_scan_ref(*args)
    torch.cuda.synchronize()
    assert ops.ssm_scan.launches == before + 1
    assert y.dtype == dtype and y.shape == args[0].shape
    assert bool(torch.isfinite(y).all())
    assert _ssm_rel_err(y, ref) < SSM_TOL[dtype]
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 65, 2047])
@pytest.mark.parametrize("dtype,dt_dtype", SSM_DTYPES)
def test_ssm_scan_kernel_ragged_lengths_on_cuda(s, dtype, dt_dtype):
    """S around the chunk (64) and the 16-row bands: a lone step, one short
    chunk, one step past it, one short of 32 chunks."""
    _require_cuda()
    dt = getattr(torch, dtype)
    _ssm_check(_ssm_inputs(2, s, 6, 64, 64, dt, getattr(torch, dt_dtype),
                           seed=s), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,nh,p,n", [
    (2, 130, 4, 24, 40),     # P and N zero-padded, 16-byte rows (f32)
    (1, 100, 3, 7, 5),       # rows of no 16-byte multiple: the load path
    (3, 96, 5, 48, 64),      # a warp's column half part-empty, nh = 5
    (2, 70, 7, 64, 8),       # a narrow state
])
@pytest.mark.parametrize("dtype,dt_dtype", SSM_DTYPES)
def test_ssm_scan_kernel_narrow_widths_on_cuda(b, s, nh, p, n, dtype,
                                               dt_dtype):
    _require_cuda()
    dt = getattr(torch, dtype)
    _ssm_check(_ssm_inputs(b, s, nh, p, n, dt, getattr(torch, dt_dtype),
                           seed=b * s + p), dt)


@pytest.mark.cuda
def test_ssm_scan_kernel_many_waves_on_cuda():
    """64 batch rows x 16 heads = 1,024 blocks, several rounds of the
    card's block slots."""
    _require_cuda()
    _ssm_check(_ssm_inputs(64, 256, 16, 64, 64, torch.float32, seed=3),
               torch.float32)


@pytest.mark.cuda
def test_ssm_scan_kernel_unaligned_float32_on_cuda():
    """Inputs that are contiguous but not 16-byte aligned take the
    synchronous load path and give the aligned path's y bit for bit."""
    _require_cuda()
    x, dt, a, bm, cm = _ssm_inputs(2, 200, 4, 64, 64, torch.float32, seed=4)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    y = ops.ssm_scan(x, dt, a, bm, cm)
    y_off = ops.ssm_scan(shifted(x), dt, a, shifted(bm), shifted(cm))
    assert torch.equal(y, y_off)
    assert _ssm_rel_err(y, kref.ssm_scan_ref(x, dt, a, bm, cm)) < \
        SSM_TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dt_dtype", SSM_DTYPES)
def test_ssm_scan_kernel_is_bitwise_repeatable_on_cuda(dtype, dt_dtype):
    """No atomics and fixed-order sums: two calls, and any chunk or
    head_block argument, give the same bits."""
    _require_cuda()
    dt = getattr(torch, dtype)
    args = _ssm_inputs(2, 512, 16, 64, 64, dt, getattr(torch, dt_dtype),
                       seed=8)
    y = _ssm_check(args, dt)
    assert torch.equal(y, ops.ssm_scan(*args))
    assert torch.equal(y, ops.ssm_scan(*args, chunk=32, head_block=3))


@pytest.mark.cuda
def test_ssm_scan_wrapper_raises_on_what_the_kernel_does_not_take():
    _require_cuda()
    x, dt, a, bm, cm = _ssm_inputs(1, 64, 4, 16, 8, torch.float32)
    with pytest.raises(ValueError, match="state"):
        wide = torch.zeros((1, 64, 80), device="cuda")
        ops.ssm_scan(x, dt, a, wide, wide)
    with pytest.raises(ValueError, match="dtype"):
        ops.ssm_scan(x.half(), dt, a, bm.half(), cm.half())
    with pytest.raises(ValueError, match="dt must be"):
        ops.ssm_scan(x, dt.bfloat16(), a, bm, cm)
    with pytest.raises(ValueError, match="a float32"):
        ops.ssm_scan(x, dt, a.double(), bm, cm)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssm_scan(x.transpose(2, 3), dt, a, bm, cm)
    with pytest.raises(ValueError, match="needs dt"):
        ops.ssm_scan(x, dt[:, :32], a, bm, cm)


# one training round at UNetConfig().reduced(): card against CPU.  The
# losses of round 0 depend only on the shared initial weights and draws;
# cuDNN may pick FFT or Winograd convolutions, whose f32 error exceeds a
# direct sum's, hence rtol 1e-4.  AdamW's first step moves each parameter
# by ±lr by its gradient's sign, so a near-zero gradient either side of 0
# can put one entry 2·lr apart: every entry within 2.002·lr, the mean |Δ|
# within 1 % of lr.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_MAX, TRAIN_PARAM_MEAN = 2 * 1.001 * 1e-3, 1e-5


def _train_one_round(device, batched):
    from repro_torch.configs import UNetConfig
    from repro_torch.core.trainer import CollaFuseTrainer, TrainerConfig
    from repro_torch.data.synthetic import (ClientDataConfig,
                                            make_client_datasets)
    from repro_torch.models.unet import UNet
    cfg = UNetConfig().reduced()
    data, _ = make_client_datasets(ClientDataConfig(
        n_clients=3, per_client=4, image_size=cfg.image_size, holdout=2))
    tr = CollaFuseTrainer(TrainerConfig(n_clients=3, T=100, cut_ratio=0.8,
                                        batched=batched),
                          lambda s: UNet(cfg, seed=s % 9973), device=device)
    return tr, tr.train_round(data)


def _param_gap(a, b):
    d = torch.cat([(a[k].cpu() - b[k].cpu()).abs().ravel() for k in a])
    return float(d.max()), float(d.mean())


@pytest.mark.cuda
def test_training_round_batched_matches_looped_and_cpu_on_cuda():
    _require_cuda()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {(dev, b): _train_one_round(dev, b)
            for dev, b in (("cuda", True), ("cuda", False), ("cpu", True))}
    ref_tr, ref = runs[("cpu", True)]
    for key in (("cuda", True), ("cuda", False)):
        tr, m = runs[key]
        np.testing.assert_allclose(m["server_loss"], ref["server_loss"],
                                   rtol=TRAIN_LOSS_RTOL)
        np.testing.assert_allclose(m["client_losses"], ref["client_losses"],
                                   rtol=TRAIN_LOSS_RTOL)
        np.testing.assert_allclose(m["server_grad_norm"],
                                   ref["server_grad_norm"],
                                   rtol=TRAIN_LOSS_RTOL)
        for a, b in [(tr.server_params, ref_tr.server_params)] + \
                list(zip(tr.client_params, ref_tr.client_params)):
            gmax, gmean = _param_gap(a, b)
            assert gmax <= TRAIN_PARAM_MAX and gmean <= TRAIN_PARAM_MEAN, \
                (key, gmax, gmean)


# the pooled batch in chunks: chunked against unchunked from the same
# models and draws.  The chunks' convolutions run at other batch sizes,
# where cuDNN may pick other algorithms: the losses are held to phase 4b's
# batched-against-looped tolerance, the parameters after one step to the
# card-against-CPU bound above
CHUNK_LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _chunk_trainer(cfg, batched, micro_batch, device="cuda"):
    from repro_torch.core.trainer import CollaFuseTrainer, TrainerConfig
    from repro_torch.models.unet import UNet
    return CollaFuseTrainer(TrainerConfig(n_clients=3, T=100, cut_ratio=0.8,
                                          batched=batched),
                            lambda s: UNet(cfg, seed=s % 9973),
                            device=device, micro_batch=micro_batch)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["reduced", "launcher"])
@pytest.mark.parametrize("batched", [True, False])
def test_chunked_training_round_matches_unchunked_on_cuda(config, batched):
    _require_cuda()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import UNetConfig
    from repro_torch.data.synthetic import (ClientDataConfig,
                                            make_client_datasets)
    from repro_torch.launch.serve_diffusion import launcher_config
    cfg = UNetConfig().reduced() if config == "reduced" else \
        launcher_config(16)
    data, _ = make_client_datasets(ClientDataConfig(
        n_clients=3, per_client=6, image_size=cfg.image_size, holdout=2))
    ref = _chunk_trainer(cfg, batched, None)
    m_ref = ref.train_round(data)
    for micro in (5, 2):
        tr = _chunk_trainer(cfg, batched, micro)
        m = tr.train_round(data)
        np.testing.assert_allclose(m["server_loss"], m_ref["server_loss"],
                                   **CHUNK_LOSS_TOL)
        np.testing.assert_allclose(m["client_losses"],
                                   m_ref["client_losses"], **CHUNK_LOSS_TOL)
        for a, b in [(tr.server_params, ref.server_params)] + \
                list(zip(tr.client_params, ref.client_params)):
            gmax, gmean = _param_gap(a, b)
            assert gmax <= TRAIN_PARAM_MAX and gmean <= TRAIN_PARAM_MEAN, \
                (micro, gmax, gmean)


@pytest.mark.cuda
def test_checkpoint_round_trips_on_cuda(tmp_path):
    """A trained trainer on the card saved and restored into a fresh one
    (and into one on the CPU): parameters and AdamW states bitwise, on each
    trainer's device; a bf16 leaf on the card bitwise."""
    _require_cuda()
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import UNetConfig
    from repro_torch.data.synthetic import (ClientDataConfig,
                                            make_client_datasets)
    cfg = UNetConfig().reduced()
    data, _ = make_client_datasets(ClientDataConfig(
        n_clients=3, per_client=4, image_size=cfg.image_size, holdout=2))
    tr = _chunk_trainer(cfg, True, 4)
    tr.train_round(data)
    tr.save(str(tmp_path / "tr"))

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree]
    for dev in ("cuda", "cpu"):
        fresh = _chunk_trainer(cfg, dev == "cpu", None, device=dev)
        fresh.restore(str(tmp_path / "tr.npz"))
        assert fresh.round == 1
        for a, b in zip(leaves(fresh.state_tree()), leaves(tr.state_tree())):
            assert a.device.type == dev and torch.equal(a.cpu(), b.cpu())
    x = torch.randn((3, 5), device="cuda").to(torch.bfloat16)
    ckpt_io.save_checkpoint(str(tmp_path / "bf16"), {"x": x})
    back = ckpt_io.restore_checkpoint(str(tmp_path / "bf16"),
                                      {"x": torch.empty_like(x)})["x"]
    assert back.is_cuda and back.dtype == torch.bfloat16
    assert torch.equal(back, x)


# ---------------------------------------------------------------------------
# the serving engine's host path: the lane-noise kernel, captured windows,
# spare columns and the streamed finisher on the card
# ---------------------------------------------------------------------------
def _noise_inputs(S, seed=0):
    g = torch.Generator().manual_seed(seed)
    seeds = torch.randint(0, 2 ** 62, (S,), generator=g, dtype=torch.int64)
    images = torch.randint(0, 4, (S,), generator=g, dtype=torch.int64)
    steps = torch.randint(0, 100, (S,), generator=g, dtype=torch.int64)
    active = torch.ones(S, dtype=torch.bool)
    active[1::3] = False
    return seeds, images, steps, active


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 8, 32])
@pytest.mark.parametrize("shape", [(128, 128, 1), (5, 3, 1), (16, 16, 3)])
def test_lane_noise_kernel_matches_plain_on_cuda(S, shape):
    """Bitwise against the plain version, on the card and on the CPU (the
    16-byte store path and the ragged one)."""
    _require_cuda()
    args = _noise_inputs(S, S)
    dev = [t.cuda() for t in args]
    before = ops.lane_noise.launches
    out = ops.lane_noise(*dev, 1, shape)
    ref = kref.lane_noise_ref(*dev, 1, shape)
    torch.cuda.synchronize()
    assert ops.lane_noise.launches == before + 1
    assert out.shape == (S,) + shape and out.dtype == torch.float32
    assert torch.equal(out, ref)
    assert torch.equal(out.cpu(), kref.lane_noise_ref(*args, 1, shape))
    assert not out[~dev[3]].any()
    from repro_torch.core.collafuse import lane_philox
    key = (int(args[0][0]), int(args[1][0]), "server", int(args[2][0]))
    one = lane_philox(*key, shape, device="cuda")
    assert one.is_cuda and torch.equal(one.cpu(), lane_philox(*key, shape))


@pytest.mark.cuda
def test_lane_noise_wrapper_raises_on_what_the_kernel_does_not_take():
    _require_cuda()
    seeds, images, steps, active = (t.cuda() for t in _noise_inputs(4))
    with pytest.raises(ValueError, match="seeds"):
        ops.lane_noise(seeds.int(), images, steps, active, 1, (8, 8, 1))
    with pytest.raises(ValueError, match="steps"):
        ops.lane_noise(seeds, images, steps[:3], active, 1, (8, 8, 1))
    with pytest.raises(ValueError, match="active"):
        ops.lane_noise(seeds, images, steps, active.int(), 1, (8, 8, 1))
    with pytest.raises(ValueError, match="tensors on cpu"):
        ops.lane_noise(seeds, images.cpu(), steps, active, 1, (8, 8, 1))


def _host_engine(k=3, slots=4, graphs=True, spare=0, menu=None, pack=False,
                 policy="cut_ratio", **kw):
    from repro_torch.configs import UNetConfig
    from repro_torch.models.unet import UNet
    from repro_torch import serve as tserve
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    menu = menu or {"ddpm": tsm.make_sampler(100),
                    "ddim": tsm.make_sampler(100, "ddim", 20)}
    server = UNet(UNetConfig().reduced(), seed=0).cuda().eval()
    return tserve.ServeEngine(tserve.EngineConfig(
        sched=tsch.cosine_schedule(100), image_shape=(16, 16, 1),
        slots=slots, scheduler=tserve.make_scheduler(policy, 100,
                                                     samplers=menu,
                                                     pack=pack),
        step_backend="cuda_masked", samplers=menu, ticks_per_dispatch=k,
        cuda_graphs=graphs, spare_columns=spare, device="cuda", **kw),
        server)


def _host_requests(n=6, sampler=None):
    from repro_torch.serve import Request
    return [Request(req_id=i, seed=900 + i, batch=1 + i % 2,
                    cut_ratio=(0.75, 0.5, 0.25)[i % 3], client_idx=i % 2,
                    arrival_tick=i, sampler=sampler or ("ddim", "ddpm")[i % 2])
            for i in range(n)]


def _clients():
    from repro_torch.configs import UNetConfig
    from repro_torch.models.unet import UNet
    return [UNet(UNetConfig().reduced(), seed=s).cuda().eval()
            for s in (1, 2)]


def _bitwise_runs(a, b):
    assert set(a.completions) == set(b.completions)
    for rid, ca in a.completions.items():
        cb = b.completions[rid]
        assert np.array_equal(ca.x_mid, cb.x_mid), rid
        assert np.array_equal(ca.x0, cb.x0), rid


@pytest.mark.cuda
def test_captured_window_is_bitwise_the_eager_window_on_cuda():
    """One window staged by hand, run eagerly, then captured and replayed
    from the same inputs: the slot array and the gathered rows bitwise;
    a whole serve with graphs bitwise one without."""
    _require_cuda()
    from repro_torch.core.collafuse import lane_philox
    from repro_torch.serve import engine as teng
    eng = _host_engine()
    with torch.inference_mode():
        eng._static_buffers(staged=False)
        lanes = teng._Lanes.empty(eng.slots, 0)
        for i, r in enumerate(_host_requests(3)[:2]):
            eng._admit(r, [2 * i, 2 * i + 1][:r.batch], lanes)
        admitted = lanes.req >= 0
        host = torch.empty(eng._plan_bytes, dtype=torch.uint8)
        hv = {n: v.numpy() for n, v in
              teng._views(host, eng._plan_layout).items()}
        eng._plan_window(lanes, admitted, hv)
        eng._plan_buf.copy_(host)
        x0 = eng._x.clone()
        eng._window(False, lane_philox)
        want = (eng._x.clone(), eng._xo.clone())
        eng._x.copy_(x0)
        eng._run_window(False, lane_philox)        # eager, then capture
        assert eng.captures == 1
        eng._x.copy_(x0)
        before = ops.launch_counts()
        eng._run_window(False, lane_philox)        # replay
        torch.cuda.synchronize()
        after = ops.launch_counts()
        assert torch.equal(eng._x, want[0]) and torch.equal(eng._xo, want[1])
        assert after["traj_masked_step"] - before["traj_masked_step"] == 3
        assert after["lane_noise"] - before["lane_noise"] == 4
    clients = _clients()
    g = _host_engine(k=4).serve(_host_requests(), clients)
    e = _host_engine(k=4, graphs=False).serve(_host_requests(), clients)
    _bitwise_runs(g, e)


@pytest.mark.cuda
def test_register_sampler_adds_no_capture_on_cuda():
    _require_cuda()
    dyn = tsm.make_sampler(100, "ddim", 10)
    static = _host_engine(menu={"ddpm": tsm.make_sampler(100), "dyn": dyn})
    ref = static.serve(_host_requests(3, "dyn"))
    eng = _host_engine(menu={"ddpm": tsm.make_sampler(100)}, spare=16)
    eng.serve(_host_requests(3, "ddpm"))
    captures, copies = eng.captures, eng.h2d_copies
    eng.register_sampler("dyn", dyn)
    res = eng.serve(_host_requests(3, "dyn"))
    assert eng.captures == captures >= 1
    assert eng.h2d_copies - copies == res.summary["windows"]
    for rid, c in ref.completions.items():
        assert np.array_equal(res.completions[rid].x_mid, c.x_mid), rid


@pytest.mark.cuda
@pytest.mark.parametrize("depth,fdepth", [(1, 1), (2, 2)])
def test_stream_is_bitwise_drain_on_cuda(depth, fdepth):
    """The streamed finisher on its own stream, waves of 2·slots lanes,
    against the drain finisher: x_mid and x0 bitwise (every client call at
    the one finisher width)."""
    _require_cuda()
    clients = _clients()
    drain = _host_engine(finish_mode="drain").serve(_host_requests(8),
                                                    clients)
    stream = _host_engine(async_depth=depth, finish_mode="stream",
                          finish_async_depth=fdepth).serve(
                              _host_requests(8), clients)
    _bitwise_runs(drain, stream)
    assert stream.summary["finish_batches"] >= 1
    assert 0.0 <= stream.summary["overlap_frac"] <= 1.0


# ---------------------------------------------------------------------------
# wave packing and observability on the card: bitwise, no new capture
# ---------------------------------------------------------------------------
def _het_requests():
    """A batch-3 head blocking same-class singles, mixed samplers and cuts:
    traffic that packing reorders under FIFO."""
    from repro_torch.serve import Request
    spec = [(1, 0.5, "ddpm"), (3, 0.25, "ddpm"), (1, 0.5, "ddpm"),
            (1, 0.25, "ddim"), (2, 0.5, "ddim"), (1, 0.75, "ddpm"),
            (1, 0.5, "ddpm"), (2, 0.25, "ddim")]
    return [Request(req_id=i, seed=950 + i, batch=b, cut_ratio=c,
                    client_idx=i % 2, arrival_tick=i // 3, sampler=smp)
            for i, (b, c, smp) in enumerate(spec)]


@pytest.mark.cuda
def test_pack_is_bitwise_unpacked_on_cuda():
    """Pack on moves lanes to other slots of the fixed-width window: x_mid
    bitwise the unpacked run's, and the warm pack-on engine captures no new
    graph."""
    _require_cuda()
    warm = _host_requests(2)
    runs = {}
    for pack in (False, True):
        eng = _host_engine(k=2, pack=pack, policy="fifo")
        eng.serve(warm)
        captures = eng.captures
        runs[pack] = eng.serve(_het_requests())
        assert eng.captures == captures >= 1
        eng.close()
    assert set(runs[True].completions) == set(runs[False].completions)
    for rid, c in runs[False].completions.items():
        assert np.array_equal(runs[True].completions[rid].x_mid, c.x_mid), \
            rid
    assert [runs[True].completions[i].admit_tick for i in range(8)] != \
        [runs[False].completions[i].admit_tick for i in range(8)]
    assert 0.0 <= runs[True].summary["fragmentation_frac"] <= 1.0


@pytest.mark.cuda
def test_obs_is_bitwise_obs_off_on_cuda(tmp_path):
    """Obs on reads no device value: completions bitwise, the same graph
    captures and host-to-device copies, one dispatch span a window."""
    _require_cuda()
    from repro_torch.obs import ObsConfig, load_trace
    clients = _clients()
    runs, engs = {}, {}
    path = str(tmp_path / "trace.json")
    for on in (False, True):
        obs = ObsConfig(trace_path=path, metrics_path=str(
            tmp_path / "m.jsonl"), metrics_every=2) if on else None
        engs[on] = _host_engine(k=4, async_depth=2, obs=obs)
        runs[on] = engs[on].serve(_host_requests(8), clients)
    _bitwise_runs(runs[False], runs[True])
    assert (engs[True].captures, engs[True].h2d_copies) == \
        (engs[False].captures, engs[False].h2d_copies)
    assert runs[True].summary["ticks"] == runs[False].summary["ticks"]
    dispatch = [e for e in load_trace(path)
                if e.get("ph") == "X" and e["name"] == "dispatch"]
    assert len(dispatch) == runs[True].summary["windows"]


@pytest.mark.cuda
def test_profiled_serve_names_the_kernels_on_cuda(tmp_path):
    """torch.profiler over the first windows, the first captured under it:
    the trace names both kernels of the window; completions bitwise the
    unprofiled run's."""
    _require_cuda()
    from repro_torch.obs import ObsConfig
    d = tmp_path / "prof"
    eng = _host_engine(k=2, obs=ObsConfig(trace=False, profile_dir=str(d),
                                          profile_windows=3))
    res = eng.serve(_host_requests(4))
    _bitwise_runs(res, _host_engine(k=2).serve(_host_requests(4)))
    (name,) = os.listdir(d)
    text = (d / name).read_text()
    assert "traj_masked_step" in text and "lane_noise" in text


# the MoE family's reduced members (f32: E 4, top-2, dropless; DeepSeek-V2
# with MLA, Kimi-K2 with GQA through the flash kernel's f32 instance):
# prefill logits on the card against the CPU at the LM parity tests'
# atol; and Kimi-K2's MoE layer alone in bf16 (the float32-result expert
# products, ``torch.bmm(..., out_dtype=float32)`` on the card) against the
# CPU's float32 products of the same bf16 operands, to a bf16 ulp of the
# largest output
MOE_CUDA_ATOL, MOE_BF16_REL = 2e-4, 2.0 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_moe_prefill_matches_cpu_on_cuda(arch):
    _require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tf
    cfg = get_config(arch).reduced()
    cpu = tf.init_params(cfg, seed=5, device="cpu")
    card = tf.Transformer(cfg, device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(6))
    prefill = make_prefill_step(cfg)
    before = ops.flash_attention.launches
    got = prefill(card, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    want = cfg.n_layers if cfg.attn_type == "gqa" else 0
    assert ops.flash_attention.launches == before + want
    ref = prefill(cpu, {"tokens": tokens})
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=MOE_CUDA_ATOL)


@pytest.mark.cuda
def test_moe_layer_bf16_matches_cpu_on_cuda():
    _require_cuda()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(),
                              dtype="bfloat16", capacity_factor=1.25)
    cpu = tmoe.MoE(cfg, dtype=torch.bfloat16, device="cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    cpu.shared.reset_parameters(torch.Generator().manual_seed(1))
    card = tmoe.MoE(cfg, dtype=torch.bfloat16, device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).bfloat16()
    with torch.inference_mode():
        got, aux = tmoe.moe_forward(x.cuda(), card, cfg)
        ref, aux_ref = tmoe.moe_forward(x, cpu, cfg)
    assert got.dtype == torch.bfloat16
    d = (got.cpu().float() - ref.float()).abs()
    assert float(d.max()) <= MOE_BF16_REL * float(ref.float().abs().max())
    assert float(aux) == pytest.approx(float(aux_ref), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large",
                                  "xlstm-125m"])
def test_vlm_audio_xlstm_prefill_matches_cpu_on_cuda(arch):
    """Each new family's reduced member (f32) on the card against the CPU
    on the same weights and inputs: the vision prefix, the conditioning,
    the mLSTM chunks and the sLSTM loop; ``flash_attention`` once a layer
    where there is attention."""
    _require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tf
    cfg = get_config(arch).reduced()
    cpu = tf.init_params(cfg, seed=5, device="cpu")
    card = tf.Transformer(cfg, device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                     generator=g)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = 0.5 * torch.randn(
            (2, cfg.n_vision_tokens, cfg.d_model), generator=g)
    if cfg.cross_attention:
        batch["cond_embeds"] = 0.5 * torch.randn(
            (2, cfg.n_cond_tokens, cfg.d_model), generator=g)
    prefill = make_prefill_step(cfg)
    before = ops.flash_attention.launches
    got = prefill(card, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    want = 0 if cfg.family == "ssm" else cfg.n_layers
    assert ops.flash_attention.launches == before + want
    ref = prefill(cpu, batch)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=MOE_CUDA_ATOL)


@pytest.mark.cuda
def test_kernel_wrappers_raise_under_autograd_on_cuda():
    """The kernels have no backward: a CUDA input that requires a gradient
    raises while autograd records, and launches nothing; under
    ``no_grad`` the same call launches."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 64, 4, 64), generator=g, device="cuda")
    before = ops.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), q, q)
    assert ops.flash_attention.launches == before
    with torch.no_grad():
        ops.flash_attention(q, q, q)
    assert ops.flash_attention.launches == before + 1
    x = torch.randn((1, 64, 4, 32), device="cuda", requires_grad=True)
    dt = torch.rand((1, 64, 4), device="cuda")
    a = -torch.rand(4, device="cuda")
    bm = torch.randn((1, 64, 16), device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssm_scan(x, dt, a, bm, bm)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v2-236b",
                                  "zamba2-7b"])
def test_lm_train_step_matches_cpu_on_cuda(arch):
    """One train step of the reduced member (f32, TF32 off) on the card and
    on the CPU from the same weights and batch.  Before the update: the
    losses within 1e-5 relative and each gradient leaf within 1e-4 of its
    own max |g|, as phase 9 (c) holds them.  After ``make_train_step``:
    the losses and global gradient norms within 1e-5 relative, and the
    first moments, linear in the clipped gradient, within that same 1e-4
    of each leaf's max (AdamW's parameter step is near ±lr whatever the
    gradient, so the parameters would hold nothing)."""
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    cfg = get_config(arch).reduced()
    cpu = tf.init_params(cfg, seed=2, device="cpu")
    card = tf.Transformer(cfg, device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    batch = next(token_batches(cfg.vocab_size, 2, 32, device="cpu"))
    batches = (batch, {k: v.cuda() for k, v in batch.items()})

    def leaf_gap(got, want):
        return {k: float((got[k].cpu() - want[k]).abs().max())
                / max(float(want[k].abs().max()), 1e-30) for k in want}

    grads = []
    for model, b in zip((cpu, card), batches):
        loss, _ = tf.lm_loss(model, b, cfg)
        loss.backward()
        grads.append((float(loss.detach()),
                      {k: p.grad.detach().clone()
                       for k, p in model.named_parameters()}))
        for p in model.parameters():
            p.grad = None
    (l_cpu, g_cpu), (l_card, g_card) = grads
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    gap = leaf_gap(g_card, g_cpu)
    assert max(gap.values()) <= 1e-4, max(gap, key=gap.get)

    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, opt_cfg)
    out = []
    for model, b in zip((cpu, card), batches):
        state = adamw.init_state(dict(model.named_parameters()), opt_cfg)
        _, state, m = step(model, state, b)
        out.append((float(m["loss"]), float(m["grad_norm"]), state["mu"]))
    (l_cpu, n_cpu, mu_cpu), (l_card, n_card, mu_card) = out
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    assert abs(n_card - n_cpu) <= 1e-5 * n_cpu
    gap = leaf_gap(mu_card, mu_cpu)
    assert max(gap.values()) <= 1e-4, max(gap, key=gap.get)


# ---------------------------------------------------------------------------
# the mesh: two ranks sharing the card ("gloo+ipc")
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["collectives", "tp", "ep"])
def test_mesh_on_one_card_matches_one_rank(case, tmp_path):
    """Two ranks on card 0 (``tests/_torch_cuda_mesh.py``; transport
    "gloo+ipc"): every collective of ``parallel/comm.py`` on CUDA tensors
    through CUDA IPC; Yi's reduced member with its heads over
    ``model`` (flash_attention at the local H, prefill and decode against
    the whole model in float32); DeepSeek-V2's reduced member with its
    experts over ``model`` (the all-to-all and replicated paths)."""
    _require_cuda()
    if torch.cuda.device_count() > 1:
        pytest.skip("two ranks share one card only where the machine has "
                    "one; with more cards the transport is NCCL")
    from _torch_cuda_mesh import run
    torch.cuda.empty_cache()
    res = run(case, (1, 2), str(tmp_path))
    assert all(r["transport"] == "gloo+ipc" for r in res)
    if case == "collectives":
        for r in res:
            assert all(r["ok"].values()), r["ok"]
            assert r["stats"]["calls"] == 6
    elif case == "tp":
        for r in res:
            assert r["local_heads"] == 2 and r["launches"] == 2
            assert r["prefill_err"] < 2e-4 and r["decode_err"] < 2e-4, r
    else:
        for r in res:
            assert r["experts"] == 2
            assert r["paths"] == ["all_to_all", "replicated"]
            assert r["prefill_err"] < 2e-4 and r["decode_err"] < 2e-4, r
