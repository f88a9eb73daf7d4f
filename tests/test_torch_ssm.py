"""Port parity for the Mamba2 block: ``ops.ssm_scan``'s plain version
against the reference's Pallas ``ssm_scan`` (interpret mode, as
``tests/test_kernels.py`` runs it) and ``ssm_scan_ref``; the port's chunk
loop at several chunk lengths; ``ssm_forward`` (both kernels) against the
reference's on the same numpy weights; and the cached decode chain against
the forward.  The CUDA kernel itself is held against the plain version on
the card by ``tests/test_torch_cuda.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (mm_3xtf32, mm_tf32, rna_tf32,  # noqa: E402
                           set_torch_cpu, ssm_params)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as jssm_scan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.layers import ShardCtx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssm_scan as tssm_k  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

set_torch_cpu()

# relative to the reference's largest |y| (tests/test_kernels.py:99-102)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRID = [(1, 64, 4, 16, 8, 16, 4),       # tests/test_kernels.py:77-82
        (2, 128, 8, 32, 16, 32, 8),
        (2, 96, 6, 16, 8, 32, 2),
        (1, 256, 16, 64, 64, 128, 8)]


def _scan_inputs(b, s, nh, p, n, seed=0):
    """x, dt (softplus'd), a (< 0, float32), bm, cm as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    a = -np.exp(0.3 * rng.standard_normal(nh)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, bm, cm


def _rel_err(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-6)


def _as(dtype, x, dt, a, bm, cm):
    """The same inputs as (jax arrays, torch tensors) in ``dtype`` (a stays
    float32, as ssm_forward passes it)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = tuple(jnp.asarray(v, jnp.float32 if v is a else jdt)
              for v in (x, dt, a, bm, cm))
    t = tuple(torch.from_numpy(v) if v is a else torch.from_numpy(v).to(tdt)
              for v in (x, dt, a, bm, cm))
    return j, t


@pytest.mark.parametrize("b,s,nh,p,n,chunk,hb", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_plain_matches_pallas_and_recurrence(b, s, nh, p, n, chunk,
                                                      hb, dtype):
    (jx, jdt, ja, jbm, jcm), (tx, tdt, ta, tbm, tcm) = _as(
        dtype, *_scan_inputs(b, s, nh, p, n, seed=s + nh))
    pallas = jssm_scan(jx, jdt, ja, jbm, jcm, chunk=chunk, head_block=hb)
    jr = jref.ssm_scan_ref(jx, jdt, ja, jbm, jcm)
    before = ops.launch_counts()
    y = ops.ssm_scan(tx, tdt, ta, tbm, tcm, chunk=chunk, head_block=hb)
    assert ops.launch_counts() == before           # plain version on the CPU
    assert y.dtype == tx.dtype and y.shape == tx.shape
    yf = y.to(torch.float32).numpy()
    assert _rel_err(yf, jr) < TOL[dtype]
    assert _rel_err(yf, pallas) < TOL[dtype]


def test_ssm_scan_plain_takes_float32_dt_with_bfloat16_x():
    """ssm_forward's mix on a card: dt float32 while x is bf16."""
    x, dt, a, bm, cm = _scan_inputs(2, 96, 6, 16, 8, seed=3)
    (jx, _, ja, jbm, jcm), (tx, _, ta, tbm, tcm) = _as("bfloat16", x, dt, a,
                                                      bm, cm)
    jr = jref.ssm_scan_ref(jx, jnp.asarray(dt), ja, jbm, jcm)
    y = ops.ssm_scan(tx, torch.from_numpy(dt), ta, tbm, tcm)
    assert y.dtype == torch.bfloat16
    assert _rel_err(y.to(torch.float32).numpy(), jr) < TOL["bfloat16"]


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
def test_chunk_loop_is_independent_of_the_chunk(chunk):
    """The port's chunk loop (ssm_forward's "torch" mixing) at any chunk
    against the stepwise recurrence and the Pallas kernel at chunks 16 and
    64 (tests/test_kernels.py:105-117)."""
    x, dt, a, bm, cm = _scan_inputs(1, 128, 4, 16, 8, seed=5)
    t = [torch.from_numpy(v) for v in (x, dt, a, bm, cm)]
    y = tssm._chunked_mixing(t[0], t[1], t[2], t[3], t[4], chunk).numpy()
    want = tref.ssm_scan_ref(*t).numpy()
    assert _rel_err(y, want) < TOL["float32"]
    j = [jnp.asarray(v) for v in (x, dt, a, bm, cm)]
    for c in (16, 64):
        np.testing.assert_allclose(y, np.asarray(jssm_scan(
            *j, chunk=c, head_block=4)), rtol=0, atol=1e-4)


def test_ssm_scan_counts_and_helpers():
    x = torch.zeros((4, 2048, 112, 64))
    bm = torch.zeros((4, 2048, 64))
    # executed, at the kernel's chunk: the 136 lower-triangle 4x4 tiles of
    # G once per (batch, chunk); per head, on P and N padded to 64, W·X over
    # four 16-row bands that see 16, 32, 48 and 64 keys, C·state, the update
    # over every step of the chunk, and the decay
    gram = 136 * 16 * 2 * 64
    bands = 2 * 64 * 16 * (16 + 32 + 48 + 64)
    per_chunk = gram + 112 * (bands + 2 * 64 * 64 * 64 + 2 * 64 * 64 * 64
                              + 64 * 64)
    assert tssm_k.ssd_flops_executed(x, bm) == 4 * 32 * per_chunk
    # a ragged last chunk runs whole
    assert tssm_k.ssd_flops_executed(x[:, :100], bm[:, :100]) == \
        4 * 2 * per_chunk
    # narrow P and N run at the padded width; G's tiles take N as it is
    x24, bm5 = torch.zeros((1, 64, 3, 24)), torch.zeros((1, 64, 5))
    assert tssm_k.ssd_flops_executed(x24, bm5) == 136 * 16 * 2 * 5 + 3 * (
        bands + 4 * 64 * 64 * 64 + 64 * 64)
    # least: the chunked form at L = 8 (256 chunks), without C·state in
    # the first chunk and the update and decay in the last
    def chunk8(reads, writes):
        return 2 * 8 * 8 * 64 + 112 * (8 * 9 * 64 + 2 * 8 * 64 * 64 * (
            reads + writes) + 64 * 64 * (reads and writes))
    least = 4 * (chunk8(0, 1) + 254 * chunk8(1, 1) + chunk8(1, 0))
    assert tssm_k.ssd_flops(x, bm) == least
    # below both the kernel's chunk and the step recurrence (5·N·P a step)
    assert least < tssm_k.ssd_flops_executed(x, bm)
    assert least < 4 * 2048 * 112 * 5 * 64 * 64
    # one step: y = (c·b)·dt·x, no state
    assert tssm_k.ssd_flops(x[:1, :1], bm[:1, :1]) == 2 * 64 + 112 * 2 * 64
    dt = torch.zeros((4, 2048, 112))
    a = torch.zeros(112)
    assert tssm_k.ssd_bytes(x, dt, a, bm, bm) == 4 * (
        2 * x.numel() + dt.numel() + 112 + 2 * bm.numel())
    # the grid: one block a (head, batch), whatever head_block the caller
    # names; and the scratch, a record of G, C and B (64 padded rows each)
    # per (batch, chunk)
    assert tssm_k.grid_for(4, 112) == (112, 4)
    assert tssm_k.grid_for(3, 5) == (5, 3)
    assert tssm_k.scratch_numel(4, 2048) == 4 * 32 * 64 * (68 + 68 + 72)
    assert tssm_k.scratch_numel(2, 65) == 2 * 2 * 64 * (68 + 68 + 72)
    with pytest.raises(ValueError, match="positive"):
        ops.ssm_scan(x[:1, :4], dt[:1, :4], a, bm[:1, :4], bm[:1, :4],
                     chunk=0)


def _ssd_chunked(x, dt, a, bm, cm, mm, chunk=64):
    """The kernel's chunked form at its chunk, in x's dtype, with its four
    products (W·X, C·state, (u B)ᵀ·X; G = C·Bᵀ stays a plain product, as
    the record kernel forms it on the float32 units) through ``mm``."""
    b, s, nh, _ = x.shape
    state = x.new_zeros((b, nh, bm.shape[-1], x.shape[-1]))
    ys = []
    for lo in range(0, s, chunk):
        xc = x[:, lo:lo + chunk].permute(0, 2, 1, 3)          # (b, nh, l, p)
        dtc = dt[:, lo:lo + chunk].permute(0, 2, 1)            # (b, nh, l)
        bc, cc = bm[:, lo:lo + chunk], cm[:, lo:lo + chunk]   # (b, l, n)
        ln = xc.shape[2]
        cum = torch.cumsum(dtc * a[None, :, None], dim=-1)
        causal = torch.ones(ln, ln, dtype=torch.bool).tril()
        diff = torch.where(causal, cum[..., :, None] - cum[..., None, :], 0)
        g = (cc @ bc.transpose(1, 2))[:, None]
        w = torch.where(causal, g * torch.exp(diff) * dtc[..., None, :], 0)
        cs = mm(cc[:, None].expand(-1, nh, -1, -1), state)
        ys.append((mm(w, xc) + torch.exp(cum)[..., None] * cs)
                  .permute(0, 2, 1, 3))
        u = dtc * torch.exp(cum[..., -1:] - cum)
        ub = (bc[:, None] * u[..., None]).transpose(-1, -2)    # (b, nh, n, l)
        state = state * torch.exp(cum[..., -1])[..., None, None] + mm(ub, xc)
    return torch.cat(ys, dim=1)


def test_tf32_rna_split_rounds_ties_away_and_keeps_2_22():
    """The split the kernel feeds its mma: hi rounds to 10 mantissa bits,
    ties away from zero, and hi + lo is within 2^-22 of v."""
    tie = 1.0 + 2.0 ** -11                 # half a TF32 ulp above 1
    v = torch.tensor([tie, -tie, tie - 2.0 ** -23, 3.0, 0.0],
                     dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0, 0.0]
    assert rna_tf32(v).tolist() == want
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32)) * 1e3
    hi = rna_tf32(r)
    lo = rna_tf32(r - hi)
    assert float(((hi.double() + lo.double() - r.double()).abs()
                  / r.double().abs()).max()) <= 2.0 ** -22
    assert float(((hi.double() - r.double()).abs()
                  / r.double().abs()).max()) > 2.0 ** -12


@pytest.mark.parametrize("b,s,nh,p,n", [(1, 192, 4, 64, 64),
                                        (2, 130, 3, 24, 40)])
def test_ssd_3xtf32_chunked_form_within_float32_tolerance(b, s, nh, p, n):
    """The kernel's arithmetic, emulated in plain torch on the chunked form
    at a reduced Zamba2-like shape, against the same form in float64: the
    3xTF32 products hold the float32 tolerance; one plain TF32 product
    would not."""
    ins = _scan_inputs(b, s, nh, p, n, seed=s + n)
    f32 = [torch.from_numpy(v) for v in ins]
    f64 = [v.double() for v in f32]
    want = _ssd_chunked(*f64, mm=torch.matmul)
    assert _rel_err(want, tref.ssm_scan_ref(*f32)) < TOL["float32"]
    assert _rel_err(_ssd_chunked(*f32, mm=mm_3xtf32), want) < \
        TOL["float32"]
    assert _rel_err(_ssd_chunked(*f32, mm=mm_tf32), want) > TOL["float32"]


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------
def _block(variant, seed=0):
    """(reference cfg, port cfg, reference params, port module) for
    Zamba2's reduced member (d 256, 16 heads of 32, N 16, chunk 16) or a
    variant with ragged head widths (d 96: 6 heads of 32, N 8, chunk 8)."""
    jcfg, tcfg = jget_config("zamba2-7b").reduced(), \
        get_config("zamba2-7b").reduced()
    if variant == "narrow":
        kw = dict(d_model=96, ssm_heads=6, ssm_state=8, ssm_chunk=8)
        jcfg = dataclasses.replace(jcfg, **kw)
        tcfg = dataclasses.replace(tcfg, **kw)
    tree = ssm_params(jcfg, seed)
    mod = tssm.Mamba2(tcfg)
    mod.load_state_dict({k: torch.from_numpy(np.asarray(v))
                         for k, v in tree.items()})
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), mod.eval()


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def test_mamba2_module_holds_ssm_init_leaves():
    jcfg, tcfg, jp, mod = _block("zamba2")
    shapes = {k: tuple(v.shape) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in mod.state_dict().items()} == shapes
    fresh = tssm.Mamba2(tcfg)
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    for name in ("dt_bias", "A_log", "conv_b"):
        assert torch.count_nonzero(getattr(fresh, name)) == 0
    assert torch.all(fresh.D == 1) and torch.all(fresh.norm_scale == 1)
    assert fresh.A_log.dtype == fresh.D.dtype == torch.float32
    w = fresh.conv_w.detach()                 # fan-in = the conv's width
    assert float(w.abs().max()) <= 3 * tcfg.conv_width ** -0.5 + 1e-6
    assert float(fresh.w_out.detach().abs().max()) <= \
        3 * tcfg.d_inner_ssm ** -0.5 + 1e-6


@pytest.mark.parametrize("variant,s", [("zamba2", 64), ("narrow", 40)])
@pytest.mark.parametrize("kernel", ["flash", "torch"])
def test_ssm_forward_matches_reference(variant, s, kernel):
    """S spans several chunks (4 of 16; 5 of 8)."""
    jcfg, tcfg, jp, mod = _block(variant)
    x = _x(2, s, tcfg.d_model)
    ref = jssm.ssm_forward(jnp.asarray(x), jp, jcfg, ShardCtx())
    before = ops.launch_counts()
    with torch.inference_mode():
        out = tssm.ssm_forward(torch.from_numpy(x), mod, tcfg, kernel=kernel)
    assert ops.launch_counts() == before
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-4)


def test_ssm_forward_in_bfloat16_matches_reference():
    """The dtype points: bf16 projections, f32 dt, conv, mixing and norm.
    Tolerance: a few bf16 ulps of outputs of size ~1 (2^-8 relative), the
    two frameworks rounding the projections' f32 sums alike."""
    jcfg, tcfg, jp, mod = _block("zamba2")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    f32 = {"dt_bias", "A_log", "D"}
    jp = {k: v if k in f32 else v.astype(jnp.bfloat16) for k, v in jp.items()}
    mod = mod.to(torch.bfloat16)
    for name in f32:
        getattr(mod, name).data = getattr(mod, name).data.float()
    x = _x(2, 64, tcfg.d_model)
    ref = jssm.ssm_forward(jnp.asarray(x, jnp.bfloat16), jp, jcfg, ShardCtx())
    with torch.inference_mode():
        outs = [tssm.ssm_forward(torch.from_numpy(x).to(torch.bfloat16), mod,
                                 tcfg, kernel=k) for k in ("flash", "torch")]
    want = np.asarray(ref.astype(jnp.float32))
    for out in outs:
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                                   atol=4 * 2.0 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("variant", ["zamba2", "narrow"])
def test_ssm_decode_chain_matches_forward_and_reference(variant):
    """Cached decode over S steps: against the port's forward (both
    kernels) and the reference's own decode chain."""
    jcfg, tcfg, jp, mod = _block(variant)
    b, s = 2, 32
    x = _x(b, s, tcfg.d_model, seed=2)
    cache = tssm.ssm_init_cache(tcfg, b, torch.float32, "cpu")
    assert cache["state"].shape == (b, tcfg.ssm_heads, tcfg.ssm_state,
                                    tcfg.ssm_head_dim)
    assert cache["conv"].shape == (b, tcfg.conv_width - 1,
                                   tcfg.d_inner_ssm + 2 * tcfg.ssm_state)
    jcache = jssm.ssm_init_cache(jcfg, b, jnp.float32)
    jdec = jax.jit(lambda p, xt, c: jssm.ssm_decode(xt, p, c, jcfg,
                                                    ShardCtx()))
    touts, jouts = [], []
    with torch.inference_mode():
        for t in range(s):
            o, cache = tssm.ssm_decode(torch.from_numpy(x[:, t:t + 1]), mod,
                                       cache, tcfg)
            touts.append(o[:, 0].numpy())
            jo, jcache = jdec(jp, jnp.asarray(x[:, t:t + 1]), jcache)
            jouts.append(np.asarray(jo[:, 0]))
        fwd = {k: tssm.ssm_forward(torch.from_numpy(x), mod, tcfg,
                                   kernel=k).numpy()
               for k in ("flash", "torch")}
    dec = np.stack(touts, axis=1)
    np.testing.assert_allclose(dec, np.stack(jouts, axis=1), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(cache["state"].numpy(),
                               np.asarray(jcache["state"]), rtol=0, atol=2e-4)
    for out in fwd.values():
        np.testing.assert_allclose(dec, out, rtol=0, atol=2e-4)
