"""Port parity for attention: ``ops.flash_attention``'s plain version
against the reference's Pallas ``flash_attention`` (interpret mode, as
``tests/test_kernels.py`` runs it) and ``attention_ref``; the port's
``blockwise_attention``, ``decode_attention`` and GQA module against the
reference's.  The CUDA kernel itself is held against the plain version on
the card by ``tests/test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import rna_tf32, set_torch_cpu  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.layers import ShardCtx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

set_torch_cpu()

TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # tests/test_kernels.py:16-17


def _qkv(b, s, h, kv, hd, seed=0, skv=None):
    rng = np.random.default_rng(seed)
    skv = skv or s
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.to(torch.float32).numpy()


@pytest.mark.parametrize("b,s,h,kv,hd,bq,bk,window", [
    (1, 128, 4, 4, 32, 64, 64, 0),       # MHA
    (2, 256, 8, 2, 64, 128, 64, 0),      # GQA g=4
    (1, 512, 4, 1, 64, 128, 128, 0),     # MQA
    (2, 256, 4, 2, 64, 64, 64, 32),      # sliding windows
    (2, 256, 4, 2, 64, 64, 64, 64),
    (2, 256, 4, 2, 64, 64, 64, 200),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_attention_ref(
        b, s, h, kv, hd, bq, bk, window, dtype):
    q, k, v = _qkv(b, s, h, kv, hd, seed=s + h + window)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    pallas = jflash(jq, jk, jv, causal=True, window=window, block_q=bq,
                    block_kv=bk)
    jr = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    before = ops.launch_counts()
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert ops.launch_counts() == before           # the plain version ran
    assert out.dtype == tdt and out.shape == tq.shape
    assert torch.equal(out, tref.attention_ref(tq, tk, tv, causal=True,
                                               window=window))
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(pallas), rtol=0, atol=tol)
    np.testing.assert_allclose(_f32(out), _f32(jr), rtol=0, atol=tol)


@pytest.mark.parametrize("causal,window,skv", [(False, 0, 96), (True, 16, 64),
                                               (False, 0, 40)])
def test_attention_ref_matches_reference(causal, window, skv):
    q, k, v = _qkv(2, 64, 6, 3, 32, seed=7, skv=skv)
    jr = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, softmax_scale=0.3)
    tr = tref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal, window=window, softmax_scale=0.3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=2e-5)


@pytest.mark.parametrize("sq,skv,window,q_offset", [
    (64, 64, 0, 0), (64, 64, 24, 0), (4096, 4096, 0, 0),
    (16, 80, 0, 64), (2048, 6144, 1000, 4096)])
def test_blockwise_attention_matches_reference(sq, skv, window, q_offset):
    """One chunk, a window, several 2048-chunks with block skipping, and a
    q_offset into a longer key range."""
    b, h, kv, hd = (1, 2, 1, 8) if sq >= 2048 else (2, 8, 2, 32)
    q, k, v = _qkv(b, sq, h, kv, hd, seed=sq + window, skv=skv)
    jo = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window, q_offset=q_offset)
    to = tattn.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=True, window=window,
                                   q_offset=q_offset)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=2e-5)


@pytest.mark.parametrize("valid_len", [None, 1, 13])
def test_decode_attention_matches_reference(valid_len):
    q, k, v = _qkv(3, 1, 8, 2, 32, seed=3, skv=24)
    jo = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), valid_len=valid_len)
    to = tattn.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                valid_len=valid_len)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=2e-5)


def _gqa_pair(seed=0):
    """The reduced Yi with 8 heads on 2 KV heads (G = 4), both packages."""
    import dataclasses
    jcfg = dataclasses.replace(jget_config("yi-6b").reduced(), n_heads=8,
                               n_kv_heads=2, head_dim=32)
    tcfg = dataclasses.replace(get_config("yi-6b").reduced(), n_heads=8,
                               n_kv_heads=2, head_dim=32)
    rng = np.random.default_rng(seed)
    d, h, kv, hd = jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    p = {"wq": rng.standard_normal((d, h, hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, kv, hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, kv, hd)) / np.sqrt(d),
         "wo": rng.standard_normal((h, hd, d)) / np.sqrt(h * hd)}
    p = {k: a.astype(np.float32) for k, a in p.items()}
    mod = tattn.GQAttention(tcfg)
    mod.load_state_dict({k: torch.from_numpy(a) for k, a in p.items()})
    return jcfg, tcfg, p, mod


@pytest.mark.parametrize("kernel", ["flash", "torch"])
@pytest.mark.parametrize("window", [0, 8])
def test_gqa_forward_matches_reference(kernel, window):
    jcfg, tcfg, p, mod = _gqa_pair()
    x = np.random.default_rng(1).standard_normal((2, 32, jcfg.d_model)) \
        .astype(np.float32)
    jk = {"flash": "pallas", "torch": "jnp"}[kernel]
    jo = jattn.gqa_forward(jnp.asarray(x), {k: jnp.asarray(a) for k, a in
                                            p.items()}, jcfg, ShardCtx(),
                           window=window, kernel=jk)
    with torch.no_grad():
        to = tattn.gqa_forward(torch.from_numpy(x), mod, tcfg, window=window,
                               kernel=kernel)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=2e-5)


def test_gqa_decode_chain_matches_reference():
    jcfg, tcfg, p, mod = _gqa_pair()
    x = np.random.default_rng(2).standard_normal((2, 12, jcfg.d_model)) \
        .astype(np.float32)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jc = jattn.gqa_init_cache(jcfg, 2, 12, jnp.float32)
    tc = tattn.gqa_init_cache(tcfg, 2, 12, torch.float32, "cpu")
    for pos in range(12):
        jo, jc = jattn.gqa_decode(jnp.asarray(x[:, pos:pos + 1]), jp, jc,
                                  jnp.int32(pos), jcfg, ShardCtx())
        with torch.no_grad():
            to, tc = tattn.gqa_decode(torch.from_numpy(x[:, pos:pos + 1]),
                                      mod, tc, pos, tcfg)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=2e-5)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=0,
                               atol=2e-5)


def test_attention_bound_counts():
    """The work chip_smoke.py holds the kernel's time against: FLOP on the
    visible causal triangle (and window band), bytes of q, k, v and out."""
    assert tfa.visible_pairs(4, 4, True, 0) == 10
    assert tfa.visible_pairs(6, 6, True, 2) == 11
    assert tfa.visible_pairs(3, 5, False, 0) == 15
    q = torch.empty((4, 2048, 32, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((4, 2048, 4, 128), dtype=torch.bfloat16, device="meta")
    assert tfa.attention_flops(q, k) == 4 * 128 * 4 * 32 * 2048 * 2049 // 2
    assert tfa.attention_bytes(q, k, k) == 2 * 2 * 4 * 2048 * 128 * (32 + 4)


def _brute_tile_pairs(sq, skv, causal, window, rows, keys):
    """(q tile, key tile) pairs holding at least one visible pair."""
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    vis = np.ones((sq, skv), bool)
    if causal:
        vis &= j <= i
    if window:
        vis &= j > i - window
    return sum(bool(vis[a:a + rows, c:c + keys].any())
               for a in range(0, sq, rows) for c in range(0, skv, keys))


@pytest.mark.parametrize("sq,skv,causal,window,rows,keys", [
    (64, 64, True, 0, 16, 8), (67, 67, True, 0, 16, 16),
    (100, 100, True, 24, 16, 8), (50, 90, False, 0, 16, 32),
    (90, 50, True, 0, 32, 16), (128, 128, True, 200, 32, 32),
    (2085, 2085, True, 0, 128, 128), (520, 520, True, 1024, 128, 128)])
@pytest.mark.parametrize("hd", [32, 112])
def test_attention_flops_executed_counts_the_visited_tiles(
        sq, skv, causal, window, rows, keys, hd):
    """The kernel visits exactly the tiles with a visible pair; each costs
    2·rows·keys·(hd + max(hd, 64)) (p·v at 64 columns for hd 32), never less
    than the least work."""
    q = torch.empty((2, sq, 6, hd), device="meta")
    k = torch.empty((2, skv, 3, hd), device="meta")
    got = tfa.attention_flops_executed(q, k, causal=causal, window=window,
                                       rows=rows, keys=keys)
    want = 2 * rows * keys * (hd + max(hd, 64)) * 2 * 6 * _brute_tile_pairs(
        sq, skv, causal, window, rows, keys)
    assert got == want
    assert got >= tfa.attention_flops(q, k, causal=causal, window=window)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (2085, 2085, True, 0), (300, 300, True, 40), (96, 160, False, 0),
    (1000, 1000, True, 10), (37, 37, True, 0)])
@pytest.mark.parametrize("hd", [32, 112, 128])
def test_attention_flops_executed_f32_counts_each_warps_visible_tiles(
        sq, skv, causal, window, hd):
    """The float32 kernel's warps (16 rows) execute exactly the 32-key tiles
    that hold a visible pair for one of their rows, at 2·16·32·2·hd each."""
    q = torch.empty((2, sq, 4, hd), device="meta")
    k = torch.empty((2, skv, 2, hd), device="meta")
    got = tfa.attention_flops_executed_f32(q, k, causal=causal,
                                           window=window)
    want = 2 * 16 * 32 * 2 * hd * 2 * 4 * _brute_tile_pairs(
        sq, skv, causal, window, tfa.F32_WARP_ROWS, tfa.F32_BLOCK_K)
    assert got == want
    assert got >= tfa.attention_flops(q, k, causal=causal, window=window)


# The float32 kernel's arithmetic (csrc/flash_attention.cu, float32
# instance), emulated in plain torch on the CPU: 32-key tiles in ascending
# order; q * scale rounded to float32, then every product operand split
# into TF32 hi and lo (rna_tf32) and each product a b run k-step by k-step
# (8 wide) as three TF32 products: for q·kᵀ a_hi b_hi into one float32
# accumulator and a_lo b_hi + a_hi b_lo into another, summed at the tile's
# end; for p·v a_lo b_hi, a_hi b_lo and a_hi b_hi added in turn to o.  The
# online softmax in float32 and log2 units, masked scores the finite
# -2^30, keys past Skv -inf; p·v with the keys of each 8-key step in the
# kernel's order (k-column c is key 2c for c < 4 and key 2(c - 4) + 1
# after: the accumulator's pairs, unshuffled).
_LOG2E = float(np.float32(1.4426950408889634))
_NEG_INF = -2.0 ** 30
_PV_ORDER = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def _k_steps(a, b):
    """(a, b) cut into the kernel's k-steps of 8."""
    return [(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :])
            for k0 in range(0, a.shape[-1], 8)]


def _qk_3xtf32(a, b):
    """a @ b as q·kᵀ's k-steps: hi·hi and the two small terms in two
    accumulators."""
    ah, bh = rna_tf32(a), rna_tf32(b)
    al, bl = rna_tf32(a - ah), rna_tf32(b - bh)
    big = small = 0
    for (xh, yh), (xl, yl) in zip(_k_steps(ah, bh), _k_steps(al, bl)):
        small = small + xl @ yh
        small = small + xh @ yl
        big = big + xh @ yh
    return big + small


def _pv_3xtf32(acc, a, b):
    """acc + a @ b as p·v's k-steps: the three products added in turn."""
    ah, bh = rna_tf32(a), rna_tf32(b)
    al, bl = rna_tf32(a - ah), rna_tf32(b - bh)
    for (xh, yh), (xl, yl) in zip(_k_steps(ah, bh), _k_steps(al, bl)):
        acc = acc + xl @ yh
        acc = acc + xh @ yl
        acc = acc + xh @ yh
    return acc


def _qk_tf32(a, b):
    """a @ b as one plain TF32 product a k-step."""
    acc = 0
    for x, y in _k_steps(rna_tf32(a), rna_tf32(b)):
        acc = acc + x @ y
    return acc


def _pv_tf32(acc, a, b):
    return acc + _qk_tf32(a, b)


def _flash_f32_emulated(q, k, v, *, causal=True, window=0, scale=None,
                        qk=_qk_3xtf32, pv=_pv_3xtf32, ex2_rel=0.0,
                        seed=0):
    """The float32 kernel's result from float32 CPU tensors q (B, Sq, H,
    hd), k and v (B, Skv, KV, hd).  ``ex2_rel`` perturbs every exp2 by a
    relative error drawn from ±ex2_rel, a model of the MUFU's ex2.approx.
    Every row visits every tile: a tile that masks all of a row's keys
    leaves its m, l and o as the kernel's skip does, or adds garbage that
    the next alpha = 0 wipes."""
    b, sq, h, hd = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    scale = 1.0 / np.sqrt(hd) if scale is None else scale
    qs = (q * np.float32(scale)).permute(0, 2, 1, 3)          # (b, h, sq, hd)
    kh = k.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vh = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    gen = torch.Generator().manual_seed(seed)
    pos = torch.arange(sq)[:, None]

    def ex2(x):
        y = torch.exp2(x)
        return y * (1 + ex2_rel * (2 * torch.rand(y.shape, generator=gen) - 1)
                    ).to(torch.float32)

    m = torch.full((b, h, sq, 1), _NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, hd))
    for k_lo in range(0, skv, 32):
        pad = (0, 0, 0, max(0, k_lo + 32 - skv))
        kt = torch.nn.functional.pad(kh[:, :, k_lo:k_lo + 32], pad)
        vt = torch.nn.functional.pad(vh[:, :, k_lo:k_lo + 32], pad)
        s = qk(qs, kt.transpose(-1, -2))
        s = s * _LOG2E
        key = k_lo + torch.arange(32)[None, :]
        masked = torch.zeros((sq, 32), dtype=torch.bool)
        if causal:
            masked |= key > pos
        if window:
            masked |= key <= pos - window
        s = torch.where(masked, torch.tensor(_NEG_INF), s)
        s = torch.where(key >= skv, torch.tensor(float("-inf")), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = ex2(m - m_new)
        p = ex2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        order = torch.cat([j + _PV_ORDER for j in range(0, 32, 8)])
        o = pv(o * alpha, p[..., order], vt[:, :, order])
        m = m_new
    return (o / torch.clamp_min(l, 1e-37)).permute(0, 2, 1, 3)


def _attention_f64(q, k, v, *, causal=True, window=0, scale=None):
    """attention_ref's definition evaluated in float64."""
    b, sq, h, hd = q.shape
    g = h // k.shape[2]
    scale = 1.0 / np.sqrt(hd) if scale is None else scale
    qd = q.double().permute(0, 2, 1, 3)
    kd = k.double().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vd = v.double().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    s = (qd @ kd.transpose(-1, -2)) * scale
    i = torch.arange(sq)[:, None]
    j = torch.arange(k.shape[1])[None, :]
    ok = torch.ones((sq, k.shape[1]), dtype=torch.bool)
    if causal:
        ok &= j <= i
    if window:
        ok &= j > i - window
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    return (p @ vd).permute(0, 2, 1, 3)


_EMULATED = [
    # b, s, h, kv, hd, window, scale: hd 128 with GQA (G 4) and a ragged
    # 32-key tile; hd 112, MHA; a window whose rows see only masked keys in
    # their first tile; a negative scale
    (1, 200, 8, 2, 128, 0, None),
    (2, 96, 2, 2, 112, 0, None),
    (1, 300, 4, 2, 64, 40, None),
    (1, 130, 4, 1, 32, 0, -0.2),
]


@pytest.mark.parametrize("b,s,h,kv,hd,window,scale", _EMULATED)
def test_flash_f32_kernel_arithmetic_holds_the_f32_tolerance(
        b, s, h, kv, hd, window, scale):
    """The float32 kernel's arithmetic (3xTF32 products, the permuted p·v
    key order, exp2 with the MUFU's error ~2^-22 modelled as twice that)
    against the definition in float64: within the float32 tolerance."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, s, h, kv, hd, seed=s))
    want = _attention_f64(q, k, v, causal=True, window=window, scale=scale)
    got = _flash_f32_emulated(q, k, v, causal=True, window=window,
                              scale=scale, ex2_rel=2.0 ** -21)
    assert got.dtype == torch.float32
    err = float((got.double() - want).abs().max())
    assert err <= TOL["float32"], err
    ref = tref.attention_ref(q, k, v, causal=True, window=window,
                             softmax_scale=scale)
    assert float((ref.double() - want).abs().max()) <= TOL["float32"]


@pytest.mark.parametrize("product", ["qk", "pv"])
@pytest.mark.parametrize("b,s,h,kv,hd,window,scale", _EMULATED[:2])
def test_flash_f32_one_plain_tf32_product_misses_the_f32_tolerance(
        b, s, h, kv, hd, window, scale, product):
    """With either product as plain TF32 (one mma a k-step) the same
    emulation misses 2e-5: the kernel needs the 3xTF32 split in both."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, s, h, kv, hd, seed=s))
    want = _attention_f64(q, k, v, causal=True, window=window, scale=scale)
    plain = {"qk": _qk_tf32, "pv": _pv_tf32}[product]
    got = _flash_f32_emulated(q, k, v, causal=True, window=window,
                              scale=scale, **{product: plain})
    assert float((got.double() - want).abs().max()) > TOL["float32"]

