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

from _torch_parity import set_torch_cpu  # noqa: E402
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
