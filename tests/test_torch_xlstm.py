"""Port parity for the ssm family (xLSTM): the mLSTM's chunked forward at
one and at several chunks, its decode, the sLSTM's forward and decode
(``repro_torch.models.xlstm``) against the reference's
``repro/models/xlstm.py``; the stack with groups and a remainder and
without sLSTM blocks, its prefill, its cached decode chain against the
reference's and the port's own forward (the chunked form against the
recurrence), and ``params_from_jax``, on the same numpy weights.  The
config is the reference's reduced xLSTM (f32; d 256, 4 heads of 128 in
the mLSTM, ``slstm_every`` 2)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import lm_params, set_torch_cpu, xlstm_params  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.models.layers import ShardCtx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402

set_torch_cpu()

ARCH = "xlstm-125m"
B = 2
# f32 on both sides; the port contracts the mLSTM's normaliser in another
# order than the reference's three-operand einsum, and the chunked form
# against the recurrence sums in other orders over S positions
ATOL, LOGIT_ATOL = 1e-5, 2e-4
# the mLSTM forward's outputs reach ~3.5 (mean |out| ~0.47); over 3 chunks
# of 256 the two packages' float32 sums part by up to 1.4e-5 at 9 of 393216
# elements, 5e-7 on average: held to max 4e-5 and mean 2e-6
MLSTM_MAX, MLSTM_MEAN = 4e-5, 2e-6
# the stack's variants: the reduced member (one group, an mLSTM and an
# sLSTM), 3 layers (a group and a remainder mLSTM), no sLSTM blocks
VARIANTS = {"reduced": {}, "rem": dict(n_layers=3),
            "mlstm": dict(slstm_every=0)}


def _configs(**kw):
    return (dataclasses.replace(jget_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _block(kind, seed=0, f_bias=None):
    jcfg, tcfg = _configs()
    tree = xlstm_params(kind, jcfg, seed)
    if f_bias is not None:
        tree["f_bias"] = np.full_like(tree["f_bias"], f_bias)
    mod = {"mlstm": txl.MLSTM, "slstm": txl.SLSTM}[kind](tcfg, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.asarray(v))
                         for k, v in tree.items()})
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), mod


def _x(tcfg, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, s, tcfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s,f_bias", [(64, None), (512, 6.0), (768, 6.0),
                                      (512, -20.0)])
def test_mlstm_forward_matches_reference(s, f_bias):
    """S 64 is one chunk; 512 and 768 are 2 and 3 chunks of 256 with
    forget gates near 1 (bias 6: a chunk's carried state weighs ~0.5 at
    its end); bias -20 makes exp(seg) overflow above the diagonal, where
    the weights must be 0, not NaN."""
    jcfg, tcfg, jp, mod = _block("mlstm", f_bias=f_bias)
    assert txl.mlstm_chunk_len(s) == min(s, 256)
    x = _x(tcfg, s)
    ref = jxl.mlstm_forward(jnp.asarray(x), jp, jcfg, ShardCtx())
    with torch.inference_mode():
        out = txl.mlstm_forward(torch.from_numpy(x), mod, tcfg)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    d = np.abs(out.numpy() - np.asarray(ref))
    assert d.max() <= MLSTM_MAX and d.mean() <= MLSTM_MEAN, \
        (d.max(), d.mean())


def test_mlstm_forward_rejects_a_partial_chunk():
    _, tcfg, _, mod = _block("mlstm")
    assert txl.mlstm_chunk_len(2048) == 256 and \
        txl.mlstm_chunk_len(16384) == 512
    with pytest.raises(ValueError, match="not a multiple"):
        txl.mlstm_forward(torch.zeros((1, 300, tcfg.d_model)), mod, tcfg)


def _chain(step_j, step_t, jcache, tcache, x):
    """Feed x (B, S, d) a token at a time through both decode steps."""
    jouts, touts = [], []
    with torch.inference_mode():
        for t in range(x.shape[1]):
            jo, jcache = step_j(jnp.asarray(x[:, t:t + 1]), jcache)
            to, tcache = step_t(torch.from_numpy(x[:, t:t + 1]), tcache)
            jouts.append(np.asarray(jo))
            touts.append(to.numpy())
    return np.concatenate(jouts, 1), np.concatenate(touts, 1), tcache


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_matches_reference_and_forward(kind):
    """24 decode steps from a zeroed cache: each step against the
    reference's decode, and the chain against the port's forward over the
    same 24 tokens (for the mLSTM, the recurrence against the chunked
    form)."""
    jcfg, tcfg, jp, mod = _block(kind, f_bias=6.0 if kind == "mlstm"
                                 else None)
    x = _x(tcfg, 24, seed=5)
    jdec = getattr(jxl, f"{kind}_decode")
    jinit = getattr(jxl, f"{kind}_init_cache")
    tdec = getattr(txl, f"{kind}_decode")
    tinit = getattr(txl, f"{kind}_init_cache")
    step_j = jax.jit(lambda xt, c: jdec(xt, jp, c, jcfg, ShardCtx()))
    jo, to, cache = _chain(step_j, lambda xt, c: tdec(xt, mod, c, tcfg),
                           jinit(jcfg, B, jnp.float32),
                           tinit(tcfg, B, "cpu"), x)
    assert all(v.dtype == torch.float32 for v in cache.values())
    np.testing.assert_allclose(to, jo, rtol=0, atol=ATOL)
    with torch.inference_mode():
        fwd = getattr(txl, f"{kind}_forward")(torch.from_numpy(x), mod, tcfg)
    np.testing.assert_allclose(to, fwd.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("s", [16, 96])
def test_slstm_forward_matches_reference(s):
    jcfg, tcfg, jp, mod = _block("slstm")
    x = _x(tcfg, s, seed=7)
    ref = jxl.slstm_forward(jnp.asarray(x), jp, jcfg, ShardCtx())
    with torch.inference_mode():
        out = txl.slstm_forward(torch.from_numpy(x), mod, tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def _models(variant, s, seed=0):
    jcfg, tcfg = _configs(**VARIANTS[variant])
    tree = lm_params(jcfg, seed)
    model = ttf.Transformer(tcfg, device="cpu").eval()
    model.load_state_dict(ttf.params_from_jax(tree))
    toks = np.random.default_rng(seed + 1).integers(
        0, tcfg.vocab_size, (B, s)).astype(np.int32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), model, toks


@pytest.mark.parametrize("variant,s", [("reduced", 512), ("rem", 64),
                                       ("mlstm", 64)])
def test_xlstm_prefill_matches_reference(variant, s):
    """The reduced member over 2 mLSTM chunks; the other variants at one."""
    jcfg, tcfg, jp, model, toks = _models(variant, s)
    ref = jtf.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    out = make_prefill_step(tcfg)(model,
                                  {"tokens": torch.from_numpy(toks).long()})
    assert out.shape == (B, s, tcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_xlstm_decode_chain_matches_reference_and_forward(variant):
    """Teacher-forced decode over 24 positions through the cache (an mLSTM
    state and norm a layer, the sLSTM's c, n, h and m): against the
    reference's chain and the port's own forward."""
    s = 24
    jcfg, tcfg, jp, model, toks = _models(variant, s)
    jcache = jtf.init_cache(jcfg, B, s)
    tcache = ttf.init_cache(tcfg, B, s, device="cpu")
    g, k, rem = ttf.xlstm_layout(tcfg)
    if k:
        assert len(tcache["groups"]) == g and \
            len(tcache["groups"][0]["mlstm"]) == k - 1
        assert set(tcache["groups"][0]["slstm"]) == {"c", "n", "h", "m"}
        assert (tcache["rem"] is None) == (rem == 0)
    else:
        assert set(tcache) == {"layers"} and len(tcache["layers"]) == rem
    decode = make_decode_step(tcfg)
    jdec = jax.jit(lambda p, c, t, pos: jtf.decode_step(
        p, c, {"tokens": t}, pos, jcfg))
    touts, jouts = [], []
    for pos in range(s):
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.int32(pos))
        tl, tcache = decode(model, tcache,
                            {"tokens": torch.from_numpy(
                                toks[:, pos:pos + 1]).long()}, pos)
        jouts.append(np.asarray(jl[:, 0]))
        touts.append(tl[:, 0].numpy())
    dec = np.stack(touts, axis=1)
    np.testing.assert_allclose(dec, np.stack(jouts, axis=1), rtol=0,
                               atol=LOGIT_ATOL)
    fwd = make_prefill_step(tcfg)(model,
                                  {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(dec, fwd.numpy(), rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_params_from_jax_maps_every_xlstm_leaf_once(variant):
    """The reference's ``param_count`` for xLSTM leaves out each mLSTM's
    f_bias (nh) and counts the sLSTM's up and down maps as 2·d² (they hold
    4·d²): the tree and the port hold ``param_count() + n_mlstm·nh +
    n_slstm·2·d²``."""
    jcfg, tcfg = _configs(**VARIANTS[variant])
    tree = lm_params(jcfg, 0)
    sd = ttf.params_from_jax(tree)
    g, k, rem = ttf.xlstm_layout(tcfg)
    n_s = g
    n_m = tcfg.n_layers - n_s
    n_leaves = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in sd.values()) == n_leaves == \
        tcfg.param_count() + n_m * tcfg.n_heads + n_s * 2 * tcfg.d_model ** 2
    model = ttf.Transformer(tcfg, device="cpu")
    model.load_state_dict(sd)                      # strict: no key left over
    kinds = [type(b).__name__ for b in model.blocks()]
    assert kinds == {"reduced": ["MLSTMLayer", "SLSTMLayer"],
                     "rem": ["MLSTMLayer", "SLSTMLayer", "MLSTMLayer"],
                     "mlstm": ["MLSTMLayer", "MLSTMLayer"]}[variant]
    drawn = ttf.init_params(tcfg, seed=3, device="cpu")
    assert {k_: v.shape for k_, v in drawn.state_dict().items()} == \
        {k_: v.shape for k_, v in sd.items()}
    m = next(b for b in drawn.blocks() if hasattr(b, "mlstm")).mlstm
    assert m.w_i.dtype == m.f_bias.dtype == torch.float32
    assert torch.all(m.f_bias == 3.0) and torch.all(m.norm_scale == 1.0)
    assert float(m.w_q.detach().std()) * (2 * tcfg.d_model) ** 0.5 == \
        pytest.approx(0.987, abs=0.03)
    bf16 = ttf.Transformer(dataclasses.replace(tcfg, dtype="bfloat16"),
                           device="cpu")
    mb = next(b for b in bf16.blocks() if hasattr(b, "mlstm")).mlstm
    assert mb.w_f.dtype == torch.float32 and mb.w_q.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="xLSTM"):
        ttf.params_from_jax({**tree, "dense_layers": []})
