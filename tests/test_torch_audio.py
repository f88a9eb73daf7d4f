"""Port parity for the audio family (MusicGen): ``cross_attention`` and
the decode's ``cross_decode`` against the reference's ``cross_attention``
and ``_cross_decode``, the model's prefill logits with ``cond_embeds``
through both attention kernels, and the cached decode chain with each
layer's ``cross_kv`` filled from the conditioning (the reference's
``tests/test_decode.py`` relation): against the reference's chain and the
port's own forward, on the same numpy weights.  The config is the
reference's reduced MusicGen (f32; d 256, MHA 4 of hd 64, 8 conditioning
tokens)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import cross_params, lm_params, set_torch_cpu  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import ShardCtx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

set_torch_cpu()

ARCH = "musicgen-large"
B, S = 2, 16
ATOL, LOGIT_ATOL = 1e-5, 2e-4


def _configs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


def _cond(tcfg, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, tcfg.n_cond_tokens, tcfg.d_model))).astype(np.float32)


def _cross(seed=0):
    jcfg, tcfg = _configs()
    tree = cross_params(jcfg, seed)
    mod = tattn.CrossAttention(tcfg, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.asarray(v))
                         for k, v in tree.items()})
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), mod


def test_cross_attention_matches_reference():
    jcfg, tcfg, jp, mod = _cross()
    x = np.random.default_rng(1).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    cond = _cond(tcfg, 2)
    ref = jattn.cross_attention(jnp.asarray(x), jnp.asarray(cond), jp, jcfg,
                                ShardCtx())
    with torch.inference_mode():
        out = tattn.cross_attention(torch.from_numpy(x),
                                    torch.from_numpy(cond), mod, tcfg)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    assert {k: tuple(v.shape) for k, v in mod.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


def test_cross_decode_matches_reference_and_cross_attention():
    """``cross_decode`` on K/V precomputed from the conditioning: against
    the reference's ``_cross_decode`` on the same K/V, and against
    ``cross_attention`` on the conditioning itself, token by token."""
    jcfg, tcfg, jp, mod = _cross()
    x = np.random.default_rng(3).standard_normal(
        (B, 1, tcfg.d_model)).astype(np.float32)
    cond = torch.from_numpy(_cond(tcfg, 4))
    with torch.inference_mode():
        kv = {"k": mod.project(cond, mod.wk), "v": mod.project(cond, mod.wv)}
        out = ttf.cross_decode(torch.from_numpy(x), mod, kv, tcfg)
        full = tattn.cross_attention(torch.from_numpy(x), cond, mod, tcfg)
    ref = jtf._cross_decode(jnp.asarray(x), jp,
                            {k: jnp.asarray(v.numpy()) for k, v in kv.items()},
                            jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(out.numpy(), full.numpy(), rtol=0, atol=ATOL)


def _models(seed=0):
    jcfg, tcfg = _configs()
    tree = lm_params(jcfg, seed)
    model = ttf.Transformer(tcfg, device="cpu").eval()
    model.load_state_dict(ttf.params_from_jax(tree))
    toks = np.random.default_rng(seed + 1).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), model, toks, \
        _cond(tcfg, seed + 2)


@pytest.mark.parametrize("kernel", ["flash", "torch"])
def test_audio_prefill_matches_reference(kernel):
    jcfg, tcfg, jp, model, toks, cond = _models()
    jkernel = {"flash": "pallas", "torch": "jnp"}[kernel]
    ref = jtf.prefill(jp, {"tokens": jnp.asarray(toks),
                           "cond_embeds": jnp.asarray(cond)}, jcfg,
                      kernel=jkernel)
    before = ops.launch_counts()
    out = make_prefill_step(tcfg, kernel=kernel)(
        model, {"tokens": torch.from_numpy(toks).long(),
                "cond_embeds": torch.from_numpy(cond)})
    assert ops.launch_counts() == before           # plain version on the CPU
    assert out.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=LOGIT_ATOL)
    with pytest.raises(ValueError, match="needs cond_embeds"):
        make_prefill_step(tcfg)(model,
                                {"tokens": torch.from_numpy(toks).long()})


def test_audio_decode_chain_matches_reference_and_forward():
    """Each layer's cross_kv filled from the conditioning through that
    layer's wk and wv, in both caches; then teacher-forced decode over S
    positions against the reference's chain and the port's forward."""
    jcfg, tcfg, jp, model, toks, cond = _models()
    jcache = jtf.init_cache(jcfg, B, S)
    tcache = ttf.init_cache(tcfg, B, S, device="cpu")
    shape = (B, tcfg.n_cond_tokens, tcfg.n_heads, tcfg.head_dim)
    assert all(c["cross_kv"]["k"].shape == shape and
               not c["cross_kv"]["v"].any() for c in tcache["layers"])
    tcond = torch.from_numpy(cond)
    with torch.inference_mode():
        for layer, c in zip(model.layers, tcache["layers"]):
            c["cross_kv"]["k"].copy_(layer.cross.project(tcond,
                                                         layer.cross.wk))
            c["cross_kv"]["v"].copy_(layer.cross.project(tcond,
                                                         layer.cross.wv))
    lp = jp["layers"]["cross"]
    jcache["layers"]["cross_kv"] = {
        n: jnp.einsum("bcd,ldhk->lbchk", jnp.asarray(cond), lp[w])
        for n, w in (("k", "wk"), ("v", "wv"))}
    decode = make_decode_step(tcfg)
    jdec = jax.jit(lambda p, c, t, pos: jtf.decode_step(
        p, c, {"tokens": t}, pos, jcfg))
    touts, jouts = [], []
    for pos in range(S):
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
                                  {"tokens": torch.from_numpy(toks).long(),
                                   "cond_embeds": tcond})
    np.testing.assert_allclose(dec, fwd.numpy(), rtol=0, atol=LOGIT_ATOL)


def test_params_from_jax_maps_every_audio_leaf_once():
    jcfg, tcfg = _configs()
    tree = lm_params(jcfg, 0)
    sd = ttf.params_from_jax(tree)
    n_leaves = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in sd.values()) == n_leaves \
        == tcfg.param_count()
    assert {"layers.1.cross.wo", "layers.1.norm_c.scale"} <= set(sd)
    model = ttf.Transformer(tcfg, device="cpu")
    model.load_state_dict(sd)                      # strict: no key left over
    drawn = ttf.init_params(tcfg, seed=3, device="cpu")
    assert {k: v.shape for k, v in drawn.state_dict().items()} == \
        {k: v.shape for k, v in sd.items()}
    w = drawn.layers[0].cross.wo.detach()          # fan-in H·hd
    fan_in = tcfg.n_heads * tcfg.head_dim
    assert float(w.std()) * fan_in ** 0.5 == pytest.approx(0.987, abs=0.03)
