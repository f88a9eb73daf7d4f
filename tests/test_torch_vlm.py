"""Port parity for the vlm family (Qwen2-VL): M-RoPE
(``repro_torch.models.layers.apply_mrope``) against the reference's
``apply_mrope``, three equal streams against RoPE bitwise, the vision
prefix's positions (``vlm_assemble``), the model's prefill logits through
both attention kernels and its cached decode chain, against the JAX
reference on the same numpy weights.  The config is the reference's
reduced Qwen2-VL (f32; d 256, H 4, KV 2, hd 64, sections (8, 12, 12), 8
vision tokens on a 2x2 grid)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import lm_params, set_torch_cpu  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import ShardCtx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

set_torch_cpu()

ARCH = "qwen2-vl-2b"
B, S_TEXT = 2, 24
# f32 on both sides: the rotations differ by cos/sin implementations (an
# ulp of the angle's image); the models by summation order
ROPE_ATOL, LOGIT_ATOL = 1e-5, 2e-4


def _models(seed=0):
    jcfg, tcfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = lm_params(jcfg, seed)
    model = ttf.Transformer(tcfg, device="cpu").eval()
    model.load_state_dict(ttf.params_from_jax(tree))
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, tcfg.vocab_size, (B, S_TEXT)).astype(np.int32)
    vis = (0.5 * rng.standard_normal(
        (B, tcfg.n_vision_tokens, tcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), model, toks, vis


def _torch_batch(toks, vis=None):
    batch = {"tokens": torch.from_numpy(toks).long()}
    if vis is not None:
        batch["vision_embeds"] = torch.from_numpy(vis)
    return batch


@pytest.mark.parametrize("sections,hd", [((8, 12, 12), 64),
                                         ((16, 24, 24), 128),
                                         ((2, 3, 11), 32)])
def test_apply_mrope_matches_reference(sections, hd):
    """Random (3, B, S) ids (each stream its own), Qwen2-VL's sections at
    the reduced and the full head dim, and a lopsided split."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((B, 16, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 300, (3, B, 16)).astype(np.int32)
    ref = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              sections)
    out = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6, sections)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ROPE_ATOL)
    with pytest.raises(ValueError, match="sum to"):
        tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            (1, 2, 3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_equal_streams_are_rope_bitwise(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((B, 20, 4, 64), generator=g).to(getattr(torch, dtype))
    pos = torch.randint(0, 5000, (B, 20), generator=g)
    three = tlayers.apply_mrope(x, pos[None].expand(3, B, 20), 1e6,
                                (8, 12, 12))
    assert three.dtype == x.dtype
    assert torch.equal(three, tlayers.apply_rope(x, pos, 1e6))


def test_vlm_assemble_matches_reference():
    """The spliced input and the (3, B, S) positions: vision (0, i // 2,
    i % 2) on the 2x2 grid, then text from 2 (not 8) on all streams."""
    jcfg, tcfg, jp, model, toks, vis = _models()
    jx, jpos = jtf._vlm_assemble({"tokens": jnp.asarray(toks),
                                  "vision_embeds": jnp.asarray(vis)}, jp,
                                 jcfg, ShardCtx())
    tx, tpos = ttf.vlm_assemble(torch.from_numpy(toks).long(),
                                torch.from_numpy(vis), model.embed, tcfg)
    assert tpos.dtype == torch.int32 and tpos.shape == (3, B, 8 + S_TEXT)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tx.detach().numpy(), np.asarray(jx))
    assert tpos[:, 0, :8].tolist() == [[0] * 8, [0, 0, 1, 1, 2, 2, 3, 3],
                                      [0, 1] * 4]
    assert tpos[:, 0, 8].tolist() == [2, 2, 2]
    with pytest.raises(ValueError, match="vision_embeds of 8 tokens"):
        ttf.vlm_assemble(torch.from_numpy(toks).long(), None, model.embed,
                         tcfg)


@pytest.mark.parametrize("kernel", ["flash", "torch"])
def test_vlm_prefill_matches_reference(kernel):
    """The vision prefix and the text through both attention paths (the
    flash kernel's plain version on the CPU, or blockwise PyTorch) against
    the reference's forward (its Pallas kernel in interpret mode, or jnp)."""
    jcfg, tcfg, jp, model, toks, vis = _models()
    jkernel = {"flash": "pallas", "torch": "jnp"}[kernel]
    ref = jtf.prefill(jp, {"tokens": jnp.asarray(toks),
                           "vision_embeds": jnp.asarray(vis)}, jcfg,
                      kernel=jkernel)
    before = ops.launch_counts()
    out = make_prefill_step(tcfg, kernel=kernel)(model, _torch_batch(toks,
                                                                      vis))
    assert ops.launch_counts() == before           # plain version on the CPU
    assert out.shape == (B, tcfg.n_vision_tokens + S_TEXT, tcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=LOGIT_ATOL)


def test_vlm_decode_chain_matches_reference_and_forward():
    """Teacher-forced decode of the text alone over S positions (position
    ``pos`` on all three streams): against the reference's chain, and
    against the port's forward of the same weights under family "dense"
    with the same sections (plain ids broadcast to three streams)."""
    jcfg, tcfg, jp, model, toks, _ = _models()
    jcache = jtf.init_cache(jcfg, B, S_TEXT)
    tcache = ttf.init_cache(tcfg, B, S_TEXT, device="cpu")
    decode = make_decode_step(tcfg)
    jdec = jax.jit(lambda p, c, t, pos: jtf.decode_step(
        p, c, {"tokens": t}, pos, jcfg))
    touts, jouts = [], []
    for pos in range(S_TEXT):
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.int32(pos))
        tl, tcache = decode(model, tcache,
                            _torch_batch(toks[:, pos:pos + 1]), pos)
        jouts.append(np.asarray(jl[:, 0]))
        touts.append(tl[:, 0].numpy())
    dec = np.stack(touts, axis=1)
    np.testing.assert_allclose(dec, np.stack(jouts, axis=1), rtol=0,
                               atol=LOGIT_ATOL)
    dense_cfg = dataclasses.replace(tcfg, family="dense")
    dense = ttf.Transformer(dense_cfg, device="cpu").eval()
    dense.load_state_dict(model.state_dict())
    fwd = make_prefill_step(dense_cfg)(dense, _torch_batch(toks))
    np.testing.assert_allclose(dec, fwd.numpy(), rtol=0, atol=LOGIT_ATOL)


def test_params_from_jax_maps_every_vlm_leaf_once():
    jcfg, tcfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = lm_params(jcfg, 0)
    sd = ttf.params_from_jax(tree)
    n_leaves = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in sd.values()) == n_leaves \
        == tcfg.param_count()
    model = ttf.Transformer(tcfg, device="cpu")
    model.load_state_dict(sd)                      # strict: no key left over
    drawn = ttf.init_params(tcfg, seed=3, device="cpu")
    assert {k: v.shape for k, v in drawn.state_dict().items()} == \
        {k: v.shape for k, v in sd.items()}
    assert model.layers[0].cross is None
    full = get_config(ARCH)
    assert full.mrope_sections == (16, 24, 24) and \
        tcfg.mrope_sections == (8, 12, 12)
