"""Port parity for the LM slices, dense and hybrid (Zamba2): configs,
weights carried across, prefill logits (the kernels' plain versions and
plain PyTorch) and the cached decode chain, against the JAX reference on
the same numpy weights; and the serving launcher on the CPU."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import lm_params, set_torch_cpu  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.specs import serve_window as jserve_window  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.specs import serve_window  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

set_torch_cpu()

B, S = 2, 32
VARIANTS = ["yi-reduced", "yi-gqa"]
# Zamba2's reduced member (2 groups of 1 Mamba2 layer, no remainder) and a
# variant with a remainder (5 layers, attn_every 2: the shared block runs 3
# times); S spans 4 of their 16-step ssm chunks
HYBRID_VARIANTS = ["zamba2-reduced", "zamba2-rem"]
S_HYBRID = 64


def _configs(variant):
    """(reference cfg, port cfg): Yi's reduced member (H = KV = 4, MHA), a
    narrow GQA variant of it (H 8, KV 2, hd 32), Zamba2's reduced member,
    or that with a remainder group (n_layers 5, attn_every 2)."""
    arch = "zamba2-7b" if variant.startswith("zamba2") else "yi-6b"
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    kw = {"yi-gqa": dict(n_heads=8, n_kv_heads=2, head_dim=32),
          "zamba2-rem": dict(n_layers=5, attn_every=2)}.get(variant)
    if kw:
        jcfg = dataclasses.replace(jcfg, **kw)
        tcfg = dataclasses.replace(tcfg, **kw)
    return jcfg, tcfg


def _models(variant, seed=0):
    jcfg, tcfg = _configs(variant)
    tree = lm_params(jcfg, seed)
    model = ttf.Transformer(tcfg, device="cpu").eval()
    model.load_state_dict(ttf.params_from_jax(tree))
    jparams = jax.tree.map(jnp.asarray, tree)
    s = S_HYBRID if variant in HYBRID_VARIANTS else S
    toks = np.random.default_rng(seed + 1).integers(
        0, tcfg.vocab_size, (B, s)).astype(np.int32)
    return jcfg, tcfg, jparams, model, toks


@pytest.mark.parametrize("arch", ["yi-6b", "granite-3-8b", "glm4-9b",
                                  "minicpm-2b", "zamba2-7b"])
def test_configs_match_reference(arch):
    c = get_config(arch)
    assert dataclasses.asdict(c) == dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(c.reduced()) == \
        dataclasses.asdict(jget_config(arch).reduced())
    assert c.param_count() == jget_config(arch).param_count()
    for s, kv, w in ((2048, None, None), (1, 4096, None), (1, 32768, 8192)):
        assert c.flops_per_token_fwd(s, kv, w) == \
            jget_config(arch).flops_per_token_fwd(s, kv, w)
    for shape in INPUT_SHAPES.values():
        assert serve_window(c, shape) == jserve_window(jget_config(arch),
                                                       shape)
    assert sorted(list_archs()) == sorted(
        ["yi-6b", "granite-3-8b", "glm4-9b", "minicpm-2b", "zamba2-7b"])
    assert get_config("yi-6b").param_count() == 6_061_035_520


def test_other_families_raise_with_their_roadmap_item():
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("xlstm-125m")
    cfg = dataclasses.replace(get_config("yi-6b").reduced(), family="moe",
                              n_experts=4, top_k=2, d_ff_expert=64)
    with pytest.raises(ValueError, match="ROADMAP"):
        ttf.Transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP"):
        ttf.init_cache(dataclasses.replace(cfg, attn_type="mla"), 1, 4,
                       device="cpu")


@pytest.mark.parametrize("arch", ["yi-6b", "minicpm-2b"])
def test_params_from_jax_maps_every_leaf_once(arch):
    """Reduced members: Yi (separate head) and MiniCPM (tied embedding)."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
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
    assert sum(p.numel() for p in drawn.parameters()) == tcfg.param_count()
    w = drawn.layers[0].attn.wq.detach()      # fan-in truncated normal
    assert w.dtype == torch.float32 and float(w.abs().max()) <= \
        3 * tcfg.d_model ** -0.5 + 1e-7
    assert abs(float(w.std()) * tcfg.d_model ** 0.5 - 0.987) < 0.03
    again = ttf.init_params(tcfg, seed=3, device="cpu")
    assert torch.equal(again.embed.embedding, drawn.embed.embedding)


@pytest.mark.parametrize("variant", HYBRID_VARIANTS)
def test_params_from_jax_maps_every_hybrid_leaf_once(variant):
    """The hybrid tree: shared block, groups stacked (g, attn_every, ...),
    the remainder (rem, ...) or None.  The reference's ``param_count``
    counts the shared block's norm twice (``+ 2 * d``; the tree holds one
    norm), so the tree is ``param_count() - d_model``, as in the reference
    (Zamba2-7B: 6,596,990,160 against 6,596,986,576 leaves)."""
    jcfg, tcfg = _configs(variant)
    tree = lm_params(jcfg, 0)
    sd = ttf.params_from_jax(tree)
    n_leaves = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in sd.values()) == n_leaves \
        == tcfg.param_count() - tcfg.d_model
    model = ttf.Transformer(tcfg, device="cpu")
    model.load_state_dict(sd)                      # strict: no key left over
    g, k, rem = ttf.hybrid_layout(tcfg)
    assert (len(model.groups), len(model.groups[0]), len(model.rem)) == \
        (g, k, rem) == {"zamba2-reduced": (2, 1, 0),
                        "zamba2-rem": (2, 2, 1)}[variant]
    drawn = ttf.init_params(tcfg, seed=3, device="cpu")
    assert {k_: v.shape for k_, v in drawn.state_dict().items()} == \
        {k_: v.shape for k_, v in sd.items()}
    m = drawn.groups[0][0].ssm
    assert m.A_log.dtype == m.D.dtype == m.dt_bias.dtype == torch.float32
    assert torch.all(m.D == 1) and not torch.any(m.A_log)
    assert float(m.w_x.detach().std()) * tcfg.d_model ** 0.5 == \
        pytest.approx(0.987, abs=0.03)
    with pytest.raises(ValueError, match="dense or hybrid"):
        ttf.params_from_jax({**tree, "layers": tree["groups"]})


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kernel", ["flash", "torch"])
def test_prefill_matches_reference(variant, kernel):
    jcfg, tcfg, jparams, model, toks = _models(variant)
    jkernel = {"flash": "pallas", "torch": "jnp"}[kernel]
    ref = jtf.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                      kernel=jkernel)
    before = ops.launch_counts()
    out = make_prefill_step(tcfg, kernel=kernel)(
        model, {"tokens": torch.from_numpy(toks).long()})
    assert ops.launch_counts() == before           # plain version on the CPU
    assert out.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("variant,window", [("yi-reduced", 0),
                                            ("yi-gqa", 0), ("yi-gqa", 8)])
def test_decode_chain_matches_reference_and_forward(variant, window):
    """Teacher-forced decode over S positions: against the reference's
    chain, and against the port's own forward (ring-buffer cache of
    ``window`` slots against the windowed forward)."""
    jcfg, tcfg, jparams, model, toks = _models(variant)
    jcache = jtf.init_cache(jcfg, B, S, window=window)
    tcache = ttf.init_cache(tcfg, B, S, window=window, device="cpu")
    assert tcache["layers"][0]["k"].shape == \
        (B, window or S, tcfg.n_kv_heads, tcfg.head_dim)
    decode = make_decode_step(tcfg, window=window)
    jdec = jax.jit(lambda p, c, t, pos: jtf.decode_step(
        p, c, {"tokens": t}, pos, jcfg, window=window))
    touts, jouts = [], []
    for pos in range(S):
        jl, jcache = jdec(jparams, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.int32(pos))
        tl, tcache = decode(model, tcache,
                            {"tokens": torch.from_numpy(
                                toks[:, pos:pos + 1]).long()}, pos)
        jouts.append(np.asarray(jl[:, 0]))
        touts.append(tl[:, 0].numpy())
    dec = np.stack(touts, axis=1)
    np.testing.assert_allclose(dec, np.stack(jouts, axis=1), rtol=0,
                               atol=2e-4)
    fwd = make_prefill_step(tcfg, window=window)(
        model, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(dec, fwd.numpy(), rtol=0, atol=2e-4)


@pytest.mark.parametrize("variant", HYBRID_VARIANTS)
@pytest.mark.parametrize("kernel", ["flash", "torch"])
def test_hybrid_prefill_matches_reference(variant, kernel):
    """Both kernels: the shared block's attention (the flash kernel's plain
    version, or blockwise PyTorch) and the Mamba2 mixing (``ssm_scan``'s
    plain version, or the chunk loop), against the reference's forward
    (Pallas attention, or its jnp attention; its inline chunk loop)."""
    jcfg, tcfg, jparams, model, toks = _models(variant)
    jkernel = {"flash": "pallas", "torch": "jnp"}[kernel]
    ref = jtf.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                      kernel=jkernel)
    before = ops.launch_counts()
    out = make_prefill_step(tcfg, kernel=kernel)(
        model, {"tokens": torch.from_numpy(toks).long()})
    assert ops.launch_counts() == before           # plain versions on the CPU
    assert out.shape == (B, S_HYBRID, tcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("variant,window", [("zamba2-reduced", 0),
                                            ("zamba2-rem", 0),
                                            ("zamba2-rem", 8)])
def test_hybrid_decode_chain_matches_reference_and_forward(variant, window):
    """Teacher-forced decode over S positions through the hybrid cache (one
    KV cache per application of the shared block, one Mamba2 state and conv
    history a layer): against the reference's chain and the port's own
    forward."""
    jcfg, tcfg, jparams, model, toks = _models(variant)
    s = toks.shape[1]
    jcache = jtf.init_cache(jcfg, B, s, window=window)
    tcache = ttf.init_cache(tcfg, B, s, window=window, device="cpu")
    g, k, rem = ttf.hybrid_layout(tcfg)
    assert len(tcache["groups"]) == g and \
        (tcache["rem"] is None) == (rem == 0)
    grp = tcache["groups"][0]
    assert grp["attn_kv"]["k"].shape == \
        (B, window or s, tcfg.n_kv_heads, tcfg.head_dim)
    assert len(grp["ssm"]) == k and grp["ssm"][0]["state"].shape == \
        (B, tcfg.ssm_heads, tcfg.ssm_state, tcfg.ssm_head_dim)
    assert grp["ssm"][0]["state"].dtype == torch.float32
    decode = make_decode_step(tcfg, window=window)
    jdec = jax.jit(lambda p, c, t, pos: jtf.decode_step(
        p, c, {"tokens": t}, pos, jcfg, window=window))
    touts, jouts = [], []
    for pos in range(s):
        jl, jcache = jdec(jparams, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.int32(pos))
        tl, tcache = decode(model, tcache,
                            {"tokens": torch.from_numpy(
                                toks[:, pos:pos + 1]).long()}, pos)
        jouts.append(np.asarray(jl[:, 0]))
        touts.append(tl[:, 0].numpy())
    dec = np.stack(touts, axis=1)
    np.testing.assert_allclose(dec, np.stack(jouts, axis=1), rtol=0,
                               atol=2e-4)
    fwd = make_prefill_step(tcfg, window=window)(
        model, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(dec, fwd.numpy(), rtol=0, atol=2e-4)


def test_serve_launcher_on_cpu_hybrid(capsys):
    stats = tserve.main(["--device", "cpu", "--arch", "zamba2-7b",
                         "--requests", "2", "--batch", "2", "--prompt-len",
                         "6", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "serving loop OK" in out and "zamba2-7b (reduced" in out
    assert len(stats) == 2 and all(s["tok_s"] > 0 for s in stats)


def test_serve_launcher_on_cpu(capsys):
    stats = tserve.main(["--device", "cpu", "--arch", "yi-6b", "--requests",
                         "2", "--batch", "2", "--prompt-len", "6",
                         "--tokens", "3", "--window", "4"])
    out = capsys.readouterr().out
    assert "serving loop OK" in out and "reduced" in out
    assert len(stats) == 2 and all(s["tok_s"] > 0 for s in stats)


def test_serve_launcher_reduced_flag():
    assert tserve._parse_args([]).reduced is True
    assert tserve._parse_args(["--no-reduced"]).reduced is False
