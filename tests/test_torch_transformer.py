"""Port parity for the LM slices, dense, hybrid (Zamba2) and MoE
(DeepSeek-V2 with MLA, Kimi-K2 with GQA): configs, weights carried across,
prefill logits (the kernels' plain versions and plain PyTorch), the MoE
aux loss and the cached decode chain, against the JAX reference on the
same numpy weights; and the serving launcher on the CPU."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import lm_params, set_torch_cpu  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
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
# the MoE family's reduced members (f32, first_dense 1 and one MoE layer,
# E 4, top-2, dropless), each at capacity_factor 1.0 (assignments drop),
# and DeepSeek-V2's with q_lora_rank 0 (MLA's wq path)
MOE_VARIANTS = ["deepseek-reduced", "deepseek-drop", "deepseek-wq",
                "kimi-reduced", "kimi-drop"]
ARCHS = {"zamba2": "zamba2-7b", "yi": "yi-6b", "deepseek": "deepseek-v2-236b",
         "kimi": "kimi-k2-1t-a32b"}


def _configs(variant):
    """(reference cfg, port cfg): Yi's reduced member (H = KV = 4, MHA), a
    narrow GQA variant of it (H 8, KV 2, hd 32), Zamba2's reduced member,
    or that with a remainder group (n_layers 5, attn_every 2); DeepSeek-V2's
    or Kimi-K2's reduced member, dropping at capacity_factor 1.0, or
    DeepSeek-V2's with q_lora_rank 0."""
    arch = ARCHS[variant.split("-")[0]]
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    kw = {"yi-gqa": dict(n_heads=8, n_kv_heads=2, head_dim=32),
          "zamba2-rem": dict(n_layers=5, attn_every=2),
          "deepseek-drop": dict(capacity_factor=1.0),
          "kimi-drop": dict(capacity_factor=1.0),
          "deepseek-wq": dict(q_lora_rank=0)}.get(variant)
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
                                  "minicpm-2b", "zamba2-7b",
                                  "deepseek-v2-236b", "kimi-k2-1t-a32b",
                                  "qwen2-vl-2b", "musicgen-large",
                                  "xlstm-125m"])
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
    assert dataclasses.asdict(get_config("paper-unet")) == \
        dataclasses.asdict(jget_config("paper-unet"))
    assert get_config("yi-6b").param_count() == 6_061_035_520


def test_registry_is_the_references_and_unknown_families_raise():
    """Every architecture of the reference, in its order; an unknown arch
    raises ``KeyError``, and an unknown family or attention type
    ``ValueError`` from the model and its cache."""
    for unet in (False, True):          # the reference's order and flag
        assert list_archs(include_unet=unet) == \
            jlist_archs(include_unet=unet)
    assert len(list_archs()) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-7b")
    base = get_config("yi-6b").reduced()
    for kw in (dict(family="rnn"), dict(attn_type="linear")):
        cfg = dataclasses.replace(base, **kw)
        with pytest.raises(ValueError, match="rnn|linear"):
            ttf.Transformer(cfg, device="cpu")
        with pytest.raises(ValueError, match="rnn|linear"):
            ttf.init_cache(cfg, 1, 4, device="cpu")
    for arch in ("qwen2-vl-2b", "musicgen-large", "xlstm-125m"):
        cfg = get_config(arch).reduced()
        assert isinstance(ttf.Transformer(cfg, device="cpu"), ttf.Transformer)


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


@pytest.mark.parametrize("variant", ["deepseek-reduced", "deepseek-wq",
                                     "kimi-reduced"])
def test_params_from_jax_maps_every_moe_leaf_once(variant):
    """The MoE tree: ``dense_layers`` a list (not stacked), ``layers``
    stacked on axis 0, the router float32; MLA's leaves (w_dq/w_uq or wq)
    or GQA's by name."""
    jcfg, tcfg = _configs(variant)
    tree = lm_params(jcfg, 0)
    assert isinstance(tree["dense_layers"], list)
    sd = ttf.params_from_jax(tree)
    n_leaves = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in sd.values()) == n_leaves \
        == tcfg.param_count()
    model = ttf.Transformer(tcfg, device="cpu")
    model.load_state_dict(sd)                      # strict: no key left over
    assert (len(model.dense_layers), len(model.layers)) == \
        (tcfg.first_dense, tcfg.n_layers - tcfg.first_dense)
    assert [type(b).__name__ for b in model.blocks()] == \
        ["DenseLayer"] * tcfg.first_dense + \
        ["MoELayer"] * (tcfg.n_layers - tcfg.first_dense)
    attn_type = type(model.dense_layers[0].attn).__name__
    assert attn_type == ("MLAttention" if tcfg.attn_type == "mla"
                         else "GQAttention")
    drawn = ttf.init_params(tcfg, seed=3, device="cpu")
    assert {k: v.shape for k, v in drawn.state_dict().items()} == \
        {k: v.shape for k, v in sd.items()}
    moe = drawn.layers[0].moe
    assert moe.router.dtype == torch.float32
    assert float(moe.w_down.detach().std()) * tcfg.d_ff_expert ** 0.5 == \
        pytest.approx(0.987, abs=0.03)
    bf16 = ttf.Transformer(dataclasses.replace(tcfg, dtype="bfloat16"),
                           device="cpu")
    assert bf16.layers[0].moe.router.dtype == torch.float32
    assert bf16.layers[0].moe.w_gate.dtype == torch.bfloat16
    with pytest.raises(ValueError, match=r"dense or hybrid \(or MoE\)"):
        ttf.params_from_jax({**tree, "groups": tree["layers"]})


@pytest.mark.parametrize("variant", MOE_VARIANTS)
@pytest.mark.parametrize("kernel", ["flash", "torch"])
def test_moe_prefill_and_aux_match_reference(variant, kernel):
    """Logits through both kernels (Kimi's GQA through the flash kernel's
    plain version or blockwise PyTorch; MLA blockwise either way), and the
    summed aux loss against the reference's ``moe_aux``."""
    jcfg, tcfg, jparams, model, toks = _models(variant)
    jkernel = {"flash": "pallas", "torch": "jnp"}[kernel]
    ref, jaux = jtf.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                            kernel=jkernel)
    before = ops.launch_counts()
    out = make_prefill_step(tcfg, kernel=kernel)(
        model, {"tokens": torch.from_numpy(toks).long()})
    with torch.inference_mode():
        logits, aux = ttf.forward_with_aux(
            model, {"tokens": torch.from_numpy(toks).long()}, tcfg,
            kernel=kernel)
    assert ops.launch_counts() == before           # plain versions on the CPU
    assert out.shape == (B, S, tcfg.vocab_size)
    assert torch.equal(out, logits)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-4)
    assert set(aux) == {"moe_aux"} and aux["moe_aux"].dtype == torch.float32
    np.testing.assert_allclose(float(aux["moe_aux"]),
                               float(jaux["moe_aux"]), rtol=1e-5)


def test_dense_families_report_a_zero_aux():
    _, tcfg, _, model, toks = _models("yi-reduced")
    with torch.inference_mode():
        _, aux = ttf.forward_with_aux(
            model, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert float(aux["moe_aux"]) == 0.0


def test_run_config_sets_the_capacity_factor_for_a_call():
    """A config that differs only in the capacity factor runs the MoE
    layers at it (here dropless against dropping) and is restored; one that
    describes other weights raises."""
    _, tcfg, _, model, toks = _models("kimi-drop")
    batch = {"tokens": torch.from_numpy(toks).long()}
    dropless = dataclasses.replace(tcfg, capacity_factor=4.0)
    with torch.inference_mode():
        drop = ttf.forward(model, batch, tcfg)
        free = ttf.forward(model, batch, dropless)
        again = ttf.forward(model, batch, tcfg)
    assert model.layers[0].cfg is tcfg and torch.equal(drop, again)
    assert not torch.equal(drop, free)
    with pytest.raises(ValueError, match="beyond"):
        ttf.forward(model, batch, dataclasses.replace(tcfg, top_k=1))


@pytest.mark.parametrize("variant,window", [("deepseek-reduced", 0),
                                            ("deepseek-reduced", 8),
                                            ("deepseek-wq", 0),
                                            ("deepseek-drop", 0),
                                            ("kimi-reduced", 0),
                                            ("kimi-reduced", 8),
                                            ("kimi-drop", 0)])
def test_moe_decode_chain_matches_reference_and_forward(variant, window):
    """Teacher-forced decode over S positions (MLA's absorbed decode on the
    compressed cache, or GQA's): against the reference's chain; and,
    dropless, against the port's own forward.  At capacity_factor 1.0 a
    step's B = 2 tokens get one slot an expert, so decode drops other
    assignments than the forward, as in the reference."""
    jcfg, tcfg, jparams, model, toks = _models(variant)
    jcache = jtf.init_cache(jcfg, B, S, window=window)
    tcache = ttf.init_cache(tcfg, B, S, window=window, device="cpu")
    assert set(tcache) == {"dense_layers", "layers"}
    assert len(tcache["dense_layers"]) == tcfg.first_dense
    keys = {"c_kv", "k_rope"} if tcfg.attn_type == "mla" else {"k", "v"}
    for c in tcache["dense_layers"] + tcache["layers"]:
        assert set(c) == keys and next(iter(c.values())).shape[1] == \
            (window or S)
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
    if tcfg.capacity_factor >= tcfg.n_experts:          # dropless
        np.testing.assert_allclose(dec, fwd.numpy(), rtol=0, atol=2e-4)
    else:
        assert np.abs(dec - fwd.numpy()).max() > 1e-2


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_serve_launcher_on_cpu_moe(arch, capsys):
    stats = tserve.main(["--device", "cpu", "--arch", arch, "--requests",
                         "1", "--batch", "2", "--prompt-len", "5",
                         "--tokens", "3"])
    out = capsys.readouterr().out
    assert "serving loop OK" in out and f"{arch} (reduced" in out
    assert len(stats) == 1 and stats[0]["tok_s"] > 0


def test_serve_launcher_refuses_weights_that_do_not_fit():
    """Kimi-K2 at full size holds ~1.03e12 parameters, ~2.07e12 bytes in
    bf16: the launcher raises before it allocates anything."""
    cfg = get_config("kimi-k2-1t-a32b")
    need = cfg.param_count() * 2
    assert need > tserve.CPU_WEIGHT_BYTES
    with pytest.raises(ValueError,
                       match=f"{need} bytes.*shard them over more cards"):
        tserve.main(["--device", "cpu", "--arch", "kimi-k2-1t-a32b",
                     "--no-reduced"])
    assert tserve.check_weights_fit(cfg.reduced(), torch.device("cpu")) == \
        cfg.reduced().param_count() * 4


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


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large",
                                  "xlstm-125m"])
def test_serve_launcher_on_cpu_vlm_audio_xlstm(arch, capsys):
    """Tokens only, the decode chain filling the cache (an audio model's
    cross_kv left as init_cache makes it, as in the reference)."""
    stats = tserve.main(["--device", "cpu", "--arch", arch, "--requests",
                         "2", "--batch", "2", "--prompt-len", "6",
                         "--tokens", "3"])
    out = capsys.readouterr().out
    assert "serving loop OK" in out and f"{arch} (reduced" in out
    assert len(stats) == 2 and all(s["tok_s"] > 0 for s in stats)


def test_serve_launcher_reduced_flag():
    assert tserve._parse_args([]).reduced is True
    assert tserve._parse_args(["--no-reduced"]).reduced is False
