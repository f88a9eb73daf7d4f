"""Port parity for DeepSeek-V2's MLA (``repro_torch.models.attention``)
against the reference's ``mla_forward`` and ``mla_decode`` on the same
numpy weights, for both query paths (``w_dq``/``w_uq`` at q_lora_rank > 0,
``wq`` at 0): the prefill, and the absorbed-weight decode chain against the
reference's chain and against the port's own (expanded) prefill, with the
whole sequence cached and with a ring buffer of 8 slots under a window of
8.  The config is the reference's reduced DeepSeek-V2 (f32; H 4, r 64, qr
64, nope 64, rope 32, v 64)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import mla_params, set_torch_cpu  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.layers import ShardCtx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

set_torch_cpu()

B, S = 2, 24
ATOL = 1e-5
Q_PATHS = {"q_lora": {}, "wq": dict(q_lora_rank=0)}


def _mla(q_path, seed=0):
    kw = Q_PATHS[q_path]
    arch = "deepseek-v2-236b"
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    tree = mla_params(jcfg, seed)
    mod = tattn.MLAttention(tcfg, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.asarray(v))
                         for k, v in tree.items()})
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), mod, x


@pytest.mark.parametrize("q_path", list(Q_PATHS))
def test_mla_module_layouts(q_path):
    jcfg, tcfg, jp, mod, _ = _mla(q_path)
    names = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
    assert names == {k: tuple(v.shape) for k, v in jp.items()}
    assert ("wq" in names) == (tcfg.q_lora_rank == 0)
    assert sum(v.numel() for v in mod.parameters()) == tcfg._attn_params()
    drawn = tattn.make_attention(tcfg, device="cpu")
    assert isinstance(drawn, tattn.MLAttention)
    drawn.reset_parameters(torch.Generator().manual_seed(0))
    w = drawn.w_uk.detach()                          # fan-in r
    assert float(w.abs().max()) <= 3 * tcfg.kv_lora_rank ** -0.5 + 1e-7
    assert float(w.std()) * tcfg.kv_lora_rank ** 0.5 == \
        pytest.approx(0.987, abs=0.03)


@pytest.mark.parametrize("q_path", list(Q_PATHS))
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("kernel", ["flash", "torch"])
def test_mla_forward_matches_reference(q_path, window, kernel):
    """``kernel`` is ignored, as in the reference: MLA runs blockwise
    attention either way and launches no kernel."""
    jcfg, tcfg, jp, mod, x = _mla(q_path)
    ref = jattn.mla_forward(jnp.asarray(x), jp, jcfg, ShardCtx(),
                            window=window)
    before = ops.launch_counts()
    with torch.inference_mode():
        out = tattn.mla_forward(torch.from_numpy(x), mod, tcfg,
                                window=window, kernel=kernel)
    assert ops.launch_counts() == before
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_mla_forward_rejects_an_unknown_kernel():
    _, tcfg, _, mod, x = _mla("q_lora")
    with pytest.raises(ValueError, match="kernel"):
        tattn.mla_forward(torch.from_numpy(x), mod, tcfg, kernel="pallas")


@pytest.mark.parametrize("q_path", list(Q_PATHS))
@pytest.mark.parametrize("window", [0, 8])
def test_mla_decode_chain_matches_reference_and_forward(q_path, window):
    """Absorbed decode over S positions, the cache written in place:
    against the reference's chain, and against the port's expanded forward
    (the ring buffer of ``window`` slots against the windowed forward)."""
    jcfg, tcfg, jp, mod, x = _mla(q_path)
    t = window or S
    jcache = jattn.mla_init_cache(jcfg, B, t, jnp.float32)
    tcache = tattn.attention_init_cache(tcfg, B, t, torch.float32, "cpu")
    assert set(tcache) == {"c_kv", "k_rope"}
    assert tcache["c_kv"].shape == (B, t, tcfg.kv_lora_rank)
    assert tcache["k_rope"].shape == (B, t, tcfg.qk_rope_dim)
    jdec = jax.jit(lambda c, xx, pos: jattn.mla_decode(
        xx, jp, c, pos, jcfg, ShardCtx(), window=window))
    touts, jouts = [], []
    with torch.inference_mode():
        for pos in range(S):
            jo, jcache = jdec(jcache, jnp.asarray(x[:, pos:pos + 1]),
                              jnp.int32(pos))
            to, same = tattn.attention_decode(
                torch.from_numpy(x[:, pos:pos + 1]), mod, tcache, pos, tcfg,
                window=window)
            assert same is tcache
            jouts.append(np.asarray(jo))
            touts.append(to.numpy())
        fwd = tattn.mla_forward(torch.from_numpy(x), mod, tcfg,
                                window=window).numpy()
    dec = np.concatenate(touts, axis=1)
    np.testing.assert_allclose(dec, np.concatenate(jouts, axis=1), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(dec, fwd, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tcache["c_kv"].numpy(),
                               np.asarray(jcache["c_kv"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tcache["k_rope"].numpy(),
                               np.asarray(jcache["k_rope"]), rtol=0,
                               atol=ATOL)
