"""Port parity for the MoE layer (``repro_torch.models.moe``) against the
reference's single-device path (``repro/models/moe.py``) on the same numpy
weights: the router's probabilities, indices and aux loss, the capacity,
the dispatch slots and keep masks (integers, so bitwise), and
``moe_forward`` with and without shared experts, dropless and dropping.
The configs are the reference's reduced DeepSeek-V2 and Kimi-K2 (f32, E 4,
top-2, dropless) and variants of them."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import moe_params, set_torch_cpu  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import ShardCtx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

set_torch_cpu()

ATOL = 1e-5
# (arch, overrides): dropless reduced members (Kimi one shared expert,
# DeepSeek two), a member without shared experts, and members at
# capacity_factor 1.0 where assignments drop
VARIANTS = {
    "kimi": ("kimi-k2-1t-a32b", {}),
    "deepseek": ("deepseek-v2-236b", {}),
    "no-shared": ("kimi-k2-1t-a32b", dict(n_shared_experts=0)),
    "kimi-drop": ("kimi-k2-1t-a32b", dict(capacity_factor=1.0)),
    "deepseek-drop": ("deepseek-v2-236b", dict(capacity_factor=1.0)),
}


def _configs(variant):
    arch, kw = VARIANTS[variant]
    return (dataclasses.replace(jget_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _moe(variant, seed=0):
    jcfg, tcfg = _configs(variant)
    tree = moe_params(jcfg, seed)
    mod = tmoe.MoE(tcfg, device="cpu")
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            flat[k] = v
    mod.load_state_dict({k: torch.from_numpy(np.asarray(v))
                         for k, v in flat.items()})
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), mod


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


@pytest.mark.parametrize("variant", ["kimi", "deepseek"])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_router_topk_matches_reference(variant, n):
    jcfg, tcfg, jp, mod = _moe(variant)
    x = _x(1, n, tcfg.d_model)[0]
    jp_, ji, jaux = jmoe.router_topk(jnp.asarray(x), jp["router"], jcfg.top_k)
    with torch.inference_mode():
        tp, ti, taux = tmoe.router_topk(torch.from_numpy(x), mod.router,
                                        tcfg.top_k)
    assert ti.dtype == torch.int32 and tp.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp_), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert np.allclose(tp.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("n,k,e,cf", [(1, 2, 4, 1.25), (4, 6, 160, 1.25),
                                      (8192, 6, 160, 1.25),
                                      (8192, 8, 384, 1.25), (64, 2, 4, 1.0),
                                      (64, 2, 4, 4.0), (3, 8, 384, 384.0),
                                      (5, 3, 7, 0.1)])
def test_capacity_matches_reference(n, k, e, cf):
    assert tmoe.capacity(n, k, e, cf) == jmoe._capacity(n, k, e, cf)


@pytest.mark.parametrize("n,e,k,cap", [(64, 4, 2, 32), (64, 4, 2, 5),
                                       (33, 8, 3, 1), (200, 16, 4, 60)])
def test_dispatch_indices_match_reference_bitwise(n, e, k, cap):
    """Random routes (k distinct experts a token, skewed towards low
    experts so that some experts overflow): slots and keep masks equal."""
    rng = np.random.default_rng(n + e + k + cap)
    weights = np.exp(-0.3 * np.arange(e))
    top_i = np.stack([rng.choice(e, size=k, replace=False,
                                 p=weights / weights.sum())
                      for _ in range(n)]).astype(np.int32)
    jpos, jkeep = jmoe._dispatch_indices(jnp.asarray(top_i), e, cap)
    tpos, tkeep = tmoe.dispatch_indices(torch.from_numpy(top_i), e, cap)
    assert tpos.dtype == torch.int32 and tkeep.dtype == torch.bool
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    counts = np.bincount(top_i.reshape(-1), minlength=e)
    assert int(tkeep.sum()) == int(np.minimum(counts, cap).sum())
    if cap < counts.max():
        assert not bool(tkeep.all())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_forward_matches_reference(variant):
    jcfg, tcfg, jp, mod = _moe(variant)
    x = _x(2, 32, tcfg.d_model)
    jout, jaux = jmoe.moe_forward(jnp.asarray(x), jp, jcfg, ShardCtx())
    with torch.inference_mode():
        tout, taux = tmoe.moe_forward(torch.from_numpy(x), mod, tcfg)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert (mod.shared is None) == (tcfg.n_shared_experts == 0)
    # the dropping variants do drop: 64 tokens, k 2, E 4, 32 slots
    with torch.inference_mode():
        _, top_i, _ = tmoe.router_topk(torch.from_numpy(x).reshape(64, -1),
                                       mod.router, tcfg.top_k)
    cap = tmoe.capacity(64, tcfg.top_k, tcfg.n_experts,
                        tcfg.capacity_factor)
    _, keep = tmoe.dispatch_indices(top_i, tcfg.n_experts, cap)
    assert bool(keep.all()) == (variant not in ("kimi-drop",
                                                "deepseek-drop"))


def test_dropped_assignments_contribute_exactly_zero():
    """At one slot an expert, a token whose assignments all drop gets
    exactly the shared experts' output; the buffer holds only kept rows."""
    _, tcfg, _, mod = _moe("kimi")
    x = torch.from_numpy(_x(1, 16, tcfg.d_model)[0])
    with torch.inference_mode():
        top_p, top_i, _ = tmoe.router_topk(x, mod.router, tcfg.top_k)
        pos, keep = tmoe.dispatch_indices(top_i, tcfg.n_experts, 1)
        buf = tmoe.scatter_dispatch(x, top_i, pos, keep, tcfg.n_experts, 1)
        out, _ = tmoe.moe_local(x, mod, tcfg, 1)
        shared = tmoe.shared_expert(x, mod.shared)
        full, _ = tmoe.moe_forward(x[None], mod, dataclasses.replace(
            tcfg, capacity_factor=1 / 32))          # ceil(16·2/32/4) = 1
    assert int(keep.sum()) == len(torch.unique(top_i[keep]))
    for e, p_, n, j in zip(top_i[keep], pos[keep], *torch.nonzero(
            keep, as_tuple=True)):
        assert torch.equal(buf[e, p_], x[n])
    assert int((buf.abs().sum(-1) > 0).sum()) == int(keep.sum())
    dropped = ~keep.any(dim=1)
    assert bool(dropped.any())
    assert torch.equal(out[dropped], torch.zeros_like(out[dropped]))
    assert torch.equal(full[0][dropped], (out + shared)[dropped])


def test_moe_module_draws_each_expert_at_its_fan_in():
    _, tcfg, _, _ = _moe("deepseek")
    mod = tmoe.MoE(tcfg, device="cpu")
    mod.reset_parameters(torch.Generator().manual_seed(0))
    d, f = tcfg.d_model, tcfg.d_ff_expert
    assert mod.router.dtype == torch.float32
    for w, fan in ((mod.router, d), (mod.w_gate, d), (mod.w_up, d),
                   (mod.w_down, f)):
        assert float(w.detach().abs().max()) <= 3 * fan ** -0.5 + 1e-7
        if w.numel() > 10_000:            # the router's 1024 are too few
            assert float(w.detach().std()) * fan ** 0.5 == \
                pytest.approx(0.987, abs=0.03)
    assert mod.shared.w_gate.shape == (d, tcfg.n_shared_experts * f)
    n = sum(p.numel() for p in mod.parameters())
    assert n == tcfg._moe_params()
