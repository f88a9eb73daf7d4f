"""Port parity for LM training: ``lm_loss`` and its gradients against
``jax.value_and_grad`` of the reference's ``lm_loss`` for each family at
``reduced()`` on the same numpy weights, the in-place ``apply_updates_``
against the reference's and the port's functional ``apply_updates``, the
train step lowering the loss for every arch, ``remat`` bitwise the plain
step, and the kernel wrappers refusing to run under autograd off the CPU."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import lm_params, set_torch_cpu  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import softmax_cross_entropy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import schedule as tschedule  # noqa: E402

set_torch_cpu()

B, S = 2, 32
# one arch of each family; MiniCPM-2B for the tied embedding, DeepSeek-V2
# for the MoE family with MLA
FAMILIES = ["yi-6b", "minicpm-2b", "qwen2-vl-2b", "musicgen-large",
            "deepseek-v2-236b", "zamba2-7b", "xlstm-125m"]
# the loss within 1e-5 relative; each gradient leaf within 1e-4 of its own
# max |g|.  Measured worst over FAMILIES (CPU, float32): the loss 7.1e-8
# relative (one float32 ulp), a leaf 9.9e-6 of its max (the hybrid's
# w_C, through the chunked scan; 2.1e-6 to 4.8e-6 for the others)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _batch_np(cfg, seed=1):
    """Tokens, labels and (vlm, audio) stubbed embeddings, numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["vision_embeds"] = 0.02 * rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model))
    if cfg.family == "audio":
        batch["cond_embeds"] = 0.02 * rng.standard_normal(
            (B, cfg.n_cond_tokens, cfg.d_model))
    return batch


def _to_jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                           else jnp.float32) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(v.astype(np.int64 if v.dtype.kind == "i"
                                         else np.float32))
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(tree, batch, loss, aux, gradient tree, the gradients as a port
    state dict) of the reference's ``lm_loss`` at ``reduced()``."""
    jcfg = jget_config(arch).reduced()
    tree = lm_params(jcfg, 0)
    batch = _batch_np(jcfg)

    def loss_fn(p, b):
        return jtf.lm_loss(p, b, jcfg)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), _to_jax(batch))
    return tree, batch, float(loss), {k: float(v) for k, v in aux.items()}, \
        grads, ttf.params_from_jax(jax.tree.map(np.asarray, grads))


def _model(arch, tree):
    model = ttf.Transformer(get_config(arch).reduced(), device="cpu")
    model.load_state_dict(ttf.params_from_jax(tree))
    return model


def _grads(model, batch, **kw):
    cfg = model.cfg
    for p in model.parameters():
        p.grad = None
    loss, aux = ttf.lm_loss(model, batch, cfg, **kw)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, {
        k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_and_gradients_match_reference(arch):
    tree, batch, j_loss, j_aux, _, j_grads = _reference(arch)
    model = _model(arch, tree)
    loss, aux, grads = _grads(model, _to_torch(batch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    assert abs(float(aux["ce"]) - j_aux["ce"]) <= LOSS_RTOL * abs(j_aux["ce"])
    assert abs(float(aux["moe_aux"]) - j_aux["moe_aux"]) <= \
        LOSS_RTOL * max(abs(j_aux["moe_aux"]), 1e-30)
    if model.cfg.is_moe:
        assert j_aux["moe_aux"] > 0.3
    # every leaf of the port has a gradient, the tied embedding once
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        want = j_grads[name]
        scale = float(want.abs().max())
        assert scale > 0, name
        assert float((g - want).abs().max()) <= GRAD_TOL * scale, name


def test_cross_entropy_is_the_written_out_form_in_float32():
    """bf16 logits are upcast first; the mean over every token."""
    g = torch.Generator().manual_seed(0)
    logits = (3 * torch.randn((2, 5, 11), generator=g)).bfloat16()
    labels = torch.randint(0, 11, (2, 5), generator=g)
    ce = softmax_cross_entropy(logits, labels)
    lf = logits.float()
    want = (torch.logsumexp(lf, -1)
            - lf.gather(-1, labels[..., None])[..., 0]).mean()
    assert ce.dtype == torch.float32 and torch.equal(ce, want)
    # the reference's on the same logits
    j = jtf.softmax_cross_entropy(jnp.asarray(lf.numpy()),
                                  jnp.asarray(labels.numpy(), jnp.int32))
    assert abs(float(ce) - float(j)) <= 1e-6 * float(j)


def _state_np(tree, seed):
    """AdamW state after a few steps' worth of moments, numpy."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda a: 0.01 * rng.standard_normal(a.shape)
                      .astype(np.float32), tree)
    nu = jax.tree.map(lambda a: 1e-4 * rng.random(a.shape)
                      .astype(np.float32), tree)
    return mu, nu


def _port_state(mu, nu, step):
    """The port's AdamW state from the numpy moments, copied: the
    reference's jitted update may still be reading the same numpy buffers
    (its dispatch is asynchronous) while the port updates these in
    place."""
    return {"step": torch.tensor(step, dtype=torch.int32),
            "mu": {k: v.clone() for k, v in ttf.params_from_jax(mu).items()},
            "nu": {k: v.clone() for k, v in ttf.params_from_jax(nu).items()}}


@pytest.mark.parametrize("arch,wd,sched", [("minicpm-2b", 0.0, None),
                                           ("deepseek-v2-236b", 0.1, "wsd")])
def test_apply_updates_inplace_matches_reference(arch, wd, sched):
    """The reference's gradients through the port's ``apply_updates_`` give
    the reference's ``apply_updates`` parameters and moments within 1e-6
    (the reference's clip scales them: the global norm is above 1)."""
    tree, _, _, _, jgrads, grads = _reference(arch)
    jcfg = jadamw.AdamWConfig(lr=1e-3, weight_decay=wd)
    tcfg = adamw.AdamWConfig(lr=1e-3, weight_decay=wd)
    mu, nu = _state_np(tree, 3)
    jsched = tsched = None
    if sched:
        jsched = jschedule.get_schedule(sched, 10)
        tsched = tschedule.get_schedule(sched, 10)
    jp, js, jm = jax.jit(lambda p, g, st: jadamw.apply_updates(
        p, g, st, jcfg, jsched))(
        jax.tree.map(jnp.asarray, tree), jgrads,
        {"step": jnp.asarray(4, jnp.int32), "mu": jax.tree.map(jnp.asarray,
                                                               mu),
         "nu": jax.tree.map(jnp.asarray, nu)})
    params = {k: v.clone() for k, v in ttf.params_from_jax(tree).items()}
    state = _port_state(mu, nu, 4)
    m = adamw.apply_updates_(params, grads, state, tcfg, tsched)
    assert float(m["grad_norm"]) > 1.0
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-6 * float(jm["grad_norm"])
    assert float(m["lr"]) == float(np.float32(jm["lr"]))
    assert int(state["step"]) == 5
    for got, want in ((params, jp), (state["mu"], js["mu"]),
                      (state["nu"], js["nu"])):
        want = ttf.params_from_jax(jax.tree.map(np.asarray, want))
        for name in want:
            assert float((got[name] - want[name]).abs().max()) <= 1e-6, name


@pytest.mark.parametrize("dtype,wd,clip,sched", [
    ("float32", 0.0, 1.0, None), ("float32", 0.1, 1.0, "cosine"),
    ("float32", 0.0, 0.0, "wsd"), ("bfloat16", 0.1, 1.0, "wsd")])
def test_apply_updates_inplace_is_bitwise_functional(dtype, wd, clip, sched):
    """In place, leaf by leaf, the parameters, moments, step and metrics
    are bitwise the functional ``apply_updates``' (f32 and bf16
    parameters, float32 moments), and the inputs given to the functional
    one are untouched."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(5)
    shapes = {"embed.embedding": (37, 16), "layers.0.w": (16, 24),
              "layers.0.scale": (16,), "groups.0.1.a": (3, 5, 7)}
    params = {k: torch.randn(s, generator=g).to(dt) for k, s in shapes.items()}
    grads = {k: (3 * torch.randn(s, generator=g)).to(dt)
             for k, s in shapes.items()}
    cfg = adamw.AdamWConfig(lr=3e-3, weight_decay=wd, grad_clip=clip)
    sch = tschedule.get_schedule(sched, 20) if sched else None
    state = adamw.init_state(params, cfg)
    state_ = adamw.init_state(params, cfg)
    params_ = {k: v.clone() for k, v in params.items()}
    before = {k: v.clone() for k, v in params.items()}
    for _ in range(3):
        params, state, m = adamw.apply_updates(params, grads, state, cfg, sch)
        m_ = adamw.apply_updates_(params_, grads, state_, cfg, sch)
        assert torch.equal(m["grad_norm"], m_["grad_norm"])
        assert torch.equal(m["lr"], m_["lr"])
    assert torch.equal(state["step"], state_["step"])
    for k in shapes:
        assert params_[k].dtype == dt
        assert torch.equal(params[k], params_[k]), k
        assert torch.equal(state["mu"][k], state_["mu"][k]), k
        assert torch.equal(state["nu"][k], state_["nu"][k]), k
        assert not torch.equal(params_[k], before[k]), k


@pytest.mark.parametrize("arch", list_archs())
def test_train_step_lowers_the_loss(arch):
    """Five steps on one repeated batch lower the loss, every arch (the
    reference's test_loss_decreases), and the step frees the gradients and
    counts its steps."""
    cfg = get_config(arch).reduced()
    model = ttf.init_params(cfg, seed=0, device="cpu")
    opt_cfg = adamw.AdamWConfig(lr=3e-3)
    state = adamw.init_state(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    batch = _to_torch(_batch_np(cfg, seed=2))
    losses = []
    for _ in range(5):
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        assert set(m) == {"loss", "ce", "moe_aux", "grad_norm", "lr"}
    assert losses[-1] < losses[0], losses
    assert int(state["step"]) == 5
    assert all(p.grad is None for p in model.parameters())
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2-vl-2b",
                                  "musicgen-large", "kimi-k2-1t-a32b",
                                  "zamba2-7b", "xlstm-125m"])
def test_remat_is_bitwise_the_plain_step(arch):
    """``remat=True`` (each block under torch.utils.checkpoint) gives the
    plain step's loss and gradients bitwise, and the same parameters after
    two steps."""
    cfg = get_config(arch).reduced()
    batch = _to_torch(_batch_np(cfg, seed=4))
    base = ttf.init_params(cfg, seed=1, device="cpu")
    loss, aux, grads = _grads(base, batch)
    loss_r, aux_r, grads_r = _grads(base, batch, remat=True)
    assert torch.equal(loss, loss_r)
    assert torch.equal(aux["moe_aux"], aux_r["moe_aux"])
    for k in grads:
        assert torch.equal(grads[k], grads_r[k]), k
    out = []
    for remat in (False, True):
        model = ttf.Transformer(cfg, device="cpu")
        model.load_state_dict(base.state_dict())
        opt_cfg = adamw.AdamWConfig(lr=1e-3)
        state = adamw.init_state(dict(model.named_parameters()), opt_cfg)
        step = make_train_step(cfg, opt_cfg, remat=remat)
        for _ in range(2):
            model, state, _ = step(model, state, batch)
        out.append(model.state_dict())
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


def test_kernel_wrappers_refuse_autograd_off_the_cpu():
    """A non-CPU tensor that requires a gradient, while autograd records,
    raises RuntimeError naming the missing backward; under no_grad and
    inference_mode the wrapper goes on to its device check, which a meta
    tensor (the dry run's) passes to the output's shape."""
    q = torch.empty((1, 8, 4, 32), device="meta", requires_grad=True)
    x = torch.empty((1, 8, 4, 16), device="meta", requires_grad=True)
    dt = torch.empty((1, 8, 4), device="meta")
    a = torch.empty(4, device="meta")
    bm = torch.empty((1, 8, 16), device="meta")
    for call in (lambda: ops.flash_attention(q, q, q),
                 lambda: ops.ssm_scan(x, dt, a, bm, bm)):
        with pytest.raises(RuntimeError, match="no backward.*kernel='torch'"):
            call()
        for mode in (torch.no_grad, torch.inference_mode):
            with mode():
                out = call()
            assert out.is_meta and out.shape[:3] == (1, 8, 4)
    # a CPU tensor that requires a gradient takes the differentiable plain
    # version
    qc = torch.randn((1, 8, 4, 32), requires_grad=True)
    ops.flash_attention(qc, qc, qc).sum().backward()
    assert qc.grad is not None and bool(torch.isfinite(qc.grad).all())


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-7b"])
def test_lm_loss_with_the_kernels_raises_off_the_cpu(arch):
    """The forward's default ``kernel="flash"`` under autograd on a non-CPU
    device raises at the first kernel call; the training default
    ``kernel="torch"`` runs through (a meta model: shapes only)."""
    cfg = get_config(arch).reduced()
    model = ttf.Transformer(cfg, device="meta")
    toks = torch.zeros((B, S), dtype=torch.int64, device="meta")
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(RuntimeError, match="no backward"):
        ttf.lm_loss(model, batch, cfg, kernel="flash")
    loss, _ = ttf.lm_loss(model, batch, cfg)
    assert loss.shape == () and loss.requires_grad


def test_training_path_calls_no_kernel_wrapper(monkeypatch):
    """The train step never reaches ``ops.flash_attention`` or
    ``ops.ssm_scan`` (replaced here by functions that raise), for the
    families with attention and with the Mamba2 mixer."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called")
    monkeypatch.setattr(ops, "flash_attention", boom)
    monkeypatch.setattr(ops, "ssm_scan", boom)
    for arch in ("glm4-9b", "zamba2-7b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=3)
        model = ttf.init_params(cfg, seed=0, device="cpu")
        state = adamw.init_state(dict(model.named_parameters()),
                                 adamw.AdamWConfig())
        _, _, m = make_train_step(cfg)(model, state,
                                       _to_torch(_batch_np(cfg)))
        assert bool(torch.isfinite(m["loss"]))


def test_chunk_loops_give_finite_gradients_where_exp_overflows():
    """Above the diagonal of a chunk exp(seg) overflows once the decay
    summed over the chunk passes ~88: the Mamba2 chunk loop (dt ~10, a -1
    and -2 over 32 steps) and the mLSTM (forget bias -20 over 512 steps)
    keep the forward (the recurrence's values) and give finite gradients,
    where selecting after the exp (the reference's jnp.where) gives NaN."""
    from repro_torch.kernels.ref import ssm_scan_ref
    from repro_torch.models import ssm as tssm
    from repro_torch.models import xlstm as txl
    g = torch.Generator().manual_seed(0)
    xh = torch.randn((1, 32, 2, 4), generator=g, requires_grad=True)
    dt = (10 + torch.rand((1, 32, 2), generator=g)).requires_grad_()
    a = torch.tensor([-1.0, -2.0], requires_grad=True)
    bm = torch.randn((1, 32, 8), generator=g, requires_grad=True)
    cm = torch.randn((1, 32, 8), generator=g, requires_grad=True)
    y = tssm._chunked_mixing(xh, dt, a, bm, cm, 32)
    with torch.no_grad():
        ref = ssm_scan_ref(xh, dt, a, bm, cm)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    y.square().sum().backward()
    for t in (xh, dt, a, bm, cm):
        assert bool(torch.isfinite(t.grad).all())
    cfg = get_config("xlstm-125m").reduced()
    mod = txl.MLSTM(cfg, device="cpu")
    mod.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        mod.f_bias.fill_(-20.0)
    x = torch.randn((1, 512, cfg.d_model), generator=g, requires_grad=True)
    out = txl.mlstm_forward(x, mod, cfg)
    assert bool(torch.isfinite(out).all())
    out.square().sum().backward()
    assert bool(torch.isfinite(x.grad).all())
    for name, p in mod.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name
