"""Port parity: the CollaFuse training path — synthetic data, ``q_sample``
and ``ddpm_loss``, the split losses and upload builders, AdamW, and the
whole trainer (batched and looped, with and without labels) — against the
reference, fed the reference's weights and its threefry draws
(``tests/_torch_parity.py``: ``unet_params``, ``reference_train_draws``).

Each test states its tolerance; the ``*_catches_*`` tests show that a
deliberate fault (AdamW's b2 = 0.999, clipping over the whole client stack
instead of per member, an off-by-one in a t range) breaks it.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import functional_call, grad_and_value  # noqa: E402

from _torch_parity import (np_tree, reference_chain_noise,  # noqa: E402
                           reference_train_draws, set_torch_cpu, unet_params)
from repro.configs.base import UNetConfig as JaxUNetConfig  # noqa: E402
from repro.core import collafuse as jcf  # noqa: E402
from repro.core.trainer import CollaFuseTrainer as JaxTrainer  # noqa: E402
from repro.core.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.diffusion import ddpm as jddpm  # noqa: E402
from repro.diffusion import schedule as jsch  # noqa: E402
from repro.models import unet as junet  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import UNetConfig  # noqa: E402
from repro_torch.core import collafuse as tcf  # noqa: E402
from repro_torch.core import trainer as ttr  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.diffusion import ddpm as tddpm  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402
from repro_torch.launch import clients_sweep  # noqa: E402
from repro_torch.launch.serve_diffusion import launcher_config  # noqa: E402
from repro_torch.models import unet as tunet  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

set_torch_cpu()

T, CUT, N_CLIENTS, B, IMAGE, ROUNDS = 10, 0.8, 3, 4, 8, 3
NUM_CLASSES, LABEL_DROP = 3, 0.3
LABELS = [np.array(v, np.int32) for v in ([0, 1, 2, 1], [2, 2, 0, 1],
                                          [1, 0, 3, 2])]   # 3 = the null row
# losses: both frameworks compute in f32 and their convolutions sum in
# other orders; the reference holds its own two engines to the same rtol
# (tests/test_batched_engine.py)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# gradients, relative to each leaf's largest entry: f32 rounding in the
# convolutions' sums, ~1e-6 measured
GRAD_RTOL = 1e-4


def _configs(name, num_classes=0):
    port = {"sweep": launcher_config(IMAGE),
            "reduced": UNetConfig().reduced()}[name]
    port = dataclasses.replace(port, num_classes=num_classes)
    ref = JaxUNetConfig(**{f.name: getattr(port, f.name)
                           for f in dataclasses.fields(JaxUNetConfig)})
    return ref, port


def _module(cfg, params):
    m = tunet.UNet(cfg)
    m.load_state_dict(tunet.params_from_jax(params))
    return m


def _model_fn(module):
    def fn(params, x, t, y=None):
        return functional_call(module, params,
                               (x, t) if y is None else (x, t, y))
    return fn


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size,n_clients", [(8, 3), (32, 2)])
def test_synthetic_datasets_equal_the_reference_bitwise(size, n_clients):
    cfg = dict(n_clients=n_clients, per_client=5, image_size=size,
               holdout=3, seed=4)
    jc, jh = jsyn.make_client_datasets(jsyn.ClientDataConfig(**cfg))
    tc, th = tsyn.make_client_datasets(tsyn.ClientDataConfig(**cfg))
    assert len(tc) == n_clients and th.dtype == torch.float32
    for a, b in zip(jc + [jh], tc + [th]):
        assert np.array_equal(np.asarray(a), b.numpy())
    jb = jsyn.image_batches(jc[0], 2, seed=3)
    tb = tsyn.image_batches(tc[0], 2, seed=3)
    for _ in range(5):                            # wraps past one epoch
        assert np.array_equal(np.asarray(next(jb)), next(tb).numpy())


# ---------------------------------------------------------------------------
# q_sample, ddpm_loss, split losses, uploads
# ---------------------------------------------------------------------------
def test_q_sample_and_ddpm_loss_match_reference_given_the_draws():
    """Same x0, t and noise: x_t within 1e-6 and the loss within LOSS_TOL;
    t one off (the off-by-one fault) moves the loss beyond it."""
    ref_cfg, port_cfg = _configs("sweep")
    params = unet_params(ref_cfg, 3)
    model = _module(port_cfg, params)
    js, ts = jsch.cosine_schedule(T), tsch.cosine_schedule(T)
    key = jax.random.PRNGKey(5)
    x0 = np.random.default_rng(0).standard_normal((B, IMAGE, IMAGE, 1))
    x0 = x0.astype(np.float32)
    ref_loss, aux = jax.jit(lambda k, x: jddpm.ddpm_loss(
        js, lambda xt, t: junet.forward(params, xt, t, ref_cfg), k, x,
        t_range=(1, 8)))(key, jnp.asarray(x0))
    k_t, k_n = jax.random.split(key)                # ddpm_loss's draws
    t = np.asarray(jax.random.randint(k_t, (B,), 1, 9))
    noise = np.asarray(jax.random.normal(k_n, x0.shape))
    assert np.array_equal(t, np.asarray(aux["t"]))
    np.testing.assert_allclose(
        tddpm.q_sample(ts, _t(x0), _t(t), _t(noise)).numpy(),
        np.asarray(jddpm.q_sample(js, jnp.asarray(x0), jnp.asarray(t),
                                  jnp.asarray(noise))), rtol=0, atol=1e-6)
    with torch.no_grad():
        loss, out = tddpm.ddpm_loss(ts, model, _t(x0), _t(t), _t(noise))
        shifted, _ = tddpm.ddpm_loss(ts, model, _t(x0), _t(t) + 1,
                                     _t(noise))
    assert torch.equal(out["t"], _t(t))
    np.testing.assert_allclose(float(loss), float(ref_loss), **LOSS_TOL)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(float(shifted), float(ref_loss),
                                   **LOSS_TOL)


@pytest.mark.parametrize("name,labeled", [("sweep", False), ("sweep", True),
                                          ("reduced", True)])
def test_split_losses_and_gradients_match_reference(name, labeled):
    """Round 0 of both sides from the reference's parameters: the server
    loss on an upload and the client loss from x0 and a key, each within
    LOSS_TOL, every leaf's gradient within GRAD_RTOL of its largest
    entry.  ``reduced`` has attention at 8×8."""
    nc = NUM_CLASSES if labeled else 0
    ref_cfg, port_cfg = _configs(name, nc)
    params = unet_params(ref_cfg, 11)
    model = _module(port_cfg, params)
    tparams = {k: v.detach() for k, v in model.named_parameters()}
    js, ts = jsch.cosine_schedule(T), tsch.cosine_schedule(T)
    plan = jcf.CutPlan(T, CUT)
    s = port_cfg.image_size
    x0 = np.random.default_rng(1).uniform(-1, 1, (B, s, s, 1))
    x0 = x0.astype(np.float32)
    y = LABELS[2] if labeled else None
    yj = None if y is None else jnp.asarray(y)

    def apply(p, x, t, *yy):
        return junet.forward(p, x, t, ref_cfg, *yy)

    # the server: an upload made by the reference
    up = jcf.make_server_batch(js, plan, jax.random.PRNGKey(2),
                               jnp.asarray(x0), yj, nc, LABEL_DROP)
    up = {k: np.asarray(v) for k, v in up.items()}
    rl, rg = jax.jit(jax.value_and_grad(jcf.server_loss_fn(js, plan,
                                                           apply)))(
        params, *(jnp.asarray(up[k]) for k in ("x_t", "t", "eps")),
        None if y is None else jnp.asarray(up["y"]))
    tg, tl = grad_and_value(tcf.server_loss_fn(_model_fn(model)))(
        tparams, *(_t(up[k]) for k in ("x_t", "t", "eps")),
        None if y is None else _t(up["y"], np.int64))
    np.testing.assert_allclose(float(tl), float(rl), **LOSS_TOL)
    ref_g = tunet.params_from_jax(np_tree(rg))
    for k in ref_g:
        assert _max_rel(tg[k].numpy(), ref_g[k].numpy()) < GRAD_RTOL, k

    # a client: the reference's key, split as client_loss_fn splits it
    key = jax.random.PRNGKey(7)
    rl, rg = jax.jit(jax.value_and_grad(jcf.client_loss_fn(
        js, plan, apply, nc, LABEL_DROP)))(params, key, jnp.asarray(x0), yj)
    drop = None
    if labeled:
        k_drop, key = jax.random.split(key)
        drop = _t(jax.random.bernoulli(k_drop, LABEL_DROP, (B,)))
    k_t, k_n = jax.random.split(key)
    t = _t(jax.random.randint(k_t, (B,), 1, plan.t_split + 1))
    noise = _t(jax.random.normal(k_n, x0.shape))
    tg, tl = grad_and_value(tcf.client_loss_fn(ts, _model_fn(model), nc))(
        tparams, _t(x0), t, noise, None if y is None else _t(y, np.int64),
        drop)
    np.testing.assert_allclose(float(tl), float(rl), **LOSS_TOL)
    ref_g = tunet.params_from_jax(np_tree(rg))
    for k in ref_g:
        assert _max_rel(tg[k].numpy(), ref_g[k].numpy()) < GRAD_RTOL, k


@pytest.mark.parametrize("labeled", [False, True])
def test_upload_builders_match_reference(labeled):
    """``make_server_batch`` per client and ``make_pooled_server_batch``
    given the reference's draws: x_t within 1e-6, t, eps and dropped labels
    equal; the pooled batch is the client-major concatenation, and no
    upload carries x0."""
    js, ts = jsch.cosine_schedule(T), tsch.cosine_schedule(T)
    plan = jcf.CutPlan(T, CUT)
    rng = np.random.default_rng(2)
    x0 = rng.uniform(-1, 1, (N_CLIENTS, B, IMAGE, IMAGE, 1))
    x0 = x0.astype(np.float32)
    ys = np.stack(LABELS) if labeled else None
    keys = jax.random.split(jax.random.PRNGKey(4), N_CLIENTS)
    nc = NUM_CLASSES if labeled else 0
    ref = jcf.make_pooled_server_batch(
        js, plan, keys, jnp.asarray(x0),
        None if ys is None else jnp.asarray(ys), nc, LABEL_DROP)
    lo, hi = plan.server_range
    ts_, epss, drops = [], [], []
    for k in range(N_CLIENTS):                 # make_server_batch's splits
        if labeled:
            k_t, k_n, k_y = jax.random.split(keys[k], 3)
            drops.append(_t(jax.random.bernoulli(k_y, LABEL_DROP, (B,))))
        else:
            k_t, k_n = jax.random.split(keys[k])
        ts_.append(_t(jax.random.randint(k_t, (B,), lo, hi + 1)))
        epss.append(_t(jax.random.normal(k_n, x0.shape[1:])))
    per = [tcf.make_server_batch(
        ts, _t(x0[k]), ts_[k], epss[k],
        None if ys is None else _t(ys[k], np.int64),
        drops[k] if labeled else None, nc) for k in range(N_CLIENTS)]
    pooled = tcf.make_pooled_server_batch(
        ts, _t(x0), torch.stack(ts_), torch.stack(epss),
        None if ys is None else _t(ys, np.int64),
        torch.stack(drops) if labeled else None, nc)
    assert set(pooled) == set(ref) == ({"x_t", "t", "eps", "y"} if labeled
                                       else {"x_t", "t", "eps"})
    for k in pooled:
        cat = torch.cat([u[k] for u in per])
        assert torch.equal(pooled[k], cat), k
        tol = 1e-6 if k == "x_t" else 0.0
        np.testing.assert_allclose(pooled[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=tol, err_msg=k)
    if labeled:
        assert (pooled["y"] == NUM_CLASSES).any()          # some dropped


def test_drop_labels():
    y = torch.tensor([0, 1, 2, 3])
    drop = torch.tensor([True, False, True, False])
    assert torch.equal(tcf.drop_labels(y, drop, 5), torch.tensor([5, 1, 5, 3]))
    assert tcf.drop_labels(y, None, 5) is y


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
SHAPES = {"conv": (3, 3, 2, 4), "bias": (4,), "dense": (5, 3)}
# given the same gradients the two compute the same f32 expressions: states
# and parameters agree to a few ulps
ADAM_TOL = dict(rtol=1e-6, atol=1e-9)


def _adam_case(seed, n=None, steps=3):
    rng = np.random.default_rng(seed)
    lead = () if n is None else (n,)
    # member scales straddle the clip: 0.05x, 1x and 20x a unit gradient
    scale = 1.0 if n is None else np.array([0.05, 1.0, 20.0][:n])

    def g_of(s):
        return (rng.standard_normal(lead + s) *
                np.reshape(scale, lead + (1,) * len(s))).astype(np.float32)
    p = {k: rng.standard_normal(lead + s).astype(np.float32)
         for k, s in SHAPES.items()}
    grads = [{k: g_of(s) for k, s in SHAPES.items()} for _ in range(steps)]
    return p, grads


def _run_ref(p, grads, cfg, stacked, schedule=None):
    init = jadamw.init_stacked_state if stacked else jadamw.init_state
    upd = jadamw.apply_updates_stacked if stacked else jadamw.apply_updates
    s = init(p, cfg)
    for g in grads:
        p, s, m = upd(p, g, s, cfg, schedule)
    return np_tree(p), np_tree(s), np_tree(m)


def _run_port(p, grads, cfg, stacked, schedule=None):
    init = tadamw.init_stacked_state if stacked else tadamw.init_state
    upd = tadamw.apply_updates_stacked if stacked else tadamw.apply_updates
    p = {k: _t(v) for k, v in p.items()}
    s = init(p, cfg)
    for g in grads:
        p, s, m = upd(p, {k: _t(v) for k, v in g.items()}, s, cfg, schedule)
    return p, s, m


def _assert_adam_equal(ref, port):
    (rp, rs, rm), (tp, ts, tm) = ref, port
    np.testing.assert_array_equal(ts["step"].numpy(), rs["step"])
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), rp[k], **ADAM_TOL)
        np.testing.assert_allclose(ts["mu"][k].numpy(), rs["mu"][k],
                                   **ADAM_TOL)
        np.testing.assert_allclose(ts["nu"][k].numpy(), rs["nu"][k],
                                   **ADAM_TOL)
    np.testing.assert_allclose(tm["grad_norm"].numpy(), rm["grad_norm"],
                               rtol=1e-6)


@pytest.mark.parametrize("inverse_lr", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_reference(steps, weight_decay, inverse_lr):
    """One and three steps, the first clipped; with decay; with an lr
    schedule of 1/step."""
    cfg = dict(weight_decay=weight_decay)
    sched = (lambda step: 1.0 / step) if inverse_lr else None
    p, grads = _adam_case(steps, steps=steps)
    grads[0] = {k: 30 * v for k, v in grads[0].items()}      # clipped
    _assert_adam_equal(
        _run_ref(p, grads, jadamw.AdamWConfig(**cfg), False, sched),
        _run_port(p, grads, tadamw.AdamWConfig(**cfg), False, sched))
    np.testing.assert_allclose(
        tadamw.global_norm({k: _t(v) for k, v in grads[0].items()}).numpy(),
        np.asarray(jadamw.global_norm(grads[0])), rtol=1e-6)


def test_adamw_stacked_clips_per_member_and_equals_per_member():
    """Three members, one under the clip, two over it: the stacked update
    equals the reference's stacked one and, member by member, the port's
    unstacked one."""
    p, grads = _adam_case(8, n=3)
    cfg = tadamw.AdamWConfig()
    port = _run_port(p, grads, cfg, True)
    _assert_adam_equal(_run_ref(p, grads, jadamw.AdamWConfig(), True), port)
    norms = port[2]["grad_norm"].numpy()
    assert norms[0] < cfg.grad_clip < norms[1] < norms[2]
    for k in range(3):
        one = _run_port({n: v[k] for n, v in p.items()},
                        [{n: v[k] for n, v in g.items()} for g in grads],
                        cfg, False)
        for n in SHAPES:
            np.testing.assert_allclose(port[0][n][k].numpy(),
                                       one[0][n].numpy(), **ADAM_TOL)
    assert torch.equal(tadamw.tree_unstack(
        tadamw.tree_stack([{"a": torch.ones(2)}, {"a": torch.zeros(2)}]), 1)
        ["a"], torch.zeros(2))


def test_adamw_tolerance_catches_b2_0999():
    """torch.optim.AdamW's default b2 = 0.999 in place of the reference's
    0.95: nu is off by 50x after one step, the parameters after two."""
    p, grads = _adam_case(1, steps=2)
    ref = _run_ref(p, grads, jadamw.AdamWConfig(), False)
    bad = _run_port(p, grads, tadamw.AdamWConfig(b2=0.999), False)
    with pytest.raises(AssertionError):
        _assert_adam_equal(ref, bad)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad[0]["conv"].numpy(), ref[0]["conv"],
                                   **ADAM_TOL)


def test_adamw_tolerance_catches_a_clip_over_the_whole_stack():
    """The unstacked update run on the stack clips every member by the
    stack's norm: the members under the clip then move differently."""
    p, grads = _adam_case(8, n=3)
    ref = _run_ref(p, grads, jadamw.AdamWConfig(), True)
    cfg = tadamw.AdamWConfig()
    pt = {k: _t(v) for k, v in p.items()}
    s = tadamw.init_state(pt, cfg)                    # one scalar step
    for g in grads:
        pt, s, _ = tadamw.apply_updates(pt, {k: _t(v) for k, v in g.items()},
                                        s, cfg)
    with pytest.raises(AssertionError):
        for k in SHAPES:
            np.testing.assert_allclose(pt[k].numpy(), ref[0][k], **ADAM_TOL)


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------
def test_train_draws_are_keyed_and_stay_in_their_side_range():
    plan = tcf.CutPlan(T, CUT)
    src = tcf.TrainDraws(3)
    t, eps, drop = tcf.side_draws(src, plan, 2, 1, "client", (400, 2, 2, 1),
                                  True, 0.25)
    # {1..t_split}: both ends drawn, nothing outside; the server's likewise
    assert t.min() == 1 and t.max() == plan.t_split
    ts_, _, none = tcf.side_draws(src, plan, 2, 1, "server", (400, 2, 2, 1),
                                  False, 0.25)
    assert ts_.min() == plan.t_split + 1 and ts_.max() == T and none is None
    assert 0.15 < drop.float().mean() < 0.35 and eps.shape == (400, 2, 2, 1)
    # a draw is a function of its key alone, not of the order of asking
    again = tcf.side_draws(tcf.TrainDraws(3), plan, 2, 1, "client",
                           (400, 2, 2, 1), True, 0.25)
    assert all(torch.equal(a, b) for a, b in zip((t, eps, drop), again))
    for key in [(4, 2, 1), (3, 1, 1), (3, 2, 0)]:
        other = tcf.TrainDraws(key[0]).noise(key[1], key[2], "client",
                                             (4, 2, 2, 1))
        assert not torch.equal(other, eps[:4])
    assert len({tcf.train_seed(3, 2, 1, r) for r in tcf.TRAIN_ROLES}) == 6


def test_a_t_range_off_by_one_is_refused():
    """A source drawing t one past the side's range (randint's exclusive
    end taken as inclusive) is caught where the draws are taken."""
    class OffByOne(tcf.TrainDraws):
        def timesteps(self, rnd, client, side, b, lo, hi):
            return super().timesteps(rnd, client, side, b, lo, hi + 1)
    plan = tcf.CutPlan(T, CUT)
    with pytest.raises(ValueError, match="outside"):
        tcf.side_draws(OffByOne(0), plan, 0, 0, "client", (200, 1, 1, 1),
                       False, 0.0)
    with pytest.raises(KeyError):
        tcf.InjectedTrainDraws({}).noise(0, 0, "server", (1, 1, 1, 1))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _data():
    clients, _ = jsyn.make_client_datasets(jsyn.ClientDataConfig(
        n_clients=N_CLIENTS, per_client=B, image_size=IMAGE, holdout=2))
    return [np.asarray(c) for c in clients]


def _cfg(labeled, **kw):
    return {**dict(n_clients=N_CLIENTS, T=T, cut_ratio=CUT, seed=0,
                   num_classes=NUM_CLASSES if labeled else 0,
                   label_drop=LABEL_DROP), **kw}


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's looped trainer, 3 rounds, per label mode: its
    initial and final parameters (numpy) and its metrics.  The reference's
    own test holds its batched engine to this one
    (tests/test_batched_engine.py); the looped engine compiles smaller
    programs."""
    runs = {}
    for labeled in (False, True):
        ref_cfg, _ = _configs("sweep", NUM_CLASSES if labeled else 0)
        tr = JaxTrainer(JaxTrainerConfig(**_cfg(labeled, batched=False)),
                        lambda k: junet.init_params(k, ref_cfg),
                        lambda p, x, t, *y: junet.forward(p, x, t, ref_cfg,
                                                          *y))
        init = [np_tree(tr.server_params)] + [np_tree(p)
                                              for p in tr.client_params]
        data = [jnp.asarray(d) for d in _data()]
        labels = [jnp.asarray(y) for y in LABELS] if labeled else None
        metrics = [tr.train_round(data, labels) for _ in range(ROUNDS)]
        runs[labeled] = dict(init=init, metrics=metrics,
                             server=np_tree(tr.server_params),
                             clients=[np_tree(p) for p in tr.client_params])
    return runs


def _port_trainer(run, labeled, batched, rounds=ROUNDS, **kw):
    _, port_cfg = _configs("sweep", NUM_CLASSES if labeled else 0)
    by_seed = {ttr.member_seed(0, m): p for m, p in enumerate(run["init"])}
    draws = reference_train_draws(0, rounds, N_CLIENTS, B, (IMAGE, IMAGE, 1),
                                  tcf.CutPlan(T, CUT), labeled,
                                  LABEL_DROP if labeled else 0.0)
    return ttr.CollaFuseTrainer(
        ttr.TrainerConfig(**_cfg(labeled, batched=batched, **kw)),
        lambda s: _module(port_cfg, by_seed[s]), device="cpu",
        draws=tcf.InjectedTrainDraws(draws))


def _train(tr, labeled, rounds=ROUNDS):
    data = [torch.from_numpy(d) for d in _data()]
    labels = [_t(y, np.int64) for y in LABELS] if labeled else None
    return [tr.train_round(data, labels) for _ in range(rounds)]


# Parameters after 3 AdamW steps.  Adam's first steps move a parameter by
# lr·mu_hat/(sqrt(nu_hat)+eps): about ±lr by the sign of its gradient, and
# for the b1, b2 here at most 1.001·lr a step (Cauchy-Schwarz on the bias-
# corrected averages).  Where a gradient is near 0 the two frameworks'
# roundings can give it either sign, so one parameter can end up to
# 2·lr·steps apart; the rest agree to f32 rounding.  Held: every entry
# within 2·1.001·lr·ROUNDS, and the mean |Δ| within 1e-3·lr (measured
# ~2e-8, max ~1.6e-4, with ~0.03 % of entries beyond 1e-5).
PARAM_MAX = 2 * 1.001 * 1e-3 * ROUNDS
PARAM_MEAN = 1e-6


def _assert_params_close(port, ref, what):
    """``port`` against ``ref`` (a state dict, or the reference's tree)."""
    if not all(torch.is_tensor(v) for v in ref.values()):
        ref = tunet.params_from_jax(ref)
    d = np.concatenate([np.abs(port[k].numpy() - ref[k].numpy()).ravel()
                        for k in ref])
    assert d.max() <= PARAM_MAX, (what, d.max())
    assert d.mean() <= PARAM_MEAN, (what, d.mean())


@pytest.mark.parametrize("labeled", [False, True])
@pytest.mark.parametrize("batched", [True, False])
def test_trainer_matches_reference_for_three_rounds(reference_runs, batched,
                                                    labeled):
    run = reference_runs[labeled]
    tr = _port_trainer(run, labeled, batched)
    metrics = _train(tr, labeled)
    for r, (m, rm) in enumerate(zip(metrics, run["metrics"])):
        np.testing.assert_allclose(m["server_loss"], rm["server_loss"],
                                   err_msg=f"round {r}", **LOSS_TOL)
        np.testing.assert_allclose(m["client_losses"], rm["client_losses"],
                                   err_msg=f"round {r}", **LOSS_TOL)
        for k in ("server_flops", "client_flops", "client_fraction"):
            assert m[k] == pytest.approx(rm[k], rel=1e-12)
    _assert_params_close(tr.server_params, run["server"], "server")
    for k in range(N_CLIENTS):
        _assert_params_close(tr.client_params[k], run["clients"][k],
                             f"client {k}")


def test_trainer_parameter_bound_catches_b2_0999(reference_runs):
    """The trainer with AdamW's b2 at 0.999 fails the parameter bound."""
    run = reference_runs[False]
    tr = _port_trainer(run, False, True)
    tr.opt_cfg = tadamw.AdamWConfig(lr=1e-3, grad_clip=1.0, b2=0.999)
    _train(tr, False)
    with pytest.raises(AssertionError):
        _assert_params_close(tr.server_params, run["server"], "server")


@pytest.mark.parametrize("labeled", [False, True])
def test_batched_engine_matches_looped(reference_runs, labeled):
    """The port's two engines on the same draws: losses within LOSS_TOL,
    parameters to the cross-framework bound (one vmapped grouped
    convolution against three separate ones round differently, and a
    near-zero gradient can flip an entry's first step), AdamW's first
    moments within 1e-5.  A ragged round on the batched trainer takes the
    looped engine and keeps the stack."""
    run = reference_runs[labeled]
    trs = {b: _port_trainer(run, labeled, b) for b in (True, False)}
    ms = {b: _train(tr, labeled) for b, tr in trs.items()}
    for mb, ml in zip(ms[True], ms[False]):
        np.testing.assert_allclose(mb["server_loss"], ml["server_loss"],
                                   **LOSS_TOL)
        np.testing.assert_allclose(mb["client_losses"], ml["client_losses"],
                                   **LOSS_TOL)
    _assert_params_close(trs[True].server_params, trs[False].server_params,
                         "server")
    stacks = [trs[b].client_stack for b in (True, False)]
    for k in range(N_CLIENTS):
        _assert_params_close(*(tadamw.tree_unstack(s, k) for s in stacks),
                             f"client {k}")
    mus = [trs[b].client_opt_stack["mu"] for b in (True, False)]
    for k in mus[0]:
        np.testing.assert_allclose(mus[0][k].numpy(), mus[1][k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert torch.equal(trs[True].client_opt_stack["step"],
                       torch.full((N_CLIENTS,), ROUNDS, dtype=torch.int32))
    tr = trs[True]
    ragged = [torch.zeros((2 + k, IMAGE, IMAGE, 1)) for k in range(N_CLIENTS)]
    labels = ([torch.zeros(2 + k, dtype=torch.int64)
               for k in range(N_CLIENTS)] if labeled else None)
    tr.draws = tcf.TrainDraws(0)
    m = tr.train_round(ragged, labels)
    assert len(m["client_losses"]) == N_CLIENTS and tr._client_list is None
    assert torch.equal(tr.client_opt_stack["step"],
                       torch.full((N_CLIENTS,), ROUNDS + 1,
                                  dtype=torch.int32))


def test_client_views_and_set_client_params(reference_runs):
    run = reference_runs[False]
    for batched in (True, False):
        tr = _port_trainer(run, False, batched)
        new = {k: torch.full_like(v, 0.5)
               for k, v in tr.client_params[1].items()}
        tr.set_client_params(1, new)
        assert all(torch.equal(tr.client_params[1][k], new[k]) for k in new)
        assert all(torch.equal(tr.client_stack[k][1], new[k]) for k in new)
        assert not torch.equal(tr.client_params[0]["conv_in.weight"],
                               new["conv_in.weight"])
        assert len(tr.client_opts) == N_CLIENTS
        m = tr.client_model(1)
        assert torch.equal(m.conv_in.weight, new["conv_in.weight"])
        assert torch.equal(tr.server_model().conv_in.weight,
                           tr.server_params["conv_in.weight"])


@pytest.mark.parametrize("cut", [0.0, 1.0])
def test_trainer_with_one_side_empty(reference_runs, cut):
    """c = 0 trains only the server, c = 1 only the clients (the paper's
    non-collaborative baseline); the missing side draws and reports
    nothing."""
    run = reference_runs[False]
    by_seed = {ttr.member_seed(0, m): p for m, p in enumerate(run["init"])}
    _, port_cfg = _configs("sweep")
    tr = ttr.CollaFuseTrainer(
        ttr.TrainerConfig(**_cfg(False, cut_ratio=cut)),
        lambda s: _module(port_cfg, by_seed[s]), device="cpu")
    m = _train(tr, False, rounds=1)[0]
    assert ("server_loss" in m) == (cut == 0.0)
    assert ("client_losses" in m) == (cut == 1.0)


@pytest.mark.parametrize("labeled", [False, True])
def test_trainer_sample_and_disclosed_match_reference(reference_runs,
                                                      labeled):
    """Split sampling and the disclosed tensor from the reference's initial
    models, fed the reference's threefry noise, within 1e-4: T = 10's
    first step divides by √(1-β_T) ≈ 0.03, which grows f32 rounding."""
    run = reference_runs[labeled]
    ref_cfg, _ = _configs("sweep", NUM_CLASSES if labeled else 0)
    jt = JaxTrainer(JaxTrainerConfig(**_cfg(labeled)),
                    lambda k: junet.init_params(k, ref_cfg),
                    lambda p, x, t, *y: junet.forward(p, x, t, ref_cfg, *y))
    tr = _port_trainer(run, labeled, True)
    shape = (2, IMAGE, IMAGE, 1)
    key = jax.random.PRNGKey(6)
    ref_x0, ref_mid = jt.sample(key, shape, client_idx=1,
                                return_intermediate=True)
    k_init, k_srv, k_cli = jax.random.split(key, 3)
    x_t = np.asarray(jax.random.normal(k_init, shape))
    n_srv = T - round(CUT * T)
    srv = reference_chain_noise(k_srv, n_srv, shape)
    cli = reference_chain_noise(k_cli, T - n_srv, shape)
    draws = {}
    for i in range(2):
        draws[(9, i, "init", 0)] = x_t[i]
        for p in range(T):
            draws[(9, i, "server" if p < n_srv else "client", p)] = (
                srv[p] if p < n_srv else cli[p - n_srv])[i]
    x0, mid = tr.sample(9, shape, client_idx=1, return_intermediate=True,
                        noise=tcf.InjectedNoise(draws))
    np.testing.assert_allclose(mid.numpy(), np.asarray(ref_mid), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(x0.numpy(), np.asarray(ref_x0), rtol=1e-4,
                               atol=1e-4)

    real = _data()[2]
    ref_d = jt.disclosed(key, jnp.asarray(real), client_idx=2)
    k_n, k_s = jax.random.split(key)
    eps = np.asarray(jax.random.normal(k_n, real.shape))
    chain = reference_chain_noise(k_s, n_srv, real.shape)
    draws = {(9, i, "init", 0): eps[i] for i in range(B)}
    draws.update({(9, i, "server", p): chain[p][i]
                  for i in range(B) for p in range(n_srv)})
    out = tr.disclosed(9, torch.from_numpy(real), client_idx=2,
                       noise=tcf.InjectedNoise(draws))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_d), rtol=1e-4,
                               atol=1e-4)
    if labeled:
        cs, cc = tr.cond_model_fns(0)
        y = torch.full((2,), NUM_CLASSES, dtype=torch.int64)
        xs, ts_ = torch.zeros(shape), torch.tensor([3, 9])
        with torch.no_grad():
            assert torch.equal(cs(xs, ts_, y), tr.model_fns(0)[0](xs, ts_))
    else:
        with pytest.raises(ValueError):
            tr.cond_model_fns(0)


def test_trainer_rejects_bad_inputs():
    cfg = launcher_config(IMAGE)
    tr = ttr.CollaFuseTrainer(ttr.TrainerConfig(n_clients=2, T=T),
                              lambda s: tunet.UNet(cfg, seed=s % 997),
                              device="cpu")
    x = [torch.zeros((2, IMAGE, IMAGE, 1))] * 2
    with pytest.raises(ValueError, match="batches"):
        tr.train_round(x[:1])
    with pytest.raises(ValueError, match="num_classes"):
        tr.train_round(x, [torch.zeros(2, dtype=torch.int64)] * 2)
    with pytest.raises(ValueError, match="label_drop"):
        ttr.CollaFuseTrainer(ttr.TrainerConfig(label_drop=1.0), None,
                             device="cpu")


def test_clients_sweep_launcher_on_cpu(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    clients_sweep.main(["--device", "cpu", "--clients", "2", "--rounds", "1",
                        "--T", "6", "--compare-looped", "--json", str(out)])
    assert "clients sweep OK: 1 points" in capsys.readouterr().out
    import json
    rec = json.loads(out.read_text())[0]
    assert set(rec) == {"n_clients", "round_s", "server_flops",
                        "client_flops", "server_loss", "speedup_vs_looped",
                        "device"}
    assert rec["n_clients"] == 2 and rec["device"] == "cpu"
    assert rec["speedup_vs_looped"] > 0
