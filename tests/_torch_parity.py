"""Shared helpers for the port's parity tests: run the same numpy inputs
through the JAX reference (``repro``) and the PyTorch port (``repro_torch``).

Noise is the one input the two cannot draw alike: the reference draws from
threefry keys.  :func:`reference_lane_noise` replays the reference's key
discipline — ``lane_keys`` (fold_in(req_key, image) split into k_init,
k_srv, k_cli), then ``k, k_n = split(k)`` per step — and returns the draws
keyed as the port's noise sources key them: (seed, image, role, step), with
step the trajectory position.
"""
import jax
import numpy as np
import torch

from repro.core import collafuse as jcf


def set_torch_cpu():
    """Deterministic f32 CPU math, two threads (the suite runs 6 workers)."""
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(2)


def rna_tf32(v):
    """cvt.rna.tf32.f32 of a float32 tensor, as the port's 3xTF32 kernels
    compute it on the integer units: 10 mantissa bits, ties away from
    zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b as three TF32 products (a_lo b_hi + a_hi b_lo, then a_hi b_hi)
    with float32 sums; a_lo b_lo dropped."""
    ah, bh = rna_tf32(a), rna_tf32(b)
    al, bl = rna_tf32(a - ah), rna_tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a, b):
    """a @ b as one plain TF32 product, which no port kernel uses."""
    return rna_tf32(a) @ rna_tf32(b)


def np_tree(tree):
    """A JAX pytree with every leaf as a numpy array (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return np.asarray(tree)


def unet_params(cfg, seed, perturb=True):
    """Reference U-Net params for ``cfg`` (a ``repro`` UNetConfig) drawn
    with numpy: fan-in scaled weights, and with ``perturb`` small nonzero
    biases and GroupNorm offsets, so every leaf's mapping is exercised;
    without it zero biases and unit norms, as the reference's init."""
    from repro.models import unet as junet
    shapes = jax.eval_shape(lambda k: junet.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1])
        shape = leaf.shape
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 \
                else shape[-1] if "label_emb" in name else shape[0]
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif "g_scale" in name:
            a = 1.0 + perturb * 0.1 * rng.standard_normal(shape)
        else:
            a = perturb * 0.1 * rng.standard_normal(shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def reference_lane_noise(seed, batch, image_shape, cut, K, draws=None):
    """The reference engine's draws for request ``PRNGKey(seed)``: x_T per
    image ("init", step 0), the server chain over positions [0, cut) and the
    client chain over [cut, K).  Adds to and returns ``draws``."""
    draws = {} if draws is None else draws
    k_init, k_srv, k_cli = jcf.lane_keys(jax.random.PRNGKey(seed), batch)
    for i in range(batch):
        draws[(seed, i, "init", 0)] = np.asarray(
            jax.random.normal(k_init[i], image_shape))
        for role, key, steps in (("server", k_srv[i], range(0, cut)),
                                 ("client", k_cli[i], range(cut, K))):
            for pos in steps:
                key, k_n = jax.random.split(key)
                draws[(seed, i, role, pos)] = np.asarray(
                    jax.random.normal(k_n, image_shape))
    return draws


def reference_chain_noise(key, n_steps, shape):
    """The batch-shaped draws of ``sample_range``/``sample_trajectory``
    from ``key``: step j's noise is ``normal(split(k)[1], shape)``."""
    out = []
    for _ in range(n_steps):
        key, k_n = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k_n, shape)))
    return out


# ---------------------------------------------------------------------------
# a tiny ε-model written alike in both frameworks (the serving tests' MLP)
# ---------------------------------------------------------------------------
def tiny_params(image_shape, seed, hidden=32):
    rng = np.random.default_rng(seed)
    d = int(np.prod(image_shape))
    return {"w1": (rng.standard_normal((d + 8, hidden)) / 6.0
                   ).astype(np.float32),
            "w2": (rng.standard_normal((hidden, d)) / 6.0).astype(np.float32)}


def tiny_apply_jax(p, x, t):
    import jax.numpy as jnp
    b = x.shape[0]
    freqs = jnp.exp(jnp.linspace(0.0, 3.0, 4))
    ang = t[:, None].astype(jnp.float32) * freqs[None]
    temb = jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], -1)
    h = jax.nn.silu(jnp.concatenate([x.reshape(b, -1), temb], -1) @ p["w1"])
    return (h @ p["w2"]).reshape(x.shape)


class TinyEps(torch.nn.Module):
    """:func:`tiny_apply_jax` as a module (NHWC in, NHWC out)."""

    def __init__(self, p):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.from_numpy(np.array(p["w1"])))
        self.w2 = torch.nn.Parameter(torch.from_numpy(np.array(p["w2"])))

    def forward(self, x, t):
        b = x.shape[0]
        freqs = torch.exp(torch.linspace(0.0, 3.0, 4, device=x.device))
        ang = t[:, None].to(torch.float32) * freqs[None]
        temb = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
        h = torch.nn.functional.silu(
            torch.cat([x.reshape(b, -1), temb], -1) @ self.w1)
        return (h @ self.w2).reshape(x.shape)


def lm_params(cfg, seed):
    """Reference LM params for ``cfg`` (a ``repro`` ModelConfig) drawn with
    numpy in the shapes of ``jax.eval_shape(tf.init_params)``: matrices
    scaled by the fan-in the reference's ``dense_init`` uses (the first
    axis; ``H·hd`` for the attention output map, ``d`` for the embedding;
    a stacked leaf's axis after its stacking: one for ``layers``,
    ``norms`` and ``rem``, two for ``groups``, one for the xLSTM groups'
    ``slstm`` and ``norms_s``; an expert's own fan-in, d for its (E, d, f)
    ``w_gate``/``w_up`` and f for its (E, f, d) ``w_down``), norm scales
    and the Mamba2 D near 1, A_log ~ 0.3·N(0, 1), the mLSTM's forget bias
    near its init's 3, and small biases, so every leaf's mapping is
    exercised.  float32 numpy leaves, for both packages."""
    from repro.models import transformer as jtf
    shapes = jax.eval_shape(lambda k: jtf.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    return _fill_params(shapes, seed)


def ssm_params(cfg, seed):
    """Reference Mamba2 params (``ssm_init``'s shapes) for ``cfg``, drawn
    as :func:`lm_params` draws a hybrid's Mamba2 leaves."""
    from repro.models import ssm as jssm
    shapes = jax.eval_shape(lambda k: jssm.ssm_init(k, cfg),
                            jax.random.PRNGKey(0))
    return _fill_params(shapes, seed)


def moe_params(cfg, seed):
    """Reference MoE params (``moe_init``'s shapes) for ``cfg``, drawn as
    :func:`lm_params` draws an MoE layer's leaves."""
    from repro.models import moe as jmoe
    shapes = jax.eval_shape(lambda k: jmoe.moe_init(k, cfg),
                            jax.random.PRNGKey(0))
    return _fill_params(shapes, seed)


def mla_params(cfg, seed):
    """Reference MLA params (``mla_init``'s shapes) for ``cfg``, drawn as
    :func:`lm_params` draws a layer's attention leaves."""
    from repro.models import attention as jattn
    shapes = jax.eval_shape(lambda k: jattn.mla_init(k, cfg),
                            jax.random.PRNGKey(0))
    return _fill_params(shapes, seed)


def cross_params(cfg, seed):
    """Reference cross-attention params (``cross_attention_init``'s
    shapes), drawn as :func:`lm_params` draws a layer's attention leaves."""
    from repro.models import attention as jattn
    shapes = jax.eval_shape(lambda k: jattn.cross_attention_init(k, cfg),
                            jax.random.PRNGKey(0))
    return _fill_params(shapes, seed)


def xlstm_params(kind, cfg, seed):
    """Reference ``mlstm_init`` or ``slstm_init`` params (``kind`` "mlstm"
    or "slstm") for ``cfg``, drawn as :func:`lm_params` draws a block's."""
    from repro.models import xlstm as jxl
    init = {"mlstm": jxl.mlstm_init, "slstm": jxl.slstm_init}[kind]
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    return _fill_params(shapes, seed)


_STACKED = {"layers": 1, "groups": 2, "rem": 1, "norms": 1}
# the xLSTM's sLSTM block and its norm stack once a group, (g, ...)
_STACKED_ONCE = ("slstm", "norms_s")
# the MoE experts' leaves, drawn at each expert's own fan-in
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _fill_params(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(getattr(p, "key", p)) for p in path]
        shape = leaf.shape
        axes = _STACKED.get(names[0], 0)
        if names[0] == "groups" and names[1] in _STACKED_ONCE:
            axes = 1
        core = shape[axes:]
        if names[-1] in ("scale", "norm_scale", "D"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif names[-1] == "A_log":
            a = 0.3 * rng.standard_normal(shape)
        elif names[-1] in ("dt_bias", "conv_b"):
            a = 0.1 * rng.standard_normal(shape)
        elif names[-1] == "f_bias":       # the mLSTM's forget gate, near 1
            a = 3.0 + 0.5 * rng.standard_normal(shape)
        else:
            fan_in = core[0]
            if names[-1] == "wo":
                fan_in = core[0] * core[1]
            elif names[-1] == "embedding":
                fan_in = core[-1]
            elif names[-1] in _EXPERT_LEAVES and len(core) == 3:
                fan_in = core[1]          # (E, d, f) / (E, f, d): d or f
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def reference_train_draws(seed, n_rounds, n_clients, b, image_shape, plan,
                          labeled=False, label_drop=0.0):
    """The reference trainer's draws (``repro/core/trainer.py:162,222-243``)
    for ``TrainerConfig(seed=seed)`` over ``n_rounds`` rounds of ``b``
    images a client, keyed as the port's training draw sources key them:
    (round, client, role).

    Its key chain starts at ``PRNGKey(seed + 17)`` and hands out one key a
    client, ``rng, k = split(rng)``: each round the server's keys first
    (when the cut leaves the server steps), then the clients'.  A server
    key splits as ``make_server_batch`` does (``collafuse.py:150``): t
    from {t_split+1..T}, eps, and on a labeled round the label drop; a
    client key as ``client_loss_fn`` (``collafuse.py:128-139``): on a
    labeled round ``k_drop, k_loss = split(key)`` first, then
    ``ddpm_loss``'s ``k_t, k_n = split``.  The masks exist only where
    ``label_drop`` > 0, as ``drop_labels`` draws nothing otherwise."""
    draws = {}
    rng = jax.random.PRNGKey(seed + 17)
    shape = (b,) + tuple(image_shape)
    drop = labeled and label_drop > 0.0

    def next_key():
        nonlocal rng
        rng, k = jax.random.split(rng)
        return k

    def put(rnd, k, side, k_t, k_n, lo, hi):
        draws[(rnd, k, side + "_t")] = np.asarray(
            jax.random.randint(k_t, (b,), lo, hi + 1))
        draws[(rnd, k, side + "_eps")] = np.asarray(
            jax.random.normal(k_n, shape, jax.numpy.float32))

    for rnd in range(n_rounds):
        if plan.n_server_steps > 0:
            for k, key in enumerate([next_key() for _ in range(n_clients)]):
                if labeled:
                    k_t, k_n, k_y = jax.random.split(key, 3)
                    if drop:
                        draws[(rnd, k, "server_drop")] = np.asarray(
                            jax.random.bernoulli(k_y, label_drop, (b,)))
                else:
                    k_t, k_n = jax.random.split(key)
                put(rnd, k, "server", k_t, k_n, *plan.server_range)
        if plan.n_client_steps > 0:
            for k, key in enumerate([next_key() for _ in range(n_clients)]):
                if labeled:
                    k_drop, key = jax.random.split(key)
                    if drop:
                        draws[(rnd, k, "client_drop")] = np.asarray(
                            jax.random.bernoulli(k_drop, label_drop, (b,)))
                k_t, k_n = jax.random.split(key)
                put(rnd, k, "client", k_t, k_n, *plan.client_range)
    return draws


def reference_disclosure_noise(key, seed, shape, n_steps, draws=None):
    """The reference's draws of ``disclosed_at_pos(..., key, x0, pos)`` on
    an (N, H, W, C) batch, keyed as the port's noise sources key them: it
    splits ``key`` into (k_n, k_s), draws x_T's ε for the whole batch from
    k_n, and the server chain from k_s as :func:`reference_chain_noise`.
    Image i's rows become (seed, i, "init", 0) and (seed, i, "server", j)
    for j < ``n_steps``.  Adds to and returns ``draws``."""
    draws = {} if draws is None else draws
    k_n, k_s = jax.random.split(key)
    eps = np.asarray(jax.random.normal(k_n, shape))
    chain = reference_chain_noise(k_s, n_steps, shape)
    for i in range(shape[0]):
        draws[(seed, i, "init", 0)] = eps[i]
        for j in range(n_steps):
            draws[(seed, i, "server", j)] = chain[j][i]
    return draws


# ---------------------------------------------------------------------------
# its class-conditional twin: a label embedding row per class and a null row
# (index n_classes) added to the time embedding, as the reference's
# classifier-free guidance gate builds its model (benchmarks/run.py)
# ---------------------------------------------------------------------------
def tiny_cond_params(image_shape, seed, n_classes=4, hidden=32):
    p = tiny_params(image_shape, seed, hidden)
    rng = np.random.default_rng(seed + 1000)
    p["yemb"] = (rng.standard_normal((n_classes + 1, 8)) / 2.0
                 ).astype(np.float32)
    return p


def tiny_cond_apply_jax(p, x, t, y=None):
    import jax.numpy as jnp
    b = x.shape[0]
    nc = p["yemb"].shape[0] - 1
    freqs = jnp.exp(jnp.linspace(0.0, 3.0, 4))
    ang = t[:, None].astype(jnp.float32) * freqs[None]
    temb = jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], -1)
    yc = (jnp.full((b,), nc, jnp.int32) if y is None
          else jnp.clip(y, 0, nc))
    temb = temb + jnp.asarray(p["yemb"])[yc]
    h = jax.nn.silu(jnp.concatenate([x.reshape(b, -1), temb], -1) @ p["w1"])
    return (h @ p["w2"]).reshape(x.shape)


class TinyCondEps(TinyEps):
    """:func:`tiny_cond_apply_jax` as a module; ``y=None`` is the null
    label."""

    def __init__(self, p):
        super().__init__(p)
        self.yemb = torch.nn.Parameter(torch.from_numpy(np.array(p["yemb"])))

    def forward(self, x, t, y=None):
        b = x.shape[0]
        nc = self.yemb.shape[0] - 1
        freqs = torch.exp(torch.linspace(0.0, 3.0, 4, device=x.device))
        ang = t[:, None].to(torch.float32) * freqs[None]
        temb = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
        yc = (torch.full((b,), nc, dtype=torch.int64, device=x.device)
              if y is None else torch.clamp(y.to(torch.int64), 0, nc))
        temb = temb + self.yemb[yc]
        h = torch.nn.functional.silu(
            torch.cat([x.reshape(b, -1), temb], -1) @ self.w1)
        return (h @ self.w2).reshape(x.shape)


def ep_emulation(data, model, train=False):
    """A stand-in for the reference's ``moe_forward`` that computes its
    expert-parallel semantics on one device, for a (data, model) mesh:
    with n tokens cut into data·model blocks of at least ``model`` tokens,
    each block through ``_moe_local`` at its own capacity (the all-to-all
    path; aux averaged over data shard 0's model blocks, which ``out_specs
    P()`` returns, or with ``train`` over every block, as a data-parallel
    step that averages each data rank's loss gives it); otherwise each data block (all tokens when n does not
    divide) through ``_moe_local`` at its capacity (the replicated path,
    whose ``keep & mine`` summed over ``model`` is ``keep``; aux data shard
    0's); the shared experts on every token.  E not dividing ``model`` or
    one model rank: the reference's own single-device path."""
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    orig = jmoe.moe_forward

    def moe_forward(x, p, cfg, ctx):
        b, s, d = x.shape
        n, e = b * s, cfg.n_experts
        if model == 1 or e % model:
            return orig(x, p, cfg, ctx)
        xf = x.reshape(n, d)
        if n % (data * model) == 0 and n // (data * model) >= model:
            blocks = data * model
            cap = jmoe._capacity(n // blocks, cfg.top_k, e,
                                 cfg.capacity_factor)
            res = [jmoe._moe_local(blk, p, cfg, cap)
                   for blk in jnp.split(xf, blocks)]
            first = blocks if train else model
            aux = sum(r[1] for r in res[:first]) / first
        else:
            blocks = data if n % data == 0 else 1
            cap = jmoe._capacity(n // blocks, cfg.top_k, e,
                                 cfg.capacity_factor)
            res = [jmoe._moe_local(blk, p, cfg, cap)
                   for blk in jnp.split(xf, blocks)]
            aux = res[0][1]
        out = jnp.concatenate([r[0] for r in res])
        if "shared" in p:
            out = out + jmoe._shared_expert(xf, p["shared"])
        return out.reshape(b, s, d), aux
    return moe_forward
