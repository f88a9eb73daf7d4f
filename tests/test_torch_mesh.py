"""The port on (data, model) meshes of gloo processes on the CPU, against
the reference on the same numpy weights (float32, ``reduced()``).

One module fixture writes every case's whole state dict and inputs, then
starts a 1x2 and a 2x2 world at once (``tests/_torch_mesh_worker.py``, a
process a rank, one thread each); each world runs every case and writes
its outputs.  Each case is its own test: the sharded prefill logits and
teacher-forced decode chains against the reference's unsharded
``prefill`` and decode chain (``test_torch_transformer.py``'s tolerance);
tensor parallelism with the KV heads sharded, whole (sliced by slice and
by index) and the heads not dividing the axis (replicated, and
``qshard_attention``); DeepSeek-V2's MLA and both expert-parallel paths
(dropless, and dropping at ``capacity_factor`` 1.0 against the
reference's EP semantics, :func:`_torch_parity.ep_emulation`, which
``test_reference_ep_and_qshard_match_the_emulation`` holds against the
reference's real ``shard_map`` paths); Kimi-K2, Qwen2-VL and MusicGen;
``cache_seq_shard`` decode chains; Zamba2 and xLSTM on every world (their
Mamba2 and mLSTM heads a rank, the sLSTM replicated) and with heads that
do not divide the model axis; 3 train steps (Yi on 2x2 with and without
FSDP and with its KV heads sliced on 1x2, Zamba2 on 2x1 with FSDP and on
1x2, xLSTM on 1x2 and on 2x2 with FSDP, both with heads that do not
divide the axis on 1x2, DeepSeek-V2 on 1x2 and 2x2 dropless and dropping:
loss and
grad_norm against the one-rank port, which for an MoE runs the mesh's
expert-parallel semantics a block at a time, the gradients against
``jax.value_and_grad`` of the reference's ``lm_loss``, for an MoE under
``ep_emulation(train=True)``) and the mesh's checkpoint restored on one
rank.  In process: a 1x1 mesh is bitwise no
mesh."""
import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (ep_emulation, lm_params, np_tree,  # noqa: E402
                           set_torch_cpu)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.launch.steps import (make_ctx, make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step)
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.comm import Mesh  # noqa: E402

set_torch_cpu()

REPO = Path(__file__).resolve().parents[1]
WORLDS = {"1x2": (1, 2), "2x2": (2, 2), "2x1": (2, 1)}
B, S = 2, 8
LOGIT_ATOL = 2e-4
TRAIN = dict(steps=3, lr=3e-3, batch=4)

# 15 Mamba2 heads of 32 and 3 attention heads: neither divides model 2
ZAMBA2_ODD = dict(d_model=240, ssm_heads=15, n_heads=3, n_kv_heads=3)
# name -> (arch, config fields replaced, extra case fields)
LM_CASES = {
    "yi": ("yi-6b", {}, {}),
    "yi-kv1": ("yi-6b", dict(n_heads=8, n_kv_heads=1, head_dim=32), {}),
    "yi-kv3": ("yi-6b", dict(n_heads=6, n_kv_heads=3, head_dim=32), {}),
    "minicpm-h3": ("minicpm-2b", dict(n_heads=3, n_kv_heads=3,
                                      vocab_size=509), {}),
    "minicpm-qshard": ("minicpm-2b", dict(n_heads=3, n_kv_heads=3),
                       dict(seq_shard_attn=True, decode=False)),
    "deepseek": ("deepseek-v2-236b", {}, {}),
    "deepseek-drop": ("deepseek-v2-236b", dict(capacity_factor=1.0), {}),
    "kimi": ("kimi-k2-1t-a32b", {}, {}),
    "qwen2-vl": ("qwen2-vl-2b", {}, {}),
    "musicgen": ("musicgen-large", {}, {}),
    "yi-cseq": ("yi-6b", {}, dict(cache_seq_shard=True, prefill=False)),
    "deepseek-cseq": ("deepseek-v2-236b", {},
                      dict(cache_seq_shard=True, prefill=False)),
    "musicgen-cseq": ("musicgen-large", {},
                      dict(cache_seq_shard=True, prefill=False)),
    # the recurrent families: data-only, their heads a rank, and heads
    # that do not divide the model axis (run replicated)
    "zamba2": ("zamba2-7b", {}, dict(worlds=["2x1", "1x2", "2x2"])),
    "xlstm": ("xlstm-125m", {}, dict(worlds=["2x1", "1x2", "2x2"])),
    "zamba2-h15": ("zamba2-7b", ZAMBA2_ODD, {}),
    "xlstm-h1": ("xlstm-125m", dict(n_heads=1, n_kv_heads=1), {}),
}
# name -> (arch, fsdp, world, config fields replaced)
TRAIN_CASES = {
    "train": ("yi-6b", False, "2x2", {}),
    "train-fsdp": ("yi-6b", True, "2x2", {}),
    "train-zamba2-fsdp": ("zamba2-7b", True, "2x1", {}),
    # the recurrent families on a model axis: B/C and the conv's B/C
    # columns, the summed norm statistics, the mLSTM's gathered u
    "train-zamba2-1x2": ("zamba2-7b", False, "1x2", {}),
    "train-xlstm-1x2": ("xlstm-125m", False, "1x2", {}),
    "train-xlstm-fsdp-2x2": ("xlstm-125m", True, "2x2", {}),
    "train-zamba2-h15": ("zamba2-7b", False, "1x2", ZAMBA2_ODD),
    "train-xlstm-h1": ("xlstm-125m", False, "1x2",
                       dict(n_heads=1, n_kv_heads=1)),
    # KV 1 on model 2: wk/wv replicated, each rank slicing its KV head
    "train-yi-kv1": ("yi-6b", False, "1x2",
                     dict(n_heads=8, n_kv_heads=1, head_dim=32)),
    # the all-to-all path's backward: the reverse exchange, aux over model
    "train-deepseek": ("deepseek-v2-236b", False, "1x2", {}),
    "train-deepseek-2x2": ("deepseek-v2-236b", False, "2x2", {}),
    "train-deepseek-drop": ("deepseek-v2-236b", False, "1x2",
                            dict(capacity_factor=1.0)),
    "train-deepseek-drop-fsdp": ("deepseek-v2-236b", True, "2x2",
                                 dict(capacity_factor=1.0)),
}

# the recurrent families' train cases on a model axis
RECURRENT_TP = ("train-zamba2-1x2", "train-xlstm-1x2", "train-xlstm-fsdp-2x2",
                "train-zamba2-h15", "train-xlstm-h1")


def _cfgs(arch, replace):
    return (dataclasses.replace(jget_config(arch).reduced(), **replace),
            dataclasses.replace(get_config(arch).reduced(), **replace))


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """(reference cfg, port cfg, numpy tree, batch of numpy arrays)."""
    if name in TRAIN_CASES:
        arch, _, _, replace = TRAIN_CASES[name]
        jcfg, tcfg = _cfgs(arch, replace)
        rng = np.random.default_rng(7)
        toks = rng.integers(0, tcfg.vocab_size, (TRAIN["batch"], S))
        return jcfg, tcfg, lm_params(jcfg, 0), {
            "tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    arch, replace, _ = LM_CASES[name]
    jcfg, tcfg = _cfgs(arch, replace)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (B, S))}
    if tcfg.family == "vlm":
        batch["vision_embeds"] = (0.5 * rng.standard_normal(
            (B, tcfg.n_vision_tokens, tcfg.d_model))).astype(np.float32)
    if tcfg.family == "audio":
        batch["cond_embeds"] = (0.5 * rng.standard_normal(
            (B, tcfg.n_cond_tokens, tcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, lm_params(jcfg, 0), batch


def _state_key(name):
    if name in TRAIN_CASES:
        arch, _, _, replace = TRAIN_CASES[name]
    else:
        arch, replace, _ = LM_CASES[name]
    return arch + "".join(f"-{k}{v}" for k, v in sorted(replace.items()))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Write the cases, start both worlds and the reference's EP
    subprocess, compute the reference's outputs meanwhile, wait; {world:
    (output dir, a failed rank's stderr or None), "ep": the subprocess's
    (returncode, stdout, stderr)}."""
    root = tmp_path_factory.mktemp("mesh")
    cases = []
    for name in [*LM_CASES, *TRAIN_CASES]:
        _, _, tree, batch = _inputs(name)
        key = _state_key(name)
        if not (root / f"{key}.pt").exists():
            torch.save(ttf.params_from_jax(tree), root / f"{key}.pt")
        if name in TRAIN_CASES:
            arch, fsdp, world, replace = TRAIN_CASES[name]
            case = dict(kind="train", arch=arch, fsdp=fsdp, worlds=[world],
                        replace=replace,
                        **{k: TRAIN[k] for k in ("steps", "lr")})
        else:
            arch, replace, extra = LM_CASES[name]
            case = dict(kind="lm", arch=arch, replace=replace,
                        **{"worlds": _worlds_of(name), **extra})
        case.update(name=name, state=key,
                    **{k: v.tolist() for k, v in batch.items()})
        cases.append(case)
    (root / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = {}
    for world, dims in WORLDS.items():
        port = _free_port()
        procs[world] = [subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_torch_mesh_worker.py"),
             "--dims", world, "--rank", str(r), "--port", str(port),
             "--dir", str(root)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
            for r in range(int(np.prod(dims)))]
    ep = subprocess.Popen([sys.executable, "-c", EP_SCRIPT.replace(
        "TESTS", repr(str(REPO / "tests")))], env=dict(
            os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    for name in LM_CASES:
        for world in _worlds_of(name):
            _reference(name, world)
    deadline = time.monotonic() + 420
    errors = {}
    for world, ps in procs.items():
        for p in ps:
            try:
                _, err = p.communicate(timeout=max(1.0, deadline -
                                                   time.monotonic()))
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, 9)
                _, err = p.communicate()
            if p.returncode:
                errors[world] = err[-3000:]
    try:
        ep_out = ep.communicate(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        os.killpg(ep.pid, 9)
        ep_out = ep.communicate()
    return {**{w: (root / w, errors.get(w)) for w in WORLDS},
            "ep": (ep.returncode, *ep_out)}


def _out(worlds, world, name):
    path, err = worlds[world]
    assert err is None, err
    return np.load(path / f"{name}.npz")


def _jbatch(batch):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(name, world):
    """The reference's prefill logits and decode chain for a case, under
    its EP semantics on ``world`` when the case drops tokens (the same for
    both worlds otherwise)."""
    jcfg, _, tree, batch = _inputs(name)
    first = _worlds_of(name)[0]
    if not (jcfg.family == "moe" and jcfg.capacity_factor < jcfg.n_experts) \
            and world != first:
        return _reference(name, first)
    jp = jax.tree.map(jnp.asarray, tree)
    dims = WORLDS[world]
    old = jmoe.moe_forward
    if jcfg.family == "moe" and jcfg.capacity_factor < jcfg.n_experts:
        jmoe.moe_forward = ep_emulation(*dims)
    try:
        prefill = np.asarray(jtf.prefill(jp, _jbatch(batch), jcfg))
        cache = jtf.init_cache(jcfg, B, S)
        if jcfg.family == "audio":
            lp = jp["layers"]["cross"]
            cond = jnp.asarray(batch["cond_embeds"])
            cache["layers"]["cross_kv"] = {
                n: jnp.einsum("bcd,ldhk->lbchk", cond, lp[w])
                for n, w in (("k", "wk"), ("v", "wv"))}
        dec = jax.jit(lambda p, c, t, pos: jtf.decode_step(
            p, c, {"tokens": t}, pos, jcfg))
        toks = batch["tokens"].astype(np.int32)
        chain = []
        for pos in range(S):
            lg, cache = dec(jp, cache, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.int32(pos))
            chain.append(np.asarray(lg[:, 0]))
    finally:
        jmoe.moe_forward = old
    return prefill, np.stack(chain, axis=1)


def _worlds_of(name):
    return LM_CASES[name][2].get("worlds", ["1x2", "2x2"])


@pytest.mark.parametrize("name,world", [(n, w) for n in LM_CASES
                                        for w in _worlds_of(n)])
def test_mesh_matches_reference(worlds, name, world):
    out = _out(worlds, world, name)
    prefill, chain = _reference(name, world)
    extra = LM_CASES[name][2]
    if extra.get("prefill", True):
        np.testing.assert_allclose(out["prefill"], prefill, rtol=0,
                                   atol=LOGIT_ATOL)
    if extra.get("decode", True):
        np.testing.assert_allclose(out["decode"], chain, rtol=0,
                                   atol=LOGIT_ATOL)
    arch = LM_CASES[name][0]
    d, m = WORLDS[world]
    if name == "zamba2":
        # a rank's heads' state and its own conv channels [x_r, B, C]
        cfg = _inputs(name)[1]
        assert tuple(out["state_local_shape"]) == (
            B // d, cfg.ssm_heads // m, cfg.ssm_state, cfg.ssm_head_dim)
        assert tuple(out["conv_local_shape"]) == (
            B // d, cfg.conv_width - 1,
            cfg.d_inner_ssm // m + 2 * cfg.ssm_state)
    if name == "zamba2-h15":
        cfg = _inputs(name)[1]                          # whole, replicated
        assert tuple(out["conv_local_shape"])[2] == \
            cfg.d_inner_ssm + 2 * cfg.ssm_state
    if arch in ("zamba2-7b", "xlstm-125m"):
        return
    if arch in ("deepseek-v2-236b", "kimi-k2-1t-a32b"):
        if extra.get("prefill", True):
            assert set(out["prefill_paths"]) == {"all_to_all"}
        assert set(out["decode_paths"]) == {"replicated"}
    kv = tuple(out["kv_local_shape"])
    if name == "yi":
        assert kv == (B // d, S, 4 // m, 64)            # KV heads sharded
    if name in ("yi-cseq", "deepseek-cseq"):
        assert kv[:2] == (B // d, S // m)               # the sequence
    if name == "yi-kv1":
        assert kv == (B // d, S, 1, 32)                 # whole, replicated


def test_mesh_aux_matches_the_reference_ep_aux(worlds):
    """On 1x2 (one data shard) the aux loss of a dropping run is the
    reference's: the mean over ``model`` of each block's."""
    out = _out(worlds, "1x2", "deepseek-drop")
    jcfg, _, tree, batch = _inputs("deepseek-drop")
    old = jmoe.moe_forward
    jmoe.moe_forward = ep_emulation(1, 2)
    try:
        _, aux = jtf.forward(jax.tree.map(jnp.asarray, tree), _jbatch(batch),
                             jcfg)
    finally:
        jmoe.moe_forward = old
    np.testing.assert_allclose(out["aux"], float(aux["moe_aux"]), rtol=1e-5)


def _port_ep_emulation(data, model):
    """The port's ``moe_forward`` under the mesh's expert-parallel training
    semantics on one process: the tokens cut into data·model blocks, each
    through ``moe_local`` at its own capacity, the aux averaged over every
    block (each data rank's over ``model``, the metrics over ``data``),
    the shared experts on every token."""
    def moe_forward(x, p, cfg, ctx=None):
        b, s, d = x.shape
        n, blocks = b * s, data * model
        assert n % blocks == 0 and n // blocks >= model
        xf = x.reshape(n, d)
        cap = tmoe.capacity(n // blocks, cfg.top_k, cfg.n_experts,
                            cfg.capacity_factor)
        res = [tmoe.moe_local(blk, p, cfg, cap) for blk in xf.chunk(blocks)]
        out = torch.cat([r[0] for r in res])
        if p.shared is not None:
            out = out + tmoe.shared_expert(xf, p.shared)
        return out.reshape(b, s, d), sum(r[1] for r in res) / blocks
    return moe_forward


def _one_rank_train(name):
    jcfg, tcfg, tree, batch = _inputs(name)
    if tcfg.family == "moe":
        old = tmoe.moe_forward
        tmoe.moe_forward = _port_ep_emulation(*WORLDS[TRAIN_CASES[name][2]])
        try:
            return _one_rank_train_plain(tcfg, tree, batch)
        finally:
            tmoe.moe_forward = old
    return _one_rank_train_plain(tcfg, tree, batch)


def _one_rank_train_plain(tcfg, tree, batch):
    model = ttf.Transformer(tcfg, device="cpu")
    model.load_state_dict(ttf.params_from_jax(tree))
    opt_cfg = adamw.AdamWConfig(lr=TRAIN["lr"])
    opt = adamw.init_state(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(tcfg, opt_cfg)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(TRAIN["steps"]):
        model, opt, m = step(model, opt, tb)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return np.array(losses), np.array(norms)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_mesh_train_matches_one_rank_and_reference(worlds, name):
    out = _out(worlds, TRAIN_CASES[name][2], name)
    losses, norms = _one_rank_train(name)
    np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
    if name in RECURRENT_TP:
        # the first step's grad_norm at 1e-5; AdamW's normalised update
        # turns the ~1e-6 relative rounding of the sharded sums into up
        # to lr on gradient entries near zero, so later steps drift
        # (6e-4 by step 3 at lr 3e-3, 3e-6 at lr 3e-4)
        np.testing.assert_allclose(out["grad_norm"][0], norms[0], rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-3)
    else:
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-5)
    assert out["loss"][-1] < out["loss"][0]
    jcfg, _, tree, batch = _inputs(name)
    jb = _jbatch(batch)
    old = jmoe.moe_forward
    if jcfg.family == "moe":
        jmoe.moe_forward = ep_emulation(*WORLDS[TRAIN_CASES[name][2]],
                                        train=True)
    try:
        (_, _), grads = jax.value_and_grad(
            lambda p: jtf.lm_loss(p, jb, jcfg), has_aux=True)(
                jax.tree.map(jnp.asarray, tree))
    finally:
        jmoe.moe_forward = old
    want = ttf.params_from_jax(np_tree(grads))
    for n, g in want.items():
        g = g.numpy()
        np.testing.assert_allclose(out["grad." + n], g, rtol=0,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=n)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_mesh_checkpoint_restores_bitwise_on_one_rank(worlds, name):
    world = TRAIN_CASES[name][2]
    out = _out(worlds, world, name)
    _, tcfg, _, _ = _inputs(name)
    model = ttf.Transformer(tcfg, device="cpu")
    opt = adamw.init_state(dict(model.named_parameters()),
                           adamw.AdamWConfig())
    lm_train.restore_state(str(worlds[world][0] / f"{name}.ckpt.npz"),
                           model, opt)
    assert int(opt["step"]) == TRAIN["steps"]
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      out["param." + n], err_msg=n)


def _mesh_1x1():
    return Mesh(shape={"data": 1, "model": 1},
                coords={"data": 0, "model": 0}, device=torch.device("cpu"),
                transport="gloo")


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v2-236b"])
def test_one_by_one_mesh_is_bitwise_no_mesh(arch):
    """Prefill, a decode chain and 2 train steps (FSDP on) on a 1x1 mesh
    equal the paths without a mesh bit for bit."""
    jcfg, tcfg = _cfgs(arch, {})
    tree = lm_params(jcfg, 0)
    ctx = make_ctx(_mesh_1x1())
    plain = ttf.Transformer(tcfg, device="cpu")
    plain.load_state_dict(ttf.params_from_jax(tree))
    sharded = ttf.shard_model(ttf.Transformer(tcfg, device="meta"), ctx,
                              fsdp=True)
    ttf.load_full_(sharded, ttf.params_from_jax(tree))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, S))).long()
    a = make_prefill_step(tcfg)(plain, {"tokens": toks})
    b = make_prefill_step(tcfg, ctx=ctx)(sharded, {"tokens": toks})
    assert torch.equal(a, b)
    ca = ttf.init_cache(tcfg, B, S, device="cpu")
    cb = ttf.init_cache(tcfg, B, S, ctx=ctx)
    da, db = make_decode_step(tcfg), make_decode_step(tcfg, ctx=ctx)
    for pos in range(S):
        la, ca = da(plain, ca, {"tokens": toks[:, pos:pos + 1]}, pos)
        lb, cb = db(sharded, cb, {"tokens": toks[:, pos:pos + 1]}, pos)
        assert torch.equal(la, lb)
    opt_cfg = adamw.AdamWConfig(lr=3e-3)
    oa = adamw.init_state(dict(plain.named_parameters()), opt_cfg)
    ob = adamw.init_state(dict(sharded.named_parameters()), opt_cfg)
    sa = make_train_step(tcfg, opt_cfg)
    sb = make_train_step(tcfg, opt_cfg, ctx=ctx)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    for _ in range(2):
        _, _, ma = sa(plain, oa, batch)
        _, _, mb = sb(sharded, ob, batch)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for (n, p), (_, q) in zip(plain.named_parameters(),
                              sharded.named_parameters()):
        assert torch.equal(p, q), n


def test_init_params_on_a_mesh_draws_the_one_card_weights():
    """Each rank's slice of a model drawn on a mesh is the slice of the
    one-card model drawn from the same seed (a 1x2 and a 2x2 rank's
    coordinates, no process group: the draw runs no collective)."""
    tcfg = get_config("deepseek-v2-236b").reduced()
    whole = ttf.init_params(tcfg, seed=5, device="cpu")
    full = dict(whole.named_parameters())
    for dims, coords in (((1, 2), {"data": 0, "model": 1}),
                         ((2, 2), {"data": 1, "model": 0})):
        mesh = Mesh(shape=dict(zip(("data", "model"), dims)), coords=coords,
                    device=torch.device("cpu"))
        part = ttf.init_params(tcfg, seed=5, ctx=make_ctx(mesh), fsdp=True)
        for n, p in part.named_parameters():
            want = full[n][p.shard_slices] if hasattr(p, "shard_slices") \
                else full[n]
            assert torch.equal(p, want), n


def test_hybrid_and_ssm_refuse_a_model_axis():
    """They no longer refuse one: a rank's cache on a 1x2 mesh holds its
    Mamba2 heads' state and conv channels [x_r, B, C], its mLSTM heads'
    state and norm, and the sLSTM's whole (B, d) carries; a rank's model
    holds the specs' slices (no process group: neither runs a
    collective)."""
    mesh = Mesh(shape={"data": 1, "model": 2}, coords={"data": 0,
                                                        "model": 1},
                device=torch.device("cpu"))
    ctx = make_ctx(mesh)
    cfg = get_config("zamba2-7b").reduced()
    layer = ttf.init_cache(cfg, 2, 8, ctx=ctx)["groups"][0]["ssm"][0]
    assert layer["state"].shape == (2, cfg.ssm_heads // 2, cfg.ssm_state,
                                    cfg.ssm_head_dim)
    assert layer["conv"].shape == (2, cfg.conv_width - 1,
                                   cfg.d_inner_ssm // 2 + 2 * cfg.ssm_state)
    model = ttf.init_params(cfg, seed=1, ctx=ctx)
    ssm = model.groups[0][0].ssm
    assert ssm.w_x.shape[1] == cfg.d_inner_ssm // 2
    assert ssm.conv_w.shape[1] == (cfg.d_inner_ssm + 2 * cfg.ssm_state) // 2
    assert ssm.w_B.shape == (cfg.d_model, cfg.ssm_state)
    cfg = get_config("xlstm-125m").reduced()
    cache = ttf.init_cache(cfg, 2, 8, ctx=ctx)["groups"][0]
    hd = 2 * cfg.d_model // cfg.n_heads
    assert cache["mlstm"][0]["state"].shape == (2, cfg.n_heads // 2, hd, hd)
    assert cache["mlstm"][0]["norm"].shape == (2, cfg.n_heads // 2, hd)
    assert cache["slstm"]["m"].shape == (2, cfg.d_model)
    assert torch.all(cache["slstm"]["m"] == -1e9)


EP_SCRIPT = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, TESTS)
from _torch_parity import ep_emulation, moe_params
from repro.configs import get_config
from repro.launch.mesh import make_mesh, mesh_context
from repro.models import attention as jattn, moe as jmoe
from repro.models.layers import ShardCtx
assert len(jax.devices()) == 4
mesh = make_mesh((1, 4), ("data", "model"))
ctx = ShardCtx(mesh=mesh)
cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                          n_experts=8, capacity_factor=1.0)
p = jax.tree.map(jnp.asarray, moe_params(cfg, 0))
emulate = ep_emulation(1, 4)
rng = np.random.default_rng(0)
for n_tok in (64, 2):
    x = jnp.asarray(rng.standard_normal((1, n_tok, cfg.d_model)),
                    jnp.float32)
    with mesh_context(mesh):
        out, aux = jax.jit(lambda x, p: jmoe.moe_forward(x, p, cfg, ctx))(
            x, p)
    want, want_aux = emulate(x, p, cfg, ctx)
    whole, _ = jmoe.moe_forward(x, p, cfg, ShardCtx())
    assert float(jnp.abs(out - want).max()) < 1e-5, n_tok
    assert abs(float(aux) - float(want_aux)) < 1e-6, n_tok
    if n_tok == 64:       # blocks drop what the whole batch keeps
        assert float(jnp.abs(whole - want).max()) > 1e-3
q = jnp.asarray(rng.standard_normal((2, 64, 3, 16)), jnp.float32)
k = jnp.asarray(rng.standard_normal((2, 64, 3, 16)), jnp.float32)
v = jnp.asarray(rng.standard_normal((2, 64, 3, 16)), jnp.float32)
sctx = ShardCtx(mesh=mesh, seq_shard_attn=True)
for window in (0, 24):
    with mesh_context(mesh):
        got = jax.jit(lambda q, k, v: jattn.qshard_attention(
            q, k, v, sctx, causal=True, window=window))(q, k, v)
    want = jattn.blockwise_attention(q, k, v, causal=True, window=window)
    assert float(jnp.abs(got - want).max()) < 1e-5, window
print("EP-OK")
"""


def test_reference_ep_and_qshard_match_the_emulation(worlds):
    """The reference's real ``shard_map`` EP paths on a 1x4 mesh of forced
    host devices (E 8, dropping at capacity_factor 1.0, 64 tokens through
    the all-to-all path and 2 through the replicated one) equal
    :func:`_torch_parity.ep_emulation`, and its ``qshard_attention`` equals
    its blockwise attention, full and windowed (a subprocess the fixture
    starts beside the worlds)."""
    rc, out, err = worlds["ep"]
    assert rc == 0, err[-3000:]
    assert "EP-OK" in out
