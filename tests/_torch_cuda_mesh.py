"""Ranks of the card's mesh tests in ``tests/test_torch_cuda.py``: two
processes on one card ("gloo+ipc", ``launch/mesh.py``'s ``run_ranks``), each
writing what it saw to ``<out>/rank<r>.pt``.  The port only."""
import os

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import close_mesh, init_mesh, run_ranks
from repro_torch.launch.steps import make_ctx
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf
from repro_torch.parallel import comm


def run(case: str, dims, out: str) -> list:
    """Run ``case`` on a mesh of ``dims`` on the card; the ranks'
    results."""
    run_ranks(_rank, dims[0] * dims[1], (case, dims, out), timeout_s=600)
    return [torch.load(os.path.join(out, f"rank{r}.pt"))
            for r in range(dims[0] * dims[1])]


def _rank(rank: int, port: int, case: str, dims, out: str) -> None:
    mesh = init_mesh(dims, rank, f"127.0.0.1:{port}", device_type="cuda")
    try:
        res = {"collectives": _collectives, "tp": _tp,
               "ep": _ep}[case](mesh)
        res["transport"] = mesh.transport
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        close_mesh(mesh)


def _collectives(mesh):
    """Every collective on CUDA tensors, checked against its values; then
    one whose ranks send different shapes, which must raise."""
    dev, r, n = mesh.device, mesh.coords["model"], mesh.shape["model"]
    comm.reset_stats()
    base = torch.arange(8, dtype=torch.float32, device=dev)
    ok = {}
    x = (base + r).to(torch.bfloat16)
    ok["all_reduce"] = torch.equal(
        comm.all_reduce(x, mesh, "model").float().cpu(),
        (n * base + sum(range(n))).cpu())
    ok["all_reduce_max"] = torch.equal(
        comm.all_reduce(base + r, mesh, "model", op="max").cpu(),
        (base + n - 1).cpu())
    g = comm.all_gather((base + 10 * r).reshape(2, 4), mesh, "model", 1)
    ok["all_gather"] = torch.equal(g.cpu(), torch.cat(
        [(base + 10 * i).reshape(2, 4) for i in range(n)], 1).cpu())
    rs = comm.reduce_scatter(base.reshape(4, 2), mesh, "model", 0)
    ok["reduce_scatter"] = torch.equal(
        rs.cpu(), (n * base.reshape(4, 2)).chunk(n)[r].cpu())
    a2a = comm.all_to_all(base + 100 * r, mesh, "model")
    ok["all_to_all"] = torch.equal(a2a.cpu(), torch.cat(
        [(base + 100 * i).chunk(n)[r] for i in range(n)]).cpu())
    b = comm.broadcast(base + r, mesh, "model")
    ok["broadcast"] = torch.equal(b.cpu(), base.cpu())
    ok["on_card"] = all(t.is_cuda for t in (g, rs, a2a, b))
    stats = dict(comm.STATS)
    # ranks that send tensors of different shapes raise on every rank
    try:
        comm.all_gather(torch.zeros(2 + r, device=dev), mesh, "model", 0)
        ok["shapes_differ_raises"] = False
    except RuntimeError:
        ok["shapes_differ_raises"] = True
    return {"ok": ok, "stats": stats}


def _model(mesh, arch):
    cfg = get_config(arch).reduced()
    ctx = make_ctx(mesh)
    whole = tf.init_params(cfg, seed=0, device=mesh.device)
    part = tf.init_params(cfg, seed=0, ctx=ctx)
    return cfg, ctx, whole, part


def _tp(mesh):
    """Yi's reduced member on the mesh and whole on the same card: prefill
    logits, a decode chain, the flash_attention launches."""
    cfg, ctx, whole, part = _model(mesh, "yi-6b")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g).cuda()
    with torch.inference_mode():
        ref = tf.prefill(whole, {"tokens": toks}, cfg)
        before = ops.flash_attention.launches
        got = tf.prefill(part, {"tokens": toks}, cfg, ctx=ctx)
        launches = ops.flash_attention.launches - before
        ca = tf.init_cache(cfg, 2, 8, device=mesh.device)
        cb = tf.init_cache(cfg, 2, 8, ctx=ctx)
        dec = []
        for pos in range(8):
            la, ca = tf.decode_step(whole, ca, {"tokens": toks[:, pos:pos + 1]},
                                    pos, cfg)
            lb, cb = tf.decode_step(part, cb, {"tokens": toks[:, pos:pos + 1]},
                                    pos, cfg, ctx=ctx)
            dec.append(float((la - lb).abs().max()))
    return {"prefill_err": float((ref - got).abs().max()),
            "decode_err": max(dec), "launches": launches,
            "local_heads": part.layers[0].attn.wq.shape[1]}


def _ep(mesh):
    """DeepSeek-V2's reduced member (dropless) with its experts over
    ``model``: the all-to-all prefill and the replicated decode against the
    whole model on the same card."""
    cfg, ctx, whole, part = _model(mesh, "deepseek-v2-236b")
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g).cuda()
    moe_mod.RECORD = []
    with torch.inference_mode():
        ref = tf.prefill(whole, {"tokens": toks}, cfg)
        got = tf.prefill(part, {"tokens": toks}, cfg, ctx=ctx)
        ca = tf.init_cache(cfg, 2, 4, device=mesh.device)
        cb = tf.init_cache(cfg, 2, 4, ctx=ctx)
        la, _ = tf.decode_step(whole, ca, {"tokens": toks[:, :1]}, 0, cfg)
        lb, _ = tf.decode_step(part, cb, {"tokens": toks[:, :1]}, 0, cfg,
                               ctx=ctx)
    paths = sorted({r[0] for r in moe_mod.RECORD})
    moe_mod.RECORD = None
    return {"prefill_err": float((ref - got).abs().max()),
            "decode_err": float((la - lb).abs().max()), "paths": paths,
            "experts": part.layers[0].moe.w_gate.shape[0]}
