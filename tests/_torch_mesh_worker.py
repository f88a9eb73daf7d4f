"""One rank of a CPU mesh for ``tests/test_torch_mesh.py``::

    python tests/_torch_mesh_worker.py --dims 2x2 --rank R --port P --dir D

Every rank of a (data, model) gloo world reads ``D/cases.json`` and the
whole state dicts the test wrote (``D/<state>.pt``), shards them over its
mesh and runs each case; rank 0 writes each case's outputs, gathered over
the data axes, to ``D/<world>/<case>.npz``.  The port only: no JAX here.
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch import train as lm_train
from repro_torch.launch.mesh import init_mesh, parse_mesh_shape
from repro_torch.launch.steps import (_average_over_data, make_ctx,
                                      make_train_step)
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd


def config(case):
    cfg = get_config(case["arch"]).reduced()
    return dataclasses.replace(cfg, **case.get("replace", {}))


def gather_rows(x, ctx, rows_sharded):
    if not rows_sharded:
        return x
    return comm.all_gather(x, ctx.mesh, ctx.batch_axes, 0)


def rows_sharded(b, ctx):
    return b % ctx.data_size == 0 and ctx.data_size > 1


def fill_cross_kv(model_full, cache, cond, ctx):
    """Each layer's cross_kv from the conditioning through the whole
    weights, cut to this rank's slice of the cache (the specs of the whole
    cache's shapes)."""
    cfg = model_full.cfg
    specs = shd.cache_specs(tf._cache_tree(cfg, cond.shape[0], 1, 0,
                                           torch.device("meta")), ctx)
    with torch.inference_mode():
        for layer, c, sp in zip(model_full.layers, cache["layers"],
                                specs["layers"]):
            for n, w in (("k", layer.cross.wk), ("v", layer.cross.wv)):
                full = layer.cross.project(cond, w)
                t = c["cross_kv"][n]
                t.copy_(full[shd.shard_slices(full.shape,
                                              sp["cross_kv"][n], ctx.mesh)])


def run_lm(case, state, ctx, out):
    cfg = config(case)
    toks = torch.from_numpy(np.asarray(case["tokens"])).long()
    b, s = toks.shape
    model = tf.shard_model(tf.Transformer(cfg, device="meta"), ctx)
    tf.load_full_(model, state)
    model.eval()
    batch = {"tokens": toks}
    extra = {}
    for k in ("vision_embeds", "cond_embeds"):
        if k in case:
            extra[k] = torch.from_numpy(np.asarray(case[k], np.float32))
    batch.update(extra)
    rows = rows_sharded(b, ctx)
    moe_mod.RECORD = []
    if case.get("prefill", True):
        with torch.inference_mode():
            logits, aux = tf.forward_with_aux(model, batch, cfg, ctx=ctx,
                                              kernel=case.get("kernel",
                                                              "flash"))
        out["prefill"] = gather_rows(logits, ctx, rows).numpy()
        out["aux"] = aux["moe_aux"].numpy()
    paths = [r[0] for r in moe_mod.RECORD]
    out["prefill_paths"] = np.array(paths or ["none"])
    moe_mod.RECORD = []
    if case.get("decode", True):
        cache = tf.init_cache(cfg, b, s, ctx=ctx)
        if "cond_embeds" in extra:
            full = tf.Transformer(cfg, device="cpu")
            full.load_state_dict(state)
            fill_cross_kv(full, cache, extra["cond_embeds"], ctx)
        steps = []
        with torch.inference_mode():
            for pos in range(s):
                lg, cache = tf.decode_step(model, cache,
                                           {"tokens": toks[:, pos:pos + 1]},
                                           pos, cfg, ctx=ctx)
                steps.append(gather_rows(lg[:, 0], ctx, rows))
        out["decode"] = torch.stack(steps, 1).numpy()
    out["decode_paths"] = np.array(
        sorted({r[0] for r in moe_mod.RECORD}) or ["none"])
    moe_mod.RECORD = None
    if cfg.family == "hybrid":
        layer = tf.init_cache(cfg, b, s, ctx=ctx)["groups"][0]["ssm"][0]
        out["conv_local_shape"] = np.array(layer["conv"].shape)
        out["state_local_shape"] = np.array(layer["state"].shape)
    elif cfg.family != "ssm":
        out["kv_local_shape"] = np.array(
            tf.init_cache(cfg, b, s, ctx=ctx)["layers"][-1][
                "c_kv" if cfg.attn_type == "mla" else "k"].shape)


def run_train(case, state, ctx, out, world_dir):
    cfg = config(case)
    model = tf.shard_model(tf.Transformer(cfg, device="meta"), ctx,
                           fsdp=case["fsdp"])
    tf.load_full_(model, state)
    toks = torch.from_numpy(np.asarray(case["tokens"])).long()
    labels = torch.from_numpy(np.asarray(case["labels"])).long()
    batch = {"tokens": toks, "labels": labels}
    # the gradients at the first weights, averaged over the data axes
    loss, _ = tf.lm_loss(model, batch, cfg, ctx=ctx)
    loss.backward()
    params = dict(model.named_parameters())
    grads = _average_over_data(params, ctx)
    for n, g in grads.items():
        out["grad." + n] = tf.gather_full(g, model.param_specs[n],
                                          ctx.mesh).numpy()
        params[n].grad = None
    opt_cfg = adamw.AdamWConfig(lr=case["lr"])
    opt = adamw.init_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, ctx=ctx)
    losses, norms = [], []
    for _ in range(case["steps"]):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["loss"] = np.array(losses)
    out["grad_norm"] = np.array(norms)
    for n, t in tf.full_state(model, ctx).items():
        out["param." + n] = t.numpy()
    # the launcher's checkpoint, gathered and written by rank 0
    lm_train.save_state(os.path.join(world_dir, case["name"] + ".ckpt.npz"),
                        model, opt, ctx)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    dims = parse_mesh_shape(args.dims)
    mesh = init_mesh(dims, args.rank, f"127.0.0.1:{args.port}",
                     device_type="cpu", timeout_s=300)
    world_dir = os.path.join(args.dir, args.dims)
    os.makedirs(world_dir, exist_ok=True)
    with open(os.path.join(args.dir, "cases.json")) as f:
        cases = json.load(f)
    states = {}
    for case in cases:
        if args.dims not in case.get("worlds", [args.dims]):
            continue
        ctx = make_ctx(mesh, seq_shard_attn=case.get("seq_shard_attn",
                                                     False),
                       cache_seq_shard=case.get("cache_seq_shard", False))
        key = case["state"]
        if key not in states:
            states[key] = torch.load(os.path.join(args.dir, key + ".pt"))
        out = {}
        if case["kind"] == "train":
            run_train(case, states[key], ctx, out, world_dir)
        else:
            run_lm(case, states[key], ctx, out)
        if args.rank == 0:
            np.savez(os.path.join(world_dir, case["name"] + ".npz"), **out)
    comm.barrier(mesh)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
