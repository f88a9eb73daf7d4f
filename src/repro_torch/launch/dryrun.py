"""Dry run for H100 nodes: one rank's step of every (arch × shape × mesh)
combination, counted on the meta device (counterpart of
``repro/launch/dryrun.py``)::

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    python -m repro_torch.launch.dryrun --sweep --mesh single

The reference lowers and compiles each step on 256 or 512 forced host
devices and reads XLA's cost and memory analyses.  The port runs eagerly,
so it runs instead: rank 0 of the production mesh (``launch/mesh.py``
``make_production_mesh``: ``--nodes`` nodes of 8 cards on ``model``, and
with ``--mesh multi`` two pods) holds its shards of the full config on
the meta device (``tf.init_params(ctx=...)``, ``tf.init_cache(ctx=...)``,
``launch/specs.py``'s batch), and its real train, prefill or decode step
(``launch/steps.py``, with the levers) runs under
:class:`~repro_torch.launch.counter.WorkCounter` on a dry mesh
(:meth:`~repro_torch.parallel.comm.Mesh.dry`), whose collectives return
meta tensors and are recorded.  Nothing is computed and no device memory
is allocated, so the dry run runs on any machine and touches no card: the
rule that the port's entry points run on the card does not bind it, as
the reference's dry run runs on CPU host devices.

Per combo this writes ``results/dryrun_torch/<arch>__<shape>__<mesh>
[__tag].json``:

* ``full``: the full-depth step's counted FLOPs, bytes, transcendentals,
  kernels (one unit a wrapper call), collectives, and ``memory``
  (``argument_bytes``: the rank's params, optimizer state, cache and
  batch; ``output_bytes``; ``temp_bytes``: the most live at once beyond
  the arguments; ``alias_bytes``: the arguments written in place; and
  ``code_bytes`` 0: nothing is compiled);
* ``probes``: 1- and 2-unit steps (``roofline.probe_units``), scaled to
  the full depth (``scaled``);
* ``roofline``: the three time terms on H100 cards, the dominant one and
  the useful-FLOPs ratio (``roofline.roofline_terms``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional, Union

import torch

from repro_torch.configs import (INPUT_SHAPES, InputShape, get_config,
                                 list_archs)
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as sp
from repro_torch.launch.counter import WorkCounter, nbytes
from repro_torch.launch.mesh import (axes_for, make_production_mesh,
                                     parse_mesh_shape)
from repro_torch.launch.steps import (make_ctx, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.parallel import comm
from repro_torch.parallel.comm import Mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def dry_mesh(name: str, nodes: int = 32, rank: int = 0) -> Mesh:
    """Rank ``rank`` of a dry mesh: "single" (``nodes`` x 8), "multi" (2 x
    ``nodes`` x 8) or a shape "DxM" / "PxDxM"."""
    if name in ("single", "multi"):
        shape = make_production_mesh(multi_pod=name == "multi",
                                     nodes=nodes).shape
    else:
        dims = parse_mesh_shape(name)
        shape = dict(zip(axes_for(dims), dims))
    return Mesh.dry(shape, rank)


def tree_bytes(tree) -> int:
    return sum(nbytes(t) for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def count_step(cfg, shape: InputShape, mesh: Mesh, *, fsdp: bool = False,
               remat: bool = False, seq_shard_attn: bool = False,
               cache_seq_shard: bool = False) -> Dict:
    """One rank's step of ``cfg`` at ``shape`` on the dry ``mesh``,
    counted: its FLOPs, bytes, collectives and memory (see the module's
    docstring)."""
    t0 = time.perf_counter()
    window = sp.serve_window(cfg, shape)
    ctx = make_ctx(mesh, seq_shard_attn=seq_shard_attn,
                   cache_seq_shard=cache_seq_shard)
    model = tf.init_params(cfg, ctx=ctx, fsdp=fsdp)
    batch = sp.batch_specs_abstract(cfg, shape)
    params = dict(model.named_parameters())
    args = {"params": params, "batch": batch}
    if shape.kind == "train":
        args["opt_state"] = adamw.init_state(params, adamw.AdamWConfig())
        step = make_train_step(cfg, window=window, remat=remat, ctx=ctx)

        def run():
            return step(model, args["opt_state"], batch)
        aliased = ("params", "opt_state")
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, window=window, ctx=ctx)

        def run():
            return step(model, batch)
        aliased = ()
    else:
        args["cache"] = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                                      window=window, ctx=ctx)
        step = make_decode_step(cfg, window=window, ctx=ctx)

        def run():
            return step(model, args["cache"], batch, shape.seq_len - 1)
        aliased = ("cache",)
    build_s = time.perf_counter() - t0
    mesh.records.clear()
    comm.reset_stats()
    t0 = time.perf_counter()
    with WorkCounter() as counter:
        out = run()
    run_s = time.perf_counter() - t0
    arg_ids = {t.untyped_storage()._cdata
               for t in torch.utils._pytree.tree_leaves(args)
               if isinstance(t, torch.Tensor)}
    out_bytes = sum(nbytes(t) for t in torch.utils._pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)
                    and t.untyped_storage()._cdata not in arg_ids)
    return {
        "lower_s": build_s,      # the rank's shards and inputs, on meta
        "compile_s": 0.0,        # nothing compiles: PyTorch runs eagerly
        "run_s": run_s,
        "flops": float(counter.flops),
        "bytes_accessed": float(counter.bytes),
        "utilization_ops": {"transcendentals": counter.transcendentals},
        "ops": counter.ops,
        "kernels": counter.units,
        "stats": {"calls": int(comm.STATS["calls"]),
                  "bytes": int(comm.STATS["bytes"])},
        "collectives": rl.collective_link_bytes(mesh.records, mesh),
        "memory": {
            "argument_bytes": tree_bytes(args),
            "output_bytes": out_bytes,
            "temp_bytes": counter.peak_bytes,
            "alias_bytes": sum(tree_bytes(args[k]) for k in aliased),
            "code_bytes": 0,
        },
    }


def _costs(info: Dict) -> Dict[str, float]:
    coll = info["collectives"]
    return {"flops": info["flops"], "bytes": info["bytes_accessed"],
            "link_bytes": coll["total_link_bytes"],
            **{f"link:{k}": v for k, v in coll["link_bytes"].items()},
            **{f"class:{k}": v
               for k, v in coll["link_bytes_by_class"].items()}}


def run_combo(arch: str, shape_name: Union[str, InputShape], mesh_name: str,
              *, fsdp=False, remat=False, tag="", probes=True,
              skip_full=False, seq_shard_attn=False, cache_seq_shard=False,
              capacity_factor=None, nodes: int = 32,
              cfg: Optional[object] = None) -> dict:
    """The record of one combination (the reference's keys).
    ``shape_name`` may be an :class:`InputShape`, ``mesh_name`` a shape
    "DxM", ``cfg`` a config to use in place of ``get_config(arch)``."""
    cfg = cfg or get_config(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    mesh = dry_mesh(mesh_name, nodes)
    n_devices = mesh.world
    window = sp.serve_window(cfg, shape)
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "mesh_shape": dict(mesh.shape),
        "kind": shape.kind, "window": window,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "fsdp": fsdp, "remat": remat,
        "seq_shard_attn": seq_shard_attn, "cache_seq_shard": cache_seq_shard,
        "capacity_factor": capacity_factor,
    }
    levers = dict(fsdp=fsdp, remat=remat, seq_shard_attn=seq_shard_attn,
                  cache_seq_shard=cache_seq_shard)
    if not skip_full:
        rec["full"] = count_step(cfg, shape, mesh, **levers)
    if probes:
        (u1, u2), n_units = rl.probe_units(cfg)
        probes_out, costs = {}, {}
        for label, nl in (("probe1", u1), ("probe2", u2)):
            info = count_step(rl.probe_config(cfg, nl), shape, mesh,
                              **levers)
            probes_out[label] = info
            costs[label] = _costs(info)
        scaled = rl.scale_probe_costs(costs["probe1"], costs["probe2"],
                                      n_units)
        rec["probes"] = probes_out
        rec["n_units"] = n_units
        rec["scaled"] = scaled
        # the rank's count times the ranks: the whole job's FLOPs
        rec["roofline"] = rl.roofline_terms(
            cfg, shape, n_chips=n_devices, window=window,
            hlo_flops=scaled["flops"] * n_devices,
            hlo_bytes=scaled["bytes"],
            link_bytes={c: scaled.get(f"class:{c}", 0.0)
                        for c in rl.LINK_BW})
    return rec


def result_path(arch, shape, mesh_name, tag=""):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(RESULTS_DIR,
                        f"{arch}__{shape}__{mesh_name}{suffix}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--nodes", type=int, default=32,
                    help="H100 nodes of 8 cards (a pod's, with --mesh multi)")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--seq-shard-attn", action="store_true")
    ap.add_argument("--cache-seq-shard", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--skip-full", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.sweep:
        combos = [(arch, shape, args.mesh) for arch in list_archs()
                  for shape in INPUT_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape, or --sweep")
        combos = [(args.arch, args.shape, args.mesh)]

    failures = []
    for arch, shape, mesh_name in combos:
        path = result_path(arch, shape, mesh_name, args.tag)
        if os.path.exists(path) and not args.force:
            print(f"[skip] {path} exists", flush=True)
            continue
        t0 = time.time()
        print(f"[run ] {arch} × {shape} × {mesh_name} "
              f"(fsdp={args.fsdp} remat={args.remat})", flush=True)
        try:
            rec = run_combo(arch, shape, mesh_name, fsdp=args.fsdp,
                            remat=args.remat, tag=args.tag,
                            probes=not args.no_probes,
                            skip_full=args.skip_full,
                            seq_shard_attn=args.seq_shard_attn,
                            cache_seq_shard=args.cache_seq_shard,
                            capacity_factor=args.capacity_factor,
                            nodes=args.nodes)
            rec["wall_s"] = round(time.time() - t0, 1)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1, default=str)
            r = rec.get("roofline", {})
            mem = rec.get("full", {}).get("memory", {})
            print(f"[ ok ] {arch} × {shape} × {mesh_name} "
                  f"wall={rec['wall_s']}s dominant={r.get('dominant')} "
                  f"compute={r.get('compute_s', 0):.4f}s "
                  f"memory={r.get('memory_s', 0):.4f}s "
                  f"collective={r.get('collective_s', 0):.4f}s "
                  f"args={mem.get('argument_bytes', 0) / 1e9:.2f}GB",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — sweep must survive one failure
            failures.append((arch, shape, mesh_name, repr(e)))
            print(f"[FAIL] {arch} × {shape} × {mesh_name}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("dry-run complete: every combination counted.")


if __name__ == "__main__":
    main()
