"""Roofline model for H100 nodes: compute, memory and collective terms from
counted dry runs (counterpart of ``repro/launch/roofline.py``).

The reference reads its costs from XLA: ``cost_analysis`` of two unrolled
probe compiles (1 and 2 stack units), scaled to the full depth, and the
collectives parsed out of the post-SPMD HLO.  PyTorch compiles nothing, so
the port counts instead (``launch/dryrun.py``): one rank's real step runs
on the meta device under :class:`~repro_torch.launch.counter.WorkCounter`
(FLOPs, bytes, the kernels as units), and a dry mesh
(:meth:`~repro_torch.parallel.comm.Mesh.dry`) records each collective.
The probes and their scaling are the reference's::

    per_unit = cost(2u) - cost(1u)
    total    = cost(1u) - per_unit      # base: embed/lm-head/loss/optimizer
               + n_units * per_unit

An eager count has no fusion noise, so the scaled probes equal the
full-depth count.  Collective bytes take the reference's ring formulas
(:func:`_link_bytes`), split by the links they cross: NVLink inside a node
(the model axis), the network across nodes (data, pod).  The constants are
the H100 SXM's (``launch/mesh.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Union

from repro_torch.configs import InputShape, ModelConfig
from repro_torch.launch.mesh import (HBM_BW, NET_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16, link_class)

# the bandwidth of each link class, a card
LINK_BW = {"nvlink": NVLINK_BW, "net": NET_BW}

# the port's collectives (parallel/comm.py) as the reference's HLO names them
HLO_OPS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
           "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
           "broadcast": "broadcast"}


def _link_bytes(op: str, size: int, n: int) -> float:
    """Ring-algorithm per-device link bytes for a collective with result
    bytes ``size`` over ``n`` participants (a broadcast, which the
    reference's HLO never holds, passes each byte on once)."""
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return size * (n - 1) / n
    if op == "reduce-scatter":
        return size * (n - 1)          # result is the scattered shard
    if op == "all-reduce":
        return 2 * size * (n - 1) / n
    if op == "all-to-all":
        return size * (n - 1) / n
    if op in ("collective-permute", "broadcast"):
        return float(size)
    return 0.0


def collective_link_bytes(records: Iterable, mesh) -> Dict:
    """The reference's ``parse_collectives`` on a dry mesh's records
    ((op, axes, group size, result bytes) a collective): link bytes and
    counts by HLO op name, their total, and the link bytes by class
    ("nvlink", "net": :func:`~repro_torch.launch.mesh.link_class`)."""
    per_op: Dict[str, float] = {}
    count: Dict[str, int] = {}
    by_class = {"nvlink": 0.0, "net": 0.0}
    for op, axes, n, size in records:
        name = HLO_OPS[op]
        b = _link_bytes(name, size, n)
        per_op[name] = per_op.get(name, 0.0) + b
        count[name] = count.get(name, 0) + 1
        by_class[link_class(mesh.shape, axes)] += b
    return {"link_bytes": per_op, "counts": count,
            "total_link_bytes": sum(per_op.values()),
            "link_bytes_by_class": by_class}


# ---------------------------------------------------------------------------
# Probe scaling
# ---------------------------------------------------------------------------
def probe_units(cfg: ModelConfig):
    """(unit_layer_counts_for_probes, n_units_full)."""
    if cfg.family == "hybrid":
        k = cfg.attn_every
        return (k, 2 * k), cfg.n_layers / k
    if cfg.family == "ssm" and cfg.slstm_every:
        k = cfg.slstm_every
        return (k, 2 * k), cfg.n_layers / k
    if cfg.family == "moe":
        fd = cfg.first_dense
        return (fd + 1, fd + 2), cfg.n_layers - fd
    return (1, 2), cfg.n_layers


def probe_config(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=n_layers)


def scale_probe_costs(cost1: Dict, cost2: Dict, n_units: float) -> Dict:
    out = {}
    for k in set(cost1) | set(cost2):
        c1, c2 = cost1.get(k, 0.0), cost2.get(k, 0.0)
        # a negative delta is not a cost (the reference's XLA may choose
        # other fusions at 1u and 2u; an eager count never does) -> clamp
        per_unit = max(0.0, c2 - c1)
        out[k] = max(0.0, c1 - per_unit) + n_units * per_unit
    return out


# ---------------------------------------------------------------------------
# Analytic FLOPs / bytes
# ---------------------------------------------------------------------------
def analytic_flops(cfg: ModelConfig, shape: InputShape, window: int) -> float:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        fwd = cfg.flops_per_token_fwd(s) * b * s
        return 3.0 * fwd                       # fwd + backward (2x)
    if shape.kind == "prefill":
        return cfg.flops_per_token_fwd(s) * b * s
    return cfg.flops_per_token_fwd(1, kv_len=s, window=window) * b


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """The 6·N·D (train) / 2·N·D (inference) convention, active params for
    MoE; attention score FLOPs excluded by convention."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch


def analytic_hbm_bytes(cfg: ModelConfig, shape: InputShape, window: int,
                       n_chips: int) -> float:
    """Per-step HBM traffic floor, summed over cards: every resident param
    byte read once (+3x for train: grad write, two optimizer-moment
    read-writes approximated), plus decode KV-cache read."""
    p_bytes = cfg.param_count() * 2        # bf16 residency
    if shape.kind == "train":
        traffic = p_bytes * (1 + 2) + cfg.param_count() * 4 * 4  # p+g, m/v rw
    elif shape.kind == "decode":
        # params read once per step; MoE: the routed experts as the floor
        traffic = cfg.active_param_count() * 2
        traffic += _decode_cache_bytes(cfg, shape, window)
    else:
        traffic = cfg.active_param_count() * 2
    return float(traffic)


def _decode_cache_bytes(cfg: ModelConfig, shape: InputShape,
                        window: int) -> float:
    b = shape.global_batch
    t = min(shape.seq_len, window) if window else shape.seq_len
    if cfg.family == "ssm":
        d = cfg.d_model
        per_layer = b * (cfg.n_heads * (2 * d // max(cfg.n_heads, 1)) ** 2) * 4
        return cfg.n_layers * per_layer
    if cfg.family == "hybrid":
        sites = math.ceil(cfg.n_layers / cfg.attn_every)
        attn = sites * b * t * 2 * cfg.n_kv_heads * cfg.head_dim * 2
        ssm = cfg.n_layers * b * cfg.ssm_heads * cfg.ssm_state * \
            cfg.ssm_head_dim * 4
        return attn + ssm
    if cfg.attn_type == "mla":
        return cfg.n_layers * b * t * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    return cfg.n_layers * b * t * 2 * cfg.n_kv_heads * cfg.head_dim * 2


# ---------------------------------------------------------------------------
# The three terms
# ---------------------------------------------------------------------------
def roofline_terms(cfg: ModelConfig, shape: InputShape, *, n_chips: int,
                   window: int, hlo_flops: float, hlo_bytes: float,
                   link_bytes: Union[float, Dict[str, float]]) -> Dict:
    """The reference's terms on H100 cards.  ``hlo_flops`` is the whole
    job's counted FLOPs, ``hlo_bytes`` a card's counted bytes;
    ``link_bytes`` a card's link bytes by class ({"nvlink": b, "net": b})
    or one number, all of it on NVLink.  ``collective_s`` is each class's
    bytes over its own bandwidth, summed."""
    by_class = dict(link_bytes) if isinstance(link_bytes, dict) \
        else {"nvlink": float(link_bytes)}
    a_flops = analytic_flops(cfg, shape, window)
    m_flops = model_flops(cfg, shape)
    a_bytes = analytic_hbm_bytes(cfg, shape, window, n_chips)
    compute_s = a_flops / (n_chips * PEAK_FLOPS_BF16)
    compute_hlo_s = hlo_flops / (n_chips * PEAK_FLOPS_BF16)
    # hlo_bytes is a card's (one rank's counted step) -> its time directly
    memory_s = hlo_bytes / HBM_BW
    memory_analytic_s = a_bytes / (n_chips * HBM_BW)
    collective_s = sum(b / LINK_BW[c] for c, b in by_class.items())
    terms = {
        "compute_s": compute_s,
        "compute_hlo_s": compute_hlo_s,
        "memory_s": memory_s,
        "memory_analytic_s": memory_analytic_s,
        "collective_s": collective_s,
        "analytic_flops": a_flops,
        "hlo_flops": hlo_flops,
        "model_flops_6nd": m_flops,
        "useful_ratio": (m_flops / hlo_flops) if hlo_flops else None,
        "hlo_bytes_per_chip": hlo_bytes,
        "link_bytes_per_chip": sum(by_class.values()),
        "link_bytes_by_class": by_class,
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["dominant"] = dom
    total = terms["compute_s"] + terms["memory_s"] + terms["collective_s"]
    terms["bound_fraction"] = terms[dom] / total if total else None
    return terms
