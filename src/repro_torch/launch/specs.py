"""Serving shapes and abstract inputs (counterpart of
``repro/launch/specs.py``).  The abstract values are meta tensors: every
arch's full-width shapes, with no memory, for the sharding specs."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs import InputShape, ModelConfig


def serve_window(cfg: ModelConfig, shape: InputShape) -> int:
    """Sliding-window size for this (arch, shape) pair (0 = full attention).

    long_500k needs sub-quadratic serving: SSM/hybrid archs are natively
    O(1)-state (the hybrid's shared attention blocks still window); every
    other family serves long_500k with the sliding-window variant.
    """
    if shape.name != "long_500k":
        return 0
    if cfg.family == "ssm":
        return 0                      # no attention at all
    return cfg.sliding_window or 8192


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs_abstract(cfg: ModelConfig, shape: InputShape,
                         kind: Optional[str] = None) -> Dict:
    """The model-input batch as meta tensors (tokens and labels int64)."""
    kind = kind or shape.kind
    b, s = shape.global_batch, shape.seq_len
    emb = getattr(torch, cfg.dtype)
    if kind == "decode":
        batch = {"tokens": _meta((b, 1), torch.int64)}
        if cfg.family == "audio":
            batch["cond_embeds"] = _meta((b, cfg.n_cond_tokens, cfg.d_model),
                                         emb)
        return batch
    s_text = s - cfg.n_vision_tokens if cfg.family == "vlm" else s
    batch = {"tokens": _meta((b, s_text), torch.int64)}
    if kind == "train":
        batch["labels"] = _meta((b, s_text), torch.int64)
    if cfg.family == "vlm":
        batch["vision_embeds"] = _meta((b, cfg.n_vision_tokens, cfg.d_model),
                                       emb)
    if cfg.family == "audio":
        batch["cond_embeds"] = _meta((b, cfg.n_cond_tokens, cfg.d_model), emb)
    return batch


def params_abstract(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """``{name: meta tensor}`` of the model's parameters."""
    from repro_torch.models.transformer import Transformer
    return dict(Transformer(cfg, device="meta").named_parameters())


def cache_abstract(cfg: ModelConfig, shape: InputShape, window: int):
    from repro_torch.models.transformer import _cache_tree
    return _cache_tree(cfg, shape.global_batch, shape.seq_len, window,
                       torch.device("meta"))


def opt_abstract(params_abs: Dict[str, torch.Tensor], opt_cfg=None):
    from repro_torch.optim import adamw
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    mu = getattr(torch, opt_cfg.mu_dtype)
    return {"step": _meta((), torch.int32),
            "mu": {k: _meta(p.shape, mu) for k, p in params_abs.items()},
            "nu": {k: _meta(p.shape, mu) for k, p in params_abs.items()}}


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict:
    """Everything a step consumes, as meta tensors."""
    out = {"batch": batch_specs_abstract(cfg, shape),
           "params": params_abstract(cfg)}
    if shape.kind == "train":
        out["opt_state"] = opt_abstract(out["params"])
    elif shape.kind == "decode":
        out["cache"] = cache_abstract(cfg, shape, serve_window(cfg, shape))
        out["pos"] = _meta((), torch.int32)
    return out
