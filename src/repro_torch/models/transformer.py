"""The dense GQA decoder: prefill logits, KV cache and cached decode
(counterpart of the dense family of ``repro/models/transformer.py``).

A :class:`Transformer` holds the embedding, ``n_layers`` :class:`DenseLayer`
modules ([RMSNorm, GQA, residual, RMSNorm, SwiGLU, residual], the
reference's ``_dense_layer_apply``/``_dense_layer_decode``) run by a Python
loop where the reference scans, the final norm and the LM head.  The public
functions keep the reference's names and layouts: tokens (B, S), logits
(B, S, V) in the config's dtype.  The parameters are the "params" the
functions take; :func:`params_from_jax` maps a reference tree onto them.

The port serves the dense family; MoE, SSM, hybrid, VLM and audio models
raise a ``ValueError`` that names their ROADMAP item.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import MLP, Embed, RMSNorm


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise ValueError(f"{cfg.arch_id}: the {cfg.family!r} family is not "
                         "ported yet (ROADMAP.md Queue 1 item 6: the rest of "
                         "the LM families)")
    if cfg.attn_type != "gqa" or cfg.cross_attention or cfg.mrope_sections:
        raise ValueError(f"{cfg.arch_id}: MLA, cross-attention and M-RoPE "
                         "are not ported yet (ROADMAP.md Queue 1 item 6)")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class DenseLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.attn = attn.GQAttention(cfg, dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)

    def forward(self, x, *, window: int = 0, kernel: str = "flash"):
        x = x + attn.gqa_forward(self.norm1(x), self.attn, self.cfg,
                                 window=window, kernel=kernel)
        return x + self.mlp(self.norm2(x))

    def decode(self, x, cache, pos: int, *, window: int = 0):
        a, cache = attn.gqa_decode(self.norm1(x), self.attn, cache, pos,
                                   self.cfg, window=window)
        x = x + a
        return x + self.mlp(self.norm2(x)), cache


class Transformer(nn.Module):
    """Parameters of a dense decoder, in ``cfg.dtype``, left uninitialised:
    :func:`init_params` draws them, ``load_state_dict(params_from_jax(tree))``
    copies a reference tree."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        dtype = _dtype(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                           dtype, device)
        self.layers = nn.ModuleList(DenseLayer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)

    def forward(self, tokens, *, window: int = 0, kernel: str = "flash"):
        """tokens (B, S) -> logits (B, S, V)."""
        x = self.embed.embed(tokens)
        for layer in self.layers:
            x = layer(x, window=window, kernel=kernel)
        return self.embed.unembed(self.final_norm(x))


# ===========================================================================
# parameters
# ===========================================================================
@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Transformer:
    """A :class:`Transformer` on ``device`` with weights drawn from a
    ``torch.Generator`` there, seeded with ``seed``: fan-in truncated
    normals for every matrix, ones for every norm scale."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.embed.reset_parameters(gen)
    for layer in model.layers:
        layer.attn.reset_parameters(gen)
        layer.mlp.reset_parameters(gen)
    return model.eval()


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The reference's dense param tree (leaves as numpy arrays, ``layers``
    stacked on a leading L axis) as a :class:`Transformer` state dict in
    float32: ``embed``/``final_norm`` leaves by name, ``layers`` leaves
    split along L into ``layers.<i>.<path>``.  The attention weights keep
    their ``(d, H, hd)``/``(H, hd, d)`` layouts.  Raises on a tree with
    other top-level entries (another family)."""
    extra = set(tree) - {"embed", "final_norm", "layers"}
    if extra:
        raise ValueError(f"not a dense param tree: unexpected {sorted(extra)}")

    def leaves(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix[:-1], np.asarray(node, dtype=np.float32)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    out: Dict[str, torch.Tensor] = {}
    for top in ("embed", "final_norm"):
        for name, a in leaves(tree[top], f"{top}."):
            out[name] = tensor(a)
    for name, a in leaves(tree["layers"]):
        for i in range(a.shape[0]):
            out[f"layers.{i}.{name}"] = tensor(a[i])
    return out


# ===========================================================================
# forward / prefill / cache / decode
# ===========================================================================
def forward(params: Transformer, batch, cfg: ModelConfig, *, window: int = 0,
            kernel: str = "flash") -> torch.Tensor:
    """batch {"tokens": (B, S)} -> logits (B, S, V) in the config's dtype.
    (The dense family has no auxiliary loss; the reference's second return
    value is always zero for it.)"""
    return params(batch["tokens"], window=window, kernel=kernel)


def prefill(params: Transformer, batch, cfg: ModelConfig, *, window: int = 0,
            kernel: str = "flash") -> torch.Tensor:
    """Prefill = the full forward's logits, as in the reference: the serving
    loop fills the cache by chaining :func:`decode_step`."""
    return forward(params, batch, cfg, window=window, kernel=kernel)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               window: int = 0, device: DeviceLike = "cuda"):
    """Zeroed KV cache: {"layers": [{"k", "v"}, ...]}, one (B, T, KV, hd)
    pair per layer in the config's dtype, T = min(cache_len, window) with a
    window (a ring buffer), else cache_len."""
    _check_supported(cfg)
    kv_len = min(cache_len, window) if window else cache_len
    dev = resolve_device(device)
    return {"layers": [attn.gqa_init_cache(cfg, batch, kv_len, _dtype(cfg),
                                           dev)
                       for _ in range(cfg.n_layers)]}


def decode_step(params: Transformer, cache, batch, pos: int,
                cfg: ModelConfig, *, window: int = 0):
    """One-token step.  batch {"tokens": (B, 1)}; pos the absolute position.
    Returns (logits (B, 1, V), cache), the cache written in place."""
    x = params.embed.embed(batch["tokens"])
    for layer, c in zip(params.layers, cache["layers"]):
        x, _ = layer.decode(x, c, pos, window=window)
    return params.embed.unembed(params.final_norm(x)), cache
