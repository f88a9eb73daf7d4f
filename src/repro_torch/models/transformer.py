"""The LM families the port serves, prefill logits, cache and cached
decode (counterpart of the dense, MoE and hybrid families of
``repro/models/transformer.py``).

A :class:`Transformer` holds the embedding, the family's stack, the final
norm and the LM head.  The stack is run by Python loops where the
reference scans:

* dense: ``n_layers`` :class:`DenseLayer` modules ([RMSNorm, GQA, residual,
  RMSNorm, SwiGLU, residual], the reference's ``_dense_layer_apply`` /
  ``_dense_layer_decode``);
* moe (DeepSeek-V2, Kimi-K2): ``first_dense`` :class:`DenseLayer` modules,
  then ``n_layers - first_dense`` :class:`MoELayer` modules ([RMSNorm,
  attention, residual, RMSNorm, MoE, residual], the reference's
  ``_moe_layer_apply`` / ``_moe_layer_decode``); the attention is GQA or
  MLA as configured, in the dense layers too;
* hybrid (Zamba2): one weight-shared :class:`SharedAttention` block
  ([RMSNorm, GQA, residual]) applied before each of the ``n_layers //
  attn_every`` groups of ``attn_every`` :class:`MambaLayer` modules
  ([RMSNorm, Mamba2, residual]), and once more before the ``rem``
  remaining layers, if any (the reference's ``_hybrid_stack`` /
  ``_hybrid_decode``).

The public functions keep the reference's names and layouts: tokens
(B, S), logits (B, S, V) in the config's dtype.  The parameters are the
"params" the functions take; :func:`params_from_jax` maps a reference tree
onto them.  The functions run the MoE layers with the capacity factor of
the config they are given, as the reference's do (:data:`RUN_FIELDS`).

xLSTM, VLM and audio models, cross-attention and M-RoPE raise a
``ValueError`` that names their ROADMAP item.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import MLP, Embed, RMSNorm

FAMILIES = ("dense", "moe", "hybrid")
# config fields a call may change without changing the weights
RUN_FIELDS = ("capacity_factor",)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.arch_id}: the {cfg.family!r} family is not "
                         "ported yet (ROADMAP.md Queue 1 item 4: the rest of "
                         "the LM families)")
    if cfg.attn_type not in ("gqa", "mla") or cfg.cross_attention or \
            cfg.mrope_sections:
        raise ValueError(f"{cfg.arch_id}: cross-attention and M-RoPE are "
                         "not ported yet (ROADMAP.md Queue 1 item 4)")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# Every block (DenseLayer, MoELayer, SharedAttention, MambaLayer) is called
# alike: block(x, window=, kernel=) on a whole sequence and block.decode(x,
# cache, pos, window=) on one token; a Mamba2 layer has no window and no
# position.
class DenseLayer(nn.Module):
    """x + attention(RMSNorm(x)), then + SwiGLU(RMSNorm(·)); the attention
    is GQA or MLA as configured."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.attn = attn.make_attention(cfg, dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)

    def forward(self, x, *, window: int = 0, kernel: str = "flash"):
        x = x + attn.attention_forward(self.norm1(x), self.attn, self.cfg,
                                       window=window, kernel=kernel)
        return x + self.mlp(self.norm2(x))

    def decode(self, x, cache, pos: int, *, window: int = 0):
        a, cache = attn.attention_decode(self.norm1(x), self.attn, cache,
                                         pos, self.cfg, window=window)
        x = x + a
        return x + self.mlp(self.norm2(x)), cache


class MoELayer(nn.Module):
    """x + attention(RMSNorm(x)), then + MoE(RMSNorm(·)); the attention is
    GQA or MLA as configured.  ``cfg`` gives the MoE its capacity factor."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.attn = attn.make_attention(cfg, dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.moe = moe_mod.MoE(cfg, dtype, device)

    def forward_aux(self, x, *, window: int = 0, kernel: str = "flash"):
        """(the layer's output, its MoE's aux loss)."""
        x = x + attn.attention_forward(self.norm1(x), self.attn, self.cfg,
                                       window=window, kernel=kernel)
        m, aux = moe_mod.moe_forward(self.norm2(x), self.moe, self.cfg)
        return x + m, aux

    def forward(self, x, *, window: int = 0, kernel: str = "flash"):
        return self.forward_aux(x, window=window, kernel=kernel)[0]

    def decode(self, x, cache, pos: int, *, window: int = 0):
        a, cache = attn.attention_decode(self.norm1(x), self.attn, cache,
                                         pos, self.cfg, window=window)
        x = x + a
        m, _ = moe_mod.moe_forward(self.norm2(x), self.moe, self.cfg)
        return x + m, cache


class SharedAttention(nn.Module):
    """The hybrid's weight-shared block: x + GQA(RMSNorm(x))."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.attn = attn.GQAttention(cfg, dtype, device)

    def mix(self, x, *, window: int = 0, kernel: str = "flash"):
        """The block's own output, before the residual add."""
        return attn.gqa_forward(self.norm(x), self.attn, self.cfg,
                                window=window, kernel=kernel)

    def mix_decode(self, x, cache, pos: int, *, window: int = 0):
        return attn.gqa_decode(self.norm(x), self.attn, cache, pos, self.cfg,
                               window=window)

    def forward(self, x, *, window: int = 0, kernel: str = "flash"):
        return x + self.mix(x, window=window, kernel=kernel)

    def decode(self, x, cache, pos: int, *, window: int = 0):
        a, cache = self.mix_decode(x, cache, pos, window=window)
        return x + a, cache


class MambaLayer(nn.Module):
    """x + Mamba2(RMSNorm(x))."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.ssm = ssm_mod.Mamba2(cfg, dtype, device)

    def mix(self, x, *, window: int = 0, kernel: str = "flash"):
        """The block's own output, before the residual add."""
        return ssm_mod.ssm_forward(self.norm(x), self.ssm, self.cfg,
                                   kernel=kernel)

    def mix_decode(self, x, cache, pos: int, *, window: int = 0):
        return ssm_mod.ssm_decode(self.norm(x), self.ssm, cache, self.cfg)

    def forward(self, x, *, window: int = 0, kernel: str = "flash"):
        return x + self.mix(x, kernel=kernel)

    def decode(self, x, cache, pos: int, *, window: int = 0):
        o, cache = self.mix_decode(x, cache, pos)
        return x + o, cache


def hybrid_layout(cfg: ModelConfig):
    """(groups, attn_every, rem): the hybrid runs ``groups`` groups of
    ``attn_every`` Mamba2 layers and ``rem`` more, the shared block before
    each group and before the remainder."""
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.attn_every, cfg.n_layers - g * cfg.attn_every


class Transformer(nn.Module):
    """Parameters of a dense, MoE or hybrid LM, in ``cfg.dtype`` (the MoE
    router and the hybrid's dt_bias, A_log and D in float32), left
    uninitialised: :func:`init_params` draws them,
    ``load_state_dict(params_from_jax(tree))`` copies a reference tree."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        dtype = _dtype(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                           dtype, device)
        if cfg.family == "hybrid":
            g, k, rem = hybrid_layout(cfg)
            self.shared_attn = SharedAttention(cfg, dtype, device)
            self.groups = nn.ModuleList(
                nn.ModuleList(MambaLayer(cfg, dtype, device)
                              for _ in range(k)) for _ in range(g))
            self.rem = nn.ModuleList(MambaLayer(cfg, dtype, device)
                                     for _ in range(rem))
        elif cfg.family == "moe":
            dense_cfg = dataclasses.replace(cfg, family="dense",
                                            cross_attention=False)
            self.dense_layers = nn.ModuleList(
                DenseLayer(dense_cfg, dtype, device)
                for _ in range(cfg.first_dense))
            self.layers = nn.ModuleList(
                MoELayer(cfg, dtype, device)
                for _ in range(cfg.n_layers - cfg.first_dense))
        else:
            self.layers = nn.ModuleList(DenseLayer(cfg, dtype, device)
                                        for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)

    def blocks(self):
        """The blocks in the order the forward runs them: the dense layers;
        the MoE family's dense layers, then its MoE layers; or the shared
        block before each group of Mamba2 layers and before the
        remainder."""
        if self.cfg.family == "moe":
            yield from self.dense_layers
        if self.cfg.family != "hybrid":
            yield from self.layers
            return
        for group in [*self.groups, self.rem]:
            if len(group):
                yield self.shared_attn
                yield from group

    def forward_aux(self, tokens, *, window: int = 0, kernel: str = "flash"):
        """tokens (B, S) -> (logits (B, S, V), the MoE layers' summed aux
        loss, a float32 scalar: zero without MoE layers)."""
        x = self.embed.embed(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks():
            if isinstance(block, MoELayer):
                x, a = block.forward_aux(x, window=window, kernel=kernel)
                aux = aux + a
            else:
                x = block(x, window=window, kernel=kernel)
        return self.embed.unembed(self.final_norm(x)), aux

    def forward(self, tokens, *, window: int = 0, kernel: str = "flash"):
        """tokens (B, S) -> logits (B, S, V)."""
        return self.forward_aux(tokens, window=window, kernel=kernel)[0]


# ===========================================================================
# parameters
# ===========================================================================
@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Transformer:
    """A :class:`Transformer` on ``device`` with weights drawn from a
    ``torch.Generator`` there, seeded with ``seed``: fan-in truncated
    normals for every matrix, ones for every norm scale (and the Mamba2
    blocks' zeros and ones, as ``ssm_init``)."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.embed.reset_parameters(gen)
    for module in model.modules():
        if isinstance(module, (attn.GQAttention, attn.MLAttention, MLP,
                               moe_mod.MoE, ssm_mod.Mamba2)):
            module.reset_parameters(gen)
    return model.eval()


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The reference's param tree (leaves as numpy arrays) as a
    :class:`Transformer` state dict in float32, each leaf mapped once:
    ``embed``/``final_norm``/``shared_attn`` leaves by name; the dense and
    MoE ``layers`` (stacked on a leading L axis) split into
    ``layers.<i>.<path>``; the MoE family's ``dense_layers`` (a list, not
    stacked) into ``dense_layers.<i>.<path>``; the hybrid's ``groups``
    (stacked (g, attn_every, ...)) into ``groups.<i>.<j>.ssm.<leaf>`` and
    ``groups.<i>.<j>.norm.scale``, and its ``rem`` ((rem, ...), or None)
    into ``rem.<j>...``.  The attention and expert weights keep their
    layouts.  Raises on a tree with other top-level entries (another
    family)."""
    dense = {"embed", "final_norm", "layers"}
    moe = {"embed", "final_norm", "dense_layers", "layers"}
    hybrid = {"embed", "final_norm", "shared_attn", "groups", "rem"}
    if set(tree) not in (dense, moe, hybrid):
        raise ValueError("not a dense or hybrid (or MoE) param tree: entries "
                         f"{sorted(tree)}")

    def leaves(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix[:-1], np.asarray(node, dtype=np.float32)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    out: Dict[str, torch.Tensor] = {}
    for top in ("embed", "final_norm", "shared_attn"):
        for name, a in leaves(tree.get(top) or {}, f"{top}."):
            out[name] = tensor(a)
    for i, layer in enumerate(tree.get("dense_layers") or []):
        for name, a in leaves(layer, f"dense_layers.{i}."):
            out[name] = tensor(a)
    for name, a in leaves(tree.get("layers") or {}):
        for i in range(a.shape[0]):
            out[f"layers.{i}.{name}"] = tensor(a[i])

    def layer_name(name):          # ssm.<leaf> or norms.scale -> norm.scale
        return "norm.scale" if name == "norms.scale" else name

    for name, a in leaves(tree.get("groups") or {}):
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                out[f"groups.{i}.{j}.{layer_name(name)}"] = tensor(a[i, j])
    for name, a in leaves(tree.get("rem") or {}):
        for j in range(a.shape[0]):
            out[f"rem.{j}.{layer_name(name)}"] = tensor(a[j])
    return out


# ===========================================================================
# forward / prefill / cache / decode
# ===========================================================================
@contextlib.contextmanager
def run_config(params: Transformer, cfg: ModelConfig):
    """Run ``params`` under ``cfg`` for the duration of the block: a config
    that differs from the model's own only in :data:`RUN_FIELDS` (such as
    the reference's dropless ``capacity_factor``) is handed to every MoE
    layer and restored after; any other difference raises, since it would
    describe other weights."""
    own = params.cfg
    if cfg == own:
        yield
        return
    if dataclasses.replace(cfg, **{f: getattr(own, f)
                                   for f in RUN_FIELDS}) != own:
        raise ValueError(f"config {cfg.arch_id} differs from the model's "
                         f"beyond {RUN_FIELDS}")
    layers = [m for m in params.modules() if isinstance(m, MoELayer)]
    for m in layers:
        m.cfg = cfg
    try:
        yield
    finally:
        for m in layers:
            m.cfg = own


def forward_with_aux(params: Transformer, batch, cfg: ModelConfig, *,
                     window: int = 0, kernel: str = "flash"):
    """The reference's ``forward``: batch {"tokens": (B, S)} -> (logits
    (B, S, V) in the config's dtype, {"moe_aux": the MoE layers' summed aux
    loss}, zero for the dense and hybrid families)."""
    with run_config(params, cfg):
        logits, aux = params.forward_aux(batch["tokens"], window=window,
                                         kernel=kernel)
    return logits, {"moe_aux": aux}


def forward(params: Transformer, batch, cfg: ModelConfig, *, window: int = 0,
            kernel: str = "flash") -> torch.Tensor:
    """batch {"tokens": (B, S)} -> logits (B, S, V) in the config's dtype
    (:func:`forward_with_aux` also returns the aux loss)."""
    return forward_with_aux(params, batch, cfg, window=window,
                            kernel=kernel)[0]


def prefill(params: Transformer, batch, cfg: ModelConfig, *, window: int = 0,
            kernel: str = "flash") -> torch.Tensor:
    """Prefill = the full forward's logits, as in the reference: the serving
    loop fills the cache by chaining :func:`decode_step`."""
    return forward(params, batch, cfg, window=window, kernel=kernel)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               window: int = 0, device: DeviceLike = "cuda"):
    """Zeroed cache in the config's dtype; T = min(cache_len, window) KV
    slots with a window (a ring buffer), else cache_len.

    dense: {"layers": [{"k", "v"}, ...]}, one (B, T, KV, hd) pair a layer.
    moe: {"dense_layers": [...], "layers": [...]}, a layer's entry {"k",
    "v"} for GQA or {"c_kv" (B, T, r), "k_rope" (B, T, rope)} for MLA.
    hybrid: {"groups": [{"attn_kv": {"k", "v"}, "ssm": [{"state", "conv"},
    ...]}, ...], "rem": {"attn_kv", "ssm"} or None}: one KV cache for each
    application of the shared block and one Mamba2 cache a layer."""
    _check_supported(cfg)
    kv_len = min(cache_len, window) if window else cache_len
    dev = resolve_device(device)
    dtype = _dtype(cfg)

    def kv():
        return attn.attention_init_cache(cfg, batch, kv_len, dtype, dev)

    if cfg.family == "hybrid":
        g, k, rem = hybrid_layout(cfg)

        def group(n):
            return {"attn_kv": kv(),
                    "ssm": [ssm_mod.ssm_init_cache(cfg, batch, dtype, dev)
                            for _ in range(n)]}
        return {"groups": [group(k) for _ in range(g)],
                "rem": group(rem) if rem else None}
    if cfg.family == "moe":
        return {"dense_layers": [kv() for _ in range(cfg.first_dense)],
                "layers": [kv() for _ in range(cfg.n_layers -
                                               cfg.first_dense)]}
    return {"layers": [kv() for _ in range(cfg.n_layers)]}


def decode_step(params: Transformer, cache, batch, pos: int,
                cfg: ModelConfig, *, window: int = 0):
    """One-token step.  batch {"tokens": (B, 1)}; pos the absolute position.
    Returns (logits (B, 1, V), cache), the cache written in place.  The MoE
    layers see the B tokens of the step, so their capacity is
    ``ceil(B·k·cf / E)``, as in the reference."""
    with run_config(params, cfg):
        x = params.embed.embed(batch["tokens"])
        for block, c in zip(params.blocks(), _block_caches(cache)):
            x, _ = block.decode(x, c, pos, window=window)
        return params.embed.unembed(params.final_norm(x)), cache


def _block_caches(cache):
    """The cache's per-block entries in :meth:`Transformer.blocks` order."""
    if "layers" in cache:
        yield from cache.get("dense_layers", [])
        yield from cache["layers"]
        return
    for group in [*cache["groups"], cache["rem"]]:
        if group is not None:
            yield group["attn_kv"]
            yield from group["ssm"]
