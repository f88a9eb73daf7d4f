"""The LM families of the reference, prefill logits, the training loss,
cache and cached decode (counterpart of ``repro/models/transformer.py``).

A :class:`Transformer` holds the embedding, the family's stack, the final
norm and the LM head.  The stack is run by Python loops where the
reference scans:

* dense, vlm (Qwen2-VL) and audio (MusicGen): ``n_layers``
  :class:`DenseLayer` modules ([RMSNorm, GQA, residual, (RMSNorm,
  cross-attention to the conditioning, residual,) RMSNorm, SwiGLU,
  residual], the reference's ``_dense_layer_apply`` /
  ``_dense_layer_decode``).  A vlm prefill splices the vision embeddings
  before the text and rotates by (3, B, S) M-RoPE positions
  (:func:`vlm_assemble`); an audio layer's decode attends to the
  precomputed ``cross_kv`` of its cache (:func:`cross_decode`);
* moe (DeepSeek-V2, Kimi-K2): ``first_dense`` :class:`DenseLayer` modules,
  then ``n_layers - first_dense`` :class:`MoELayer` modules ([RMSNorm,
  attention, residual, RMSNorm, MoE, residual], the reference's
  ``_moe_layer_apply`` / ``_moe_layer_decode``); the attention is GQA or
  MLA as configured, in the dense layers too;
* ssm (xLSTM): ``n_layers // slstm_every`` groups of ``slstm_every - 1``
  :class:`MLSTMLayer` modules and one :class:`SLSTMLayer` ([RMSNorm,
  mLSTM or sLSTM, residual]), then the ``rem`` remaining mLSTM layers; or,
  with ``slstm_every`` 0, ``n_layers`` mLSTM layers (the reference's
  ``_xlstm_stack`` / ``_xlstm_decode``);
* hybrid (Zamba2): one weight-shared :class:`SharedAttention` block
  ([RMSNorm, GQA, residual]) applied before each of the ``n_layers //
  attn_every`` groups of ``attn_every`` :class:`MambaLayer` modules
  ([RMSNorm, Mamba2, residual]), and once more before the ``rem``
  remaining layers, if any (the reference's ``_hybrid_stack`` /
  ``_hybrid_decode``).

The public functions keep the reference's names and layouts: a batch
{"tokens": (B, S)} (a vlm's also "vision_embeds" (B, P, d), an audio
model's "cond_embeds" (B, C, d)), logits (B, S, V) in the config's dtype.
The parameters are the "params" the functions take; :func:`params_from_jax`
maps a reference tree onto them.  The functions run the MoE layers with
the capacity factor of the config they are given, as the reference's do
(:data:`RUN_FIELDS`).  :func:`lm_loss` also takes "labels" (B, S) int64
and trains through plain PyTorch (``kernel="torch"``).

Every entry point takes an optional ``ctx`` (a ``ShardCtx`` with a mesh);
without it each runs today's code.  On a mesh the batch passed in is the
global batch: a rank keeps its rows (``batch_specs``: over the data axes
where they divide the batch) and returns its rows' logits, gathered over
the vocabulary.  The model is the rank's shards (:func:`init_params` with
``ctx``, or :func:`load_full_` of a whole state dict); with FSDP a block's
shards are gathered before it runs and, under autograd, the block runs
under ``torch.utils.checkpoint``, so its gathered weights are dropped after
the forward and gathered again for the backward, whose gradients are
reduce-scattered (:func:`~repro_torch.models.layers.fsdp_gather`).  On a
model axis the ``hybrid`` family runs its Mamba2 layers' heads a rank
(:mod:`repro_torch.models.ssm`) and its shared block's attention heads a
rank, and the ``ssm`` family its mLSTM heads a rank and its sLSTM
recurrence on every rank (:mod:`repro_torch.models.xlstm`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (MLP, Embed, RMSNorm, ShardCtx,
                                      fsdp_gather, gather_from, reduce_from,
                                      softmax_cross_entropy, split_to, tp,
                                      vocab_parallel_cross_entropy)
from repro_torch.parallel import sharding as shd

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# config fields a call may change without changing the weights
RUN_FIELDS = ("capacity_factor",)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.arch_id}: {cfg.family!r} is not an LM "
                         f"family; the families are {FAMILIES}")
    if cfg.attn_type not in ("gqa", "mla"):
        raise ValueError(f"{cfg.arch_id}: attention {cfg.attn_type!r} is "
                         "neither 'gqa' nor 'mla'")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# Every block (DenseLayer, MoELayer, SharedAttention, MambaLayer,
# MLSTMLayer, SLSTMLayer) is called alike: block(x, positions=, cond=,
# window=, kernel=) on a whole sequence and block.decode(x, cache, pos,
# window=) on one token; a block ignores what it has no use for (the
# recurrent blocks positions and window, all but the audio layers cond).
class DenseLayer(nn.Module):
    """x + attention(RMSNorm(x)), then, with ``cfg.cross_attention``,
    + cross-attention(RMSNorm(·), cond), then + SwiGLU(RMSNorm(·)); the
    attention is GQA or MLA as configured."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.attn = attn.make_attention(cfg, dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)
        if cfg.cross_attention:
            self.norm_c = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
            self.cross = attn.CrossAttention(cfg, dtype, device)
        else:
            self.norm_c = self.cross = None

    def forward(self, x, *, positions=None, cond=None, window: int = 0,
                kernel: str = "flash", ctx: Optional[ShardCtx] = None):
        x = x + attn.attention_forward(self.norm1(x), self.attn, self.cfg,
                                       positions=positions, window=window,
                                       kernel=kernel, ctx=ctx)
        if self.cross is not None:
            if cond is None:
                raise ValueError(f"{self.cfg.arch_id}: a cross-attention "
                                 "layer needs cond_embeds")
            x = x + attn.cross_attention(self.norm_c(x), cond, self.cross,
                                         self.cfg, ctx)
        return x + self.mlp(self.norm2(x), ctx)

    def decode(self, x, cache, pos: int, *, window: int = 0,
               ctx: Optional[ShardCtx] = None):
        """The layer's cache: its KV entries, and with cross-attention
        "cross_kv" {"k", "v"} (B, C, H, hd)."""
        a, cache = attn.attention_decode(self.norm1(x), self.attn, cache,
                                         pos, self.cfg, window=window,
                                         ctx=ctx)
        x = x + a
        if self.cross is not None:
            x = x + cross_decode(self.norm_c(x), self.cross,
                                 cache["cross_kv"], self.cfg, ctx)
        return x + self.mlp(self.norm2(x), ctx), cache


def cross_decode(x, p: attn.CrossAttention, cross_kv, cfg: ModelConfig,
                 ctx: Optional[ShardCtx] = None):
    """The reference's ``_cross_decode``: cross-attention of x (B, 1, d)
    to the precomputed keys and values ``cross_kv`` {"k", "v"} (B, C, H,
    hd).  Scores in float32 *divided* by sqrt(hd), as the reference writes
    it (:func:`~repro_torch.models.attention.cross_attention` multiplies by
    1/sqrt(hd)); p rounded to x's dtype before the product with v.  On a
    mesh this rank's heads attend over their ``cross_kv`` heads, or, with
    ``cross_kv`` sharded over its C conditioning tokens
    (``cache_seq_shard``), every head over this rank's stripe, combined
    (:func:`~repro_torch.models.attention.stripe_attend`) and cut back to
    this rank's heads; with the heads sharded, wo's partial sums are
    all-reduced."""
    f32 = torch.float32
    sharded = tp(ctx) and p.wq.shape[1] != cfg.n_heads
    q = p.project(x, p.wq)
    ck, cv = cross_kv["k"], cross_kv["v"]
    if ck.shape[1] != attn.full_shape(ck)[1]:
        mesh, axis = ctx.mesh, ctx.model_axis
        qa = gather_from(q, mesh, axis, 2) if sharded else q
        s = torch.einsum("bshk,bchk->bhsc", qa.to(f32),
                         ck.to(f32)) / math.sqrt(cfg.head_dim)
        o = attn.stripe_attend(s, None, lambda pr: torch.einsum(
            "bhsc,bchk->bhsk", pr.to(x.dtype).to(f32), cv.to(f32)), ctx)
        o = o.permute(0, 2, 1, 3).to(x.dtype)
        if sharded:
            o = split_to(o, mesh, axis, 2)
    else:
        s = torch.einsum("bshk,bchk->bhsc", q.to(f32),
                         ck.to(f32)) / math.sqrt(cfg.head_dim)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bhsc,bchk->bshk", pr.to(x.dtype).to(f32),
                         cv.to(f32)).to(x.dtype)
    out = p.out(o)
    return reduce_from(out, ctx.mesh, ctx.model_axis) if sharded else out


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

    def forward_aux(self, x, *, positions=None, cond=None, window: int = 0,
                    kernel: str = "flash", ctx: Optional[ShardCtx] = None):
        """(the layer's output, its MoE's aux loss)."""
        x = x + attn.attention_forward(self.norm1(x), self.attn, self.cfg,
                                       positions=positions, window=window,
                                       kernel=kernel, ctx=ctx)
        m, aux = moe_mod.moe_forward(self.norm2(x), self.moe, self.cfg, ctx)
        return x + m, aux

    def forward(self, x, *, positions=None, cond=None, window: int = 0,
                kernel: str = "flash", ctx: Optional[ShardCtx] = None):
        return self.forward_aux(x, positions=positions, window=window,
                                kernel=kernel, ctx=ctx)[0]

    def decode(self, x, cache, pos: int, *, window: int = 0,
               ctx: Optional[ShardCtx] = None):
        a, cache = attn.attention_decode(self.norm1(x), self.attn, cache,
                                         pos, self.cfg, window=window,
                                         ctx=ctx)
        x = x + a
        m, _ = moe_mod.moe_forward(self.norm2(x), self.moe, self.cfg, ctx)
        return x + m, cache


class _MixBlock(nn.Module):
    """x + mix(RMSNorm(x)): the hybrid's and the xLSTM's blocks.  A
    subclass gives ``mix`` and ``mix_decode``, the block's own output
    before the residual add, on the model axis of ``ctx``."""

    def forward(self, x, *, positions=None, cond=None, window: int = 0,
                kernel: str = "flash", ctx: Optional[ShardCtx] = None):
        return x + self.mix(x, positions=positions, window=window,
                            kernel=kernel, ctx=ctx)

    def decode(self, x, cache, pos: int, *, window: int = 0,
               ctx: Optional[ShardCtx] = None):
        o, cache = self.mix_decode(x, cache, pos, window=window, ctx=ctx)
        return x + o, cache


class SharedAttention(_MixBlock):
    """The hybrid's weight-shared block: x + GQA(RMSNorm(x))."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.attn = attn.GQAttention(cfg, dtype, device)

    def mix(self, x, *, positions=None, window: int = 0,
            kernel: str = "flash", ctx=None):
        return attn.gqa_forward(self.norm(x), self.attn, self.cfg,
                                positions=positions, window=window,
                                kernel=kernel, ctx=ctx)

    def mix_decode(self, x, cache, pos: int, *, window: int = 0, ctx=None):
        return attn.gqa_decode(self.norm(x), self.attn, cache, pos, self.cfg,
                               window=window, ctx=ctx)


class MambaLayer(_MixBlock):
    """x + Mamba2(RMSNorm(x))."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.ssm = ssm_mod.Mamba2(cfg, dtype, device)

    def mix(self, x, *, positions=None, window: int = 0,
            kernel: str = "flash", ctx=None):
        return ssm_mod.ssm_forward(self.norm(x), self.ssm, self.cfg,
                                   kernel=kernel, ctx=ctx)

    def mix_decode(self, x, cache, pos: int, *, window: int = 0, ctx=None):
        return ssm_mod.ssm_decode(self.norm(x), self.ssm, cache, self.cfg,
                                  ctx)


class MLSTMLayer(_MixBlock):
    """x + mLSTM(RMSNorm(x))."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.mlstm = xlstm_mod.MLSTM(cfg, dtype, device)

    def mix(self, x, *, positions=None, window: int = 0,
            kernel: str = "flash", ctx=None):
        return xlstm_mod.mlstm_forward(self.norm(x), self.mlstm, self.cfg,
                                       ctx)

    def mix_decode(self, x, cache, pos: int, *, window: int = 0, ctx=None):
        return xlstm_mod.mlstm_decode(self.norm(x), self.mlstm, cache,
                                      self.cfg, ctx)


class SLSTMLayer(_MixBlock):
    """x + sLSTM(RMSNorm(x))."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.slstm = xlstm_mod.SLSTM(cfg, dtype, device)

    def mix(self, x, *, positions=None, window: int = 0,
            kernel: str = "flash", ctx=None):
        return xlstm_mod.slstm_forward(self.norm(x), self.slstm, self.cfg,
                                       ctx)

    def mix_decode(self, x, cache, pos: int, *, window: int = 0, ctx=None):
        return xlstm_mod.slstm_decode(self.norm(x), self.slstm, cache,
                                      self.cfg, ctx)


def hybrid_layout(cfg: ModelConfig):
    """(groups, attn_every, rem): the hybrid runs ``groups`` groups of
    ``attn_every`` Mamba2 layers and ``rem`` more, the shared block before
    each group and before the remainder."""
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.attn_every, cfg.n_layers - g * cfg.attn_every


def xlstm_layout(cfg: ModelConfig):
    """(groups, slstm_every, rem): the xLSTM runs ``groups`` groups of
    ``slstm_every - 1`` mLSTM layers and an sLSTM layer, then ``rem``
    mLSTM layers (with ``slstm_every`` 0: no group, ``n_layers`` mLSTM
    layers)."""
    k = cfg.slstm_every
    if not k:
        return 0, 0, cfg.n_layers
    g = cfg.n_layers // k
    return g, k, cfg.n_layers - g * k


def vlm_assemble(tokens, vision_embeds, embed: Embed, cfg: ModelConfig,
                 ctx: Optional[ShardCtx] = None):
    """The reference's ``_vlm_assemble``: the vision embeddings (B, P, d),
    cast to the token embeddings' dtype, spliced before the text's, and
    the M-RoPE positions (3, B, S) int32: vision patch i at (0, i // grid,
    i % grid) with grid = int(sqrt(P)), text from ``grid`` on (not P) on
    all three streams."""
    tok = embed.embed(tokens, ctx)
    p_vis = cfg.n_vision_tokens
    if vision_embeds is None or vision_embeds.shape[1] != p_vis:
        raise ValueError(f"{cfg.arch_id}: a vlm forward needs vision_embeds "
                         f"of {p_vis} tokens")
    x = torch.cat([vision_embeds.to(tok.dtype), tok], dim=1)
    b, s = x.shape[:2]
    grid = max(1, int(p_vis ** 0.5))
    idx = torch.arange(p_vis, device=x.device)
    vis_pos = torch.stack([torch.zeros_like(idx), idx // grid, idx % grid])
    tpos = torch.arange(s - p_vis, device=x.device) + grid
    pos = torch.cat([vis_pos, tpos[None].expand(3, -1)], dim=1)   # (3,S)
    return x, pos[:, None, :].expand(3, b, s).to(torch.int32)


class Transformer(nn.Module):
    """Parameters of an LM, in ``cfg.dtype`` (the MoE router, the hybrid's
    dt_bias, A_log and D, the mLSTM's gates and the sLSTM's biases in
    float32), left uninitialised: :func:`init_params` draws them,
    ``load_state_dict(params_from_jax(tree))`` copies a reference tree."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        dtype = _dtype(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                           dtype, device)

        def make(cls, n):
            return nn.ModuleList(cls(cfg, dtype, device) for _ in range(n))

        if cfg.family == "hybrid":
            g, k, rem = hybrid_layout(cfg)
            self.shared_attn = SharedAttention(cfg, dtype, device)
            self.groups = nn.ModuleList(make(MambaLayer, k) for _ in range(g))
            self.rem = make(MambaLayer, rem)
        elif cfg.family == "ssm" and cfg.slstm_every:
            g, k, rem = xlstm_layout(cfg)
            self.groups = nn.ModuleList(
                nn.ModuleList([*make(MLSTMLayer, k - 1),
                               SLSTMLayer(cfg, dtype, device)])
                for _ in range(g))
            self.rem = make(MLSTMLayer, rem)
        elif cfg.family == "ssm":
            self.layers = make(MLSTMLayer, cfg.n_layers)
        elif cfg.family == "moe":
            dense_cfg = dataclasses.replace(cfg, family="dense",
                                            cross_attention=False)
            self.dense_layers = nn.ModuleList(
                DenseLayer(dense_cfg, dtype, device)
                for _ in range(cfg.first_dense))
            self.layers = make(MoELayer, cfg.n_layers - cfg.first_dense)
        else:
            self.layers = make(DenseLayer, cfg.n_layers)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)

    def blocks(self):
        """The blocks in the order the forward runs them: the layers; the
        MoE family's dense layers, then its MoE layers; the xLSTM's groups
        ([mLSTM ×(k-1), sLSTM]) and its remainder; or the hybrid's shared
        block before each group of Mamba2 layers and before the
        remainder."""
        fam = self.cfg.family
        if fam == "moe":
            yield from self.dense_layers
        if fam == "hybrid":
            for group in [*self.groups, self.rem]:
                if len(group):
                    yield self.shared_attn
                    yield from group
        elif fam == "ssm" and self.cfg.slstm_every:
            for group in [*self.groups, self.rem]:
                yield from group
        else:
            yield from self.layers

    def forward_aux(self, tokens, *, vision_embeds=None, cond_embeds=None,
                    window: int = 0, kernel: str = "flash",
                    remat: bool = False, ctx: Optional[ShardCtx] = None,
                    gather: bool = True):
        """tokens (B, S) -> (logits (B, S', V), the MoE layers' summed aux
        loss, a float32 scalar: zero without MoE layers).  A vlm splices
        ``vision_embeds`` (B, P, d) before the text (S' = P + S) and runs
        at its M-RoPE positions; an audio model attends to ``cond_embeds``
        (B, C, d), cast to the activations' dtype.  On a mesh (``ctx``) the
        tokens are this rank's rows and the logits come back gathered over
        the vocabulary, or, without ``gather``, this rank's vocabulary
        block when the head is sharded.  ``remat`` runs each
        block under ``torch.utils.checkpoint`` (non-reentrant): its
        activations are recomputed in the backward instead of kept (the
        reference's ``jax.checkpoint``); the values are the same."""
        with _swapped(self, _gather_top(self, ctx)):
            if self.cfg.family == "vlm":
                x, positions = vlm_assemble(tokens, vision_embeds,
                                            self.embed, self.cfg, ctx)
            else:
                x, positions = self.embed.embed(tokens, ctx), None
            cond = None if cond_embeds is None else cond_embeds.to(x.dtype)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            kw = dict(positions=positions, cond=cond, window=window,
                      kernel=kernel, ctx=ctx)
            for block in self.blocks():
                moe = isinstance(block, MoELayer)
                out = block_call(block, "forward_aux" if moe else "forward",
                                 x, remat, **kw)
                if moe:
                    x, a = out
                    aux = aux + a
                else:
                    x = out
            return self.embed.unembed(self.final_norm(x), ctx,
                                      gather=gather), aux

    def forward(self, tokens, *, vision_embeds=None, cond_embeds=None,
                window: int = 0, kernel: str = "flash"):
        """tokens (B, S) -> logits (B, S', V), as :meth:`forward_aux`."""
        return self.forward_aux(tokens, vision_embeds=vision_embeds,
                                cond_embeds=cond_embeds, window=window,
                                kernel=kernel)[0]


@contextlib.contextmanager
def _swapped(module: nn.Module, tensors: Dict[str, torch.Tensor]):
    """``module``'s parameters named in ``tensors`` (dotted, relative to
    it) replaced by those tensors for the duration of the block."""
    saved = []
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        m = module.get_submodule(owner) if owner else module
        saved.append((m, leaf, m._parameters[leaf]))
        m._parameters[leaf] = t
    try:
        yield
    finally:
        for m, leaf, p in reversed(saved):
            m._parameters[leaf] = p


def _fsdp_params(module: nn.Module):
    """(name, shard) of ``module``'s FSDP-sharded parameters."""
    return [(n, p) for n, p in module.named_parameters()
            if hasattr(p, "fsdp_dim")]


def _gather_top(model: "Transformer", ctx: Optional[ShardCtx]):
    """The embedding's, the head's and the final norm's FSDP shards
    gathered (kept for the whole forward, which uses the embedding at both
    ends when it is tied); none without FSDP."""
    out = {}
    for prefix, m in (("embed.", model.embed),
                      ("final_norm.", model.final_norm)):
        for n, p in _fsdp_params(m):
            out[prefix + n] = fsdp_gather(p, ctx.mesh, "data", p.fsdp_dim)
    return out


def block_call(block: nn.Module, method: str, x, remat: bool, **kw):
    """``block.<method>(x, **kw)``, under ``torch.utils.checkpoint`` with
    ``remat``.  A block with FSDP shards (on the mesh of ``kw["ctx"]``)
    gathers them first and, under autograd, always runs under the
    checkpoint, so its gathered weights are not kept for the backward but
    gathered again there: FSDP's memory, not every block's whole weights
    held until the backward."""
    fn = getattr(block, method)
    shards = _fsdp_params(block)
    if not shards:
        return checkpoint(fn, x, use_reentrant=False, **kw) if remat \
            else fn(x, **kw)
    names = [n for n, _ in shards]
    dims = [p.fsdp_dim for _, p in shards]
    ctx = kw["ctx"]

    def run(x, *local):
        full = {n: fsdp_gather(t, ctx.mesh, "data", d)
                for n, t, d in zip(names, local, dims)}
        with _swapped(block, full):
            return fn(x, **kw)
    local = [p for _, p in shards]
    if torch.is_grad_enabled():
        return checkpoint(run, x, *local, use_reentrant=False)
    return run(x, *local)


# ===========================================================================
# parameters
# ===========================================================================
# the modules init_params resets, in the order model.modules() meets them
_DRAWN = (attn.GQAttention, attn.MLAttention, attn.CrossAttention, MLP,
          moe_mod.MoE, ssm_mod.Mamba2, xlstm_mod.MLSTM, xlstm_mod.SLSTM,
          RMSNorm)


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = "cuda", ctx: Optional[ShardCtx] = None,
                fsdp: bool = False) -> Transformer:
    """A :class:`Transformer` on ``device`` with weights drawn from a
    ``torch.Generator`` there, seeded with ``seed``: fan-in truncated
    normals for every matrix, ones for every norm scale (and the Mamba2,
    mLSTM and sLSTM blocks' constants, as their reference inits).

    On a mesh (``ctx``) the model is built on the meta device and each
    leaf becomes this rank's slice under ``param_specs(fsdp=fsdp)`` on the
    mesh's device (:func:`shard_model`); each leaf is then drawn whole, in
    the one-card order, and the slice kept, so the sharded model holds the
    one-card model's weights of the same seed.  On a dry mesh (the meta
    device) the shards have their shapes and nothing is drawn."""
    if ctx is not None and ctx.mesh is not None:
        model = shard_model(Transformer(cfg, device="meta"), ctx, fsdp)
        dev = ctx.mesh.device
        if dev.type == "meta":
            return model.eval()
    else:
        dev = resolve_device(device)
        model = Transformer(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.embed.reset_parameters(gen)
    for module in model.modules():
        if isinstance(module, _DRAWN):
            module.reset_parameters(gen)
    return model.eval()


def shard_model(model: Transformer, ctx: ShardCtx,
                fsdp: bool = False) -> Transformer:
    """Replace each of ``model``'s parameters (whole, on any device, meta
    included) by an uninitialised parameter of this rank's slice on the
    mesh's device, per ``param_specs(fsdp=fsdp)``.  A sliced parameter
    carries ``full_shape`` and ``shard_slices``; an FSDP one ``fsdp_dim``
    (its dim sharded over ``data``).  The specs are kept in
    ``model.param_specs``."""
    mesh = ctx.mesh
    specs = shd.param_specs({n: p.shape for n, p in
                             model.named_parameters()}, ctx, fsdp=fsdp)
    for name, p in list(model.named_parameters()):
        spec = specs[name]
        owner, _, leaf = name.rpartition(".")
        new = nn.Parameter(torch.empty(shd.local_shape(p.shape, spec, mesh),
                                       dtype=p.dtype, device=mesh.device),
                           requires_grad=p.requires_grad)
        if tuple(new.shape) != tuple(p.shape):
            new.full_shape = p.shape
            new.shard_slices = shd.shard_slices(p.shape, spec, mesh)
        if "data" in spec:
            new.fsdp_dim = spec.index("data")
        setattr(model.get_submodule(owner), leaf, new)
    model.param_specs = specs
    return model


@torch.no_grad()
def load_full_(model: Transformer, state: Dict[str, torch.Tensor]) -> None:
    """Copy a whole (one-card) state dict into ``model``, each leaf cut to
    the slice the model's parameter holds (the whole leaf when it is not
    sharded)."""
    for name, p in model.named_parameters():
        t = state[name]
        if hasattr(p, "shard_slices"):
            t = t[p.shard_slices]
        p.copy_(t)


def gather_full(tensor: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A whole leaf from the ranks' slices of it under ``spec``: gathered
    along each sharded dim over that dim's axes.  Every rank of the mesh
    calls it."""
    from repro_torch.parallel import comm
    for dim, entry in enumerate(spec):
        if entry:
            tensor = comm.all_gather(tensor, mesh, entry, dim)
    return tensor


def full_state(model: Transformer, ctx: ShardCtx) -> Dict[str, torch.Tensor]:
    """The whole (one-card) state dict of a sharded model, gathered on
    every rank (a collective call)."""
    specs = getattr(model, "param_specs", None)
    return {n: gather_full(p.detach(), specs[n], ctx.mesh) if specs else
            p.detach() for n, p in model.named_parameters()}


def params_from_jax(tree, like: Optional[Transformer] = None
                    ) -> Dict[str, torch.Tensor]:
    """The reference's param tree (leaves as numpy arrays) as a
    :class:`Transformer` state dict in float32, each leaf mapped once:
    ``embed``/``final_norm``/``shared_attn`` leaves by name; the dense,
    vlm, audio (``cross.*``, ``norm_c.scale``) and MoE ``layers`` (stacked
    on a leading L axis) split into ``layers.<i>.<path>``; the MoE family's
    ``dense_layers`` (a list, not stacked) into ``dense_layers.<i>.<path>``;
    the hybrid's ``groups`` (stacked (g, attn_every, ...)) into
    ``groups.<i>.<j>.ssm.<leaf>`` and ``groups.<i>.<j>.norm.scale``, and
    its ``rem`` ((rem, ...), or None) into ``rem.<j>...``.  The xLSTM's
    ``groups`` ({mlstm, norms_m} (g, k-1, ...), {slstm, norms_s} (g, ...))
    into ``groups.<i>.<j>.mlstm`` for j < k-1 and ``groups.<i>.<k-1>.slstm``
    with their ``norm.scale``, its ``rem`` {mlstm, norms} into
    ``rem.<j>.mlstm``, and without sLSTM blocks ``layers``/``norms`` into
    ``layers.<i>.mlstm`` and ``layers.<i>.norm.scale``.  The weights keep
    their layouts.  Raises on a tree with other top-level entries.  With
    ``like`` (a sharded :class:`Transformer`) each leaf is cut to the
    slice that model's parameter holds."""
    out = _params_from_jax(tree)
    if like is None:
        return out
    params = dict(like.named_parameters())
    return {n: t[params[n].shard_slices] if hasattr(params[n], "shard_slices")
            else t for n, t in out.items()}


def _params_from_jax(tree) -> Dict[str, torch.Tensor]:
    dense = {"embed", "final_norm", "layers"}
    moe = {"embed", "final_norm", "dense_layers", "layers"}
    hybrid = {"embed", "final_norm", "shared_attn", "groups", "rem"}
    xlstm = {"embed", "final_norm", "groups", "rem"}
    mlstm_only = {"embed", "final_norm", "layers", "norms"}
    if set(tree) not in (dense, moe, hybrid, xlstm, mlstm_only):
        raise ValueError("not a dense or hybrid (or MoE) param tree, nor an "
                         f"xLSTM one: entries {sorted(tree)}")

    def leaves(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix[:-1], np.asarray(node, dtype=np.float32)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    out: Dict[str, torch.Tensor] = {}

    def put(node, prefix, axes):
        """Every leaf of ``node``, its leading ``len(axes)`` stacking axes
        split into ``prefix`` formatted with their indices."""
        for name, a in leaves(node):
            for idx in np.ndindex(*a.shape[:len(axes)]):
                out[prefix.format(*idx) + name] = tensor(a[idx])

    for top in ("embed", "final_norm", "shared_attn"):
        for name, a in leaves(tree.get(top) or {}, f"{top}."):
            out[name] = tensor(a)
    for i, layer in enumerate(tree.get("dense_layers") or []):
        for name, a in leaves(layer, f"dense_layers.{i}."):
            out[name] = tensor(a)
    groups, rem = tree.get("groups"), tree.get("rem")
    if set(tree) == mlstm_only:
        put(tree["layers"], "layers.{}.mlstm.", "i")
        put(tree["norms"], "layers.{}.norm.", "i")
    else:
        put(tree.get("layers") or {}, "layers.{}.", "i")
    if set(tree) == xlstm:
        last = groups["norms_m"]["scale"].shape[1]          # slstm_every - 1
        put(groups["mlstm"], "groups.{}.{}.mlstm.", "ij")
        put(groups["norms_m"], "groups.{}.{}.norm.", "ij")
        put(groups["slstm"], "groups.{}." + f"{last}.slstm.", "i")
        put(groups["norms_s"], "groups.{}." + f"{last}.norm.", "i")
        if rem is not None:
            put(rem["mlstm"], "rem.{}.mlstm.", "j")
            put(rem["norms"], "rem.{}.norm.", "j")
        return out
    if groups is not None:                                  # the hybrid
        put(groups["ssm"], "groups.{}.{}.ssm.", "ij")
        put(groups["norms"], "groups.{}.{}.norm.", "ij")
    if rem is not None:
        put(rem["ssm"], "rem.{}.ssm.", "j")
        put(rem["norms"], "rem.{}.norm.", "j")
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


def local_batch(batch, ctx: Optional[ShardCtx]):
    """(this rank's rows of a global batch, the ctx of the call): each leaf
    cut over the data axes where ``batch_specs`` shards it, and
    ``rows_sharded`` set when they do.  Without a mesh: (batch, ctx)."""
    if ctx is None or ctx.mesh is None:
        return batch, ctx
    specs = shd.batch_specs(batch, ctx)
    out, rows = {}, False
    for k, v in batch.items():
        entry = specs[k][0] if specs[k] else None
        if entry:
            v = v[shd.shard_slices(v.shape, specs[k], ctx.mesh)]
            rows = True
        out[k] = v
    return out, dataclasses.replace(ctx, rows_sharded=rows)


def forward_with_aux(params: Transformer, batch, cfg: ModelConfig, *,
                     window: int = 0, kernel: str = "flash",
                     remat: bool = False, ctx: Optional[ShardCtx] = None,
                     gather: bool = True):
    """The reference's ``forward``: batch {"tokens": (B, S)} (with
    "vision_embeds" for a vlm, "cond_embeds" for an audio model) ->
    (logits (B, S', V) in the config's dtype, {"moe_aux": the MoE layers'
    summed aux loss}, zero for the other families).  ``remat``: see
    :meth:`Transformer.forward_aux`.  On a mesh (``ctx``) the batch is the
    global one and the logits are this rank's rows (:func:`local_batch`);
    ``gather`` False leaves them in vocabulary blocks when the head is
    sharded."""
    batch, ctx = local_batch(batch, ctx)
    with run_config(params, cfg):
        logits, aux = params.forward_aux(
            batch["tokens"], vision_embeds=batch.get("vision_embeds"),
            cond_embeds=batch.get("cond_embeds"), window=window,
            kernel=kernel, remat=remat, ctx=ctx, gather=gather)
    return logits, {"moe_aux": aux}


def forward(params: Transformer, batch, cfg: ModelConfig, *, window: int = 0,
            kernel: str = "flash",
            ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """batch -> logits (B, S', V) in the config's dtype
    (:func:`forward_with_aux` also returns the aux loss)."""
    return forward_with_aux(params, batch, cfg, window=window,
                            kernel=kernel, ctx=ctx)[0]


def prefill(params: Transformer, batch, cfg: ModelConfig, *, window: int = 0,
            kernel: str = "flash",
            ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Prefill = the full forward's logits, as in the reference: the serving
    loop fills the cache by chaining :func:`decode_step`."""
    return forward(params, batch, cfg, window=window, kernel=kernel, ctx=ctx)


def lm_loss(params: Transformer, batch, cfg: ModelConfig, *, window: int = 0,
            kernel: str = "torch", remat: bool = False,
            ctx: Optional[ShardCtx] = None):
    """The training objective (the reference's ``lm_loss``): batch as
    :func:`forward_with_aux` takes it plus "labels" (B, S) int64 ->
    (loss, {"ce": the mean cross-entropy, "moe_aux": the MoE layers'
    summed aux loss}), float32 scalars; loss = ce + ``router_aux_coef`` ·
    moe_aux.  A vlm's loss runs over the text region only: the first
    ``n_vision_tokens`` logits (the vision prefix has no labels) are
    dropped.

    ``kernel`` defaults to ``"torch"``, not ``"flash"`` as the forward's
    does: the kernels have no backward (:mod:`repro_torch.kernels.ops`
    raises under autograd on a card), and the reference's ``lm_loss``
    likewise trains through its plain ``"jnp"`` path.

    On a mesh the batch is the global one and the loss this rank's rows'
    (the train step averages it over the data axes); with the head sharded
    over the vocabulary the cross-entropy is vocab-parallel
    (:func:`~repro_torch.models.layers.vocab_parallel_cross_entropy`)."""
    labels = local_batch(batch, ctx)[0]["labels"]
    logits, aux = forward_with_aux(params, batch, cfg, window=window,
                                   kernel=kernel, remat=remat, ctx=ctx,
                                   gather=False)
    if cfg.family == "vlm":
        logits = logits[:, cfg.n_vision_tokens:]
    if tp(ctx) and params.embed.head_block()[1]:
        ce = vocab_parallel_cross_entropy(logits, labels, ctx)
    else:
        ce = softmax_cross_entropy(logits, labels)
    return ce + cfg.router_aux_coef * aux["moe_aux"], {
        "ce": ce, "moe_aux": aux["moe_aux"]}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               window: int = 0, device: DeviceLike = "cuda",
               ctx: Optional[ShardCtx] = None):
    """Zeroed cache in the config's dtype (the recurrent states in
    float32); T = min(cache_len, window) KV slots with a window (a ring
    buffer), else cache_len.

    dense, vlm: {"layers": [{"k", "v"}, ...]}, one (B, T, KV, hd) pair a
    layer; audio: each layer's entry also "cross_kv" {"k", "v"} (B, C, H,
    hd), zeros until the caller fills it, as in the reference.
    moe: {"dense_layers": [...], "layers": [...]}, a layer's entry {"k",
    "v"} for GQA or {"c_kv" (B, T, r), "k_rope" (B, T, rope)} for MLA.
    ssm (xLSTM): {"groups": [{"mlstm": [{"state", "norm"}, ...], "slstm":
    {"c", "n", "h", "m"}}, ...], "rem": [...] or None}, or {"layers":
    [...]} without sLSTM blocks.
    hybrid: {"groups": [{"attn_kv": {"k", "v"}, "ssm": [{"state", "conv"},
    ...]}, ...], "rem": {"attn_kv", "ssm"} or None}: one KV cache for each
    application of the shared block and one Mamba2 cache a layer.

    On a mesh (``ctx``) ``batch`` is the global batch and each leaf is this
    rank's slice under ``cache_specs`` on the mesh's device, filled with
    the leaf's constant start (zeros, the sLSTM's stabiliser ``M_INIT``); a
    sliced leaf carries ``full_shape``.  A Mamba2 layer's "conv" holds the
    channels the rank convolves (:func:`~repro_torch.models.ssm.
    conv_channels`: with its own heads [x_r, B, C], not the spec's
    contiguous block)."""
    _check_supported(cfg)
    if ctx is not None and ctx.mesh is not None:
        tree = _cache_tree(cfg, batch, cache_len, window,
                           torch.device("meta"))
        starts = _cache_tree(cfg, 1, 1, 0, torch.device("cpu"))
        mesh = ctx.mesh

        def local(name, spec, t, start):
            shape = shd.local_shape(t.shape, spec, mesh)
            if name == "conv":                  # a Mamba2 layer's
                shape = (*shape[:-1], ssm_mod.conv_channels(cfg, ctx))
            out = torch.full(shape, start.reshape(-1)[0].item(),
                             dtype=t.dtype, device=mesh.device)
            if tuple(out.shape) != tuple(t.shape):
                out.full_shape = t.shape
            return out
        return _zip_tree(local, shd.cache_specs(tree, ctx), tree, starts)
    return _cache_tree(cfg, batch, cache_len, window, resolve_device(device))


def _zip_tree(fn, *trees, name: str = ""):
    """``fn(name, *leaves)`` over the leaves of trees of one structure
    (nested dicts and lists; None kept), ``name`` a leaf's innermost dict
    key."""
    first = trees[1]
    if isinstance(first, dict):
        return {k: _zip_tree(fn, *(t[k] for t in trees), name=k)
                for k in first}
    if isinstance(first, list):
        return [_zip_tree(fn, *leaves, name=name) for leaves in zip(*trees)]
    return None if first is None else fn(name, *trees)


def _cache_tree(cfg: ModelConfig, batch: int, cache_len: int, window: int,
                dev: torch.device):
    kv_len = min(cache_len, window) if window else cache_len
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
    if cfg.family == "ssm":
        g, k, rem = xlstm_layout(cfg)

        def mlstm(n):
            return [xlstm_mod.mlstm_init_cache(cfg, batch, dev)
                    for _ in range(n)]
        if not k:
            return {"layers": mlstm(rem)}
        return {"groups": [{"mlstm": mlstm(k - 1),
                            "slstm": xlstm_mod.slstm_init_cache(cfg, batch,
                                                                dev)}
                           for _ in range(g)],
                "rem": mlstm(rem) if rem else None}
    if cfg.family == "moe":
        return {"dense_layers": [kv() for _ in range(cfg.first_dense)],
                "layers": [kv() for _ in range(cfg.n_layers -
                                               cfg.first_dense)]}

    def layer():
        c = kv()
        if cfg.cross_attention:
            shape = (batch, cfg.n_cond_tokens, cfg.n_heads, cfg.head_dim)
            c["cross_kv"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                             "v": torch.zeros(shape, dtype=dtype, device=dev)}
        return c
    return {"layers": [layer() for _ in range(cfg.n_layers)]}


def decode_step(params: Transformer, cache, batch, pos: int,
                cfg: ModelConfig, *, window: int = 0,
                ctx: Optional[ShardCtx] = None):
    """One-token step.  batch {"tokens": (B, 1)}; pos the absolute position
    (a vlm's on all three M-RoPE streams, as in the reference).  Returns
    (logits (B, 1, V), cache), the cache written in place.  The MoE layers
    see the B tokens of the step, so their capacity is ``ceil(B·k·cf /
    E)``, as in the reference.  On a mesh the batch is the global one, the
    cache this rank's (:func:`init_cache` with ``ctx``) and the logits
    this rank's rows, gathered over the vocabulary."""
    batch, ctx = local_batch(batch, ctx)
    with run_config(params, cfg), _swapped(params, _gather_top(params, ctx)):
        x = params.embed.embed(batch["tokens"], ctx)
        for block, c in zip(params.blocks(),
                            _block_caches(cache, params.cfg.family)):
            x, _ = block_call(block, "decode", x, False, cache=c, pos=pos,
                              window=window, ctx=ctx)
        return params.embed.unembed(params.final_norm(x), ctx), cache


def _block_caches(cache, family: str):
    """The cache's per-block entries in :meth:`Transformer.blocks` order."""
    if family == "hybrid":
        for group in [*cache["groups"], cache["rem"]]:
            if group is not None:
                yield group["attn_kv"]
                yield from group["ssm"]
    elif "groups" in cache:                                 # xLSTM
        for group in cache["groups"]:
            yield from group["mlstm"]
            yield group["slstm"]
        yield from cache["rem"] or []
    else:
        yield from cache.get("dense_layers", [])
        yield from cache["layers"]
