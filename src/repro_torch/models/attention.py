"""Attention: blockwise full / sliding-window attention, the decode step
over a KV cache, the GQA module (with Qwen2-VL's M-RoPE where the config
has ``mrope_sections``), DeepSeek-V2's MLA and MusicGen's cross-attention
(counterpart of ``repro/models/attention.py`` on one device).

``gqa_forward`` runs the attention core one of two ways: ``kernel="flash"``
(the default) calls :func:`repro_torch.kernels.ops.flash_attention`, the
hand-written CUDA kernel on a card and its plain version on the CPU, as
the reference's ``"pallas"`` calls its Pallas kernel; ``kernel="torch"``
runs :func:`blockwise_attention` in plain PyTorch, the reference's
``"jnp"``.  Products of bfloat16 operands are taken in float32 where the
reference asks for a float32 result (``preferred_element_type``).

MLA keeps a compressed ``c_kv`` (rank r) and one shared rope key a token.
``mla_forward`` expands them to per-head keys and values and runs
:func:`blockwise_attention` with v padded to the qk width, whatever
``kernel`` says, as the reference does (it reaches no Pallas kernel);
``mla_decode`` scores against the compressed cache itself, with ``w_uk``
absorbed into the query and ``w_uv`` applied after the attention.

``cross_attention`` attends from the sequence to the conditioning
embeddings: no RoPE, no mask, C keys; it reaches no Pallas kernel in the
reference and stays plain PyTorch here.  The decode steps write the new
entries into the cache in place, where the reference returns a new cache:
that keeps one copy of a cache in device memory.

On a mesh (``ctx`` with a model axis above 1) each module runs on the heads
its rank holds (``parallel/sharding.py``): wq, wk, wv head-sharded and wo
row-sharded, the partial sums all-reduced in the activation dtype
(``repro/models/attention.py:279-285``); ``flash_attention`` runs at the
local H and KV.  Where q's heads divide the axis and KV's do not, wk and wv
stay whole and a rank takes the KV heads of its q heads' groups.  Where
the heads do not divide it, the attention is replicated, or, with
``seq_shard_attn``, :func:`qshard_attention` gives each rank a stripe of
the queries (the reference's condition, ``attention.py:260-262``).  MLA
shards w_uq, w_uk, w_uv and wo by head and keeps w_dq, w_dkv and w_krope
whole.  Decode reads the cache as ``cache_specs`` lays it out: KV heads
over ``model``, or with ``cache_seq_shard`` the cache's sequence, where
each rank attends over its stripe and returns (max, sum, accumulator),
the ranks combine them (:func:`combine_partials`, the combine GSPMD
inserts in the reference) and the rank that owns the step's slot writes
the new entry.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (ShardCtx, apply_mrope, apply_rope,
                                      copy_to, full_shape, gather_from,
                                      reduce_from, split_to, tp,
                                      trunc_normal_)
from repro_torch.parallel import comm

NEG_INF = -2.0 ** 30
KERNELS = ("flash", "torch")


class GQAttention(nn.Module):
    """The GQA projections in the reference's layouts: wq (d, H, hd),
    wk and wv (d, KV, hd), wo (H, hd, d)."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = nn.Parameter(torch.empty(d, h, hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, kv, hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, kv, hd, **kw))
        self.wo = nn.Parameter(torch.empty(h, hd, d, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        d = full_shape(self.wq)[0]
        for w in (self.wq, self.wk, self.wv):
            trunc_normal_(w, d, generator)
        wo = full_shape(self.wo)
        trunc_normal_(self.wo, wo[0] * wo[1], generator)

    def project(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(B, S, d) · (d, N, hd) -> (B, S, N, hd) in x's dtype."""
        b, s, d = x.shape
        return (x @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """(B, S, H, hd) · (H, hd, d) -> (B, S, d) in o's dtype."""
        b, s = o.shape[:2]
        return o.reshape(b, s, -1) @ self.wo.reshape(-1, self.wo.shape[2])


# ---------------------------------------------------------------------------
# blockwise (flash-style) attention core
# ---------------------------------------------------------------------------
def _chunk_sizes(s_q: int, s_kv: int) -> tuple[int, int]:
    return min(s_q, 2048), min(s_kv, 2048)


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        q_offset: int = 0,
                        softmax_scale: Optional[float] = None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0.

    Online softmax over chunks of up to 2048 queries and keys, in float32;
    chunks no query can see are skipped.  ``q_offset``: absolute position
    of q[0] relative to k[0].  Returns (B, Sq, H, hd) in q's dtype; p is
    cast to v's dtype before the product with v, as in the reference."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qc, kc = _chunk_sizes(sq, skv)
    n_q, n_kv = sq // qc, skv // kc
    if n_q * qc != sq or n_kv * kc != skv:
        raise ValueError(f"lengths {sq}, {skv} are not multiples of the "
                         f"chunks {qc}, {kc}")
    f32 = torch.float32
    qg = q.reshape(b, sq, kvh, g, hd)
    outs = []
    for iq in range(n_q):
        q_blk = qg[:, iq * qc:(iq + 1) * qc].to(f32)           # (B,qc,KV,G,hd)
        q_lo = q_offset + iq * qc
        q_hi = q_lo + qc - 1
        m = torch.full((b, kvh, g, qc), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((b, kvh, g, qc), dtype=f32, device=q.device)
        acc = torch.zeros((b, kvh, g, qc, hd), dtype=f32, device=q.device)
        for ik in range(n_kv):
            k_lo = ik * kc
            k_hi = k_lo + kc - 1
            if causal and k_lo > q_hi:
                continue                                        # fully masked
            if window and k_hi < q_lo - window + 1:
                continue                                        # outside window
            k_blk = k[:, k_lo:k_lo + kc]                        # (B,kc,KV,hd)
            v_blk = v[:, k_lo:k_lo + kc]
            s = torch.einsum("bqkgd,btkd->bkgqt", q_blk, k_blk.to(f32)) * scale
            need_mask = (causal and k_hi > q_lo) or (
                window and k_lo < q_hi - window + 1)
            if need_mask:
                qpos = q_lo + torch.arange(qc, device=q.device)[:, None]
                kpos = k_lo + torch.arange(kc, device=q.device)[None, :]
                ok = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
                if causal:
                    ok &= kpos <= qpos
                if window:
                    ok &= kpos > qpos - window
                s = s.masked_fill(~ok, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p_ = torch.exp(s - m_new[..., None])
            l = l * alpha + p_.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p_.to(v.dtype).to(f32), v_blk.to(f32))
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-37)
        outs.append(out.permute(0, 3, 1, 2, 4))                 # (B,qc,KV,G,hd)
    return torch.cat(outs, dim=1).reshape(b, sq, h, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid_len=None,
                     softmax_scale: Optional[float] = None):
    """Single-step attention.  q: (B, 1, H, hd); caches: (B, T, KV, hd).

    ``valid_len``: cache positions >= valid_len are masked (None = the
    whole cache is valid)."""
    b, _, h, hd = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qg = q.reshape(b, kvh, g, hd).to(f32)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.to(f32)) * scale
    if valid_len is not None:
        mask = torch.arange(t, device=q.device) < valid_len
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).to(f32),
                     v_cache.to(f32))
    return o.reshape(b, 1, h, hd).to(q.dtype)


def blockwise_dyn(q, k, v, q_offset: int, *, causal: bool, window: int = 0,
                  softmax_scale: Optional[float] = None):
    """The reference's ``_blockwise_dyn``: online-softmax attention of a
    query stripe starting at absolute position ``q_offset`` (a rank's
    stripe), every key chunk of up to 2048 computed with a mask (no chunk
    skipped).  q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd)."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    kc = min(skv, 2048)
    if skv % kc:
        raise ValueError(f"key length {skv} is not a multiple of {kc}")
    f32 = torch.float32
    qg = q.reshape(b, sq, kvh, g, hd).to(f32)
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=f32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=f32, device=q.device)
    for ik in range(skv // kc):
        k_blk = k[:, ik * kc:(ik + 1) * kc]
        v_blk = v[:, ik * kc:(ik + 1) * kc]
        s = torch.einsum("bqkgd,btkd->bkgqt", qg, k_blk.to(f32)) * scale
        kpos = ik * kc + torch.arange(kc, device=q.device)
        ok = torch.ones((sq, kc), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos[None, :] <= qpos[:, None]
        if window:
            ok &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~ok, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p_ = torch.exp(s - m_new[..., None])
        l = l * alpha + p_.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqt,btkd->bkgqd", p_.to(v.dtype).to(f32), v_blk.to(f32))
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-37)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def qshard_attention(q, k, v, ctx: ShardCtx, *, causal: bool = True,
                     window: int = 0):
    """Sequence-parallel attention (the reference's ``qshard_attention``):
    each rank on ``model`` attends its stripe of the queries against the
    whole keys (:func:`blockwise_dyn` at the stripe's offset), and the
    stripes are gathered.  For heads that do not divide the model axis,
    in place of replicating the whole S×S attention on every rank.  The
    backward gathers the stripes' gradients of q and sums those of k and
    v over the ranks."""
    mesh, axis, n = ctx.mesh, ctx.model_axis, ctx.model_size
    sq = q.shape[1]
    if sq % n:
        raise ValueError(f"sequence {sq} does not split over {n} ranks")
    qs = split_to(q, mesh, axis, 1)
    k, v = copy_to(k, mesh, axis), copy_to(v, mesh, axis)
    o = blockwise_dyn(qs, k, v, ctx.model_rank * (sq // n), causal=causal,
                      window=window)
    return gather_from(o, mesh, axis, 1)


def combine_partials(m, l, acc, ctx: ShardCtx):
    """Flash-decoding's combine over ``model``: each rank's running max
    ``m`` (...), sum ``l`` (...) and accumulator ``acc`` (..., X) over its
    stripe of keys, rescaled to the global max and summed; returns
    acc / l in float32."""
    mesh, axis = ctx.mesh, ctx.model_axis
    mg = comm.all_reduce(m, mesh, axis, op="max")
    a = torch.exp(m - mg)
    l = comm.all_reduce(l * a, mesh, axis)
    acc = comm.all_reduce(acc * a[..., None], mesh, axis)
    return acc / torch.clamp_min(l[..., None], 1e-37)


def stripe_attend(s, ok, pv, ctx: ShardCtx):
    """Softmax attention over a stripe of keys, combined over ``model``:
    ``s`` (..., T_l) float32 scores, ``ok`` the valid keys (None: all),
    ``pv(p)`` the product of the stripe's unnormalised probabilities with
    its values (..., X).  Returns (..., X) in float32."""
    if ok is not None:
        s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1)
    pr = torch.exp(s - m[..., None])
    if ok is not None:
        pr = pr * ok
    return combine_partials(m, pr.sum(dim=-1), pv(pr), ctx)


def _local_kv(rank: int, h_local: int, group: int):
    """The KV heads rank ``rank``'s ``h_local`` query heads read, with
    ``group`` query heads a KV head: a slice when the rank's heads cover
    whole groups or lie in one, else one KV head index a query head."""
    off = rank * h_local
    if h_local % group == 0 or group % h_local == 0:
        lo = off // group
        return slice(lo, lo + max(1, h_local // group))
    return torch.tensor([(off + j) // group for j in range(h_local)])


# ---------------------------------------------------------------------------
# GQA module
# ---------------------------------------------------------------------------
def _positions_default(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def gqa_forward(x, p: GQAttention, cfg: ModelConfig, *, positions=None,
                window: int = 0, kernel: str = "flash",
                ctx: Optional[ShardCtx] = None):
    """Full (prefill) causal GQA self-attention.  x: (B, S, d) -> (B, S, d)
    in x's dtype.  positions: (B, S), or (3, B, S) under M-RoPE, where
    plain (B, S) ids stand for three equal streams; None: 0..S-1.  On a
    mesh with the heads sharded: this rank's heads (and their KV heads)
    and the wo partial sums all-reduced in x's dtype; with the heads whole,
    the replicated attention or, with ``seq_shard_attn``,
    :func:`qshard_attention`."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
    b, s, _ = x.shape
    sharded = tp(ctx) and p.wq.shape[1] != cfg.n_heads
    wk, wv = p.wk, p.wv
    if sharded:
        x = copy_to(x, ctx.mesh, ctx.model_axis)
        wk, wv = _kv_weights(p, cfg, ctx)
    q = p.project(x, p.wq)
    k = p.project(x, wk)
    v = p.project(x, wv)
    if positions is None:
        positions = _positions_default(b, s, x.device)
    q, k = _rope(q, k, positions, cfg)
    if tp(ctx) and not sharded and ctx.seq_shard_attn and \
            s % ctx.model_size == 0:
        o = qshard_attention(q, k, v, ctx, causal=True, window=window)
    elif kernel == "flash":
        o = ops.flash_attention(q, k, v, causal=True, window=window)
    else:
        o = blockwise_attention(q, k, v, causal=True, window=window)
    out = p.out(o)
    return reduce_from(out, ctx.mesh, ctx.model_axis) if sharded else out


def _kv_weights(p: GQAttention, cfg: ModelConfig, ctx: ShardCtx):
    """wk and wv for this rank's query heads: its own block when KV is
    sharded, else the whole weights' KV heads of its heads' groups (their
    gradient summed over ``model``)."""
    if p.wk.shape[1] != cfg.n_kv_heads:
        return p.wk, p.wv
    sel = _local_kv(ctx.model_rank, p.wq.shape[1],
                    cfg.n_heads // cfg.n_kv_heads)
    mesh, axis = ctx.mesh, ctx.model_axis
    return copy_to(p.wk, mesh, axis)[:, sel], copy_to(p.wv, mesh, axis)[:, sel]


def _rope(q, k, positions, cfg: ModelConfig):
    """q and k rotated: M-RoPE when the config has ``mrope_sections`` (2-D
    ids broadcast to three equal streams), else RoPE."""
    if not cfg.mrope_sections:
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if positions.ndim == 2:
        positions = positions[None].expand(3, *positions.shape)
    return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
            apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))


def gqa_init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(x, p: GQAttention, cache: Dict[str, torch.Tensor], pos: int,
               cfg: ModelConfig, *, window: int = 0,
               ctx: Optional[ShardCtx] = None):
    """One decode step.  x: (B, 1, d); pos: absolute position (int), on
    all three streams under M-RoPE, as in the reference.

    Full attention: cache length T == sequence length, written at index
    pos.  Sliding window: T == window (a ring buffer), index pos % window.
    Writes the cache in place and returns (out, cache).

    On a mesh the cache is as ``cache_specs`` lays it out.  A cache with
    every KV head takes the step's entries gathered from the ranks'
    blocks.  A cache sharded over its sequence (``cache_seq_shard``) goes
    through :func:`_stripe_decode`; otherwise this rank's heads attend
    over their KV heads.  With the heads sharded, wo's partial sums are
    all-reduced."""
    b = x.shape[0]
    pos = int(pos)
    q = p.project(x, p.wq)
    k = p.project(x, p.wk)
    v = p.project(x, p.wv)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k = _rope(q, k, posb, cfg)
    ck, cv = cache["k"], cache["v"]
    sharded = tp(ctx) and p.wq.shape[1] != cfg.n_heads
    if ck.shape[2] != k.shape[2]:
        k = gather_from(k, ctx.mesh, ctx.model_axis, 2)
        v = gather_from(v, ctx.mesh, ctx.model_axis, 2)
    t = full_shape(ck)[1]
    slot = pos % t if window else pos
    valid = min(pos + 1, t)
    if ck.shape[1] != t:
        o = _stripe_decode(q, k, v, ck, cv, slot, valid, sharded, ctx)
    else:
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        kc, vc = ck, cv
        if sharded and ck.shape[2] == cfg.n_kv_heads:
            sel = _local_kv(ctx.model_rank, q.shape[2],
                            cfg.n_heads // cfg.n_kv_heads)
            kc, vc = ck[:, :, sel], cv[:, :, sel]
        o = decode_attention(q, kc, vc, valid_len=valid)
    out = p.out(o)
    return (reduce_from(out, ctx.mesh, ctx.model_axis) if sharded
            else out), cache


def _stripe_decode(q, k, v, ck, cv, slot: int, valid: int, sharded: bool,
                   ctx: ShardCtx):
    """Decode attention over a cache sharded over its sequence: the rank
    whose stripe holds ``slot`` writes the step's entries; every rank
    attends every head over its stripe (:func:`stripe_attend` combines),
    then keeps its own heads when they are sharded."""
    mesh, axis = ctx.mesh, ctx.model_axis
    b, tl = q.shape[0], ck.shape[1]
    if slot // tl == ctx.model_rank:
        ck[:, slot % tl] = k[:, 0]
        cv[:, slot % tl] = v[:, 0]
    qa = gather_from(q, mesh, axis, 2) if sharded else q
    h, hd, kvh = qa.shape[2], qa.shape[3], ck.shape[2]
    f32 = torch.float32
    qg = qa.reshape(b, kvh, h // kvh, hd).to(f32)
    s = torch.einsum("bkgd,btkd->bkgt", qg, ck.to(f32)) * \
        (1.0 / math.sqrt(hd))
    ok = ctx.model_rank * tl + torch.arange(tl, device=q.device) < valid
    o = stripe_attend(s, ok, lambda pr: torch.einsum(
        "bkgt,btkd->bkgd", pr.to(cv.dtype).to(f32), cv.to(f32)), ctx)
    o = o.reshape(b, 1, h, hd).to(q.dtype)
    return split_to(o, mesh, axis, 2) if sharded else o


# ---------------------------------------------------------------------------
# MLA module (DeepSeek-V2)
# ---------------------------------------------------------------------------
class MLAttention(nn.Module):
    """``mla_init``'s parameters in the reference's layouts: w_dkv (d, r),
    w_krope (d, rope), w_uk (r, H, nope), w_uv (r, H, vh), wo (H, vh, d);
    and either w_dq (d, qr) and w_uq (qr, H, nope + rope) when
    ``q_lora_rank`` > 0, or wq (d, H, nope + rope)."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
        nope, rope, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kw = dict(dtype=dtype, device=device)
        self.w_dkv = nn.Parameter(torch.empty(d, r, **kw))
        self.w_krope = nn.Parameter(torch.empty(d, rope, **kw))
        self.w_uk = nn.Parameter(torch.empty(r, h, nope, **kw))
        self.w_uv = nn.Parameter(torch.empty(r, h, vh, **kw))
        self.wo = nn.Parameter(torch.empty(h, vh, d, **kw))
        if qr:
            self.w_dq = nn.Parameter(torch.empty(d, qr, **kw))
            self.w_uq = nn.Parameter(torch.empty(qr, h, nope + rope, **kw))
            self.wq = None
        else:
            self.w_dq = self.w_uq = None
            self.wq = nn.Parameter(torch.empty(d, h, nope + rope, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fan-in truncated normals: a matrix's first axis (d for the maps
        of x, r for w_uk and w_uv, qr for w_uq), H·vh for wo."""
        for w in (self.w_dkv, self.w_krope, self.w_dq, self.wq, self.w_uk,
                  self.w_uv, self.w_uq):
            if w is not None:
                trunc_normal_(w, full_shape(w)[0], generator)
        wo = full_shape(self.wo)
        trunc_normal_(self.wo, wo[0] * wo[1], generator)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """(B, S, H, vh) · (H, vh, d) -> (B, S, d) in o's dtype."""
        b, s = o.shape[:2]
        return o.reshape(b, s, -1) @ self.wo.reshape(-1, self.wo.shape[2])


def _up(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, r) · (r, H, k) -> (B, S, H, k) in c's dtype."""
    b, s, r = c.shape
    return (c @ w.reshape(r, -1)).view(b, s, w.shape[1], w.shape[2])


def _same(t):
    return t


def _mla_q(x, p: MLAttention, c=_same) -> torch.Tensor:
    """The queries (B, S, H, nope + rope) in x's dtype.  ``c`` marks the
    input of a head-sharded map (:func:`copy_to` on a mesh)."""
    if p.w_dq is not None:
        return _up(c(x @ p.w_dq), p.w_uq)
    return _up(c(x), p.wq)


def _mla_rope_key(x, p: MLAttention, positions, cfg: ModelConfig):
    """The shared rope key (B, S, 1, rope), rotated."""
    return apply_rope((x @ p.w_krope)[:, :, None, :], positions,
                      cfg.rope_theta)


def mla_forward(x, p: MLAttention, cfg: ModelConfig, *, positions=None,
                window: int = 0, kernel: str = "flash",
                ctx: Optional[ShardCtx] = None):
    """Prefill MLA attention: the compressed KV expanded to per-head keys
    and values, the shared rope key broadcast over the heads, v padded
    from vh to nope + rope, blockwise attention with scale
    1/sqrt(nope + rope).  ``kernel`` is accepted and ignored, as in the
    reference.  x: (B, S, d) -> (B, S, d) in x's dtype.  On a mesh with
    the heads sharded: this rank's heads (the whole w_dq, w_dkv and
    w_krope products feed them) and an all-reduce."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
    b, s, _ = x.shape
    nope, rope, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    sharded = tp(ctx) and p.wo.shape[0] != cfg.n_heads
    c = (lambda t: copy_to(t, ctx.mesh, ctx.model_axis)) if sharded \
        else _same
    h = p.w_uk.shape[1]
    if positions is None:
        positions = _positions_default(b, s, x.device)
    q = _mla_q(x, p, c)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    c_kv = c(x @ p.w_dkv)
    k_rope = c(_mla_rope_key(x, p, positions, cfg))
    q_full = torch.cat([q[..., :nope], q_rope], dim=-1)
    k_full = torch.cat([_up(c_kv, p.w_uk), k_rope.expand(b, s, h, rope)],
                       dim=-1)
    v = F.pad(_up(c_kv, p.w_uv), (0, nope + rope - vh))
    o = blockwise_attention(q_full, k_full, v, causal=True, window=window,
                            softmax_scale=1.0 / math.sqrt(nope + rope))
    out = p.out(o[..., :vh])
    return reduce_from(out, ctx.mesh, ctx.model_axis) if sharded else out


def mla_init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    """c_kv (B, T, r) and k_rope (B, T, rope), zeroed."""
    return {"c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


def mla_decode(x, p: MLAttention, cache: Dict[str, torch.Tensor], pos: int,
               cfg: ModelConfig, *, window: int = 0,
               ctx: Optional[ShardCtx] = None):
    """One absorbed-weight decode step.  x: (B, 1, d); pos: absolute
    position (int).  The query's nope part times w_uk scores against the
    compressed cache directly, plus the rope term; the attention runs in
    the compressed space and is up-projected through w_uv.  The cache slot
    is pos (pos % T under a window, a ring buffer).  Writes the cache in
    place and returns (out, cache).  On a mesh this rank's heads read the
    whole compressed cache (written alike on every rank), or a cache
    sharded over its sequence (:func:`_mla_stripe_decode`); with the heads
    sharded, wo's partial sums are all-reduced."""
    b = x.shape[0]
    pos = int(pos)
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    f32 = torch.float32
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = _mla_q(x, p)                                        # (B,1,H,nope+rope)
    q_rope = apply_rope(q[..., nope:], posb, cfg.rope_theta)
    # absorb w_uk into the query: q_c = q_nope · w_ukᵀ -> (B, 1, H, r)
    q_c = torch.einsum("bshk,rhk->bshr", q[..., :nope], p.w_uk)
    t = full_shape(cache["c_kv"])[1]
    slot = pos % t if window else pos
    c_new = (x @ p.w_dkv)[:, 0]
    r_new = _mla_rope_key(x, p, posb, cfg)[:, 0, 0]
    scale = 1.0 / math.sqrt(nope + rope)
    sharded = tp(ctx) and p.wo.shape[0] != cfg.n_heads
    if cache["c_kv"].shape[1] != t:
        o_c = _mla_stripe_decode(q_c, q_rope, c_new, r_new, cache, slot,
                                 min(pos + 1, t), scale, sharded, ctx)
    else:
        cache["c_kv"][:, slot] = c_new
        cache["k_rope"][:, slot] = r_new
        c_kv, k_rope = cache["c_kv"].to(f32), cache["k_rope"].to(f32)
        s = (torch.einsum("bshr,btr->bhst", q_c.to(f32), c_kv) +
             torch.einsum("bshk,btk->bhst", q_rope.to(f32), k_rope)) * scale
        valid = torch.arange(t, device=x.device) < min(pos + 1, t)
        pr = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
        # attend in the compressed space, then up-project through w_uv
        o_c = torch.einsum("bhst,btr->bshr", pr.to(x.dtype).to(f32),
                           c_kv).to(x.dtype)
    out = p.out(torch.einsum("bshr,rhk->bshk", o_c, p.w_uv))
    return (reduce_from(out, ctx.mesh, ctx.model_axis) if sharded
            else out), cache


def _mla_stripe_decode(q_c, q_rope, c_new, r_new, cache, slot: int,
                       valid: int, scale: float, sharded: bool,
                       ctx: ShardCtx):
    """MLA's compressed attention over a cache sharded over its sequence:
    the rank whose stripe holds ``slot`` writes the step's entries; every
    rank scores every head over its stripe (:func:`stripe_attend`
    combines), then keeps its own heads when they are sharded.  Returns
    o_c (B, 1, H_local, r) in q_c's dtype."""
    mesh, axis = ctx.mesh, ctx.model_axis
    f32 = torch.float32
    cc, kr = cache["c_kv"], cache["k_rope"]
    tl = cc.shape[1]
    if slot // tl == ctx.model_rank:
        cc[:, slot % tl] = c_new
        kr[:, slot % tl] = r_new
    if sharded:
        q_c = gather_from(q_c, mesh, axis, 2)
        q_rope = gather_from(q_rope, mesh, axis, 2)
    s = (torch.einsum("bshr,btr->bhst", q_c.to(f32), cc.to(f32)) +
         torch.einsum("bshk,btk->bhst", q_rope.to(f32), kr.to(f32))) * scale
    ok = ctx.model_rank * tl + torch.arange(tl, device=cc.device) < valid
    o_c = stripe_attend(s, ok, lambda pr: torch.einsum(
        "bhst,btr->bhsr", pr.to(q_c.dtype).to(f32), cc.to(f32)), ctx)
    o_c = o_c.permute(0, 2, 1, 3).to(q_c.dtype)
    return split_to(o_c, mesh, axis, 2) if sharded else o_c


# ---------------------------------------------------------------------------
# the layer's attention, GQA or MLA as configured
# ---------------------------------------------------------------------------
def make_attention(cfg: ModelConfig, dtype=None, device=None) -> nn.Module:
    """An :class:`MLAttention` when ``cfg.attn_type == "mla"``, else a
    :class:`GQAttention`."""
    if cfg.attn_type == "mla":
        return MLAttention(cfg, dtype, device)
    return GQAttention(cfg, dtype, device)


def attention_forward(x, p: nn.Module, cfg: ModelConfig, *, positions=None,
                      window: int = 0, kernel: str = "flash",
                      ctx: Optional[ShardCtx] = None):
    """:func:`mla_forward` or :func:`gqa_forward`, by ``p``'s type, at
    ``positions`` (None: 0..S-1)."""
    fwd = mla_forward if isinstance(p, MLAttention) else gqa_forward
    return fwd(x, p, cfg, positions=positions, window=window, kernel=kernel,
               ctx=ctx)


def attention_decode(x, p: nn.Module, cache, pos: int, cfg: ModelConfig, *,
                     window: int = 0, ctx: Optional[ShardCtx] = None):
    """:func:`mla_decode` or :func:`gqa_decode`, by ``p``'s type."""
    dec = mla_decode if isinstance(p, MLAttention) else gqa_decode
    return dec(x, p, cache, pos, cfg, window=window, ctx=ctx)


def attention_init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                         device) -> Dict[str, torch.Tensor]:
    """:func:`mla_init_cache` or :func:`gqa_init_cache`, as configured."""
    init = mla_init_cache if cfg.attn_type == "mla" else gqa_init_cache
    return init(cfg, batch, cache_len, dtype, device)


# ---------------------------------------------------------------------------
# cross-attention (MusicGen's conditioning)
# ---------------------------------------------------------------------------
class CrossAttention(nn.Module):
    """``cross_attention_init``'s parameters in the reference's layouts:
    wq, wk, wv (d, H, hd), wo (H, hd, d)."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = nn.Parameter(torch.empty(d, h, hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, h, hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, h, hd, **kw))
        self.wo = nn.Parameter(torch.empty(h, hd, d, **kw))

    reset_parameters = GQAttention.reset_parameters
    project = GQAttention.project
    out = GQAttention.out


def cross_attention(x, cond, p: CrossAttention, cfg: ModelConfig,
                    ctx: Optional[ShardCtx] = None):
    """x: (B, S, d) queries; cond: (B, C, d) keys and values, in x's
    dtype.  No RoPE, no mask; scores in float32 times 1/sqrt(hd), the
    softmax in float32, p rounded to x's dtype before the product with v.
    Returns (B, S, d) in x's dtype.  On a mesh with the heads sharded:
    this rank's heads and an all-reduce."""
    f32 = torch.float32
    sharded = tp(ctx) and p.wq.shape[1] != cfg.n_heads
    if sharded:
        x = copy_to(x, ctx.mesh, ctx.model_axis)
        cond = copy_to(cond, ctx.mesh, ctx.model_axis)
    q = p.project(x, p.wq)
    k = p.project(cond, p.wk)
    v = p.project(cond, p.wv)
    s = torch.einsum("bshk,bchk->bhsc", q.to(f32), k.to(f32)) * \
        (1.0 / math.sqrt(cfg.head_dim))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhsc,bchk->bshk", pr.to(x.dtype).to(f32),
                     v.to(f32)).to(x.dtype)
    out = p.out(o)
    return reduce_from(out, ctx.mesh, ctx.model_axis) if sharded else out
