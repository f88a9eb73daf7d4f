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
reference and stays plain PyTorch here.  The sequence-sharded variant
(``qshard_attention``) waits for the DTensor mesh (``ROADMAP.md`` Queue 1
item 4.5).  The decode steps write the new entries into the cache in place,
where the reference returns a new cache: that keeps one copy of a cache in
device memory.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_mrope, apply_rope, trunc_normal_

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
        d = self.wq.shape[0]
        for w in (self.wq, self.wk, self.wv):
            trunc_normal_(w, d, generator)
        trunc_normal_(self.wo, self.wo.shape[0] * self.wo.shape[1], generator)

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


# ---------------------------------------------------------------------------
# GQA module
# ---------------------------------------------------------------------------
def _positions_default(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def gqa_forward(x, p: GQAttention, cfg: ModelConfig, *, positions=None,
                window: int = 0, kernel: str = "flash"):
    """Full (prefill) causal GQA self-attention.  x: (B, S, d) -> (B, S, d)
    in x's dtype.  positions: (B, S), or (3, B, S) under M-RoPE, where
    plain (B, S) ids stand for three equal streams; None: 0..S-1."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
    b, s, _ = x.shape
    q = p.project(x, p.wq)
    k = p.project(x, p.wk)
    v = p.project(x, p.wv)
    if positions is None:
        positions = _positions_default(b, s, x.device)
    q, k = _rope(q, k, positions, cfg)
    if kernel == "flash":
        o = ops.flash_attention(q, k, v, causal=True, window=window)
    else:
        o = blockwise_attention(q, k, v, causal=True, window=window)
    return p.out(o)


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
               cfg: ModelConfig, *, window: int = 0):
    """One decode step.  x: (B, 1, d); pos: absolute position (int), on
    all three streams under M-RoPE, as in the reference.

    Full attention: cache length T == sequence length, written at index
    pos.  Sliding window: T == window (a ring buffer), index pos % window.
    Writes the cache in place and returns (out, cache)."""
    b = x.shape[0]
    pos = int(pos)
    q = p.project(x, p.wq)
    k = p.project(x, p.wk)
    v = p.project(x, p.wv)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k = _rope(q, k, posb, cfg)
    t = cache["k"].shape[1]
    slot = pos % t if window else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    o = decode_attention(q, cache["k"], cache["v"], valid_len=min(pos + 1, t))
    return p.out(o), cache


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
                trunc_normal_(w, w.shape[0], generator)
        trunc_normal_(self.wo, self.wo.shape[0] * self.wo.shape[1], generator)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """(B, S, H, vh) · (H, vh, d) -> (B, S, d) in o's dtype."""
        b, s = o.shape[:2]
        return o.reshape(b, s, -1) @ self.wo.reshape(-1, self.wo.shape[2])


def _up(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, r) · (r, H, k) -> (B, S, H, k) in c's dtype."""
    b, s, r = c.shape
    return (c @ w.reshape(r, -1)).view(b, s, w.shape[1], w.shape[2])


def _mla_q(x, p: MLAttention) -> torch.Tensor:
    """The queries (B, S, H, nope + rope) in x's dtype."""
    if p.w_dq is not None:
        return _up(x @ p.w_dq, p.w_uq)
    return _up(x, p.wq)


def _mla_rope_key(x, p: MLAttention, positions, cfg: ModelConfig):
    """The shared rope key (B, S, 1, rope), rotated."""
    return apply_rope((x @ p.w_krope)[:, :, None, :], positions,
                      cfg.rope_theta)


def mla_forward(x, p: MLAttention, cfg: ModelConfig, *, positions=None,
                window: int = 0, kernel: str = "flash"):
    """Prefill MLA attention: the compressed KV expanded to per-head keys
    and values, the shared rope key broadcast over the heads, v padded
    from vh to nope + rope, blockwise attention with scale
    1/sqrt(nope + rope).  ``kernel`` is accepted and ignored, as in the
    reference.  x: (B, S, d) -> (B, S, d) in x's dtype."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
    b, s, _ = x.shape
    nope, rope, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    h = cfg.n_heads
    if positions is None:
        positions = _positions_default(b, s, x.device)
    q = _mla_q(x, p)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    c_kv = x @ p.w_dkv
    k_rope = _mla_rope_key(x, p, positions, cfg)
    q_full = torch.cat([q[..., :nope], q_rope], dim=-1)
    k_full = torch.cat([_up(c_kv, p.w_uk), k_rope.expand(b, s, h, rope)],
                       dim=-1)
    v = F.pad(_up(c_kv, p.w_uv), (0, nope + rope - vh))
    o = blockwise_attention(q_full, k_full, v, causal=True, window=window,
                            softmax_scale=1.0 / math.sqrt(nope + rope))
    return p.out(o[..., :vh])


def mla_init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    """c_kv (B, T, r) and k_rope (B, T, rope), zeroed."""
    return {"c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


def mla_decode(x, p: MLAttention, cache: Dict[str, torch.Tensor], pos: int,
               cfg: ModelConfig, *, window: int = 0):
    """One absorbed-weight decode step.  x: (B, 1, d); pos: absolute
    position (int).  The query's nope part times w_uk scores against the
    compressed cache directly, plus the rope term; the attention runs in
    the compressed space and is up-projected through w_uv.  The cache slot
    is pos (pos % T under a window, a ring buffer).  Writes the cache in
    place and returns (out, cache)."""
    b = x.shape[0]
    pos = int(pos)
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    f32 = torch.float32
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = _mla_q(x, p)                                        # (B,1,H,nope+rope)
    q_rope = apply_rope(q[..., nope:], posb, cfg.rope_theta)
    # absorb w_uk into the query: q_c = q_nope · w_ukᵀ -> (B, 1, H, r)
    q_c = torch.einsum("bshk,rhk->bshr", q[..., :nope], p.w_uk)
    t = cache["c_kv"].shape[1]
    slot = pos % t if window else pos
    cache["c_kv"][:, slot] = (x @ p.w_dkv)[:, 0]
    cache["k_rope"][:, slot] = _mla_rope_key(x, p, posb, cfg)[:, 0, 0]
    c_kv, k_rope = cache["c_kv"].to(f32), cache["k_rope"].to(f32)
    s = (torch.einsum("bshr,btr->bhst", q_c.to(f32), c_kv) +
         torch.einsum("bshk,btk->bhst", q_rope.to(f32), k_rope)) \
        * (1.0 / math.sqrt(nope + rope))
    valid = torch.arange(t, device=x.device) < min(pos + 1, t)
    pr = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    # attend in the compressed space, then up-project through w_uv
    o_c = torch.einsum("bhst,btr->bshr", pr.to(x.dtype).to(f32),
                       c_kv).to(x.dtype)
    o = torch.einsum("bshr,rhk->bshk", o_c, p.w_uv)
    return p.out(o), cache


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
                      window: int = 0, kernel: str = "flash"):
    """:func:`mla_forward` or :func:`gqa_forward`, by ``p``'s type, at
    ``positions`` (None: 0..S-1)."""
    fwd = mla_forward if isinstance(p, MLAttention) else gqa_forward
    return fwd(x, p, cfg, positions=positions, window=window, kernel=kernel)


def attention_decode(x, p: nn.Module, cache, pos: int, cfg: ModelConfig, *,
                     window: int = 0):
    """:func:`mla_decode` or :func:`gqa_decode`, by ``p``'s type."""
    dec = mla_decode if isinstance(p, MLAttention) else gqa_decode
    return dec(x, p, cache, pos, cfg, window=window)


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


def cross_attention(x, cond, p: CrossAttention, cfg: ModelConfig):
    """x: (B, S, d) queries; cond: (B, C, d) keys and values, in x's
    dtype.  No RoPE, no mask; scores in float32 times 1/sqrt(hd), the
    softmax in float32, p rounded to x's dtype before the product with v.
    Returns (B, S, d) in x's dtype."""
    f32 = torch.float32
    q = p.project(x, p.wq)
    k = p.project(cond, p.wk)
    v = p.project(cond, p.wv)
    s = torch.einsum("bshk,bchk->bhsc", q.to(f32), k.to(f32)) * \
        (1.0 / math.sqrt(cfg.head_dim))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhsc,bchk->bshk", pr.to(x.dtype).to(f32),
                     v.to(f32)).to(x.dtype)
    return p.out(o)
