"""Shared LM layers: RMSNorm, RoPE and Qwen2-VL's multimodal RoPE, the
SwiGLU MLP, embedding, unembedding, the fan-in truncated-normal init and
the softmax cross-entropy (counterpart of ``repro/models/layers.py:105-248``).

Weights keep the reference's layouts (``(d, ff)`` for a dense map,
``(vocab, d)`` for the embedding), so a reference tree maps onto the port
leaf for leaf.  The dtype points are the reference's: RMSNorm computes in
float32; the MLP's gate and up products come out in the activation dtype
and silu·up is taken in float32; logits come out in the activation dtype.
A matrix product of bfloat16 tensors accumulates in float32 and rounds its
output once, as the reference's ``preferred_element_type`` does;
:func:`matmul_f32` keeps the float32 result where the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def trunc_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Fill ``w`` in place with ``fan_in**-0.5 ·`` a standard normal
    truncated to [-3, 3] (the counterpart of the reference's ``dense_init``),
    drawn from ``generator`` on ``w``'s device by inverting the normal CDF
    of a uniform draw.  The two frameworks draw different numbers; the tests
    hand both the same weights."""
    lo = math.erf(-3 / math.sqrt(2))
    u = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    u.uniform_(lo, -lo, generator=generator)
    x = u.erfinv_().mul_(math.sqrt(2)).clamp_(-3.0, 3.0)
    with torch.no_grad():
        w.copy_(x.mul_(fan_in ** -0.5))
    return w


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """x / rms(x) · scale in float32, returned in x's dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of x's last axis by float32 ``angles``
    (B, S, hd/2), broadcast over the heads; returns x's dtype."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integers.  Rotates the two
    halves of hd in float32 and returns x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs       # (B,S,half)
    return _rotate(x, angles)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: (B, S, H, hd); positions: (3, B, S)
    (temporal, height, width) ids; ``sections`` splits the hd/2 frequency
    bands among the three streams in order (sum(sections) == hd // 2).
    Angles in float32, the result in x's dtype; with three equal streams
    it is :func:`apply_rope` bitwise (the same products)."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"hd/2 = {half}")
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    # band j takes the position of the stream whose section holds j (the
    # reference's repeat_interleave of the stream ids); selected by slices,
    # since a tensor of repeats would synchronise the device
    pos = positions.to(torch.float32)
    pos_sel = torch.cat([pos[i, :, :, None].expand(*pos.shape[1:], n)
                         for i, n in enumerate(sections)], dim=-1)
    return _rotate(x, pos_sel * freqs)                          # (B,S,half)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result: bf16 operands accumulate in float32
    and the result is not rounded (the reference's
    ``preferred_element_type=float32``)."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        mm = torch.bmm if a.ndim == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def dense_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., k) · (k, n) -> (..., n) with a float32 result, as
    :func:`matmul_f32`."""
    out = matmul_f32(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


class MLP(nn.Module):
    """SwiGLU: ``silu(x·w_gate) · (x·w_up) · w_down``."""

    def __init__(self, d_model: int, d_ff: int, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.w_gate = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.w_up = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.w_down = nn.Parameter(torch.empty(d_ff, d_model, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.w_gate, self.w_gate.shape[0], generator)
        trunc_normal_(self.w_up, self.w_up.shape[0], generator)
        trunc_normal_(self.w_down, self.w_down.shape[0], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.w_gate
        u = x @ self.w_up
        h = (F.silu(h.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
        return h @ self.w_down


class Embed(nn.Module):
    """Token embedding and LM head; the head is the embedding's transpose
    when the config ties them."""

    def __init__(self, vocab: int, d_model: int, tie: bool, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.embedding = nn.Parameter(torch.empty(vocab, d_model, **kw))
        self.lm_head = None if tie else nn.Parameter(
            torch.empty(d_model, vocab, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.embedding.shape[1]
        trunc_normal_(self.embedding, d, generator)
        if self.lm_head is not None:
            trunc_normal_(self.lm_head, d, generator)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, d) -> logits (B, S, vocab) in x's dtype."""
        w = self.embedding.T if self.lm_head is None else self.lm_head
        return x @ w


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V), labels (B, S) int64 -> the mean over all tokens of
    ``logsumexp(logits) - logits[label]``, a float32 scalar, computed in
    float32 whatever the logits' dtype (the reference's
    ``softmax_cross_entropy``, written out as it is)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    return torch.mean(logz - gold)
