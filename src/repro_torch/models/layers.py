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

On a mesh (a :class:`ShardCtx` with a mesh) a module holds its rank's
slice of each weight (``parallel/sharding.py``'s ``param_specs``) and
infers from the slice's shape what is sharded: the embedding's rows and
the head's columns over ``model`` (vocab-parallel: a masked lookup and an
all-reduce; logits sharded over the vocabulary, gathered for prefill, and
a vocab-parallel logsumexp for the loss), the MLP's ``w_gate``/``w_up``
columns and ``w_down`` rows (its partial sums all-reduced in the
activation dtype, as ``repro/models/layers.py:199-214`` does).  The
collectives are ``torch.autograd.Function``s, so training has their
backward: :func:`copy_to` (identity, its backward an all-reduce),
:func:`reduce_from` (an all-reduce, its backward the identity),
:func:`gather_from` and :func:`split_to` (each the other's backward),
:func:`exchange` (an all-to-all, its own reverse), :func:`fsdp_gather`
(an all-gather, its backward a reduce-scatter) and :func:`reduce_both` (an
all-reduce both ways: a statistic of sharded values that feeds sharded
work, such as a norm over a sharded width).  Without a mesh every
function runs today's code, and an axis of size 1 runs no collective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel import comm
from repro_torch.parallel.comm import Axes, Mesh


# ---------------------------------------------------------------------------
# sharding context
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The mesh and its logical axes, carried into model code (the
    reference's ``ShardCtx``).  ``mesh`` None is one device: no function
    runs a collective.  ``seq_shard_attn`` shards the queries' sequence
    over ``model`` where the heads do not divide it (``qshard_attention``);
    ``cache_seq_shard`` shards the decode cache over its sequence
    (flash-decoding, with an explicit combine).  ``rows_sharded`` is set
    by the entry points of ``models/transformer.py`` for one call: the
    activations hold this rank's block of the batch over the data axes
    (the batch divides them), not the whole batch."""

    mesh: Optional[Mesh] = None
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    seq_shard_attn: bool = False
    cache_seq_shard: bool = False
    rows_sharded: bool = False

    @property
    def model_size(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape[self.model_axis]

    @property
    def data_size(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.size(self.batch_axes)

    @property
    def model_rank(self) -> int:
        """This rank's index on ``model`` (0 without a mesh)."""
        if self.mesh is None:
            return 0
        return self.mesh.coords[self.model_axis]

    def resolve(self, dim):
        """A logical dim tag ("batch", "model", an axis name or None) as
        mesh axes."""
        if dim is None:
            return None
        if dim == "batch":
            return self.batch_axes if len(self.batch_axes) > 1 \
                else self.batch_axes[0]
        if dim == "model":
            return self.model_axis
        return dim


def tp(ctx: Optional[ShardCtx]) -> bool:
    """Whether ``ctx`` has a model axis above 1."""
    return ctx is not None and ctx.model_size > 1


# ---------------------------------------------------------------------------
# collectives with their backward
# ---------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(c, x, mesh, axes):
        c.mesh, c.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(c, g):
        return comm.all_reduce(g, c.mesh, c.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(c, x, mesh, axes):
        return comm.all_reduce(x, mesh, axes)

    @staticmethod
    def backward(c, g):
        return g, None, None


def _chunk(x, mesh: Mesh, axes: Axes, dim: int):
    n, i = mesh.size(axes), mesh.index(axes)
    w = x.shape[dim] // n
    return x.narrow(dim, i * w, w)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(c, x, mesh, axes, dim):
        c.mesh, c.axes, c.dim = mesh, axes, dim
        return comm.all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(c, g):
        return _chunk(g, c.mesh, c.axes, c.dim).contiguous(), None, None, \
            None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(c, x, mesh, axes, dim):
        c.mesh, c.axes, c.dim = mesh, axes, dim
        return _chunk(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(c, g):
        return comm.all_gather(g, c.mesh, c.axes, c.dim), None, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(c, x, mesh, axes):
        c.mesh, c.axes = mesh, axes
        return comm.all_to_all(x, mesh, axes)

    @staticmethod
    def backward(c, g):
        return comm.all_to_all(g, c.mesh, c.axes), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(c, x, mesh, axes, dim):
        c.mesh, c.axes, c.dim = mesh, axes, dim
        return comm.all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(c, g):
        return comm.reduce_scatter(g, c.mesh, c.axes, c.dim), None, None, \
            None


def _live(mesh: Optional[Mesh], axes: Axes) -> bool:
    return mesh is not None and mesh.size(axes) > 1


def copy_to(x, mesh: Optional[Mesh], axes: Axes):
    """x; its gradient is summed over ``axes`` (a replicated input to
    sharded work)."""
    return _CopyTo.apply(x, mesh, axes) if _live(mesh, axes) else x


def reduce_from(x, mesh: Optional[Mesh], axes: Axes):
    """The sum of x over ``axes`` in x's dtype; the gradient passes."""
    return _ReduceFrom.apply(x, mesh, axes) if _live(mesh, axes) else x


def gather_from(x, mesh: Optional[Mesh], axes: Axes, dim: int):
    """The ranks' x over ``axes`` concatenated along ``dim``; the gradient
    is cut back to this rank's block."""
    return _GatherFrom.apply(x, mesh, axes, dim) if _live(mesh, axes) else x


def split_to(x, mesh: Optional[Mesh], axes: Axes, dim: int):
    """This rank's block of x along ``dim``; the gradient is gathered."""
    return _SplitTo.apply(x, mesh, axes, dim) if _live(mesh, axes) else x


def exchange(x, mesh: Optional[Mesh], axes: Axes):
    """All-to-all over ``axes`` on dim 0; the gradient goes back."""
    return _Exchange.apply(x, mesh, axes) if _live(mesh, axes) else x


def fsdp_gather(x, mesh: Optional[Mesh], axes: Axes, dim: int):
    """A weight's FSDP shards gathered along ``dim``; the gradient is
    reduce-scattered back to the shard."""
    return _FsdpGather.apply(x, mesh, axes, dim) if _live(mesh, axes) else x


def reduce_both(x, mesh: Optional[Mesh], axes: Axes):
    """The sum of x over ``axes``; its gradient is summed too (each rank's
    use of the sum is a part of the whole)."""
    return copy_to(reduce_from(x, mesh, axes), mesh, axes)


def full_shape(w: torch.Tensor) -> torch.Size:
    """The shape of the whole weight ``w`` is a rank's slice of (its own
    shape when it is whole)."""
    return getattr(w, "full_shape", w.shape)


def trunc_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Fill ``w`` in place with ``fan_in**-0.5 ·`` a standard normal
    truncated to [-3, 3] (the counterpart of the reference's ``dense_init``),
    drawn from ``generator`` on ``w``'s device by inverting the normal CDF
    of a uniform draw.  The two frameworks draw different numbers; the tests
    hand both the same weights.  A rank's slice of a sharded weight (a
    tensor with ``full_shape`` and ``shard_slices``) draws the whole weight
    and keeps its slice, so a sharded model has the one-card model's
    weights."""
    lo = math.erf(-3 / math.sqrt(2))
    u = torch.empty(full_shape(w), dtype=torch.float32, device=w.device)
    u.uniform_(lo, -lo, generator=generator)
    x = u.erfinv_().mul_(math.sqrt(2)).clamp_(-3.0, 3.0)
    x = x.mul_(fan_in ** -0.5)
    with torch.no_grad():
        w.copy_(x[w.shard_slices] if hasattr(w, "shard_slices") else x)
    return w


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """x / rms(x) · scale in float32, returned in x's dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def sharded_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
                    width: int, ctx: ShardCtx) -> torch.Tensor:
    """:func:`rmsnorm` of a tensor whose last dim is this rank's block of
    ``width`` (and ``scale`` its block): the sum of squares is summed over
    ``model`` both ways (:func:`reduce_both`)."""
    xf = x.to(torch.float32)
    ss = reduce_both(xf.square().sum(dim=-1, keepdim=True), ctx.mesh,
                     ctx.model_axis)
    return (xf * torch.rsqrt(ss / width + eps) *
            scale.to(torch.float32)).to(x.dtype)


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
        self.d_ff = d_ff
        self.w_gate = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.w_up = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.w_down = nn.Parameter(torch.empty(d_ff, d_model, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.w_gate, full_shape(self.w_gate)[0], generator)
        trunc_normal_(self.w_up, full_shape(self.w_up)[0], generator)
        trunc_normal_(self.w_down, full_shape(self.w_down)[0], generator)

    def forward(self, x: torch.Tensor,
                ctx: Optional[ShardCtx] = None) -> torch.Tensor:
        """On a mesh with d_ff sharded: column-parallel gate and up,
        row-parallel down, the partial sums all-reduced in x's dtype."""
        sharded = self.w_gate.shape[1] != self.d_ff
        if sharded:
            x = copy_to(x, ctx.mesh, ctx.model_axis)
        h = x @ self.w_gate
        u = x @ self.w_up
        h = (F.silu(h.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
        out = h @ self.w_down
        return reduce_from(out, ctx.mesh, ctx.model_axis) if sharded else out


class Embed(nn.Module):
    """Token embedding and LM head; the head is the embedding's transpose
    when the config ties them."""

    def __init__(self, vocab: int, d_model: int, tie: bool, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.vocab = vocab
        self.embedding = nn.Parameter(torch.empty(vocab, d_model, **kw))
        self.lm_head = None if tie else nn.Parameter(
            torch.empty(d_model, vocab, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        d = full_shape(self.embedding)[1]
        trunc_normal_(self.embedding, d, generator)
        if self.lm_head is not None:
            trunc_normal_(self.lm_head, d, generator)

    def embed(self, tokens: torch.Tensor,
              ctx: Optional[ShardCtx] = None) -> torch.Tensor:
        """Token rows; with the rows sharded over ``model`` a masked
        lookup of this rank's vocabulary block, all-reduced (a sum with
        one nonzero term, so exact in any dtype)."""
        rows = self.embedding.shape[0]
        if rows == self.vocab:
            return F.embedding(tokens, self.embedding)
        lo = ctx.model_rank * rows
        mine = (tokens >= lo) & (tokens < lo + rows)
        out = F.embedding(torch.where(mine, tokens - lo, 0), self.embedding)
        out = out.masked_fill(~mine[..., None], 0)
        return reduce_from(out, ctx.mesh, ctx.model_axis)

    def head_block(self) -> Tuple[torch.Tensor, bool]:
        """(the head (d, V or V/M), whether it is this rank's vocabulary
        block)."""
        w = self.embedding.T if self.lm_head is None else self.lm_head
        return w, w.shape[1] != self.vocab

    def unembed(self, x: torch.Tensor, ctx: Optional[ShardCtx] = None,
                gather: bool = True) -> torch.Tensor:
        """(B, S, d) -> logits (B, S, vocab) in x's dtype.  With the head
        sharded over the vocabulary: this rank's block (B, S, V/M), or,
        with ``gather``, the blocks gathered."""
        w, sharded = self.head_block()
        if not sharded:
            return x @ w
        logits = copy_to(x, ctx.mesh, ctx.model_axis) @ w
        if gather:
            return gather_from(logits, ctx.mesh, ctx.model_axis, -1)
        return logits


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


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 ctx: ShardCtx) -> torch.Tensor:
    """:func:`softmax_cross_entropy` of logits sharded over the vocabulary
    on ``model`` (this rank's block (B, S, V/M)), with no rank holding the
    whole (B, S, V): the max is all-reduced (no gradient flows through it),
    the sum of exponentials and the gold logit (taken on the rank whose
    block holds the label) are all-reduced sums."""
    mesh, axis = ctx.mesh, ctx.model_axis
    lf = logits.to(torch.float32)
    vb = lf.shape[-1]
    lo = ctx.model_rank * vb
    m = comm.all_reduce(lf.detach().amax(dim=-1), mesh, axis, op="max")
    sumexp = reduce_from(torch.exp(lf - m[..., None]).sum(dim=-1), mesh,
                         axis)
    logz = torch.log(sumexp) + m
    mine = (labels >= lo) & (labels < lo + vb)
    idx = torch.where(mine, labels - lo, 0)
    gold = torch.take_along_dim(lf, idx[..., None], dim=-1)[..., 0]
    gold = reduce_from(gold.masked_fill(~mine, 0.0), mesh, axis)
    return torch.mean(logz - gold)

