"""Train, prefill and decode step functions and the mesh context
(counterpart of ``make_ctx``, ``make_train_step``, ``make_prefill_step``
and ``make_decode_step`` in ``repro/launch/steps.py``).  PyTorch runs
eagerly, so there is no ``jit_step_for``: the steps take the ``ShardCtx``
and the model holds its rank's shards (``tf.init_params(ctx=...)``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import batch_axes_of
from repro_torch.models import transformer as tf
from repro_torch.models.layers import ShardCtx
from repro_torch.optim import adamw
from repro_torch.parallel import comm


def make_ctx(mesh, *, seq_shard_attn: bool = False,
             cache_seq_shard: bool = False) -> ShardCtx:
    """The ``ShardCtx`` of ``mesh`` (None: one device), its batch axes
    those of :func:`~repro_torch.launch.mesh.batch_axes_of`."""
    if mesh is None:
        return ShardCtx()
    return ShardCtx(mesh=mesh, batch_axes=batch_axes_of(mesh),
                    seq_shard_attn=seq_shard_attn,
                    cache_seq_shard=cache_seq_shard)


def _average_over_data(params, ctx: ShardCtx):
    """Each parameter's gradient averaged over the batch axes: an FSDP
    shard's was summed over ``data`` by its reduce-scatter, the rest are
    all-reduced over every batch axis."""
    mesh, axes, n = ctx.mesh, tuple(ctx.batch_axes), ctx.data_size
    grads = {}
    for k, p in params.items():
        g = p.grad
        rest = tuple(a for a in axes if a != "data") \
            if hasattr(p, "fsdp_dim") else axes
        if rest:
            g = comm.all_reduce(g, mesh, rest)
        grads[k] = g / n
    return grads


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                    window: int = 0, remat: bool = False,
                    ctx: Optional[ShardCtx] = None):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: :func:`~repro_torch.models.transformer.lm_loss`, its
    gradients by autograd over ``model.named_parameters()`` (a tied
    embedding is one parameter, so the head's and the embedding's
    gradients meet in it), then :func:`~repro_torch.optim.adamw.
    apply_updates_`, which writes the parameters and ``opt_state`` (from
    ``adamw.init_state(dict(model.named_parameters()), opt_cfg)``) in
    place, the counterpart of the reference's donated jit.  The gradients
    are freed after the update.  The metrics are float32 scalar tensors:
    ``loss``, ``ce``, ``moe_aux``, ``grad_norm`` and ``lr``.

    ``remat`` recomputes each block's activations in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
    ``lm_loss`` runs its default ``kernel="torch"``: the kernels have no
    backward.  As in the reference, the step takes no schedule.

    On a mesh (``ctx``; the model and the state a rank's shards, the
    batch the global one) each data rank takes its rows, the gradients
    are averaged over the batch axes, the clipping norm is the global one,
    and the metrics are averaged over the batch axes.  An MoE model on a
    data axis needs a batch the data axis divides."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    mesh = ctx.mesh if ctx is not None else None

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if mesh is not None and cfg.family == "moe" and ctx.data_size > 1 \
                and batch["tokens"].shape[0] % ctx.data_size:
            raise ValueError(
                f"{cfg.arch_id}: a batch of {batch['tokens'].shape[0]} "
                f"rows does not split over {ctx.data_size} data ranks; the "
                "experts' gradients need each rank's own rows")
        loss, aux = tf.lm_loss(model, batch, cfg, window=window,
                               remat=remat, ctx=ctx)
        loss.backward()
        if mesh is None:
            m = adamw.apply_updates_(params, {k: p.grad for k, p in
                                              params.items()},
                                     opt_state, opt_cfg)
        else:
            m = adamw.apply_updates_(params, _average_over_data(params, ctx),
                                     opt_state, opt_cfg, ctx=ctx,
                                     specs=model.param_specs)
        for p in params.values():
            p.grad = None
        out = {"loss": loss.detach(), "ce": aux["ce"].detach(),
               "moe_aux": aux["moe_aux"].detach()}
        if mesh is not None:
            out = {k: comm.all_reduce(v, mesh, ctx.batch_axes) /
                   ctx.data_size for k, v in out.items()}
        return model, opt_state, {**out, **m}
    return train_step


def make_prefill_step(cfg: ModelConfig, *, window: int = 0,
                      kernel: str = "flash",
                      ctx: Optional[ShardCtx] = None):
    """``prefill_step(params, batch) -> logits (B, S, V)`` under
    ``torch.inference_mode``; ``kernel`` picks the attention core
    (``"flash"``: the CUDA kernel, ``"torch"``: blockwise PyTorch).  On a
    mesh: this rank's rows of the global batch's logits."""
    def prefill_step(params, batch):
        with torch.inference_mode():
            return tf.prefill(params, batch, cfg, window=window,
                              kernel=kernel, ctx=ctx)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, window: int = 0,
                     ctx: Optional[ShardCtx] = None):
    """``decode_step(params, cache, batch, pos) -> (logits, cache)`` under
    ``torch.inference_mode``; the cache is written in place.  On a mesh
    the cache is the rank's (``tf.init_cache(ctx=...)``)."""
    def decode_step(params, cache, batch, pos):
        with torch.inference_mode():
            return tf.decode_step(params, cache, batch, pos, cfg,
                                  window=window, ctx=ctx)
    return decode_step
