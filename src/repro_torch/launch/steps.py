"""Train, prefill and decode step functions (counterpart of
``make_train_step``, ``make_prefill_step`` and ``make_decode_step`` in
``repro/launch/steps.py``, without the sharding plumbing: one card,
PyTorch runs eagerly)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                    window: int = 0, remat: bool = False):
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
    backward.  As in the reference, the step takes no schedule."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, aux = tf.lm_loss(model, batch, cfg, window=window,
                               remat=remat)
        loss.backward()
        m = adamw.apply_updates_(params, {k: p.grad
                                          for k, p in params.items()},
                                 opt_state, opt_cfg)
        for p in params.values():
            p.grad = None
        return model, opt_state, {"loss": loss.detach(),
                                  "ce": aux["ce"].detach(),
                                  "moe_aux": aux["moe_aux"].detach(), **m}
    return train_step


def make_prefill_step(cfg: ModelConfig, *, window: int = 0,
                      kernel: str = "flash"):
    """``prefill_step(params, batch) -> logits (B, S, V)`` under
    ``torch.inference_mode``; ``kernel`` picks the attention core
    (``"flash"``: the CUDA kernel, ``"torch"``: blockwise PyTorch)."""
    def prefill_step(params, batch):
        with torch.inference_mode():
            return tf.prefill(params, batch, cfg, window=window,
                              kernel=kernel)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, window: int = 0):
    """``decode_step(params, cache, batch, pos) -> (logits, cache)`` under
    ``torch.inference_mode``; the cache is written in place."""
    def decode_step(params, cache, batch, pos):
        with torch.inference_mode():
            return tf.decode_step(params, cache, batch, pos, cfg,
                                  window=window)
    return decode_step
