"""Configurations: the LM ``ModelConfig``, the paper U-Net's ``UNetConfig``
and the named input shapes.

Copies of ``repro/configs/base.py`` (``ModelConfig`` with its fields,
``validate``, ``reduced``, ``param_count`` and ``flops_per_token_fwd``;
``UNetConfig``; ``INPUT_SHAPES``): the port keeps its own so that it
imports nothing of ``repro``.  ``validate`` raises ``ValueError`` where the
reference asserts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio", "unet")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Configuration for a decoder transformer / SSM / hybrid backbone."""

    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    source: str = ""                 # citation for the config

    # --- attention ---
    attn_type: str = "gqa"           # gqa | mla
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) split of head_dim/2
    sliding_window: int = 0          # 0 = full attention everywhere
    long_context_mode: str = ""      # "" | "sliding_window" | "native"

    # --- MLA (deepseek-v2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense: int = 0             # leading dense layers before MoE stack
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2): shared attention block every `attn_every` ssm layers ---
    attn_every: int = 0

    # --- xlstm ---
    slstm_every: int = 0             # every k-th block is sLSTM (rest mLSTM)

    # --- vlm ---
    n_vision_tokens: int = 0         # patch embeddings spliced as a prefix
    # --- audio ---
    n_cond_tokens: int = 0           # conditioning embeddings (cross-attention)
    cross_attention: bool = False

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # -------- derived --------
    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def validate(self) -> "ModelConfig":
        """Raise ``ValueError`` on an inconsistent configuration."""
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.attn_type != "mla" and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")
        if self.is_moe and not (self.top_k > 0 and self.d_ff_expert > 0):
            raise ValueError("an MoE config needs top_k and d_ff_expert")
        if self.family == "hybrid" and not (
                self.ssm_state > 0 and
                self.ssm_heads * self.ssm_head_dim == self.d_inner_ssm):
            raise ValueError("a hybrid config needs ssm_state > 0 and "
                             "ssm_heads * ssm_head_dim == d_inner_ssm")
        return self

    # -------- reduced variant for CPU smoke tests --------
    def reduced(self) -> "ModelConfig":
        """A tiny member of the same family: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        head_dim = min(self.head_dim, 64)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        reps = {
            "n_layers": 2,
            "d_model": d_model,
            "n_heads": n_heads,
            "n_kv_heads": n_kv,
            "head_dim": head_dim,
            "d_ff": min(self.d_ff, 512) if self.d_ff else 0,
            "vocab_size": min(self.vocab_size, 512),
            "qk_nope_dim": min(self.qk_nope_dim, 64),
            "qk_rope_dim": min(self.qk_rope_dim, 32),
            "v_head_dim": min(self.v_head_dim, 64),
            "kv_lora_rank": min(self.kv_lora_rank, 64),
            "q_lora_rank": min(self.q_lora_rank, 64),
            "n_experts": min(self.n_experts, 4),
            "top_k": min(self.top_k, 2),
            "d_ff_expert": min(self.d_ff_expert, 128) if self.d_ff_expert else 0,
            "first_dense": min(self.first_dense, 1),
            # dropless at smoke scale: capacity == N·k even if all tokens
            # route to one expert (keeps decode == forward exactly)
            "capacity_factor": float(max(self.n_experts, 1)),
            # keep nh * head_dim == expand * d_model
            "ssm_head_dim": min(self.ssm_head_dim, 32),
            "ssm_heads": (self.ssm_expand * d_model) //
                         min(self.ssm_head_dim, 32) if self.ssm_heads else 0,
            "ssm_state": min(self.ssm_state, 16) if self.ssm_state else 0,
            "ssm_chunk": 16,
            "attn_every": min(self.attn_every, 1) if self.attn_every else 0,
            "slstm_every": min(self.slstm_every, 2) if self.slstm_every else 0,
            "n_vision_tokens": min(self.n_vision_tokens, 8),
            "n_cond_tokens": min(self.n_cond_tokens, 8),
            "mrope_sections": tuple(
                s * (head_dim // 2) // max(sum(self.mrope_sections), 1)
                for s in self.mrope_sections
            ) if self.mrope_sections else (),
            "dtype": "float32",
        }
        cfg = dataclasses.replace(self, **reps)
        if cfg.mrope_sections and sum(cfg.mrope_sections) != cfg.head_dim // 2:
            # repair rounding: dump remainder into the first section
            secs = list(cfg.mrope_sections)
            secs[0] += cfg.head_dim // 2 - sum(secs)
            cfg = dataclasses.replace(cfg, mrope_sections=tuple(secs))
        return cfg

    # -------- analytic parameter count --------
    def param_count(self) -> int:
        """Exact parameter count of this config (embedding included once if tied)."""
        d = self.d_model
        p = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            p += self.vocab_size * d                  # lm head
        p += d                                        # final norm
        for i in range(self.n_layers):
            p += self._layer_params(i)
        if self.family == "hybrid" and self.attn_every:
            p += self._attn_params() + 2 * d          # one shared attn block + norms
        return p

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.attn_type == "mla":
            qk_head = self.qk_nope_dim + self.qk_rope_dim
            p = 0
            if self.q_lora_rank:
                p += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk_head
            else:
                p += d * self.n_heads * qk_head
            p += d * (self.kv_lora_rank + self.qk_rope_dim)          # down-proj + k_rope
            p += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
            p += self.n_heads * self.v_head_dim * d                  # out proj
            return p
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def _ffn_params(self) -> int:
        return 3 * self.d_model * self.d_ff  # swiglu

    def _moe_params(self) -> int:
        d = self.d_model
        p = d * self.n_experts                                        # router
        p += self.n_experts * 3 * d * self.d_ff_expert                # routed
        p += self.n_shared_experts * 3 * d * self.d_ff_expert         # shared
        return p

    def _ssm_params(self) -> int:
        # matches models/ssm.py exactly: n_groups=1, B/C are (d, state)
        d, di = self.d_model, self.d_inner_ssm
        nh, st = self.ssm_heads, self.ssm_state
        p = d * (2 * di + 2 * st + nh)           # w_z, w_x, w_B, w_C, w_dt
        p += self.conv_width * (di + 2 * st)     # depthwise conv + bias
        p += (di + 2 * st) + nh                  # conv_b, dt_bias
        p += nh + nh                             # A_log, D
        p += di                                  # gated norm
        p += di * d                              # out proj
        return p

    def _mlstm_params(self) -> int:
        d = self.d_model
        di = 2 * d
        # up proj (x, gate), q/k/v at d_inner, i/f gates per head
        p = d * 2 * di + 3 * di * di + 2 * di * self.n_heads
        p += di + di * d               # norm + down proj
        return p

    def _slstm_params(self) -> int:
        d = self.d_model
        p = 4 * 2 * d * d              # i f z o gates, recurrent + input
        p += 4 * d                     # biases
        p += d + 2 * d * d             # norm + ffn-ish projection up/down (factor 2)
        return p

    def _layer_params(self, i: int) -> int:
        d = self.d_model
        if self.family in ("dense", "vlm", "audio"):
            p = self._attn_params() + self._ffn_params() + 2 * d
            if self.cross_attention:
                p += self._attn_params() + d
            return p
        if self.family == "moe":
            p = self._attn_params() + 2 * d
            if i < self.first_dense:
                p += 3 * d * (self.d_ff or self.d_ff_expert * 8)
            else:
                p += self._moe_params()
            return p
        if self.family == "ssm":   # xlstm
            if self.slstm_every and (i % self.slstm_every == self.slstm_every - 1):
                return self._slstm_params() + d
            return self._mlstm_params() + d
        if self.family == "hybrid":
            return self._ssm_params() + d
        raise ValueError(self.family)

    # -------- analytic step FLOPs (per token, forward) --------
    def flops_per_token_fwd(self, seq_len: int, kv_len: Optional[int] = None,
                            window: Optional[int] = None) -> float:
        """Matmul FLOPs per token of one forward pass.

        seq_len: query length of this step; kv_len: attended length (defaults
        to seq_len).  Attention cost uses the *average* causal kv length.
        """
        d, hd = self.d_model, self.head_dim
        kv_len = kv_len if kv_len is not None else seq_len
        if window:
            kv_len = min(kv_len, window)
        f = 0.0
        # embeddings: lookup free; lm head:
        f += 2 * d * self.vocab_size
        for i in range(self.n_layers):
            f += self._layer_flops_per_token(i, seq_len, kv_len, window)
        if self.family == "hybrid" and self.attn_every:
            n_attn = math.ceil(self.n_layers / self.attn_every)
            f += n_attn * self._attn_flops_per_token(seq_len, kv_len, window)
        return f

    def _attn_flops_per_token(self, s, kv, window) -> float:
        d, hd = self.d_model, self.head_dim
        if self.attn_type == "mla":
            qk_head = self.qk_nope_dim + self.qk_rope_dim
            f = 2 * self.d_model * (self.q_lora_rank or self.n_heads * qk_head)
            if self.q_lora_rank:
                f += 2 * self.q_lora_rank * self.n_heads * qk_head
            f += 2 * d * (self.kv_lora_rank + self.qk_rope_dim)
            f += 2 * self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
            f += 2 * self.n_heads * self.v_head_dim * d
            eff_kv = kv if (s == 1 or window) else kv / 2
            f += 2 * self.n_heads * eff_kv * (qk_head + self.v_head_dim)
            return f
        f = 2 * d * self.n_heads * hd + 2 * 2 * d * self.n_kv_heads * hd
        f += 2 * self.n_heads * hd * d
        eff_kv = kv if (s == 1 or window) else kv / 2   # causal average
        f += 2 * 2 * self.n_heads * hd * eff_kv          # qk^T and att@v
        return f

    def _ffn_flops_per_token(self) -> float:
        return 2 * 3 * self.d_model * self.d_ff

    def _moe_flops_per_token(self) -> float:
        d = self.d_model
        f = 2 * d * self.n_experts                                   # router
        f += self.top_k * 2 * 3 * d * self.d_ff_expert               # routed (active)
        f += self.n_shared_experts * 2 * 3 * d * self.d_ff_expert    # shared
        return f

    def _ssm_flops_per_token(self) -> float:
        d, di = self.d_model, self.d_inner_ssm
        nh, st, p = self.ssm_heads, self.ssm_state, self.ssm_head_dim
        f = 2 * d * (2 * di + 2 * st + nh)             # in proj
        f += 2 * self.conv_width * (di + 2 * st)       # depthwise conv
        f += 2 * nh * p * st * 2                       # state update + readout per token
        f += 2 * di * d                                # out proj
        return f

    def _mlstm_flops_per_token(self) -> float:
        d = self.d_model
        di = 2 * d
        hd = di // max(self.n_heads, 1)
        f = 2 * d * 2 * di + 2 * 3 * di * di + 2 * 2 * di * self.n_heads
        f += 2 * 2 * di * hd                            # matrix memory update/read per head dims
        f += 2 * di * d
        return f

    def _slstm_flops_per_token(self) -> float:
        d = self.d_model
        return 2 * 4 * 2 * d * d + 2 * 2 * d * d

    def _layer_flops_per_token(self, i, s, kv, window) -> float:
        if self.family in ("dense", "vlm", "audio"):
            f = self._attn_flops_per_token(s, kv, window) + self._ffn_flops_per_token()
            if self.cross_attention:
                f += self._attn_flops_per_token(s, self.n_cond_tokens, None)
            return f
        if self.family == "moe":
            f = self._attn_flops_per_token(s, kv, window)
            if i < self.first_dense:
                f += 2 * 3 * self.d_model * (self.d_ff or self.d_ff_expert * 8)
            else:
                f += self._moe_flops_per_token()
            return f
        if self.family == "ssm":
            if self.slstm_every and (i % self.slstm_every == self.slstm_every - 1):
                return self._slstm_flops_per_token()
            return self._mlstm_flops_per_token()
        if self.family == "hybrid":
            return self._ssm_flops_per_token()
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if not self.is_moe:
            return self.param_count()
        p = self.param_count()
        routed_all = self.n_layers_moe() * self.n_experts * 3 * self.d_model * self.d_ff_expert
        routed_active = self.n_layers_moe() * self.top_k * 3 * self.d_model * self.d_ff_expert
        return p - routed_all + routed_active

    def n_layers_moe(self) -> int:
        return max(0, self.n_layers - self.first_dense) if self.is_moe else 0



@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """The paper's own DDPM backbone (U-Net w/ ResNet blocks + self-attention)."""

    arch_id: str = "paper-unet"
    family: str = "unet"
    image_size: int = 128
    in_channels: int = 1
    base_channels: int = 64
    channel_mults: Tuple[int, ...] = (1, 2, 4, 8)
    n_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    time_dim: int = 256
    norm_groups: int = 8
    dropout: float = 0.0
    dtype: str = "float32"
    # classifier-free guidance: 0 = unconditional (classic); N > 0 adds an
    # (N+1)-row class embedding to the time embedding, row N being the
    # null label
    num_classes: int = 0
    source = "CollaFuse §4 (Ronneberger'15 U-Net + He'16 ResNet + Vaswani'17 attn)"

    def reduced(self) -> "UNetConfig":
        return dataclasses.replace(
            self, image_size=16, base_channels=16, channel_mults=(1, 2),
            n_res_blocks=1, attn_resolutions=(8,), time_dim=64, norm_groups=4)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
