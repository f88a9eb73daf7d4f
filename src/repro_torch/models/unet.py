"""DDPM U-Net — the CollaFuse paper's backbone (§4); counterpart of
``repro/models/unet.py``.

ResNet blocks for down/up-sampling, single-head self-attention at the
configured resolutions, sinusoidal time embedding computed in float32, and
an optional class embedding (null row = ``num_classes``) added to it.  The
public layout is NHWC, as in the reference; inside, the network runs NCHW
for ``conv2d``.  Convolutions use the reference's "SAME" padding, which for
a stride-2 3x3 conv on an even size pads 0 before and 1 after — not the 1
and 1 of ``Conv2d(padding=1)``.

Submodule names mirror the reference's param tree (``downs.0.res.0.conv1``,
``mid.attn.qkv``, ...), so :func:`params_from_jax` maps a reference tree
onto :meth:`UNet.load_state_dict` one leaf at a time.

On a model axis (:func:`shard_unet`) each convolution whose output
channels divide the axis holds its rank's block of them, as the
reference's rule ``"w"`` shards its rank-4 HWIO kernels on their last dim
(:func:`param_specs` computes the specs on the reference's names and
shapes, :func:`reference_leaves`, and moves them onto the port's OIHW
layout); ``conv_out``'s single channel, the biases, the dense maps, the
norms and the label embedding stay whole.  Such a convolution computes its
block of channels (its weight block and its slice of the bias) and
all-gathers them, so the norms, the attention and the residuals run on
whole tensors on every rank.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import UNetConfig
from repro_torch.models.layers import (ShardCtx, copy_to, full_shape,
                                      gather_from)
from repro_torch.parallel import sharding as shd


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def conv_same(h: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], stride: int) -> torch.Tensor:
    """NCHW conv2d with XLA's "SAME" padding: total (out-1)·stride + k −
    size, split floor-before / ceil-after."""
    pads = []                            # F.pad order: last dim first
    for size, k in ((h.shape[-1], weight.shape[-1]),
                    (h.shape[-2], weight.shape[-2])):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    if pads[0] == pads[1] and pads[2] == pads[3]:
        return F.conv2d(h, weight, bias, stride, (pads[2], pads[0]))
    return F.conv2d(F.pad(h, pads), weight, bias, stride)


class Conv(nn.Conv2d):
    """Conv2d with XLA's "SAME" padding (:func:`conv_same`).  Its weight
    may be a model-axis rank's block of the output channels
    (:func:`shard_unet` sets ``ctx``): it computes that block and gathers
    the channels."""

    ctx: Optional[ShardCtx] = None

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=0)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        w = self.weight.shape[0]
        if w == self.out_channels:
            return conv_same(h, self.weight, self.bias, self.stride[0])
        mesh, axis = self.ctx.mesh, self.ctx.model_axis
        lo = self.ctx.model_rank * w
        out = conv_same(copy_to(h, mesh, axis), self.weight,
                        self.bias[lo:lo + w], self.stride[0])
        return gather_from(out, mesh, axis, 1)


def group_norm(groups: int, c: int) -> nn.GroupNorm:
    """Contiguous channel groups, biased variance, eps 1e-5 — the reference
    ``gn``."""
    return nn.GroupNorm(groups, c, eps=1e-5)


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of integer timesteps t: (B,) -> (B, dim), f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) *
                      torch.arange(half, dtype=torch.float32,
                                   device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, time_dim: int, groups: int):
        super().__init__()
        self.norm1 = group_norm(groups, cin)
        self.conv1 = Conv(cin, cout, 3)
        self.time_proj = nn.Linear(time_dim, cout)
        self.norm2 = group_norm(groups, cout)
        self.conv2 = Conv(cout, cout, 3)
        self.skip = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_proj(temb)[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (self.skip(x) if self.skip is not None else x)


class AttnBlock(nn.Module):
    """Single-head self-attention over the H·W positions, scaled by 1/√c.
    q, k and v are the qkv conv's output channels [0:c], [c:2c], [2c:3c]."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.norm = group_norm(groups, c)
        self.qkv = Conv(c, 3 * c, 1)
        self.out = Conv(c, c, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        qkv = self.qkv(self.norm(x)).reshape(b, 3, c, hh * ww)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        s = torch.einsum("bci,bcj->bij", q, k) / math.sqrt(c)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bij,bcj->bci", a, v).reshape(b, c, hh, ww)
        return x + self.out(o)


class Stage(nn.Module):
    """One resolution of the down or up path: ResBlocks, each followed by an
    attention block where the resolution has one, then a resample conv."""

    def __init__(self):
        super().__init__()
        self.res = nn.ModuleList()
        self.attn = nn.ModuleList()       # nn.Identity where no attention


class Mid(nn.Module):
    def __init__(self, c: int, time_dim: int, groups: int):
        super().__init__()
        self.res1 = ResBlock(c, c, time_dim, groups)
        self.attn = AttnBlock(c, groups)
        self.res2 = ResBlock(c, c, time_dim, groups)


# ---------------------------------------------------------------------------
# full U-Net
# ---------------------------------------------------------------------------
class UNet(nn.Module):
    """``forward(x_nhwc, t, y=None) -> eps_hat`` (NHWC).

    Weights are drawn from ``seed`` on the CPU, as the reference's
    ``init_params`` does (truncated-normal fan-in, zero biases, unit
    GroupNorm scales); move the module with ``.to(device)``.
    """

    def __init__(self, cfg: UNetConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        g = cfg.norm_groups
        ch, td = cfg.base_channels, cfg.time_dim
        self.time_mlp1 = nn.Linear(td, td)
        self.time_mlp2 = nn.Linear(td, td)
        self.conv_in = Conv(cfg.in_channels, ch, 3)
        self.label_emb = (nn.Embedding(cfg.num_classes + 1, td)
                          if cfg.num_classes else None)
        res, cur, chans = cfg.image_size, ch, [ch]
        self.downs = nn.ModuleList()
        for li, mult in enumerate(cfg.channel_mults):
            cout = ch * mult
            stage = Stage()
            for _ in range(cfg.n_res_blocks):
                stage.res.append(ResBlock(cur, cout, td, g))
                cur = cout
                stage.attn.append(AttnBlock(cur, g)
                                  if res in cfg.attn_resolutions
                                  else nn.Identity())
                chans.append(cur)
            if li < len(cfg.channel_mults) - 1:
                stage.down = Conv(cur, cur, 3, stride=2)
                chans.append(cur)
                res //= 2
            self.downs.append(stage)
        self.mid = Mid(cur, td, g)
        self.ups = nn.ModuleList()
        for li, mult in list(enumerate(cfg.channel_mults))[::-1]:
            cout = ch * mult
            stage = Stage()
            for _ in range(cfg.n_res_blocks + 1):
                stage.res.append(ResBlock(cur + chans.pop(), cout, td, g))
                cur = cout
                stage.attn.append(AttnBlock(cur, g)
                                  if res in cfg.attn_resolutions
                                  else nn.Identity())
            if li > 0:
                stage.up = Conv(cur, cur, 3)
                res *= 2
            self.ups.append(stage)
        self.norm_out = group_norm(g, cur)
        self.conv_out = Conv(cur, cfg.in_channels, 3)
        self.init_weights(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Truncated-normal (±3σ) fan-in weights, zero biases, unit norms."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, nn.Embedding)):
                w = m.weight              # fan-in = one output row's size
                std = w[0].numel() ** -0.5
                nn.init.trunc_normal_(w, std=std, a=-3 * std, b=3 * std,
                                      generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, H, W, C) noised image; t: (B,) int timesteps -> eps_hat
        (B, H, W, C).  ``y``: (B,) int labels when ``num_classes`` > 0,
        clipped to [0, num_classes]; None conditions on the null label."""
        cfg = self.cfg
        temb = time_embedding(t, cfg.time_dim)
        temb = self.time_mlp2(F.silu(self.time_mlp1(temb)))
        if self.label_emb is not None:
            if y is None:
                y = torch.full(x.shape[:1], cfg.num_classes,
                               dtype=torch.int64, device=x.device)
            yc = torch.clamp(y.to(torch.int64), 0, cfg.num_classes)
            temb = temb + self.label_emb(yc)

        h = self.conv_in(x.permute(0, 3, 1, 2))
        skips = [h]
        for stage in self.downs:
            for rb, ab in zip(stage.res, stage.attn):
                h = ab(rb(h, temb))
                skips.append(h)
            if hasattr(stage, "down"):
                h = stage.down(h)
                skips.append(h)
        h = self.mid.res1(h, temb)
        h = self.mid.attn(h)
        h = self.mid.res2(h, temb)
        for stage in self.ups:
            for rb, ab in zip(stage.res, stage.attn):
                h = ab(rb(torch.cat([h, skips.pop()], dim=1), temb))
            if hasattr(stage, "up"):
                h = stage.up(F.interpolate(h, scale_factor=2.0,
                                           mode="nearest"))
        h = F.silu(self.norm_out(h))
        return self.conv_out(h).permute(0, 2, 3, 1).contiguous()


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """Convert the reference's U-Net param tree (leaves as numpy arrays) into
    a :class:`UNet` state dict: conv weights HWIO → OIHW, dense ``(in,
    out)`` → ``Linear.weight (out, in)``, GroupNorm ``g_scale``/``g_bias`` →
    ``weight``/``bias``, ``label_emb`` → ``label_emb.weight``; the
    ``downs``/``ups`` lists map by index and their ``None`` attention
    entries are skipped."""
    out: Dict[str, torch.Tensor] = {}

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    def walk(node, prefix: str) -> None:
        if node is None:
            return
        if isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
            return
        if not isinstance(node, dict):
            raise TypeError(f"unexpected leaf at {prefix!r}: {type(node)}")
        for k, v in node.items():
            if k == "w":
                a = np.asarray(v)
                out[prefix + "weight"] = tensor(
                    a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
            elif k == "g_scale":
                out[prefix + "weight"] = tensor(v)
            elif k in ("bias", "g_bias"):
                out[prefix + "bias"] = tensor(v)
            elif k == "label_emb":
                out[prefix + "label_emb.weight"] = tensor(v)
            else:
                walk(v, f"{prefix}{k}.")
    walk(tree, "")
    return out


def reference_leaves(model: UNet) -> Dict[str, tuple]:
    """``{port name: (reference dotted name, reference shape, perm)}`` for
    every parameter, ``perm[i]`` the reference dim of the port's dim i:
    a conv's OIHW ``weight`` is the HWIO ``w``, a dense map's (out, in)
    ``weight`` the (in, out) ``w``, a GroupNorm's ``weight``/``bias`` the
    ``g_scale``/``g_bias``, the label embedding's ``weight`` the
    ``label_emb`` leaf of its parent; biases keep their names."""
    out: Dict[str, tuple] = {}
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, nn.Conv2d):
            o, i, kh, kw = full_shape(m.weight)
            out[pre + "weight"] = (pre + "w", (kh, kw, i, o), (3, 2, 0, 1))
        elif isinstance(m, nn.Linear):
            o, i = m.weight.shape
            out[pre + "weight"] = (pre + "w", (i, o), (1, 0))
        elif isinstance(m, nn.GroupNorm):
            out[pre + "weight"] = (pre + "g_scale", tuple(m.weight.shape),
                                   (0,))
            out[pre + "bias"] = (pre + "g_bias", tuple(m.bias.shape), (0,))
            continue
        elif isinstance(m, nn.Embedding):
            out[pre + "weight"] = (name, tuple(m.weight.shape), (0, 1))
            continue
        else:
            continue
        if m.bias is not None:
            out[pre + "bias"] = (pre + "bias", tuple(m.bias.shape), (0,))
    return out


def param_specs(model: UNet, ctx: ShardCtx) -> Dict[str, tuple]:
    """``{port name: spec}`` in the port's layouts: the reference's
    ``param_specs`` of :func:`reference_leaves`'s names and shapes, each
    spec's entries moved to the port's dims."""
    leaves = reference_leaves(model)
    ref = shd.param_specs({r: shape for r, shape, _ in leaves.values()},
                          ctx)
    return {n: tuple(ref[r][d] for d in perm)
            for n, (r, _, perm) in leaves.items()}


def shard_unet(model: UNet, ctx: ShardCtx) -> UNet:
    """Cut ``model``'s parameters in place to this rank's slices under
    :func:`param_specs` on ``ctx``'s mesh (a convolution's block of output
    channels; a cut parameter carries ``full_shape`` and
    ``shard_slices``), and hand each cut convolution the ``ctx``.  The
    specs are kept in ``model.param_specs``."""
    specs = param_specs(model, ctx)
    for name, p in list(model.named_parameters()):
        spec = specs[name]
        if not any(spec):
            continue
        owner, _, leaf = name.rpartition(".")
        m = model.get_submodule(owner)
        cut = shd.shard_slices(p.shape, spec, ctx.mesh)
        new = nn.Parameter(p.detach()[cut].clone(),
                           requires_grad=p.requires_grad)
        new.full_shape, new.shard_slices = p.shape, cut
        setattr(m, leaf, new)
        m.ctx = ctx
    model.param_specs = specs
    return model


def flops_per_image(cfg: UNetConfig) -> float:
    """Operations of one image's forward pass, counted from the
    configuration's shapes: 2 per multiply-add of every conv, dense layer
    and attention product.  Convolutions count every tap, zero padding
    included, so this is a slight upper bound; norms and activations are
    left out."""
    total = 0.0
    td = cfg.time_dim
    total += 2 * 2 * td * td                       # time MLP
    res = cfg.image_size
    ch = cfg.base_channels

    def conv(cin, cout, k, r):
        return 2.0 * cin * cout * k * k * r * r

    def resblock(cin, cout, r):
        f = conv(cin, cout, 3, r) + conv(cout, cout, 3, r) + 2.0 * td * cout
        return f + (conv(cin, cout, 1, r) if cin != cout else 0.0)

    def attn(c, r):
        n = r * r
        return conv(c, 3 * c, 1, r) + conv(c, c, 1, r) + 2 * 2.0 * n * n * c

    total += conv(cfg.in_channels, ch, 3, res)
    cur, chans = ch, [ch]
    for li, mult in enumerate(cfg.channel_mults):
        cout = ch * mult
        for _ in range(cfg.n_res_blocks):
            total += resblock(cur, cout, res)
            cur = cout
            if res in cfg.attn_resolutions:
                total += attn(cur, res)
            chans.append(cur)
        if li < len(cfg.channel_mults) - 1:
            res //= 2
            total += conv(cur, cur, 3, res)
            chans.append(cur)
    total += 2 * resblock(cur, cur, res) + attn(cur, res)
    for li, mult in list(enumerate(cfg.channel_mults))[::-1]:
        cout = ch * mult
        for _ in range(cfg.n_res_blocks + 1):
            total += resblock(cur + chans.pop(), cout, res)
            cur = cout
            if res in cfg.attn_resolutions:
                total += attn(cur, res)
        if li > 0:
            res *= 2
            total += conv(cur, cur, 3, res)
    total += conv(cur, cfg.in_channels, 3, res)
    return total
