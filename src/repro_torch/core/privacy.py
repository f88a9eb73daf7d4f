"""Disclosed-information metrics: pixel MSE and KID (paper §4-5);
counterpart of ``repro/core/privacy.py``.

KID = unbiased MMD² with the polynomial kernel k(x,y) = (xᵀy/d + 1)³
(Binkowski et al. 2018), over features from a FIXED random convolutional
extractor (InceptionV3 is not available offline; a frozen random conv net
keeps *relative* orderings, and every claim of the paper is a comparison
across cut-ratios, not an absolute KID level).

Feature weights keep the reference's layouts — ``convs`` HWIO, ``head``
(c, feat_dim) — so the reference's ``feature_params()`` can be passed in as
numpy arrays; :func:`feature_params` draws the port's own.  Everything runs
on the device of the images.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import trunc_normal_
from repro_torch.models.unet import conv_same


# ---------------------------------------------------------------------------
# feature extractor
# ---------------------------------------------------------------------------
def feature_params(seed: int = 1234, channels=(16, 32, 64), in_ch: int = 1,
                   feat_dim: int = 256) -> Dict:
    """Frozen random conv features drawn from ``seed`` on the CPU with the
    reference's ``dense_init`` law (a standard normal truncated to ±3,
    scaled by fan-in^-1/2).  The two frameworks draw different numbers;
    pass the reference's arrays in to get its features."""
    gen = torch.Generator().manual_seed(seed)
    convs, c_prev = [], in_ch
    for c in channels:
        convs.append(trunc_normal_(torch.empty(3, 3, c_prev, c), 9 * c_prev,
                                   gen))
        c_prev = c
    head = trunc_normal_(torch.empty(c_prev, feat_dim), c_prev, gen)
    return {"convs": convs, "head": head}


def _on(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _extract_chunk(params, images: torch.Tensor) -> torch.Tensor:
    dev = images.device
    x = images.to(torch.float32).permute(0, 3, 1, 2)           # NHWC -> NCHW
    for w in params["convs"]:
        x = conv_same(x, _on(w, dev).permute(3, 2, 0, 1), None, 2)
        x = F.leaky_relu(x, 0.2)
    x = x.mean(dim=(2, 3))                        # global average pool
    return x @ _on(params["head"], dev)


def extract_features(params, images: torch.Tensor,
                     chunk_size: int = 512) -> torch.Tensor:
    """images: (N, H, W, C) in [-1, 1] -> (N, feat_dim) float32.

    Batches beyond ``chunk_size`` go through in slices of the batch axis.
    Each image's features are a function of that image alone, but the
    convolutions may pick other algorithms at other batch sizes: chunked
    features agree with the one-shot ones to float32 rounding, not bit for
    bit (the reference's own bitwise claim fails).
    """
    images = torch.as_tensor(images)
    n = images.shape[0]
    if n <= chunk_size:
        return _extract_chunk(params, images)
    return torch.cat([_extract_chunk(params, images[i:i + chunk_size])
                      for i in range(0, n, chunk_size)])


# ---------------------------------------------------------------------------
# KID (unbiased MMD², polynomial kernel)
# ---------------------------------------------------------------------------
def _poly_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    return (x @ y.T / d + 1.0) ** 3


def kid_from_features(fx: torch.Tensor, fy: torch.Tensor, *,
                      small_batch: str = "error") -> torch.Tensor:
    """Unbiased MMD² estimator (Binkowski et al. 2018, eq. 3).

    The unbiased estimator divides by m·(m-1) and n·(n-1), which is 0 for a
    single-image batch: that raises by default.  ``small_batch="biased"``
    selects the BIASED V-statistic (diagonal kept, divide by m²/n²), defined
    down to one image at the cost of a positive bias of order 1/m.
    """
    if small_batch not in ("error", "biased"):
        raise ValueError(f"small_batch={small_batch!r}: 'error' or 'biased'")
    m, n = fx.shape[0], fy.shape[0]
    kxx = _poly_kernel(fx, fx)
    kyy = _poly_kernel(fy, fy)
    kxy = _poly_kernel(fx, fy)
    sum_kxy = kxy.mean()
    if m < 2 or n < 2:
        if small_batch != "biased":
            raise ValueError(
                f"unbiased KID needs >= 2 images per batch (got m={m}, "
                f"n={n}): the m*(m-1)/n*(n-1) denominators are 0 — pass a "
                f"larger batch or small_batch='biased' for the V-statistic")
        return kxx.mean() + kyy.mean() - 2 * sum_kxy
    sum_kxx = (kxx.sum() - torch.trace(kxx)) / (m * (m - 1))
    sum_kyy = (kyy.sum() - torch.trace(kyy)) / (n * (n - 1))
    return sum_kxx + sum_kyy - 2 * sum_kxy


def kid(params, real: torch.Tensor, generated: torch.Tensor
        ) -> torch.Tensor:
    """KID between two image batches (lower = closer distributions)."""
    return kid_from_features(extract_features(params, real),
                             extract_features(params, generated))


# ---------------------------------------------------------------------------
# pixel-level disclosure
# ---------------------------------------------------------------------------
def mse_disclosure(real: torch.Tensor, disclosed: torch.Tensor
                   ) -> torch.Tensor:
    """Pixel-by-pixel MSE between real client images and the partially
    denoised images at the cut.  HIGHER = more concealed."""
    return torch.mean(torch.square(real.to(torch.float32) -
                                   disclosed.to(torch.float32)))


def disclosure_report(feat_params, real: torch.Tensor,
                      disclosed: torch.Tensor) -> Dict:
    """{"mse", "kid"} of the disclosed images against the real ones, on the
    disclosed images' device."""
    real = torch.as_tensor(real).to(disclosed.device)
    return {"mse": float(mse_disclosure(real, disclosed)),
            "kid": float(kid(feat_params, real, disclosed))}
