"""Synthetic client datasets for the CollaFuse split training, and
synthetic LM token batches (counterpart of ``repro/data/synthetic.py``; the
port's own copy of its numpy code).

The paper trains on BraTS MRI brain scans, which are not available offline.
These are structured grayscale images — anisotropic-Gaussian "brain"
masses with an inner "ventricle" and speckle texture, with per-client
shifts of position and eccentricity — so that a DDPM visibly learns the
distribution and the clients' distributions differ.  The same seed gives
arrays bitwise equal to the reference's.  Everything is made on the CPU
with numpy; the images are returned as CPU tensors (the caller moves
them), the token batches on the device asked for.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ClientDataConfig:
    n_clients: int = 3
    per_client: int = 256
    image_size: int = 32
    holdout: int = 128
    seed: int = 0


def _make_images(rng: np.random.Generator, n: int, size: int,
                 center_shift: float, ecc: float) -> np.ndarray:
    """Ellipse "brain" + inner "ventricle" + speckle texture, in [-1, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / size - 0.5
    imgs = np.zeros((n, size, size, 1), np.float32)
    for i in range(n):
        cx = center_shift + rng.normal(0, 0.05)
        cy = rng.normal(0, 0.05)
        a = 0.32 + rng.normal(0, 0.03)
        b = a * (ecc + rng.normal(0, 0.05))
        theta = rng.uniform(0, np.pi)
        ct, st = np.cos(theta), np.sin(theta)
        u = (xx - cx) * ct + (yy - cy) * st
        v = -(xx - cx) * st + (yy - cy) * ct
        brain = np.exp(-((u / a) ** 2 + (v / b) ** 2) * 3.0)
        vent = np.exp(-(((u) / (a * 0.25)) ** 2 +
                        ((v) / (b * 0.35)) ** 2) * 3.0)
        tex = rng.normal(0, 0.05, (size, size))
        img = brain - 0.55 * vent + tex * (brain > 0.2)
        imgs[i, :, :, 0] = img
    imgs = np.clip(imgs, 0, 1.2)
    return (imgs / 0.6 - 1.0).astype(np.float32)


def make_client_datasets(cfg: ClientDataConfig
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Returns (clients: list of (N, H, W, 1), holdout: (M, H, W, 1)), CPU
    float32 tensors.  Clients differ in position and eccentricity —
    mimicking the paper's patient-disjoint per-institution datasets."""
    rng = np.random.default_rng(cfg.seed)
    shifts = np.linspace(-0.12, 0.12, cfg.n_clients)
    eccs = np.linspace(0.6, 0.9, cfg.n_clients)
    clients = [
        torch.from_numpy(_make_images(rng, cfg.per_client, cfg.image_size,
                                      shifts[i], eccs[i]))
        for i in range(cfg.n_clients)
    ]
    holdout = torch.from_numpy(_make_images(rng, cfg.holdout, cfg.image_size,
                                            0.0, 0.75))
    return clients, holdout


def image_batches(data: torch.Tensor, batch: int, seed: int = 0
                  ) -> Iterator[torch.Tensor]:
    """Infinite shuffled batch iterator (the reference's permutation
    order)."""
    n = data.shape[0]
    rng = np.random.default_rng(seed)
    while True:
        perm = torch.from_numpy(rng.permutation(n))
        for i in range(0, n - batch + 1, batch):
            yield data[perm[i:i + batch]]


def token_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                  structured: bool = True, device: DeviceLike = "cuda"
                  ) -> Iterator[dict]:
    """Infinite synthetic LM batches {"tokens", "labels"}, each (batch,
    seq) int64 on ``device`` (the index dtype ``Embed`` and the loss's
    gather take; the values are the reference's int32 ones, drawn in its
    order): structured = a noisy integer-sequence grammar (learnable),
    else uniform random; labels are the tokens shifted by one."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    while True:
        if structured:
            start = rng.integers(0, vocab, (batch, 1))
            step = rng.integers(1, 7, (batch, 1))
            seqs = (start + step * np.arange(seq + 1)) % vocab
            noise = rng.integers(0, vocab, seqs.shape)
            mask = rng.random(seqs.shape) < 0.05
            seqs = np.where(mask, noise, seqs)
        else:
            seqs = rng.integers(0, vocab, (batch, seq + 1))
        seqs = torch.from_numpy(seqs.astype(np.int64)).to(dev)
        yield {"tokens": seqs[:, :-1].contiguous(),
               "labels": seqs[:, 1:].contiguous()}
