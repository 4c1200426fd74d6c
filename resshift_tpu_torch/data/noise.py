"""Noise of the degradation pipeline on NHWC tensors in [0, 1] (the port's
own copy of the JAX package's `data/noise.py`).

  * Gaussian noise with a per-sample sigma (in 8-bit units) and a
    per-sample gray flag (a gray sample takes one noise plane for all
    channels);
  * Poisson (shot) noise with vals = 2^ceil(log2(#unique 8-bit levels))
    per sample (`_vals_from_unique`), on the image rounded to 8 bits, and
    the same on its gray version (torchvision's coefficients) for gray
    samples.
The draws come from `generator`, or are given: `noise=` / `gray_noise=`
(unit normals) for the Gaussian, `counts=` / `gray_counts=` (the Poisson
counts) for the shot noise, so that a test can feed the JAX package's.
"""

from __future__ import annotations

import torch

__all__ = ["add_gaussian_noise", "add_poisson_noise"]

_GRAY = (0.2989, 0.587, 0.114)


def _to_gray(img: torch.Tensor) -> torch.Tensor:
    return (img * torch.tensor(_GRAY, device=img.device)).sum(-1, keepdim=True)


def add_gaussian_noise(img: torch.Tensor, sigma: torch.Tensor, gray: torch.Tensor,
                       generator: torch.Generator | None = None, clip: bool = True, *,
                       noise: torch.Tensor | None = None,
                       gray_noise: torch.Tensor | None = None) -> torch.Tensor:
    """img (B, H, W, 3); sigma (B,) in 8-bit units; gray (B,) 0 / 1."""
    b, h, w, _ = img.shape
    if noise is None:
        noise = torch.randn(img.shape, generator=generator, device=img.device)
    if gray_noise is None:
        gray_noise = torch.randn((b, h, w, 1), generator=generator, device=img.device)
    sigma = sigma.reshape(b, 1, 1, 1) / 255.0
    g = gray.reshape(b, 1, 1, 1).float()
    noise = (noise * sigma) * (1 - g) + (gray_noise * sigma).expand(img.shape) * g
    out = img + noise
    return out.clamp(0.0, 1.0) if clip else out


def _vals_from_unique(img01: torch.Tensor) -> torch.Tensor:
    """Per sample, 2^ceil(log2(the number of distinct 8-bit levels))."""
    b = img01.shape[0]
    levels = torch.round(img01 * 255.0).clamp(0, 255).long().reshape(b, -1)
    counts = torch.zeros(b, 256, device=img01.device).scatter_add_(
        1, levels, torch.ones(levels.shape, device=img01.device))
    uniq = (counts > 0).sum(1).float()
    return torch.exp2(torch.ceil(torch.log2(uniq)))


def add_poisson_noise(img: torch.Tensor, scale: torch.Tensor, gray: torch.Tensor,
                      generator: torch.Generator | None = None, clip: bool = True, *,
                      counts: torch.Tensor | None = None,
                      gray_counts: torch.Tensor | None = None) -> torch.Tensor:
    """Shot noise poisson(img * vals) / vals - img, times `scale` (B,)."""
    b = img.shape[0]
    g = gray.reshape(b, 1, 1, 1).float()
    scale = scale.reshape(b, 1, 1, 1)
    imgq = torch.round(img * 255.0).clamp(0, 255) / 255.0
    vals = _vals_from_unique(imgq).reshape(b, 1, 1, 1)
    if counts is None:
        counts = torch.poisson(imgq * vals, generator=generator)
    noise = counts.float() / vals - imgq
    img_gray = torch.round(_to_gray(img) * 255.0).clamp(0, 255) / 255.0
    vals_g = _vals_from_unique(img_gray).reshape(b, 1, 1, 1)
    if gray_counts is None:
        gray_counts = torch.poisson(img_gray * vals_g, generator=generator)
    noise_g = (gray_counts.float() / vals_g - img_gray).expand(img.shape)
    out = img + (noise * (1 - g) + noise_g * g) * scale
    return out.clamp(0.0, 1.0) if clip else out
