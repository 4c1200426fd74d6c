"""Batched image filtering on NHWC tensors (the port's own copy of the JAX
package's `ops/filters.py`).

  * `filter2d`: correlation with a KxK kernel after reflect padding (numpy's
    reflection, also where the padding exceeds the side), one kernel for the
    batch or one per sample (a grouped conv with the batch folded into the
    channels);
  * `gaussian_kernel2d`: OpenCV's `getGaussianKernel(ksize, sigma)` outer
    product (sigma <= 0 takes OpenCV's rule from the size);
  * `usm_sharp`: unsharp masking with a thresholded soft mask.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["filter2d", "gaussian_kernel2d", "usm_sharp"]


@functools.lru_cache(maxsize=256)
def _reflect(n: int, p: int) -> np.ndarray:
    """Indices of a length-n axis reflect-padded by p on each side."""
    return np.pad(np.arange(n), p, mode="reflect")


def _pad_reflect(img: torch.Tensor, p: int) -> torch.Tensor:
    _, h, w, _ = img.shape
    ih = torch.as_tensor(_reflect(h, p), device=img.device)
    iw = torch.as_tensor(_reflect(w, p), device=img.device)
    return img.index_select(1, ih).index_select(2, iw)


def filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C); kernel (B, k, k) per sample or (1, k, k) for all,
    k odd.  Correlation (no kernel flip), as torch's conv2d and OpenCV's
    filter2D compute it."""
    b, h, w, c = img.shape
    kb, k, _ = kernel.shape
    if k % 2 != 1:
        raise ValueError(f"filter2d takes an odd kernel size, not {k}")
    x = _pad_reflect(img, k // 2).permute(0, 3, 1, 2)
    kernel = kernel.to(img.dtype)
    if kb == 1:
        weight = kernel[0].expand(c, 1, k, k)
        return F.conv2d(x, weight, groups=c).permute(0, 2, 3, 1)
    weight = kernel[:, None, None].expand(b, c, 1, k, k).reshape(b * c, 1, k, k)
    out = F.conv2d(x.reshape(1, b * c, h + k - 1, w + k - 1), weight, groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=8)
def gaussian_kernel2d(radius: int = 51, sigma: float = 0.0) -> np.ndarray:
    """OpenCV's `getGaussianKernel(radius, sigma)` outer product, float32."""
    if sigma <= 0:
        sigma = 0.3 * ((radius - 1) * 0.5 - 1) + 0.8
    ax = np.arange(radius, dtype=np.float64) - (radius - 1) / 2.0
    k = np.exp(-(ax**2) / (2 * sigma**2))
    k /= k.sum()
    return np.outer(k, k).astype(np.float32)


def usm_sharp(img: torch.Tensor, weight: float = 0.5, radius: int = 50,
              threshold: float = 10.0) -> torch.Tensor:
    """Unsharp masking of NHWC images in [0, 1]."""
    if radius % 2 == 0:
        radius += 1
    kern = torch.as_tensor(gaussian_kernel2d(radius, 0.0), device=img.device)[None]
    residual = img - filter2d(img, kern)
    mask = ((residual.abs() * 255.0) > threshold).to(img.dtype)
    soft_mask = filter2d(mask, kern)
    sharp = (img + weight * residual).clamp(0.0, 1.0)
    return soft_mask * sharp + (1 - soft_mask) * img
