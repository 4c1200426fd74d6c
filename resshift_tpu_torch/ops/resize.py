"""Separable image resizing as two dense resampling matrices.

The matrices are built on the host in float64 numpy (the same builder as
the JAX package's `ops/resize.py`) and applied as two float32 matmuls:
  * `bicubic_torch`: `F.interpolate(mode='bicubic', align_corners=False)`
    (cubic a = -0.75, replicate border; with `antialias` on a downscale,
    torch's antialiased form: a = -0.5, out-of-range taps dropped and the
    rest renormalised);
  * `bicubic_matlab`: MATLAB's `imresize` (a = -0.5, antialiased on a
    downscale, symmetric border, weights renormalised);
  * `bilinear`, `nearest` (src = floor(dst * in / out)) and `area`
    (adaptive average pooling), as `F.interpolate` has them.
Each matrix is cached per (sizes, mode, antialias) on the host and per
device once moved there, so that a call makes no host-to-device copy after
the first of its shape.  `resize_np` applies the same matrices in float64
numpy, for the host-side data loaders, summing only each row's band.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["resize", "resize_np", "resize_matrix", "resize_matrix_np", "imresize_matlab",
           "upsample_nearest"]


def _cubic_torch(x: np.ndarray) -> np.ndarray:
    """Cubic convolution kernel with a = -0.75 (PyTorch's bicubic)."""
    a = -0.75
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return np.where(ax <= 1, (a + 2) * ax3 - (a + 3) * ax2 + 1,
                    np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0))


def _cubic_matlab(x: np.ndarray) -> np.ndarray:
    """MATLAB's bicubic kernel, a = -0.5."""
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((1 < ax) & (ax <= 2)))


def _linear(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


_KERNELS = {"bicubic_torch": (_cubic_torch, 2.0), "bicubic_matlab": (_cubic_matlab, 2.0),
            "bilinear": (_linear, 1.0)}


def _reflect_index(idx: np.ndarray, n: int) -> np.ndarray:
    """MATLAB's symmetric border: ... 1, 0 | 0, 1, ... n-1 | n-1, n-2 ..."""
    idx = np.where(idx < 0, -idx - 1, idx)
    idx = np.where(idx >= n, 2 * n - idx - 1, idx)
    idx = np.where(idx < 0, -idx - 1, idx)  # once more for a very small n
    return np.clip(idx, 0, n - 1)


@functools.lru_cache(maxsize=256)
def resize_matrix_np(in_size: int, out_size: int, mode: str = "bicubic_torch",
                     antialias: bool = False) -> np.ndarray:
    """Dense (out_size, in_size) float64 resampling matrix."""
    scale = out_size / in_size
    if mode == "nearest":
        m = np.zeros((out_size, in_size))
        src = np.floor(np.arange(out_size) * (in_size / out_size)).astype(int)
        m[np.arange(out_size), np.clip(src, 0, in_size - 1)] = 1.0
        return m
    if mode == "area":  # bin i = [floor(i in / out), ceil((i + 1) in / out))
        m = np.zeros((out_size, in_size))
        for i in range(out_size):
            lo, hi = (i * in_size) // out_size, -((-(i + 1) * in_size) // out_size)
            m[i, lo:hi] = 1.0 / (hi - lo)
        return m
    if mode not in _KERNELS:
        raise ValueError(f"unknown resize mode {mode!r}")
    kernel, support = _KERNELS[mode]
    aa = antialias and scale < 1.0
    if mode == "bicubic_torch" and aa:  # torch's antialiased bicubic: PIL's a = -0.5
        kernel = _cubic_matlab
    u = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5  # align_corners=False
    kscale = min(scale, 1.0) if aa else 1.0
    ksupport = support / kscale
    left = np.floor(u - ksupport).astype(int) + 1
    p = int(math.ceil(2 * ksupport)) + 2
    idx = left[:, None] + np.arange(p)[None, :]
    w = kernel((u[:, None] - idx) * kscale) * kscale
    if mode == "bicubic_matlab":
        w = w / w.sum(axis=1, keepdims=True)
        idx_b = _reflect_index(idx, in_size)
    elif aa:  # drop the out-of-range taps, renormalise the rest
        w = np.where((idx >= 0) & (idx < in_size), w, 0.0)
        w = w / w.sum(axis=1, keepdims=True)
        idx_b = np.clip(idx, 0, in_size - 1)
    else:  # replicate border; the weights already sum to 1
        idx_b = np.clip(idx, 0, in_size - 1)
    m = np.zeros((out_size, in_size))
    np.add.at(m, (np.repeat(np.arange(out_size), p), idx_b.ravel()), w.ravel())
    return m


_DEVICE_CACHE: dict[tuple, torch.Tensor] = {}


def resize_matrix(in_size: int, out_size: int, mode: str = "bicubic_torch",
                  antialias: bool = False, device: str | torch.device = "cpu") -> torch.Tensor:
    """The float32 matrix on `device`, moved there once per shape."""
    key = (in_size, out_size, mode, antialias, torch.device(device))
    m = _DEVICE_CACHE.get(key)
    if m is None:
        m = torch.as_tensor(resize_matrix_np(in_size, out_size, mode, antialias),
                            dtype=torch.float32, device=device)
        _DEVICE_CACHE[key] = m
    return m


def resize(x: torch.Tensor, out_hw: tuple[int, int], mode: str = "bicubic_torch",
           antialias: bool = False) -> torch.Tensor:
    """Resize NHWC (or HWC, HW) images to `out_hw` in float32; returns x's
    dtype.  `bicubic_matlab` is always antialiased, as MATLAB's default."""
    if mode == "bicubic_matlab":
        antialias = True
    nd = x.ndim
    if nd == 2:
        x = x[None, :, :, None]
    elif nd == 3:
        x = x[None]
    _, h, w, _ = x.shape
    oh, ow = out_hw
    xf = x.float()
    if h != oh:
        xf = torch.einsum("oh,nhwc->nowc", resize_matrix(h, oh, mode, antialias, x.device), xf)
    if w != ow:
        xf = torch.einsum("ow,nhwc->nhoc", resize_matrix(w, ow, mode, antialias, x.device), xf)
    out = xf.to(x.dtype)
    return out[0, :, :, 0] if nd == 2 else out[0] if nd == 3 else out


@functools.lru_cache(maxsize=256)
def _band(in_size: int, out_size: int, mode: str, antialias: bool):
    """The matrix's nonzero band: for each output row the input indices
    from its first to its last nonzero column, ascending, (out, width), and
    their weights (zero past a row's band)."""
    m = resize_matrix_np(in_size, out_size, mode, antialias)
    nz = m != 0
    lo, hi = nz.argmax(1), in_size - nz[:, ::-1].argmax(1)
    k = np.arange(int((hi - lo).max()))
    idx = np.minimum(lo[:, None] + k, in_size - 1)
    return idx, np.where(k < (hi - lo)[:, None], np.take_along_axis(m, idx, 1), 0.0)


def resize_np(x: np.ndarray, out_hw: tuple[int, int], mode: str = "bicubic_matlab",
              antialias: bool = False) -> np.ndarray:
    """The same resize in float64 numpy on an HWC or HW array; returns x's
    dtype.  Each output sums its band's taps in ascending order, as the
    JAX package's `np.einsum` over the dense matrix adds every input in
    order (its zero columns add nothing exactly): the same bits, at the
    band's cost instead of the whole side's."""
    if mode == "bicubic_matlab":
        antialias = True
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    h, w, c = x.shape
    oh, ow = out_hw
    out = x.astype(np.float64)
    if h != oh:
        idx, wt = _band(h, oh, mode, antialias)
        acc = np.zeros((oh, w, c))
        for k in range(idx.shape[1]):
            acc += wt[:, k, None, None] * out[idx[:, k]]
        out = acc
    if w != ow:
        idx, wt = _band(w, ow, mode, antialias)
        acc = np.zeros((out.shape[0], ow, c))
        for k in range(idx.shape[1]):
            acc += wt[None, :, k, None] * out[:, idx[:, k]]
        out = acc
    out = out.astype(x.dtype)
    return out[..., 0] if squeeze else out


def imresize_matlab(x: np.ndarray, scale: float) -> np.ndarray:
    """MATLAB `imresize(im, scale)`: output ceil(in * scale), antialiased
    a = -0.5 cubic, symmetric border."""
    h, w = x.shape[:2]
    return resize_np(x, (int(np.ceil(h * scale)), int(np.ceil(w * scale))), "bicubic_matlab")


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest upsample of NHWC images by an integer factor."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)
