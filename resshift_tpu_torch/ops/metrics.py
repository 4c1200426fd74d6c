"""MATLAB-style image quality metrics on the host (numpy; evaluation only).

The port's own copy of the JAX package's `ops/metrics.py`: PSNR, SSIM with
the 11x11 sigma-1.5 Gaussian window and the 'valid' crop, and MATLAB's
`rgb2ycbcr` for the Y-channel protocol.  `scipy.ndimage.correlate` is
imported at the first SSIM.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["rgb2ycbcr", "calculate_psnr", "calculate_ssim", "batch_psnr", "batch_ssim"]

_Y_COEF = np.array([65.481, 128.553, 24.966]) / 255.0
_FULL = np.array([
    [65.481, -37.797, 112.0],
    [128.553, -74.203, -93.786],
    [24.966, 112.0, -18.214],
]) / 255.0


def rgb2ycbcr(im: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB rgb2ycbcr; uint8 [0, 255] or float [0, 1] in, same dtype out."""
    if im.dtype == np.uint8:
        imt = im.astype(np.float64)
    else:
        imt = (im * 255).astype(np.float64)
    if only_y:
        rlt = imt @ _Y_COEF + 16.0
    else:
        rlt = imt @ _FULL + np.array([16, 128, 128])
    if im.dtype == np.uint8:
        rlt = rlt.round()
    else:
        rlt /= 255.0
    return rlt.astype(im.dtype)


def _crop(im1, im2, border):
    if im1.shape != im2.shape:
        raise ValueError("images must share a shape")
    h, w = im1.shape[:2]
    sl = (slice(border, h - border or None), slice(border, w - border or None))
    return im1[sl], im2[sl]


def calculate_psnr(im1: np.ndarray, im2: np.ndarray, border: int = 0,
                   ycbcr: bool = False) -> float:
    """PSNR on [0, 255] images (uint8 or float)."""
    if ycbcr:
        im1, im2 = rgb2ycbcr(im1, True), rgb2ycbcr(im2, True)
    im1, im2 = _crop(im1, im2, border)
    mse = np.mean((im1.astype(np.float64) - im2.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(ax**2) / (2 * sigma**2))
    k /= k.sum()
    return np.outer(k, k)


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    from scipy.ndimage import correlate

    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    win = _gaussian_window()

    def f(x):  # cv2.filter2D's reflect-101 border, then the 'valid' crop
        return correlate(x, win, mode="mirror")[5:-5, 5:-5]

    mu1, mu2 = f(img1), f(img2)
    mu1_sq, mu2_sq, mu12 = mu1**2, mu2**2, mu1 * mu2
    s1 = f(img1**2) - mu1_sq
    s2 = f(img2**2) - mu2_sq
    s12 = f(img1 * img2) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(ssim_map.mean())


def calculate_ssim(im1: np.ndarray, im2: np.ndarray, border: int = 0,
                   ycbcr: bool = False) -> float:
    """MATLAB-style SSIM on [0, 255] images; the channel mean for RGB."""
    if ycbcr:
        im1, im2 = rgb2ycbcr(im1, True), rgb2ycbcr(im2, True)
    im1, im2 = _crop(im1, im2, border)
    if im1.ndim == 2:
        return _ssim_single(im1, im2)
    if im1.shape[2] == 1:
        return _ssim_single(im1[..., 0], im2[..., 0])
    return float(np.mean([_ssim_single(im1[..., i], im2[..., i]) for i in range(3)]))


def _to_ubyte(x: np.ndarray) -> np.ndarray:
    """[0, 1] float -> uint8, as skimage's img_as_ubyte."""
    return np.clip(np.round(np.clip(x, 0, 1) * 255.0), 0, 255).astype(np.uint8)


def _y_ubyte(img: np.ndarray, clean: np.ndarray, ycbcr: bool):
    """The protocol's inputs: Y in float (when asked), then uint8."""
    if ycbcr:
        img = np.stack([rgb2ycbcr(i.astype(np.float64), True) for i in img])[..., None]
        clean = np.stack([rgb2ycbcr(c.astype(np.float64), True) for c in clean])[..., None]
    return _to_ubyte(img), _to_ubyte(clean)


def batch_psnr(img: np.ndarray, clean: np.ndarray, border: int = 0,
               ycbcr: bool = False) -> float:
    """Summed PSNR over an NHWC [0, 1] batch."""
    img8, clean8 = _y_ubyte(img, clean, ycbcr)
    return float(sum(calculate_psnr(clean8[i], img8[i], border) for i in range(img8.shape[0])))


def batch_ssim(img: np.ndarray, clean: np.ndarray, border: int = 0,
               ycbcr: bool = False) -> float:
    """Summed SSIM over an NHWC [0, 1] batch."""
    img8, clean8 = _y_ubyte(img, clean, ycbcr)
    return float(sum(calculate_ssim(clean8[i], img8[i], border) for i in range(img8.shape[0])))
