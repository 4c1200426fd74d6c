"""Face degradations on the host (the port's own copy of the JAX package's
`data/faces.py`), in numpy without OpenCV:

  * `ffhq_degrade`: the GFPGAN-style training degradation of faceir
    training (a mixed-kernel 41x41 blur, a downsample by a drawn factor,
    Gaussian noise, a JPEG round trip, the resize back, optional colour
    jitter and gray);
  * `face_degradation`: the deterministic-parameter degradation of the
    face test sets.

Every draw comes from the caller's `np.random.Generator`, in the JAX
package's order.  OpenCV's filter2D, float resizes, gray conversion and
JPEG round trip are `ops/cv.py`'s and `ops/jpeg.py`'s.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops import cv
from ..ops.jpeg import jpeg_roundtrip
from . import degradations as deg

__all__ = ["ffhq_degrade", "face_degradation", "color_jitter"]


def _add_gaussian_noise_np(rng, img, sigma):
    noise = rng.standard_normal(img.shape).astype(np.float32) * sigma / 255.0
    return np.clip(img + noise, 0, 1)


def _jpeg_np(img, quality):
    """JPEG round trip of a [0, 1] RGB image at int(quality), the 8-bit
    image truncated (not rounded) from x * 255, as the JAX package does."""
    im8 = (np.clip(img, 0, 1) * 255.0).astype(np.uint8)
    return jpeg_roundtrip(im8, int(quality)).astype(np.float32) / 255.0


def _gray3(img):
    return np.tile(cv.rgb_to_gray_float(img)[:, :, None], (1, 1, 3))


def color_jitter(rng, img, shift):
    jitter = rng.uniform(-shift, shift, 3).astype(np.float32)
    return np.clip(img + jitter, 0, 1)


def ffhq_degrade(
    rng: np.random.Generator,
    img_gt: np.ndarray,  # HWC RGB [0, 1], float32
    *,
    blur_kernel_size: int = 41,
    kernel_list=("iso", "aniso"),
    kernel_prob=(0.5, 0.5),
    blur_sigma=(0.1, 15),
    downsample_range=(0.8, 32),
    noise_range=(0, 20),
    jpeg_range=(30, 100),
    color_jitter_prob: float | None = None,
    color_jitter_shift: float = 20 / 255.0,
    gray_prob: float | None = 0.01,
    gt_gray: bool = True,
):
    """Returns (gt, lq), both HWC RGB float32 in [0, 1]; lq on 8-bit levels."""
    h, w, _ = img_gt.shape
    kernel = deg.random_mixed_kernels(
        rng, list(kernel_list), list(kernel_prob), blur_kernel_size,
        blur_sigma, blur_sigma, (-math.pi, math.pi),
    )
    lq = cv.filter2d(img_gt, kernel)
    scale = rng.uniform(*downsample_range)
    lq = cv.resize_float(lq, (int(w // scale), int(h // scale)), "linear")
    if noise_range is not None:
        lq = _add_gaussian_noise_np(rng, lq, rng.uniform(*noise_range))
    if jpeg_range is not None:
        lq = _jpeg_np(lq, rng.uniform(*jpeg_range))
    lq = cv.resize_float(lq, (w, h), "linear")

    if color_jitter_prob is not None and rng.uniform() < color_jitter_prob:
        lq = color_jitter(rng, lq, color_jitter_shift)
    if gray_prob and rng.uniform() < gray_prob:
        lq = _gray3(lq)
        if gt_gray:
            img_gt = _gray3(img_gt)

    lq = np.clip((lq * 255.0).round(), 0, 255) / 255.0
    return img_gt.astype(np.float32), lq.astype(np.float32)


def face_degradation(im: np.ndarray, sf: float, sig_x: float, sig_y: float,
                     theta: float, nf: float, qf: float,
                     rng: np.random.Generator | None = None) -> np.ndarray:
    """The test-set degradation with given parameters: an anisotropic 41x41
    Gaussian blur, a downsample by sf, Gaussian noise of level nf (drawn
    from `rng`), JPEG at quality qf, the resize back.  im: HWC RGB [0, 1]."""
    rng = rng or np.random.default_rng(0)
    h, w = im.shape[:2]
    kernel = deg.bivariate_gaussian(41, sig_x, sig_y, theta, isotropic=False)
    lq = cv.filter2d(im, kernel.astype(np.float32))
    lq = cv.resize_float(lq, (int(w // sf), int(h // sf)), "linear")
    lq = _add_gaussian_noise_np(rng, lq, nf)
    lq = _jpeg_np(lq, qf)
    lq = cv.resize_float(lq, (w, h), "linear")
    return np.clip((lq * 255.0).round(), 0, 255) / 255.0
