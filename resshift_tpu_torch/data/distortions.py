"""LaMa-style geometric and photometric distortions for inpainting training
(the port's own copy of the JAX package's `data/distortions.py`):

    SmallestMaxSize(out)  ->  Perspective(scale U(0, 0.06), p=.5)
    ->  Affine(scale U(.7, 1.3), rotate U(-40, 40) deg, shear U(-.1, .1) deg,
        reflect border, p=.5)
    ->  PadIfNeeded(out, reflect101)  ->  OpticalDistortion(.05/.05, p=.5)
    ->  RandomCrop(out)  ->  HFlip(p=.5)  ->  CLAHE(clip U(1, 4), 8x8, p=.5)
    ->  RandomBrightnessContrast(.2/.2, p=.5)
    ->  HueSaturationValue(5/30/5, p=.5)

On uint8 HWC RGB; returns float32 in [0, 1] (the caller normalises).  The
draws come from the `np.random.Generator` given to each call, in the JAX
package's order, coin flips included; the OpenCV calls of the JAX package
are `ops/cv.py`'s numpy stand-ins (their bands against OpenCV: ROADMAP.md
section 3).
"""

from __future__ import annotations

import math

import numpy as np

from ..ops import cv

__all__ = ["LamaDistortions"]


def _smallest_max_size(im: np.ndarray, size: int) -> np.ndarray:
    h, w = im.shape[:2]
    s = size / min(h, w)
    if s == 1.0:
        return im
    return cv.resize_linear(im, (max(size, round(w * s)), max(size, round(h * s))))


def _perspective(im: np.ndarray, rng: np.random.Generator,
                 scale_range=(0.0, 0.06)) -> np.ndarray:
    """Four-point perspective jitter (imgaug PerspectiveTransform: corner
    offsets ~ N(0, s*dim), s ~ U(scale_range)), replicate border, keep size."""
    h, w = im.shape[:2]
    s = rng.uniform(*scale_range)
    jit_x = rng.normal(0, s, 4) * w
    jit_y = rng.normal(0, s, 4) * h
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = src + np.stack([jit_x, jit_y], axis=1).astype(np.float32)
    return cv.warp_perspective(im, cv.get_perspective_transform(dst, src), (w, h))


def _affine(im: np.ndarray, rng: np.random.Generator, scale=(0.7, 1.3),
            rotate=(-40, 40), shear=(-0.1, 0.1)) -> np.ndarray:
    """Independent x/y scale + rotation + (degree) shear about the center,
    reflect border (IAAAffine2 -> iaa.Affine semantics)."""
    h, w = im.shape[:2]
    sx, sy = rng.uniform(*scale), rng.uniform(*scale)
    rot = math.radians(rng.uniform(*rotate))
    shx = math.radians(rng.uniform(*shear))
    shy = math.radians(rng.uniform(*shear))
    cx, cy = w / 2.0, h / 2.0
    # M = T(c) @ R(rot) @ Shear @ Scale @ T(-c)
    cr, sr = math.cos(rot), math.sin(rot)
    rot_m = np.array([[cr, -sr], [sr, cr]])
    shear_m = np.array([[1.0, math.tan(shx)], [math.tan(shy), 1.0]])
    scale_m = np.diag([sx, sy])
    A = rot_m @ shear_m @ scale_m
    t = np.array([cx, cy]) - A @ np.array([cx, cy])
    M = np.concatenate([A, t[:, None]], axis=1).astype(np.float32)
    return cv.warp_affine(im, M, (w, h))


def _pad_if_needed(im: np.ndarray, size: int) -> np.ndarray:
    h, w = im.shape[:2]
    ph, pw = max(size - h, 0), max(size - w, 0)
    if not (ph or pw):
        return im
    top, left = ph // 2, pw // 2
    return cv.copy_make_border_reflect101(im, top, ph - top, left, pw - left)


def _optical_distortion(im: np.ndarray, rng: np.random.Generator,
                        distort_limit=0.05, shift_limit=0.05) -> np.ndarray:
    """Barrel/pincushion distortion via a distorted camera model
    (albumentations OpticalDistortion defaults)."""
    h, w = im.shape[:2]
    k = rng.uniform(-distort_limit, distort_limit)
    dx = round(rng.uniform(-shift_limit, shift_limit) * w)
    dy = round(rng.uniform(-shift_limit, shift_limit) * h)
    fx, fy = w, h
    cx, cy = w * 0.5 + dx, h * 0.5 + dy
    cam = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    dist = np.array([k, k, 0, 0, 0], np.float32)
    return cv.remap(im, *cv.init_undistort_rectify_map(cam, dist, (w, h)))


def _clahe(im: np.ndarray, rng: np.random.Generator,
           clip_limit=(1.0, 4.0)) -> np.ndarray:
    """CLAHE on the L channel of LAB (albumentations CLAHE on RGB)."""
    clip = rng.uniform(*clip_limit)
    lab = cv.rgb_to_lab(im)
    lab[..., 0] = cv.clahe(lab[..., 0], clip, (8, 8))
    return cv.lab_to_rgb(lab)


def _brightness_contrast(im: np.ndarray, rng: np.random.Generator,
                         limit=0.2) -> np.ndarray:
    alpha = 1.0 + rng.uniform(-limit, limit)
    beta = rng.uniform(-limit, limit)
    out = im.astype(np.float32) * alpha + beta * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def _hsv_jitter(im: np.ndarray, rng: np.random.Generator, hue=5, sat=30,
                val=5) -> np.ndarray:
    hsv = cv.rgb_to_hsv(im).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + round(rng.uniform(-hue, hue))) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + round(rng.uniform(-sat, sat)), 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + round(rng.uniform(-val, val)), 0, 255)
    return cv.hsv_to_rgb(hsv.astype(np.uint8))


class LamaDistortions:
    """Full lama_distortions stack.  `__call__(im_uint8, rng)` -> float32
    [0,1] HWC crop of `pch_size`."""

    def __init__(self, pch_size: int = 256, p: float = 0.5):
        self.pch_size = pch_size
        self.p = p

    def __call__(self, im: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if im.dtype != np.uint8:
            im = np.clip(np.round(im * 255.0), 0, 255).astype(np.uint8)
        s = self.pch_size
        im = _smallest_max_size(im, s)
        if rng.uniform() < self.p:
            im = _perspective(im, rng)
        if rng.uniform() < self.p:
            im = _affine(im, rng)
        im = _pad_if_needed(im, s)
        if rng.uniform() < self.p:
            im = _optical_distortion(im, rng)
        h, w = im.shape[:2]
        top = int(rng.integers(0, h - s + 1))
        left = int(rng.integers(0, w - s + 1))
        im = im[top:top + s, left:left + s]
        if rng.uniform() < self.p:
            im = np.ascontiguousarray(im[:, ::-1])
        if rng.uniform() < self.p:
            im = _clahe(im, rng)
        if rng.uniform() < self.p:
            im = _brightness_contrast(im, rng)
        if rng.uniform() < self.p:
            im = _hsv_jitter(im, rng)
        return im.astype(np.float32) / 255.0
