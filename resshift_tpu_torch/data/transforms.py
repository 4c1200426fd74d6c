"""Transform registry: numpy HWC callables (the port's own copy of the JAX
package's `data/transforms.py`).

API parity with the reference's `get_transforms`
(datapipe/datasets.py:50-121), re-expressed as pure numpy functions over
HWC float images (the framework's interchange format — NHWC goes to the
device, so there is no ToTensor/CHW step).  Each transform maps an HWC
image in [0,1] (uint8 accepted for lama_distortions, like the reference)
to a float32 HWC array, normalized where the reference normalizes.

Types: default, bicubic_norm, bicubic_back_norm, resize_ccrop_norm,
rcrop_aug_norm, aug_norm, lama_distortions, rgb2gray.
"""

from __future__ import annotations

import numpy as np

from ..ops.resize import imresize_matlab, resize_np

__all__ = ["get_transforms"]


def _normalize(im: np.ndarray, mean, std) -> np.ndarray:
    im = np.asarray(im, np.float32)
    if im.ndim == 2:
        im = im[..., None]
    return (im - np.float32(mean)) / np.float32(std)


def _spatial_aug(im, rng, only_hflip=False, only_vflip=False, only_hvflip=False):
    """Reference util_image.SpatialAug: one of the 8 dihedral ops, with the
    restriction flags used by the face configs."""
    if only_hflip:
        return np.ascontiguousarray(im[:, ::-1]) if rng.uniform() < 0.5 else im
    if only_vflip:
        return np.ascontiguousarray(im[::-1]) if rng.uniform() < 0.5 else im
    if only_hvflip:
        c = int(rng.integers(3))
        if c == 1:
            return np.ascontiguousarray(im[:, ::-1])
        if c == 2:
            return np.ascontiguousarray(im[::-1])
        return im
    flag = int(rng.integers(8))
    if flag % 4:
        im = np.rot90(im, flag % 4)
    if flag >= 4:
        im = np.flipud(im)
    return np.ascontiguousarray(im)


def _center_crop(im, size):
    h, w = im.shape[:2]
    th, tw = (size, size) if isinstance(size, int) else size
    top, left = max((h - th) // 2, 0), max((w - tw) // 2, 0)
    return im[top:top + th, left:left + tw]


def _resize_short(im, size):
    """torchvision Resize(int): scale so the SHORT edge == size."""
    h, w = im.shape[:2]
    s = size / min(h, w)
    return resize_np(im, (round(h * s), round(w * s)), "bicubic_torch")


def get_transforms(transform_type: str, kwargs: dict | None = None):
    """Returns fn(im_hwc [, rng]) -> float32 HWC."""
    kw = dict(kwargs or {})
    mean = kw.get("mean", 0.5)
    std = kw.get("std", 0.5)

    def _rng(rng):
        return rng if rng is not None else np.random.default_rng()

    if transform_type == "default":
        return lambda im, rng=None: _normalize(im, mean, std)

    if transform_type == "bicubic_norm":
        scale, out_shape = kw.get("scale"), kw.get("out_shape")
        mn, mx = kw.get("min_max", (0.0, 1.0))

        def f(im, rng=None):
            if out_shape is not None:
                im = resize_np(im, tuple(out_shape), "bicubic_matlab")
            else:
                im = imresize_matlab(im, scale)
            return _normalize(np.clip(im, mn, mx), mean, std)

        return f

    if transform_type == "bicubic_back_norm":
        scale = kw.get("scale")
        mn, mx = kw.get("min_max", (0.0, 1.0))

        def f(im, rng=None):
            im = imresize_matlab(im, scale=scale)
            im = imresize_matlab(im, scale=1.0 / scale)
            return _normalize(np.clip(im, mn, mx), mean, std)

        return f

    if transform_type == "resize_ccrop_norm":
        size = kw.get("size")

        def f(im, rng=None):
            return _normalize(_center_crop(_resize_short(im, size), size), mean, std)

        return f

    if transform_type == "rcrop_aug_norm":
        pch = kw.get("pch_size", 256)

        def f(im, rng=None):
            rng = _rng(rng)
            h, w = im.shape[:2]
            top = int(rng.integers(0, max(h - pch, 0) + 1))
            left = int(rng.integers(0, max(w - pch, 0) + 1))
            im = im[top:top + pch, left:left + pch]
            im = _spatial_aug(im, rng, kw.get("only_hflip", False),
                              kw.get("only_vflip", False),
                              kw.get("only_hvflip", False))
            mv = kw.get("max_value")
            if mv:
                im = np.asarray(im, np.float32) / mv
            return _normalize(im, mean, std)

        return f

    if transform_type == "aug_norm":
        def f(im, rng=None):
            im = _spatial_aug(im, _rng(rng), kw.get("only_hflip", False),
                              kw.get("only_vflip", False),
                              kw.get("only_hvflip", False))
            return _normalize(im, mean, std)

        return f

    if transform_type == "lama_distortions":
        from .distortions import LamaDistortions

        tr = LamaDistortions(pch_size=kw.get("pch_size", 256))
        # reference composes LamaDistortionTransform + ToTensor(max_value=1)
        # (no mean/std normalization at this stage)
        return lambda im, rng=None: tr(im, _rng(rng)).astype(np.float32)

    if transform_type == "rgb2gray":
        nc = kw.get("num_output_channels", 3)

        def f(im, rng=None):
            im = np.asarray(im, np.float32)
            if im.ndim == 2:
                g = im
            else:
                # ITU-R 601 luma, matching torchvision Grayscale
                g = 0.299 * im[..., 0] + 0.587 * im[..., 1] + 0.114 * im[..., 2]
            g = np.repeat(g[..., None], nc, axis=-1)
            return _normalize(g, mean, std)

        return f

    raise ValueError(f"unexpected transform type: {transform_type}")
