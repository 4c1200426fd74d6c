"""BSRGAN degradations on the host (the port's own copy of the JAX package's
`data/bsrgan.py`), in numpy and scipy without OpenCV: the `bsrgan` and
`bsrganimagenet` dataset types' chains.

  * `degradation_bsrgan_light`: a shuffled chain of blur, two downsample
    stages (the second kept last), Gaussian noise and JPEG, with an
    optional 2x pre-downsample at sf 4 and a final JPEG;
  * `degradation_bsrgan`: the full chain: two blur slots, the second
    downsample at probability 0.75, noise levels (2, 8), a minimum input
    size and a paired random crop of the LQ to `lq_patchsize`;
  * helpers: anisotropic and fspecial Gaussian kernels, the shifted
    nearest downsample, colour / gray / channel-correlated Gaussian noise,
    the JPEG round trip (rounded to 8 bits).

All randomness comes from an explicit `np.random.Generator`, in the JAX
package's order.  OpenCV's float resizes and JPEG round trip are
`ops/cv.py`'s and `ops/jpeg.py`'s; `use_sharp` is `ops/filters.usm_sharp`
on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage
from scipy.linalg import orth

from ..ops import cv
from ..ops.jpeg import jpeg_roundtrip
from ..ops.resize import imresize_matlab

__all__ = ["degradation_bsrgan_light", "degradation_bsrgan", "add_blur",
           "add_gaussian_noise_bsr", "add_jpeg_noise"]

_INTERP = ["linear", "cubic", "area"]  # OpenCV's INTER_LINEAR / CUBIC / AREA, choices 1/2/3


def _fspecial_gaussian(hsize: int, sigma: float) -> np.ndarray:
    siz = (hsize - 1) / 2.0
    x, y = np.meshgrid(np.arange(-siz, siz + 1), np.arange(-siz, siz + 1))
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(float).eps * h.max()] = 0
    return h / h.sum() if h.sum() != 0 else h


def _anisotropic_gaussian(ksize: int, theta: float, l1: float, l2: float) -> np.ndarray:
    v = np.dot(np.array([[np.cos(theta), -np.sin(theta)],
                         [np.sin(theta), np.cos(theta)]]), np.array([1.0, 0.0]))
    V = np.array([[v[0], v[1]], [v[1], -v[0]]])
    D = np.array([[l1, 0], [0, l2]])
    sigma = V @ D @ np.linalg.inv(V)
    c = ksize // 2
    xx, yy = np.meshgrid(np.arange(ksize) - c, np.arange(ksize) - c)
    grid = np.stack([xx, yy], -1)
    inv = np.linalg.inv(sigma)
    k = np.exp(-0.5 * np.einsum("...i,ij,...j->...", grid, inv, grid))
    return k / k.sum()


def _shift_pixel(x: np.ndarray, sf: int) -> np.ndarray:
    """Bilinear shift by (sf - 1) / 2 toward the upper left."""
    h, w = x.shape[:2]
    shift = (sf - 1) * 0.5
    xs = np.clip(np.arange(w) + shift, 0, w - 1)
    ys = np.clip(np.arange(h) + shift, 0, h - 1)
    x0 = np.floor(xs).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y0 = np.floor(ys).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    wx = (xs - x0)[None, :]
    wy = (ys - y0)[:, None]
    if x.ndim == 2:
        x = x[:, :, None]
    a = x[y0][:, x0] * (1 - wx[..., None]) + x[y0][:, x1] * wx[..., None]
    b = x[y1][:, x0] * (1 - wx[..., None]) + x[y1][:, x1] * wx[..., None]
    out = a * (1 - wy[..., None]) + b * wy[..., None]
    return out.squeeze()


def add_blur(rng: np.random.Generator, img: np.ndarray, sf: int = 4) -> np.ndarray:
    wd2 = (4.0 + sf) / 4
    wd = (2.0 + 0.2 * sf) / 4
    if rng.random() < 0.5:
        k = _anisotropic_gaussian(int(rng.integers(2, 12)) + 3,
                                  rng.random() * np.pi,
                                  wd2 * rng.random(), wd2 * rng.random())
    else:
        k = _fspecial_gaussian(int(rng.integers(2, 5)) + 3, wd * rng.random())
    return ndimage.convolve(img, k[:, :, None], mode="mirror")


def add_gaussian_noise_bsr(rng: np.random.Generator, img: np.ndarray,
                           noise_level1: int = 2, noise_level2: int = 25) -> np.ndarray:
    level = int(rng.integers(noise_level1, noise_level2 + 1))
    rnum = rng.random()
    if rnum > 0.6:    # colour noise
        img = img + rng.normal(0, level / 255.0, img.shape).astype(np.float32)
    elif rnum < 0.4:  # gray noise
        img = img + rng.normal(0, level / 255.0, (*img.shape[:2], 1)).astype(np.float32)
    else:             # channel-correlated noise
        L = noise_level2 / 255.0
        D = np.diag(rng.random(3))
        U = orth(rng.random((3, 3)))
        conv = U.T @ D @ U
        img = img + rng.multivariate_normal(
            [0, 0, 0], np.abs(L**2 * conv), img.shape[:2]).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(rng: np.random.Generator, img: np.ndarray,
                   q_lo: int = 80, q_hi: int = 95) -> np.ndarray:
    """JPEG round trip at a quality drawn from [q_lo, q_hi], the 8-bit image
    rounded from x * 255."""
    qf = int(rng.integers(q_lo, q_hi + 1))
    im8 = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
    return jpeg_roundtrip(im8, qf).astype(np.float32) / 255.0


def _usm_sharp_np(image: np.ndarray) -> np.ndarray:
    import torch

    from ..ops.filters import usm_sharp

    with torch.no_grad():
        return usm_sharp(torch.from_numpy(np.ascontiguousarray(image[None]))).numpy()[0]


def _bsrgan_chain(rng: np.random.Generator, image: np.ndarray, sf: int,
                  use_sharp: bool, *, second_blur: bool, down2_prob: float,
                  noise_levels: tuple[int, int]):
    """The shuffled chain that the light and full variants share; they
    differ only in the knobs."""
    jpeg_prob, scale2_prob = 0.9, 0.25
    h1, w1 = image.shape[:2]
    image = image.copy()[:w1 - w1 % sf, :h1 - h1 % sf, ...]  # the JAX package's crop

    if use_sharp:
        image = _usm_sharp_np(image)

    hq = image.copy()
    sf_run = sf
    if sf == 4 and rng.random() < scale2_prob:
        if rng.random() < 0.5:
            interp = _INTERP[int(rng.integers(3))]
            image = cv.resize_float(image, (image.shape[1] // 2, image.shape[0] // 2), interp)
        else:
            image = imresize_matlab(image, 0.5)
        image = np.clip(image, 0.0, 1.0)
        sf_run = 2

    order = list(rng.permutation(7))
    i1, i2 = order.index(2), order.index(3)
    if i1 > i2:  # keep downsample3 last
        order[i1], order[i2] = order[i2], order[i1]

    a, b = image.shape[1], image.shape[0]
    for i in order:
        if i == 0:
            image = add_blur(rng, image, sf=sf_run)
        elif i == 1 and second_blur:  # the full chain only
            image = add_blur(rng, image, sf=sf_run)
        elif i == 2:
            a, b = image.shape[1], image.shape[0]
            if rng.random() < down2_prob:
                sf1 = rng.uniform(1, 2 * sf_run)
                interp = _INTERP[int(rng.integers(3))]
                image = cv.resize_float(image, (int(image.shape[1] / sf1),
                                                int(image.shape[0] / sf1)), interp)
            else:
                k = _fspecial_gaussian(25, rng.uniform(0.1, 0.6 * sf_run))
                ks = _shift_pixel(k, sf_run)
                ks = ks / ks.sum()
                image = ndimage.convolve(image, ks[:, :, None], mode="mirror")
                image = image[0::sf_run, 0::sf_run, ...]
            image = np.clip(image, 0.0, 1.0)
        elif i == 3:
            interp = _INTERP[int(rng.integers(3))]
            image = cv.resize_float(image, (int(a / sf_run), int(b / sf_run)), interp)
            image = np.clip(image, 0.0, 1.0)
        elif i == 4:
            image = add_gaussian_noise_bsr(rng, image, *noise_levels)
        elif i == 5:
            if rng.random() < jpeg_prob:
                image = add_jpeg_noise(rng, image)
        # i == 6: the camera-ISP slot, a no-op as in the JAX package

    image = add_jpeg_noise(rng, image)
    return image.astype(np.float32), hq.astype(np.float32)


def degradation_bsrgan_light(rng: np.random.Generator, image: np.ndarray,
                             sf: int = 4, use_sharp: bool = False):
    """The light chain.  Returns (lq, hq): lq at 1/sf resolution, RGB [0, 1]."""
    return _bsrgan_chain(rng, image, sf, use_sharp, second_blur=False,
                         down2_prob=0.8, noise_levels=(1, 2))


def degradation_bsrgan(rng: np.random.Generator, image: np.ndarray,
                       sf: int = 4, lq_patchsize: int = 72,
                       use_sharp: bool = False):
    """The full chain, then a paired random crop: lq to `lq_patchsize`, hq
    to lq_patchsize * sf.  Returns (lq, hq), RGB [0, 1]."""
    h, w = image.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(
            f"img size ({h}x{w}) is too small for lq_patchsize={lq_patchsize} at sf={sf}")
    lq, hq = _bsrgan_chain(rng, image, sf, use_sharp, second_blur=True,
                           down2_prob=0.75, noise_levels=(2, 8))
    lh, lw = lq.shape[:2]
    top = int(rng.integers(0, lh - lq_patchsize + 1))
    left = int(rng.integers(0, lw - lq_patchsize + 1))
    lq = lq[top:top + lq_patchsize, left:left + lq_patchsize, :]
    hq = hq[top * sf:(top + lq_patchsize) * sf,
            left * sf:(left + lq_patchsize) * sf, :]
    return lq, hq
