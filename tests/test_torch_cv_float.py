"""`ops/cv.py`'s float32 paths against OpenCV 5 (`cv2.resize` with
INTER_LINEAR, INTER_CUBIC and INTER_AREA, `cv2.filter2D` with a 41x41
kernel, `cv2.cvtColor(..., COLOR_RGB2GRAY)`), on seeded images in [0, 1].

Bands (measured here; ROADMAP.md section 3):
  * INTER_AREA, filter2D, gray: equal bit for bit;
  * INTER_LINEAR: equal, except where OpenCV's kernel lerps as p0 * (1 -
    f) + p1 * f instead of its fused multiply-add (some border columns of a
    strong enlargement, and sources a few pixels wide): within 2^-23 (two
    ulp below 1) everywhere; equal on >= 99% of values where the source is
    at least 8 px wide (measured 99.39% at 4 -> 202 columns, 100% at every
    other shape here; 82% at 5 -> 8 columns);
  * INTER_CUBIC: OpenCV's float32 sums are not reproduced (the port sums in
    float64 and rounds once): within 4e-7 (measured 3.6e-7), which no 8-bit
    level sees.
"""

import cv2
import numpy as np
import pytest

from resshift_tpu_torch.data import degradations as deg
from resshift_tpu_torch.ops import cv

FLAGS = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC, "area": cv2.INTER_AREA}
# (H, W, h, w): shrinking at integer and fractional ratios, enlarging, mixed,
# the same size, the faces' 512 -> 512 // s -> 512 and the BSRGAN halving
SHAPES = [(64, 80, 31, 37), (512, 512, 256, 256), (512, 512, 200, 200), (90, 60, 30, 20),
          (256, 256, 64, 64), (50, 50, 100, 100), (37, 53, 64, 64), (100, 60, 512, 512),
          (94, 155, 108, 211), (64, 80, 100, 40), (33, 33, 33, 33), (39, 4, 76, 202),
          (7, 9, 3, 2), (1, 5, 3, 8)]
BAND = {"linear": (2.0 ** -23, 0.99), "cubic": (4e-7, 0.0), "area": (0.0, 1.0)}


@pytest.mark.parametrize("mode", sorted(FLAGS))
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_resize_float_matches_opencv(shape, mode):
    h_in, w_in, h, w = shape
    im = np.random.default_rng(h_in * 1000 + w).random((h_in, w_in, 3), dtype=np.float32)
    got = cv.resize_float(im, (w, h), mode)
    want = cv2.resize(im, (w, h), interpolation=FLAGS[mode])
    assert got.shape == want.shape and got.dtype == np.float32
    atol, share = BAND[mode]
    diff = np.abs(got - want)
    assert diff.max() <= atol, (mode, shape, diff.max())
    if w_in >= 8:
        assert (diff == 0).mean() >= share, (mode, shape, (diff == 0).mean())


def test_resize_float_two_dimensional_and_unknown_mode():
    im = np.random.default_rng(3).random((20, 30), dtype=np.float32)
    np.testing.assert_array_equal(cv.resize_float(im, (13, 9), "area"),
                                  cv2.resize(im, (13, 9), interpolation=cv2.INTER_AREA))
    with pytest.raises(ValueError, match="interpolation"):
        cv.resize_float(im, (13, 9), "lanczos")


@pytest.mark.parametrize("sigma", [0.3, 2.0, 9.0])
@pytest.mark.parametrize("hw", [(512, 512), (100, 77), (25, 30)])
def test_filter2d_matches_opencv(hw, sigma):
    rng = np.random.default_rng(int(sigma * 10) + hw[1])
    im = rng.random(hw + (3,), dtype=np.float32)
    k = deg.bivariate_gaussian(41, sigma, sigma * 0.6, 0.7, isotropic=False).astype(np.float32)
    np.testing.assert_array_equal(cv.filter2d(im, k), cv2.filter2D(im, -1, k))


def test_filter2d_is_a_correlation():
    im = np.random.default_rng(5).random((60, 50, 3), dtype=np.float32)
    k = np.zeros((41, 41), np.float32)
    k[3, 30] = 1.0  # one tap off the centre: a shift, not its mirror
    np.testing.assert_array_equal(cv.filter2d(im, k), cv2.filter2D(im, -1, k))


def test_rgb_to_gray_float_matches_opencv():
    im = np.random.default_rng(6).random((128, 96, 3), dtype=np.float32)
    np.testing.assert_array_equal(cv.rgb_to_gray_float(im), cv2.cvtColor(im, cv2.COLOR_RGB2GRAY))
