"""The port's LaMa distortions (`data/distortions.py`) and its OpenCV
stand-ins (`ops/cv.py`) against OpenCV and the JAX package, on the CPU.

Each `ops/cv.py` function against the OpenCV call it replaces, with the
band measured here (OpenCV 5):
  * resize (INTER_LINEAR, uint8), warpPerspective (replicate), warpAffine
    (reflect), remap (reflect-101, float maps): within 1 level on >= 99.9%
    of the pixels (the remap equal);
  * getPerspectiveTransform within 1e-9, copyMakeBorder (reflect-101) and
    initUndistortRectifyMap (CV_32FC1) equal;
  * RGB -> HSV and HSV -> RGB equal on a sample of 2^20 colours;
  * RGB -> LAB: L equal, a and b within 1 level; LAB -> RGB within 1 level
    on >= 99.99%; CLAHE on one plane equal; the CLAHE step (LAB, CLAHE on
    L, back) within 2 levels on >= 99.99% of the pixels;
then each step of `LamaDistortions` and the whole chain against the JAX
package's: the generator's state after the call equal (the draws and coin
flips in the JAX package's order), the pixels within 2 levels on >= 99% (a
level apart after a warp grows through CLAHE's table, which maps a level
to several where the histogram is narrow).
"""

import math

import cv2
import numpy as np
import pytest

from resshift_tpu.data import distortions as jd
from resshift_tpu_torch.data import distortions as td
from resshift_tpu_torch.ops import cv
from resshift_tpu_torch.ops.resize import resize_np


def _field(rng, h, w, noise=0.05):
    f = resize_np(rng.uniform(0, 1, (h // 16, w // 16, 3)), (h, w), "bilinear")
    return np.clip(np.round((f + rng.normal(0, noise, (h, w, 3))) * 255), 0, 255).astype(np.uint8)


def _band(got, want, level, share):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert np.mean(d <= level) >= share, (np.mean(d <= level), d.max())


@pytest.fixture(scope="module")
def image():
    return _field(np.random.default_rng(0), 256, 256)


@pytest.mark.parametrize("wh", [(256, 384), (171, 256), (97, 65), (300, 200)])
def test_resize_linear(wh):
    im = _field(np.random.default_rng(1), 200, 300)
    _band(cv.resize_linear(im, wh), cv2.resize(im, wh, interpolation=cv2.INTER_LINEAR), 1, 0.999)


@pytest.mark.parametrize("seed", range(3))
def test_warps_and_remap(image, seed):
    rng = np.random.default_rng(seed)
    h, w = image.shape[:2]
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = src + np.stack([rng.normal(0, 0.05, 4) * w, rng.normal(0, 0.05, 4) * h],
                         1).astype(np.float32)
    m = cv2.getPerspectiveTransform(dst, src)
    np.testing.assert_allclose(cv.get_perspective_transform(dst, src), m, rtol=0, atol=1e-9)
    _band(cv.warp_perspective(image, m, (w, h)),
          cv2.warpPerspective(image, m, (w, h), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_REPLICATE), 1, 0.999)
    rot, (sx, sy) = math.radians(rng.uniform(-40, 40)), rng.uniform(0.7, 1.3, 2)
    a = np.array([[math.cos(rot), -math.sin(rot)], [math.sin(rot), math.cos(rot)]]) @ np.diag(
        [sx, sy])
    t = np.array([w / 2, h / 2]) - a @ np.array([w / 2, h / 2])
    m2 = np.concatenate([a, t[:, None]], 1).astype(np.float32)
    _band(cv.warp_affine(image, m2, (w, h)),
          cv2.warpAffine(image, m2, (w, h), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT), 1, 0.999)
    k = rng.uniform(-0.05, 0.05)
    cam = np.array([[w, 0, w * 0.5 + 7], [0, h, h * 0.5 - 5], [0, 0, 1]], np.float32)
    dist = np.array([k, k, 0, 0, 0], np.float32)
    want = cv2.initUndistortRectifyMap(cam, dist, None, None, (w, h), cv2.CV_32FC1)
    got = cv.init_undistort_rectify_map(cam, dist, (w, h))
    for g, m_ in zip(got, want):
        np.testing.assert_array_equal(g, m_)
    np.testing.assert_array_equal(
        cv.remap(image, *got), cv2.remap(image, *want, interpolation=cv2.INTER_LINEAR,
                                         borderMode=cv2.BORDER_REFLECT_101))
    part = image[:180, :200]
    np.testing.assert_array_equal(cv.copy_make_border_reflect101(part, 38, 38, 28, 28),
                                  cv2.copyMakeBorder(part, 38, 38, 28, 28,
                                                     cv2.BORDER_REFLECT_101))


@pytest.fixture(scope="module")
def colours():
    rng = np.random.default_rng(2)
    return rng.integers(0, 256, (1024, 1024, 3)).astype(np.uint8)


def test_hsv_equal(colours):
    np.testing.assert_array_equal(cv.rgb_to_hsv(colours), cv2.cvtColor(colours,
                                                                       cv2.COLOR_RGB2HSV))
    hsv = colours.copy()
    hsv[..., 0] %= 180
    np.testing.assert_array_equal(cv.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_lab_and_clahe(colours, image):
    lab, want = cv.rgb_to_lab(colours), cv2.cvtColor(colours, cv2.COLOR_RGB2LAB)
    np.testing.assert_array_equal(lab[..., 0], want[..., 0])
    _band(lab, want, 1, 1.0)
    _band(cv.lab_to_rgb(colours), cv2.cvtColor(colours, cv2.COLOR_LAB2RGB), 1, 0.9999)
    for clip in (1.0, 2.5, 4.0):
        plane = cv2.cvtColor(image, cv2.COLOR_RGB2LAB)[..., 0]
        c = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8))
        np.testing.assert_array_equal(cv.clahe(plane, clip), c.apply(plane))
        np.testing.assert_array_equal(cv.clahe(plane[:100, :150], clip),
                                      c.apply(plane[:100, :150]))
        want_lab = cv2.cvtColor(image, cv2.COLOR_RGB2LAB)
        want_lab[..., 0] = c.apply(want_lab[..., 0])
        got_lab = cv.rgb_to_lab(image)
        got_lab[..., 0] = cv.clahe(got_lab[..., 0], clip)
        _band(cv.lab_to_rgb(got_lab), cv2.cvtColor(want_lab, cv2.COLOR_LAB2RGB), 2, 0.9999)


STEPS = {"perspective": "_perspective", "affine": "_affine", "optical": "_optical_distortion",
         "clahe": "_clahe", "brightness": "_brightness_contrast", "hsv": "_hsv_jitter"}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_each_step_matches_jax(image, name):
    for seed in (0, 1):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        want = getattr(jd, STEPS[name])(image.copy(), a)
        got = getattr(td, STEPS[name])(image.copy(), b)
        assert a.bit_generator.state == b.bit_generator.state
        assert got.shape == want.shape and got.dtype == np.uint8
        _band(got, want, 1 if name != "clahe" else 2, 0.999)
    small = image[:200, :150]
    _band(td._smallest_max_size(small, 256), jd._smallest_max_size(small, 256), 1, 0.999)
    np.testing.assert_array_equal(td._pad_if_needed(small, 256), jd._pad_if_needed(small, 256))


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_lama_distortions_match_jax(p):
    rng = np.random.default_rng(5)
    for seed in range(4):
        im = _field(rng, *((300, 260) if seed % 2 else (240, 256))).astype(np.float32) / 255
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jd.LamaDistortions(256, p)(im, a)
        got = td.LamaDistortions(256, p)(im, b)
        assert a.bit_generator.state == b.bit_generator.state
        assert got.shape == (256, 256, 3) and got.dtype == np.float32
        _band(np.round(got * 255), np.round(want * 255), 2, 0.99)
