"""The port's JPEG round trip (`ops/jpeg.py`) against OpenCV's
`cv2.imencode(".jpg")` / `cv2.imdecode`, bit for bit.

  * every size (1x1 to 176x250, odd sides among them), on a smooth field
    and on noise, at qualities 1 to 100 (around the scaling's switch at 50);
  * both callers of the JAX package: `faces._jpeg_np` (the 8-bit image
    truncated from x * 255) and `bsrgan.add_jpeg_noise` (rounded, its
    quality drawn from the generator), against the JAX functions;
  * the SHA-256 digests that `chip_smoke.py` phase 19 holds the card's run
    to: OpenCV's here, and the port's.
"""

import hashlib
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from resshift_tpu.data import bsrgan as jbsrgan, faces as jfaces
from resshift_tpu_torch.data import bsrgan as tbsrgan, faces as tfaces
from resshift_tpu_torch.ops.jpeg import jpeg_roundtrip, quant_tables

SIZES = [(1, 1), (8, 8), (16, 16), (17, 31), (37, 53), (64, 64), (176, 250)]
QUALITIES = [1, 30, 49, 50, 60, 75, 95, 100]


def _image(h, w, kind, seed=0):
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([128 + 100 * np.sin(xx / 7 + c) * np.cos(yy / 5 - c) for c in range(3)], -1)
    return np.clip(f, 0, 255).astype(np.uint8)


def _cv2_roundtrip(rgb, quality):
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                           [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
    assert ok
    return np.ascontiguousarray(cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_roundtrip_equals_opencv(hw, kind, quality):
    im = _image(*hw, kind)
    np.testing.assert_array_equal(jpeg_roundtrip(im, quality), _cv2_roundtrip(im, quality))


def test_quality_scaling_and_clamps():
    luma, chroma = quant_tables(50)
    assert luma[0, 0] == 16 and chroma[0, 0] == 17  # the standard tables at 50
    assert (quant_tables(1)[0] == 255).sum() > 60  # 5000 %, clamped to baseline's 255
    assert (quant_tables(100)[0] == 1).all()
    assert all((a == b).all() for a, b in zip(quant_tables(0), quant_tables(1)))
    with pytest.raises(ValueError):
        jpeg_roundtrip(np.zeros((4, 4), np.uint8), 75)


@pytest.mark.parametrize("seed", range(4))
def test_faces_caller_truncates_as_jax(seed):
    rng = np.random.default_rng(seed)
    img = np.clip(rng.normal(0.5, 0.3, (37, 53, 3)), 0, 1).astype(np.float32)
    q = rng.uniform(30, 100)
    got, want = tfaces._jpeg_np(img, q), jfaces._jpeg_np(img, q)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_bsrgan_caller_rounds_as_jax(seed):
    img = np.clip(np.random.default_rng(seed).normal(0.5, 0.3, (40, 24, 3)), 0, 1)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    got, want = tbsrgan.add_jpeg_noise(r1, img), jbsrgan.add_jpeg_noise(r2, img)
    assert r1.bit_generator.state == r2.bit_generator.state
    np.testing.assert_array_equal(got, want)


def test_chip_smoke_digests_are_opencvs():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    probe = chip_smoke.jpeg_probe_image()
    assert probe.shape == (37, 53, 3)
    digest = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    want = {q: digest(_cv2_roundtrip(probe, q)) for q in (30, 60, 95)}
    assert chip_smoke.JPEG_DIGESTS == want
    assert {q: digest(jpeg_roundtrip(probe, q)) for q in want} == want
