"""The port's LaMa masks (`data/masks.py`) and its stand-ins for cv2.line and
cv2.circle (`ops/cv.py`) against the JAX package's OpenCV versions.

  * `cv.circle` (filled) equals cv2.circle everywhere; `cv.line` equals
    cv2.line wherever the stroke's polygon stays inside the image, and
    elsewhere differs on at most 1% of the pixels, each within 1 px of an
    edge of OpenCV's mask (OpenCV clips such edges before drawing them);
  * every mask family, each under two seeds: the generator's state after
    the call equals the JAX package's (the draws, unused ones included, in
    its order), the mask within the same band (equal for the families that
    draw no stroke);
  * `MixedMaskGenerator` with the inpainting configs' kwargs and with every
    family at once (and inversion): 40 masks each, the same band, the same
    state;
  * the port's data modules import with no OpenCV installed.
"""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from resshift_tpu.data import masks as jm
from resshift_tpu_torch.data import masks as tm
from resshift_tpu_torch.ops import cv


def _near_edge(ref: np.ndarray) -> np.ndarray:
    """Pixels within 1 px (8-neighbourhood) of an edge of the 0/1 mask `ref`."""
    pad = np.pad(ref, 1, mode="edge")
    h, w = ref.shape
    shifts = [pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    edge = np.any([s != ref for s in shifts], axis=0)
    pe = np.pad(edge, 1)
    return np.any([pe[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] for dy in (-1, 0, 1)
                   for dx in (-1, 0, 1)], axis=0)


def _assert_band(got: np.ndarray, want: np.ndarray) -> None:
    got, want = np.squeeze(got), np.squeeze(want)
    diff = got != want
    assert diff.mean() <= 0.01, diff.mean()
    assert not (diff & ~_near_edge(want)).any()


@pytest.mark.parametrize("seed", range(4))
def test_line_and_circle_match_opencv(seed):
    rng = np.random.default_rng(seed)
    exact = 0
    for k in range(60):
        h, w = 96, 128
        inside = k % 2 == 0
        lo, hi = (0, 0) if inside else (-15, 15)
        sx, ex = (int(v) for v in rng.integers(lo, w + hi, 2))
        sy, ey = (int(v) for v in rng.integers(lo, h + hi, 2))
        t = int(rng.integers(2, 40))
        want, got = np.zeros((h, w), np.float32), np.zeros((h, w), np.float32)
        cv2.line(want, (sx, sy), (ex, ey), 1.0, t)
        cv.line(got, (sx, sy), (ex, ey), 1.0, t)
        r = t // 2
        if min(sx, sy, ex, ey) - r >= 0 and max(sx, ex) + r < w and max(sy, ey) + r < h:
            np.testing.assert_array_equal(got, want)
            exact += 1
        else:
            _assert_band(got, want)
        want[:], got[:] = 0, 0
        radius = int(rng.integers(0, 50))
        cv2.circle(want, (sx, sy), radius=radius, color=1.0, thickness=-1)
        cv.circle(got, (sx, sy), radius, 1.0)
        np.testing.assert_array_equal(got, want)
    assert exact > 0


FAMILIES = {
    "irregular line": (jm.irregular_mask, tm.irregular_mask,
                       dict(max_len=200, max_width=100, max_times=5, min_times=1)),
    "irregular circle": (jm.irregular_mask, tm.irregular_mask,
                         dict(draw_method="circle", max_times=6, min_times=2)),
    "irregular square": (jm.irregular_mask, tm.irregular_mask,
                         dict(draw_method="square", max_times=6, min_times=2)),
    "rectangle": (jm.rectangle_mask, tm.rectangle_mask, dict(bbox_max_size=150, max_times=4)),
    "superres": (jm.superres_mask, tm.superres_mask, {}),
    "outpainting": (jm.outpainting_mask, tm.outpainting_mask, dict(probs=(0.2, 0.2, 0.2, 0.2))),
    "expand centre": (jm.expand_mask, tm.expand_mask, {}),
    "expand drawn": (jm.expand_mask, tm.expand_mask, dict(center=False)),
    "half": (jm.half_mask, tm.half_mask, {}),
    "alterline": (jm.alterline_mask, tm.alterline_mask, {}),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_mask_family_matches_jax(name):
    jfn, tfn, kw = FAMILIES[name]
    for seed in (0, 1):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jfn(a, 256, 256, **kw)
        got = tfn(b, 256, 256, **kw)
        assert a.bit_generator.state == b.bit_generator.state
        assert got.dtype == np.float32 and got.shape == (256, 256)
        if "line" in name:
            _assert_band(got, want)
        else:
            np.testing.assert_array_equal(got, want)


MIXES = {
    "inpainting configs": dict(
        irregular_proba=1, irregular_kwargs=dict(max_angle=4, max_len=200, max_width=100,
                                                 max_times=5, min_times=1),
        box_proba=1, box_kwargs=dict(margin=10, bbox_min_size=30, bbox_max_size=150,
                                     max_times=4, min_times=1)),
    "every family": dict(irregular_proba=1, box_proba=1, squares_proba=1, superres_proba=1,
                         outpainting_proba=1, expand_proba=1, half_proba=1, alterline_proba=1,
                         invert_proba=0.3),
}


@pytest.mark.parametrize("name", sorted(MIXES))
def test_mixed_generator_matches_jax(name):
    jgen = jm.MixedMaskGenerator(np.random.default_rng(3), **MIXES[name])
    tgen = tm.MixedMaskGenerator(np.random.default_rng(3), **MIXES[name])
    for _ in range(40):
        want, got = jgen((256, 256)), tgen((256, 256))
        assert got.shape == (256, 256, 1) and got.dtype == np.float32
        _assert_band(got, want)
        assert jgen.rng.bit_generator.state == tgen.rng.bit_generator.state


def test_data_modules_import_without_opencv():
    code = ("import sys; sys.modules['cv2'] = None\n"
            "import resshift_tpu_torch.ops.cv, resshift_tpu_torch.data.masks\n"
            "import resshift_tpu_torch.data.distortions, resshift_tpu_torch.data.datasets\n"
            "import numpy as np\n"
            "from resshift_tpu_torch.data.distortions import LamaDistortions\n"
            "from resshift_tpu_torch.data.masks import MixedMaskGenerator\n"
            "rng = np.random.default_rng(0)\n"
            "out = LamaDistortions(64, p=1.0)(rng.uniform(0, 1, (80, 72, 3)), rng)\n"
            "m = MixedMaskGenerator(rng, irregular_proba=1, squares_proba=1)((64, 64))\n"
            "assert out.shape == (64, 64, 3) and m.shape == (64, 64, 1)\n"
            "assert 'cv2' not in {k for k, v in sys.modules.items() if v is not None}\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(Path(__file__).resolve().parent.parent))
