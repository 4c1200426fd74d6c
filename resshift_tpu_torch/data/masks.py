"""LaMa-style inpainting masks on the host (the port's own copy of the JAX
package's `data/masks.py`): irregular brush strokes, rectangles,
super-resolution stripes, outpainting paddings, expand / half / alterline,
and the probability mixer.  Masks are (H, W, 1) float32 with 1 marking the
region to fill.  Every family draws from the `np.random.Generator` it is
given in the JAX package's order (draws whose values go unused included),
so that one seed gives the same masks; the strokes and discs are drawn by
`ops/cv.py` (OpenCV's thick line and filled circle, in numpy).
"""

from __future__ import annotations

import numpy as np

from ..ops import cv

__all__ = ["MixedMaskGenerator"]


def irregular_mask(rng, h, w, max_angle=4, max_len=60, max_width=20,
                   min_times=0, max_times=10, draw_method="line"):
    mask = np.zeros((h, w), np.float32)
    times = rng.integers(min_times, max_times + 1)
    for i in range(times):
        sx = int(rng.integers(w))
        sy = int(rng.integers(h))
        for _ in range(1 + int(rng.integers(5))):
            angle = 0.01 + rng.integers(max_angle)
            if i % 2 == 0:
                angle = 2 * 3.1415926 - angle
            length = 10 + int(rng.integers(max_len))
            brush_w = 5 + int(rng.integers(max_width))
            ex = int(np.clip(sx + length * np.sin(angle), 0, w))
            ey = int(np.clip(sy + length * np.cos(angle), 0, h))
            if draw_method == "line":
                cv.line(mask, (sx, sy), (ex, ey), 1.0, brush_w)
            elif draw_method == "circle":
                cv.circle(mask, (sx, sy), brush_w, 1.0)
            elif draw_method == "square":
                r = brush_w // 2
                mask[max(sy - r, 0):sy + r, max(sx - r, 0):sx + r] = 1
            sx, sy = ex, ey
    return mask


def rectangle_mask(rng, h, w, margin=10, bbox_min_size=30, bbox_max_size=100,
                   min_times=0, max_times=3):
    mask = np.zeros((h, w), np.float32)
    bbox_max_size = min(bbox_max_size, h - margin * 2, w - margin * 2)
    for _ in range(int(rng.integers(min_times, max_times + 1))):
        bw = int(rng.integers(bbox_min_size, bbox_max_size))
        bh = int(rng.integers(bbox_min_size, bbox_max_size))
        sx = int(rng.integers(margin, w - margin - bw + 1))
        sy = int(rng.integers(margin, h - margin - bh + 1))
        mask[sy:sy + bh, sx:sx + bw] = 1
    return mask


def superres_mask(rng, h, w, min_step=2, max_step=4, min_width=1, max_width=3):
    mask = np.zeros((h, w), np.float32)
    step_x = int(rng.integers(min_step, max_step + 1))
    width_x = int(rng.integers(min_width, min(step_x, max_width + 1)))
    off_x = int(rng.integers(0, step_x))
    step_y = int(rng.integers(min_step, max_step + 1))
    width_y = int(rng.integers(min_width, min(step_y, max_width + 1)))
    off_y = int(rng.integers(0, step_y))
    for dy in range(width_y):
        mask[off_y + dy::step_y] = 1
    for dx in range(width_x):
        mask[:, off_x + dx::step_x] = 1
    return mask


def outpainting_mask(rng, h, w, min_padding_percent=0.04, max_padding_percent=0.25,
                     probs=(0.5, 0.5, 0.5, 0.5)):
    mask = np.zeros((h, w), np.float32)

    def pad(size):
        n1 = int(min_padding_percent * size)
        n2 = int(max_padding_percent * size)
        return int(rng.integers(n1, max(n2, n1 + 1))) / size

    coords = [
        [(0, 0), (1, pad(h))],
        [(0, 0), (pad(w), 1)],
        [(0, 1 - pad(h)), (1, 1)],
        [(1 - pad(w), 0), (1, 1)],
    ]
    applied = False
    for pp, coord in zip(probs, coords):
        if rng.random() < pp:
            applied = True
            mask[int(coord[0][0] * h):int(coord[1][0] * h),
                 int(coord[0][1] * w):int(coord[1][1] * w)] = 1
    if not applied:
        idx = rng.choice(len(coords), p=np.asarray(probs) / np.sum(probs))
        coord = coords[idx]
        mask[int(coord[0][0] * h):int(coord[1][0] * h),
             int(coord[0][1] * w):int(coord[1][1] * w)] = 1
    return mask


def expand_mask(rng, h, w, masking_percent=0.25, center=True):
    if center:
        sh = int(h * masking_percent / 2)
        sw = int(w * masking_percent / 2)
    else:
        sh = int(h * rng.uniform(0.01, 1 - masking_percent))
        sw = int(w * rng.uniform(0.01, 1 - masking_percent))
    mask = np.ones((h, w), np.float32)
    mask[sh:sh + int(h * (1 - masking_percent)), sw:sw + int(w * (1 - masking_percent))] = 0
    return mask


def half_mask(rng, h, w, masking_percent=0.25):
    mask = np.zeros((h, w), np.float32)
    flag = rng.random()
    if flag < 0.25:
        mask[int(h * masking_percent):, :] = 1
    elif flag < 0.5:
        mask[:-int(h * masking_percent), :] = 1
    elif flag < 0.75:
        mask[:, int(w * masking_percent):] = 1
    else:
        mask[:, :-int(w * masking_percent)] = 1
    return mask


def alterline_mask(rng, h, w):
    mask = np.zeros((h, w), np.float32)
    if rng.random() > 0.5:
        mask[::2, :] = 1
    else:
        mask[:, ::2] = 1
    return mask


class MixedMaskGenerator:
    """Probability mixer over the mask families.

    kwargs mirror the reference's config surface: `<kind>_proba` +
    `<kind>_kwargs` for kind in irregular/box/squares/superres/outpainting/
    expand/half/alterline, plus invert_proba.
    """

    def __init__(self, rng: np.random.Generator | None = None, invert_proba=0.0, **kw):
        self.rng = rng or np.random.default_rng()
        self.invert_proba = invert_proba
        self._entries = []

        def add(name, fn, extra=None):
            p = kw.get(f"{name}_proba", 0.0)
            if p > 0:
                kwargs = dict(kw.get(f"{name}_kwargs") or {})
                if extra:
                    kwargs.update(extra)
                self._entries.append((p, fn, kwargs))

        add("irregular", irregular_mask, {"draw_method": "line"})
        add("box", rectangle_mask)
        add("squares", irregular_mask, {"draw_method": "square"})
        add("superres", superres_mask)
        add("outpainting", outpainting_mask)
        add("expand", expand_mask)
        add("half", half_mask)
        add("alterline", alterline_mask)
        if not self._entries:
            self._entries = [(1 / 3, irregular_mask, {"draw_method": "line"}),
                             (1 / 3, rectangle_mask, {})]
        self._probs = np.asarray([e[0] for e in self._entries], np.float64)
        self._probs /= self._probs.sum()

    def __call__(self, hw: tuple[int, int], iter_i: int | None = None) -> np.ndarray:
        h, w = hw
        idx = int(self.rng.choice(len(self._entries), p=self._probs))
        _, fn, kwargs = self._entries[idx]
        mask = fn(self.rng, h, w, **kwargs)
        if self.invert_proba > 0 and self.rng.random() < self.invert_proba:
            mask = 1 - mask
        return mask[..., None]
