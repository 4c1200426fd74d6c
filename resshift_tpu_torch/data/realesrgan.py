"""The RealESRGAN two-stage degradation on the device (the port's own copy
of the JAX package's `data/realesrgan.py`).

blur with each sample's first kernel -> random resize -> Gaussian or
Poisson noise -> JPEG -> optionally a second order (blur, resize, noise) ->
{resize back + sinc, JPEG} in random order -> clamp and round to 8 bits ->
one paired random crop for the batch -> [-1, 1] with NaNs scrubbed -> the
training-pair queue.

Every branching draw (resize kind, scale and mode, noise family, the
second order's coins, the order of the last stage, the crop) comes from
the host's `np.random.Generator`, in the JAX package's order; per-sample
values (kernels, sigmas, gray flags, JPEG qualities) ride in as tensors.
The first resize scale keeps the JAX package's 1/16 grid (`_q`), which
shapes the data.  The noise draws come from a `torch.Generator` on the
device, or from `noise_draws(stage, gauss, img)`, which returns the noise
function's `noise=`/`gray_noise=` (Gaussian) or `counts=`/`gray_counts=`
(Poisson) for stage 0 (first order) or 1 (second): a test feeds JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ops.diffjpeg import diff_jpeg
from ..ops.filters import filter2d, usm_sharp
from ..ops.resize import resize
from .noise import add_gaussian_noise, add_poisson_noise

__all__ = ["DegradationConfig", "RealESRGANDegrader", "paired_random_crop"]

_SCALE_GRID = 16  # the first resize scale on a grid of 1/16
_MODES = ("area", "bilinear", "bicubic_torch")


@dataclasses.dataclass(frozen=True)
class DegradationConfig:
    """The `degradation` block of a task YAML."""

    sf: int = 4
    resize_prob: tuple = (0.2, 0.7, 0.1)
    resize_range: tuple = (0.15, 1.5)
    gaussian_noise_prob: float = 0.5
    noise_range: tuple = (1, 30)
    poisson_scale_range: tuple = (0.05, 3.0)
    gray_noise_prob: float = 0.4
    jpeg_range: tuple = (30, 95)
    second_order_prob: float = 0.5
    second_blur_prob: float = 0.8
    resize_prob2: tuple = (0.3, 0.4, 0.3)
    resize_range2: tuple = (0.3, 1.2)
    gaussian_noise_prob2: float = 0.5
    noise_range2: tuple = (1, 25)
    poisson_scale_range2: tuple = (0.05, 2.5)
    gray_noise_prob2: float = 0.4
    jpeg_range2: tuple = (30, 95)
    gt_size: int = 256
    resize_back: bool = False
    use_sharp: bool = False
    queue_size: int | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "DegradationConfig":
        """The keys this class has (lists as tuples); others are ignored."""
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()
                      if k in cls.__dataclass_fields__})


def _rand_updown(rng: np.random.Generator, probs, srange) -> float:
    kind = rng.choice(3, p=np.asarray(probs) / np.sum(probs))
    if kind == 0:  # up
        return rng.uniform(1, srange[1])
    if kind == 1:  # down
        return rng.uniform(srange[0], 1)
    return 1.0


def _q(s: float) -> float:
    return max(round(s * _SCALE_GRID), 1) / _SCALE_GRID


def paired_random_crop(rng: np.random.Generator, gt: torch.Tensor, lq: torch.Tensor,
                       gt_size: int, scale: int):
    """One crop offset for the whole batch, the GT's `scale` times the LQ's."""
    _, h_lq, w_lq, _ = lq.shape
    lq_size = gt_size // scale
    top = int(rng.integers(0, h_lq - lq_size + 1))
    left = int(rng.integers(0, w_lq - lq_size + 1))
    return (gt[:, top * scale:top * scale + gt_size, left * scale:left * scale + gt_size],
            lq[:, top:top + lq_size, left:left + lq_size])


NoiseDraws = Callable[[int, bool, torch.Tensor], dict]


class RealESRGANDegrader:
    """Batch degrader with the training-pair queue."""

    def __init__(self, cfg: DegradationConfig | dict):
        self.cfg = DegradationConfig.from_dict(cfg) if isinstance(cfg, dict) else cfg
        self._queue: dict[str, np.ndarray] | None = None
        self._queue_ptr = 0

    def _noise(self, stage, img, rng, generator, gauss_prob, noise_range, poisson_range,
               gray_prob, noise_draws):
        b = img.shape[0]
        dev = img.device
        gauss = rng.uniform() < gauss_prob
        amount = rng.uniform(*(noise_range if gauss else poisson_range), size=b)
        amount = torch.as_tensor(amount, dtype=torch.float32, device=dev)
        gray = torch.as_tensor(rng.uniform(size=b) < gray_prob, dtype=torch.float32, device=dev)
        draws = {} if noise_draws is None else noise_draws(stage, gauss, img)
        fn = add_gaussian_noise if gauss else add_poisson_noise
        return fn(img, amount, gray, generator, **draws)

    def __call__(self, rng: np.random.Generator, generator: torch.Generator | None,
                 batch: dict, *, noise_draws: NoiseDraws | None = None) -> dict:
        """batch: {'gt': (B, H, W, 3) in [0, 1], 'kernel1', 'kernel2',
        'sinc_kernel': (B, k, k)}, tensors on the device (or arrays) ->
        {'gt', 'lq'} numpy arrays in [-1, 1]."""
        cfg = self.cfg
        dev = generator.device if generator is not None else torch.device("cpu")
        on = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        gt = on(batch["gt"])
        b, ori_h, ori_w, _ = gt.shape
        sf = cfg.sf
        if cfg.use_sharp:
            gt = usm_sharp(gt)

        # first order
        out = filter2d(gt, on(batch["kernel1"]))
        s1 = _q(_rand_updown(rng, cfg.resize_prob, cfg.resize_range))
        mode1 = _MODES[rng.integers(3)]
        if s1 != 1.0:
            out = resize(out, (int(ori_h * s1), int(ori_w * s1)), mode1)
        out = self._noise(0, out, rng, generator, cfg.gaussian_noise_prob, cfg.noise_range,
                          cfg.poisson_scale_range, cfg.gray_noise_prob, noise_draws)
        q1 = on(rng.uniform(*cfg.jpeg_range, size=b))
        out = diff_jpeg(out.clamp(0.0, 1.0), q1)

        # second order
        if rng.uniform() < cfg.second_order_prob:
            if rng.uniform() < cfg.second_blur_prob:
                out = filter2d(out, on(batch["kernel2"]))
            s2 = _rand_updown(rng, cfg.resize_prob2, cfg.resize_range2)
            mode2 = _MODES[rng.integers(3)]
            out = resize(out, (max(int(ori_h / sf * s2), 8), max(int(ori_w / sf * s2), 8)), mode2)
            out = self._noise(1, out, rng, generator, cfg.gaussian_noise_prob2,
                              cfg.noise_range2, cfg.poisson_scale_range2,
                              cfg.gray_noise_prob2, noise_draws)

        # resize back + sinc and JPEG, in random order
        sinc = on(batch["sinc_kernel"])
        mode3 = _MODES[rng.integers(3)]
        q2 = on(rng.uniform(*cfg.jpeg_range2, size=b))
        if rng.uniform() < 0.5:
            out = filter2d(resize(out, (ori_h // sf, ori_w // sf), mode3), sinc)
            out = diff_jpeg(out.clamp(0.0, 1.0), q2)
        else:
            out = diff_jpeg(out.clamp(0.0, 1.0), q2)
            out = filter2d(resize(out, (ori_h // sf, ori_w // sf), mode3), sinc)
        if cfg.resize_back:
            out = resize(out, (ori_h, ori_w), "bicubic_torch")
        lq = torch.round(out.clamp(0, 1) * 255.0).clamp(0, 255) / 255.0

        gt_c, lq_c = paired_random_crop(rng, gt, lq, cfg.gt_size, 1 if cfg.resize_back else sf)
        lq_c = torch.nan_to_num((lq_c - 0.5) / 0.5)
        gt_c = torch.nan_to_num((gt_c - 0.5) / 0.5)
        return self._queue_swap(rng, {"gt": gt_c.cpu().numpy(), "lq": lq_c.cpu().numpy()})

    def _queue_swap(self, rng: np.random.Generator, batch: dict) -> dict:
        """The pool of `queue_size` (default 10 x batch) training pairs: filled
        first; once full, shuffled, its first batch handed out and replaced
        by the incoming one."""
        b = batch["lq"].shape[0]
        qsize = self.cfg.queue_size or b * 10
        if qsize <= 0:
            return batch
        if qsize % b:
            raise ValueError(f"queue_size {qsize} is not a multiple of the batch {b}")
        if self._queue is None:
            self._queue = {k: np.zeros((qsize,) + v.shape[1:], v.dtype) for k, v in batch.items()}
            self._queue_ptr = 0
        if self._queue_ptr == qsize:
            idx = rng.permutation(qsize)
            for k in self._queue:
                self._queue[k] = self._queue[k][idx]
            out = {k: self._queue[k][:b].copy() for k in self._queue}
            for k in self._queue:
                self._queue[k][:b] = batch[k]
            return out
        for k in self._queue:
            self._queue[k][self._queue_ptr:self._queue_ptr + b] = batch[k]
        self._queue_ptr += b
        return batch
