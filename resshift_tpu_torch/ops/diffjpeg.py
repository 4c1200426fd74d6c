"""JPEG compression round trip on NHWC RGB tensors in [0, 1] (the port's
own copy of the JAX package's `ops/diffjpeg.py`).

RGB -> YCbCr (the JPEG matrix), 2x2 mean chroma subsampling, 8x8 block
DCT as two products with the DCT matrix, quantisation by the standard luma
and chroma tables scaled by `quality_to_factor` and rounded (half to even,
as `jnp.round`), then the inverse chain; the image is zero-padded to a
multiple of 16 and cropped back.  `quality` is one value or one per sample.
`differentiable=True` rounds as round(x) + (x - round(x))^3, whose
gradient is not zero.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["diff_jpeg", "quality_to_factor"]

_Y_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32).T
_C_TABLE = np.full((8, 8), 99, dtype=np.float32)
_C_TABLE[:4, :4] = np.array(
    [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]).T
_RGB2YCC = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                     [0.5, -0.418688, -0.081312]], dtype=np.float32).T
_YCC_SHIFT = np.array([0.0, 128.0, 128.0], dtype=np.float32)
_YCC2RGB = np.array([[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136],
                     [1.0, 1.772, 0.0]], dtype=np.float32).T


@functools.lru_cache(maxsize=1)
def _dct_mat() -> np.ndarray:
    """C with the block DCT = C (X - 128) C^T."""
    c = np.zeros((8, 8), dtype=np.float64)
    for u in range(8):
        alpha = (1 / np.sqrt(2)) if u == 0 else 1.0
        for x in range(8):
            c[u, x] = alpha * np.cos((2 * x + 1) * u * np.pi / 16) * 0.5
    return c.astype(np.float32)


def quality_to_factor(quality: torch.Tensor) -> torch.Tensor:
    """JPEG quality in (0, 100] -> the quantisation tables' scale."""
    q = torch.as_tensor(quality, dtype=torch.float32)
    return torch.where(q < 50, 5000.0 / q, 200.0 - q * 2.0) / 100.0


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H/8 * W/8, 8, 8)."""
    b, h, w = x.shape
    return x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(b, -1, 8, 8)


def _merge(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = x.shape[0]
    return x.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, h, w)


def diff_jpeg(x: torch.Tensor, quality, differentiable: bool = False) -> torch.Tensor:
    """The JPEG round trip of x (B, H, W, 3) in [0, 1] at `quality` (a
    number or (B,)); returns (B, H, W, 3) in [0, 1]."""
    b, h, w, _ = x.shape
    dev = x.device
    t = lambda a: torch.as_tensor(a, device=dev)
    q = torch.as_tensor(quality, dtype=torch.float32, device=dev).expand(b)
    factor = quality_to_factor(q)[:, None, None, None]
    if differentiable:
        rnd = lambda v: torch.round(v) + (v - torch.round(v)) ** 3
    else:
        rnd = torch.round
    hp, wp = h + (-h) % 16, w + (-w) % 16
    xp = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    ycc = (xp * 255.0) @ t(_RGB2YCC) + t(_YCC_SHIFT)
    y = ycc[..., 0]
    cb = ycc[..., 1].reshape(b, hp // 2, 2, wp // 2, 2).mean(dim=(2, 4))
    cr = ycc[..., 2].reshape(b, hp // 2, 2, wp // 2, 2).mean(dim=(2, 4))
    c = t(_dct_mat())
    out = []
    for comp, table, (ch, cw) in ((y, _Y_TABLE, (hp, wp)), (cb, _C_TABLE, (hp // 2, wp // 2)),
                                  (cr, _C_TABLE, (hp // 2, wp // 2))):
        d = torch.einsum("ux,bnxy,vy->bnuv", c, _blocks(comp) - 128.0, c)
        scale = t(table)[None, None] * factor
        d = rnd(d / scale) * scale
        out.append(_merge(torch.einsum("ux,bnuv,vy->bnxy", c, d, c) + 128.0, ch, cw))
    y_r, cb_r, cr_r = out
    cb_r = cb_r.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    cr_r = cr_r.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    ycc_r = torch.stack([y_r, cb_r, cr_r], dim=-1)
    rgb = (ycc_r + t(np.array([-0.0, -128.0, -128.0], np.float32))) @ t(_YCC2RGB)
    return (rgb.clamp(0.0, 255.0) / 255.0)[:, :h, :w, :]
