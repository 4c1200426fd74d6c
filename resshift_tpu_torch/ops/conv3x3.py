"""A direct SAME 3x3 convolution, NHWC input, HWIO weight, no bias: the
probe that asks whether a hand-written conv can match the library's.

Probe P1 `conv3x3` (csrc/conv3x3.cu) replaces the TPU probe
`tools/profile_conv_pallas.py::conv3x3_pallas` (P1); `tools/profile_conv.py`
reaches it, against `F.conv2d`.  The wrapper runs the plain PyTorch version
for a CPU tensor, launches the kernel for a CUDA tensor, and raises for
anything else.  The taps sum in f32 and the output rounds to the input
dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _ext
from .._ext import I, P

__all__ = ["conv3x3_plain", "conv3x3", "CONV3X3"]

CONV3X3 = _ext.Kernel("conv3x3", [P] * 3 + [I] * 7)

_PIX = 64  # output pixels per CTA (csrc/conv3x3.cu): rows x (64 / rows)


def _shift_w(x: torch.Tensor, dx: int) -> torch.Tensor:
    """(B, R, W, C) shifted along W by dx with a zero edge: dx = 1 puts
    x[w - 1] at w, dx = -1 puts x[w + 1] at w."""
    z = torch.zeros_like(x[:, :, :1])
    if dx == -1:
        return torch.cat([x[:, :, 1:], z], dim=2)
    return torch.cat([z, x[:, :, :-1]], dim=2)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The TPU probe's dy-decomposed im2col: for each kernel row dy, the
    input rows shifted by dy, their W-axis neighbours concatenated to depth
    3C, times the (3C, Co) slab of that row; the three products summed in
    f32.  x: (B, H, W, C); w: (3, 3, C, Co).  Returns (B, H, W, Co) in x's
    dtype."""
    bsz, h, wd, c = x.shape
    co = w.shape[-1]
    dt = x.dtype
    # per-dy matrices (3C, Co): HWIO flattened orders the rows dx = 0, 1, 2,
    # as the concatenation [x[w - 1], x, x[w + 1]] below
    wm = w.to(dt).reshape(3, 3 * c, co).float()
    xp = F.pad(x, (0, 0, 0, 0, 1, 1))  # zero rows above and below
    acc = None
    for dy in range(3):
        xr = xp[:, dy:dy + h]
        m = torch.cat([_shift_w(xr, 1), xr, _shift_w(xr, -1)], dim=-1)
        part = m.reshape(-1, 3 * c).float() @ wm[dy]
        acc = part if acc is None else acc + part
    return acc.reshape(bsz, h, wd, co).to(dt)


def _default_rows(wd: int) -> int:
    """Rows per CTA that fill its 64 pixels with whole rows where W < 64."""
    cols = _PIX
    while cols > 1 and cols // 2 >= wd:
        cols //= 2
    return _PIX // cols


def _kernel(x, w, rows) -> torch.Tensor:
    if x.dim() != 4:
        raise ValueError(f"conv3x3 takes NHWC input, not {tuple(x.shape)}")
    bsz, h, wd, c = x.shape
    co = w.shape[-1]
    rows = _default_rows(wd) if rows is None else rows
    if w.shape != (3, 3, c, co) or rows <= 0 or _PIX % rows or bsz > 65535:
        raise ValueError(f"conv3x3: unsupported shapes x={tuple(x.shape)} w={tuple(w.shape)} "
                         f"rows={rows} (rows must divide {_PIX})")
    dt = x.dtype
    code = _ext.dtype_code(dt)  # f32 or bf16, else raises
    x = x.contiguous()
    wt = w.to(dt).contiguous()
    y = torch.empty(bsz, h, wd, co, dtype=dt, device=x.device)
    CONV3X3(x.data_ptr(), wt.data_ptr(), y.data_ptr(), code, bsz, h, wd, c, co, rows)
    return y


def conv3x3(x: torch.Tensor, w: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """SAME 3x3 conv, no bias.  x: (B, H, W, C) f32 or bf16; w: (3, 3, C,
    Co) (cast to x's dtype).  `rows`: output rows per CTA of the kernel, a
    divisor of 64 (default: whole rows of at most 64 pixels)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return _kernel(x, w, rows)
