"""A direct SAME 3x3 convolution, NHWC input, HWIO weight, no bias: the
probe that asks whether a hand-written conv can match the library's.

Probe P1 `conv3x3` replaces the TPU probe
`tools/profile_conv_pallas.py::conv3x3_pallas` (P1) in two routes, picked by
dtype (`conv_route`): bf16 on the tensor cores (csrc/conv3x3_tc.cu, counter
CONV3X3_TC, 128 output pixels a CTA, variants "vec" for 16-byte copies where
C and Co are multiples of 8 and "elem" otherwise), f32 on the FMA kernel
(csrc/conv3x3.cu, counter CONV3X3, 64 output pixels a CTA).
`tools/profile_conv.py` reaches it, against `F.conv2d`.  The wrapper runs
the plain PyTorch version for a CPU tensor, launches its dtype's kernel for
a CUDA tensor, and raises for anything else.  The taps sum in f32 and the
output rounds to the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _ext
from .._ext import I, P

__all__ = ["conv3x3_plain", "conv_route", "conv3x3", "CONV3X3", "CONV3X3_TC"]

CONV3X3 = _ext.Kernel("conv3x3", [P] * 3 + [I] * 7)  # f32, FMA
CONV3X3_TC = _ext.Kernel("conv3x3_tc", [P] * 3 + [I] * 7)  # bf16, tensor cores

# output pixels per CTA, rows x (pixels / rows), of each route
# (csrc/conv3x3.cu, csrc/conv3x3_tc.cu)
_PIX = {"fma": 64, "tc": 128}


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


def _default_rows(wd: int, pix: int) -> int:
    """Rows per CTA that fill its `pix` pixels with whole rows where W < pix."""
    cols = pix
    while cols > 1 and cols // 2 >= wd:
        cols //= 2
    return pix // cols


def conv_route(dtype: torch.dtype, x_shape, co: int, rows: int | None = None) -> str:
    """Which route of probe P1 takes NHWC input of `x_shape` to `co`
    channels with `rows` output rows per CTA (None: whole rows): "tc" (bf16,
    `conv3x3_tc`, `rows` a divisor of 128) or "fma" (f32, `conv3x3`, `rows`
    a divisor of 64).  Both take any C and Co; the tensor-core kernel's
    entry raises at launch for a grid of 2^31 CTAs or more.  Raises
    TypeError for other dtypes and ValueError for shapes neither route
    takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3 takes float32 or bfloat16, not {dtype}")
    if len(x_shape) != 4:
        raise ValueError(f"conv3x3 takes NHWC input, not {tuple(x_shape)}")
    route = "tc" if dtype == torch.bfloat16 else "fma"
    pix = _PIX[route]
    bsz, h, wd, c = x_shape
    rows = _default_rows(wd, pix) if rows is None else rows
    ok = min(bsz, h, wd, c, co) > 0 and 0 < rows <= pix and pix % rows == 0
    if ok and route == "fma":
        ok = bsz <= 65535  # the FMA kernel's grid: images on z
    if not ok:
        raise ValueError(f"conv3x3: no {dtype} route for x={tuple(x_shape)} -> {co} with "
                         f"rows={rows} (rows must divide {pix})")
    return route


def _kernel(x, w, rows) -> torch.Tensor:
    co = w.shape[-1]
    route = conv_route(x.dtype, tuple(x.shape), co, rows)
    bsz, h, wd, c = x.shape
    if w.shape != (3, 3, c, co):
        raise ValueError(f"conv3x3: unsupported shapes x={tuple(x.shape)} w={tuple(w.shape)}")
    rows = _default_rows(wd, _PIX[route]) if rows is None else rows
    dt = x.dtype
    x = x.contiguous()
    wt = w.to(dt).contiguous()
    y = torch.empty(bsz, h, wd, co, dtype=dt, device=x.device)
    if route == "tc":
        vec = c % 8 == 0 and co % 8 == 0  # 16-byte cp.async of x and the taps
        if vec:
            x, wt = _ext.aligned16(x), _ext.aligned16(wt)
        CONV3X3_TC(x.data_ptr(), wt.data_ptr(), y.data_ptr(), bsz, h, wd, c, co, rows, int(vec),
                   device=x.device, variant="vec" if vec else "elem")
    else:
        CONV3X3(x.data_ptr(), wt.data_ptr(), y.data_ptr(), _ext.dtype_code(dt), bsz, h, wd, c,
                co, rows, device=x.device)
    return y


def conv3x3(x: torch.Tensor, w: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """SAME 3x3 conv, no bias.  x: (B, H, W, C) f32 or bf16; w: (3, 3, C,
    Co) (cast to x's dtype).  `rows`: output rows per CTA of the kernel, a
    divisor of its pixels per CTA, 128 in bf16 and 64 in f32 (default: whole
    rows).  On a CUDA tensor bf16 launches the tensor-core kernel and f32 the
    FMA one (`conv_route`)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return _kernel(x, w, rows)
