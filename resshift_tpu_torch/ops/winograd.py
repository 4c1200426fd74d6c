"""Winograd F(2x2, 3x3) convolution: a SAME, stride-1 3x3 conv on NHWC
input with an HWIO weight, through 16 channel contractions against the
transformed kernel U = G g G^T (Lavin and Gray, arXiv:1509.09308).

Kernel K10 `winograd_conv3x3` replaces the TPU kernel
`winograd.winograd_conv3x3` (K10) in two routes, picked by dtype
(`conv_route`): bf16 on the tensor cores (csrc/winograd_conv3x3_tc.cu,
counter WINOGRAD_CONV3X3_TC, variants "vec" for 16-byte copies where C and
Co are multiples of 8 and "elem" otherwise), f32 on the FMA kernel
(csrc/winograd_conv3x3.cu, counter WINOGRAD_CONV3X3).  No model is wired to
it: `tools/profile_winograd.py` reaches it, against `F.conv2d`.  The wrapper
runs the plain PyTorch version for a CPU tensor, launches its dtype's
kernel for a CUDA tensor, and raises for anything else.

Numerics (the JAX package's `winograd_conv3x3_xla`): the input transform
B^T d B runs in f32 and rounds to the input dtype; U is computed in f32 and
rounds to the input dtype; the 16 products sum in f32; the output transform
adds their +-1 terms in a fixed order, then the bias in f32, and the result
rounds to the input dtype.  Winograd is not bitwise the direct conv: in f32
the two agree to about 1e-5 relative.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import _ext
from .._ext import I, P

__all__ = ["winograd_kernel_transform", "kernel_u", "winograd_conv3x3_plain", "winograd_available",
           "conv_route", "winograd_conv3x3", "WINOGRAD_CONV3X3", "WINOGRAD_CONV3X3_TC"]

WINOGRAD_CONV3X3 = _ext.Kernel("winograd_conv3x3", [P] * 4 + [I] * 6)  # f32, FMA
WINOGRAD_CONV3X3_TC = _ext.Kernel("winograd_conv3x3_tc", [P] * 4 + [I] * 6)  # bf16, tensor cores

_FMA_CO_BLK = 64  # output channels per CTA of the FMA route (csrc/winograd_conv3x3.cu)

# F(2x2, 3x3) transforms; every entry is exact in binary floating point.
#   B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]],  A^T as _AT below
_G = np.array([[1.0, 0.0, 0.0],
               [0.5, 0.5, 0.5],
               [0.5, -0.5, 0.5],
               [0.0, 0.0, 1.0]], np.float32)
_AT = ((1.0, 1.0, 1.0, 0.0), (0.0, 1.0, -1.0, -1.0))


def winograd_kernel_transform(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Co) HWIO kernel -> (4, 4, C, Co) f32 Winograd-domain kernel."""
    g = torch.as_tensor(_G, device=w.device)
    return torch.einsum("ua,vb,abio->uvio", g, g, w.float())


def kernel_u(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The kernels' U: (3, 3, C, Co) -> G g G^T in f32, rounded to `dt`, as
    (16, C, Co), position uu * 4 + vv first.  The wrapper computes it on the
    card at every call, as the JAX package computes U outside its kernel.
    G's rows are g0, (g0 + g1 + g2) / 2, (g0 - g1 + g2) / 2 and g2, so U is
    a few adds and halvings of w's slices, first along the rows, then along
    the columns: no G tensor, no matmul, no copy from the host."""

    def g_rows(t, axis):  # G applied along `axis` of size 3 -> 4
        g0, g1, g2 = t.unbind(axis)
        return torch.stack([g0, (g0 + g1 + g2) * 0.5, (g0 - g1 + g2) * 0.5, g2], axis)

    c, co = w.shape[2:]
    return g_rows(g_rows(w.float(), 0), 1).to(dt).reshape(16, c, co)


def _bt_1d(d0, d1, d2, d3):
    """1-D input transform along one spatial axis: the rows of B^T d."""
    return (d0 - d2, d1 + d2, d2 - d1, d1 - d3)


def winograd_conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, H, W, C), H and W even; w: (3, 3, C, Co); b: (Co,) or None.
    Returns (B, H, W, Co) in x's dtype."""
    bsz, h, wd, c = x.shape
    if h % 2 or wd % 2:
        raise ValueError(f"Winograd F(2,3) needs even H and W, not {(h, wd)}")
    co = w.shape[-1]
    dt = x.dtype
    u = winograd_kernel_transform(w).to(dt).float()  # (4, 4, C, Co)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    # phase view: padded row 2i + a -> (even/odd slab, +-1 tile shift)
    xp = xp.reshape(bsz, h // 2 + 1, 2, wd // 2 + 1, 2, c)
    ph = {(ra, ca): xp[:, :, ra, :, ca] for ra in (0, 1) for ca in (0, 1)}

    def d(a, bb):  # d(a, bb)[i, j] = x_padded[2i + a, 2j + bb]
        sl = ph[(a % 2, bb % 2)]
        return sl[:, a // 2:a // 2 + h // 2, bb // 2:bb // 2 + wd // 2]

    acc = [[None, None], [None, None]]
    for uu in range(4):
        t_u = [_bt_1d(d(0, bb), d(1, bb), d(2, bb), d(3, bb))[uu] for bb in range(4)]
        v_u = _bt_1d(*t_u)  # the column transform: V[uu, vv]
        for vv in range(4):
            wr, wc = (_AT[0][uu], _AT[1][uu]), (_AT[0][vv], _AT[1][vv])
            m = v_u[vv].to(dt).float() @ u[uu, vv]  # (B, H/2, W/2, Co), f32 sum
            for p in range(2):
                for q in range(2):
                    if wr[p] == 0.0 or wc[q] == 0.0:
                        continue
                    term = m if wr[p] * wc[q] == 1.0 else -m
                    acc[p][q] = term if acc[p][q] is None else acc[p][q] + term

    # interleave the 2x2 output phases: (B, H/2, W/2, Co) x 4 -> (B, H, W, Co)
    row0 = torch.stack([acc[0][0], acc[0][1]], dim=3).reshape(bsz, h // 2, wd, co)
    row1 = torch.stack([acc[1][0], acc[1][1]], dim=3).reshape(bsz, h // 2, wd, co)
    y = torch.stack([row0, row1], dim=2).reshape(bsz, h, wd, co)
    if b is not None:
        y = y + b.float()
    return y.to(dt)


def winograd_available(x_shape, c: int, co: int) -> bool:
    """The JAX package's shape gate for its fused kernel (`winograd_available`):
    even H and W of at least 8, W at most 1024, C and Co at least 64.  It is
    a TPU gate; the kernel here takes any even H and W."""
    if len(x_shape) != 4:
        return False
    _, h, wd, _ = x_shape
    return (h % 2 == 0 and wd % 2 == 0 and h >= 8 and wd >= 8
            and c >= 64 and co >= 64 and wd <= 1024)


def conv_route(dtype: torch.dtype, x_shape, co: int) -> str:
    """Which route of kernel K10 takes NHWC input of `x_shape` to `co`
    channels: "tc" (bf16, `winograd_conv3x3_tc`) or "fma" (f32,
    `winograd_conv3x3`).  Both take any C and Co and even H and W; the
    tensor-core kernel's entry raises at launch for a grid of 2^31 CTAs or
    more.  Raises TypeError for other dtypes and ValueError for shapes
    neither route takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"winograd_conv3x3 takes float32 or bfloat16, not {dtype}")
    if len(x_shape) != 4:
        raise ValueError(f"winograd_conv3x3 takes NHWC input, not {tuple(x_shape)}")
    bsz, h, wd, c = x_shape
    ok = min(bsz, h, wd, c, co) > 0 and h % 2 == 0 and wd % 2 == 0
    if ok and dtype == torch.float32:  # the FMA kernel's grid: z images x Co blocks, y tile rows
        ok = bsz * -(-co // _FMA_CO_BLK) <= 65535 and h // 2 <= 65535
    if not ok:
        raise ValueError(f"winograd_conv3x3: no {dtype} route for x={tuple(x_shape)} -> {co} "
                         f"(H and W must be even)")
    return "tc" if dtype == torch.bfloat16 else "fma"


def _kernel(x, w, b) -> torch.Tensor:
    co = w.shape[-1]
    route = conv_route(x.dtype, tuple(x.shape), co)
    bsz, h, wd, c = x.shape
    if w.shape != (3, 3, c, co) or (b is not None and b.shape != (co,)):
        raise ValueError(f"winograd_conv3x3: unsupported shapes x={tuple(x.shape)} "
                         f"w={tuple(w.shape)}")
    dt = x.dtype
    x = x.contiguous()
    u = kernel_u(w, dt)
    bias = None if b is None else b.float().contiguous()
    y = torch.empty(bsz, h, wd, co, dtype=dt, device=x.device)
    bp = None if bias is None else bias.data_ptr()
    if route == "tc":
        vec = c % 8 == 0 and co % 8 == 0  # 16-byte cp.async of x and U
        if vec:
            x, u = _ext.aligned16(x), _ext.aligned16(u)
        WINOGRAD_CONV3X3_TC(x.data_ptr(), u.data_ptr(), bp, y.data_ptr(), bsz, h, wd, c, co,
                            int(vec), device=x.device, variant="vec" if vec else "elem")
    else:
        WINOGRAD_CONV3X3(x.data_ptr(), u.data_ptr(), bp, y.data_ptr(), _ext.dtype_code(dt), bsz,
                         h, wd, c, co, device=x.device)
    return y


def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None) -> torch.Tensor:
    """SAME 3x3 stride-1 conv by Winograd F(2,3).  x: (B, H, W, C) f32 or
    bf16 with even H, W; w: (3, 3, C, Co) (cast to x's dtype through U);
    b: (Co,) or None, added in f32.  On a CUDA tensor bf16 launches the
    tensor-core kernel and f32 the FMA one (`conv_route`)."""
    if x.device.type == "cpu":
        return winograd_conv3x3_plain(x, w, b)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return _kernel(x, w, b)
