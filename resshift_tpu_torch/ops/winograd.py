"""Winograd F(2x2, 3x3) convolution: a SAME, stride-1 3x3 conv on NHWC
input with an HWIO weight, through 16 channel contractions against the
transformed kernel U = G g G^T (Lavin and Gray, arXiv:1509.09308).

Kernel K10 `winograd_conv3x3` (csrc/winograd_conv3x3.cu) replaces the TPU
kernel `winograd.winograd_conv3x3` (K10).  No model is wired to it:
`tools/profile_winograd.py` reaches it, against `F.conv2d`.  The wrapper
runs the plain PyTorch version for a CPU tensor, launches the kernel for a
CUDA tensor, and raises for anything else.

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

__all__ = ["winograd_kernel_transform", "winograd_conv3x3_plain", "winograd_available",
           "winograd_conv3x3", "WINOGRAD_CONV3X3"]

WINOGRAD_CONV3X3 = _ext.Kernel("winograd_conv3x3", [P] * 4 + [I] * 6)

_CO_BLK = 64  # output channels per CTA (csrc/winograd_conv3x3.cu)

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


def _kernel(x, w, b) -> torch.Tensor:
    if x.dim() != 4:
        raise ValueError(f"winograd_conv3x3 takes NHWC input, not {tuple(x.shape)}")
    bsz, h, wd, c = x.shape
    co = w.shape[-1]
    if (w.shape != (3, 3, c, co) or (b is not None and b.shape != (co,)) or h % 2 or wd % 2
            or bsz * -(-co // _CO_BLK) > 65535 or h // 2 > 65535):
        raise ValueError(f"winograd_conv3x3: unsupported shapes x={tuple(x.shape)} "
                         f"w={tuple(w.shape)} (H and W must be even)")
    dt = x.dtype
    code = _ext.dtype_code(dt)  # f32 or bf16, else raises
    x = x.contiguous()
    u = winograd_kernel_transform(w).to(dt).reshape(16, c, co).contiguous()
    bias = None if b is None else b.float().contiguous()
    y = torch.empty(bsz, h, wd, co, dtype=dt, device=x.device)
    WINOGRAD_CONV3X3(x.data_ptr(), u.data_ptr(), None if bias is None else bias.data_ptr(),
                     y.data_ptr(), code, bsz, h, wd, c, co)
    return y


def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None) -> torch.Tensor:
    """SAME 3x3 stride-1 conv by Winograd F(2,3).  x: (B, H, W, C) f32 or
    bf16 with even H, W; w: (3, 3, C, Co) (cast to x's dtype through U);
    b: (Co,) or None, added in f32."""
    if x.device.type == "cpu":
        return winograd_conv3x3_plain(x, w, b)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return _kernel(x, w, b)
