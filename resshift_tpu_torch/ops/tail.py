"""GroupNorm (f32 statistics) + SiLU + 3x3 conv to at most 8 channels: the
UNet head and the VQGAN decoder tail, on NCHW tensors.

Kernel F `gn_silu_conv3x3` (csrc/gn_silu_conv3x3.cu) replaces the TPU
kernel `tail_pallas._fused` (K8).  As in the JAX package the GroupNorm is
folded to a per-(image, channel) affine first (`group_norm_fold`, plain
reductions), and the kernel is off by default: `use_pallas=True` launches
it for a CUDA tensor; otherwise the plain composition runs, the JAX
package's default route.  A CPU tensor always takes the plain version.

Rounding points (the JAX package's `tail_pallas._reference`): in bf16 the
affine result rounds to bf16; the SiLU runs on that value as
`jax.nn.silu` is written, x * (1 / (1 + exp(-x))), each operation
rounding to bf16; the taps are summed in f32 and the conv result rounds to
bf16, and only then is the bias added in bf16.  In f32 everything stays
f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _ext
from .._ext import I, P
from .swin_block import fold_stats

__all__ = ["group_norm_fold", "gn_silu_conv3x3_plain", "gn_silu_conv3x3", "GN_SILU_CONV3X3"]

GN_SILU_CONV3X3 = _ext.Kernel("gn_silu_conv3x3", [P] * 6 + [I] * 6)

_MAX_CO = 8  # output channels of kernel F (csrc/gn_silu_conv3x3.cu)


def group_norm_fold(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5):
    """The GroupNorm of NCHW `x` as f32 (B, C) `w, b` with GN(x) == x*w + b:
    float32 sums and sums of squares per (image, channel), folded per group
    (the JAX package's `layers.group_norm_fold`)."""
    xf = x.float()
    return fold_stats((xf.sum((2, 3)), (xf * xf).sum((2, 3))), scale, bias,
                      x.shape[2] * x.shape[3], num_groups, eps)


def gn_silu_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """silu(x * w + b) -> conv3x3 (zero padding of the activated tensor) +
    bias, in x's dtype.  x: (B, C, H, W); w, b: the folded f32 (B, C)
    affine; weight (co, C, 3, 3); bias (co,)."""
    dt = x.dtype
    a = (x.float() * w[:, :, None, None] + b[:, :, None, None]).to(dt)
    s = a * (1 / (1 + torch.exp(-a)))  # x * sigmoid(x), op for op in dt
    return F.conv2d(s, weight.to(dt), padding=1) + bias.to(dt)[:, None, None]


def _kernel(x, w, b, weight, bias) -> torch.Tensor:
    bsz, c, h, wd = x.shape
    co = weight.shape[0]
    if co > _MAX_CO or weight.shape != (co, c, 3, 3) or bias.shape != (co,):
        raise ValueError(f"gn_silu_conv3x3 takes a (co <= {_MAX_CO}, C, 3, 3) conv; got "
                         f"weight {tuple(weight.shape)}, bias {tuple(bias.shape)} for C={c}")
    dt = x.dtype
    code = _ext.dtype_code(dt)  # f32 or bf16, else raises
    x = x.contiguous()
    # (C, 9, co) taps in x's dtype, as the conv of the plain version reads them
    taps = weight.to(dt).float().permute(1, 2, 3, 0).reshape(c, 9, co).contiguous()
    w, b = (t.float().contiguous() for t in (w, b))
    cb = bias.float().contiguous()
    y = torch.empty(bsz, co, h, wd, dtype=dt, device=x.device)
    GN_SILU_CONV3X3(x.data_ptr(), w.data_ptr(), b.data_ptr(), taps.data_ptr(), cb.data_ptr(),
                    y.data_ptr(), code, bsz, c, h, wd, co)
    return y


def gn_silu_conv3x3(x: torch.Tensor, gn_scale, gn_bias, weight, bias, *, num_groups: int = 32,
                    eps: float = 1e-5, use_pallas: bool = False) -> torch.Tensor:
    """GroupNorm(num_groups, eps, f32 statistics) -> SiLU -> conv3x3(C -> co).
    x: (B, C, H, W), f32 or bf16; gn_scale, gn_bias (C,); weight (co, C, 3,
    3); bias (co,).  `use_pallas=True` launches kernel F on a CUDA tensor,
    and then co > 8 or another dtype raises."""
    w, b = group_norm_fold(x, gn_scale, gn_bias, num_groups, eps)
    if x.device.type == "cpu" or (x.device.type == "cuda" and not use_pallas):
        return gn_silu_conv3x3_plain(x, w, b, weight, bias)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return _kernel(x, w, b, weight, bias)
