"""GroupNorm (f32 statistics) + SiLU + 3x3 conv to at most 8 channels: the
UNet head and the VQGAN decoder tail, on NCHW tensors.

Kernel F replaces the TPU kernel `tail_pallas._fused` (K8) and the
GroupNorm fold the JAX package computes before it.  It is three CUDA
kernels, each with its launch counter:
  * `gn_stats` (csrc/gn_silu_conv3x3.cu, GN_STATS): the per-(image,
    channel) sums and sums of squares of x, read once in its own dtype,
    and their fold into the f32 (B, C) affine `w, b` with GN(x) == x*w + b,
    on the card and in a fixed order (two calls give the same bits);
  * `gn_silu_conv3x3_tc` (csrc/gn_silu_conv3x3_tc.cu, GN_SILU_CONV3X3_TC):
    the bf16 route on the tensor cores, for C % 16 == 0 (the decoder tails);
  * `gn_silu_conv3x3` (csrc/gn_silu_conv3x3.cu, GN_SILU_CONV3X3): the FMA
    route, for f32 (the UNet heads) and bf16 at other C, with the channels
    split across CTAs.
`tail_route` picks the route.  As in the JAX package, the kernel is off by
default: `use_pallas=True` launches it for a CUDA tensor; otherwise the
plain composition runs (`group_norm_fold`, then `gn_silu_conv3x3_plain`),
the JAX package's default route.  A CPU tensor always takes the plain
version.  A launch carries the plain composition's gradient
(`_ext.Recompute`), as the JAX package's `_fused_bwd` calls `jax.vjp` of
`tail_pallas._reference`.

Rounding points (the JAX package's `tail_pallas._reference`): in bf16 the
affine result rounds to bf16; the SiLU runs on that value as
`jax.nn.silu` is written, x * (1 / (1 + exp(-x))), each operation
rounding to bf16; the taps are summed in f32 and the conv result rounds to
bf16, and only then is the bias added in bf16.  In f32 everything stays
f32.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .. import _ext
from .._ext import I, P
from .swin_block import fold_stats

__all__ = ["group_norm_fold", "gn_stats", "gn_silu_conv3x3_plain", "gn_silu_conv3x3",
           "tail_route", "GN_STATS", "GN_SILU_CONV3X3", "GN_SILU_CONV3X3_TC"]

_LIB = "gn_silu_conv3x3"
GN_STATS = _ext.Kernel("gn_stats", [P] * 6 + [I] * 5 + [_ext.F], lib=_LIB)
GN_SILU_CONV3X3 = _ext.Kernel("gn_silu_conv3x3", [P] * 7 + [I] * 6)  # FMA
GN_SILU_CONV3X3_TC = _ext.Kernel("gn_silu_conv3x3_tc", [P] * 6 + [I] * 5)  # tensor cores

_MAX_CO = 8  # output channels of kernel F
# the largest C of the tensor-core route: its shared memory (the halo tile,
# the taps and the affine: csrc/gn_silu_conv3x3_tc.cu smem_bytes) within 227 KB
_TC_MAX_C = 992


def tail_route(device_type: str, dtype: torch.dtype, c: int, co: int,
               use_pallas: bool = True) -> str:
    """Which version takes a tail of C = `c` channels to `co`: "plain" (a CPU
    tensor, or a CUDA tensor with `use_pallas` off), "tc" (bf16 with C % 16
    == 0: `gn_silu_conv3x3_tc`, on the tensor cores) or "fma" (f32, and bf16
    at other C: `gn_silu_conv3x3`).  The kernels take co <= 8 and float32 or
    bfloat16; raises ValueError, TypeError or (another device) RuntimeError
    for the rest."""
    if device_type == "cpu" or (device_type == "cuda" and not use_pallas):
        return "plain"
    if device_type != "cuda":
        raise RuntimeError(f"no kernel for device {device_type}")
    _ext.dtype_code(dtype)  # f32 or bf16, else TypeError
    if not (0 < co <= _MAX_CO and c > 0):
        raise ValueError(f"gn_silu_conv3x3 takes C > 0 to co <= {_MAX_CO}; got C={c}, co={co}")
    return "tc" if dtype == torch.bfloat16 and c % 16 == 0 and c <= _TC_MAX_C else "fma"


def group_norm_fold(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5):
    """The GroupNorm of NCHW `x` as f32 (B, C) `w, b` with GN(x) == x*w + b:
    float32 sums and sums of squares per (image, channel), folded per group
    (the JAX package's `layers.group_norm_fold`)."""
    xf = x.float()
    return fold_stats((xf.sum((2, 3)), (xf * xf).sum((2, 3))), scale, bias,
                      x.shape[2] * x.shape[3], num_groups, eps)


@functools.lru_cache(maxsize=256)
def _workspace(name: str, *args: int) -> int:
    """Bytes of the workspace a launch of this shape takes (csrc/<_LIB>.cu)."""
    return _ext.query(_LIB, name, *args)


def _stats(x: torch.Tensor, scale, bias, num_groups: int, eps: float,
           extra: int = 0) -> tuple[torch.Tensor, int]:
    """Launch `gn_stats` on CUDA `x` (contiguous); returns one f32 buffer, w
    (B*C), b (B*C), the slices' partial sums, then `extra` bytes for the
    caller, and the address of those.  One allocation, pointers by offset:
    the wrapper's host time is what a small tail's call costs."""
    bsz, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    g = min(num_groups, c)
    if c % g or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"gn_stats: C={c} in {g} groups, scale {tuple(scale.shape)}, bias "
                         f"{tuple(bias.shape)}")
    code = _ext.dtype_code(x.dtype)
    scale, bias = (t.float().contiguous() for t in (scale, bias))
    n = bsz * c
    ws = _workspace("gn_stats_workspace", bsz, c, hw, code)
    buf = torch.empty(2 * n + (ws + extra + 3) // 4, dtype=torch.float32, device=x.device)
    base = buf.data_ptr()
    GN_STATS(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), base + 8 * n, base, base + 4 * n,
             code, bsz, c, hw, g, eps, device=x.device)
    return buf, base + 8 * n + ws


def gn_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             num_groups: int = 32, eps: float = 1e-5):
    """`group_norm_fold` on the card: kernel `gn_stats` for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return group_norm_fold(x, scale, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    bsz, c = x.shape[:2]
    buf, _ = _stats(x.contiguous(), scale, bias, num_groups, eps)
    return buf[:bsz * c].view(bsz, c), buf[bsz * c:2 * bsz * c].view(bsz, c)


def gn_silu_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """silu(x * w + b) -> conv3x3 (zero padding of the activated tensor) +
    bias, in x's dtype.  x: (B, C, H, W); w, b: the folded f32 (B, C)
    affine; weight (co, C, 3, 3); bias (co,)."""
    dt = x.dtype
    a = (x.float() * w[:, :, None, None] + b[:, :, None, None]).to(dt)
    s = a * (1 / (1 + torch.exp(-a)))  # x * sigmoid(x), op for op in dt
    return F.conv2d(s, weight.to(dt), padding=1) + bias.to(dt)[:, None, None]


def _kernel(route: str, x, gn_scale, gn_bias, weight, bias, num_groups: int,
            eps: float) -> torch.Tensor:
    """gn_stats, then the conv kernel of `route`, on CUDA tensors."""
    bsz, c, h, wd = x.shape
    co = weight.shape[0]
    if weight.shape != (co, c, 3, 3) or bias.shape != (co,):
        raise ValueError(f"gn_silu_conv3x3 takes a (co <= {_MAX_CO}, C, 3, 3) conv; got "
                         f"weight {tuple(weight.shape)}, bias {tuple(bias.shape)} for C={c}")
    dt = x.dtype
    x = x.contiguous()
    # the FMA route's workspace (partial tiles, arrival counters) after the
    # statistics, in the same buffer
    conv_ws = 0 if route == "tc" else _workspace("gn_silu_conv3x3_workspace", bsz, c, h, wd, co)
    buf, ws = _stats(x, gn_scale, gn_bias, num_groups, eps, extra=conv_ws)
    w = buf.data_ptr()
    b = w + 4 * bsz * c
    # the conv's weight and bias in x's dtype, as the plain version rounds them
    wt, cb = weight.to(dt).contiguous(), bias.to(dt).contiguous()
    y = torch.empty(bsz, co, h, wd, dtype=dt, device=x.device)
    if route == "tc":
        GN_SILU_CONV3X3_TC(x.data_ptr(), w, b, wt.data_ptr(), cb.data_ptr(), y.data_ptr(), bsz,
                           c, h, wd, co, device=x.device)
    else:
        GN_SILU_CONV3X3(x.data_ptr(), w, b, wt.data_ptr(), cb.data_ptr(), y.data_ptr(), ws,
                        _ext.dtype_code(dt), bsz, c, h, wd, co, device=x.device)
    return y


def gn_silu_conv3x3(x: torch.Tensor, gn_scale, gn_bias, weight, bias, *, num_groups: int = 32,
                    eps: float = 1e-5, use_pallas: bool = False) -> torch.Tensor:
    """GroupNorm(num_groups, eps, f32 statistics) -> SiLU -> conv3x3(C -> co).
    x: (B, C, H, W), f32 or bf16; gn_scale, gn_bias (C,); weight (co, C, 3,
    3); bias (co,).  `use_pallas=True` launches kernel F on a CUDA tensor
    (`gn_stats`, then the route `tail_route` picks), and then co > 8 or
    another dtype raises."""
    route = tail_route(x.device.type, x.dtype, x.shape[1], weight.shape[0], use_pallas)

    def plain(x, gn_scale, gn_bias, weight, bias):
        w, b = group_norm_fold(x, gn_scale, gn_bias, num_groups, eps)
        return gn_silu_conv3x3_plain(x, w, b, weight, bias)

    if route == "plain":
        return plain(x, gn_scale, gn_bias, weight, bias)
    return _ext.Recompute.launch(
        lambda *a: _kernel(route, *a, num_groups, eps), plain, x, gn_scale, gn_bias, weight,
        bias)
