"""Standalone window attention over (M, N, C) windows: the qkv projection,
the biased softmax per head and the output projection.

Kernel K9 replaces the TPU kernel `swin_attention_pallas._forward_pallas`
(K9, via `fused_window_attention`) with two routes, picked by
`window_attn_route` from the dtype and the shape: bf16 with C % 16 == 0 and
heads 16 or 32 wide runs `window_attn_tc` (csrc/window_attn_tc.cu, kernel
A's tensor-core body without its GroupNorm, roll, residual and statistics);
f32, and bf16 at other head widths, run the FMA kernel `window_attn`
(csrc/window_attn.cu).  Counters `WINDOW_ATTN_TC` and `WINDOW_ATTN` say
which ran.  `models/swin.py::WindowAttention` and `tools/profile_unet.py`
reach it.  The wrapper runs the plain PyTorch version for a CPU tensor,
launches the route's kernel for a CUDA tensor, and raises for anything
else.  The gradient is `_ext.Recompute`'s: the backward recomputes
through the plain version, as the JAX package's custom VJP recomputes
through XLA.

Rounding points (the JAX package's `xla_window_attention`): qkv and proj
round their product to the activation dtype before adding the bias; q is
scaled (by hd^-1/2 rounded to that dtype) before the score product; the
bias rounds to that dtype before it is added; the softmax runs in f32 and
its probabilities round before p v.
"""

from __future__ import annotations

import torch

from .. import _ext
from .._ext import I, P

__all__ = ["window_attention_plain", "window_attention", "window_attn_route", "tc_body_route",
           "WINDOW_ATTN", "WINDOW_ATTN_TC"]

WINDOW_ATTN = _ext.Kernel("window_attn", [P] * 7 + [I] * 6)
WINDOW_ATTN_TC = _ext.Kernel("window_attn_tc", [P] * 7 + [I] * 5)


def rounded(v: float, dt: torch.dtype) -> float:
    """`v` rounded to `dt`: a Python scalar times a low-precision array
    rounds the scalar first in JAX; torch would keep it in f32."""
    return float(torch.tensor(v, dtype=dt))


def window_attention_plain(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads: int):
    """proj(softmax(q k^T hd^-1/2 + B) v), q, k, v = xw Wqkv + bqkv.
    xw: (M, N, C); wqkv (C, 3C), bqkv (3C,), wproj (C, C), bproj (C,);
    bias_mask: (nW or 1, nh, N, N) f32, window m taking row m % nW."""
    m, n, c = xw.shape
    nh, hd, dt = num_heads, c // num_heads, xw.dtype
    qkv = xw @ wqkv.to(dt) + bqkv.to(dt)
    qkv = qkv.reshape(m, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (q * rounded(hd**-0.5, dt)) @ k.transpose(-1, -2)
    nw = bias_mask.shape[0]
    attn = attn.reshape(m // nw, nw, nh, n, n) + bias_mask[None].to(dt)
    attn = torch.softmax(attn.reshape(m, nh, n, n).float(), dim=-1).to(dt)
    out = (attn @ v).transpose(1, 2).reshape(m, n, c)
    return out @ wproj.to(dt) + bproj.to(dt)


def tc_body_route(kernel: str, dtype: torch.dtype, n: int, c: int, num_heads: int) -> str:
    """The route gate of the kernels with two routes on kernel A's bodies,
    K9 and P2 (`kernel` names it in the errors): "tc" for bf16 with C % 16
    == 0 and heads 16 or 32 wide (window_attn_tc.cuh), "fma" for f32 at any
    shape and bf16 at the other head widths (window_heads.cuh).  Both take
    n <= 64, C <= 256 and heads up to 64 wide; raises ValueError for other
    shapes, TypeError for dtypes other than float32 and bfloat16."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel} takes float32 or bfloat16, not {dtype}")
    hd = c // num_heads if num_heads > 0 and c % num_heads == 0 else 0
    if not (0 < n <= 64 and 0 < c <= 256 and 0 < hd <= 64):
        raise ValueError(f"{kernel}: no route for N={n}, C={c}, heads={num_heads}")
    return "tc" if dtype == torch.bfloat16 and c % 16 == 0 and hd in (16, 32) else "fma"


def window_attn_route(dtype: torch.dtype, n: int, c: int, num_heads: int) -> str:
    """Which kernel takes windows of `n` tokens x `c` channels in
    `num_heads` heads: "tc" (bf16 with C % 16 == 0 and heads 16 or 32
    wide: `window_attn_tc`, on the tensor cores) or "fma" (f32 at any
    shape, bf16 at the other head widths: `window_attn`).  Both take n <=
    64, C <= 256 and heads up to 64 wide; raises ValueError for other
    shapes, TypeError for dtypes other than float32 and bfloat16."""
    return tc_body_route("window_attn", dtype, n, c, num_heads)


def _kernel(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads: int) -> torch.Tensor:
    if xw.dim() != 3:
        raise ValueError(f"window_attn takes (M, N, C) windows, not {tuple(xw.shape)}")
    m, n, c = xw.shape
    route = window_attn_route(xw.dtype, n, c, num_heads)
    nw = bias_mask.shape[0]
    if (m % nw or bias_mask.shape != (nw, num_heads, n, n) or wqkv.shape != (c, 3 * c)
            or bqkv.shape != (3 * c,) or wproj.shape != (c, c) or bproj.shape != (c,)):
        raise ValueError(f"window_attn: unsupported shapes x={tuple(xw.shape)} heads={num_heads} "
                         f"bias={tuple(bias_mask.shape)} wqkv={tuple(wqkv.shape)}")
    dt = xw.dtype
    xw = xw.contiguous()
    args = [t.to(dt).contiguous() for t in (wqkv, bqkv, wproj, bproj)]
    bm = bias_mask.float().contiguous()
    if route == "tc":  # cp.async of the rows and weights, pairs of the biases
        xw, bm = _ext.aligned16(xw), _ext.aligned16(bm)
        args = [_ext.aligned16(a) for a in args]
    y = torch.empty_like(xw)
    ptrs = [xw.data_ptr(), *(a.data_ptr() for a in args), bm.data_ptr(), y.data_ptr()]
    if route == "tc":
        WINDOW_ATTN_TC(*ptrs, m, n, c, num_heads, nw, device=xw.device)
    else:
        WINDOW_ATTN(*ptrs, _ext.dtype_code(dt), m, n, c, num_heads, nw, device=xw.device)
    return y


def _forward(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads):
    if xw.device.type == "cpu":
        return window_attention_plain(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads)
    if xw.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xw.device}")
    return _kernel(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads)


def window_attention(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads: int) -> torch.Tensor:
    """Windowed multi-head attention with a custom gradient.  xw: (M, N, C)
    f32 or bf16 tokens of M windows; the weights in xw's dtype (cast if
    not); bias_mask (nW or 1, nh, N, N) additive f32 (rel-pos bias, plus the
    shifted-window mask)."""
    return _ext.Recompute.launch(_forward, window_attention_plain, xw, wqkv, bqkv, wproj, bproj,
                                 bias_mask, num_heads)
