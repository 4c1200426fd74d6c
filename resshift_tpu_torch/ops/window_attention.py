"""Standalone window attention over (M, N, C) windows: the qkv projection,
the biased softmax per head and the output projection.

Kernel K9 `window_attn` (csrc/window_attn.cu) replaces the TPU kernel
`swin_attention_pallas._forward_pallas` (K9, via `fused_window_attention`).
`models/swin.py::WindowAttention` and `tools/profile_unet.py` reach it.
The wrapper runs the plain PyTorch version for a CPU tensor, launches the
kernel for a CUDA tensor, and raises for anything else.  The gradient is a
`torch.autograd.Function` whose backward recomputes through the plain
version, as the JAX package's custom VJP recomputes through XLA.

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

__all__ = ["window_attention_plain", "window_attention", "WindowAttentionFn", "WINDOW_ATTN"]

WINDOW_ATTN = _ext.Kernel("window_attn", [P] * 7 + [I] * 6)


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


def _kernel(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads: int) -> torch.Tensor:
    if xw.dim() != 3:
        raise ValueError(f"window_attn takes (M, N, C) windows, not {tuple(xw.shape)}")
    m, n, c = xw.shape
    nw = bias_mask.shape[0]
    if (n > 64 or c > 256 or c % num_heads or c // num_heads > 64 or m % nw
            or bias_mask.shape != (nw, num_heads, n, n) or wqkv.shape != (c, 3 * c)
            or bqkv.shape != (3 * c,) or wproj.shape != (c, c) or bproj.shape != (c,)):
        raise ValueError(f"window_attn: unsupported shapes x={tuple(xw.shape)} heads={num_heads} "
                         f"bias={tuple(bias_mask.shape)} wqkv={tuple(wqkv.shape)}")
    dt = xw.dtype
    code = _ext.dtype_code(dt)  # f32 or bf16, else raises
    xw = xw.contiguous()
    args = [t.to(dt).contiguous() for t in (wqkv, bqkv, wproj, bproj)]
    bm = bias_mask.float().contiguous()
    y = torch.empty_like(xw)
    WINDOW_ATTN(xw.data_ptr(), *(a.data_ptr() for a in args), bm.data_ptr(), y.data_ptr(),
                code, m, n, c, num_heads, nw)
    return y


def _forward(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads):
    if xw.device.type == "cpu":
        return window_attention_plain(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads)
    if xw.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xw.device}")
    return _kernel(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads)


class WindowAttentionFn(torch.autograd.Function):
    """Forward: the kernel on a CUDA tensor, the plain version on a CPU one.
    Backward: the plain version's gradients, recomputed under autograd."""

    @staticmethod
    def forward(ctx, xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads: int):
        ctx.save_for_backward(xw, wqkv, bqkv, wproj, bproj, bias_mask)
        ctx.num_heads = num_heads
        return _forward(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in ins if t.requires_grad]
        with torch.enable_grad():
            y = window_attention_plain(*ins, ctx.num_heads)
            grads = iter(torch.autograd.grad(y, wanted, g) if wanted else ())
        return (*(next(grads) if t.requires_grad else None for t in ins), None)


def window_attention(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads: int) -> torch.Tensor:
    """Windowed multi-head attention with a custom gradient.  xw: (M, N, C)
    f32 or bf16 tokens of M windows; the weights in xw's dtype (cast if
    not); bias_mask (nW or 1, nh, N, N) additive f32 (rel-pos bias, plus the
    shifted-window mask)."""
    return WindowAttentionFn.apply(xw, wqkv, bqkv, wproj, bproj, bias_mask, num_heads)
