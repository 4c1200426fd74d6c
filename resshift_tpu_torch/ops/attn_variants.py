"""Kernel A's attention half without its statistics, with one of five
softmaxes: the ablations that split the attention's cost between its
matrix products and its softmax.

Probe P2 replaces the TPU probe
`tools/profile_attn_variants.py::call_variant` (P2) with two routes, picked
by `attn_variant_route` from the dtype and the shape: bf16 with C % 16 == 0
and heads 16 or 32 wide runs `attn_variants_tc` (csrc/attn_variants_tc.cu,
kernel A's tensor-core body with P2's rounding and softmaxes); f32, and
bf16 at other head widths, run the FMA kernel `attn_variants`
(csrc/attn_variants.cu).  Counters `ATTN_VARIANTS_TC` and `ATTN_VARIANTS`
say which ran.  `tools/profile_attn_variants.py` reaches it, beside kernel
A.  The wrapper runs the plain PyTorch version for a CPU tensor, launches
the route's kernel for a CUDA tensor, and raises for anything else.

    y = x + proj(attn(x*w + b)),  s = q k^T hd^-1/2 + B - 30 per head

The shift of 30 is the one the TPU kernel folds into its bias
(`swin_block_pallas._prep_bias`); f32, bf16exp and noexp do not depend on
it, mxsum and none do.  Softmax modes (`attn_kernel_variant`):
  f32      softmax in f32, the probabilities rounded to the value dtype;
  mxsum    p = exp(s - 30) rounded, p v divided by the f32 sum of those p;
  bf16exp  p = exp((s - max) rounded) rounded, divided by the rounded sum;
  noexp    (s - max) / sum(s - max);
  none     the raw scores.
Rounding follows that kernel: qkv and proj add their bias to the f32 sum
and round once, the scores stay f32, y = x + proj rounds once.  The TPU
probe's super-windows (`_pick_gw`) are not carried over: there the noexp
and none modes mixed the windows of a super-window through its -1e9 cross
mask; here every window stands alone.
"""

from __future__ import annotations

import torch

from .. import _ext
from .._ext import I, P
from .window_attention import rounded, tc_body_route

__all__ = ["SOFTMAX_MODES", "SOFTMAX_SHIFT", "attn_variant_plain", "attn_variant",
           "attn_variant_route", "ATTN_VARIANTS", "ATTN_VARIANTS_TC"]

ATTN_VARIANTS = _ext.Kernel("attn_variants", [P] * 9 + [I] * 8)
ATTN_VARIANTS_TC = _ext.Kernel("attn_variants_tc", [P] * 9 + [I] * 7)

SOFTMAX_MODES = ("f32", "mxsum", "bf16exp", "noexp", "none")
SOFTMAX_SHIFT = 30.0


def attn_variant_plain(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask, num_heads: int,
                       n_win: int, softmax: str = "f32") -> torch.Tensor:
    """x: (B, T, C) window-major tokens; w, b: (B, C) f32 GroupNorm affine;
    bias_mask: (nW or 1, nh, N, N) f32."""
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, not {softmax!r}")
    bsz, t, c = x.shape
    nh, hd, n, dt = num_heads, c // num_heads, n_win, x.dtype
    m = bsz * t // n
    xn = (x.float() * w[:, None] + b[:, None]).to(dt)
    qkv = (xn.float() @ wqkv.to(dt).float() + bqkv.to(dt).float()).to(dt)
    qkv = qkv.reshape(m, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1].float(), qkv[2].float()
    s = (q * rounded(hd**-0.5, dt)).float() @ k.transpose(-1, -2)
    nw = bias_mask.shape[0]
    s = s.reshape(m // nw, nw, nh, n, n) + (bias_mask.float() - SOFTMAX_SHIFT)[None]
    s = s.reshape(m, nh, n, n)
    if softmax == "mxsum":
        p = torch.exp(s - 30.0).to(dt).float()
        out = (p @ v) * (1.0 / p.sum(-1, keepdim=True))
    else:
        smax = s.amax(-1, keepdim=True)
        if softmax == "f32":
            p = torch.softmax(s, dim=-1).to(dt)
        elif softmax == "bf16exp":
            p = torch.exp((s - smax).to(dt))
            p = p / p.float().sum(-1, keepdim=True).to(dt)
        elif softmax == "noexp":
            p = s - smax
            p = (p / p.sum(-1, keepdim=True)).to(dt)
        else:
            p = s.to(dt)
        out = p.float() @ v
    out = out.transpose(1, 2).reshape(m, n, c).to(dt)
    proj = out.float() @ wproj.to(dt).float() + bproj.to(dt).float()
    return (x.float() + proj.reshape(bsz, t, c)).to(dt)


def attn_variant_route(dtype: torch.dtype, n: int, c: int, num_heads: int) -> str:
    """Which kernel takes windows of `n` tokens x `c` channels in
    `num_heads` heads: "tc" (bf16 with C % 16 == 0 and heads 16 or 32
    wide: `attn_variants_tc`, on the tensor cores) or "fma" (f32 at any
    shape, bf16 at the other head widths: `attn_variants`).  Both take n <=
    64, C <= 256 and heads up to 64 wide; raises ValueError for other
    shapes, TypeError for dtypes other than float32 and bfloat16.  The gate
    is K9's (`window_attention.window_attn_route`): both routes run kernel
    A's bodies."""
    return tc_body_route("attn_variants", dtype, n, c, num_heads)


def _kernel(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask, num_heads, n_win, softmax):
    if x.dim() != 3:
        raise ValueError(f"attn_variants takes (B, T, C) tokens, not {tuple(x.shape)}")
    bsz, t, c = x.shape
    route = attn_variant_route(x.dtype, n_win, c, num_heads)
    nwb = bias_mask.shape[0]
    if (softmax not in SOFTMAX_MODES or t % n_win
            or bias_mask.shape != (nwb, num_heads, n_win, n_win) or nwb not in (1, t // n_win)
            or wqkv.shape != (c, 3 * c) or wproj.shape != (c, c)):
        raise ValueError(f"attn_variants: unsupported call x={tuple(x.shape)} heads={num_heads} "
                         f"N={n_win} bias={tuple(bias_mask.shape)} softmax={softmax!r}")
    dt = x.dtype
    x = x.contiguous()
    args = [a.float().contiguous() for a in (w, b)]
    args += [a.to(dt).contiguous() for a in (wqkv, bqkv, wproj, bproj)]
    bm = (bias_mask.float() - SOFTMAX_SHIFT).contiguous()
    if route == "tc":  # cp.async of the rows and weights, pairs of the biases
        x, bm = _ext.aligned16(x), _ext.aligned16(bm)
        args[2:] = [_ext.aligned16(a) for a in args[2:]]
    y = torch.empty_like(x)
    ptrs = [x.data_ptr(), *(a.data_ptr() for a in args), bm.data_ptr(), y.data_ptr()]
    mode = SOFTMAX_MODES.index(softmax)
    if route == "tc":
        ATTN_VARIANTS_TC(*ptrs, mode, bsz, t, c, num_heads, n_win, nwb, device=x.device,
                         variant=softmax)
    else:
        ATTN_VARIANTS(*ptrs, _ext.dtype_code(dt), mode, bsz, t, c, num_heads, n_win, nwb,
                      device=x.device, variant=softmax)
    return y


def attn_variant(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask, num_heads: int, n_win: int,
                 softmax: str = "f32") -> torch.Tensor:
    """x + proj(attn(x*w + b)) with the softmax `softmax` (SOFTMAX_MODES)."""
    if x.device.type == "cpu":
        return attn_variant_plain(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask, num_heads,
                                  n_win, softmax)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return _kernel(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask, num_heads, n_win, softmax)
