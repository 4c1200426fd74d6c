"""Swin block halves on (B, T, C) window-major tokens: GroupNorm folded to a
per-image affine, then window attention or the channel MLP, plus the
residual and the f32 (sum, sumsq) of the output per (image, channel) that
the next GroupNorm folds from.

Two kernels carry the block on the GPU (csrc/), each in two routes chosen
by dtype: bf16 (the main path's) on the tensor cores, f32 on the FMA units.
  * A replaces the TPU kernels
    `swin_block_pallas._norm_attn_residual_fwd_pallas` (K1) and
    `_shift_attn_fwd_pallas` (K3, the shifted-window read):
    `swin_window_attn_tc` in bf16, `swin_window_attn` in f32 (the shapes
    each takes: `attn_route`);
  * B replaces `_norm_mlp_residual_fwd_pallas` (K2) and
    `_mlp_unshift_fwd_pallas` (K4, the unshifted write): `swin_mlp_tc` in
    bf16, `swin_mlp` in f32.
Each wrapper runs the plain PyTorch version for a CPU tensor, launches
the kernel for a CUDA tensor, and raises for anything else.  A launch carries the plain version's
gradient (`_ext.Recompute`: the backward recomputes the plain version
under autograd), as the JAX package's custom VJPs `_nars_bwd`,
`_sars_bwd`, `_nmrs_bwd` and `_murs_bwd` recompute the `*_xla`
compositions; every output (y and both statistics) is differentiable.
The plain versions repeat the JAX package's `*_xla` compositions op for
op, including where they round to the activation dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _ext
from .._ext import I, P
from .window_attention import window_attention_plain

__all__ = ["token_stats", "fold_stats", "gn_fold", "shift_permutation", "shift_fuse_fits",
           "attn_route",
           "norm_attn_residual_plain", "norm_mlp_residual_plain",
           "norm_attn_residual_stats_plain", "shift_attn_residual_stats_plain",
           "norm_mlp_residual_stats_plain", "mlp_unshift_residual_stats_plain",
           "norm_attn_residual_stats", "shift_attn_residual_stats",
           "norm_mlp_residual_stats", "mlp_unshift_residual_stats",
           "SWIN_WINDOW_ATTN", "SWIN_WINDOW_ATTN_TC", "SWIN_MLP", "SWIN_MLP_TC"]

SWIN_WINDOW_ATTN = _ext.Kernel("swin_window_attn", [P] * 13 + [I] * 11)  # f32, FMA
SWIN_WINDOW_ATTN_TC = _ext.Kernel("swin_window_attn_tc", [P] * 13 + [I] * 10)  # bf16, tensor cores
SWIN_MLP = _ext.Kernel("swin_mlp", [P] * 12 + [I] * 9)  # f32, FMA
SWIN_MLP_TC = _ext.Kernel("swin_mlp_tc", [P] * 12 + [I] * 8)  # bf16, tensor cores

_ROWS = 64  # token rows per CTA of kernel B, both routes (csrc/swin_mlp*.cu)


# ------------------------------------------------------------------ GN fold

def token_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(image, channel) f32 sum and sum of squares over the token axis."""
    xf = x.float()
    return xf.sum(1), (xf * xf).sum(1)


def fold_stats(stats, scale: torch.Tensor, bias: torch.Tensor, t: int,
               num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm affine (w, b), f32 (B, C), with GN(x) == x*w + b, from the
    per-channel token sums over `t` tokens."""
    s_c, sq_c = stats
    bsz, c = s_c.shape
    g = min(num_groups, c)
    n = t * (c // g)
    mean_g = s_c.reshape(bsz, g, c // g).sum(-1) / n
    var_g = torch.clamp(sq_c.reshape(bsz, g, c // g).sum(-1) / n - mean_g * mean_g, min=0.0)
    inv_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(c // g, dim=1)
    w = inv_g.repeat_interleave(c // g, dim=1) * scale[None].float()
    return w, bias[None].float() - mean_c * w


def gn_fold(x: torch.Tensor, scale, bias, num_groups: int = 32, eps: float = 1e-5):
    return fold_stats(token_stats(x), scale, bias, x.shape[1], num_groups, eps)


# ----------------------------------------------------- token permutations

@functools.lru_cache(maxsize=64)
def shift_permutation(h: int, w: int, ws: int, shift: int) -> tuple[np.ndarray, np.ndarray]:
    """roll(-shift) + re-partition as a permutation of window-major tokens:
    `perm[j]` is the unshifted-layout index of the token at shifted-layout
    position j.  Returns (perm, inv_perm).  The kernels compute the same
    index on the fly: perm(j) is the window-major index of spatial
    ((r + shift) mod h, (c + shift) mod w), inv(j) that of
    ((r - shift) mod h, (c - shift) mod w), where (r, c) is token j."""
    base = np.arange(h * w).reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1)
    inv0 = np.empty_like(base)
    inv0[base] = np.arange(base.size)
    r, c = base // w, base % w
    perm = inv0[((r + shift) % h) * w + (c + shift) % w]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv


def shift_fuse_fits(wd: int, ws: int) -> bool:
    """Whether a shifted block at a map `wd` tokens wide absorbs the shift
    into kernels A and B (rows of at most 1024 tokens); wider maps take
    kernel E (ops/shift.py) around the unshifted A and B.  This mirrors the
    JAX package's dispatch (`swin_block_pallas.shift_fuse_fits`, a TPU VMEM
    limit), so that both packages take the same route; it is not an H100
    limit: A and B read through the roll at any width."""
    return wd * ws <= 1024


def _take(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return x[:, torch.as_tensor(idx, device=x.device)]


# --------------------------------------------------------- plain versions

def norm_attn_residual_plain(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask,
                             num_heads: int, n_win: int) -> torch.Tensor:
    """x + proj(softmax(q k^T hd^-1/2 + B) v), q, k, v = (x*w + b) Wqkv + bqkv.
    x: (B, T, C); bias_mask: (nW or 1, nh, N, N) f32; softmax in f32."""
    bsz, t, c = x.shape
    xn = (x.float() * w[:, None] + b[:, None]).to(x.dtype)
    out = window_attention_plain(xn.reshape(bsz * t // n_win, n_win, c), wqkv, bqkv, wproj,
                                 bproj, bias_mask, num_heads)
    return x + out.reshape(bsz, t, c)


def norm_mlp_residual_plain(x, w, b, w1, b1, w2, b2) -> torch.Tensor:
    """x + fc2(GELU_erf(fc1(x*w + b)))."""
    dt = x.dtype
    xn = (x.float() * w[:, None] + b[:, None]).to(dt)
    h = F.gelu(xn @ w1.to(dt) + b1.to(dt))
    return x + (h @ w2.to(dt) + b2.to(dt))


def norm_attn_residual_stats_plain(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask,
                                   num_heads, n_win):
    y = norm_attn_residual_plain(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask,
                                 num_heads, n_win)
    return (y,) + token_stats(y)


def shift_attn_residual_stats_plain(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask,
                                    num_heads, n_win, h, wd, ws, shift):
    """Attention on the shifted layout; the output stays shifted."""
    perm, _ = shift_permutation(h, wd, ws, shift)
    return norm_attn_residual_stats_plain(_take(x, perm), w, b, wqkv, bqkv, wproj,
                                          bproj, bias_mask, num_heads, n_win)


def norm_mlp_residual_stats_plain(x, w, b, w1, b1, w2, b2):
    y = norm_mlp_residual_plain(x, w, b, w1, b1, w2, b2)
    return (y,) + token_stats(y)


def mlp_unshift_residual_stats_plain(y, w, b, w1, b1, w2, b2, h, wd, ws, shift):
    """Undo the shift, then the MLP half (pointwise over tokens, so the
    permutation commutes past it)."""
    _, inv = shift_permutation(h, wd, ws, shift)
    return norm_mlp_residual_stats_plain(_take(y, inv), w, b, w1, b1, w2, b2)


# ------------------------------------------------------------- dispatch

def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return False


def _cast(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return t.to(dt).contiguous()


def _check_tokens(x: torch.Tensor):
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("tokens must be a contiguous (B, T, C) tensor")
    return x.shape


def _geometry(t: int, n_win: int, geom):
    if geom is None:
        return 0, 0, 0, 0
    h, wd, ws, shift = geom
    if h * wd != t or ws * ws != n_win or h % ws or wd % ws or not 0 < shift < ws:
        raise ValueError(f"bad shift geometry {geom} for T={t}, N={n_win}")
    return ws, h, wd, shift


def attn_route(dtype: torch.dtype, n_win: int, c: int, num_heads: int) -> str:
    """Which route of kernel A takes windows of `n_win` tokens x `c`
    channels in `num_heads` heads: "tc" (bf16, `swin_window_attn_tc`: C %
    16 == 0 and head width 16 or 32) or "fma" (f32, `swin_window_attn`: any
    head width up to 64).  Both take n_win <= 64 and C <= 256.  Raises
    ValueError for shapes the dtype's route does not take, TypeError for
    other dtypes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"swin_window_attn takes float32 or bfloat16, not {dtype}")
    hd = c // num_heads if num_heads > 0 and c % num_heads == 0 else 0
    tc = dtype == torch.bfloat16
    if not (0 < n_win <= 64 and 0 < c <= 256 and 0 < hd <= 64) or (tc and (c % 16 or
                                                                          hd not in (16, 32))):
        raise ValueError(f"swin_window_attn: no {dtype} route for N={n_win}, C={c}, "
                         f"heads={num_heads}")
    return "tc" if tc else "fma"


def _attn_kernel(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask, num_heads, n_win, geom):
    bsz, t, c = _check_tokens(x)
    route = attn_route(x.dtype, n_win, c, num_heads)
    nwin_img = t // n_win
    nwb = bias_mask.shape[0]
    if (t % n_win or bias_mask.shape != (nwb, num_heads, n_win, n_win)
            or nwb not in (1, nwin_img)):
        raise ValueError("swin_window_attn: unsupported shapes "
                         f"x={tuple(x.shape)} heads={num_heads} N={n_win} bias={tuple(bias_mask.shape)}")
    ws, h, wd, shift = _geometry(t, n_win, geom)
    dt = x.dtype
    args = [_cast(a, torch.float32) for a in (w, b)]
    args += [_cast(a, dt) for a in (wqkv, bqkv, wproj, bproj)]
    bm = _cast(bias_mask, torch.float32)
    if route == "tc":  # cp.async of the rows and weights, pairs of the biases
        x, bm = _ext.aligned16(x), _ext.aligned16(bm)
        args[2:] = [_ext.aligned16(a) for a in args[2:]]
    y = torch.empty_like(x)
    part = torch.empty(2, bsz, nwin_img, c, dtype=torch.float32, device=x.device)
    stats = torch.empty(2, bsz, c, dtype=torch.float32, device=x.device)
    ptrs = [x.data_ptr(), *(a.data_ptr() for a in args), bm.data_ptr(), y.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr()]
    variant = "shift" if geom else "plain"
    if route == "tc":
        SWIN_WINDOW_ATTN_TC(*ptrs, bsz, t, c, num_heads, n_win, nwb, ws, h, wd, shift,
                            device=x.device, variant=variant)
    else:
        SWIN_WINDOW_ATTN(*ptrs, _ext.dtype_code(dt), bsz, t, c, num_heads, n_win, nwb, ws, h, wd,
                         shift, device=x.device, variant=variant)
    return y, stats[0], stats[1]


def _mlp_kernel(x, w, b, w1, b1, w2, b2, geom):
    bsz, t, c = _check_tokens(x)
    hidden = w1.shape[1]
    dt = x.dtype
    tc = dt == torch.bfloat16  # the tensor-core route takes C % 16 == 0
    if (c > 256 or w1.shape != (c, hidden) or w2.shape != (hidden, c) or hidden % 64
            or (tc and c % 16)):
        raise ValueError(f"swin_mlp: unsupported shapes x={tuple(x.shape)} w1={tuple(w1.shape)}"
                         f" for {dt}")
    ws, h, wd, shift = (0, 0, 0, 0) if geom is None else _geometry(t, geom[2] ** 2, geom)
    args = [_cast(a, torch.float32) for a in (w, b)]
    args += [_cast(a, dt) for a in (w1, b1, w2, b2)]
    if tc:
        x, args[2], args[4] = (_ext.aligned16(a) for a in (x, args[2], args[4]))
    y = torch.empty_like(x)
    nparts = -(-t // _ROWS)
    part = torch.empty(2, bsz, nparts, c, dtype=torch.float32, device=x.device)
    stats = torch.empty(2, bsz, c, dtype=torch.float32, device=x.device)
    ptrs = [x.data_ptr(), *(a.data_ptr() for a in args), y.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr()]
    variant = "unshift" if geom else "plain"
    if tc:
        SWIN_MLP_TC(*ptrs, bsz, t, c, hidden, ws, h, wd, shift, device=x.device,
                    variant=variant)
    else:  # float32; dtype_code raises for any other type
        SWIN_MLP(*ptrs, _ext.dtype_code(dt), bsz, t, c, hidden, ws, h, wd, shift,
                 device=x.device, variant=variant)
    return y, stats[0], stats[1]


def norm_attn_residual_stats(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask, num_heads, n_win):
    """Fused GN-affine + W-MSA + residual + output stats: (y, sum, sumsq)."""
    if _on_cpu(x):
        return norm_attn_residual_stats_plain(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask,
                                              num_heads, n_win)
    return _ext.Recompute.launch(functools.partial(_attn_kernel, geom=None),
                                norm_attn_residual_stats_plain, x, w, b, wqkv, bqkv, wproj,
                                bproj, bias_mask, num_heads, n_win)


def shift_attn_residual_stats(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask, num_heads, n_win,
                              h, wd, ws, shift):
    """As `norm_attn_residual_stats`, reading x (unshifted layout) through
    the SW-MSA roll; y is in the shifted layout."""
    if _on_cpu(x):
        return shift_attn_residual_stats_plain(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask,
                                               num_heads, n_win, h, wd, ws, shift)
    kernel = functools.partial(_attn_kernel, geom=(h, wd, ws, shift))
    return _ext.Recompute.launch(lambda *a: kernel(*a[:10]), shift_attn_residual_stats_plain,
                                x, w, b, wqkv, bqkv, wproj, bproj, bias_mask, num_heads, n_win,
                                h, wd, ws, shift)


def norm_mlp_residual_stats(x, w, b, w1, b1, w2, b2):
    """Fused GN-affine + fc1 + exact GELU + fc2 + residual + stats."""
    if _on_cpu(x):
        return norm_mlp_residual_stats_plain(x, w, b, w1, b1, w2, b2)
    return _ext.Recompute.launch(functools.partial(_mlp_kernel, geom=None),
                                norm_mlp_residual_stats_plain, x, w, b, w1, b1, w2, b2)


def mlp_unshift_residual_stats(y, w, b, w1, b1, w2, b2, h, wd, ws, shift):
    """As `norm_mlp_residual_stats` on y in the shifted layout, writing the
    unshifted layout."""
    if _on_cpu(y):
        return mlp_unshift_residual_stats_plain(y, w, b, w1, b1, w2, b2, h, wd, ws, shift)
    kernel = functools.partial(_mlp_kernel, geom=(h, wd, ws, shift))
    return _ext.Recompute.launch(lambda *a: kernel(*a[:7]), mlp_unshift_residual_stats_plain,
                                y, w, b, w1, b1, w2, b2, h, wd, ws, shift)
