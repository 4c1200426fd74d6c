"""Swin window-attention stage of the UNet.

  * BasicLayer = patch-embed 1x1 conv -> window partition (once) -> `depth`
    SwinTransformerBlocks on (B, T, C) window-major tokens (odd blocks
    shifted by ws // 2) -> window reverse -> patch-unembed 1x1 conv.
  * The window size and shift of a block follow the build-time resolution;
    the shifted-window mask follows the runtime map.
  * Norms are GroupNorm32 folded to a per-image affine; each block runs as
    the two fused halves of ops/swin_block.py.  A shifted block absorbs the
    shift into the attention half's read and the MLP half's write where
    `shift_fuse_fits` holds, as the JAX package does; on wider maps the
    token permutation of ops/shift.py runs before and after the attention
    half.
  * `patch_norm` adds a GroupNorm after each projection (patch_embed.norm,
    patch_unembed.norm); the first block's statistics are then those of
    the normalised tokens.
  * `use_pallas` is the JAX package's tri-state pin: None (auto) and True
    launch kernels A, B and E on a CUDA tensor; False runs the plain
    composition on every device (the JAX trainer's pin: the kernels'
    backward recomputes that composition anyway).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn

from ..ops import shift as shift_ops
from ..ops import swin_block as sb
from ..ops.swin_block import shift_permutation
from ..ops.window_attention import window_attention
from .layers import Conv2d, GroupNorm32, Linear

__all__ = ["window_partition_tokens", "window_reverse_tokens", "relative_position_index",
           "shift_permutation", "shifted_window_mask", "WindowAttention", "SwinTransformerBlock",
           "BasicLayer"]


def window_partition_tokens(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW*N, C) window-major tokens."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, -1, c)


def window_reverse_tokens(xt: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B, nW*N, C) -> (B, H, W, C)."""
    b, _, c = xt.shape
    x = xt.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=64)
def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def shifted_window_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws, ws*ws) additive mask of 0 / -100.

    Keeps the reference's quirks bit for bit, because the released weights
    were trained with them: its region labels index an NCHW (1,1,H,W) tensor
    with NHWC-style slices (so they partition the H axis only), and its mask
    tokens are flattened w-major."""
    img = np.zeros((1, 1, h, w))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt  # faithful: hs hits the size-1 dim
            cnt += 1
    win = img.reshape(1, 1, h // ws, ws, w // ws, ws)
    win = win.transpose(0, 2, 4, 3, 5, 1).reshape(-1, ws, ws, 1)
    win = win.transpose(0, 2, 3, 1).reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class _WindowAttentionParams(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int, dtype: torch.dtype,
                 qkv_bias: bool = True):
        super().__init__()
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = Linear(dim, 3 * dim, dtype=dtype, bias=qkv_bias)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.register_buffer("relative_position_index",
                             torch.as_tensor(relative_position_index(window_size).reshape(-1)),
                             persistent=False)


class WindowAttention(_WindowAttentionParams):
    """W-MSA / SW-MSA over (B*nW, N, C) windows, the reference's
    WindowAttention (swin_transformer.py:65-161) with its parameter layout.
    It runs `ops/window_attention.window_attention`: kernel K9 on a CUDA
    tensor, the plain version on a CPU one.  A custom `qk_scale` is folded
    into the q columns of the qkv weight and bias, as the JAX package does."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: float | None = None, dtype: torch.dtype = torch.float32):
        super().__init__(dim, window_size, num_heads, dtype, qkv_bias)
        self.num_heads, self.qk_scale, self.dtype = num_heads, qk_scale, dtype

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x: (B*nW, N, C); mask: (nW, N, N) additive (the shifted-window
        mask) or None."""
        _, n, c = x.shape
        nh, dt = self.num_heads, self.dtype
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(n, n, nh).permute(2, 0, 1)[None]
        if mask is not None:
            bias = bias + mask[:, None]
        wqkv = self.qkv.weight.t()
        bqkv = (self.qkv.bias if self.qkv.bias is not None
                else torch.zeros(3 * c, device=wqkv.device))
        if self.qk_scale is not None:
            ratio = torch.ones(3 * c, device=wqkv.device)
            ratio[:c] = self.qk_scale / (c // nh) ** -0.5
            wqkv, bqkv = wqkv * ratio, bqkv * ratio
        return window_attention(x, wqkv.to(dt), bqkv.to(dt), self.proj.weight.t().to(dt),
                                self.proj.bias.to(dt), bias.float(), nh)


class _MlpParams(nn.Module):
    """fc1 / fc2 as 1x1 convs, the reference's parameter layout."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Conv2d(dim, hidden, 1, dtype=dtype)
        self.fc2 = Conv2d(hidden, dim, 1, dtype=dtype)


def _dense(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A Linear or 1x1-conv weight as an (in, out) matrix in dtype `dt`."""
    return w.reshape(w.shape[0], w.shape[1]).t().to(dt)


class SwinTransformerBlock(nn.Module):
    """One Swin block on (B, T, C) tokens: (S)W-MSA half, then the MLP half."""

    def __init__(self, dim: int, build_resolution: int, num_heads: int, window_size: int = 8,
                 shift: bool = False, mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32,
                 use_pallas: bool | None = None):
        super().__init__()
        self.use_pallas = use_pallas
        ws = window_size
        shift_size = ws // 2 if shift else 0
        if build_resolution <= ws:
            shift_size, ws = 0, build_resolution
        self.ws, self.shift_size, self.num_heads, self.dtype = ws, shift_size, num_heads, dtype
        self.norm1 = GroupNorm32(dim)
        self.attn = _WindowAttentionParams(dim, ws, num_heads, dtype)
        self.norm2 = GroupNorm32(dim)
        self.mlp = _MlpParams(dim, int(dim * mlp_ratio), dtype)
        self._masks: dict = {}

    def _bias_mask(self, h: int, w: int) -> torch.Tensor:
        """Rel-pos bias (+ shift mask) as (nW or 1, nh, N, N) f32."""
        n, nh = self.ws * self.ws, self.num_heads
        table = self.attn.relative_position_bias_table
        bias = table[self.attn.relative_position_index].reshape(n, n, nh).permute(2, 0, 1)
        bias = bias.float()[None]
        if not self.shift_size:
            return bias
        key = (h, w, table.device)
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(
                shifted_window_mask(h, w, self.ws, self.shift_size), device=table.device)
        return bias + self._masks[key][:, None]

    def forward(self, xt: torch.Tensor, h: int, w: int, stats=None):
        """xt: (B, T, C) tokens; `stats` = their (sum, sumsq) if known.
        Returns (out, out_sum, out_sumsq)."""
        _, t, _ = xt.shape
        dt, nh, ws, shift = self.dtype, self.num_heads, self.ws, self.shift_size
        n = ws * ws
        bias_mask = self._bias_mask(h, w)
        attn, mlp = self.attn, self.mlp
        wqkv, bqkv = _dense(attn.qkv.weight, dt), attn.qkv.bias.to(dt)
        wproj, bproj = _dense(attn.proj.weight, dt), attn.proj.bias.to(dt)
        w1, b1 = _dense(mlp.fc1.weight, dt), mlp.fc1.bias.to(dt)
        w2, b2 = _dense(mlp.fc2.weight, dt), mlp.fc2.bias.to(dt)
        if stats is None:
            stats = sb.token_stats(xt)
        # a token permutation keeps per-image statistics, so the affines hold
        # in either layout
        wa, ba = sb.fold_stats(stats, self.norm1.weight, self.norm1.bias, t)
        # the pin False: the plain composition on every device (the plain
        # versions of both routes are the same gathers and products)
        plain = self.use_pallas is False
        if shift and sb.shift_fuse_fits(w, ws):
            shift_attn_half = (sb.shift_attn_residual_stats_plain if plain
                               else sb.shift_attn_residual_stats)
            unshift_mlp_half = (sb.mlp_unshift_residual_stats_plain if plain
                                else sb.mlp_unshift_residual_stats)
            y, ys, yq = shift_attn_half(xt, wa, ba, wqkv, bqkv, wproj, bproj, bias_mask, nh, n,
                                        h, w, ws, shift)
            wm, bm = sb.fold_stats((ys, yq), self.norm2.weight, self.norm2.bias, t)
            return unshift_mlp_half(y, wm, bm, w1, b1, w2, b2, h, w, ws, shift)
        # wider shifted maps: kernel E permutes around the unshifted halves
        attn_half = sb.norm_attn_residual_stats_plain if plain else sb.norm_attn_residual_stats
        mlp_half = sb.norm_mlp_residual_stats_plain if plain else sb.norm_mlp_residual_stats
        shift_fn = shift_ops.shift_tokens_plain if plain else shift_ops.shift_tokens
        xs = shift_fn(xt, h, w, ws, shift) if shift else xt
        y, ys, yq = attn_half(xs, wa, ba, wqkv, bqkv, wproj, bproj, bias_mask, nh, n)
        if shift:
            y = shift_fn(y, h, w, ws, shift, inverse=True)
        wm, bm = sb.fold_stats((ys, yq), self.norm2.weight, self.norm2.bias, t)
        return mlp_half(y, wm, bm, w1, b1, w2, b2)


class _Proj(nn.Module):
    def __init__(self, cin: int, cout: int, dtype: torch.dtype, norm: bool = False):
        super().__init__()
        self.proj = Conv2d(cin, cout, 1, dtype=dtype)
        self.norm = GroupNorm32(cout) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x)
        return x if self.norm is None else self.norm(x)


class BasicLayer(nn.Module):
    """Patch-embed -> window partition -> Swin blocks -> window reverse ->
    patch-unembed (patch size 1), each projection followed by a GroupNorm
    where `patch_norm`."""

    def __init__(self, in_chans: int, embed_dim: int, num_heads: int, window_size: int,
                 depth: int = 2, build_resolution: int = 64, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, use_pallas: bool | None = None,
                 patch_norm: bool = False):
        super().__init__()
        self.ws = build_resolution if build_resolution <= window_size else window_size
        self.patch_embed = _Proj(in_chans, embed_dim, dtype, patch_norm)
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(embed_dim, build_resolution, num_heads, window_size,
                                 shift=(i % 2 == 1), mlp_ratio=mlp_ratio, dtype=dtype,
                                 use_pallas=use_pallas)
            for i in range(depth)])
        self.patch_unembed = _Proj(embed_dim, in_chans, dtype, patch_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W)."""
        x = self.patch_embed(x)
        _, _, h, w = x.shape
        ws = self.ws
        if h % ws or w % ws:
            raise ValueError(f"{(h, w)} not divisible by window {ws}")
        # one window is a strided view of an NCHW map: the kernels take
        # contiguous tokens
        xt = window_partition_tokens(x.permute(0, 2, 3, 1), ws).contiguous()
        stats = None  # the first block computes them; the kernels emit the rest
        for blk in self.blocks:
            xt, *stats = blk(xt, h, w, stats)
        x = window_reverse_tokens(xt, ws, h, w).permute(0, 3, 1, 2)
        return self.patch_unembed(x)
