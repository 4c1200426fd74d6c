"""The reference's other denoisers, kept for ablations (NHWC at `forward`,
NCHW inside), as the JAX package's `models/unet_variants.py` has them.

  * `UNetModel`: the guided-diffusion UNet with global multi-head attention
    (`GlobalAttentionBlock`) at the attention resolutions, optional class
    conditioning `y`, and the LQ image concatenated to x_t (pixel-unshuffled
    when it is twice x_t's size).  Module names follow the reference's
    state_dict, which `convert.from_flax(..., "unet_plain")` produces.
  * `UNetModelConv`: the norm-free all-conv UNet, no attention.  Its quirk
    is kept: with `use_scale_shift_norm` the FiLM comes after a SiLU.  The
    JAX package has no converter for it; its names are the port's own
    (`from_flax(..., "unet_conv")`).
`in_channels` is the width of `conv_in`'s input, LQ channels included, as
the reference defines it (the JAX modules infer that width from the input).
The heads run in the input dtype, the last conv in float32.  Nothing here
launches a kernel: the JAX package computes this attention outside Pallas.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (Conv2d, Downsample, GroupNorm32, Linear, ResBlock, Upsample,
                     timestep_embedding, upsample_nearest2x)

__all__ = ["pixel_unshuffle", "attention_scale", "GlobalAttentionBlock", "UNetModel",
           "ResBlockConv", "UNetModelConv"]


def pixel_unshuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """F.pixel_unshuffle on NHWC: (B, H, W, C) -> (B, H/f, W/f, C*f*f), the
    channel c*f*f + fy*f + fx holding pixel (fy, fx) of channel c."""
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


class _Conv1x1d(nn.Conv1d):
    """The reference's 1-D 1x1 conv over tokens, applied as a dense layer
    on (B, T, C) in `compute_dtype`."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__(cin, cout, 1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight[:, :, 0].to(dt), self.bias.to(dt))


def attention_scale(hd: int, dtype: torch.dtype) -> torch.Tensor:
    """hd^-1/4 as the JAX block computes it: the fourth root in float32,
    rounded to `dtype`, then its reciprocal rounded again."""
    return 1 / torch.tensor(float(hd)).sqrt().sqrt().to(dtype)


class GlobalAttentionBlock(nn.Module):
    """GN -> 1x1 qkv -> multi-head attention over all pixels -> zero-initialised
    1x1 proj_out, residual.  `use_new_attention_order` picks the qkv layout:
    [q of all heads | k | v], else per head [q | k | v] (the legacy order).
    q and k are each scaled by hd^-1/4, rounded to the input dtype, as the
    JAX block rounds them; the softmax runs in float32."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 use_new_attention_order: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads if num_head_channels == -1 else channels // num_head_channels
        self.new_order = use_new_attention_order
        self.norm = GroupNorm32(channels)
        self.qkv = _Conv1x1d(channels, 3 * channels, dtype)
        self.proj_out = _Conv1x1d(channels, channels, dtype)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W)."""
        b, c, h, w = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(self.norm(x).flatten(2).transpose(1, 2))  # (B, T, 3C)
        if self.new_order:
            q, k, v = (t.reshape(b, h * w, nh, hd) for t in qkv.chunk(3, dim=-1))
        else:
            q, k, v = qkv.reshape(b, h * w, nh, 3 * hd).chunk(3, dim=-1)
        scale = attention_scale(hd, x.dtype)
        attn = torch.einsum("bthd,bshd->bhts", q * scale, k * scale)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = self.proj_out(torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, h * w, c))
        return x + out.transpose(1, 2).reshape(b, c, h, w)


def _nrb(num_res_blocks, n: int) -> list[int]:
    return [num_res_blocks] * n if isinstance(num_res_blocks, int) else list(num_res_blocks)


def _cat_lq(x: torch.Tensor, lq: torch.Tensor | None) -> torch.Tensor:
    """x_t with the LQ image concatenated (pixel-unshuffled where its size
    differs from x_t's), in x_t's dtype."""
    if lq is None:
        return x
    if lq.shape[1:3] != x.shape[1:3]:
        lq = pixel_unshuffle(lq, 2)
    return torch.cat([x, lq.to(x.dtype)], dim=-1)


class UNetModel(nn.Module):
    """The guided-diffusion UNet with global attention (input_blocks.N.M,
    middle_block, output_blocks, out, and label_emb with `num_classes`)."""

    def __init__(self, image_size: int = 64, in_channels: int = 3, model_channels: int = 160,
                 out_channels: int = 3, num_res_blocks: Sequence[int] | int = 2,
                 attention_resolutions: Sequence[int] = (32, 16, 8),
                 channel_mult: Sequence[int] = (1, 2, 4, 8), conv_resample: bool = True,
                 num_classes: int | None = None, num_heads: int = 1,
                 num_head_channels: int = -1, use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False, use_new_attention_order: bool = False,
                 cond_lq: bool = False, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nrb = _nrb(num_res_blocks, len(channel_mult))
        mc, ted = model_channels, model_channels * 4
        self.dtype, self.model_channels, self.cond_lq = dtype, model_channels, cond_lq

        def res(cin, cout, drop=0.0, **updown):  # dropout where the JAX model passes it
            return ResBlock(cin, ted, drop, cout, dtype=dtype,
                            use_scale_shift_norm=use_scale_shift_norm, **updown)

        def attn(ch):
            return GlobalAttentionBlock(ch, num_heads, num_head_channels,
                                        use_new_attention_order, dtype)

        def resample(ch, up):
            if resblock_updown:
                return res(ch, ch, up=up, down=not up)
            return (Upsample if up else Downsample)(ch, ch, dtype=dtype, use_conv=conv_resample)

        self.time_embed = nn.Sequential(Linear(mc, ted, dtype=dtype), nn.SiLU(),
                                        Linear(ted, ted, dtype=dtype))
        self.label_emb = nn.Embedding(num_classes, ted) if num_classes is not None else None
        ch = int(channel_mult[0] * mc)
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(in_channels, ch, 3, padding=1,
                                                                 dtype=dtype)])])
        chans, ds = [ch], image_size
        for level, mult in enumerate(channel_mult):
            for _ in range(nrb[level]):
                layers = [res(ch, int(mult * mc), dropout)]
                ch = int(mult * mc)
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([resample(ch, up=False)]))
                chans.append(ch)
                ds //= 2
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(nrb[level] + 1):
                layers = [res(ch + chans.pop(), int(mult * mc))]
                ch = int(mult * mc)
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == nrb[level]:
                    layers.append(resample(ch, up=True))
                    ds *= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 Conv2d(ch, out_channels, 3, padding=1, dtype=torch.float32))
        nn.init.zeros_(self.out[2].weight)
        nn.init.zeros_(self.out[2].bias)

    @staticmethod
    def _run(layers: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        for layer in layers:
            h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, y: torch.Tensor | None = None,
                lq: torch.Tensor | None = None) -> torch.Tensor:
        """x: (B, H, W, C), timesteps: (B,), y: (B,) class labels, lq: (B, H,
        W, 3) or (B, 2H, 2W, 3) -> (B, H, W, out) float32."""
        emb = self.time_embed[2](F.silu(
            self.time_embed[0](timestep_embedding(timesteps, self.model_channels))))
        if self.label_emb is not None:
            if y is None:
                raise ValueError("this model takes class labels y")
            emb = emb + self.label_emb.weight[y]
        if lq is not None and not self.cond_lq:
            raise ValueError("this model takes no LQ image")
        x = _cat_lq(x, lq)
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        hs = []
        for blk in self.input_blocks:
            h = self._run(blk, h, emb)
            hs.append(h)
        h = self._run(self.middle_block, h, emb)
        for blk in self.output_blocks:
            h = self._run(blk, torch.cat([h, hs.pop()], dim=1), emb)
        h = F.silu(self.out[0](h.to(x.dtype)))
        return self.out[2](h).permute(0, 2, 3, 1)


class ResBlockConv(nn.Module):
    """Norm-free residual block: SiLU -> (up / down) -> in_layers.1 (3x3) ->
    timestep injection (FiLM after a SiLU with `use_scale_shift_norm`, else
    SiLU of the sum) -> out_layers.2 (3x3, zero-initialised), plus the skip
    (identity, 1x1, or 3x3 with `use_conv`)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int | None = None,
                 use_conv: bool = False, use_scale_shift_norm: bool = False, up: bool = False,
                 down: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = out_channels or channels
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.in_layers = nn.Sequential(nn.SiLU(), Conv2d(channels, out_ch, 3, padding=1,
                                                         dtype=dtype))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch,
                              dtype=dtype))
        self.out_layers = nn.Sequential(nn.SiLU(), nn.Identity(),
                                        Conv2d(out_ch, out_ch, 3, padding=1, dtype=dtype))
        nn.init.zeros_(self.out_layers[2].weight)
        nn.init.zeros_(self.out_layers[2].bias)
        self.skip_connection = (None if out_ch == channels
                                else Conv2d(channels, out_ch, 3 if use_conv else 1,
                                            padding=1 if use_conv else 0, dtype=dtype))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = F.silu(x)
        if self.up:
            h, x = upsample_nearest2x(h), upsample_nearest2x(x)
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.in_layers[1](h)
        emb_out = self.emb_layers[1](F.silu(emb))[:, :, None, None].to(h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(h) * (1 + scale) + shift
        else:
            h = F.silu(h + emb_out)
        h = self.out_layers[2](h)
        skip = x if self.skip_connection is None else self.skip_connection(x)
        return skip + h


class UNetModelConv(nn.Module):
    """The norm-free all-conv UNet: input_blocks.N.0, middle_block.0 / .1,
    output_blocks.N.M, out.1 (SiLU then a float32 3x3 conv)."""

    def __init__(self, in_channels: int = 3, model_channels: int = 160, out_channels: int = 3,
                 num_res_blocks: Sequence[int] | int = 2,
                 channel_mult: Sequence[int] = (1, 2, 4, 8), conv_resample: bool = True,
                 use_scale_shift_norm: bool = False, resblock_updown: bool = False,
                 cond_lq: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        nrb = _nrb(num_res_blocks, len(channel_mult))
        mc, ted = model_channels, model_channels * 4
        self.dtype, self.model_channels, self.cond_lq = dtype, model_channels, cond_lq

        def res(cin, cout=None, **updown):
            return ResBlockConv(cin, ted, cout, use_scale_shift_norm=use_scale_shift_norm,
                                dtype=dtype, **updown)

        def resample(ch, up):
            if resblock_updown:
                return res(ch, ch, up=up, down=not up)
            return (Upsample if up else Downsample)(ch, ch, dtype=dtype, use_conv=conv_resample)

        self.time_embed = nn.Sequential(Linear(mc, ted, dtype=dtype), nn.SiLU(),
                                        Linear(ted, ted, dtype=dtype))
        ch = int(channel_mult[0] * mc)
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(in_channels, ch, 3, padding=1,
                                                                 dtype=dtype)])])
        chans = [ch]
        for level, mult in enumerate(channel_mult):
            for _ in range(nrb[level]):
                self.input_blocks.append(nn.ModuleList([res(ch, int(mult * mc))]))
                ch = int(mult * mc)
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([resample(ch, up=False)]))
                chans.append(ch)
        self.middle_block = nn.ModuleList([res(ch), res(ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(nrb[level] + 1):
                layers = [res(ch + chans.pop(), int(mult * mc))]
                ch = int(mult * mc)
                if level and i == nrb[level]:
                    layers.append(resample(ch, up=True))
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(nn.SiLU(), Conv2d(ch, out_channels, 3, padding=1,
                                                   dtype=torch.float32))

    @staticmethod
    def _run(layers: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        for layer in layers:
            h = layer(h, emb) if isinstance(layer, (ResBlockConv, ResBlock)) else layer(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                lq: torch.Tensor | None = None) -> torch.Tensor:
        """x: (B, H, W, C), timesteps: (B,), lq: (B, H, W, 3) or (B, 2H, 2W,
        3) -> (B, H, W, out) float32."""
        emb = self.time_embed[2](F.silu(
            self.time_embed[0](timestep_embedding(timesteps, self.model_channels))))
        if lq is not None and not self.cond_lq:
            raise ValueError("this model takes no LQ image")
        x = _cat_lq(x, lq)
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        hs = []
        for blk in self.input_blocks:
            h = self._run(blk, h, emb)
            hs.append(h)
        h = self._run(self.middle_block, h, emb)
        for blk in self.output_blocks:
            h = self._run(blk, torch.cat([h, hs.pop()], dim=1), emb)
        return self.out[1](F.silu(h.to(x.dtype))).permute(0, 2, 3, 1)
