"""UNetModelSwin, the ResShift denoiser (NHWC at its public forward).

  * conv-in -> per level [ResBlock x n, a Swin BasicLayer after the first
    block of each level whose resolution is in `attention_resolutions`] ->
    Downsample; middle = ResBlock, BasicLayer, ResBlock; the decoder mirrors
    it with skip concatenation and Upsample;
  * timestep MLP: sinusoidal(model_channels) -> Linear(4x) -> SiLU -> Linear;
  * LQ conditioning: the LQ image (and the mask channel, concatenated
    first) goes through a strided-conv `feature_extractor` when lq_size >
    image_size (log2(lq_size / image_size) levels of conv3x3 to 16 * 2^i
    channels, SiLU, stride-2 conv to twice that), else as it is, and is
    channel-concatenated with x_t;
  * the head (GN, SiLU, 3x3 conv) runs in the input dtype, float32;
  * the options of the JAX model: `resblock_updown` (a ResBlock with `down`
    / `up` in place of each Downsample / Upsample), `conv_resample=False`
    (average pool / nearest 2x without a conv), `use_scale_shift_norm=False`
    (the embedding added before the second GN) and `patch_norm` (a
    GroupNorm after each Swin projection).
`use_pallas` (the config key `model.use_pallas`) is the JAX package's
tri-state pin: None (the default) launches kernels A, B and E in the Swin
blocks on a CUDA tensor and leaves kernel F off; True launches F in the
head as well, as the JAX pin launches K8 there; False runs the plain
composition on every device, with no kernel at all (what the JAX trainer
trains through).  `clone(use_pallas=...)` gives a module that shares every
parameter with this one under another pin.
`size_multiple` is the latent side that the downsamplings and the Swin
windows divide.
Module names follow the reference's state_dict (input_blocks.N.M, ...).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import tail
from .layers import (Conv2d, Downsample, GroupNorm32, Linear, ResBlock, Upsample, pinned_clone,
                     timestep_embedding)
from .swin import BasicLayer

__all__ = ["UNetModelSwin"]


class UNetModelSwin(nn.Module):
    def __init__(self, image_size: int = 64, in_channels: int = 3, model_channels: int = 160,
                 out_channels: int = 3, num_res_blocks: Sequence[int] | int = (2, 2, 2, 2),
                 attention_resolutions: Sequence[int] = (64, 32, 16, 8), dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 2, 4), conv_resample: bool = True,
                 num_heads: int = 1, num_head_channels: int = 32,
                 use_scale_shift_norm: bool = True, resblock_updown: bool = False,
                 swin_depth: int = 2, swin_embed_dim: int = 192, window_size: int = 8,
                 mlp_ratio: float = 4.0, patch_norm: bool = False, cond_lq: bool = True,
                 cond_mask: bool = False, lq_size: int = 64,
                 dtype: torch.dtype = torch.float32, use_pallas: bool | None = None):
        super().__init__()
        nrb = [num_res_blocks] * len(channel_mult) if isinstance(num_res_blocks, int) \
            else list(num_res_blocks)
        mc, ted = model_channels, model_channels * 4
        heads = num_heads if num_head_channels == -1 else swin_embed_dim // num_head_channels
        self.dtype, self.model_channels = dtype, model_channels
        self.use_pallas = use_pallas
        self.cond_lq, self.cond_mask = cond_lq, cond_mask
        self.size_multiple = 2 ** (len(channel_mult) - 1)

        def swin(ch, ds):
            # a level built at ds runs at the latent's 1 / (image_size / ds)
            self.size_multiple = math.lcm(self.size_multiple,
                                          image_size // ds * min(window_size, ds))
            return BasicLayer(ch, swin_embed_dim, heads, window_size, swin_depth,
                              build_resolution=ds, mlp_ratio=mlp_ratio, dtype=dtype,
                              use_pallas=use_pallas, patch_norm=patch_norm)

        def res(cin, cout, **updown):
            return ResBlock(cin, ted, dropout, cout, dtype=dtype,
                            use_scale_shift_norm=use_scale_shift_norm, **updown)

        def resample(ch, up):
            if resblock_updown:
                return res(ch, ch, up=up, down=not up)
            return (Upsample if up else Downsample)(ch, ch, dtype=dtype, use_conv=conv_resample)

        self.time_embed = nn.Sequential(Linear(mc, ted, dtype=dtype), nn.SiLU(),
                                        Linear(ted, ted, dtype=dtype))
        cin = in_channels
        self.feature_extractor = None
        if cond_lq:
            lq_ch = 3 + (1 if cond_mask else 0)
            levels = int(math.log2(lq_size / image_size))
            if levels:  # conv3x3 -> SiLU -> stride-2 conv, per level
                fe, base = [], 16
                for _ in range(levels):
                    fe += [Conv2d(lq_ch, base, 3, padding=1, dtype=dtype), nn.SiLU(),
                           Downsample(base, 2 * base, dtype=dtype)]
                    lq_ch, base = 2 * base, 2 * base
                self.feature_extractor = nn.Sequential(*fe)
            cin += lq_ch
        ch = int(channel_mult[0] * mc)
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(cin, ch, 3, padding=1,
                                                                 dtype=dtype)])])
        chans = [ch]
        ds = image_size
        for level, mult in enumerate(channel_mult):
            for jj in range(nrb[level]):
                layers = [res(ch, int(mult * mc))]
                ch = int(mult * mc)
                if ds in attention_resolutions and jj == 0:
                    layers.append(swin(ch, ds))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([resample(ch, up=False)]))
                chans.append(ch)
                ds //= 2
        self.middle_block = nn.ModuleList([res(ch, ch), swin(ch, ds), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(nrb[level] + 1):
                layers = [res(ch + chans.pop(), int(mult * mc))]
                ch = int(mult * mc)
                if ds in attention_resolutions and i == 0:
                    layers.append(swin(ch, ds))
                if level and i == nrb[level]:
                    layers.append(resample(ch, up=True))
                    ds *= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 Conv2d(ch, out_channels, 3, padding=1, dtype=torch.float32))
        nn.init.zeros_(self.out[2].weight)
        nn.init.zeros_(self.out[2].bias)

    def clone(self, use_pallas: bool | None) -> "UNetModelSwin":
        """This module under the pin `use_pallas`: new module objects holding
        the same parameter and buffer tensors (an update of either is an
        update of both), as Flax's `clone(use_pallas=...)` keeps one param
        tree.  Its train/eval mode is its own."""
        return pinned_clone(self, use_pallas)

    @staticmethod
    def _run(layers: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        for layer in layers:
            h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
        return h

    def forward(self, x: torch.Tensor | None, timesteps: torch.Tensor | None,
                lq: torch.Tensor | None = None, mask: torch.Tensor | None = None,
                lq_feat: torch.Tensor | None = None,
                features_only: bool = False) -> torch.Tensor:
        """x: (B, H, W, C) latent, timesteps: (B,), lq: (B, lq_size-scaled
        H, W, 3), mask: (B, ..., 1) -> (B, H, W, out).  The LQ features do
        not depend on the timestep: `features_only=True` returns them (x and
        timesteps may be None) and `lq_feat=` takes them back in place of
        lq and mask, so that a sampler computes them once per call."""
        if lq is not None and lq_feat is None:
            if not self.cond_lq or (mask is not None and not self.cond_mask):
                raise ValueError("this model takes no LQ image or no mask")
            lq_feat = (lq if mask is None else torch.cat([lq, mask], dim=-1)).to(self.dtype)
            if self.feature_extractor is not None:
                lq_feat = self.feature_extractor(lq_feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if features_only:
            return lq_feat
        dt = self.dtype
        in_dtype = x.dtype
        emb = self.time_embed[2](F.silu(
            self.time_embed[0](timestep_embedding(timesteps, self.model_channels))))
        parts = [x.to(dt)] + ([] if lq_feat is None else [lq_feat.to(dt)])
        h = torch.cat(parts, dim=-1).permute(0, 3, 1, 2)
        hs = []
        for blk in self.input_blocks:
            h = self._run(blk, h, emb)
            hs.append(h)
        h = self._run(self.middle_block, h, emb)
        for blk in self.output_blocks:
            h = self._run(blk, torch.cat([h, hs.pop()], dim=1), emb)
        h = h.to(in_dtype).float()
        out = tail.gn_silu_conv3x3(h, self.out[0].weight, self.out[0].bias, self.out[2].weight,
                                   self.out[2].bias, eps=1e-5,
                                   use_pallas=self.use_pallas is True)
        return out.permute(0, 2, 3, 1)
