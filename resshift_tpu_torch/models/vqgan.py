"""VQGAN autoencoder (f4 and f8) and the KL autoencoder — NHWC at
`encode`/`decode`, NCHW inside.

  * Encoder/Decoder conv backbones with GroupNorm eps 1e-6 and SiLU; the
    strided downsample conv pads asymmetrically (0, 1); with
    `resamp_with_conv=False` the resampling is a 2x2 average pool / nearest
    2x.  `double_z` gives the encoder 2 * z_channels outputs (the KL
    moments).
  * Both keep one full single-head self-attention block at the bottleneck
    (`mid.attn_1`), and one after each ResnetBlock of a level whose
    resolution is in `attn_resolutions` (`down.i.attn.j`, `up.i.attn.j`):
    on a CUDA tensor each runs kernel C for every N; on the CPU the dense
    plain form, or the query-chunked form above `chunk_threshold` tokens.
  * VectorQuantizer: nearest code (kernel D on a CUDA tensor), then a gather.
    `encode` returns the pre-quantization latent; `decode` quantizes first.
  * The decoder tail (GN, SiLU, conv_out) goes through ops/tail.py.
  * AutoencoderKL: `quant_conv` to 2 * embed_dim moments (mean, logvar
    clipped to [-30, 20]); `encode` gives the mode, or a posterior sample
    where a generator or the noise itself is given.  IdentityFirstStage is
    the first stage of pixel-space diffusion (the pipeline's `autoencoder:
    null`).
  * `use_pallas` is the JAX package's tri-state switch, threaded to every
    AttnBlock, the VectorQuantizer and the decoder tail: None (the default)
    launches C and D on a CUDA tensor and leaves F off; True launches F in
    the decoder tail as well; False runs the plain versions of all three
    on any device (the train step's decode under autograd, through
    `clone(use_pallas=False)`, since C has no backward).
Module names follow the reference's state_dict (encoder.down.0.block.0...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import flash_attention, tail, vq
from .layers import Conv2d, GroupNorm32, pinned_clone, upsample_nearest2x

__all__ = ["ResnetBlock", "AttnBlock", "Downsample", "Upsample", "Encoder", "Decoder",
           "VectorQuantizer", "VQModel", "AutoencoderKL", "IdentityFirstStage"]


def _norm(c: int) -> GroupNorm32:
    return GroupNorm32(c, eps=1e-6)


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = out_channels or in_channels
        self.norm1 = _norm(in_channels)
        self.conv1 = Conv2d(in_channels, out_ch, 3, padding=1, dtype=dtype)
        self.norm2 = _norm(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, dtype=dtype)
        self.nin_shortcut = (None if in_channels == out_ch
                             else Conv2d(in_channels, out_ch, 1, dtype=dtype))

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over all pixels."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32,
                 chunk_threshold: int = 16384, use_pallas: bool | None = None):
        super().__init__()
        self.chunk_threshold = chunk_threshold
        self.use_pallas = use_pallas
        self.norm = _norm(in_channels)
        self.q = Conv2d(in_channels, in_channels, 1, dtype=dtype)
        self.k = Conv2d(in_channels, in_channels, 1, dtype=dtype)
        self.v = Conv2d(in_channels, in_channels, 1, dtype=dtype)
        self.proj_out = Conv2d(in_channels, in_channels, 1, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q, k, v = (m(hn).reshape(b, c, h * w).transpose(1, 2) for m in (self.q, self.k, self.v))
        big = h * w > self.chunk_threshold
        if self.use_pallas is False or (big and _on_cpu(q)):
            out = (flash_attention.chunked_attention_plain(q, k, v, chunk=4096) if big
                   else flash_attention.attention_plain(q, k, v))
        else:
            out = flash_attention.flash_attention_1h(q, k, v)
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Asymmetric-pad stride-2 3x3 conv (`with_conv`), else a 2x2 average pool."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32,
                 with_conv: bool = True):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, stride=2, dtype=dtype) if with_conv \
            else None

    def forward(self, x):
        if self.conv is None:
            return F.avg_pool2d(x, 2)
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv (`with_conv`)."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32,
                 with_conv: bool = True):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1, dtype=dtype) if with_conv \
            else None

    def forward(self, x):
        x = upsample_nearest2x(x)
        return x if self.conv is None else self.conv(x)


def _nrb(num_res_blocks, n: int) -> list[int]:
    return [num_res_blocks] * n if isinstance(num_res_blocks, int) else list(num_res_blocks)


def _attn_list(n: int, at_res: bool, channels: int, dtype, use_pallas) -> nn.ModuleList:
    """A level's AttnBlocks, one after each ResnetBlock where the level's
    resolution is in `attn_resolutions`, else none."""
    return nn.ModuleList([AttnBlock(channels, dtype, use_pallas=use_pallas)
                          for _ in range(n if at_res else 0)])


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: Sequence[int] | int = 2, in_channels: int = 3,
                 z_channels: int = 3, dtype: torch.dtype = torch.float32,
                 use_pallas: bool | None = None, attn_resolutions: Sequence[int] = (),
                 resolution: int = 256, double_z: bool = False, resamp_with_conv: bool = True):
        super().__init__()
        nrb = _nrb(num_res_blocks, len(ch_mult))
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, dtype=dtype)
        in_ch_mult = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList()
        curr_res = resolution
        for i, mult in enumerate(ch_mult):
            block_in, block_out = ch * in_ch_mult[i], ch * mult
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(nrb[i]):
                level.block.append(ResnetBlock(block_in, block_out, dtype))
                block_in = block_out
            level.attn = _attn_list(nrb[i], curr_res in attn_resolutions, block_in, dtype,
                                    use_pallas)
            if i != len(ch_mult) - 1:
                level.downsample = Downsample(block_in, dtype, resamp_with_conv)
                curr_res //= 2
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, dtype=dtype)
        self.mid.attn_1 = AttnBlock(block_in, dtype, use_pallas=use_pallas)
        self.mid.block_2 = ResnetBlock(block_in, dtype=dtype)
        self.norm_out = _norm(block_in)
        self.conv_out = Conv2d(block_in, 2 * z_channels if double_z else z_channels, 3,
                               padding=1, dtype=dtype)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for j, blk in enumerate(level.block):
                h = blk(h)
                if level.attn:
                    h = level.attn[j](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: Sequence[int] | int = 2, z_channels: int = 3,
                 dtype: torch.dtype = torch.float32, use_pallas: bool | None = None,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256,
                 resamp_with_conv: bool = True):
        super().__init__()
        nrb = _nrb(num_res_blocks, len(ch_mult))
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (len(ch_mult) - 1)
        self.use_pallas = use_pallas
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1, dtype=dtype)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, dtype=dtype)
        self.mid.attn_1 = AttnBlock(block_in, dtype, use_pallas=use_pallas)
        self.mid.block_2 = ResnetBlock(block_in, dtype=dtype)
        levels = []
        for i in reversed(range(len(ch_mult))):
            block_out = ch * ch_mult[i]
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(nrb[i] + 1):
                level.block.append(ResnetBlock(block_in, block_out, dtype))
                block_in = block_out
            level.attn = _attn_list(nrb[i] + 1, curr_res in attn_resolutions, block_in, dtype,
                                    use_pallas)
            if i != 0:
                level.upsample = Upsample(block_in, dtype, resamp_with_conv)
                curr_res *= 2
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)  # up[i] is level i; run from the last
        self.norm_out = _norm(block_in)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1, dtype=dtype)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for j, blk in enumerate(level.block):
                h = blk(h)
                if level.attn:
                    h = level.attn[j](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return tail.gn_silu_conv3x3(h, self.norm_out.weight, self.norm_out.bias,
                                    self.conv_out.weight, self.conv_out.bias, eps=1e-6,
                                    use_pallas=self.use_pallas is True)


class VectorQuantizer(nn.Module):
    """L2-nearest codebook entry with the straight-through form
    z + stop_gradient(q - z)."""

    def __init__(self, n_e: int = 8192, e_dim: int = 3, use_pallas: bool | None = None):
        super().__init__()
        self.e_dim = e_dim
        self.use_pallas = use_pallas
        self.embedding = nn.Embedding(n_e, e_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_e, 1.0 / n_e)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z: (..., e_dim) channels-last."""
        zf = z.float()
        emb = self.embedding.weight.float()
        search = (vq.nearest_codebook_indices_plain if self.use_pallas is False
                  else vq.nearest_codebook_indices)
        idx = search(zf.reshape(-1, self.e_dim), emb)
        z_q = emb[idx].reshape(zf.shape)
        # straight-through: the value of z_q, the gradient of z (identity);
        # the codebook gets none, as JAX's stop_gradient gives
        return (zf + (z_q - zf).detach()).to(z.dtype)


def _backbone_kwargs(dd: dict, dtype: torch.dtype) -> dict:
    """The keys of a `ddconfig` that both the encoder and the decoder take
    (`double_z`, `dropout` and the channel counts of the ends aside)."""
    return dict(ch=dd["ch"], ch_mult=dd["ch_mult"], num_res_blocks=dd["num_res_blocks"],
                z_channels=dd["z_channels"], attn_resolutions=dd.get("attn_resolutions") or (),
                resolution=dd.get("resolution", 256),
                resamp_with_conv=dd.get("resamp_with_conv", True), dtype=dtype)


class VQModel(nn.Module):
    """encode returns the pre-quantization latent; decode quantizes first.
    Both take and return NHWC.  `double_z` is ignored, as the JAX model
    ignores it: the VQ encoder has z_channels outputs."""

    def __init__(self, ddconfig: dict, n_embed: int = 8192, embed_dim: int = 3,
                 dtype: torch.dtype = torch.float32, use_pallas: bool | None = None):
        super().__init__()
        dd = ddconfig
        self.use_pallas = use_pallas
        common = _backbone_kwargs(dd, dtype)
        self.encoder = Encoder(in_channels=dd.get("in_channels", 3), use_pallas=use_pallas,
                               **common)
        self.decoder = Decoder(out_ch=dd.get("out_ch", 3), use_pallas=use_pallas, **common)
        self.quantize = VectorQuantizer(n_embed, embed_dim, use_pallas=use_pallas)
        self.quant_conv = Conv2d(dd["z_channels"], embed_dim, 1, dtype=dtype)
        self.post_quant_conv = Conv2d(embed_dim, dd["z_channels"], 1, dtype=dtype)

    def clone(self, use_pallas: bool | None) -> "VQModel":
        """This module under the pin `use_pallas`: new module objects holding
        the same parameter and buffer tensors, as Flax's
        `clone(use_pallas=...)` keeps one param tree."""
        return pinned_clone(self, use_pallas)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return h.permute(0, 2, 3, 1)

    def decode(self, h: torch.Tensor) -> torch.Tensor:
        quant = self.quantize(h).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(quant)).permute(0, 2, 3, 1)


class AutoencoderKL(nn.Module):
    """The KL-regularised autoencoder: the encoder with `double_z` always on,
    `quant_conv` to (mean, logvar), `post_quant_conv` back to z_channels.
    NHWC in and out; `use_pallas` as VQModel's."""

    def __init__(self, ddconfig: dict, embed_dim: int = 4, dtype: torch.dtype = torch.float32,
                 use_pallas: bool | None = None):
        super().__init__()
        dd = ddconfig
        self.use_pallas = use_pallas
        common = _backbone_kwargs(dd, dtype)
        self.encoder = Encoder(in_channels=dd.get("in_channels", 3), use_pallas=use_pallas,
                               double_z=True, **common)
        self.decoder = Decoder(out_ch=dd.get("out_ch", 3), use_pallas=use_pallas, **common)
        self.quant_conv = Conv2d(2 * dd["z_channels"], 2 * embed_dim, 1, dtype=dtype)
        self.post_quant_conv = Conv2d(embed_dim, dd["z_channels"], 1, dtype=dtype)

    def clone(self, use_pallas: bool | None) -> "AutoencoderKL":
        """This module under the pin `use_pallas`, sharing its parameters."""
        return pinned_clone(self, use_pallas)

    def encode(self, x: torch.Tensor, generator: torch.Generator | None = None,
               sample_posterior: bool = True, return_moments: bool = False,
               noise: torch.Tensor | None = None):
        """x: (B, H, W, C) -> z: the posterior's mode, or mean + std * noise
        where `sample_posterior` and a `generator` (float32 standard normal
        noise drawn from it on x's device) or the `noise` itself is given.
        With `return_moments`, (z, moments), moments = (mean | logvar)
        before the clip."""
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        logvar = logvar.clamp(-30.0, 20.0)
        if sample_posterior and noise is None and generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        z = mean if not sample_posterior or noise is None else \
            mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        return (z, moments) if return_moments else z

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.decode(self.encode(x, generator))


class IdentityFirstStage(nn.Module):
    """The no-op first stage of pixel-space diffusion."""

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x
