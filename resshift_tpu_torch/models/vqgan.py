"""VQGAN autoencoder (f4 and f8) — NHWC at `encode`/`decode`, NCHW inside.

  * Encoder/Decoder conv backbones with GroupNorm eps 1e-6 and SiLU; the
    strided downsample conv pads asymmetrically (0, 1).
  * Both keep one full single-head self-attention block at the bottleneck
    (`mid.attn_1`) even with no attention resolutions: on a CUDA tensor it
    runs kernel C for every N; on the CPU the dense plain form, or the
    query-chunked form above `chunk_threshold` tokens.
  * VectorQuantizer: nearest code (kernel D on a CUDA tensor), then a gather.
    `encode` returns the pre-quantization latent; `decode` quantizes first.
  * The decoder tail (GN, SiLU, conv_out) goes through ops/tail.py.
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
           "VectorQuantizer", "VQModel"]


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
    """Asymmetric-pad stride-2 3x3 conv."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, stride=2, dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(upsample_nearest2x(x))


def _nrb(num_res_blocks, n: int) -> list[int]:
    return [num_res_blocks] * n if isinstance(num_res_blocks, int) else list(num_res_blocks)


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: Sequence[int] | int = 2, in_channels: int = 3,
                 z_channels: int = 3, dtype: torch.dtype = torch.float32,
                 use_pallas: bool | None = None):
        super().__init__()
        nrb = _nrb(num_res_blocks, len(ch_mult))
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, dtype=dtype)
        in_ch_mult = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList()
        for i, mult in enumerate(ch_mult):
            block_in, block_out = ch * in_ch_mult[i], ch * mult
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(nrb[i]):
                level.block.append(ResnetBlock(block_in, block_out, dtype))
                block_in = block_out
            if i != len(ch_mult) - 1:
                level.downsample = Downsample(block_in, dtype)
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, dtype=dtype)
        self.mid.attn_1 = AttnBlock(block_in, dtype, use_pallas=use_pallas)
        self.mid.block_2 = ResnetBlock(block_in, dtype=dtype)
        self.norm_out = _norm(block_in)
        self.conv_out = Conv2d(block_in, z_channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: Sequence[int] | int = 2, z_channels: int = 3,
                 dtype: torch.dtype = torch.float32, use_pallas: bool | None = None):
        super().__init__()
        nrb = _nrb(num_res_blocks, len(ch_mult))
        block_in = ch * ch_mult[-1]
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
            if i != 0:
                level.upsample = Upsample(block_in, dtype)
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)  # up[i] is level i; run from the last
        self.norm_out = _norm(block_in)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1, dtype=dtype)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
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


class VQModel(nn.Module):
    """encode returns the pre-quantization latent; decode quantizes first.
    Both take and return NHWC."""

    def __init__(self, ddconfig: dict, n_embed: int = 8192, embed_dim: int = 3,
                 dtype: torch.dtype = torch.float32, use_pallas: bool | None = None):
        super().__init__()
        dd = ddconfig
        self.use_pallas = use_pallas
        if dd.get("attn_resolutions") or dd.get("double_z"):
            raise NotImplementedError("this port covers attn_resolutions=[] and double_z=False")
        common = dict(ch=dd["ch"], ch_mult=dd["ch_mult"], num_res_blocks=dd["num_res_blocks"],
                      z_channels=dd["z_channels"], dtype=dtype)
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
