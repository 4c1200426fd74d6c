"""Basic building blocks (NCHW inside, reference-layout parameter names).

  * GroupNorm32 computes its statistics in float32 and casts back to the
    input dtype (eps 1e-5; the VQGAN uses 1e-6); `group_norm_fold` gives
    the same normalisation as a per-(image, channel) affine.
  * timestep_embedding puts cos first, then sin.
  * ResBlock: GN-SiLU-conv3x3, FiLM scale-shift timestep injection (or,
    with `use_scale_shift_norm=False`, the embedding added before the
    second GN), output conv zero-initialised; `up` / `down` resample both
    paths after the first SiLU (nearest 2x / 2x2 average), `use_conv` makes
    a channel-changing skip a 3x3 conv.
  * Downsample = stride-2 3x3 conv (2x2 average pool with `use_conv=False`);
    Upsample = nearest 2x then a 3x3 conv (nearest 2x alone without
    `use_conv`).  The port keeps the literal nearest-2x + 3x3 composition;
    the JAX package's phase-decomposed upsample is a TPU rewrite of the
    same function.
Conv2d and Linear cast their input and parameters to the module's compute
dtype at use, as Flax modules with `dtype=` do.
"""

from __future__ import annotations

import copy
import itertools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.tail import group_norm_fold

__all__ = ["Conv2d", "Linear", "GroupNorm32", "group_norm_fold", "timestep_embedding", "ResBlock",
           "Upsample", "Downsample", "upsample_nearest2x", "pinned_clone"]


def pinned_clone(module: nn.Module, use_pallas: bool | None) -> nn.Module:
    """`module` under the pin `use_pallas`: new module objects holding the
    same parameter and buffer tensors (an update of either is an update of
    both), every `use_pallas` attribute set, as Flax's
    `clone(use_pallas=...)` keeps one param tree.  Its train/eval mode is
    its own."""
    memo = {id(t): t for t in itertools.chain(module.parameters(), module.buffers())}
    other = copy.deepcopy(module, memo)
    for mod in other.modules():
        if hasattr(mod, "use_pallas"):
            mod.use_pallas = use_pallas
    return other


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `compute_dtype` (input and parameters cast at use)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride,
                        self.padding)


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype`."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 bias: bool = True):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class GroupNorm32(nn.Module):
    """GroupNorm(32) with float32 statistics whatever the compute dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, num_groups: int = 32):
        super().__init__()
        self.num_groups = min(num_groups, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embeddings, cos first: (B,) -> (B, dim) float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv (`use_conv`), named `conv`."""

    def __init__(self, channels: int, out_channels: int | None = None,
                 dtype: torch.dtype = torch.float32, use_conv: bool = True):
        super().__init__()
        out_ch = out_channels or channels
        if not use_conv and out_ch != channels:
            raise ValueError("an Upsample without a conv keeps its channels")
        self.conv = Conv2d(channels, out_ch, 3, padding=1, dtype=dtype) if use_conv else None

    def forward(self, x):
        x = upsample_nearest2x(x)
        return x if self.conv is None else self.conv(x)


class Downsample(nn.Module):
    """Stride-2 3x3 conv named `op` (`use_conv`), else a 2x2 average pool."""

    def __init__(self, channels: int, out_channels: int | None = None,
                 dtype: torch.dtype = torch.float32, use_conv: bool = True):
        super().__init__()
        out_ch = out_channels or channels
        if not use_conv and out_ch != channels:
            raise ValueError("a Downsample without a conv keeps its channels")
        self.op = (Conv2d(channels, out_ch, 3, stride=2, padding=1, dtype=dtype) if use_conv
                   else None)

    def forward(self, x):
        return F.avg_pool2d(x, 2) if self.op is None else self.op(x)


class ResBlock(nn.Module):
    """UNet residual block with timestep injection.  The Sequential indices
    follow the reference's parameter names: in_layers.0 (GN), in_layers.2
    (conv), emb_layers.1 (linear), out_layers.0 (GN), out_layers.3 (conv,
    zero-initialised), skip_connection (1x1, or 3x3 with `use_conv`).
    `up` / `down` resample the normalised branch between the SiLU and the
    first conv, and the skip input, as the reference's h_upd / x_upd."""

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.0,
                 out_channels: int | None = None, dtype: torch.dtype = torch.float32,
                 use_conv: bool = False, use_scale_shift_norm: bool = True, up: bool = False,
                 down: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(),
                                       Conv2d(channels, out_ch, 3, padding=1, dtype=dtype))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch,
                              dtype=dtype))
        self.out_layers = nn.Sequential(GroupNorm32(out_ch), nn.SiLU(), nn.Dropout(dropout),
                                        Conv2d(out_ch, out_ch, 3, padding=1, dtype=dtype))
        nn.init.zeros_(self.out_layers[3].weight)
        nn.init.zeros_(self.out_layers[3].bias)
        self.skip_connection = (None if out_ch == channels
                                else Conv2d(channels, out_ch, 3 if use_conv else 1,
                                            padding=1 if use_conv else 0, dtype=dtype))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.in_layers[0](x))
        if self.up:
            h, x = upsample_nearest2x(h), upsample_nearest2x(x)
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers[1](F.silu(emb))[:, :, None, None].to(h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_layers[0](h) * (1 + scale) + shift
        else:
            h = self.out_layers[0](h + emb_out)
        h = self.out_layers[3](self.out_layers[2](F.silu(h)))
        skip = x if self.skip_connection is None else self.skip_connection(x)
        return skip + h
