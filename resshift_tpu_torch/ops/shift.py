"""The shifted-window token permutation of a Swin block, on (B, T, C)
window-major tokens, and its inverse.

Kernel E `shift_tokens` (csrc/shift_tokens.cu) replaces the TPU kernel
`shift_pallas.shift_tokens_pallas` (K7).  A shifted block takes it where
the shift is not absorbed into kernels A and B (`swin_block.shift_fuse_fits`
is false).  The wrapper runs the plain PyTorch gather for a CPU tensor,
launches the kernel for a CUDA tensor, and raises for anything else.  Its
gradient is kernel E again, inverted (`ShiftTokensFn`).
"""

from __future__ import annotations

import torch

from .. import _ext
from .._ext import I, P
from .swin_block import shift_permutation

__all__ = ["shift_tokens_plain", "shift_tokens", "ShiftTokensFn", "SHIFT_TOKENS"]

SHIFT_TOKENS = _ext.Kernel("shift_tokens", [P] * 2 + [I] * 9)


def shift_tokens_plain(x: torch.Tensor, h: int, w: int, ws: int, shift: int,
                       inverse: bool = False) -> torch.Tensor:
    """x[:, perm], or x[:, inv] when `inverse`, with
    perm, inv = shift_permutation(h, w, ws, shift)."""
    perm, inv = shift_permutation(h, w, ws, shift)
    return x[:, torch.as_tensor(inv if inverse else perm, device=x.device)]


def _kernel(x: torch.Tensor, h: int, w: int, ws: int, shift: int,
            inverse: bool) -> torch.Tensor:
    """Launch E on CUDA `x`."""
    if x.dim() != 3 or x.shape[1] != h * w or h % ws or w % ws or not 0 < shift < ws:
        raise ValueError(f"shift_tokens: bad geometry x={tuple(x.shape)} h={h} w={w} "
                         f"ws={ws} shift={shift}")
    _ext.dtype_code(x.dtype)  # f32 or bf16, else raises
    x = x.contiguous()
    y = torch.empty_like(x)
    b, t, c = x.shape
    SHIFT_TOKENS(x.data_ptr(), y.data_ptr(), x.element_size(), b, t, c, h, w, ws, shift,
                 int(inverse), device=x.device, variant="inv" if inverse else "fwd")
    return y


class ShiftTokensFn(torch.autograd.Function):
    """Forward: kernel E.  Backward: kernel E with `inverse` flipped (the
    gradient of a permutation is its inverse), as the JAX package's
    `_stp_bwd` calls K7 with `inverse` flipped."""

    @staticmethod
    def forward(ctx, x, h: int, w: int, ws: int, shift: int, inverse: bool):
        ctx.geom = (h, w, ws, shift, inverse)
        return _kernel(x, h, w, ws, shift, inverse)

    @staticmethod
    def backward(ctx, g):
        h, w, ws, shift, inverse = ctx.geom
        return _kernel(g, h, w, ws, shift, not inverse), None, None, None, None, None


def shift_tokens(x: torch.Tensor, h: int, w: int, ws: int, shift: int,
                 inverse: bool = False) -> torch.Tensor:
    """(B, h*w, C) tokens, f32 or bf16, to the shifted layout (roll by
    -shift, re-partition), or back when `inverse`."""
    if x.device.type == "cpu":
        return shift_tokens_plain(x, h, w, ws, shift, inverse)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        return ShiftTokensFn.apply(x, h, w, ws, shift, inverse)
    return _kernel(x, h, w, ws, shift, inverse)
