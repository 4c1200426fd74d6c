"""Single-head attention for the VQGAN middle `AttnBlock`.

Kernel C replaces the TPU kernel `flash_attention_pallas.flash_attention_1h`
in two routes, chosen by dtype: bf16 (the main path's) on the tensor cores
(`flash_attn_1h_tc`, csrc/flash_attn_1h_tc.cu), f32 on the FMA units
(`flash_attn_1h`, csrc/flash_attn_1h.cu).  The wrapper runs the plain
PyTorch version for a CPU tensor, launches the kernel of the tensor's
dtype for a CUDA tensor, and raises for anything else.  The JAX package
gives K5 no VJP, and C has no backward either: a launch that autograd
would record (grad mode on and an input requiring grad) raises
RuntimeError instead of returning a detached tensor.
"""

from __future__ import annotations

import torch

from .. import _ext
from .._ext import I, P

__all__ = ["attention_plain", "chunked_attention_plain", "flash_attention_1h", "FLASH_ATTN_1H",
           "FLASH_ATTN_1H_TC"]

FLASH_ATTN_1H = _ext.Kernel("flash_attn_1h", [P] * 4 + [I] * 4)  # f32, FMA
FLASH_ATTN_1H_TC = _ext.Kernel("flash_attn_1h_tc", [P] * 4 + [I] * 2)  # bf16, tensor cores


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    # q * C**-0.5 with the scalar rounded to q's dtype first, as JAX does
    scale = float(torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype))
    return q * scale


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(C)) v over (B, N, C): the dense form of the JAX
    AttnBlock (scores in the activation dtype, softmax in f32)."""
    attn = _scaled_q(q) @ k.transpose(1, 2)
    attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
    return attn @ v


def chunked_attention_plain(q, k, v, chunk: int = 4096) -> torch.Tensor:
    """The same function in query chunks, O(chunk * N) memory."""
    return torch.cat([attention_plain(q[:, i:i + chunk], k, v)
                      for i in range(0, q.shape[1], chunk)], dim=1)


def flash_attention_1h(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(C)) v for (B, N, C) single-head tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    return _kernel(q, k, v)


def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch C on CUDA tensors; refuses a call that autograd would record."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attn_1h has no backward (nor has the JAX package's K5): "
                           "call it under torch.no_grad(), as the frozen VQGAN runs")
    b, n, c = q.shape
    if k.shape != q.shape or v.shape != q.shape or c != 512:
        raise ValueError(f"flash_attn_1h takes (B, N, 512) q, k, v; got {tuple(q.shape)}")
    q, k, v = (_ext.aligned16(t.to(q.dtype).contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        FLASH_ATTN_1H_TC(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n,
                         device=q.device)
    else:  # float32; dtype_code raises for any other type
        FLASH_ATTN_1H(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      _ext.dtype_code(q.dtype), b, n, c, device=q.device)
    return out
