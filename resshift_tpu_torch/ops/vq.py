"""Nearest-codebook search of the VQ quantizer.

Kernel D `vq_nearest` (csrc/vq_nearest.cu) replaces the TPU kernel
`vq_pallas._nearest_pallas`.  The wrapper runs the plain PyTorch version
for a CPU tensor, launches the kernel for a CUDA tensor, and raises for
anything else.  The kernel splits the codebook into slices across CTAs and
combines their first minima by an atomic minimum over 64-bit (score bits,
index) keys held in the int64 output; `vq_finalize`, its second pass in the
same library, turns the keys into indices in place.  `VQ_NEAREST` counts
the search (with its fill of the keys), `VQ_FINALIZE` the second pass.
"""

from __future__ import annotations

import torch

from .. import _ext
from .._ext import I, P

__all__ = ["nearest_codebook_indices_plain", "nearest_codebook_indices", "VQ_NEAREST",
           "VQ_FINALIZE"]

VQ_NEAREST = _ext.Kernel("vq_nearest", [P] * 3 + [I] * 3)
VQ_FINALIZE = _ext.Kernel("vq_finalize", [P, I], lib="vq_nearest")


def nearest_codebook_indices_plain(flat: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """argmin over the full distance matrix |z|^2 + |e|^2 - 2 z.e; ties go to
    the first minimum."""
    d = (flat.pow(2).sum(1, keepdim=True) + emb.pow(2).sum(1)[None]
         - 2.0 * flat @ emb.t())
    return torch.argmin(d, dim=1)


def nearest_codebook_indices(flat: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """flat (M, D) rows, emb (K, D) codebook, both f32 -> (M,) int64 indices."""
    if flat.device.type == "cpu":
        return nearest_codebook_indices_plain(flat, emb)
    if flat.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {flat.device}")
    m, d = flat.shape
    k = emb.shape[0]
    if (emb.shape[1] != d or not 0 < d <= 8 or k < 1 or flat.dtype != torch.float32
            or emb.dtype != torch.float32):
        raise ValueError(f"vq_nearest takes f32 (M, D<=8) rows and (K>=1, D) codes; "
                         f"got {tuple(flat.shape)} {flat.dtype}, {tuple(emb.shape)}")
    idx = torch.empty(m, dtype=torch.int64, device=flat.device)
    if m:
        flat, emb = flat.contiguous(), emb.contiguous()
        VQ_NEAREST(flat.data_ptr(), emb.data_ptr(), idx.data_ptr(), m, k, d, device=flat.device)
        VQ_FINALIZE(idx.data_ptr(), m, device=flat.device)
    return idx
