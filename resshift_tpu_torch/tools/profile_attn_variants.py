"""Splits the window attention's cost on the card between its matrix
products and its softmax.

Times kernel A (`production`: `swin_block.norm_attn_residual_stats`, the
GroupNorm affine, W-MSA, residual and statistics) against probe P2
(`attn_variants.attn_variant`, the same without statistics) with each of
its five softmaxes (f32, mxsum, bf16exp, noexp, none), at (64, 4096, 192),
6 heads, 8x8 windows: in bf16 (the default) both on their tensor-core
routes, in f32 (`--dtype f32`) both on their FMA routes.  `split_ms` gives
the differences: `stats` = production - variant[f32] (A's statistics
partials and their reduce, and the two rounding policies' difference),
`softmax` = variant[f32] - variant[none].

    python -m resshift_tpu_torch.tools.profile_attn_variants [--dtype bf16|f32]
"""

from __future__ import annotations

import argparse

import torch

from . import DTYPES, add_common_args, emit, pick_device, time_ms
from ..ops import attn_variants as av
from ..ops import swin_block as sb

__all__ = ["main"]

HW, C, NH, WS = 64, 192, 6, 8
N = WS * WS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                    help="bf16 (the tensor-core routes of A and P2) or f32 (their FMA routes)")
    add_common_args(ap, n_iter=32)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    dt = DTYPES[args.dtype]
    bsz, t = args.batch, HW * HW
    g = torch.Generator(device=dev).manual_seed(1)
    x = (0.5 * torch.randn(bsz, t, C, generator=g, device=dev)).to(dt)
    w, b = torch.ones(bsz, C, device=dev), torch.zeros(bsz, C, device=dev)
    wqkv = (0.05 * torch.randn(C, 3 * C, generator=g, device=dev)).to(dt)
    wproj = (0.05 * torch.randn(C, C, generator=g, device=dev)).to(dt)
    bqkv, bproj = torch.zeros(3 * C, dtype=dt, device=dev), torch.zeros(C, dtype=dt, device=dev)
    bm = torch.zeros(1, NH, N, N, device=dev)
    args_ = (x, w, b, wqkv, bqkv, wproj, bproj, bm, NH, N)
    kernels = (sb.SWIN_WINDOW_ATTN_TC, sb.SWIN_WINDOW_ATTN, av.ATTN_VARIANTS_TC,
               av.ATTN_VARIANTS)
    for k in kernels:
        k.reset()

    results = {}
    with torch.no_grad():
        y_a = sb.norm_attn_residual_stats(*args_)[0]
        results["production"] = time_ms(lambda: sb.norm_attn_residual_stats(*args_), dev,
                                        args.n_iter, args.reps)
        print(f"{'production':>22}: {results['production']} ms", flush=True)
        for sm in av.SOFTMAX_MODES:
            key = f"variant[{sm}]"
            results[key] = time_ms(lambda: av.attn_variant(*args_, sm), dev, args.n_iter,
                                   args.reps)
            print(f"{key:>22}: {results[key]} ms", flush=True)
        # the f32 mode is A's y by other rounding points
        diff = (av.attn_variant(*args_, "f32").float() - y_a.float()).abs().max().item()
        results["f32_vs_production_max_abs_diff"] = diff
        print(f"variant[f32] vs production: max|diff| {diff:.4e}", flush=True)
    if dev.type == "cuda":
        f32 = results["variant[f32]"]
        results["split_ms"] = {"stats": results["production"] - f32,
                               "softmax": f32 - results["variant[none]"]}
        print(f"split ms: {results['split_ms']}", flush=True)
    return emit(dev, results, kernels)


if __name__ == "__main__":
    main()
