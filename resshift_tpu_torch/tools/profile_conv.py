"""Probe P1 (a hand-written direct 3x3 conv) against the library's conv on
the card, at the ResBlock@64 shape (64, 64, 64, 160 -> 160), in bf16 (the
tensor-core route, the default) or f32 (the FMA route).

Prints the correctness line first (P1 on two images against the direct
conv in f32, a bf16 step at the output's scale, and the error relative to
the largest output), then `F.conv2d`
(cuDNN, channels_last, no bias, as P1) and P1 for each rows-per-CTA
setting of --rows (divisors of 128 in bf16, of 64 in f32).

    python -m resshift_tpu_torch.tools.profile_conv [--rows 1,2,4,8] [--dtype bf16|f32]
"""

from __future__ import annotations

import argparse

import torch

from . import DTYPES, add_common_args, direct_conv, emit, pick_device, time_ms
from ..ops import conv3x3 as cv

__all__ = ["main"]

HW, C = 64, 160  # the ResBlock@64 image side and channels (C -> C)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--rows", default="1,2,4,8", help="rows per CTA to sweep (divisors of "
                    "128 in bf16, of 64 in f32)")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bf16",
                    help="bf16: the tensor-core route; f32: the FMA route")
    add_common_args(ap, n_iter=32)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    dt = DTYPES[args.dtype]
    bsz, hw, c = args.batch, HW, C
    g = torch.Generator(device=dev).manual_seed(1)
    x = (0.3 * torch.randn(bsz, hw, hw, c, generator=g, device=dev)).to(dt)
    w = (0.05 * torch.randn(3, 3, c, c, generator=g, device=dev)).to(dt)
    kernels = (cv.CONV3X3_TC, cv.CONV3X3)
    for k in kernels:
        k.reset()

    # correctness first (two images)
    xs = x[:2]
    want = direct_conv(xs.float(), w.float(), None)
    err = (cv.conv3x3(xs, w).float() - want).abs().max().item()
    scale = want.abs().max().item() / 256
    print(f"max|diff|: {err:.4e} (bf16 scale ~{scale:.4e}, rel {err / scale / 256:.2e})",
          flush=True)

    gf = 2 * bsz * hw * hw * 9 * c * c / 1e9
    tf = lambda ms: "not timed" if ms is None else f"{ms:.3f} ms ({gf / ms:.0f} TF/s)"
    results = {"shape": [bsz, hw, hw, c, c], "dtype": args.dtype, "gflops": gf,
               "max_abs_err": err, "bf16_scale": scale, "rel_err": err / scale / 256}
    results["conv2d_ms"] = time_ms(lambda: direct_conv(x, w, None), dev, args.n_iter, args.reps)
    print(f"{'conv2d':>18}: {tf(results['conv2d_ms'])}", flush=True)
    for r in (int(v) for v in args.rows.split(",")):
        key = f"conv3x3 rows={r}"
        results[key + " ms"] = time_ms(lambda: cv.conv3x3(x, w, rows=r), dev, args.n_iter,
                                       args.reps)
        print(f"{key:>18}: {tf(results[key + ' ms'])}", flush=True)
    return emit(dev, results, kernels)


if __name__ == "__main__":
    main()
