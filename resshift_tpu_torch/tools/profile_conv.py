"""Probe P1 (a hand-written direct 3x3 conv) against the library's conv on
the card, at the ResBlock@64 shape (64, 64, 64, 160 -> 160) bf16.

Prints the correctness line first (P1 on two images against the direct
conv in f32, and a bf16 step at the output's scale), then `F.conv2d`
(cuDNN, channels_last) and P1 for each rows-per-CTA setting of --rows.

    python -m resshift_tpu_torch.tools.profile_conv [--rows 1,2,4,8]
"""

from __future__ import annotations

import argparse

import torch

from . import add_common_args, direct_conv, emit, pick_device, time_ms
from ..ops import conv3x3 as cv

__all__ = ["main"]

HW, C = 64, 160  # the ResBlock@64 image side and channels (C -> C)
DT = torch.bfloat16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--rows", default="1,2,4,8", help="rows per CTA to sweep (divisors of 64)")
    add_common_args(ap, n_iter=32)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    bsz, hw, c = args.batch, HW, C
    g = torch.Generator(device=dev).manual_seed(1)
    x = (0.3 * torch.randn(bsz, hw, hw, c, generator=g, device=dev)).to(DT)
    w = (0.05 * torch.randn(3, 3, c, c, generator=g, device=dev)).to(DT)
    zero = torch.zeros(c, device=dev)
    cv.CONV3X3.reset()

    # correctness first (two images)
    xs = x[:2]
    want = direct_conv(xs.float(), w.float(), zero)
    err = (cv.conv3x3(xs, w).float() - want).abs().max().item()
    scale = want.abs().max().item() / 256
    print(f"max|diff|: {err:.4e} (bf16 scale ~{scale:.4e})", flush=True)

    gf = 2 * bsz * hw * hw * 9 * c * c / 1e9
    tf = lambda ms: "not timed" if ms is None else f"{ms:.3f} ms ({gf / ms:.0f} TF/s)"
    results = {"shape": [bsz, hw, hw, c, c], "gflops": gf, "max_abs_err": err,
               "bf16_scale": scale}
    results["conv2d_ms"] = time_ms(lambda: direct_conv(x, w, zero), dev, args.n_iter, args.reps)
    print(f"{'conv2d':>18}: {tf(results['conv2d_ms'])}", flush=True)
    for r in (int(v) for v in args.rows.split(",")):
        key = f"conv3x3 rows={r}"
        results[key + " ms"] = time_ms(lambda: cv.conv3x3(x, w, rows=r), dev, args.n_iter,
                                       args.reps)
        print(f"{key:>18}: {tf(results[key + ' ms'])}", flush=True)
    return emit(dev, results, (cv.CONV3X3,))


if __name__ == "__main__":
    main()
