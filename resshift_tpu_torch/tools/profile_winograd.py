"""Kernel K10 (Winograd F(2,3)) against the library's direct conv on the card.

Times `ops/winograd.winograd_conv3x3` against `F.conv2d` (cuDNN,
channels_last, with the bias) at the conv families of the JAX package's
censuses, in bf16 (the tensor-core route, the default) or f32 (the FMA
route), the kernel transform U = G g G^T that the wrapper computes at each
call apart, and the plain PyTorch formulation with --plain-formulation.
TF/s is counted in the DIRECT conv's FLOPs for both, so the columns compare
directly (Winograd does 4/9 of the multiplies).  Each shape first checks
the kernel on two images against the direct conv in f32 (the relative
error to the largest output).

    python -m resshift_tpu_torch.tools.profile_winograd [--only=res@64] [--plain-formulation]
        [--dtype bf16|f32]
"""

from __future__ import annotations

import argparse

import torch

from . import DTYPES, add_common_args, direct_conv, emit, pick_device, time_ms
from ..ops import winograd as wg

__all__ = ["SHAPES", "main"]

# (label, B, H, C, Co): the conv families of the JAX package's censuses
SHAPES = [
    ("unet res@64  160ch", 64, 64, 160, 160),
    ("unet res@32  320ch", 64, 32, 320, 320),
    ("unet res@16  640ch", 64, 16, 640, 640),
    ("dec mid@64   512ch", 64, 64, 512, 512),
    ("dec up1@128  512->256", 64, 128, 512, 256),
    ("dec up1@128  256ch", 64, 128, 256, 256),
    ("dec up0@256  256->128", 64, 256, 256, 128),
    ("dec up0@256  128ch", 64, 256, 128, 128),
    ("enc down@128 128ch", 64, 128, 128, 128),
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", action="append", default=[],
                    help="keep the shapes whose label contains this (repeatable)")
    ap.add_argument("--plain-formulation", action="store_true",
                    help="also time the plain PyTorch Winograd formulation")
    ap.add_argument("--batch", type=int, default=None, help="override the shapes' batch")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bf16",
                    help="bf16: the tensor-core route; f32: the FMA route")
    add_common_args(ap, n_iter=32)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    dt = DTYPES[args.dtype]
    shapes = [s for s in SHAPES if not args.only or any(k in s[0] for k in args.only)]
    if not shapes:
        raise SystemExit(f"no shape matches {args.only}")
    kernels = (wg.WINOGRAD_CONV3X3_TC, wg.WINOGRAD_CONV3X3)
    for k in kernels:
        k.reset()
    results = {}
    for label, bsz, hw, c, co in shapes:
        bsz = args.batch or bsz
        g = torch.Generator(device=dev).manual_seed(sum(map(ord, label)))
        x = (0.3 * torch.randn(bsz, hw, hw, c, generator=g, device=dev)).to(dt)
        w = (0.05 * torch.randn(3, 3, c, co, generator=g, device=dev)).to(dt)
        b = 0.1 * torch.randn(co, generator=g, device=dev)

        # correctness on a slice, against the direct conv in f32
        xs = x[:2]
        want = direct_conv(xs.float(), w.float(), b)
        rel = ((wg.winograd_conv3x3(xs, w, b).float() - want).abs().max()
               / want.abs().max()).item()

        gf = 2 * bsz * hw * hw * 9 * c * co / 1e9
        ms_lib = time_ms(lambda: direct_conv(x, w, b), dev, args.n_iter, args.reps)
        ms_k = time_ms(lambda: wg.winograd_conv3x3(x, w, b), dev, args.n_iter, args.reps)
        ms_u = time_ms(lambda: wg.kernel_u(w, dt), dev, args.n_iter, args.reps)
        r = {"batch": bsz, "dtype": args.dtype, "direct_gflops": gf, "conv2d_ms": ms_lib,
             "winograd_ms": ms_k, "u_transform_ms": ms_u, "rel_err": rel}
        if args.plain_formulation:
            r["plain_ms"] = time_ms(lambda: wg.winograd_conv3x3_plain(x, w, b), dev,
                                    args.n_iter, args.reps)
        results[label] = r
        tf = lambda ms: "not timed" if ms is None else f"{ms:7.3f} ms ({gf / ms:5.0f} TF/s)"
        line = (f"{label:>22}: conv2d {tf(ms_lib)}  winograd {tf(ms_k)}  rel|diff| {rel:.2e}"
                f"  (U transform {'not timed' if ms_u is None else f'{ms_u:.4f} ms'})")
        if args.plain_formulation:
            line += f"  [plain {tf(r['plain_ms'])}]"
        print(line, flush=True)
    return emit(dev, results, kernels)


if __name__ == "__main__":
    main()
