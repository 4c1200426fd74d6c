"""Micro-profile of the UNet's component families on the card, and kernel
K9 (standalone window attention) against its plain version.

Each phase times one family in isolation at the tile batch (64 tiles of a
64x64 latent by default): ResBlocks, Swin BasicLayers (through kernels A
and B), GroupNorm, a cuDNN 3x3 conv, bf16 matmul floors, and the window
attention of `ops/window_attention.py` (`attn_kernel`: K9; `attn_plain`:
its plain PyTorch version) at (4096, 64, 192), 6 heads.  Each phase prints
its ms per call (CUDA events, best of --reps runs of --n-iter calls after a
warm-up), its FLOPs counted from the shapes, TFLOP/s and the share of the
H100's bf16 peak (`mfu`).  `--dtype f32` runs every phase in float32
(K9 then takes its FMA kernel `window_attn`; in bf16 its tensor-core
kernel `window_attn_tc`).

    python -m resshift_tpu_torch.tools.profile_unet --phases attn_kernel,attn_plain,swin64
        [--dtype bf16|f32]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from . import DTYPES, add_common_args, emit, pick_device, rate, time_ms
from ..models.layers import GroupNorm32, ResBlock
from ..models.swin import BasicLayer
from ..ops import swin_block as sb
from ..ops import window_attention as wa

__all__ = ["PHASES", "main"]

EMB, EMBED, HEADS, WS, HIDDEN = 640, 192, 6, 8, 768


def _attn_flops(windows: int, n: int, c: int) -> float:
    """qkv, scores, p v and proj of `windows` windows of n tokens."""
    return windows * (2 * n * c * 3 * c + 4 * n * n * c + 2 * n * c * c)


def _res(hw, ch):
    def make(bsz, dev, g, dt):
        mod = ResBlock(ch, EMB, dtype=dt).to(dev)
        x = torch.randn(bsz, ch, hw, hw, generator=g, device=dev).to(dt)
        e = torch.randn(bsz, EMB, generator=g, device=dev).to(dt)
        flops = 2 * (2 * bsz * hw * hw * 9 * ch * ch) + 2 * bsz * EMB * 2 * ch
        return lambda: mod(x, e), flops
    return make


def _swin(hw, ch):
    def make(bsz, dev, g, dt):
        mod = BasicLayer(ch, EMBED, HEADS, WS, depth=2, build_resolution=hw, dtype=dt).to(dev)
        x = torch.randn(bsz, ch, hw, hw, generator=g, device=dev).to(dt)
        t, n = hw * hw, min(WS, hw) ** 2
        block = _attn_flops(bsz * t // n, n, EMBED) + bsz * t * 4 * EMBED * HIDDEN
        return lambda: mod(x), 2 * (2 * bsz * t * ch * EMBED) + 2 * block
    return make


def _gn(hw, ch):
    def make(bsz, dev, g, dt):
        mod = GroupNorm32(ch).to(dev)
        x = torch.randn(bsz, ch, hw, hw, generator=g, device=dev).to(dt)
        # sum, sum of squares, normalise and affine: about 8 operations an element
        return lambda: mod(x), 8 * bsz * ch * hw * hw
    return make


def _conv(hw, cin, cout):
    def make(bsz, dev, g, dt):
        # NHWC memory seen as NCHW (channels_last), as the JAX tool's NHWC conv
        x = torch.randn(bsz, hw, hw, cin, generator=g, device=dev).to(dt).permute(0, 3, 1, 2)
        w = (0.02 * torch.randn(cout, cin, 3, 3, generator=g, device=dev)).to(dt)
        w = w.contiguous(memory_format=torch.channels_last)
        return lambda: F.conv2d(x, w, padding=1), 2 * bsz * hw * hw * 9 * cin * cout
    return make


def _matmul(rows_per_tile, k, n):
    def make(bsz, dev, g, dt):
        m = bsz * rows_per_tile
        a = (0.05 * torch.randn(m, k, generator=g, device=dev)).to(dt)
        b = (0.05 * torch.randn(k, n, generator=g, device=dev)).to(dt)
        return lambda: a @ b, 2 * m * k * n
    return make


def _attn(kernel: bool):
    def make(bsz, dev, g, dt):
        c, n = EMBED, WS * WS
        m = bsz * 64  # 64 windows of a 64x64 tile
        x = (0.5 * torch.randn(m, n, c, generator=g, device=dev)).to(dt)
        wqkv = (0.02 * torch.randn(c, 3 * c, generator=g, device=dev)).to(dt)
        wproj = (0.02 * torch.randn(c, c, generator=g, device=dev)).to(dt)
        bqkv, bproj = torch.zeros(3 * c, dtype=dt, device=dev), torch.zeros(c, dtype=dt,
                                                                              device=dev)
        bm = torch.zeros(1, HEADS, n, n, device=dev)
        fn = wa.window_attention if kernel else wa.window_attention_plain
        return lambda: fn(x, wqkv, bqkv, wproj, bproj, bm, HEADS), _attn_flops(m, n, c)
    return make


PHASES = {
    "res64": _res(64, 160), "res32": _res(32, 320), "res16": _res(16, 320), "res8": _res(8, 640),
    "swin64": _swin(64, 160), "swin32": _swin(32, 320), "swin8": _swin(8, 640),
    "gn64": _gn(64, 160), "gn32": _gn(32, 320),
    "conv64": _conv(64, 160, 160),
    "matmul_sq": _matmul(64, 4096, 4096),           # 4096^3 at 64 tiles
    "matmul_conv_eq": _matmul(4096, 1440, 160),     # a 3x3 conv's im2col product
    "matmul_mlp_eq": _matmul(4096, 192, 768),       # the Swin MLP's fc1
    "attn_kernel": _attn(True), "attn_plain": _attn(False),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None, help=f"comma list of {', '.join(PHASES)}")
    ap.add_argument("--batch", type=int, default=64, help="tiles (64x64 latents)")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES), help="every phase's dtype")
    add_common_args(ap, n_iter=8)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    names = args.phases.split(",") if args.phases else list(PHASES)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; known: {list(PHASES)}")
    kernels = (wa.WINDOW_ATTN_TC, wa.WINDOW_ATTN, sb.SWIN_WINDOW_ATTN_TC, sb.SWIN_WINDOW_ATTN,
               sb.SWIN_MLP_TC, sb.SWIN_MLP)
    for k in kernels:
        k.reset()
    results = {}
    with torch.no_grad():
        for name in names:
            fn, flops = PHASES[name](args.batch, dev, torch.Generator(device=dev).manual_seed(0),
                                     DTYPES[args.dtype])
            results[name] = rate(flops, time_ms(fn, dev, args.n_iter, args.reps))
            print(f"{name:>16}: {results[name]}", flush=True)
            del fn
    return emit(dev, results, kernels)


if __name__ == "__main__":
    main()
