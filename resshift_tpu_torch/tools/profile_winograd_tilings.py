"""Kernel K10's tensor-core tiling against other tilings on the card.

Rebuilds csrc/winograd_conv3x3_tc.cu with other values of its tile
constants (TILES 2x2 tiles and CO_BLK output channels a CTA, KC input
channels a chunk; the source takes any TILES % 16 == 0, KC % 16 == 0 and
CO_BLK % 16 == 0 that fit the H100's shared memory) and times each build's
kernel alone by CUDA events, at the census shapes of `profile_winograd` in
bf16, beside `F.conv2d` (cuDNN, channels_last, with the bias).  Each
build's output is held against `F.conv2d` in f32 within the bf16 band
(2^-6 of the largest output) and the tool fails if one is not.  Prints the
compiler's registers and spills of each build.  Needs the card and
`nvcc`: the builds go to resshift_tpu_torch/_build/tilings/.

    python -m resshift_tpu_torch.tools.profile_winograd_tilings [--batch 8] [--only=res@64]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess

import torch

from . import add_common_args, direct_conv, emit, pick_device, time_ms
from .. import _ext
from .._ext import I, P
from ..ops import winograd as wg
from .profile_winograd import SHAPES

__all__ = ["TILINGS", "variant_source", "main"]

# tag -> the constants that differ from the shipped source's.  At 128
# channels a CTA the tiles are cut to 16, as the 16 positions' f32
# accumulators of 2048 (tile, channel) pairs take half the register file;
# KC = 32 would need 305 KB of shared memory there
TILINGS = {"32x64 KC32 (shipped)": {},
           "16x128 KC16": {"TILES": 16, "CO_BLK": 128, "KC": 16},
           "64x32 KC16": {"TILES": 64, "CO_BLK": 32, "KC": 16}}
BAND = 2 ** -6


def variant_source(overrides: dict) -> str:
    """winograd_conv3x3_tc.cu with `constexpr int NAME = ...;` set to each
    value of `overrides`."""
    src = (_ext._CSRC / "winograd_conv3x3_tc.cu").read_text()
    for name, value in overrides.items():
        src, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            raise ValueError(f"winograd_conv3x3_tc.cu has no constant {name}")
    return src


def _build() -> dict:
    """Compile every tiling, one nvcc each, all started together; returns
    {tag: (entry point, registers and spills)}."""
    out = _ext._BUILD / "tilings"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (tag, over) in enumerate(TILINGS.items()):
        src, lib = out / f"tiling{i}.cu", out / f"libtiling{i}.so"
        src.write_text(variant_source(over))
        cmd = [_ext._nvcc(), *_ext._FLAGS, "-I", str(_ext._CSRC), "-o", str(lib), str(src)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    built = {}
    for tag, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for tiling {tag}:\n{log}")
        fn = ctypes.CDLL(str(lib)).winograd_conv3x3_tc
        fn.argtypes, fn.restype = [P] * 4 + [I] * 6 + [P], I
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        built[tag] = (fn, {"registers": regs, "spill_store_bytes": spills})
    return built


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", action="append", default=[],
                    help="keep the shapes whose label contains this (repeatable)")
    ap.add_argument("--batch", type=int, default=8, help="images a call")
    add_common_args(ap, n_iter=20)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("profile_winograd_tilings builds and times kernels: it needs the card")
    shapes = [s for s in SHAPES if not args.only or any(k in s[0] for k in args.only)]
    if not shapes:
        raise SystemExit(f"no shape matches {args.only}")
    built = _build()
    for tag, (_, rep) in built.items():
        print(f"{tag:>22}: {rep}", flush=True)
    results = {"builds": {tag: rep for tag, (_, rep) in built.items()}}
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for label, _, hw, c, co in shapes:
        bsz = args.batch
        g = torch.Generator(device=dev).manual_seed(sum(map(ord, label)))
        x = (0.3 * torch.randn(bsz, hw, hw, c, generator=g, device=dev)).bfloat16()
        w = (0.05 * torch.randn(3, 3, c, co, generator=g, device=dev)).bfloat16()
        b = 0.1 * torch.randn(co, generator=g, device=dev)
        u = _ext.aligned16(wg.kernel_u(w, torch.bfloat16))
        x = _ext.aligned16(x)
        want = direct_conv(x.float(), w.float(), b)
        scale = want.abs().max().item()
        y = torch.empty(bsz, hw, hw, co, dtype=torch.bfloat16, device=dev)
        r = {"batch": bsz, "conv2d_ms": time_ms(lambda: direct_conv(x, w, b), dev, args.n_iter,
                                                 args.reps)}
        line = f"{label:>22}: conv2d {r['conv2d_ms']:.4f} ms"
        for tag, (fn, _) in built.items():
            launch = lambda: fn(x.data_ptr(), u.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, hw,
                                hw, c, co, 1, stream())
            y.fill_(float("nan"))
            rc = launch()
            torch.cuda.synchronize(dev)
            if rc != 0:
                raise RuntimeError(f"tiling {tag}: CUDA error {rc} at launch")
            rel = ((y.float() - want).abs().max() / scale).item()
            if not rel <= BAND:
                raise AssertionError(f"tiling {tag} at {label}: rel err {rel} above {BAND}")
            r[tag] = {"kernel_ms": time_ms(launch, dev, args.n_iter, args.reps), "rel_err": rel}
            line += f"  {tag} {r[tag]['kernel_ms']:.4f} ms"
        results[label] = r
        print(line, flush=True)
    return emit(dev, results, ())


if __name__ == "__main__":
    main()
