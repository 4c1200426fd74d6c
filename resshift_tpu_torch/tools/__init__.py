"""The port's measurement entry points, each run as a module on the card:

    python -m resshift_tpu_torch.tools.profile_unet [--phases attn_kernel,attn_plain,...]
    python -m resshift_tpu_torch.tools.profile_winograd [--only=res@64] [--plain-formulation]
        [--dtype bf16|f32]
    python -m resshift_tpu_torch.tools.profile_conv [--rows 1,2,4,8] [--dtype bf16|f32]
    python -m resshift_tpu_torch.tools.profile_attn_variants [--dtype bf16|f32]
    python -m resshift_tpu_torch.tools.profile_winograd_tilings [--batch 8]

They reach kernels K9 (window attention), K10 (Winograd), P1 (direct 3x3
conv) and P2 (softmax ablations) at the JAX package's tools' shapes;
`profile_winograd_tilings` rebuilds K10's tensor-core kernel with other
tile constants and times each build (card only).  Each
prints one line per measurement and, last, one JSON object with the
device, the results and each kernel's launches.  `--device` defaults to
cuda and raises without a card; `--device cpu` runs the plain versions at
whatever size is asked and measures no time (the times are null).
Importing a tool has no side effect.

The helpers below are shared by the tools.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

__all__ = ["PEAK_BF16", "DTYPES", "add_common_args", "pick_device", "card", "time_ms", "rate",
           "direct_conv", "emit"]

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, at a 700 W limit)
PEAK_BF16 = 989e12
# --dtype of the tools: bf16 takes K9's, K10's, P1's and P2's tensor-core
# routes, f32 their FMA routes
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def add_common_args(ap: argparse.ArgumentParser, n_iter: int, reps: int = 3) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-iter", type=int, default=n_iter, help="calls per timed run")
    ap.add_argument("--reps", type=int, default=reps, help="timed runs; the best is kept")


def pick_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run the plain "
                               "versions without timing")
        # full f32 matmuls and convolutions wherever f32 is compared
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise RuntimeError(f"no kernels for device {dev}")
    return dev


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={dev.index or 0}"],
                             capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        out = f"{torch.cuda.get_device_name(dev)}, power limit unknown"
    return out


def time_ms(fn, dev: torch.device, n_iter: int, reps: int) -> float | None:
    """Best of `reps` CUDA-event timings of `n_iter` calls of `fn`, in ms per
    call, after one warm-up call; on the CPU `fn` runs once and no time is
    measured (None)."""
    fn()
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        best = min(best, start.elapsed_time(end) / n_iter)
    return best


def rate(flops: float, ms: float | None) -> dict:
    """ms, GFLOP, TFLOP/s and the share of the bf16 peak (`mfu`)."""
    tf = None if ms is None else flops / (ms * 1e-3) / 1e12
    return {"ms": ms, "gflops": flops / 1e9, "tflops_per_s": tf,
            "mfu": None if tf is None else tf * 1e12 / PEAK_BF16}


def direct_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """F.conv2d on NHWC x (seen as channels_last NCHW) and HWIO w, plus b
    (None: no bias); NHWC out.  The library's conv that K10 (with its bias)
    and P1 (without) are timed against."""
    wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), wt, None if b is None else b.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


def emit(dev: torch.device, results: dict, kernels) -> dict:
    """Print the closing JSON line: the card, the results and each kernel's
    launches (with its variants); returns it."""
    out = {"device": {"type": dev.type, "card": card(dev)}, "results": results,
           "launches": {k.name: {"launches": k.launches, "variants": dict(k.variants)}
                        for k in kernels}}
    print(json.dumps(out), flush=True)
    return out
