"""Times kernels A, K9, D, E, F and P2 at the shapes the port runs them, by
CUDA events around the wrapper and by the profiler's device time of one
call.

    python -m resshift_tpu_torch.tools.profile_kernels [--n-iter 20] [--reps 3]

A: `swin_block.norm_attn_residual_stats`, bf16, (8, 4096, 192), 6 heads
(the realsr tile batch's widest Swin level).  K9:
`window_attention.window_attention`, bf16, (4096, 64, 192), 6 heads
(profile_unet's `attn_kernel`).  D: `vq.nearest_codebook_indices`, f32, at
the decodes' shapes: 32768 x 8192 x 3 (the f4 tile batch), 4096 x 4096 x 8
(one f8 face), 49152 x 8192 x 3 (a 176x250 photo's 192x256 f4 latent),
262144 x 8192 x 3 (a 512x512 photo's).  E: `shift.shift_tokens`, bf16,
(1, 49152, 192) and (1, 262144, 192) (the whole-photo latents 192x256 and
512x512, window 8, shift 4).  F: `tail.gn_silu_conv3x3` pinned
`use_pallas=True` at `TAIL_SHAPES` (the UNet head at a tile batch of 8 and
at faceir's one face, f32; the f4 and f8 decoder tails, bf16), each on the
route its dtype takes, its statistics pass and its conv kernel apart in
the device time by name.  P2: `attn_variants.attn_variant`, (8, 4096, 192),
6 heads, each of its five softmaxes in bf16 and in f32 (in a checkout
where bf16 has a tensor-core route, the two dtypes time both routes).  The
device time is the sum of every device event of a call (kernels and
memsets), with the events by name beside it.  The tool uses only the
wrappers' public functions, so the same file times a checkout of an
earlier commit: copy it into that checkout's `resshift_tpu_torch/tools/`
and run it there.  Card only.
"""

from __future__ import annotations

import argparse

import torch

from . import add_common_args, emit, pick_device, time_ms
from ..ops import attn_variants as av
from ..ops import shift
from ..ops import swin_block as sb
from ..ops import tail
from ..ops import vq
from ..ops import window_attention as wa

__all__ = ["VQ_SHAPES", "E_LATENTS", "TAIL_SHAPES", "main"]

NH, N, C = 6, 64, 192
VQ_SHAPES = {"f4 tiles": (32768, 8192, 3), "f8 face": (4096, 4096, 8),
             "f4 176x250": (49152, 8192, 3), "f4 512x512": (262144, 8192, 3)}
E_LATENTS = [(192, 256), (512, 512)]
# (name, B, C, H, W, co, dtype), as chip_smoke.py's
TAIL_SHAPES = [("UNet head", 8, 160, 64, 64, 3, torch.float32),
               ("faceir head", 1, 160, 64, 64, 8, torch.float32),
               ("f4 tail", 8, 128, 256, 256, 3, torch.bfloat16),
               ("f8 tail", 1, 64, 512, 512, 3, torch.bfloat16)]


def device_ms(fn, reps: int = 5) -> dict:
    """Device time per call of fn(): the total and by event name, from a
    torch.profiler trace of `reps` calls after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / reps
    return {"total": sum(by_name.values()) if by_name else None, "by_name": by_name}


def _cases(dev: torch.device) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    bf = torch.bfloat16
    wts = [(rn(C, 3 * C) / C ** 0.5).to(bf), (0.1 * rn(3 * C)).to(bf),
           (rn(C, C) / C ** 0.5).to(bf), (0.1 * rn(C)).to(bf)]
    xa = rn(8, 4096, C).to(bf)
    wa_, ba = sb.gn_fold(xa, 1 + 0.1 * rn(C), 0.1 * rn(C))
    bias = 0.02 * rn(1, NH, N, N)
    xk = rn(4096, N, C).to(bf)
    cases = {"A (8, 4096, 192) bf16": lambda: sb.norm_attn_residual_stats(
                 xa, wa_, ba, *wts, bias, NH, N),
             "K9 (4096, 64, 192) bf16": lambda: wa.window_attention(xk, *wts, bias, NH)}
    for dt in (bf, torch.float32):
        tag = "bf16" if dt == bf else "f32"
        p2 = (xa.to(dt), wa_, ba, *(w.to(dt) for w in wts), bias, NH, N)
        for sm in av.SOFTMAX_MODES:
            cases[f"P2 {sm} (8, 4096, 192) {tag}"] = (lambda p2=p2, sm=sm:
                                                      av.attn_variant(*p2, sm))
    for label, (m, k, d) in VQ_SHAPES.items():
        z, emb = rn(m, d), 0.5 * rn(k, d)
        cases[f"D {label} ({m} x {k} x {d})"] = (lambda z=z, emb=emb:
                                                 vq.nearest_codebook_indices(z, emb))
    for h, w in E_LATENTS:
        xe = rn(1, h * w, C).to(bf)
        cases[f"E (1, {h * w}, {C}) bf16"] = (lambda xe=xe, h=h, w=w:
                                               shift.shift_tokens(xe, h, w, 8, 4))
    for name, b, c, h, w, co, dt in TAIL_SHAPES:
        eps = 1e-5 if "head" in name else 1e-6
        args = ((1.5 * rn(b, c, h, w) + 0.3).to(dt), 1 + 0.2 * rn(c), 0.5 + 0.3 * rn(c),
                (rn(co, c, 3, 3) / (9 * c) ** 0.5).to(dt), (0.1 * rn(co)).to(dt))
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        cases[f"F {name} {(b, c, h, w)} -> {co} {tag}"] = (
            lambda args=args, eps=eps: tail.gn_silu_conv3x3(*args, eps=eps, use_pallas=True))
    return cases


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, n_iter=20)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("profile_kernels needs the card: it times kernels and has no CPU "
                           "mode")
    kernels = [k for k in (getattr(sb, "SWIN_WINDOW_ATTN_TC", None),
                           getattr(wa, "WINDOW_ATTN_TC", None), wa.WINDOW_ATTN, vq.VQ_NEAREST,
                           getattr(vq, "VQ_FINALIZE", None), shift.SHIFT_TOKENS,
                           getattr(tail, "GN_STATS", None),
                           getattr(tail, "GN_SILU_CONV3X3_TC", None), tail.GN_SILU_CONV3X3,
                           getattr(av, "ATTN_VARIANTS_TC", None), av.ATTN_VARIANTS)
               if k is not None]
    for k in kernels:
        k.reset()
    results = {}
    with torch.no_grad():
        for label, fn in _cases(dev).items():
            dms = device_ms(fn)
            results[label] = {"ms": time_ms(fn, dev, args.n_iter, args.reps),
                              "device_ms": dms["total"], "device_ms_by_name": dms["by_name"]}
            print(f"{label}: {results[label]}", flush=True)
    return emit(dev, results, kernels)


if __name__ == "__main__":
    main()
