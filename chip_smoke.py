#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (resshift_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):
  1. print the card and its power limit; build every CUDA kernel from
     resshift_tpu_torch/csrc with nvcc (into the ignored _build/), and
     print each kernel's registers and spills and each source's build
     seconds;
  2. hold each kernel (A swin_window_attn, B swin_mlp, C flash_attn_1h,
     D vq_nearest, E shift_tokens) against its plain PyTorch version at the
     main paths' shapes, in bf16 and f32, and time both (D at its three
     decode shapes, with the profiler's device time of its search and its
     second pass vq_finalize); A, B and C run bf16
     on their tensor-core kernels (swin_window_attn_tc, swin_mlp_tc,
     flash_attn_1h_tc) and f32 on their FMA kernels, and each call is
     checked for its route; both routes are timed, C beside
     scaled_dot_product_attention, A and B also at each Swin level's token
     count (8 to 512 windows), A also by the profiler's device time (its
     kernel and the statistics reduce apart); C also at the
     N = 49152 of a whole photo; one wide Swin block (192x256) both ways,
     through E and through the shift-absorbing A and B;
  3. run realsr_v1 at full width (seeded random weights, bf16, 15 steps,
     batch 8 of 64x64 LQ tiles) through ResShiftPipeline.sample and check
     each kernel's launch count in that one call (here and in phases 6, 7,
     9 and 10 every A, B and C launch must be the tensor-core route, D's
     search and second pass launch once, K9, K10 and P1 never; the
     profiles of phases 3, 6, 7 and 9 give A's, the statistics reduce's and
     D's device time by name);
  4. run the same sample through the plain versions (patched in here only)
     and require >= 35 dB PSNR on the final latent;
  5. run one padded, chopped input through sample, in bf16 and in f32 (the
     FMA routes of A, B and C, which must launch there and only there);
  6. realsr_v3 on a whole 176x250 photo (batch 1, unchopped, a 192x256
     latent, so the widest Swin level takes E): launch counts derived from
     the model's structure, the output, >= 35 dB latent PSNR against the
     plain versions (E included, C in query chunks), ms per call, Mpx/s;
  7. realsr_v3 on a whole 512x512 photo (a 512x512 latent), kernels only:
     launch counts and time;
  8. `python -m resshift_tpu_torch.cli infer` in a subprocess on a folder of
     two PNGs written with the port's own codec (realsr_v1, bf16);
  9. faceir at full width (bf16, 4 steps, one 512x512 face, f8 VQGAN),
     pinned through the config keys `model.use_pallas: true` and
     `autoencoder.use_pallas: true`, so that kernel F runs in the UNet head
     and the decoder tail: launch counts derived from the config, >= 35 dB
     latent and image PSNR against the unpinned call through the plain
     versions, and the same call unpinned, timed (and profiled); F's
     launches are counted by kernel: gn_stats steps + 1 times, the FMA
     route in the f32 UNet head, the tensor-core route in the bf16 tail;
 10. inpaint_imagenet, one 256x256 image with a seeded rectangular mask,
     checked in the same way;
 11. `cli infer` through `cli.main` in this process (phase 8 runs the
     module's entry point in a subprocess; these ran in subprocesses too
     until phase 21 needed the time): inpaint_face with --mask-path (outside the
     mask the output equals the input exactly), faceir, realsr --scale 2
     (one LQ side padding to an odd multiple of 64, which the pipeline pads
     on to a multiple of 128);
phase 2 also holds kernel F against its plain version at the UNet head's
and the decoder tails' shapes (its statistics pass gn_stats against the
plain fold; its conv on the route each shape's dtype takes: f32 heads on
the FMA kernel gn_silu_conv3x3, bf16 tails on the tensor-core kernel
gn_silu_conv3x3_tc, each call checked for its route), timed by events and
by each kernel's device time beside the cuDNN composition, with its bound
and two-pass floor, and the kernels of the profiling entry points: K9 at
(4096, 64, 192) with one bias and with 64 (shift mask), in bf16 (the
tensor-core kernel window_attn_tc) and f32 (the FMA kernel window_attn),
each call checked for its route, both timed by events and by the
profiler's device time beside F.multi_head_attention_forward, and the
order of its gradients; K10 winograd_conv3x3 at unet res@64 and dec up0@256
with the batch cut to 8, against the plain formulation and F.conv2d; P1
conv3x3 at (8, 64, 64, 160) with whole rows and 1 and 4 rows per CTA; K10
and P1 in both routes (bf16: the tensor-core kernels winograd_conv3x3_tc
and conv3x3_tc; f32: the FMA kernels), each call checked for its route,
timed by events and by the profiler's device time, beside F.conv2d in the
same dtype (with the bias for K10, without for P1) and K10's U transform;
P2, all five softmaxes, at (8, 4096, 192), in bf16 (the tensor-core kernel
attn_variants_tc) and f32 (the FMA kernel attn_variants), each call checked
for its route, each mode timed by events and by the profiler's device time;
and the backward passes (`check_grads`): A and B (both variants) at (8,
4096, 192) and F at the UNet head and the f4 tail, in bf16 and f32, their
gradients against the plain versions', E's (its kernel, inverted) bit for
bit;
 12. the four tools through each one's `main` (what `python -m
     resshift_tpu_torch.tools.<tool>` calls) in this process (in
     subprocesses until phase 21 needed the time; phases 14 and 21 still
     start tools as modules) (profile_unet, profile_winograd on all nine conv families
     of its census, profile_conv, profile_attn_variants; profile_unet's K9
     phase, profile_winograd, profile_conv and profile_attn_variants once
     more with --dtype f32), each at its full width with few iterations:
     each exits 0, launches its kernels and, for K9, K10, P1 and P2, not the
     other dtype's route (their counts are the tools' own, read from the
     JSON line each prints);
 13. serving in process: a `Predictor` (realsr_v3, full width, bf16,
     seeded random weights) warmed up at every bucket (1 ... 16) at 64x64,
     then a concurrent burst of more requests than `max_batch` from threads:
     each output's shape and finiteness, distinct outputs for identical
     inputs, the batch histogram, A-D's launches per forward on their
     tensor-core routes; then, with the forward held at a gate, a request
     beyond `max_queue` must raise ServerBusyError; forwards/s, Mpx/s and
     forward p50/p99;
 14. the HTTP path: `python -m resshift_tpu_torch.tools.serve_loadtest` in a
     subprocess (which starts the server in another): exit 0, every 200 a
     PNG of the right size, the overload burst answered 429 with
     Retry-After, the /metrics counts adding up;
 15. DDPM: configs/ddpm_ablation.yaml's diffusion block (DDIM, 50 respaced
     steps of 1000) on the realsr_v1 model at full width, bf16, 8 x 64x64
     tiles: launch counts derived from the structure, >= 35 dB final-latent
     PSNR against the same call through the plain versions, ms per call;
 16. realsr_v1 on one batch of 8 tiles: `sample_time_parallel` at sweeps = T
     against `sample` with the same seed (>= 35 dB latent PSNR, and the share
     of bit-equal latent values), at sweeps = T // 3 (PSNR reported, not
     gated), `sample_progressive`'s final output against `sample`'s (>= 35
     dB) and its strip's shape; launch counts (A and B: sweeps x one step's
     count), ms per call at each sweep count;
 17. realsr_v1 training at full width (configs/realsr_swinunet_realesrgan256
     .yaml as a dict, `realsr_train_config`: the card's machine has no
     PyYAML), seeded random weights, bf16 compute on f32 masters, batch 64
     in microbatches of 8, GT 256, on 96 seeded synthetic 320x320 PNGs:
     (a) `Trainer.train(stop_iter=3)` with the RealESRGAN degradation, image
     grids at iteration 2 and validation (EMA weights, two 64 -> 256 pairs)
     at 3: loss and grad_norm finite and > 0, the lr of each step, every
     UNet parameter with a nonzero gradient, C launched 16 times a step and
     A, B, D, E, F none, validation's launches as `expected_launches`
     derives them, ms per iteration (the median of iterations 2-3: loader,
     degrader, step), images/s, peak max_memory_allocated; (b) on paired
     `base` data with `torch.use_deterministic_algorithms(True)`: 3
     iterations straight against 2 + save + resume + 1, params, EMA and
     moments bit-equal; (c) one microbatch's gradient with A and B (their
     autograd Functions, `use_pallas` unset) against the plain composition
     (`use_pallas: false`): relative L2 <= 1e-3 in f32, the bf16 figure
     printed;
 18. the LPIPS trainer at full width, seeded random weights (LPIPS's too:
     no weights ship), bf16 on f32 masters, batch 96 in microbatches of 12:
     (a) configs/bicx4_swinunet_lpips.yaml (`bicsr_lpips_config`) on 96
     seeded 288x288 PNGs through the `bicubic` loader (GT crops of 256),
     2 iterations (3 until phase 21 needed the time), then validation on 2
     pairs; (b)
     configs/inpaint_lama256_face.yaml (`inpaint_face_lpips_config`) on 96
     320x288 PNGs through the `inpainting` loader (LaMa masks and
     distortions on 8 threads), 2 iterations, then validation through
     `inpainting_val`; each: loss, lpips and grad_norm finite (lpips > 0),
     every UNet parameter with a nonzero gradient, C launched twice a
     microbatch (the encodes, under no_grad) and nothing else in a step (the
     decode under autograd is pinned plain: no C, no D), validation's
     launches as `expected_launches` derives them, val_lpips; ms per
     iteration split into the loader's wait and the step, images/s, the
     loader's wait per batch, peak max_memory_allocated;
 19. faceir: (c) the port's JPEG round trip (ops/jpeg.py) of a seeded
     image at qualities 30, 60 and 95 against the SHA-256 digests of
     OpenCV's that tests/test_torch_jpeg.py pins (integer arithmetic: the
     same bits on any machine); (a) configs/faceir_gfpgan512_lpips.yaml
     (`faceir_lpips_config`) on 96 seeded 512x512 PNGs through the
     `gfpgan` loader (the GFPGAN-style degradation in numpy on 8 threads),
     batch 96 in microbatches of 12, 2 iterations (3 until phase 21 needed
     the time), validation on 2 faces without GT, checked and timed as in
     phase 18, then `scripts celeba-faceir` on 4 faces through
     `scripts.main` in this process (a subprocess until phase 21 needed the
     time);
     (b) one batch of 96 from the `bsrgan` (light chain) and
     `bsrganimagenet` (full chain) loaders at GT 256 on 8 threads: shapes,
     range, time;
 20. the architecture options and the trainable variants, seeded random
     weights: (a) realsr_v1 at full width (bf16, 15 steps, 8 x 64x64 tiles)
     through `sample` twice, once with `resblock_updown`, `patch_norm` and
     `use_scale_shift_norm: false`, once with `conv_resample: false`: A-D's
     launches as `expected_launches` derives them, the image >= 35 dB PSNR
     against the same model's `clone(use_pallas=False)` (which must launch
     nothing), ms per call; (b) `AutoencoderKL` at latent-diffusion's KL-f16
     first-stage shape (`KL_F16`), encode and decode of 4 x 256x256 in bf16:
     C once per attention block (`kl_attention_blocks`) and nothing else, F
     at the tail when the decoder is pinned True, the reconstruction >= 35
     dB against the plain clone, a seeded posterior sample off the mode;
     (c) `UNetModel` and `UNetModelConv` at the JAX defaults' widths
     (`VARIANT_WIDTHS`), batch 8 of 64x64 with a 128x128 LQ
     pixel-unshuffled: one forward and backward each in f32 and bf16 (ms,
     peak memory, finite gradients, no kernel launched), bf16 against f32 >=
     35 dB; (d) pixel-space training (`autoencoder: null`) at
     tools/train_proof.py's settings (`pixel_train_config`) on 32 synthetic
     64x64 pairs packed by `scripts pack` (through `scripts.main` in this
     process; subprocesses until phase 21 needed the time) and
     read through `pack_path` / `extra_pack_path` by the native reader: 3
     iterations, finite losses, no launch in a step, A and B in validation
     as derived, ms per iteration split as in phase 17;
 21. data parallelism (`parallel_phase`), over two replicas on the one
     card (`devices=[cuda:0, cuda:0]`: a card listed twice holds two
     replicas, the second a copy of the first): (a) realsr_v1 at full
     width, bf16, through `sample_batch_sharded` (8 tiles of 64x64) and
     `sample_tiles_sharded` (phase 5's chopped 112x176 input, chop 64 /
     stride 48: 12 tiles): two replicas built, each shard (shard 1 on the
     copy) bit-equal to `sample` of its own inputs with its rows of the
     draws on the first, the whole image >= 35 dB from the unsharded
     `sample` (`tile_bs` = every tile for the tiles), A-D's launches per
     call (each shard a sample call), and ms per call; then, at a small
     width in f32 with the models pinned plain, `sample_batch_sharded` over
     `[cuda:0, cpu]`: the CPU shard (its replica and schedule copied from
     the card's) bit-equal to a CPU pipeline's `sample` of its inputs and
     draws, the whole within rtol / atol 5e-3 of the card's `sample`; (b)
     a `Predictor(data_parallel=True)` over the two replicas under phase
     13's burst: results as phase 13 checks them, launches per forward, and
     forwards/s beside phase 13's; (c) `python -m
     resshift_tpu_torch.tools.multiprocess_proof --nproc 1 --device cuda
     --modes dp,fsdp`, phase 17's realsr training (batch 64 / 8, GT 256,
     bf16) in a world-size-1 NCCL group with torchrun's environment, 2
     iterations with DP (the gradient all-reduce), then 2 with `train.fsdp:
     true`, in one process; ms per iteration and peak memory of each, then
     the FSDP checkpoint resumed in this process (no process group) for one
     more iteration;
 22. tensor and pipeline parallelism on the one card, realsr_v1 at full
     width, bf16, phase 3's weights: (a) `sample_tp` on one 64x64 LQ at
     batch 1 (the latency case) over two gloo ranks sharing the card
     (`multiprocess_proof --tp`, each rank a process): the ranks'
     images bit-equal, >= 35 dB from the plain-pinned `sample` on the same
     draws; then in a world-size-1 NCCL group in this process (the split
     forms, NCCL's collectives): the same bar, no kernel launched; ms a call
     and the collectives of a call beside the plain call; (b)
     `sample_pipelined` on phase 5's chopped 112x176 input (12 tiles, chunks
     of 4) over [card, card] (two stages of 8 and 7 steps, two replicas):
     bit-equal to `sample(tile_bs=4)` on the same draws, A-D launched as
     that call launches them; over [[card, card], [card, card]] (PP x DP):
     each chunk in two parts, bit-equal to `sample(tile_bs=2)` on the same
     draws and >= 35 dB from `sample(tile_bs=4)`, twice the launches; ms a call;
     [card, card] and `sample(tile_bs=4)` timed two calls each, alternated;
     then [card, cpu] at a small width in f32, pinned
     plain, within rtol / atol 5e-3 of the card's `sample(tile_bs=2)`;
then print the `kernels` JSON line (each kernel's `backward` and its phase-2
backward error among its keys; every phase's launches under
`launches_by_phase`) and, last, the result line.
Needs a CUDA card and the repository around this file.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the main path's Swin shapes (heads, window tokens, embed, MLP) and batch
NH, N, C, HIDDEN, BSZ = 6, 64, 192, 768, 8
# latents of whole photos: 176x250 LQ padded to 192x256, and 512x512 LQ
WIDE_LATENTS = [(192, 256), (512, 512)]
# kernel F's shapes (name, B, C, H, W, co, dtype): the UNet head at a tile
# batch of 8 and at faceir's one face, the f4 decoder tail at a tile batch
# of 8, the f8 decoder tail of one 512x512 face
TAIL_SHAPES = [("UNet head", 8, 160, 64, 64, 3, "f32"), ("faceir head", 1, 160, 64, 64, 8, "f32"),
               ("f4 tail", 8, 128, 256, 256, 3, "bf16"), ("f8 tail", 1, 64, 512, 512, 3, "bf16")]

# kernel D's shapes (key, latent rows, codes, D): the f4 tile batch (phase
# 3), one f8 face (phase 9), a 512x512 photo's f4 latent (phase 7)
VQ_SHAPES = [("D", 8 * 64 * 64, 8192, 3), ("D f8", 64 * 64, 4096, 8),
             ("D 512x512", 512 * 512, 8192, 3)]

# the profiling entry points' kernels: K9 at profile_unet's attention phase
# (64 tiles x 64 windows), K10 at two of profile_winograd's SHAPES and P1 at
# profile_conv's shape with the batch cut to 8, P2 at (8, 4096, 192)
# (profile_attn_variants' width with the batch cut to 8)
K9_WINDOWS = 4096
K10_SHAPES = [("unet res@64", 8, 64, 160, 160), ("dec up0@256 256->128", 8, 256, 256, 128)]
K10_CENSUS_BATCH = 2  # K10's bf16 route at every conv family of profile_winograd's SHAPES
P1_SHAPE = (8, 64, 64, 160)
P1_ROWS = (1, 4)  # P1's rows per CTA: checked in phase 2, swept by profile_conv in phase 12
# phase 12: each tool with its arguments, the kernels it must launch and those
# it must not (K9, K10 and P1 take their tensor-core routes in bf16, their
# FMA routes in f32, and so do A and P2 in profile_attn_variants);
# profile_winograd covers all nine conv families in bf16
TOOL_RUNS = [("profile_unet", ["--phases", "attn_kernel,attn_plain,swin64"],
              ["window_attn_tc", "swin_window_attn_tc"], ["window_attn"]),
             ("profile_unet", ["--phases", "attn_kernel", "--dtype", "f32"], ["window_attn"],
              ["window_attn_tc"]),
             ("profile_winograd", [], ["winograd_conv3x3_tc"], ["winograd_conv3x3"]),
             ("profile_winograd", ["--only=res@64", "--dtype", "f32"], ["winograd_conv3x3"],
              ["winograd_conv3x3_tc"]),
             ("profile_conv", ["--rows", "1,2,4"], ["conv3x3_tc"], ["conv3x3"]),
             ("profile_conv", ["--rows", ",".join(map(str, P1_ROWS)), "--dtype", "f32"],
              ["conv3x3"], ["conv3x3_tc"]),
             ("profile_attn_variants", [], ["swin_window_attn_tc", "attn_variants_tc"],
              ["attn_variants"]),
             ("profile_attn_variants", ["--dtype", "f32"], ["swin_window_attn", "attn_variants"],
              ["attn_variants_tc"])]
# the conv tools' error against F.conv2d in f32, relative to the largest
# output: phase 2's bands
TOOL_BAND = {"bf16": 2 ** -6, "f32": 1e-4}
PROBE_KERNELS = {"K9": "window_attn_tc", "K9 f32": "window_attn", "K10": "winograd_conv3x3_tc",
                 "K10 f32": "winograd_conv3x3", "P1": "conv3x3_tc", "P1 f32": "conv3x3",
                 "P2": "attn_variants_tc", "P2 f32": "attn_variants"}

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W power limit)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name: str, got, want, rel: float, atol: float) -> float:
    """max |got - want| <= atol + rel * max |want|; returns the max error."""
    err = (got.float() - want.float()).abs().max().item()
    tol = atol + rel * want.float().abs().max().item()
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} above tolerance {tol}")
    return err


# kernels whose device time every profile reports, whether or not in its top 15:
# A's routes and the reduce, D's search and second pass, F's statistics and
# fold and both of its conv routes (launched where pinned), and the work around
# the UNet's cuDNN convs that a fused GN+SiLU+conv kernel would take (the
# convs themselves, cuDNN's layout transposes, the GroupNorm moments)
PROFILED = ("swin_window_attn_tc_kernel", "swin_window_attn_kernel", "stats_reduce_kernel",
            "vq_nearest_kernel", "vq_finalize_kernel", "gn_stats_kernel", "gn_fold_kernel",
            "gn_silu_conv3x3_tc_kernel", "gn_silu_conv3x3_kernel", "fprop_implicit_gemm",
            "nchwToNhwc", "nhwcToNchw", "RowwiseMoments")


def device_ms(torch, fn, names, reps: int = 10, tries: int = 3) -> dict:
    """Device time per call of fn() by kernel-name substring, from a
    torch.profiler trace of `reps` calls after a warm-up call: the kernels
    alone, without the host's launch gaps that CUDA events around the calls
    include.  A trace that holds no kernel of a name is taken again, up to
    `tries` traces; a name still missing is None (not measured), never 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for n in [n for n, v in out.items() if v is None]:
            us = [ev.time_range.elapsed_us() for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA and n in ev.name]
            if us:
                out[n] = sum(us) / 1e3 / reps
        if all(v is not None for v in out.values()):
            break
    return out


def ms_str(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def profile_sample(torch, fn):
    """Device time of one sample call by kernel name, and the device's busy
    share of the call's wall time, from a torch.profiler trace; the kernels
    of PROFILED always.  Returns the call's result and its wall time in
    ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        out = fn()
        wall_us = (time.perf_counter() - t1) * 1e6
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        print("  profiler: no device time recorded", flush=True)
        return out, wall_us / 1e3
    print(f"  profiler: device busy {busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall "
          f"({100 * busy / wall_us:.1f}%, kernels assumed not to overlap)", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"    {us / 1e3:9.2f} ms {100 * us / busy:5.1f}%  {name[:110]}", flush=True)
    for key in PROFILED:
        us = sum(v for name, v in by_name.items() if key in name)
        print(f"    by name: {key} {us / 1e3:.2f} ms ({100 * us / busy:.1f}%)", flush=True)
    return out, wall_us / 1e3


def routed(torch, fn, tc, fma, dt):
    """fn(), which must launch A's, B's or C's tensor-core kernel `tc` once in
    bf16 and its FMA kernel `fma` once in f32, and nothing else of them."""
    before = (tc.launches, fma.launches)
    out = fn()
    bf16 = dt == torch.bfloat16
    if (tc.launches, fma.launches) != (before[0] + bf16, before[1] + (not bf16)):
        raise AssertionError(f"{tc.name} / {fma.name}: a {dt} call took the wrong route")
    return out


def check_kernels(dev):
    """Phase 2: each kernel against its plain version at the main path's
    shapes, in bf16 and f32; returns (max error, (kernel ms, plain ms[,
    library ms])) per kernel, timed in bf16 at the largest shape, and for
    A, B and C also in f32 (their FMA routes, keys "A f32", "B f32" and "C
    f32"); A's device times by kernel under "A device" and "A f32 device"."""
    import torch
    import torch.nn.functional as F

    from resshift_tpu_torch.models.swin import shifted_window_mask
    from resshift_tpu_torch.ops import flash_attention as fa, swin_block as sb, vq

    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    nh, n, c, hidden, bsz = NH, N, C, HIDDEN, BSZ
    # (tokens per image, map side, shifted?) of the Swin calls on the main path
    swin_shapes = [(4096, 64, False), (4096, 64, True), (1024, 32, False), (1024, 32, True),
                   (256, 16, False), (256, 16, True), (64, 8, False)]
    # y: a bf16 output may differ by a rounding flip or two (2^-6 of the
    # largest value); f32 only by summation order.  The (sum, sumsq)
    # statistics add those values in f32 in another order.
    tol = {torch.bfloat16: (2 ** -6, 1e-3), torch.float32: (1e-4, 1e-5)}
    stats_rel = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
    errs = {"A": 0.0, "A f32": 0.0, "B": 0.0, "B f32": 0.0}
    timed = {}
    for dt in (torch.bfloat16, torch.float32):
        rel, atol = tol[dt]
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        for t, side, shift in swin_shapes:
            ws, sh = 8, (4 if shift else 0)
            x = rn(bsz, t, c).to(dt)
            wa, ba = sb.gn_fold(x, 1 + 0.1 * rn(c), 0.1 * rn(c))
            wqkv, bqkv = (rn(c, 3 * c) / c ** 0.5).to(dt), (0.1 * rn(3 * c)).to(dt)
            wproj, bproj = (rn(c, c) / c ** 0.5).to(dt), (0.1 * rn(c)).to(dt)
            nw = (side // ws) ** 2 if shift else 1
            bm = 0.02 * rn(nw, nh, n, n)
            if shift:
                bm = bm + torch.as_tensor(shifted_window_mask(side, side, ws, sh),
                                          device=dev)[:, None]
            args = (x, wa, ba, wqkv, bqkv, wproj, bproj, bm, nh, n)
            if shift:
                geo = (side, side, ws, sh)
                fk = lambda: sb.shift_attn_residual_stats(*args, *geo)
                fp = lambda: sb.shift_attn_residual_stats_plain(*args, *geo)
            else:
                fk = lambda: sb.norm_attn_residual_stats(*args)
                fp = lambda: sb.norm_attn_residual_stats_plain(*args)
            got = routed(torch, fk, sb.SWIN_WINDOW_ATTN_TC, sb.SWIN_WINDOW_ATTN, dt)
            want = fp()
            name = f"A {tag} T={t}{' shift' if shift else ''}"
            e = check(name + " y", got[0], want[0], rel, atol)
            for i, s in ((1, "sum"), (2, "sumsq")):
                check(f"{name} {s}", got[i], want[i], stats_rel[dt], atol)
            key = "A" if dt == torch.bfloat16 else "A f32"
            errs[key] = max(errs[key], e)
            if (t, shift) == (4096, False):
                timed[key] = (cuda_ms(torch, fk), cuda_ms(torch, fp))
                kern = "swin_window_attn_tc_kernel" if key == "A" else "swin_window_attn_kernel"
                dev_ms = device_ms(torch, fk, (kern, "stats_reduce_kernel"))
                timed[f"{key} device"] = dev_ms
                print(f"  {key} ms {timed[key][0]:.4f} ({'tensor cores' if key == 'A' else 'FMA'})"
                      f", plain ms {timed[key][1]:.4f}; device ms by kernel (profiler): "
                      f"{dev_ms}", flush=True)
            elif dt == torch.bfloat16 and not shift:  # the smaller levels: fewer windows
                timed[f"A T={t}"] = (cuda_ms(torch, fk), cuda_ms(torch, fp),
                                     device_ms(torch, fk, ("swin_window_attn_tc_kernel",))[
                                         "swin_window_attn_tc_kernel"])
                print(f"  A T={t} ({bsz * t // n} windows) ms {timed[f'A T={t}'][0]:.4f}, "
                      f"plain ms {timed[f'A T={t}'][1]:.4f}, kernel device ms "
                      f"{ms_str(timed[f'A T={t}'][2])}", flush=True)
            # B on the attention output, the MLP's real input
            y = want[0]
            wm, bmm = sb.fold_stats(want[1:], 1 + 0.1 * rn(c), 0.1 * rn(c), t)
            w1, b1 = (rn(c, hidden) / c ** 0.5).to(dt), (0.1 * rn(hidden)).to(dt)
            w2, b2 = (rn(hidden, c) / hidden ** 0.5).to(dt), (0.1 * rn(c)).to(dt)
            margs = (y, wm, bmm, w1, b1, w2, b2)
            if shift:
                fk = lambda: sb.mlp_unshift_residual_stats(*margs, *geo)
                fp = lambda: sb.mlp_unshift_residual_stats_plain(*margs, *geo)
            else:
                fk = lambda: sb.norm_mlp_residual_stats(*margs)
                fp = lambda: sb.norm_mlp_residual_stats_plain(*margs)
            got, want = routed(torch, fk, sb.SWIN_MLP_TC, sb.SWIN_MLP, dt), fp()
            name = f"B {tag} T={t}{' unshift' if shift else ''}"
            e = check(name + " y", got[0], want[0], rel, atol)
            for i, s in ((1, "sum"), (2, "sumsq")):
                check(f"{name} {s}", got[i], want[i], stats_rel[dt], atol)
            key = "B" if dt == torch.bfloat16 else "B f32"
            errs[key] = max(errs[key], e)
            if (t, shift) == (4096, False):
                timed[key] = (cuda_ms(torch, fk), cuda_ms(torch, fp))
                print(f"  {key} ms {timed[key][0]:.4f} ({'tensor cores' if key == 'B' else 'FMA'})"
                      f", plain ms {timed[key][1]:.4f}", flush=True)
            elif dt == torch.bfloat16 and not shift:  # the smaller levels: fewer CTAs
                timed[f"B T={t}"] = (cuda_ms(torch, fk), cuda_ms(torch, fp))
                print(f"  B T={t} ({bsz * -(-t // 64)} CTAs) ms {timed[f'B T={t}'][0]:.4f}, "
                      f"plain ms {timed[f'B T={t}'][1]:.4f}", flush=True)

        # C at the VQGAN middle: (B, 4096, 512)
        q, k, v = (rn(bsz, 4096, 512).to(dt) for _ in range(3))
        got = routed(torch, lambda: fa.flash_attention_1h(q, k, v), fa.FLASH_ATTN_1H_TC,
                     fa.FLASH_ATTN_1H, dt)
        e = check(f"C {tag} (8, 4096, 512)", got, fa.attention_plain(q, k, v), rel, atol)
        key = "C" if dt == torch.bfloat16 else "C f32"
        errs[key] = e
        timed[key] = (cuda_ms(torch, lambda: fa.flash_attention_1h(q, k, v), reps=5),
                      cuda_ms(torch, lambda: fa.attention_plain(q, k, v), reps=5),
                      cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                          q[:, None], k[:, None], v[:, None]), reps=5))
        print(f"  {key} ms {timed[key][0]:.4f} ({'tensor cores' if key == 'C' else 'FMA'}), "
              f"plain ms {timed[key][1]:.4f}, scaled_dot_product_attention ms "
              f"{timed[key][2]:.4f}", flush=True)
        del q, k, v, got

    # C at a whole photo's latent, (1, 49152, 512) bf16, against the plain
    # version in query chunks (the dense one would hold a 9.7 GB score matrix)
    nq = WIDE_LATENTS[0][0] * WIDE_LATENTS[0][1]
    q, k, v = (rn(1, nq, 512).to(torch.bfloat16) for _ in range(3))
    check(f"C bf16 (1, {nq}, 512)", routed(torch, lambda: fa.flash_attention_1h(q, k, v),
                                           fa.FLASH_ATTN_1H_TC, fa.FLASH_ATTN_1H, q.dtype),
          fa.chunked_attention_plain(q, k, v), *tol[torch.bfloat16])
    timed["C wide"] = (cuda_ms(torch, lambda: fa.flash_attention_1h(q, k, v), reps=2, warmup=1),
                       cuda_ms(torch, lambda: fa.chunked_attention_plain(q, k, v), reps=2,
                               warmup=1),
                       cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                           q[:, None], k[:, None], v[:, None]), reps=2, warmup=1))
    print(f"  C (1, {nq}, 512) ms {timed['C wide'][0]:.4f}, plain (chunked) ms "
          f"{timed['C wide'][1]:.4f}, scaled_dot_product_attention ms {timed['C wide'][2]:.4f}",
          flush=True)
    del q, k, v

    # D at the decodes: 8 x 64^2 latent rows against the f4 8192 x 3 codebook,
    # one face's 64^2 rows against the f8 4096 x 8 one, and a 512x512
    # photo's 512^2 rows against the f4 one (phase 7's call)
    for key, m_rows, k, d in VQ_SHAPES:
        z, emb = rn(m_rows, d), 0.5 * rn(k, d)
        got = vq.nearest_codebook_indices(z, emb)
        want = vq.nearest_codebook_indices_plain(z, emb)
        differ = (got != want).nonzero().flatten()
        errs[key] = 0.0  # the largest f64 distance gap between the two choices
        if differ.numel():
            zz, e64 = z[differ].double(), emb.double()
            da = ((zz - e64[got[differ]]) ** 2).sum(1)
            db = ((zz - e64[want[differ]]) ** 2).sum(1)
            scale = (zz ** 2).sum(1) + torch.maximum((e64[got[differ]] ** 2).sum(1),
                                                     (e64[want[differ]] ** 2).sum(1))
            if not bool(((da - db).abs() <= 1e-6 * scale).all()):
                raise AssertionError(f"{key}: indices differ beyond near-ties")
            errs[key] = (da - db).abs().max().item()
        print(f"  {key} f32 ({m_rows} x {k} x {d}): {differ.numel()} of {m_rows} indices "
              f"differ, all at near-ties (1e-6 relative; largest distance gap "
              f"{errs[key]:.3e})", flush=True)
        del got, want
        fk = lambda: vq.nearest_codebook_indices(z, emb)
        dev_ms = device_ms(torch, fk, ("vq_nearest_kernel", "vq_finalize_kernel"))
        timed[key] = (cuda_ms(torch, fk),
                      cuda_ms(torch, lambda: vq.nearest_codebook_indices_plain(z, emb)), dev_ms)
        print(f"  {key} ms {timed[key][0]:.4f}, plain ms {timed[key][1]:.4f}; device ms by "
              f"kernel (profiler): {dev_ms}", flush=True)
    del z, emb
    torch.cuda.empty_cache()  # the plain version's 8.6 GB distance matrices at 512^2 rows
    return errs, timed


def check_shift(dev):
    """Phase 2, kernel E: exactly the plain gather, both ways, in bf16 and
    f32, at the whole-photo latents (192x256 and 512x512); times E, the
    plain gather and torch.index_select, and returns the bf16 times at
    192x256 (E, plain, index_select)."""
    import torch

    from resshift_tpu_torch.ops import shift as shift_ops
    from resshift_tpu_torch.ops.swin_block import shift_permutation

    g = torch.Generator(device=dev).manual_seed(6)
    timed = None
    for dt in (torch.bfloat16, torch.float32):
        for h, w in WIDE_LATENTS:
            x = torch.randn(1, h * w, C, generator=g, device=dev).to(dt)
            for inverse in (False, True):
                got = shift_ops.shift_tokens(x, h, w, 8, 4, inverse)
                if not torch.equal(got, shift_ops.shift_tokens_plain(x, h, w, 8, 4, inverse)):
                    raise AssertionError(f"E {dt} {h}x{w} inverse={inverse} differs from the gather")
            idx = torch.as_tensor(shift_permutation(h, w, 8, 4)[0], device=dev)
            t = (cuda_ms(torch, lambda: shift_ops.shift_tokens(x, h, w, 8, 4)),
                 cuda_ms(torch, lambda: shift_ops.shift_tokens_plain(x, h, w, 8, 4)),
                 cuda_ms(torch, lambda: torch.index_select(x, 1, idx)))
            print(f"  E {dt} (1, {h * w}, {C}): exact both ways; ms {t[0]:.4f}, plain ms "
                  f"{t[1]:.4f}, index_select ms {t[2]:.4f}", flush=True)
            if dt == torch.bfloat16 and (h, w) == WIDE_LATENTS[0]:
                timed = t
    return timed


def check_wide_block(dev):
    """Phase 2: one shifted Swin block at a 192x256 map in bf16, through E
    around the unshifted A and B and through the shift-absorbing A and B;
    they must agree within phase 2's bf16 band.  Returns both ms."""
    import torch

    from resshift_tpu_torch.models.swin import SwinTransformerBlock
    from resshift_tpu_torch.ops import swin_block as sb

    h, w = WIDE_LATENTS[0]
    g = torch.Generator(device=dev).manual_seed(7)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    blk = SwinTransformerBlock(C, 64, NH, 8, shift=True, dtype=torch.bfloat16).to(dev)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.startswith("norm") and name.endswith("weight"):
                p.copy_(1 + 0.1 * rn(*p.shape))
            elif p.dim() == 1 or name.endswith("table"):
                p.copy_(0.02 * rn(*p.shape))
            else:
                p.copy_(rn(*p.shape) / p[0].numel() ** 0.5)
    xt = rn(1, h * w, C).to(torch.bfloat16)
    orig = sb.shift_fuse_fits

    def route(fused):
        sb.shift_fuse_fits = lambda wd, ws: fused
        try:
            with torch.no_grad():
                return blk(xt, h, w)
        finally:
            sb.shift_fuse_fits = orig

    via_e, fused = route(False), route(True)
    check("wide block y, E route vs fused route", via_e[0], fused[0], 2 ** -6, 1e-3)
    for i, s in ((1, "sum"), (2, "sumsq")):
        check(f"wide block {s}", via_e[i], fused[i], 1e-3, 1e-3)
    ms = (cuda_ms(torch, lambda: route(False)), cuda_ms(torch, lambda: route(True)))
    print(f"  wide block (1, {h * w}, {C}) bf16: E route {ms[0]:.4f} ms, fused route "
          f"{ms[1]:.4f} ms", flush=True)
    return ms


def check_tail(dev):
    """Phase 2, kernel F pinned `use_pallas=True` at TAIL_SHAPES: its
    statistics pass `gn_stats` against the plain `group_norm_fold` (w, b
    within 1e-4 of their largest values), then the wrapper against the plain
    version (the GroupNorm folded the same way), each call checked for its
    route (the heads, f32: gn_stats and the FMA kernel; the decoder tails,
    bf16: gn_stats and the tensor-core kernel): f32 within 2e-4 of the
    largest value, bf16 within phase 2's band.  Times by events the wrapper,
    gn_stats alone, the plain version and the cuDNN composition
    (F.group_norm, F.silu, F.conv2d with the bias), each from x and the
    GroupNorm's parameters, and by the profiler each of F's kernels' device
    time; the bound (x read once) and the two-pass floor (x read twice, y
    written once).  Returns ({"F": bf16 error, "F f32": f32 error, "F stats":
    the statistics' error}, {shape name: its numbers})."""
    import torch
    import torch.nn.functional as F

    from resshift_tpu_torch.ops import tail

    kernels = {"tc": tail.GN_SILU_CONV3X3_TC, "fma": tail.GN_SILU_CONV3X3}
    g = torch.Generator(device=dev).manual_seed(11)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    errs, timed = {"F": 0.0, "F f32": 0.0, "F stats": 0.0}, {}
    for name, b, c, h, w, co, tag in TAIL_SHAPES:
        dt = torch.float32 if tag == "f32" else torch.bfloat16
        eps = 1e-5 if "head" in name else 1e-6
        x = (1.5 * rn(b, c, h, w) + 0.3).to(dt)
        scale, gbias = 1 + 0.2 * rn(c), 0.5 + 0.3 * rn(c)
        weight, bias = (rn(co, c, 3, 3) / (9 * c) ** 0.5).to(dt), (0.1 * rn(co)).to(dt)
        route = tail.tail_route("cuda", dt, c, co)
        if route != ("fma" if tag == "f32" else "tc"):
            raise AssertionError(f"F at {name}: route {route}")
        fk = lambda: tail.gn_silu_conv3x3(x, scale, gbias, weight, bias, eps=eps,
                                          use_pallas=True)
        fs = lambda: tail.gn_stats(x, scale, gbias, eps=eps)
        fold = lambda: tail.group_norm_fold(x, scale, gbias, eps=eps)
        fp = lambda: tail.gn_silu_conv3x3_plain(x, *fold(), weight, bias)
        lib = lambda: F.conv2d(F.silu(F.group_norm(x, 32, scale.to(dt), gbias.to(dt), eps)),
                               weight, bias, padding=1)
        before = (tail.GN_STATS.launches, kernels[route].launches)
        stats = fs()
        got = fk()
        if (tail.GN_STATS.launches, kernels[route].launches) != (before[0] + 2, before[1] + 1):
            raise AssertionError(f"F at {name}: gn_stats and {kernels[route].name} must "
                                 f"launch once a call")
        for got_t, want_t in zip(stats, fold()):
            errs["F stats"] = max(errs["F stats"], check(
                f"gn_stats {tag} {name} {(b, c, h, w)}", got_t, want_t, 1e-4, 0.0))
        rel, atol = (2e-4, 1e-5) if tag == "f32" else (2 ** -6, 1e-3)
        key = "F f32" if tag == "f32" else "F"
        errs[key] = max(errs[key], check(f"F {tag} {name} {(b, c, h, w)} -> {co} ({route})",
                                         got, fp(), rel, atol))
        # x read once, y written once, the taps, the GroupNorm's (C,)
        # parameters; the conv's 9 * co multiply-adds per input element and
        # about 9 operations for its statistics, affine and SiLU
        es = x.element_size()
        x_bytes, y_bytes = b * c * h * w * es, b * co * h * w * es
        nbytes = x_bytes + y_bytes + c * 9 * co * es + 8 * c
        bms, bby = bound(nbytes, b * h * w * c * (18 * co + 9), tag)
        floor_ms = (2 * x_bytes + y_bytes) / PEAK_BYTES * 1e3
        s_ms, s_by = bound(x_bytes + 8 * c + 8 * b * c, 3 * b * c * h * w, tag)
        names = ("gn_stats_kernel", "gn_fold_kernel", kernels[route].name + "_kernel")
        names += ("Memset",) if route == "fma" else ()  # the FMA route's arrival counters
        dev_ms = device_ms(torch, fk, names)
        # F and the cuDNN composition in turns (F, cuDNN, cuDNN, F): at the
        # heads both times are the host's enqueues
        f_ms, lib_ms = (cuda_ms(torch, fk), cuda_ms(torch, lib))
        lib_ms, f_ms = (lib_ms + cuda_ms(torch, lib)) / 2, (f_ms + cuda_ms(torch, fk)) / 2
        t = {"route": route, "ms": f_ms, "plain_ms": cuda_ms(torch, fp),
             "library_ms": lib_ms, "bound_ms": bms, "bound_by": bby,
             "two_pass_floor_ms": floor_ms, "stats_ms": cuda_ms(torch, fs),
             "stats_plain_ms": cuda_ms(torch, fold), "stats_bound_ms": s_ms,
             "stats_bound_by": s_by, "device_ms_by_kernel": dev_ms}
        timed[name] = t
        print(f"  F {name} ({route}): ms {t['ms']:.4f}, plain ms {t['plain_ms']:.4f}, cuDNN "
              f"composition ms {t['library_ms']:.4f}, bound ms {bms:.4f} ({bby}), two-pass "
              f"floor ms {floor_ms:.4f}; gn_stats ms {t['stats_ms']:.4f} (plain fold "
              f"{t['stats_plain_ms']:.4f}, bound {s_ms:.4f}); device ms "
              f"{ {k: ms_str(v) for k, v in dev_ms.items()} }", flush=True)
    return errs, timed


def check_window_attention(dev):
    """Phase 2, kernel K9 against its plain version at (4096, 64, 192), 6
    heads, with one bias and with 64 (rel-pos bias plus the shift mask of a
    64x64 map), in bf16 (the tensor-core kernel window_attn_tc) and f32 (the
    FMA kernel window_attn), each call checked for its route; its gradient
    (the autograd.Function) against plain autograd at 64 windows in f32
    (the backward recomputes through the plain version, so this holds the
    order of the gradients, not a kernel).  The library's one call for the
    same function is F.multi_head_attention_forward with the bias as a
    float mask of shape (M * nh, N, N).  Returns ({"K9": max bf16 error,
    "K9 f32": max f32 error}, {key: (ms, plain ms, library ms, bound ms,
    bound by, {"kernel_device_ms": ...})}), timed with one bias."""
    import torch
    import torch.nn.functional as F

    from resshift_tpu_torch.models.swin import shifted_window_mask
    from resshift_tpu_torch.ops import window_attention as wa

    g = torch.Generator(device=dev).manual_seed(14)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    m, n, c, nh = K9_WINDOWS, N, C, NH
    tol = {torch.bfloat16: (2 ** -6, 1e-3), torch.float32: (1e-4, 1e-5)}
    errs, timed = {"K9": 0.0, "K9 f32": 0.0}, {}
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        key, kname = ("K9", "window_attn_tc_kernel") if tag == "bf16" else ("K9 f32",
                                                                           "window_attn_kernel")
        for nw in (1, 64):
            x = rn(m, n, c).to(dt)
            wts = [(rn(c, 3 * c) / c ** 0.5).to(dt), (0.1 * rn(3 * c)).to(dt),
                   (rn(c, c) / c ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
            bm = 0.02 * rn(nw, nh, n, n)
            if nw > 1:
                bm = bm + torch.as_tensor(shifted_window_mask(64, 64, 8, 4), device=dev)[:, None]
            fk = lambda: wa.window_attention(x, *wts, bm, nh)
            fp = lambda: wa.window_attention_plain(x, *wts, bm, nh)
            got = routed(torch, fk, wa.WINDOW_ATTN_TC, wa.WINDOW_ATTN, dt)
            errs[key] = max(errs[key], check(f"{key} ({m}, {n}, {c}) nW {nw}", got, fp(),
                                             *tol[dt]))
            del got
            if nw == 1:
                isz = x.element_size()
                nbytes = 2 * m * n * c * isz + (4 * c * c + 4 * c) * isz + nh * n * n * 4
                ops = m * (2 * n * c * 3 * c + 4 * n * n * c + 2 * n * c * c)
                mask = bm.to(dt).expand(m, nh, n, n).reshape(m * nh, n, n)
                xt = x.transpose(0, 1)
                fl = lambda: F.multi_head_attention_forward(
                    xt, xt, xt, c, nh, wts[0].t(), wts[1], None, None, False, 0.0, wts[2].t(),
                    wts[3], training=False, need_weights=False, attn_mask=mask)[0]
                check(f"K9's library call {tag} nW {nw} vs plain", fl().transpose(0, 1), fp(),
                      *tol[dt])
                reps = 10 if tag == "bf16" else 3
                extra = {"kernel_device_ms": device_ms(torch, fk, (kname,), reps=reps)[kname]}
                timed[key] = ((cuda_ms(torch, fk, reps=reps), cuda_ms(torch, fp, reps=reps),
                               cuda_ms(torch, fl, reps=reps)) + bound(nbytes, ops, tag)
                              + (extra,))
                t = timed[key]
                print(f"  {key} ms {t[0]:.4f} ({'tensor cores' if tag == 'bf16' else 'FMA'}; "
                      f"kernel device ms {ms_str(extra['kernel_device_ms'])}), plain ms "
                      f"{t[1]:.4f}, multi_head_attention_forward ms {t[2]:.4f} "
                      f"({t[2] / t[0]:.2f}x the kernel's time), bound ms {t[3]:.4f} ({t[4]})",
                      flush=True)
                del mask, xt
    ins = [t.detach().float().clone().requires_grad_() for t in (x[:64], *wts, bm[:1])]
    ref = [t.detach().clone().requires_grad_() for t in ins]
    gy = rn(64, n, c)
    wa.window_attention(*ins, nh).backward(gy)
    wa.window_attention_plain(*ref, nh).backward(gy)
    for name, a, b in zip(("x", "wqkv", "bqkv", "wproj", "bproj", "bias"), ins, ref):
        check(f"K9 backward order f32 (64, {n}, {c}) d{name}", a.grad, b.grad, 1e-4, 1e-5)
    return errs, timed


def check_conv_probes(dev):
    """Phase 2, kernels K10 (Winograd) and P1 (direct conv), each in both
    routes: bf16 on the tensor-core kernels (winograd_conv3x3_tc,
    conv3x3_tc), f32 on the FMA kernels (winograd_conv3x3, conv3x3), each
    call checked for its route.  K10 at K10_SHAPES against the plain
    Winograd formulation (phase 2's bands) and against F.conv2d in f32 (the
    direct conv: 1e-4 relative in f32, the bf16 band in bf16); P1 at
    P1_SHAPE with whole rows and each of P1_ROWS rows per CTA, the same way.
    K10's bf16 route also at each of profile_winograd's nine census shapes
    (H, C, Co), the batch cut to K10_CENSUS_BATCH, the same way, untimed.
    Times each route by CUDA events around the wrapper and by the profiler's
    device time of its kernel, the plain version, F.conv2d (cuDNN,
    channels_last, in the same dtype: with the bias for K10, without for
    P1) and, for K10, the transform U = G g G^T that the wrapper computes
    at every call (`kernel_u`).  Returns ({key: max error}, {key: (ms, plain ms, library
    ms, bound ms, bound by, extras)}), keyed "K10 <shape>", "K10 f32
    <shape>", "P1" and "P1 f32" (errors also "K10 census <shape>")."""
    import torch

    from resshift_tpu_torch.ops import conv3x3 as cv, winograd as wg
    from resshift_tpu_torch.tools import direct_conv as direct
    from resshift_tpu_torch.tools.profile_winograd import SHAPES as census

    g = torch.Generator(device=dev).manual_seed(15)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    tol = {torch.bfloat16: (2 ** -6, 1e-3), torch.float32: (1e-4, 1e-5)}
    errs, timed = {}, {}
    for label, bsz, hw, c, co in K10_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            tag = "bf16" if dt == torch.bfloat16 else "f32"
            key = f"K10 {label}" if dt == torch.bfloat16 else f"K10 f32 {label}"
            kname = "winograd_tc_kernel" if dt == torch.bfloat16 else "winograd_kernel"
            x = (0.3 * rn(bsz, hw, hw, c)).to(dt)
            w, b = (0.05 * rn(3, 3, c, co)).to(dt), 0.1 * rn(co)
            fk = lambda: wg.winograd_conv3x3(x, w, b)
            fp = lambda: wg.winograd_conv3x3_plain(x, w, b)
            got = routed(torch, fk, wg.WINOGRAD_CONV3X3_TC, wg.WINOGRAD_CONV3X3, dt)
            errs[key] = check(f"{key} {(bsz, hw, hw, c)} -> {co} vs plain", got, fp(), *tol[dt])
            check(f"{key} vs direct conv (f32)", got, direct(x.float(), w.float(), b), *tol[dt])
            del got
            isz = x.element_size()
            nbytes = bsz * hw * hw * (c + co) * isz + 16 * c * co * isz + co * 4
            ops = 2 * 16 * bsz * (hw // 2) ** 2 * c * co
            t = (cuda_ms(torch, fk, reps=5), cuda_ms(torch, fp, reps=5),
                 cuda_ms(torch, lambda: direct(x, w, b), reps=5))
            extra = {"kernel_device_ms": device_ms(torch, fk, (kname,), reps=5)[kname],
                     "u_transform_ms": cuda_ms(torch, lambda: wg.kernel_u(w, dt), reps=5)}
            timed[key] = t + bound(nbytes, ops, tag) + (extra,)
            print(f"  {key} ms {t[0]:.4f} (kernel device ms {ms_str(extra['kernel_device_ms'])}, U "
                  f"transform ms {extra['u_transform_ms']:.4f}), plain ms {t[1]:.4f}, F.conv2d ms "
                  f"{t[2]:.4f}, bound ms {timed[key][3]:.4f} ({timed[key][4]})", flush=True)
            del x
    bf = torch.bfloat16
    for label, _, hw, c, co in census:
        key, bsz = f"K10 census {' '.join(label.split())}", K10_CENSUS_BATCH
        x = (0.3 * rn(bsz, hw, hw, c)).to(bf)
        w, b = (0.05 * rn(3, 3, c, co)).to(bf), 0.1 * rn(co)
        got = routed(torch, lambda: wg.winograd_conv3x3(x, w, b), wg.WINOGRAD_CONV3X3_TC,
                     wg.WINOGRAD_CONV3X3, bf)
        errs[key] = check(f"{key} {(bsz, hw, hw, c)} -> {co} vs plain", got,
                          wg.winograd_conv3x3_plain(x, w, b), *tol[bf])
        check(f"{key} vs direct conv (f32)", got, direct(x.float(), w.float(), b), *tol[bf])
        del x, got
    bsz, hw, _, c = P1_SHAPE
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        key = "P1" if dt == torch.bfloat16 else "P1 f32"
        kname = "conv3x3_tc_kernel" if dt == torch.bfloat16 else "conv3x3_kernel"
        x, w = (0.3 * rn(bsz, hw, hw, c)).to(dt), (0.05 * rn(3, 3, c, c)).to(dt)
        want, ref = cv.conv3x3_plain(x, w), direct(x.float(), w.float(), None)
        errs[key] = 0.0
        for r in (None, *P1_ROWS):
            got = routed(torch, lambda: cv.conv3x3(x, w, rows=r), cv.CONV3X3_TC, cv.CONV3X3, dt)
            name = f"{key} {P1_SHAPE} -> {c} rows {r or 'whole'}"
            errs[key] = max(errs[key], check(f"{name} vs plain", got, want, *tol[dt]))
            check(f"{name} vs direct conv (f32)", got, ref, *tol[dt])
        fk = lambda: cv.conv3x3(x, w)
        t = (cuda_ms(torch, fk), cuda_ms(torch, lambda: cv.conv3x3_plain(x, w)),
             cuda_ms(torch, lambda: direct(x, w, None)))
        extra = {"kernel_device_ms": device_ms(torch, fk, (kname,))[kname],
                 "ms_by_rows": {r: cuda_ms(torch, lambda: cv.conv3x3(x, w, rows=r))
                                for r in P1_ROWS}}
        nbytes = 2 * bsz * hw * hw * c * x.element_size() + 9 * c * c * x.element_size()
        timed[key] = t + bound(nbytes, 2 * bsz * hw * hw * 9 * c * c, tag) + (extra,)
        print(f"  {key} ms {t[0]:.4f} (whole rows; kernel device ms "
              f"{ms_str(extra['kernel_device_ms'])}; by rows {extra['ms_by_rows']}), plain ms "
              f"{t[1]:.4f}, F.conv2d ms {t[2]:.4f}, bound ms {timed[key][3]:.4f} "
              f"({timed[key][4]})", flush=True)
    return errs, timed


def check_attn_variants(dev):
    """Phase 2, probe P2 at (8, 4096, 192), 6 heads, each softmax mode
    against its plain version, in bf16 (the tensor-core kernel
    attn_variants_tc) and f32 (the FMA kernel attn_variants), each call
    checked for its route; in f32 the f32 mode against kernel A's y too
    (they differ only where the folded shift of 30 rounds).  Each route and
    mode is timed by events and by the profiler's device time of its kernel.
    Returns ({"P2": max bf16 error, "P2 f32": max f32 error}, {key: {mode:
    (ms, plain ms, bound ms, bound by, {"kernel_device_ms": ...})}})."""
    import torch

    from resshift_tpu_torch.ops import attn_variants as av, swin_block as sb

    g = torch.Generator(device=dev).manual_seed(16)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    bsz, t, c, nh, n = BSZ, 4096, C, NH, N
    tol = {torch.bfloat16: (2 ** -6, 1e-3), torch.float32: (1e-4, 1e-5)}
    ops = bsz * t // n * (2 * n * c * 3 * c + 4 * n * n * c + 2 * n * c * c)
    errs, timed = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        key, kname = ("P2", "attn_variants_tc_kernel") if tag == "bf16" else (
            "P2 f32", "attn_variant_kernel")
        x = rn(bsz, t, c).to(dt)
        wa, ba = sb.gn_fold(x, 1 + 0.1 * rn(c), 0.1 * rn(c))
        wts = [(rn(c, 3 * c) / c ** 0.5).to(dt), (0.1 * rn(3 * c)).to(dt),
               (rn(c, c) / c ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
        args = (x, wa, ba, *wts, 0.02 * rn(1, nh, n, n), nh, n)
        isz = x.element_size()
        nbytes = (2 * bsz * t * c * isz + (4 * c * c + 4 * c) * isz + 2 * bsz * c * 4
                  + nh * n * n * 4)
        errs[key], timed[key] = 0.0, {}
        for sm in av.SOFTMAX_MODES:
            fk = lambda: av.attn_variant(*args, sm)
            fp = lambda: av.attn_variant_plain(*args, sm)
            got = routed(torch, fk, av.ATTN_VARIANTS_TC, av.ATTN_VARIANTS, dt)
            errs[key] = max(errs[key], check(f"{key} {sm} ({bsz}, {t}, {c})", got, fp(),
                                             *tol[dt]))
            if sm == "f32" and dt == torch.float32:
                check("P2 f32 f32-mode vs kernel A's y", got,
                      sb.norm_attn_residual_stats(*args)[0], *tol[dt])
            del got
            extra = {"kernel_device_ms": device_ms(torch, fk, (kname,))[kname]}
            tk = (cuda_ms(torch, fk), cuda_ms(torch, fp)) + bound(nbytes, ops, tag) + (extra,)
            timed[key][sm] = tk
            print(f"  {key} {sm} ms {tk[0]:.4f} (kernel device ms "
                  f"{ms_str(extra['kernel_device_ms'])}), plain ms {tk[1]:.4f}, bound ms "
                  f"{tk[2]:.4f} ({tk[3]})", flush=True)
    return errs, timed


def check_grads(dev):
    """Phase 2, the kernels' backward passes, in bf16 and f32: A (plain and
    shifted at a 64x64 map) and B (plain and unshifting) at (8, 4096, 192),
    F at the UNet head (f32) and the f4 decoder tail (bf16): the gradients of
    every input through the wrapper (the kernel's forward, the plain
    version's gradient recomputed by `_ext.Recompute`) against the plain
    version's under autograd, of a fixed random weighting of every output,
    within phase 2's band of the largest gradient (the two differ only where
    the plain backward's scatter-adds sum in another order), with the share
    of bit-equal values; E at the 192x256 latent: its backward launches E
    inverse and equals the plain gather's gradient bit for bit.  Returns the
    largest relative error per kernel and dtype."""
    import torch

    from resshift_tpu_torch.models.swin import shifted_window_mask
    from resshift_tpu_torch.ops import shift as shift_ops, swin_block as sb, tail

    g = torch.Generator(device=dev).manual_seed(21)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    band = {torch.bfloat16: 2 ** -6, torch.float32: 1e-4}
    errs = {}

    def compare(name, dt, fn, plain, ins, counter=None, launches=0):
        """The gradients of sum(out * r) through fn and through plain."""
        ins = [t.detach().requires_grad_(True) if t.is_floating_point() else t for t in ins]
        before = counter.launches if counter is not None else 0
        outs = fn(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        rs = [rn(*o.shape) for o in outs]
        wanted = [t for t in ins if t.requires_grad]
        got = torch.autograd.grad(sum((o.float() * r).sum() for o, r in zip(outs, rs)), wanted)
        if counter is not None and counter.launches - before != launches:
            raise AssertionError(f"{name}: {counter.name} launched "
                                 f"{counter.launches - before} times, want {launches}")
        pouts = plain(*ins)
        pouts = pouts if isinstance(pouts, tuple) else (pouts,)
        want = torch.autograd.grad(sum((o.float() * r).sum() for o, r in zip(pouts, rs)), wanted)
        worst, same, total = 0.0, 0, 0
        for a, b in zip(got, want):
            err = (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(),
                                                                  1e-30)
            worst = max(worst, err)
            same += (a == b).sum().item()
            total += b.numel()
        tag = f"{name} {'bf16' if dt == torch.bfloat16 else 'f32'}"
        print(f"  backward {tag}: {len(got)} gradients, max error {worst:.3e} of the largest "
              f"(band {band[dt]:.3e}), {100 * same / total:.2f}% bit-equal", flush=True)
        if not worst <= band[dt]:
            raise AssertionError(f"backward {tag}: error {worst} above {band[dt]}")
        errs[tag] = max(errs.get(tag, 0.0), worst)
        return same == total

    nh, n, c, hidden, bsz, side, ws = NH, N, C, HIDDEN, BSZ, 64, 8
    for dt in (torch.bfloat16, torch.float32):
        x = rn(bsz, side * side, c).to(dt)
        wa, ba = sb.gn_fold(x, 1 + 0.1 * rn(c), 0.1 * rn(c))
        wts = [(rn(c, 3 * c) / c ** 0.5).to(dt), (0.1 * rn(3 * c)).to(dt),
               (rn(c, c) / c ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
        bm = 0.02 * rn(1, nh, n, n)
        a_tc = sb.SWIN_WINDOW_ATTN_TC if dt == torch.bfloat16 else sb.SWIN_WINDOW_ATTN
        compare("A", dt, lambda *a: sb.norm_attn_residual_stats(*a, nh, n),
                lambda *a: sb.norm_attn_residual_stats_plain(*a, nh, n),
                [x, wa, ba, *wts, bm], a_tc, 1)
        bms = bm + torch.as_tensor(shifted_window_mask(side, side, ws, 4), device=dev)[:, None]
        geo = (side, side, ws, 4)
        compare("A shifted", dt, lambda *a: sb.shift_attn_residual_stats(*a, nh, n, *geo),
                lambda *a: sb.shift_attn_residual_stats_plain(*a, nh, n, *geo),
                [x, wa, ba, *wts, bms], a_tc, 1)
        mlp = [(rn(c, hidden) / c ** 0.5).to(dt), (0.1 * rn(hidden)).to(dt),
               (rn(hidden, c) / hidden ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
        b_tc = sb.SWIN_MLP_TC if dt == torch.bfloat16 else sb.SWIN_MLP
        compare("B", dt, sb.norm_mlp_residual_stats, sb.norm_mlp_residual_stats_plain,
                [x, wa, ba, *mlp], b_tc, 1)
        compare("B unshifting", dt, lambda *a: sb.mlp_unshift_residual_stats(*a, *geo),
                lambda *a: sb.mlp_unshift_residual_stats_plain(*a, *geo),
                [x, wa, ba, *mlp], b_tc, 1)
        h, w = WIDE_LATENTS[0]
        xe = rn(1, h * w, c).to(dt)
        for inverse in (False, True):
            if not compare(f"E inverse={inverse}", dt,
                           lambda t: shift_ops.shift_tokens(t, h, w, ws, 4, inverse),
                           lambda t: shift_ops.shift_tokens_plain(t, h, w, ws, 4, inverse),
                           [xe], shift_ops.SHIFT_TOKENS, 2):
                raise AssertionError(f"E's backward differs from the gather's gradient ({dt})")
    for name, b, c, h, w, co, tag in TAIL_SHAPES[0:3:2]:  # the UNet head (f32), the f4 tail
        dt = torch.float32 if tag == "f32" else torch.bfloat16
        eps = 1e-5 if "head" in name else 1e-6
        ins = [(1.5 * rn(b, c, h, w) + 0.3).to(dt), 1 + 0.2 * rn(c), 0.5 + 0.3 * rn(c),
               (rn(co, c, 3, 3) / (9 * c) ** 0.5).to(dt), (0.1 * rn(co)).to(dt)]
        route = tail.tail_route("cuda", dt, c, co)
        kern = tail.GN_SILU_CONV3X3_TC if route == "tc" else tail.GN_SILU_CONV3X3
        plain = lambda x, s, gb, wt, bi: tail.gn_silu_conv3x3_plain(
            x, *tail.group_norm_fold(x, s, gb, eps=eps), wt, bi)
        compare(f"F {name}", dt, lambda *a: tail.gn_silu_conv3x3(*a, eps=eps, use_pallas=True),
                plain, ins, kern, 1)
    return errs


def realsr_train_config(hq_dirs: list, val_lq: str, val_gt: str) -> dict:
    """configs/realsr_swinunet_realesrgan256.yaml as `load_yaml_config` gives
    it (the card's machine has no PyYAML), with the data paths replaced by
    `hq_dirs`, `val_lq` and `val_gt` and no VQGAN checkpoint (random
    weights): realsr_v1 with the RealESRGAN degradation, batch 64 in
    microbatches of 8, GT crops of 256."""
    from resshift_tpu_torch.config import task_config

    cfg = task_config("realsr_v1")
    cfg["model"]["ckpt_path"] = None
    cfg["autoencoder"]["ckpt_path"] = None
    cfg["degradation"] = dict(
        sf=4, resize_prob=[0.2, 0.7, 0.1], resize_range=[0.15, 1.5], gaussian_noise_prob=0.5,
        noise_range=[1, 30], poisson_scale_range=[0.05, 3.0], gray_noise_prob=0.4,
        jpeg_range=[30, 95], second_order_prob=0.5, second_blur_prob=0.8,
        resize_prob2=[0.3, 0.4, 0.3], resize_range2=[0.3, 1.2], gaussian_noise_prob2=0.5,
        noise_range2=[1, 25], poisson_scale_range2=[0.05, 2.5], gray_noise_prob2=0.4,
        jpeg_range2=[30, 95], gt_size=256, resize_back=False, use_sharp=False)
    cfg["data"] = dict(
        train=dict(type="realesrgan", params=dict(
            dir_paths=list(hq_dirs), txt_file_path=[], im_exts=["JPEG"], blur_kernel_size=21,
            sinc_prob=0.1, blur_sigma=[0.2, 3.0], betag_range=[0.5, 4.0], betap_range=[1, 2.0],
            blur_kernel_size2=15, sinc_prob2=0.1, blur_sigma2=[0.2, 1.5],
            betag_range2=[0.5, 4.0], betap_range2=[1, 2.0], final_sinc_prob=0.8, gt_size=256,
            crop_pad_size=300, use_hflip=True, use_rot=False, rescale_gt=True)),
        val=dict(type="base", params=dict(dir_path=val_lq, extra_dir_path=val_gt)))
    # as PyYAML reads them: 5e-5 (no dot) is a string, which TrainConfig converts
    cfg["train"] = dict(lr="5e-5", lr_min="2e-5", lr_schedule=None, warmup_iterations=5000,
                        batch=[64, 8], microbatch=8, num_workers=4, weight_decay=0,
                        ema_rate=0.999, iterations=300000, save_freq=10000,
                        log_freq=[200, 2000], val_freq=10000, seed=123456)
    return cfg


def run_main(module: str, argv: list) -> str:
    """`module.main(argv)` (what `python -m module` calls) in this process,
    its standard output captured and returned: no interpreter to start."""
    import contextlib
    import importlib
    import io

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        importlib.import_module(module).main(argv)
    return printed.getvalue()


def counting(calls: dict, fn, key: str, read, reset):
    """fn with the launches of each call (counts zeroed before it, read after
    a synchronize) appended to calls[key]."""
    import torch

    def wrapped(*a, **k):
        reset()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        calls.setdefault(key, []).append(read())
        return out
    return wrapped


def bicsr_lpips_config(source: str, val_lq: str, val_gt: str) -> dict:
    """configs/bicx4_swinunet_lpips.yaml as `load_yaml_config` gives it (the
    bicsr task with the LPIPS trainer), with the data paths replaced and no
    VQGAN or LPIPS weights (random: none may be downloaded): batch 96 in
    microbatches of 12, GT crops of 256 and their x1/4 MATLAB bicubic."""
    from resshift_tpu_torch.config import task_config

    cfg = task_config("bicsr")
    cfg["trainer"] = "difir_lpips"
    cfg["autoencoder"]["ckpt_path"] = None
    cfg["data"] = dict(
        train=dict(type="bicubic", params=dict(
            source_path=source, degrade_kwargs=dict(scale=0.25, pch_size=256),
            transform_kwargs=dict(mean=0.5, std=0.5))),
        val=dict(type="base", params=dict(dir_path=val_lq, extra_dir_path=val_gt)))
    cfg["train"] = dict(lr="5e-5", lr_min="2e-5", lr_schedule="cosin", warmup_iterations=5000,
                        batch=[96, 12], microbatch=12, iterations=300000, loss_coef=[1.0, 1.0],
                        lpips_path=None, save_freq=10000, log_freq=[200, 2000])
    return cfg


def inpaint_face_lpips_config(images: str, val_lq: str, val_gt: str, val_mask: str) -> dict:
    """configs/inpaint_lama256_face.yaml as `load_yaml_config` gives it, with
    the data paths replaced and no VQGAN or LPIPS weights: LaMa distortions
    and masks at 256, batch 96 in microbatches of 12."""
    from resshift_tpu_torch.config import task_config

    cfg = task_config("inpaint_face")
    cfg["trainer"] = "difir_lpips"
    cfg["autoencoder"]["ckpt_path"] = None
    cfg["data"] = dict(
        train=dict(type="inpainting", params=dict(
            dir_path=images, pch_size=256, transform_type="lama_distortions",
            mask_kwargs=dict(
                irregular_proba=1, irregular_kwargs=dict(max_angle=4, max_len=200, max_width=100,
                                                         max_times=5, min_times=1),
                box_proba=1, box_kwargs=dict(margin=10, bbox_min_size=30, bbox_max_size=150,
                                             max_times=4, min_times=1)))),
        val=dict(type="inpainting_val", params=dict(lq_path=val_lq, gt_path=val_gt,
                                                    mask_path=val_mask)))
    cfg["train"] = dict(lr="5e-5", lr_schedule="cosin", batch=[96, 12], microbatch=12,
                        iterations=400000, loss_coef=[1.0, 1.0], lpips_path=None)
    return cfg


def faceir_lpips_config(faces: str, val: str) -> dict:
    """configs/faceir_gfpgan512_lpips.yaml as `load_yaml_config` gives it
    (faceir with the LPIPS trainer), with the data paths replaced and no
    VQGAN or LPIPS weights: the GFPGAN-style degradation of 512x512 faces,
    the f8 VQGAN, batch 96 in microbatches of 12, validation on a folder of
    faces without GT."""
    from resshift_tpu_torch.config import task_config

    cfg = task_config("faceir")
    cfg["trainer"] = "difir_lpips"
    cfg["autoencoder"]["ckpt_path"] = None
    cfg["data"] = dict(
        train=dict(type="gfpgan", params=dict(
            dir_path=faces, out_size=512, blur_kernel_size=41, kernel_list=["iso", "aniso"],
            kernel_prob=[0.5, 0.5], blur_sigma=[0.1, 10], downsample_range=[0.8, 8],
            noise_range=[0, 20], jpeg_range=[60, 100], use_hflip=True, color_jitter_prob=None,
            gray_prob=0.01)),
        val=dict(type="base", params=dict(dir_path=val)))
    cfg["train"] = dict(lr="5e-5", lr_schedule="cosin", batch=[96, 12], microbatch=12,
                        iterations=400000, loss_coef=[1.0, 1.0], lpips_path=None)
    return cfg


def jpeg_probe_image():
    """The seeded 37x53 RGB image whose JPEG round trips phase 19 holds to
    `JPEG_DIGESTS`: a smooth field with noise."""
    import numpy as np

    rng = np.random.default_rng(1914)
    yy, xx = np.mgrid[0:37, 0:53]
    field = np.stack([128 + 90 * np.sin(xx / 6 + c) * np.cos(yy / 5 - c) for c in range(3)], -1)
    return np.clip(field + rng.normal(0, 12, field.shape), 0, 255).astype(np.uint8)


# SHA-256 of OpenCV's JPEG round trip (imencode / imdecode, libjpeg-turbo)
# of `jpeg_probe_image()` at each quality: pinned, and held equal to
# OpenCV and to ops/jpeg.py, by tests/test_torch_jpeg.py
JPEG_DIGESTS = {30: "7207dd356fb04a89d9baa81711c424d05621f07d0b73dc90a6381a5c349ab5c9",
                60: "90a1fa9ac80bb423f1b8180db02adaa263755059738b5930bc07f6c5d319d2c1",
                95: "82c6ae44ef8f6f3b8ca87f515ee21a91ee8b3e0731dce0d6de21af307fc2a1cb"}


def write_train_data(root: Path, n_hq: int, n_val: int, n_pairs: int) -> dict:
    """Seeded synthetic PNGs (smooth random fields, written by the port's
    codec): `n_hq` 320x320 HQ images, `n_val` 64 -> 256 validation pairs and
    `n_pairs` such pairs for paired training.  Returns the folders."""
    import numpy as np

    from resshift_tpu_torch.ops.resize import resize_np
    from resshift_tpu_torch.utils.image_io import imwrite

    rng = np.random.default_rng(31)
    dirs = {k: root / k for k in ("hq", "val_lq", "val_gt", "pair_lq", "pair_gt")}
    for d in dirs.values():
        d.mkdir(parents=True)

    def field(side):
        return np.clip(resize_np(rng.uniform(0, 1, (side // 8, side // 8, 3)), (side, side),
                                 "bilinear") + rng.normal(0, 0.03, (side, side, 3)), 0, 1)

    for i in range(n_hq):
        imwrite(field(320), dirs["hq"] / f"{i:03d}.png")
    for (lq_dir, gt_dir), n in (((dirs["val_lq"], dirs["val_gt"]), n_val),
                                ((dirs["pair_lq"], dirs["pair_gt"]), n_pairs)):
        for i in range(n):
            gt = field(256)
            imwrite(gt, gt_dir / f"{i:03d}.png")
            imwrite(resize_np(gt, (64, 64), "bicubic_matlab"), lq_dir / f"{i:03d}.png")
    return dirs


def train_phase(dev, card: str, all_kernels: dict, read_launches, reset, launches: dict):
    """Phase 17: realsr_v1 training at full width (see the module docstring).
    Returns its figures."""
    import torch

    from resshift_tpu_torch.ops import swin_block as sb
    from resshift_tpu_torch.pipeline import ResShiftPipeline
    from resshift_tpu_torch.train_loop import Trainer
    from resshift_tpu_torch.trainer import TrainConfig, TrainStep

    calls: dict[str, list] = {}
    counted = lambda fn, key: counting(calls, fn, key, lambda: read_launches(all_kernels, sb),
                                       reset)

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    t1 = time.perf_counter()
    dirs = write_train_data(root, 96, 2, 32)
    print(f"  data: 96 HQ 320x320 PNGs, 2 + 32 pairs 64 -> 256, written in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    # ------------------------------------------------------------ 17(a)
    cfg = realsr_train_config([str(dirs["hq"])], str(dirs["val_lq"]), str(dirs["val_gt"]))
    cfg["train"].update(log_freq=[1, 2], val_freq=3)  # grids at 2, validation at 3
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, save_dir=str(root / "run_a"), dtype=torch.bfloat16, seed=0)
    tr.train_step = counted(tr.train_step, "17 steps")
    tr.log_train_images = counted(tr.log_train_images, "17 grids")
    tr.validate = counted(tr.validate, "17 validate")
    tr.train(stop_iter=3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log_text = (root / "run_a" / "train_log.jsonl").read_text()
    log = [json.loads(ln) for ln in log_text.splitlines()]
    steps = [m for m in log if "loss" in m]
    for m in steps:
        print(f"  iteration {m['iter']}: loss {m['loss']:.5f}, grad_norm {m['grad_norm']:.4f}, "
              f"lr {m['lr']:.4e}, loader {m['loader_ms']:.1f} ms, degrader "
              f"{m['degrade_ms']:.1f} ms, step {m['step_ms']:.1f} ms", flush=True)
        if not (math.isfinite(m["loss"]) and m["loss"] > 0 and math.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            raise AssertionError(f"iteration {m['iter']}: loss or grad_norm not finite and > 0")
    if [m["iter"] for m in steps] != [1, 2, 3]:
        raise AssertionError(f"logged iterations {[m['iter'] for m in steps]}")
    zero = [n for n, p in tr.step_fn.named
            if p.grad is None or not p.grad.abs().max().item() > 0]
    print(f"  UNet parameters with a nonzero gradient: {len(tr.step_fn.named) - len(zero)} of "
          f"{len(tr.step_fn.named)}", flush=True)
    if zero:
        raise AssertionError(f"{len(zero)} UNet parameters without a gradient, e.g. {zero[:3]}")
    mb = tr.tcfg.microbatch
    per_step = {k: 0 for k in calls["17 steps"][0]}
    per_step["C"] = 2 * (tr.batch // mb)  # two encodes a microbatch
    print(f"  launches a step: {calls['17 steps']}", flush=True)
    if any(got != per_step for got in calls["17 steps"]):
        raise AssertionError(f"step launches {calls['17 steps']}, want {per_step} each")
    launches["17 step"] = calls["17 steps"][0]
    # validation: the progressive strip of the first pair, then one sample
    # call on both pairs (one shape group)
    want = validation_launches(cfg, tr.pipe.sched.num_timesteps)
    (got,) = calls["17 validate"]
    print(f"  launches in validation: {got} (derived: {want})", flush=True)
    if got != want:
        raise AssertionError(f"validation launches {got}, want {want}")
    launches["17 validate"] = got
    (launches["17 grids"],) = calls["17 grids"]
    print(f"  launches in the iteration-2 grids: {launches['17 grids']}", flush=True)
    val = [m for m in log if "val_psnr_y" in m]
    if not (val and math.isfinite(val[0]["val_psnr_y"])):
        raise AssertionError(f"no finite validation metrics in the log: {val}")
    images = sorted(p.name for p in (root / "run_a" / "images").rglob("*.png"))
    if len(images) != 6:
        raise AssertionError(f"images written: {images}")
    times = {k: statistics.median(t[k] for t in tr.timings[1:3])
             for k in ("loader_ms", "degrade_ms", "step_ms")}
    it_ms = sum(times.values())
    print(f"  validation PSNR(Y) {val[0]['val_psnr_y']:.2f} dB (random weights); images "
          f"{images}", flush=True)
    print(f"  ms per iteration (median of iterations 2-3): {it_ms:.1f} = loader "
          f"{times['loader_ms']:.1f} + degrader {times['degrade_ms']:.1f} + step "
          f"{times['step_ms']:.1f}; {tr.batch / (it_ms / 1e3):.2f} images/s "
          f"({tr.batch / (times['step_ms'] / 1e3):.2f} in the step alone); peak "
          f"max_memory_allocated {peak_gib:.2f} GiB; on {card}", flush=True)
    result = {"ms_per_iteration": it_ms, **times, "peak_gib": peak_gib,
              "images_per_s": tr.batch / (it_ms / 1e3)}
    del tr

    # ------------------------------------------------------------ 17(b)
    print("  17(b): resume on paired data (base type, batch 16 in microbatches of 8): 3 "
          "iterations straight against 2 + save + resume + 1, deterministic algorithms on",
          flush=True)
    cfg_b = realsr_train_config([], "", "")
    cfg_b["data"] = dict(train=dict(type="base", params=dict(
        dir_path=str(dirs["pair_lq"]), extra_dir_path=str(dirs["pair_gt"]))))
    cfg_b["train"].update(batch=16, num_workers=0, log_freq=[1000, 1000], save_freq=1000)
    torch.use_deterministic_algorithms(True)
    try:
        straight = Trainer(cfg_b, save_dir=str(root / "b1"), dtype=torch.bfloat16, seed=0)
        straight.train(stop_iter=3)
        first = Trainer(cfg_b, save_dir=str(root / "b2"), dtype=torch.bfloat16, seed=0)
        first.train(stop_iter=2)
        del first
        resumed = Trainer(cfg_b, save_dir=str(root / "b3"), dtype=torch.bfloat16, seed=0,
                          resume=str(root / "b2" / "ckpts" / "step_00000002"))
        resumed.train(stop_iter=3)
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = straight.step_fn.state_dict(), resumed.step_fn.state_dict()
    same = total = 0
    for part in ("params", "ema", "exp_avg", "exp_avg_sq"):
        for k, v in a[part].items():
            same += (v == b[part][k]).sum().item()
            total += v.numel()
    print(f"  resume: step {b['step']} (straight {a['step']}); {100 * same / total:.4f}% of "
          f"params, EMA and moments bit-equal", flush=True)
    if a["step"] != b["step"] or same != total:
        raise AssertionError(f"the resumed run differs from the straight one: {same} of {total} "
                             f"values bit-equal")
    result["resume_bit_equal_share"] = same / total
    del straight, resumed, a, b

    # ------------------------------------------------------------ 17(c)
    print("  17(c): one microbatch's gradient with kernels A and B (use_pallas None, their "
          "autograd Functions) against the plain composition (use_pallas False)", flush=True)
    batch = {"gt": torch.rand(8, 256, 256, 3, generator=torch.Generator().manual_seed(33)),
             "lq": torch.rand(8, 64, 64, 3, generator=torch.Generator().manual_seed(34))}
    batch = {k: (v * 2 - 1).to(dev) for k, v in batch.items()}
    for dt, bar in ((torch.float32, 1e-3), (torch.bfloat16, None)):
        pipe = ResShiftPipeline(realsr_train_config([], "", ""), dtype=dt)
        pipe.init_params(0)
        step = TrainStep(pipe, TrainConfig(microbatch=8))
        grads = {}
        for pin in (None, False):
            step.train_unet = pipe.unet.clone(use_pallas=pin).train()
            reset()
            step.grads(batch, torch.Generator(device=dev).manual_seed(35))
            n = read_launches(all_kernels, sb)
            key = "A" if dt == torch.bfloat16 else "A f32"
            if bool(n[key]) != (pin is None):
                raise AssertionError(f"use_pallas={pin}: A launched {n[key]} times")
            grads[pin] = torch.cat([p.grad.float().flatten() for _, p in step.named])
        rel = ((grads[None] - grads[False]).norm() / grads[False].norm()).item()
        tag = "f32" if dt == torch.float32 else "bf16"
        print(f"  {tag}: relative L2 of the gradient, kernels against plain: {rel:.3e}"
              + (f" (bar {bar})" if bar else " (not gated)"), flush=True)
        if bar and not rel <= bar:
            raise AssertionError(f"gradient with the kernels off by {rel} (relative L2)")
        result[f"grad_rel_l2_{tag}"] = rel
        del pipe, step, grads
    tmp.cleanup()
    return result


def lpips_phase(dev, card: str, all_kernels: dict, read_launches, reset, launches: dict,
                workers: int = 8):
    """Phase 18: the LPIPS trainer at full width (see the module docstring).
    Returns its figures."""
    import numpy as np

    from resshift_tpu_torch.ops.resize import resize_np
    from resshift_tpu_torch.utils.image_io import imwrite

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    rng = np.random.default_rng(41)
    dirs = {k: root / k for k in ("hq", "faces", "val_lq", "val_gt", "inp_lq", "inp_gt",
                                  "inp_mask")}
    for d in dirs.values():
        d.mkdir()

    def field(h, w):
        return np.clip(resize_np(rng.uniform(0, 1, (h // 8, w // 8, 3)), (h, w), "bilinear")
                       + rng.normal(0, 0.03, (h, w, 3)), 0, 1)

    t1 = time.perf_counter()
    for i in range(96):
        imwrite(field(288, 288), dirs["hq"] / f"{i:03d}.png")
        imwrite(field(320, 288), dirs["faces"] / f"{i:03d}.png")
    for i in range(2):
        gt = field(256, 256)
        imwrite(gt, dirs["val_gt"] / f"{i:03d}.png")
        imwrite(resize_np(gt, (64, 64), "bicubic_matlab"), dirs["val_lq"] / f"{i:03d}.png")
        mask = np.zeros((256, 256))
        mask[64 + 32 * i:160 + 32 * i, 48:208] = 1
        imwrite(gt, dirs["inp_gt"] / f"{i:03d}.png")
        imwrite(gt * (1 - mask[..., None]), dirs["inp_lq"] / f"{i:03d}.png")
        imwrite(mask, dirs["inp_mask"] / f"{i:03d}.png")
    print(f"  data: 96 HQ 288x288 and 96 face-sized 320x288 PNGs, 2 bicsr and 2 inpainting "
          f"validation sets, written in {time.perf_counter() - t1:.1f} s", flush=True)
    result = {}
    for part, cfg in (
            ("a", bicsr_lpips_config(str(dirs["hq"]), str(dirs["val_lq"]), str(dirs["val_gt"]))),
            ("b", inpaint_face_lpips_config(str(dirs["faces"]), str(dirs["inp_lq"]),
                                            str(dirs["inp_gt"]), str(dirs["inp_mask"])))):
        n_iter = 2  # 18(a) trained 3 until phase 21 needed the time
        name = "bicx4_swinunet_lpips" if part == "a" else "inpaint_lama256_face"
        result[part] = train_lpips(f"18{part}", name, cfg, n_iter, root / f"run_{part}", card,
                                   all_kernels, read_launches, reset, launches, workers)
    tmp.cleanup()
    return result


def faceir_phase(dev, card: str, all_kernels: dict, read_launches, reset, launches: dict,
                 workers: int = 8) -> dict:
    """Phase 19: faceir training at full width, `scripts celeba-faceir`, the
    bsrgan loaders and the JAX-free JPEG round trip (see the module
    docstring).  Returns its figures."""
    import hashlib

    import numpy as np

    from resshift_tpu_torch.data.datasets import DataLoader, create_dataset
    from resshift_tpu_torch.ops.jpeg import jpeg_roundtrip
    from resshift_tpu_torch.ops.resize import resize_np
    from resshift_tpu_torch.utils.image_io import imread, imwrite

    # (c) first: integer arithmetic, so the bits must be those pinned here
    probe = jpeg_probe_image()
    got = {q: hashlib.sha256(jpeg_roundtrip(probe, q).tobytes()).hexdigest()
           for q in JPEG_DIGESTS}
    print(f"  19(c): JPEG round trip of the 37x53 probe at qualities {sorted(got)}: "
          f"{'equal to' if got == JPEG_DIGESTS else 'DIFFERENT from'} OpenCV's pinned "
          f"SHA-256 digests", flush=True)
    if got != JPEG_DIGESTS:
        raise AssertionError(f"JPEG digests {got}, want {JPEG_DIGESTS}")

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    rng = np.random.default_rng(19)
    dirs = {k: root / k for k in ("faces", "val", "celeba")}
    for d in dirs.values():
        d.mkdir()

    def face():
        return np.clip(resize_np(rng.uniform(0, 1, (64, 64, 3)), (512, 512), "bilinear")
                       + rng.normal(0, 0.03, (512, 512, 3)), 0, 1)

    t1 = time.perf_counter()
    for i in range(96):
        imwrite(face(), dirs["faces"] / f"{i:03d}.png")
    for i in range(2):
        imwrite(face(), dirs["val"] / f"{i:03d}.png")
    for i in range(4):
        imwrite(face(), dirs["celeba"] / f"{i:03d}.png")
    print(f"  data: 96 + 2 + 4 synthetic 512x512 face PNGs, written in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    # (a) faceir training, then the test-set script
    cfg = faceir_lpips_config(str(dirs["faces"]), str(dirs["val"]))
    result = {"a": train_lpips("19a", "faceir_gfpgan512_lpips", cfg, 2, root / "run_a", card,
                               all_kernels, read_launches, reset, launches, workers)}
    t1 = time.perf_counter()
    printed = run_main("resshift_tpu_torch.scripts", ["celeba-faceir", "--source",
                                                        str(dirs["celeba"]), "--out",
                                                        str(root / "celeba_out")])
    for sub in ("lq", "gt"):
        outs = sorted((root / "celeba_out" / sub).glob("*.png"))
        shapes = {imread(f).shape for f in outs}
        if len(outs) != 4 or shapes != {(512, 512, 3)}:
            raise AssertionError(f"scripts celeba-faceir wrote {len(outs)} {sub} PNGs {shapes}")
    result["celeba_faceir_s"] = time.perf_counter() - t1
    print(f"  scripts celeba-faceir on 4 faces: 4 lq / gt pairs of 512x512 in "
          f"{result['celeba_faceir_s']:.1f} s ({printed.strip()})", flush=True)

    # (b) one batch of each BSRGAN chain on the loader's threads
    for kind, chain in (("bsrgan", "bsrgan_light"), ("bsrganimagenet", "bsrgan")):
        ds = create_dataset(dict(type=kind, params=dict(dir_path=str(dirs["faces"]), sf=4,
                                                        gt_size=256, degradation=chain)))
        loader = DataLoader(ds, batch_size=96, num_workers=workers, prefetch=0)
        t1 = time.perf_counter()
        batch = next(iter(loader))
        ms = 1e3 * (time.perf_counter() - t1)
        loader.close()
        ok = (batch["gt"].shape == (96, 256, 256, 3) and batch["lq"].shape == (96, 64, 64, 3)
              and all(np.isfinite(v).all() and np.abs(v).max() <= 1 for v in batch.values()))
        print(f"  19(b): {kind} ({chain}) loader, 96 GT crops of 256 from the faces: gt "
              f"{batch['gt'].shape}, lq {batch['lq'].shape}, in [-1, 1] and finite: {ok}; "
              f"{ms:.1f} ms for the batch on {workers} threads", flush=True)
        if not ok:
            raise AssertionError(f"{kind} batch: gt {batch['gt'].shape}, lq {batch['lq'].shape}")
        result[f"{kind}_batch_ms"] = ms
    tmp.cleanup()
    return result


def train_lpips(tag: str, name: str, cfg: dict, n_iter: int, save_dir: Path, card: str,
                all_kernels: dict, read_launches, reset, launches: dict, workers: int) -> dict:
    """`Trainer.train(stop_iter=n_iter)` on the LPIPS trainer's `cfg` with
    `workers` loader threads and validation at the last iteration, checked
    (the losses, every UNet parameter's gradient, C twice a microbatch and
    nothing else in a step, validation's launches as derived, val_lpips
    where the val set has a GT) and timed.  Returns its figures."""
    import torch

    from resshift_tpu_torch.ops import swin_block as sb
    from resshift_tpu_torch.train_loop import Trainer

    print(f"  {tag}: configs/{name}.yaml, {n_iter} iterations at batch "
          f"{cfg['train']['batch'][0]} in microbatches of {cfg['train']['microbatch']}, "
          f"{workers} loader threads, then validation on 2 images", flush=True)
    cfg["train"].update(log_freq=[1, 1000], val_freq=n_iter, save_freq=1000,
                        num_workers=workers)
    calls: dict[str, list] = {}
    read = lambda: read_launches(all_kernels, sb)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, save_dir=str(save_dir), dtype=torch.bfloat16, seed=0)
    tr.train_step = counting(calls, tr.train_step, "steps", read, reset)
    tr.validate = counting(calls, tr.validate, "validate", read, reset)
    tr.train(stop_iter=n_iter)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log = [json.loads(ln) for ln in (save_dir / "train_log.jsonl").read_text().splitlines()]
    steps = [m for m in log if "loss" in m]
    if [m["iter"] for m in steps] != list(range(1, n_iter + 1)):
        raise AssertionError(f"logged iterations {[m['iter'] for m in steps]}")
    for m in steps:
        print(f"  iteration {m['iter']}: loss {m['loss']:.5f} (mse {m['mse']:.5f}, lpips "
              f"{m['lpips']:.5f}), grad_norm {m['grad_norm']:.4f}, loader wait "
              f"{m['loader_ms']:.1f} ms, to the card {m['degrade_ms']:.1f} ms, step "
              f"{m['step_ms']:.1f} ms", flush=True)
        if not (math.isfinite(m["loss"]) and math.isfinite(m["lpips"]) and m["lpips"] > 0
                and math.isfinite(m["grad_norm"]) and m["grad_norm"] > 0):
            raise AssertionError(f"iteration {m['iter']}: loss, lpips or grad_norm not "
                                 f"finite and > 0")
    zero = [n for n, p in tr.step_fn.named
            if p.grad is None or not p.grad.abs().max().item() > 0]
    print(f"  UNet parameters with a nonzero gradient: {len(tr.step_fn.named) - len(zero)} "
          f"of {len(tr.step_fn.named)}", flush=True)
    if zero:
        raise AssertionError(f"{len(zero)} UNet parameters without a gradient, e.g. "
                             f"{zero[:3]}")
    # a step: C twice a microbatch (the encodes, under no_grad), nothing
    # else: the decode under autograd runs pinned plain (no C, no D)
    per_step = {k: 0 for k in calls["steps"][0]}
    per_step["C"] = 2 * (tr.batch // tr.tcfg.microbatch)
    print(f"  launches a step: {calls['steps']}", flush=True)
    if any(got != per_step for got in calls["steps"]):
        raise AssertionError(f"step launches {calls['steps']}, want {per_step} each")
    want = validation_launches(cfg, tr.pipe.sched.num_timesteps)
    (got,) = calls["validate"]
    print(f"  launches in validation: {got} (derived: {want})", flush=True)
    if got != want:
        raise AssertionError(f"validation launches {got}, want {want}")
    launches[f"{tag} step"], launches[f"{tag} validate"] = calls["steps"][0], got
    val = [m for m in log if "val_psnr_y" in m]
    if "extra_dir_path" in cfg["data"]["val"]["params"] or cfg["data"]["val"]["type"] != "base":
        if not (val and math.isfinite(val[0]["val_lpips"]) and val[0]["val_lpips"] > 0):
            raise AssertionError(f"no finite val_lpips in the log: {val}")
        val_txt = (f"val_lpips {val[0]['val_lpips']:.4f}, val PSNR(Y) "
                   f"{val[0]['val_psnr_y']:.2f} dB (random weights)")
    else:  # a val set without GT: the restoration only
        if val or not (save_dir / "images" / "val" / f"val_{n_iter:06d}.png").is_file():
            raise AssertionError(f"validation without GT: metrics {val} or no restoration")
        val_txt = "validation restored (no GT)"
    later = tr.timings[1:]  # the first iteration builds the loader's threads
    times = {k: statistics.median(t[k] for t in later)
             for k in ("loader_ms", "degrade_ms", "step_ms")}
    it_ms = sum(times.values())
    print(f"  {tag}: ms per iteration (median of iterations 2-{n_iter}): {it_ms:.1f} = "
          f"loader wait {times['loader_ms']:.1f} + to the card {times['degrade_ms']:.1f} + "
          f"step {times['step_ms']:.1f}; {tr.batch / (it_ms / 1e3):.2f} images/s "
          f"({tr.batch / (times['step_ms'] / 1e3):.2f} in the step alone); loader wait per "
          f"batch {[round(t['loader_ms'], 1) for t in tr.timings]} ms; peak "
          f"max_memory_allocated {peak_gib:.2f} GiB; {val_txt}; on {card}", flush=True)
    out = {"ms_per_iteration": it_ms, **times, "peak_gib": peak_gib,
           "images_per_s": tr.batch / (it_ms / 1e3),
           "loader_ms_by_batch": [t["loader_ms"] for t in tr.timings],
           "lpips": steps[-1]["lpips"]}
    if val:
        out["val_lpips"] = val[0]["val_lpips"]
    tr.loader.close()
    del tr
    torch.cuda.empty_cache()
    return out


# latent-diffusion's KL-f16 first stage (models/first_stage_models/kl-f16/config.yaml)
KL_F16 = dict(double_z=True, z_channels=16, resolution=256, in_channels=3, out_ch=3, ch=128,
              ch_mult=[1, 1, 2, 2, 4], num_res_blocks=2, attn_resolutions=[16], dropout=0.0)
# the JAX package's UNetModel / UNetModelConv defaults at a 64x64 input and its
# 128x128 LQ, pixel-unshuffled (3 + 12 input channels)
VARIANT_WIDTHS = dict(model_channels=160, channel_mult=(1, 2, 4, 8), num_res_blocks=2)
# tools/train_proof.py's pixel-space model (autoencoder: null) and diffusion
PIXEL_MODEL = dict(image_size=64, in_channels=3, model_channels=64, out_channels=3,
                   attention_resolutions=[64, 32, 16], dropout=0.0, channel_mult=[1, 2, 2],
                   num_res_blocks=[2, 2, 2], conv_resample=True, num_head_channels=32,
                   use_scale_shift_norm=True, resblock_updown=False, swin_depth=2,
                   swin_embed_dim=96, window_size=8, mlp_ratio=4, cond_lq=True,
                   cond_mask=False, lq_size=64)


def db(x, y, peak: float | None = None) -> float:
    """PSNR of x against y in dB, peak |y|'s largest value unless given."""
    x, y = x.double(), y.double()
    peak = y.abs().max().item() if peak is None else peak
    return 10 * math.log10(peak ** 2 / max(((x - y) ** 2).mean().item(), 1e-30))


def with_biases(p) -> dict:
    """The state_dicts of pipeline `p` with every all-zero tensor (biases,
    the zero-initialised output convs) redrawn, so that every branch reaches
    the output: phase 3's random weights over `p.init_params`."""
    import torch

    gw = torch.Generator().manual_seed(1)
    return {name: {k: v if v.any() else (0.02 * torch.randn(v.shape, generator=gw)).to(v.device)
                   for k, v in mod.state_dict().items()}
            for name, mod in (("unet", p.unet), ("vqgan", p.vq))}


def seeded_weights(module, seed: int) -> None:
    """Every parameter of `module` drawn from a seeded CPU generator, none
    zero: weights N(0, 1 / fan_in), norm scales 1 + N(0, 0.05), biases and
    the rest N(0, 0.02)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.dim() >= 2:
                p.copy_(r / p[0].numel() ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1 + 0.05 * r)
            else:
                p.copy_(0.02 * r)


def kl_attention_blocks(dd: dict) -> int:
    """AttnBlocks of one encode and one decode of an autoencoder with
    `ddconfig` dd: each middle block's, and one after every ResnetBlock of a
    level whose resolution is in attn_resolutions (the decoder's levels
    hold num_res_blocks + 1)."""
    mult, attn = dd["ch_mult"], set(dd["attn_resolutions"])
    nrb = dd["num_res_blocks"]
    nrb = [nrb] * len(mult) if isinstance(nrb, int) else list(nrb)
    res = [dd["resolution"] // 2 ** i for i in range(len(mult))]
    return 2 + sum(n + (n + 1) for n, r in zip(nrb, res) if r in attn)


def unet_options_phase(dev, card: str, all_kernels: dict, read_launches, reset,
                       launches: dict, base: dict | None = None, batch: int = BSZ) -> dict:
    """Phase 20(a): `sample` at realsr_v1's widths under the UNet options
    (see the module docstring).  Returns its figures."""
    import copy

    import torch

    from resshift_tpu_torch.config import task_config
    from resshift_tpu_torch.ops import swin_block as sb
    from resshift_tpu_torch.pipeline import ResShiftPipeline

    base = base or task_config("realsr_v1")
    lq = torch.rand(batch, 64, 64, 3, generator=torch.Generator().manual_seed(20)) * 2 - 1
    lq = lq.to(dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(21)
    result = {}
    for tag, opts in (("20a1", dict(resblock_updown=True, patch_norm=True,
                                    use_scale_shift_norm=False)),
                      ("20a2", dict(conv_resample=False))):
        cfg = copy.deepcopy(base)
        cfg["model"].update(opts)
        pipe = ResShiftPipeline(cfg, dtype=torch.bfloat16, device=dev)
        pipe.init_params(seed=0)  # phase 3's kind of random weights
        pipe.load_state_dicts(**with_biases(pipe))
        latents, decode = [], pipe._decode
        pipe._decode = lambda vqm, z: latents.append(z.float().clone()) or decode(vqm, z)
        reset()
        t1 = time.perf_counter()
        out = pipe.sample(lq, gen())
        torch.cuda.synchronize()
        first = (time.perf_counter() - t1) * 1e3
        launches[tag] = read_launches(all_kernels, sb)
        want = expected_launches(cfg, 64, 64)
        print(f"  {tag} {opts}: launches in one sample call {launches[tag]} (derived: {want})",
              flush=True)
        if launches[tag] != want or not all(launches[tag][k] for k in "ABCD"):
            raise AssertionError(f"{tag}: launch counts {launches[tag]}, want {want}")
        if out.shape != (batch, 256, 256, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"{tag}: bad output {tuple(out.shape)}")
        times = []
        for _ in range(2):
            t1 = time.perf_counter()
            pipe.sample(lq, gen())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        # the same model pinned plain: clones sharing every parameter
        pipe.unet, pipe.vq = pipe.unet.clone(use_pallas=False), pipe.vq.clone(use_pallas=False)
        pipe._compute = None
        reset()
        plain = pipe.sample(lq, gen())
        torch.cuda.synchronize()
        if any(read_launches(all_kernels, sb).values()):
            raise AssertionError(f"{tag}: the clone pinned use_pallas=False launched a kernel")
        psnr, psnr_latent = db(out, plain, 2.0), db(latents[0], latents[-1])
        ms = statistics.median(times)
        print(f"  {tag}: image PSNR against the plain clone {psnr:.2f} dB (bar 35), final "
              f"latent {psnr_latent:.2f} dB (not gated); "
              f"{ms:.1f} ms per call (median of {[round(t, 1) for t in times]}; first "
              f"{first:.1f}), {batch * 256 * 256 / (ms / 1e3) / 1e6:.4f} Mpx/s on {card}",
              flush=True)
        if not psnr >= 35.0:
            raise AssertionError(f"{tag}: image PSNR {psnr:.2f} dB below 35")
        result[tag] = {"psnr_db": psnr, "latent_psnr_db": psnr_latent, "ms": ms,
                       "first_ms": first}
        del pipe, out, plain
    return result


def autoencoder_kl_phase(dev, card: str, all_kernels: dict, read_launches, reset,
                         launches: dict, dd: dict = KL_F16, embed_dim: int = 16,
                         batch: int = 4, side: int = 256) -> dict:
    """Phase 20(b): AutoencoderKL at KL-f16's first-stage shape (see the
    module docstring).  Returns its figures."""
    import torch

    from resshift_tpu_torch.models import AutoencoderKL
    from resshift_tpu_torch.ops import swin_block as sb

    ae = AutoencoderKL(dd, embed_dim, dtype=torch.bfloat16)
    seeded_weights(ae, 23)
    ae = ae.to(dev).eval()
    x = (torch.rand(batch, side, side, 3, generator=torch.Generator().manual_seed(24)) * 2
         - 1).to(dev)
    n_attn = kl_attention_blocks(dd)
    with torch.no_grad():
        reset()
        t1 = time.perf_counter()
        z = ae.encode(x)
        rec = ae.decode(z)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        launches["20b"] = got = read_launches(all_kernels, sb)
        want = {k: 0 for k in got}
        want["C"] = n_attn
        print(f"  20b: encode + decode of {batch} x {side}x{side}: launches {got} (C derived: "
              f"{n_attn} attention blocks); {ms:.1f} ms (first call) on {card}", flush=True)
        if got != want:
            raise AssertionError(f"20b: launch counts {got}, want {want}")
        t1 = time.perf_counter()
        ae.decode(ae.encode(x))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        reset()
        pinned = ae.clone(use_pallas=True).decode(z)
        launches["20b pinned decode"] = got = read_launches(all_kernels, sb)
        if not (got["F stats"] == 1 and got["F"] + got["F tc"] == 1):
            raise AssertionError(f"20b: the decoder pinned True launched F {got}")
        plain_ae = ae.clone(use_pallas=False)
        reset()
        rec_plain = plain_ae.decode(plain_ae.encode(x))
        if any(read_launches(all_kernels, sb).values()):
            raise AssertionError("20b: the clone pinned use_pallas=False launched a kernel")
        sample = ae.encode(x, generator=torch.Generator(device=dev).manual_seed(25))
    psnr, psnr_pin = db(rec, rec_plain, 2.0), db(pinned, rec_plain, 2.0)
    moved = (sample - z).abs().max().item()
    print(f"  20b: latent {tuple(z.shape)}; reconstruction PSNR against the plain clone "
          f"{psnr:.2f} dB, with F at the tail {psnr_pin:.2f} dB (bar 35); a seeded posterior "
          f"sample moves the latent by up to {moved:.4f}; {ms:.1f} ms an encode + decode on "
          f"{card}", flush=True)
    if not (psnr >= 35.0 and psnr_pin >= 35.0 and torch.isfinite(rec).all() and moved > 0):
        raise AssertionError(f"20b: PSNR {psnr:.2f} / {psnr_pin:.2f} dB, sample moved {moved}")
    return {"ms": ms, "psnr_db": psnr, "psnr_pinned_db": psnr_pin, "attn_blocks": n_attn}


def variants_phase(dev, card: str, all_kernels: dict, read_launches, reset, launches: dict,
                   widths: dict = VARIANT_WIDTHS, batch: int = BSZ, side: int = 64) -> dict:
    """Phase 20(c): UNetModel and UNetModelConv forward and backward (see the
    module docstring).  Returns their figures."""
    import torch

    from resshift_tpu_torch.models import UNetModel, UNetModelConv
    from resshift_tpu_torch.ops import swin_block as sb

    g = torch.Generator().manual_seed(26)
    x = torch.randn(batch, side, side, 3, generator=g).to(dev)
    lq = (torch.rand(batch, 2 * side, 2 * side, 3, generator=g) * 2 - 1).to(dev)
    t = torch.randint(0, 15, (batch,), generator=g).to(dev)
    result = {}
    for name, build in (("UNetModel", lambda dt: UNetModel(
            image_size=side, in_channels=15, cond_lq=True, dtype=dt, **widths)),
                        ("UNetModelConv", lambda dt: UNetModelConv(
            in_channels=15, cond_lq=True, dtype=dt, **widths))):
        outs = {}
        for dt in (torch.float32, torch.bfloat16):
            model = build(dt)
            seeded_weights(model, 27)
            model = model.to(dev).train()
            reset()
            (model(x, t, lq=lq).float() ** 2).mean().backward()  # warm-up
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            out = model(x, t, lq=lq)
            (out.float() ** 2).mean().backward()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            got = read_launches(all_kernels, sb)
            launches[f"20c {name} {dt}".replace("torch.", "")] = got
            if any(got.values()):
                raise AssertionError(f"20c: {name} launched a kernel: {got}")
            grads = [p.grad for p in model.parameters()]
            if any(gr is None or not torch.isfinite(gr).all() for gr in grads):
                raise AssertionError(f"20c: {name} {dt}: a parameter without a finite gradient")
            outs[dt] = out.detach().float()
            tag = "bf16" if dt == torch.bfloat16 else "f32"
            print(f"  20c: {name} {tag}, batch {batch} of {side}x{side} (LQ {2 * side}x"
                  f"{2 * side}, pixel-unshuffled): forward + backward {ms:.1f} ms, peak "
                  f"max_memory_allocated {peak:.2f} GiB, no kernel launched, on {card}",
                  flush=True)
            result[f"{name} {tag}"] = {"ms": ms, "peak_gib": peak}
            del model, out, grads
        psnr = db(outs[torch.bfloat16], outs[torch.float32])
        print(f"  20c: {name} bf16 output against f32: {psnr:.2f} dB (bar 35)", flush=True)
        if not psnr >= 35.0:
            raise AssertionError(f"20c: {name} bf16 against f32 {psnr:.2f} dB below 35")
        result[f"{name} psnr_db"] = psnr
    return result


def pixel_train_config(train_pack: tuple[str, str], val: tuple[str, str],
                       model: dict = PIXEL_MODEL, batch: int = 16) -> dict:
    """tools/train_proof.py's pixel-space settings (`autoencoder: null`, the
    role of IdentityFirstStage): training on packed lq / gt files, validation
    on folders."""
    return dict(
        task="train_proof", sf=1, model=dict(model),
        diffusion=dict(schedule_name="exponential", steps=4, min_noise_level=0.2,
                       etas_end=0.99, kappa=1.0, power=0.3, predict_type="xstart",
                       timestep_respacing=None, normalize_input=True, latent_flag=False,
                       scale_factor=1.0, sf=1),
        autoencoder=None,
        inference=dict(chop_size=64, chop_stride=48, padding_offset=64),
        train=dict(lr=2e-4, lr_min=2e-5, lr_schedule="cosin", warmup_iterations=50,
                   iterations=3, batch=batch, microbatch=None, ema_rate=0.999,
                   weight_decay=0.0, save_freq=1000, log_freq=[1, 1000], val_freq=3,
                   val_max_images=None),
        data=dict(train=dict(type="base", params=dict(pack_path=train_pack[0],
                                                      extra_pack_path=train_pack[1])),
                  val=dict(type="base", params=dict(dir_path=val[0], extra_dir_path=val[1]))))


def pixel_train_phase(dev, card: str, all_kernels: dict, read_launches, reset, launches: dict,
                      model: dict = PIXEL_MODEL, n_pairs: int = 32, batch: int = 16) -> dict:
    """Phase 20(d): pixel-space training from packed files (see the module
    docstring).  Returns its figures."""
    import numpy as np
    import torch

    from resshift_tpu_torch.data.packfile import PackReader, native_available
    from resshift_tpu_torch.ops import swin_block as sb
    from resshift_tpu_torch.ops.resize import resize_np
    from resshift_tpu_torch.train_loop import Trainer
    from resshift_tpu_torch.utils.image_io import imwrite

    if not native_available():
        raise AssertionError("20d: the native packfile reader does not build or load")
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    rng = np.random.default_rng(28)
    for sub in ("lq", "gt", "val_lq", "val_gt"):
        (root / sub).mkdir()
    for i in range(n_pairs + 2):
        gt = np.clip(resize_np(rng.uniform(0, 1, (8, 8, 3)), (64, 64), "bilinear")
                     + rng.normal(0, 0.03, (64, 64, 3)), 0, 1)
        lq = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1)  # a noisy copy: sf 1
        val = "val_" if i >= n_pairs else ""
        imwrite(gt, root / f"{val}gt" / f"{i:03d}.png")
        imwrite(lq, root / f"{val}lq" / f"{i:03d}.png")
    t1 = time.perf_counter()
    for sub in ("lq", "gt"):
        run_main("resshift_tpu_torch.scripts", ["pack", "--source", str(root / sub), "--out",
                                                str(root / f"{sub}.pack")])
    with PackReader(root / "gt.pack") as r:
        if not r.native or len(r) != n_pairs:
            raise AssertionError(f"20d: the pack holds {len(r)} images (native {r.native})")
    print(f"  20d: {n_pairs} synthetic 64x64 pairs packed by `scripts pack` in "
          f"{time.perf_counter() - t1:.1f} s; the native reader in use", flush=True)
    cfg = pixel_train_config((str(root / "lq.pack"), str(root / "gt.pack")),
                             (str(root / "val_lq"), str(root / "val_gt")), model, batch)
    calls: dict[str, list] = {}
    read = lambda: read_launches(all_kernels, sb)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, save_dir=str(root / "run"), dtype=torch.bfloat16, seed=0, device=dev)
    if not tr.loader.ds.client.pack.native:
        raise AssertionError("20d: the training data is not read by the native reader")
    tr.train_step = counting(calls, tr.train_step, "steps", read, reset)
    tr.validate = counting(calls, tr.validate, "validate", read, reset)
    tr.train(stop_iter=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log = [json.loads(ln) for ln in (root / "run" / "train_log.jsonl").read_text().splitlines()]
    steps = [m for m in log if "loss" in m]
    if [m["iter"] for m in steps] != [1, 2, 3]:
        raise AssertionError(f"20d: logged iterations {[m['iter'] for m in steps]}")
    for m in steps:
        print(f"  20d: iteration {m['iter']}: loss {m['loss']:.5f}, grad_norm "
              f"{m['grad_norm']:.4f}, loader {m['loader_ms']:.1f} ms, to the card "
              f"{m['degrade_ms']:.1f} ms, step {m['step_ms']:.1f} ms", flush=True)
        if not (math.isfinite(m["loss"]) and m["loss"] > 0 and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"20d: iteration {m['iter']}: loss or grad_norm not finite")
    if any(any(got.values()) for got in calls["steps"]):
        raise AssertionError(f"20d: a step launched a kernel: {calls['steps']}")
    want = validation_launches(cfg, tr.pipe.sched.num_timesteps)
    want.update({"C": 0, "D": 0, "D finalize": 0})  # no first stage: no VQGAN kernel
    (got,) = calls["validate"]
    print(f"  20d: launches in validation {got} (derived: {want})", flush=True)
    if got != want or not (got["A"] and got["B"]):
        raise AssertionError(f"20d: validation launches {got}, want {want}")
    launches["20d step"], launches["20d validate"] = calls["steps"][0], got
    times = {k: statistics.median(t[k] for t in tr.timings[1:3])
             for k in ("loader_ms", "degrade_ms", "step_ms")}
    it_ms = sum(times.values())
    print(f"  20d: ms per iteration (median of iterations 2-3): {it_ms:.1f} = loader "
          f"{times['loader_ms']:.1f} + to the card {times['degrade_ms']:.1f} + step "
          f"{times['step_ms']:.1f}; {tr.batch / (it_ms / 1e3):.2f} images/s; peak "
          f"max_memory_allocated {peak:.2f} GiB; on {card}", flush=True)
    tr.loader.close()
    del tr
    tmp.cleanup()
    return {"ms_per_iteration": it_ms, **times, "peak_gib": peak}


# the realsr structure at small width (window 4, LQ 16, f4 VQGAN), 3 steps
SMALL_REALSR = dict(
    task="realsr", sf=4,
    model=dict(image_size=16, in_channels=3, model_channels=32, out_channels=3,
               attention_resolutions=[16, 8], dropout=0.0, channel_mult=[1, 2],
               num_res_blocks=[1, 1], conv_resample=True, num_head_channels=16,
               use_scale_shift_norm=True, resblock_updown=False, swin_depth=2,
               swin_embed_dim=32, window_size=4, mlp_ratio=2, cond_lq=True,
               cond_mask=False, lq_size=16),
    diffusion=dict(schedule_name="exponential", steps=3, min_noise_level=0.04,
                   etas_end=0.99, kappa=2.0, power=0.3, predict_type="xstart",
                   timestep_respacing=None, normalize_input=True, latent_flag=True,
                   scale_factor=1.0, sf=4),
    autoencoder=dict(embed_dim=3, n_embed=64, ddconfig=dict(
        double_z=False, z_channels=3, resolution=64, in_channels=3, out_ch=3, ch=32,
        ch_mult=[1, 2, 4], num_res_blocks=1, attn_resolutions=[], dropout=0.0)),
    inference=dict(chop_size=16, chop_stride=12, padding_offset=16),
)


def cross_device_shards(dev) -> None:
    """Phase 21(a)'s `sample_batch_sharded` over [card, cpu] at SMALL_REALSR
    in f32, the models pinned plain: the CPU shard runs on a replica and a
    schedule copied from the card's pipeline, its draws moved from the
    card's generator, and its output gathered back."""
    import torch

    from resshift_tpu_torch.pipeline import ResShiftPipeline

    cpu = torch.device("cpu")
    pipes = [ResShiftPipeline(SMALL_REALSR, dtype=torch.float32, device=d) for d in (dev, cpu)]
    for p in pipes:
        p.init_params(0)
        p.unet, p.vq = p.unet.clone(use_pallas=False), p.vq.clone(use_pallas=False)
    pipe, cpu_pipe = pipes
    lq = torch.rand(4, 16, 16, 3, generator=torch.Generator().manual_seed(24)) * 2 - 1
    gen = lambda: torch.Generator(device=dev).manual_seed(25)
    want = pipe.sample(lq.to(dev), gen())
    calls, orig = [], pipe._sample_padded

    def rec(*a, **k):
        out = orig(*a, **k)
        calls.append((a, k, out))
        return out

    pipe._sample_padded = rec
    try:
        got = pipe.sample_batch_sharded(lq.to(dev), gen(), [dev, cpu])
    finally:
        del pipe._sample_padded
    keys = sorted(pipe._compute, key=str)
    if [k[0].type for k in keys] != ["cpu", "cuda"] or pipe._schedule(cpu) is pipe.sched:
        raise AssertionError(f"21a cross-device: replicas {keys}")
    if [(a[0].device.type, k["draws"][0].device.type) for a, k, _ in calls] != [
            ("cuda", "cuda"), ("cpu", "cpu")]:
        raise AssertionError("21a cross-device: the shards' inputs are not on their devices")
    for (a, k, out), p in zip(calls, pipes):
        alone = p.sample(a[0], draws=k["draws"])
        if out.device != alone.device or not torch.equal(out, alone):
            raise AssertionError(f"21a cross-device: the {out.device} shard differs from "
                                 f"sample on {alone.device}")
    err = (got.cpu() - want.cpu()).abs().max().item()
    print(f"  21a cross-device: 4 images of 16x16 over [{dev}, cpu] at a small width, f32, "
          f"plain: each shard bit-equal to sample on its own device (the CPU one a pipeline "
          f"of its own), the whole within {err:.3g} of the card's sample (bar 5e-3)",
          flush=True)
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=5e-3, atol=5e-3)


def parallel_phase(dev, card: str, all_kernels: dict, read_launches, reset, launches: dict,
                   sds: dict, serve13: dict) -> dict:
    """Phase 21 (see the module docstring); `sds` are phase 3's weights,
    `serve13` phase 13's figures.  Returns its figures."""
    import threading

    import numpy as np
    import torch

    from resshift_tpu_torch.ops import swin_block as sb
    from resshift_tpu_torch.pipeline import ResShiftPipeline
    from resshift_tpu_torch.serve import Predictor
    from resshift_tpu_torch.train_loop import Trainer

    result = {}
    two = [dev, dev]
    pipe = ResShiftPipeline("realsr_v1", dtype=torch.bfloat16, device=dev)
    pipe.load_state_dicts(**sds)
    gen = lambda: torch.Generator(device=dev).manual_seed(22)
    per_call = expected_launches(pipe.config, 64, 64)
    both = {k: 2 * v for k, v in per_call.items()}

    def sharded(tag, fn, inner, check_shard, ref):
        """fn() with the shards' calls of `pipe.<inner>` recorded; each shard
        rerun alone and held bit-equal; the whole against `ref`."""
        calls, orig = [], getattr(pipe, inner)

        def rec(*a, **k):
            out = orig(*a, **k)
            calls.append((a, k, out))
            return out

        pipe.__dict__[inner] = rec
        latents, decode = [], pipe._decode
        pipe._decode = lambda vqm, z: latents.append(z.float().clone()) or decode(vqm, z)
        try:
            reset()
            out = fn()
            torch.cuda.synchronize()
            got = read_launches(all_kernels, sb)
        finally:
            del pipe.__dict__[inner]
            pipe._decode = decode
        launches[tag] = got
        print(f"  {tag}: launches in one call {got} (derived: two shards x {per_call})",
              flush=True)
        if got != both or not all(got[k] for k in "ABCD"):
            raise AssertionError(f"{tag}: launch counts {got}, want {both}")
        if len(calls) != 2 or out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{tag}: {len(calls)} shard calls, output {tuple(out.shape)}")
        home = torch.device("cuda", torch.cuda.current_device())
        unets = [pipe._compute.get((home, i), (None,))[0] for i in (0, 1)]
        if (set(pipe._compute) != {(home, 0), (home, 1)} or unets[0] is unets[1]
                or [k["slot"] for _, k, _ in calls] != [0, 1]):
            raise AssertionError(f"{tag}: replicas {list(pipe._compute)}, want two on {home}")
        copy_gib = sum(t.numel() * t.element_size() for m in pipe._compute[(home, 1)]
                       if m is not None for t in m.state_dict().values()) / 2 ** 30
        for i, (a, k, shard_out) in enumerate(calls):
            alone = check_shard(a, k)
            torch.cuda.synchronize()
            if not torch.equal(alone, shard_out):
                diff = (alone != shard_out).float().mean().item()
                raise AssertionError(f"{tag}: shard {i} differs from sample of its inputs "
                                     f"with its draws in {100 * diff:.4f}% of values")
        psnr, same = db(out, ref, 2.0), (out == ref).float().mean().item()
        print(f"  {tag}: two replicas (the copy's tensors {copy_gib:.3f} GiB); each shard "
              f"bit-equal to sample of its inputs and draws on the first; "
              f"against the unsharded sample: image {psnr:.2f} dB (bar 35), "
              f"{100 * same:.2f}% of values bit-equal", flush=True)
        if not psnr >= 35.0:
            raise AssertionError(f"{tag}: image PSNR {psnr:.2f} dB against sample below 35")
        return psnr

    def timed(fn, n=2):
        """ms of each of n calls of fn()."""
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        return times

    # ------------------------------------------------------------ 21(a)
    lq = torch.rand(BSZ, 64, 64, 3, generator=torch.Generator().manual_seed(23)).to(dev) * 2 - 1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref = pipe.sample(lq, gen())
    torch.cuda.synchronize()
    ref_ms = []
    for _ in range(2):
        t1 = time.perf_counter()
        pipe.sample(lq, gen())
        torch.cuda.synchronize()
        ref_ms.append((time.perf_counter() - t1) * 1e3)
    batch = lambda: pipe.sample_batch_sharded(lq, gen(), two)
    result["batch_db"] = sharded(
        "21a batch", batch, "_sample_padded",
        lambda a, k: pipe.sample(a[0], draws=k["draws"]), ref)
    times = timed(batch)
    result["batch_ms"] = statistics.median(times)
    print(f"  21a batch: {BSZ} tiles over 2 replicas: {times} ms a call; unsharded sample "
          f"{ref_ms} ms; on {card}", flush=True)

    lq2 = torch.rand(1, 112, 176, 3, generator=torch.Generator().manual_seed(4)).to(dev) * 2 - 1
    grid_tiles = 12  # 128x192 padded, chop 64, stride 48: 3 x 4 starts
    chop = dict(chop_size=64, chop_stride=48)
    ref2 = pipe.sample(lq2, gen(), tile_bs=grid_tiles, **chop)
    tiles = lambda: pipe.sample_tiles_sharded(lq2, gen(), two, **chop)
    result["tiles_db"] = sharded(
        "21a tiles", tiles, "_sample_tile",
        lambda a, k: pipe.sample(a[0], draws=(k["noise"], k["step_noise"])), ref2)
    times = timed(tiles)
    result["tiles_ms"] = statistics.median(times)
    print(f"  21a tiles: {grid_tiles} tiles of one 112x176 input over 2 replicas: {times} ms "
          f"a call; on {card}", flush=True)
    del pipe, ref, ref2
    cross_device_shards(dev)

    # ------------------------------------------------------------ 21(b)
    burst = serve13["burst"]
    pred = Predictor("realsr_v3", max_batch=serve13["max_batch"], max_queue=burst,
                     batch_window_s=0.05, seed=14, data_parallel=True, devices=two)
    try:
        pred.warmup((64, 64))
        n0 = len(pred.batch_sizes)
        img = torch.randint(0, 256, (64, 64, 3), generator=torch.Generator().manual_seed(15),
                            dtype=torch.uint8).numpy()
        outs, errors = {}, []

        def ask(i):
            try:
                outs[i] = pred.predict(img)
            except Exception as e:  # noqa: BLE001 -- raised below, after the join
                errors.append(e)

        reset()
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(burst)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t1
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"21b: burst failed: {errors[:3]}")
        sizes = pred.batch_sizes[n0:]
        forwards = len(sizes)
        launches["21b"] = got = read_launches(all_kernels, sb)
        per = expected_launches(pred.pipe.config, 64, 64)
        want = {k: 2 * v * forwards for k, v in per.items()}
        print(f"  21b: batch sizes {sizes}; launches {got} (derived: {forwards} forwards x 2 "
              f"shards x {per})", flush=True)
        if got != want or sum(sizes) != burst:
            raise AssertionError(f"21b: launch counts {got}, want {want}; sizes {sizes}")
        for i in range(burst):
            o = outs[i]
            if o.shape != (256, 256, 3) or not np.isfinite(o).all():
                raise AssertionError(f"21b: output {i}: {o.shape}")
            if i and np.array_equal(o, outs[0]):
                raise AssertionError(f"21b: outputs 0 and {i} are equal for identical inputs")
        result["serve_forwards_per_s"] = forwards / wall
        print(f"  21b: {burst} requests in {wall * 1e3:.1f} ms: {forwards / wall:.3f} "
              f"forwards/s, {burst * 256 * 256 / wall / 1e6:.4f} Mpx/s (phase 13, one replica: "
              f"{serve13['forwards_per_s']:.3f} forwards/s, {serve13['mpx']:.4f} Mpx/s), on "
              f"{card}", flush=True)
    finally:
        pred.close()
    del pred, outs

    # ------------------------------------------------------------ 21(c)
    torch.cuda.empty_cache()  # the workers' memory: this process keeps none cached
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    dirs = write_train_data(root, 64, 2, 0)
    cfg = realsr_train_config([str(dirs["hq"])], str(dirs["val_lq"]), str(dirs["val_gt"]))
    cfg["train"].update(log_freq=[1, 10 ** 9], val_freq=10 ** 9, save_freq=10 ** 9)
    (root / "cfg.json").write_text(json.dumps(cfg))
    cmd = [sys.executable, "-m", "resshift_tpu_torch.tools.multiprocess_proof", "--out",
           str(root / "proof"), "--nproc", "1", "--device", "cuda", "--iters", "2", "--modes",
           "dp,fsdp", "--config", str(root / "cfg.json"), "--timeout", "400", "--threads", "4"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=460)
    if r.returncode != 0:
        raise AssertionError(f"21c: the proof failed (rc {r.returncode}):\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    report = json.loads(r.stdout.strip().splitlines()[-1])
    for mode in ("dp", "fsdp"):
        rep = report[mode]
        print(f"  21c {mode}: world size 1 (NCCL), {rep['step']} iterations: step ms "
              f"{[round(t, 1) for t in rep['step_ms'][0]]}, peak max_memory_allocated "
              f"{rep['peak_gib'][0]:.2f} GiB, state cut to {rep['shard_share']} a rank, "
              f"{rep['wall_s'][0]:.1f} s from the trainer's start to its checkpoint; on {card}",
              flush=True)
        if rep["step"] != 2 or rep["fsdp"] != (mode == "fsdp"):
            raise AssertionError(f"21c {mode}: {rep}")
        result[f"train_{mode}"] = {"step_ms": rep["step_ms"][0], "peak_gib": rep["peak_gib"][0]}
    print(f"  21c: both runs in one process, {report['wall_s']:.1f} s with start-up", flush=True)
    ckpt = root / "proof" / "fsdp" / "run" / "ckpts" / "step_00000002"
    tr = Trainer(cfg, save_dir=str(root / "resumed"), resume=str(ckpt), dtype=torch.bfloat16,
                 seed=0, device=dev)
    tr.train(stop_iter=3)
    log = [json.loads(ln) for ln in (root / "resumed" / "train_log.jsonl").read_text()
           .splitlines() if '"loss"' in ln]
    print(f"  21c: the FSDP checkpoint resumed in this process (no process group) at step "
          f"{tr.start_iter}: iteration {log[-1]['iter']}, loss {log[-1]['loss']:.5f}, step "
          f"{log[-1]['step_ms']:.1f} ms", flush=True)
    if tr.start_iter != 2 or log[-1]["iter"] != 3 or not math.isfinite(log[-1]["loss"]):
        raise AssertionError(f"21c: the resume of the FSDP checkpoint: {log}")
    del tr
    tmp.cleanup()
    return result


def tp_phase(dev, card: str, all_kernels: dict, read_launches, reset, launches: dict,
             sds: dict) -> dict:
    """Phase 22(a): `sample_tp` on one 64x64 LQ at batch 1 (see the module
    docstring); `sds` are phase 3's weights.  Returns its figures."""
    import torch
    import torch.distributed as dist

    from resshift_tpu_torch.ops import swin_block as sb
    from resshift_tpu_torch.parallel import tp
    from resshift_tpu_torch.pipeline import ResShiftPipeline
    from resshift_tpu_torch.tools.multiprocess_proof import free_port, launch_tp

    result = {}
    seed = 26
    gen = lambda: torch.Generator(device=dev).manual_seed(seed)
    lq = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(27)) * 2 - 1
    plain = ResShiftPipeline("realsr_v1", dtype=torch.bfloat16, device=dev)
    plain.load_state_dicts(**sds)
    plain.unet, plain.vq = plain.unet.clone(use_pallas=False), plain.vq.clone(use_pallas=False)
    ref = plain.sample(lq, gen())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plain.sample(lq, gen())
    torch.cuda.synchronize()
    result["plain_ms"] = (time.perf_counter() - t1) * 1e3

    def against_plain(tag, out):
        psnr, same = db(out.to(dev), ref, 2.0), (out.to(dev) == ref).float().mean().item()
        print(f"  {tag}: image {psnr:.2f} dB from the plain-pinned sample on the same draws "
              f"(bar 35), {100 * same:.2f}% of values bit-equal", flush=True)
        if out.shape != ref.shape or not torch.isfinite(out).all() or not psnr >= 35.0:
            raise AssertionError(f"{tag}: output {tuple(out.shape)}, {psnr:.2f} dB")
        return psnr

    # two gloo ranks sharing the card, each a process of the launcher
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    torch.save({"config": "realsr_v1", "dtype": "bfloat16",
                **{k: {n: v.cpu() for n, v in sd.items()} for k, sd in sds.items()},
                "cases": [{"name": "tp", "lq": lq, "seed": seed}]}, root / "spec.pt")
    t1 = time.perf_counter()
    rep = launch_tp(root / "run", root / "spec.pt", nproc=2, device=f"cuda:{dev.index or 0}",
                    backend="gloo", timeout=300, threads=4)
    wall = time.perf_counter() - t1
    if not rep["ok"]:
        logs = "\n".join((root / "run" / f"worker_{r}.log").read_text()[-2000:] for r in range(2))
        raise AssertionError(f"22a: the gloo ranks failed: {rep}\n{logs}")
    outs = [torch.load(root / "run" / "tp" / f"tp_rank{r}.pt") for r in range(2)]
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("22a: the two ranks' images differ")
    case = rep["cases"]["tp"]
    result["gloo_db"] = against_plain("22a gloo x 2 (bit-equal ranks)", outs[0])
    result["gloo_ms"] = [statistics.median(ms) for ms in case["ms"]]
    result["collectives"] = case["collectives"]
    print(f"  22a gloo x 2 on one card: ms a call per rank {case['ms']} (the first call after "
          f"an untimed build of the split clone), {case['collectives']} collectives a call, "
          f"{wall:.1f} s with the processes' start; plain-pinned sample "
          f"{result['plain_ms']:.1f} ms; on {card}", flush=True)
    tmp.cleanup()

    # a world-size-1 NCCL group in this process: the split forms, NCCL's collectives
    pipe = ResShiftPipeline("realsr_v1", dtype=torch.bfloat16, device=dev)
    pipe.load_state_dicts(**sds)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        pipe._tp_models(None)  # the split clone, built before the clock starts
        reset()
        before = dict(tp.COLLECTIVES)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = pipe.sample_tp(lq.to(dev), gen())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        got = read_launches(all_kernels, sb)
        if any(got.values()):
            raise AssertionError(f"22a: sample_tp launched a kernel: {got}")
        calls = {k: v - before[k] for k, v in tp.COLLECTIVES.items()}
        launches["22a nccl"] = got
    finally:
        dist.destroy_process_group()
    result["nccl_db"] = against_plain("22a NCCL x 1 (the split forms)", out)
    result["nccl_ms"] = ms
    print(f"  22a NCCL x 1: {ms:.1f} ms, the first call after an untimed build of the split "
          f"clone, {calls} collectives a call, no kernel launched; on {card}", flush=True)
    del plain, pipe
    return result


def pp_phase(dev, card: str, all_kernels: dict, read_launches, reset, launches: dict,
             sds: dict) -> dict:
    """Phase 22(b): `sample_pipelined` over two stages on the one card (see
    the module docstring); `sds` are phase 3's weights.  Returns its
    figures."""
    import torch

    from resshift_tpu_torch.ops import swin_block as sb
    from resshift_tpu_torch.pipeline import ResShiftPipeline

    result = {}
    pipe = ResShiftPipeline("realsr_v1", dtype=torch.bfloat16, device=dev)
    pipe.load_state_dicts(**sds)
    gen = lambda: torch.Generator(device=dev).manual_seed(28)
    lq = torch.rand(1, 112, 176, 3, generator=torch.Generator().manual_seed(4)).to(dev) * 2 - 1
    chop = dict(chop_size=64, chop_stride=48)  # 128x192 padded: 12 tiles, 3 chunks of 4

    def call(fn):
        reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, read_launches(all_kernels, sb), (time.perf_counter() - t1) * 1e3

    ref, ref_n, _ = call(lambda: pipe.sample(lq, gen(), tile_bs=4, **chop))
    per = expected_launches(pipe.config, 64, 64)
    if ref_n != {k: 3 * v for k, v in per.items()}:
        raise AssertionError(f"22b: sample(tile_bs=4) launched {ref_n}, want 3 x {per}")
    # PP x DP runs each chunk of 4 in two parts of 2: sample(tile_bs=2) on the same draws
    draws = pipe.chain_draws(lq.shape, gen(), tile_bs=4, **chop)
    halves = pipe.sample(lq, tile_bs=2, draws=draws, **chop)
    for tag, devices, parts, same_as in (("22b pp", [dev, dev], 1, ref),
                                         ("22b pp x dp", [[dev, dev], [dev, dev]], 2, halves)):
        out, got, first = call(lambda: pipe.sample_pipelined(lq, gen(), devices, chunk_bs=4,
                                                             **chop))
        launches[tag] = got
        want = {k: parts * v for k, v in ref_n.items()}
        print(f"  {tag}: launches in one call {got} (derived: {parts} x sample(tile_bs=4)'s "
              f"{ref_n})", flush=True)
        if got != want or not all(got[k] for k in "ABCD"):
            raise AssertionError(f"{tag}: launch counts {got}, want {want}")
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{tag}: output {tuple(out.shape)}")
        same = (out == ref).float().mean().item()
        psnr = db(out, ref, 2.0)
        print(f"  {tag}: against sample(tile_bs=4) on the same draws: {100 * same:.2f}% of "
              f"values bit-equal, image {psnr:.2f} dB (bar 35); bit-equal to "
              f"sample(tile_bs={4 // parts}) on them", flush=True)
        if not torch.equal(out, same_as) or not psnr >= 35.0:
            raise AssertionError(f"{tag}: not bit-equal to sample(tile_bs={4 // parts}) on the "
                                 f"same draws, or {psnr:.2f} dB from sample(tile_bs=4)")
        result[tag] = first
        print(f"  {tag}: {first:.1f} ms this call (its new replicas built in it)", flush=True)
    # two stages against sample on the one card: two calls each, alternated
    runs = {"22b pp": lambda: pipe.sample_pipelined(lq, gen(), [dev, dev], chunk_bs=4, **chop),
            "22b sample(tile_bs=4)": lambda: pipe.sample(lq, gen(), tile_bs=4, **chop)}
    for _ in range(2):
        for tag, fn in runs.items():
            result.setdefault(f"{tag} ms", []).append(call(fn)[2])
    for tag in runs:
        print(f"  {tag}: {result[tag + ' ms']} ms a call, two calls alternated with the "
              f"other's; on {card}", flush=True)
    del pipe

    # [card, cpu] at a small width in f32, pinned plain: the second stage on the host
    cpu = torch.device("cpu")
    small = ResShiftPipeline(SMALL_REALSR, dtype=torch.float32, device=dev)
    small.init_params(0)
    small.unet, small.vq = small.unet.clone(use_pallas=False), small.vq.clone(use_pallas=False)
    lq2 = (torch.rand(1, 40, 40, 3, generator=torch.Generator().manual_seed(29)) * 2 - 1).to(dev)
    gen2 = lambda: torch.Generator(device=dev).manual_seed(30)
    want = small.sample(lq2, gen2(), tile_bs=2)
    got = small.sample_pipelined(lq2, gen2(), [dev, cpu], chunk_bs=2)
    if sorted(k[0].type for k in small._compute) != ["cpu", "cuda"]:
        raise AssertionError(f"22b [card, cpu]: replicas {list(small._compute)}")
    err = (got.cpu() - want.cpu()).abs().max().item()
    print(f"  22b [{dev}, cpu]: a 40x40 input (9 tiles, chunks of 2) at a small width, f32, "
          f"plain: within {err:.3g} of the card's sample(tile_bs=2) (bar 5e-3)", flush=True)
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=5e-3, atol=5e-3)
    return result


def run_tools() -> dict:
    """Phase 12: each tool of TOOL_RUNS through its `main` (the function its
    `python -m` entry point calls), in this process on the card, at its full
    width with two timed calls; each must launch its kernels and none of
    those it must not.  The conv tools' results must also hold their kernel
    against F.conv2d in f32 within TOOL_BAND of the largest output at every
    shape.  Returns {kernel name: launches} summed over the tools."""
    counts: dict[str, int] = {}
    for name, args, kernels, not_kernels in TOOL_RUNS:
        t1 = time.perf_counter()
        lines = run_main(f"resshift_tpu_torch.tools.{name}",
                         [*args, "--n-iter", "2", "--reps", "1"]).strip().splitlines()
        out = json.loads(lines[-1])
        for line in lines[:-1]:
            print(f"  {name}: {line}", flush=True)
        got = {k: v["launches"] for k, v in out["launches"].items()}
        print(f"  {name} {' '.join(args)}: {time.perf_counter() - t1:.1f} s, launches {got}, "
              f"on {out['device']['card']}", flush=True)
        if not all(got.get(k, 0) > 0 for k in kernels) or any(got.get(k, 0)
                                                              for k in not_kernels):
            raise AssertionError(f"{name} launched {got}; it must launch {kernels} and not "
                                 f"{not_kernels}")
        res = out["results"]
        rels = {"": res} if "rel_err" in res else {k: r for k, r in res.items()
                                                   if isinstance(r, dict) and "rel_err" in r}
        if name in ("profile_winograd", "profile_conv") and not rels:
            raise AssertionError(f"{name} reported no error against F.conv2d")
        for label, r in rels.items():
            if not r["rel_err"] <= TOOL_BAND[r["dtype"]]:
                raise AssertionError(f"{name} {label}: error {r['rel_err']} of the largest "
                                     f"output, above {TOOL_BAND[r['dtype']]}")
        if rels:
            print(f"  {name}: largest error {max(r['rel_err'] for r in rels.values()):.3e} of "
                  f"the largest output over {len(rels)} shapes", flush=True)
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
    return counts


def expected_launches(cfg: dict, lat_h: int, lat_w: int, tail_pinned: bool = False,
                      steps: int | None = None) -> dict:
    """Kernel launches of one sample call at one (lat_h, lat_w) latent tile,
    from the UNet's structure: a BasicLayer of `swin_depth` blocks after the
    first ResBlock of each level in `attention_resolutions` and in the
    middle; odd blocks shifted where the build resolution exceeds the
    window; a shifted block on a map wider than 1024 tokens per window-row
    (the JAX package's dispatch) launches E twice around unshifted A and B,
    else the shift-absorbing A and B.  C runs in the encoder and decoder
    middle, D once; where both are pinned (`tail_pinned`), kernel F once per
    step in the UNet head and once in the decoder tail, each a `gn_stats`
    launch and the conv on the route its dtype and width take (the head in
    f32: the FMA kernel "F"; the tail in bf16: the tensor cores, "F tc").
    `steps` is the UNet calls of the chain (by default the config's steps:
    a respaced chain's count or a Picard chain's sweeps are given)."""
    m = cfg["model"]
    win, depth, size = m["window_size"], m["swin_depth"], m["image_size"]
    mult, attn = m["channel_mult"], m["attention_resolutions"]
    ds, layers = size, []
    for level in range(len(mult)):
        layers += [ds] if ds in attn else []
        ds = ds // 2 if level != len(mult) - 1 else ds
    layers.append(ds)  # middle
    for level in reversed(range(len(mult))):
        layers += [ds] if ds in attn else []
        ds = ds * 2 if level else ds
    steps = steps or cfg["diffusion"]["steps"]
    n = {"A": 0, "B": 0, "E": 0, "fused shift": 0}
    for ds in layers:
        ws = min(win, ds)
        n["A"] += depth
        n["B"] += depth
        if ds > win:  # the odd blocks are shifted
            shifted = depth // 2
            if (lat_w * ds // size) * ws <= 1024:
                n["fused shift"] += shifted
            else:
                n["E"] += 2 * shifted
    want = {k: v * steps for k, v in n.items()}
    want.update({"C": 2, "D": 1, "D finalize": 1, "F": 0, "F tc": 0, "F stats": 0})
    if tail_pinned:
        import torch

        from resshift_tpu_torch.ops import tail

        ae = cfg["autoencoder"]["ddconfig"]
        head = (torch.float32, m["model_channels"] * mult[0], m["out_channels"], steps)
        dec_tail = (torch.bfloat16, ae["ch"] * ae["ch_mult"][0], ae["out_ch"], 1)
        for dt, c, co, n_calls in (head, dec_tail):
            route = tail.tail_route("cuda", dt, c, co)
            want["F tc" if route == "tc" else "F"] += n_calls
            want["F stats"] += n_calls
    want.update({"A f32": 0, "B f32": 0, "C f32": 0})  # bf16: no launch of the FMA routes
    want.update({"K9": 0, "K9 f32": 0, "K10": 0, "K10 f32": 0, "P1": 0, "P1 f32": 0, "P2": 0,
                 "P2 f32": 0})  # off the sampler path
    return want


def validation_launches(cfg: dict, steps: int) -> dict:
    """Kernel launches of `Trainer.validate` on images of one shape at a 64x64
    latent: the progressive strip of the first image (T UNet calls, T + 1
    decodes and one encode), then one `sample` call on them all."""
    want = expected_launches(cfg, 64, 64)
    for k in ("A", "B", "E", "fused shift"):
        want[k] *= 2
    want.update({"C": steps + 2 + 2, "D": steps + 1 + 1, "D finalize": steps + 1 + 1})
    return want


def read_launches(kernels: dict, sb) -> dict:
    got = {k: kern.launches for k, kern in kernels.items()}
    got["fused shift"] = sum(k.variants.get("shift", 0)
                             for k in (sb.SWIN_WINDOW_ATTN_TC, sb.SWIN_WINDOW_ATTN))
    unshift = sum(k.variants.get("unshift", 0) for k in (sb.SWIN_MLP_TC, sb.SWIN_MLP))
    if unshift != got["fused shift"]:
        raise AssertionError("shifted A and unshifting B launches differ")
    return got


def tail_rows(launches: dict, errs: dict, tails: dict) -> list[dict]:
    """The `kernels` rows of F: its two conv routes and its statistics pass,
    launched in the pinned faceir call of phase 9; the tensor-core route
    timed at the f8 tail, the FMA route at faceir's head, gn_stats at the f8
    tail; every shape the route takes under `by_shape`, with the two-pass
    floor and the device time of each of F's kernels."""
    out = []
    f_repl = "resshift_tpu/ops/tail_pallas.py:173 (K8)"
    conv_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "two_pass_floor_ms",
                 "device_ms_by_kernel")
    stats_keys = {"stats_ms": "ms", "stats_plain_ms": "plain_ms", "stats_bound_ms": "bound_ms",
                  "stats_bound_by": "bound_by"}
    for key, name, src, shape, route in (
            ("F tc", "gn_silu_conv3x3_tc", "resshift_tpu_torch/csrc/gn_silu_conv3x3_tc.cu",
             "f8 tail", "tc"),
            ("F", "gn_silu_conv3x3", "resshift_tpu_torch/csrc/gn_silu_conv3x3.cu", "faceir head",
             "fma"),
            ("F stats", "gn_stats", "resshift_tpu_torch/csrc/gn_silu_conv3x3.cu", "f8 tail",
             None)):
        if route is None:  # the statistics pass, at every shape
            pick = lambda t: {new: t[old] for old, new in stats_keys.items()}
            row = {"replaces": f"{f_repl} with the GroupNorm fold before it "
                               f"(resshift_tpu/models/layers.py:29 group_norm_fold)",
                   "library_ms": None, "dtype": "bf16 and f32", "max_abs_err": errs[key]}
        else:
            pick = lambda t: {k: t[k] for k in conv_keys}
            row = {"replaces": f_repl, "dtype": "bf16" if route == "tc" else "f32",
                   "max_abs_err": errs["F" if route == "tc" else "F f32"]}
        out.append({"name": name, "route": "cuda", "source": src,
                     "launches": launches["9"][key], **row, **pick(tails[shape]),
                     "shape": shape,
                     "launches_by_phase": {ph: n.get(key, 0) for ph, n in launches.items()},
                     "by_shape": {sh: pick(t) for sh, t in tails.items()
                                  if route in (None, t["route"])}})
    return out


def kernel_rows(launches: dict, errs: dict, timed: dict) -> list[dict]:
    """The `kernels` report: each kernel's launches in its main path (the
    whole photo of phase 6 for A-E, the face of phase 9 for F, the tools of
    phase 12 for K9, K10, P1 and P2 in both routes of K10 and P1, phase 5's
    f32 call for the FMA routes of A, B and C; every phase under
    `launches_by_phase`), its error and times from phase 2 (bf16, but f32
    for the FMA routes), and its bound at the timed shapes (bytes: each
    input read once, each output written once); F's tensor-core route and
    gn_stats at the f8 decoder tail, its FMA route at faceir's head, K10 at
    unet res@64, each with every timed shape under `by_shape`, K10
    and P1 with their kernels' profiler device time (and K10 its U
    transform's time); P2 in both routes in its f32 mode, every mode under
    `by_mode`."""
    nh, n, c, hidden, bsz = NH, N, C, HIDDEN, BSZ
    s2 = 2  # bf16 bytes
    t, nw = 4096, 4096 // n
    a_bytes = 2 * bsz * t * c * s2 + (4 * c * c + 4 * c) * s2 + 4 * bsz * c * 4 + nh * n * n * 4
    a_ops = bsz * nw * (2 * n * c * 3 * c + 4 * nh * n * n * (c // nh) + 2 * n * c * c)
    b_bytes = 2 * bsz * t * c * s2 + (2 * c * hidden + hidden + c) * s2 + 4 * bsz * c * 4
    b_ops = bsz * t * 4 * c * hidden
    c_bytes, c_ops = 4 * bsz * 4096 * 512 * s2, 4 * bsz * 4096 ** 2 * 512
    # D: z and the codebook read once, the int64 indices written once; D
    # multiply-adds, a compare and a select a (row, code) pair
    vq_bound = lambda m_rows, k, d: bound(m_rows * d * 4 + k * d * 4 + m_rows * 8,
                                          m_rows * k * (2 * d + 2), "f32")
    e_bytes = 2 * WIDE_LATENTS[0][0] * WIDE_LATENTS[0][1] * c * s2  # a permutation: no operations
    a_repl = "resshift_tpu/ops/swin_block_pallas.py:389 (K1) and :496 (K3)"
    b_repl = "resshift_tpu/ops/swin_block_pallas.py:629 (K2) and :701 (K4)"
    c_repl = "resshift_tpu/ops/flash_attention_pallas.py:100 (K5)"
    meta = {
        "A": ("swin_window_attn_tc", "resshift_tpu_torch/csrc/swin_window_attn_tc.cu", a_repl,
              bound(a_bytes, a_ops, "bf16")),
        "B": ("swin_mlp_tc", "resshift_tpu_torch/csrc/swin_mlp_tc.cu", b_repl,
              bound(b_bytes, b_ops, "bf16")),
        "C": ("flash_attn_1h_tc", "resshift_tpu_torch/csrc/flash_attn_1h_tc.cu", c_repl,
              bound(c_bytes, c_ops, "bf16")),
        "D": ("vq_nearest", "resshift_tpu_torch/csrc/vq_nearest.cu",
              "resshift_tpu/ops/vq_pallas.py:70 (K6)", vq_bound(*VQ_SHAPES[0][1:])),
        "E": ("shift_tokens", "resshift_tpu_torch/csrc/shift_tokens.cu",
              "resshift_tpu/ops/shift_pallas.py:115 (K7)", bound(e_bytes, 0, "bf16")),
    }
    rows = []
    for key, (name, src, repl, (b_ms, b_by)) in meta.items():
        tk = timed[key]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                     "launches": launches["6"][key], "max_abs_err": errs[key], "ms": tk[0],
                     "plain_ms": tk[1], "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": tk[2] if len(tk) > 2 else None,
                     "launches_by_phase": {ph: n.get(key, 0) for ph, n in launches.items()}})
    rows += tail_rows(launches, errs, timed["F"])
    # D: no library call; its second pass (vq_finalize) counted apart, each
    # shape's time, bound and device time by kernel
    d_row = rows[3]
    d_row.update(library_ms=None, device_ms_by_kernel=timed["D"][2],
                 finalize_launches=launches["6"]["D finalize"],
                 finalize_launches_by_phase={ph: n.get("D finalize", 0)
                                             for ph, n in launches.items()})
    d_row["by_shape"] = {f"{m} x {k} x {d}": {"ms": timed[key][0], "plain_ms": timed[key][1],
                                              **dict(zip(("bound_ms", "bound_by"),
                                                         vq_bound(m, k, d))),
                                              "device_ms_by_kernel": timed[key][2]}
                         for key, m, k, d in VQ_SHAPES}

    # the profiling entry points' kernels: launched in phase 12 (the tools);
    # K9, K10 and P1 in both routes
    k10_repl = "resshift_tpu/ops/winograd.py:272 (K10, winograd_conv3x3 :237)"
    p1_repl = "tools/profile_conv_pallas.py:78 (P1, conv3x3_pallas :69)"
    k10 = {key: {label: timed[f"{key} {label}"] for label, *_ in K10_SHAPES}
           for key in ("K10", "K10 f32")}
    csrc = "resshift_tpu_torch/csrc/"
    p2_repl = "tools/profile_attn_variants.py:106 (P2, call_variant :99)"
    # P2's row: its f32 mode (kernel A's softmax), every mode under by_mode
    p2 = {key: timed[key]["f32"][:2] + (None,) + timed[key]["f32"][2:] for key in ("P2", "P2 f32")}
    k9_repl = "resshift_tpu/ops/swin_attention_pallas.py:197 (K9, _forward_pallas :158)"
    probes = {
        "K9": (csrc + "window_attn_tc.cu", k9_repl, errs["K9"], timed["K9"]),
        "K9 f32": (csrc + "window_attn.cu", k9_repl, errs["K9 f32"], timed["K9 f32"]),
        "K10": (csrc + "winograd_conv3x3_tc.cu", k10_repl,  # the census shapes' errors too
                max(v for k, v in errs.items() if k.startswith("K10 ") and "f32" not in k),
                k10["K10"][K10_SHAPES[0][0]]),
        "K10 f32": (csrc + "winograd_conv3x3.cu", k10_repl,
                    max(errs[f"K10 f32 {label}"] for label in k10["K10 f32"]),
                    k10["K10 f32"][K10_SHAPES[0][0]]),
        "P1": (csrc + "conv3x3_tc.cu", p1_repl, errs["P1"], timed["P1"]),
        "P1 f32": (csrc + "conv3x3.cu", p1_repl, errs["P1 f32"], timed["P1 f32"]),
        "P2": (csrc + "attn_variants_tc.cu", p2_repl, errs["P2"], p2["P2"]),
        "P2 f32": (csrc + "attn_variants.cu", p2_repl, errs["P2 f32"], p2["P2 f32"]),
    }
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    probe_rows = {}
    for key, (src, repl, err, t) in probes.items():
        row = {"name": PROBE_KERNELS[key], "route": "cuda", "source": src, "replaces": repl,
               "launches": launches["12"][key], "max_abs_err": err, **dict(zip(keys, t[:5])),
               "launches_by_phase": {ph: n.get(key, 0) for ph, n in launches.items()}}
        if key.startswith(("K9", "K10", "P1", "P2")):
            row["dtype"] = "f32" if key.endswith("f32") else "bf16"
            row.update(t[5])
        rows.append(row)
        probe_rows[key] = row
    for key in ("K10", "K10 f32"):  # the shape timed first is the row's; both under by_shape
        probe_rows[key]["by_shape"] = {label: {**dict(zip(keys, t[:5])), **t[5]}
                                       for label, t in k10[key].items()}
    for key in ("P2", "P2 f32"):
        probe_rows[key]["by_mode"] = {sm: {**dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"),
                                                      t[:4])), **t[4]}
                                      for sm, t in timed[key].items()}

    # the f32 routes of A, B and C (FMA kernels), launched by phase 5's f32
    # call; their bound at f32 widths and the f32 FMA rate
    f32 = {"A f32": ("swin_window_attn", "resshift_tpu_torch/csrc/swin_window_attn.cu", a_repl,
                     bound(2 * a_bytes - (4 * bsz * c * 4) - nh * n * n * 4, a_ops, "f32")),
           "B f32": ("swin_mlp", "resshift_tpu_torch/csrc/swin_mlp.cu", b_repl,
                     bound(2 * b_bytes - (4 * bsz * c * 4), b_ops, "f32")),
           "C f32": ("flash_attn_1h", "resshift_tpu_torch/csrc/flash_attn_1h.cu", c_repl,
                     bound(2 * c_bytes, c_ops, "f32"))}
    for key, (name, src, repl, (b_ms, b_by)) in f32.items():
        tk = timed[key]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                     "launches": launches["5 f32"][key], "max_abs_err": errs[key], "ms": tk[0],
                     "plain_ms": tk[1], "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": tk[2] if len(tk) > 2 else None, "dtype": "f32",
                     "launches_by_phase": {ph: n.get(key, 0) for ph, n in launches.items()}})
    for row in rows[0:3]:  # A, B and C: their tensor-core routes
        row["dtype"] = "bf16"
    rows[0]["by_tokens"] = {k[2:]: dict(zip(("ms", "plain_ms", "kernel_device_ms"), t))
                            for k, t in timed.items() if k.startswith("A T=")}
    rows[0]["by_tokens"]["T=4096"] = {"ms": timed["A"][0], "plain_ms": timed["A"][1],
                                      "kernel_device_ms": timed["A device"][
                                          "swin_window_attn_tc_kernel"]}
    rows[1]["by_tokens"] = {k[2:]: dict(zip(("ms", "plain_ms"), t)) for k, t in timed.items()
                            if k.startswith("B T=")}
    for row, key in ((rows[0], "A device"), (rows[-3], "A f32 device")):
        row["device_ms_by_kernel"] = timed[key]  # the kernel and the statistics reduce
    return rows


def main() -> int:
    # cuBLAS's deterministic workspace (phase 17(b) turns deterministic
    # algorithms on), set before the first cuBLAS call
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "resshift_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from resshift_tpu_torch import _ext
    from resshift_tpu_torch.ops import attn_variants as av, conv3x3 as cv, flash_attention as fa
    from resshift_tpu_torch.ops import shift as shift_ops
    from resshift_tpu_torch.ops import swin_block as sb, tail, vq, window_attention as wa
    from resshift_tpu_torch.ops import winograd as wg
    from resshift_tpu_torch.pipeline import ResShiftPipeline

    # the f32 comparisons below hold only with TF32 off for matmuls and convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---------------------------------------------------------------- 1
    t0 = t_main = time.perf_counter()
    _ext.build_all()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for log in sorted((ROOT / "resshift_tpu_torch" / "_build").glob("*.log")):
        for line in log.read_text().splitlines():  # each kernel's name, then its counts
            if ("entry function" in line or "registers" in line or "spill" in line
                    or line.startswith("built in")):
                print(f"  {log.stem}: {line.strip()}")

    # ---------------------------------------------------------------- 2
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 2: kernels against their plain versions", flush=True)
    errs, timed = check_kernels(dev)
    timed["E"], errs["E"] = check_shift(dev), 0.0
    timed["wide block"] = check_wide_block(dev)
    f_errs, timed["F"] = check_tail(dev)
    errs.update(f_errs)
    k9_errs, k9_timed = check_window_attention(dev)
    errs.update(k9_errs)
    timed.update(k9_timed)
    conv_errs, conv_timed = check_conv_probes(dev)
    errs.update(conv_errs)
    timed.update(conv_timed)
    p2_errs, p2_timed = check_attn_variants(dev)
    errs.update(p2_errs)
    timed.update(p2_timed)
    grad_errs = check_grads(dev)

    # ---------------------------------------------------------------- 3
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 3: realsr_v1, full width, bf16, 15 steps, batch 8 of 64x64", flush=True)

    pipe = ResShiftPipeline("realsr_v1", dtype=torch.bfloat16)
    pipe.init_params(seed=0)
    sds = with_biases(pipe)
    v1_sds = sds  # realsr_v1's weights, for phases 15-16 (phases 9-10 rebind sds)
    pipe.load_state_dicts(**sds)
    lq = torch.rand(BSZ, 64, 64, 3, generator=torch.Generator().manual_seed(2)).to(dev) * 2 - 1
    latents = {}

    # A, B and C by route: the tensor-core kernels (bf16) and the FMA ones
    # (f32); D's search and its second pass; K9, K10 and P1, off the sampler
    # path, must launch 0 times there
    all_kernels = {"A": sb.SWIN_WINDOW_ATTN_TC, "A f32": sb.SWIN_WINDOW_ATTN,
                   "B": sb.SWIN_MLP_TC, "B f32": sb.SWIN_MLP,
                   "C": fa.FLASH_ATTN_1H_TC, "C f32": fa.FLASH_ATTN_1H, "D": vq.VQ_NEAREST,
                   "D finalize": vq.VQ_FINALIZE, "E": shift_ops.SHIFT_TOKENS,
                   "F": tail.GN_SILU_CONV3X3, "F tc": tail.GN_SILU_CONV3X3_TC,
                   "F stats": tail.GN_STATS, "K9": wa.WINDOW_ATTN_TC, "K9 f32": wa.WINDOW_ATTN,
                   "K10": wg.WINOGRAD_CONV3X3_TC, "K10 f32": wg.WINOGRAD_CONV3X3,
                   "P1": cv.CONV3X3_TC, "P1 f32": cv.CONV3X3, "P2": av.ATTN_VARIANTS_TC,
                   "P2 f32": av.ATTN_VARIANTS}

    def runner(p, x, seed, mask=None):
        """One sample call of pipeline `p` on `x` (and `mask`), the final
        latent kept under `tag`."""
        orig_decode = p._decode

        def run(tag):
            def _decode(vqm, z):
                latents[tag] = z.float().clone()
                return orig_decode(vqm, z)

            p._decode = _decode
            out = p.sample(x, torch.Generator(device=dev).manual_seed(seed), mask)
            torch.cuda.synchronize()
            return out
        return run

    def reset():
        for kern in all_kernels.values():
            kern.reset()

    def timed_calls(run, n):
        times = []
        for _ in range(n):
            t1 = time.perf_counter()
            run("kernel")
            times.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(times), times

    def plain_path(run, c_plain):
        """`run` with every kernel swapped for its plain version (here
        only); returns its output."""
        swaps = [(sb, "norm_attn_residual_stats", sb.norm_attn_residual_stats_plain),
                 (sb, "shift_attn_residual_stats", sb.shift_attn_residual_stats_plain),
                 (sb, "norm_mlp_residual_stats", sb.norm_mlp_residual_stats_plain),
                 (sb, "mlp_unshift_residual_stats", sb.mlp_unshift_residual_stats_plain),
                 (shift_ops, "shift_tokens", shift_ops.shift_tokens_plain),
                 (fa, "flash_attention_1h", c_plain),
                 (vq, "nearest_codebook_indices", vq.nearest_codebook_indices_plain)]
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            reset()
            out_plain = run("plain")
            if any(kern.launches for kern in all_kernels.values()):
                raise AssertionError("the plain path launched a kernel")
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        return out_plain

    def latent_psnr(out, out_plain):
        a, b = latents["kernel"].double(), latents["plain"].double()
        peak = b.abs().max().item()
        psnr = 10 * math.log10(peak ** 2 / max(((a - b) ** 2).mean().item(), 1e-30))
        psnr_img = 10 * math.log10(4.0 / max(((out - out_plain) ** 2).mean().item(), 1e-30))
        print(f"  final latent PSNR kernel vs plain: {psnr:.2f} dB (bar 35), "
              f"image PSNR {psnr_img:.2f} dB (bar 35)", flush=True)
        if not (psnr >= 35.0 and psnr_img >= 35.0):
            raise AssertionError(f"latent PSNR {psnr:.2f} dB or image PSNR {psnr_img:.2f} dB "
                                 f"below 35")

    run = runner(pipe, lq, 3)
    reset()
    out = run("kernel")
    launches = {"3": read_launches(all_kernels, sb)}
    print(f"  launches in one sample call: {launches['3']}", flush=True)
    want_launches = {"A": 270, "B": 270, "C": 2, "D": 1, "D finalize": 1, "E": 0, "F": 0,
                     "F tc": 0, "F stats": 0,
                     "fused shift": 90, "A f32": 0, "B f32": 0, "C f32": 0, "K9": 0, "K9 f32": 0,
                     "K10": 0, "K10 f32": 0, "P1": 0, "P1 f32": 0, "P2": 0, "P2 f32": 0}
    if launches["3"] != want_launches:
        raise AssertionError(f"launch counts {launches['3']}, want {want_launches}")
    if out.shape != (BSZ, 256, 256, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"bad output {tuple(out.shape)}")
    ms, times = timed_calls(run, 3)
    mpx = BSZ * 256 * 256 / (ms / 1e3) / 1e6
    print(f"  sample: {ms:.1f} ms per call (median of {times}), {mpx:.3f} Mpx/s "
          f"on {card}", flush=True)

    profile_sample(torch, lambda: run("kernel"))

    # ---------------------------------------------------------------- 4
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 4: the same sample through the plain versions", flush=True)
    latent_psnr(out, plain_path(run, fa.attention_plain))

    # ---------------------------------------------------------------- 5
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 5: a chopped 112x176 input (chop 64, stride 48, tile_bs 16)", flush=True)
    lq2 = torch.rand(1, 112, 176, 3, generator=torch.Generator().manual_seed(4)).to(dev) * 2 - 1
    out2 = pipe.sample(lq2, torch.Generator(device=dev).manual_seed(5), chop_size=64,
                       chop_stride=48, tile_bs=16)
    torch.cuda.synchronize()
    if out2.shape != (1, 448, 704, 3) or not torch.isfinite(out2).all():
        raise AssertionError(f"chopped output {tuple(out2.shape)} not finite or misshapen")
    print(f"  chopped output {tuple(out2.shape)}, finite, in [{out2.min().item():.3f}, "
          f"{out2.max().item():.3f}]", flush=True)
    # the same input in f32: A, B and C take their FMA routes, D its f32 code
    pipe32 = ResShiftPipeline("realsr_v1", dtype=torch.float32)
    pipe32.load_state_dicts(**sds)
    reset()
    t1 = time.perf_counter()
    out32 = pipe32.sample(lq2, torch.Generator(device=dev).manual_seed(5), chop_size=64,
                          chop_stride=48, tile_bs=16)
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t1) * 1e3
    launches["5 f32"] = read_launches(all_kernels, sb)
    print(f"  f32: launches {launches['5 f32']}, {ms32:.1f} ms (first call)", flush=True)
    if any(launches["5 f32"][k] or not launches["5 f32"][f"{k} f32"] for k in "ABC"):
        raise AssertionError("an f32 call must launch the FMA routes of A, B and C, and only "
                             "them")
    if out32.shape != out2.shape or not torch.isfinite(out32).all():
        raise AssertionError(f"f32 chopped output {tuple(out32.shape)} not finite or misshapen")
    psnr = 10 * math.log10(4.0 / max(((out32 - out2) ** 2).mean().item(), 1e-30))
    print(f"  f32 output finite, image PSNR against the bf16 call {psnr:.2f} dB (not gated: "
          f"the dtypes differ throughout)", flush=True)
    del pipe, pipe32, run, out, out2, out32

    # ---------------------------------------------------------------- 6, 7
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    pipe3 = ResShiftPipeline("realsr_v3", dtype=torch.bfloat16)
    pipe3.load_state_dicts(**sds)  # the same model as realsr_v1, the same weights
    for phase, (lh, lw), seed in (("6", (176, 250), 8), ("7", (512, 512), 9)):
        ph, pw = (-(-s // 64) * 64 for s in (lh, lw))  # padded to the padding offset
        print(f"phase {phase}: realsr_v3, full width, bf16, 4 steps, one whole {lh}x{lw} "
              f"photo, unchopped ({ph}x{pw} latent)", flush=True)
        x = torch.rand(1, lh, lw, 3, generator=torch.Generator().manual_seed(seed)).to(dev)
        run = runner(pipe3, x * 2 - 1, seed)
        reset()
        if phase == "6":
            t1 = time.perf_counter()
            out = run("kernel")
            first_ms = (time.perf_counter() - t1) * 1e3
        else:  # one call only, under the profiler: C's time at N = 262144 by name
            out, first_ms = profile_sample(torch, lambda: run("kernel"))
        launches[phase] = read_launches(all_kernels, sb)
        want = expected_launches(pipe3.config, ph, pw)
        print(f"  launches in one sample call: {launches[phase]} (derived: {want})", flush=True)
        if launches[phase] != want or not all(launches[phase][k] for k in "ABCDE"):
            raise AssertionError(f"launch counts {launches[phase]}, want {want}, none of A-E "
                                 f"zero")
        if out.shape != (1, 4 * lh, 4 * lw, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"bad output {tuple(out.shape)}")
        mpx_out = 16 * lh * lw / 1e6
        if phase == "6":
            ms, times = timed_calls(run, 2)
            print(f"  sample: {ms:.1f} ms per call (median of {times}; first call "
                  f"{first_ms:.1f}), {mpx_out / (ms / 1e3):.4f} Mpx/s of {4 * lh}x{4 * lw} "
                  f"output on {card}", flush=True)
            profile_sample(torch, lambda: run("kernel"))
            print("  the same sample through the plain versions (C in query chunks)",
                  flush=True)
            latent_psnr(out, plain_path(run, fa.chunked_attention_plain))
        else:
            print(f"  sample: {first_ms:.1f} ms for one call (the first at this shape, "
                  f"profiled), {mpx_out / (first_ms / 1e3):.4f} Mpx/s of {4 * lh}x{4 * lw} "
                  f"output on {card}", flush=True)
        del run, out
    del pipe3

    # ---------------------------------------------------------------- 8
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 8: python -m resshift_tpu_torch.cli infer on two PNGs (realsr_v1, bf16)",
          flush=True)
    import numpy as np

    from resshift_tpu_torch.utils.image_io import png_decode, png_encode

    def cli_infer(args: list, src: Path, dst: Path, subprocess_: bool = True) -> None:
        """`cli infer` with `args` on folder `src`: `python -m` in a subprocess,
        or `cli.main` in this process."""
        argv = ["infer", *args, "--seed", "0", "--in-path", str(src), "--out-path", str(dst)]
        t1 = time.perf_counter()
        if subprocess_:
            r = subprocess.run([sys.executable, "-m", "resshift_tpu_torch.cli", *argv], cwd=ROOT,
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"cli infer {args} failed (rc {r.returncode}):\n"
                                     f"{r.stdout}\n{r.stderr}")
            stdout = r.stdout
        else:
            stdout = run_main("resshift_tpu_torch.cli", argv)
        cli_s = time.perf_counter() - t1
        done = [ln for ln in stdout.splitlines() if ln.startswith("Done:")]
        print(f"  {' '.join(args)}: {done[0] if done else 'no Done line'} ({cli_s:.1f} s"
              f"{' with start-up' if subprocess_ else ', in process'})", flush=True)

    def read_output(path: Path, shape: tuple) -> np.ndarray:
        sr = png_decode(path.read_bytes())
        if sr.shape != shape or sr.dtype != np.uint8 or sr.std() == 0:
            raise AssertionError(f"cli output {path.name}: {sr.shape} {sr.dtype}, want {shape}")
        print(f"  {path.name}: {sr.shape[1]}x{sr.shape[0]} RGB, 8-bit", flush=True)
        return sr

    rng = torch.Generator().manual_seed(10)
    png = lambda *shape: torch.randint(0, 256, shape, generator=rng, dtype=torch.uint8).numpy()
    sizes = {"square": (64, 64), "wide": (100, 150)}  # the wide one pads to a 128x192 latent
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp, "lq"), Path(tmp, "sr")
        src.mkdir()
        for name, (h, w) in sizes.items():
            (src / f"{name}.png").write_bytes(png_encode(png(h, w, 3)))
        cli_infer(["--task", "realsr", "--version", "v1"], src, dst)
        for name, (h, w) in sizes.items():
            read_output(dst / f"{name}.png", (4 * h, 4 * w, 3))

    # ---------------------------------------------------------------- 9, 10
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    from resshift_tpu_torch.config import task_config

    def task_pipeline(name: str, pin: bool, sds=None):
        """Task `name` at full width in bf16, kernel F pinned or not in the
        UNet head and the VQGAN decoder tail through the config keys
        `model.use_pallas` (true, or unset: A, B and E on, F off) and
        `autoencoder.use_pallas` (true, or unset: C and D on, F off), as a
        `--config` YAML sets them; phase 3's kind of random weights, or
        `sds`."""
        cfg = task_config(name)
        cfg["model"]["use_pallas"] = True if pin else None
        cfg["autoencoder"]["use_pallas"] = True if pin else None
        p = ResShiftPipeline(cfg, dtype=torch.bfloat16)
        if sds is None:
            p.init_params(seed=0)
            sds = with_biases(p)
        p.load_state_dicts(**sds)
        return p, sds

    for phase, name, side, seed in (("9", "faceir", 512, 12), ("10", "inpaint_imagenet", 256, 13)):
        pinned, sds = task_pipeline(name, True)
        f = 2 ** (len(pinned.config["autoencoder"]["ddconfig"]["ch_mult"]) - 1)
        print(f"phase {phase}: {name}, full width, bf16, {pinned.sched.num_timesteps} steps, one "
              f"{side}x{side} image ({side // f}x{side // f} latent), pinned model.use_pallas "
              f"and autoencoder.use_pallas", flush=True)
        gx = torch.Generator().manual_seed(seed)
        x = torch.rand(1, side, side, 3, generator=gx).to(dev) * 2 - 1
        mask = None
        if pinned.cond_mask:  # a seeded rectangle to fill (1) in a kept field (-1)
            y0, x0, mh, mw = (int(v) for v in torch.randint(side // 8, side // 2, (4,),
                                                            generator=gx))
            mask = -torch.ones(1, side, side, 1, device=dev)
            mask[:, y0:y0 + mh, x0:x0 + mw] = 1.0
            print(f"  mask: rows {y0}-{y0 + mh}, columns {x0}-{x0 + mw} filled", flush=True)
        run = runner(pinned, x, seed, mask)
        reset()
        t1 = time.perf_counter()
        out = run("kernel")
        first_ms = (time.perf_counter() - t1) * 1e3
        launches[phase] = read_launches(all_kernels, sb)
        want = expected_launches(pinned.config, side // f, side // f, tail_pinned=True)
        print(f"  launches in one sample call: {launches[phase]} (derived: {want})", flush=True)
        if launches[phase] != want or not all(launches[phase][k] for k in "ABCDF"):
            raise AssertionError(f"launch counts {launches[phase]}, want {want}, none of A-D "
                                 f"or F zero")
        if out.shape != (1, side, side, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"bad output {tuple(out.shape)}")

        unpinned, _ = task_pipeline(name, False, sds)
        urun = runner(unpinned, x, seed, mask)
        print("  the same call unpinned, through the plain versions", flush=True)
        latent_psnr(out, plain_path(urun, fa.attention_plain))
        reset()
        urun("unpinned")
        got, want = read_launches(all_kernels, sb), expected_launches(
            unpinned.config, side // f, side // f)
        if got != want:
            raise AssertionError(f"unpinned launch counts {got}, want {want}")
        times = {"pinned": [], "unpinned": []}
        for tag, fn in (("pinned", run), ("unpinned", urun), ("unpinned", urun),
                        ("pinned", run)):
            t1 = time.perf_counter()
            fn(tag)
            times[tag].append((time.perf_counter() - t1) * 1e3)
        ms = {k: statistics.median(v) for k, v in times.items()}
        profile_sample(torch, lambda: run("kernel"))  # where one pinned call's time goes
        print(f"  sample: pinned {ms['pinned']:.1f} ms per call ({times['pinned']}; first call "
              f"{first_ms:.1f}), unpinned {ms['unpinned']:.1f} ms ({times['unpinned']}; "
              f"launches {got}), {(side * side / 1e6) / (ms['pinned'] / 1e3):.4f} Mpx/s pinned, "
              f"on {card}", flush=True)
        del pinned, unpinned, run, urun, out

    # ---------------------------------------------------------------- 11
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 11: cli infer through cli.main in this process (phase 8 ran the module "
          "entry point): inpaint_face with --mask-path, faceir, realsr --scale 2", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for d in ("inp", "masks", "face", "x2"):
            (tmp / d).mkdir()
        # the mask matches a_face.png by stem; b_other.png takes the first mask
        ims = {n: png(256, 256, 3) for n in ("a_face", "b_other")}
        for n, im in ims.items():
            (tmp / "inp" / f"{n}.png").write_bytes(png_encode(im))
        m = np.zeros((256, 256), np.uint8)
        m[64:160, 80:200] = 255
        (tmp / "masks" / "a_face.png").write_bytes(png_encode(m))
        cli_infer(["--task", "inpaint_face", "--mask-path", str(tmp / "masks")], tmp / "inp",
                  tmp / "inp_out", subprocess_=False)
        keep = m == 0
        for n, im in ims.items():
            sr = read_output(tmp / "inp_out" / f"{n}.png", (256, 256, 3))
            if not np.array_equal(sr[keep], im[keep]) or np.array_equal(sr[~keep], im[~keep]):
                raise AssertionError(f"{n}: outside the mask the output must equal the input "
                                     f"and inside it must not")
            print(f"  {n}.png: equal to the input at all {int(keep.sum())} px outside the mask, "
                  f"restored inside", flush=True)
        (tmp / "face" / "face.png").write_bytes(png_encode(png(512, 512, 3)))
        cli_infer(["--task", "faceir"], tmp / "face", tmp / "face_out", subprocess_=False)
        read_output(tmp / "face_out" / "face.png", (512, 512, 3))
        # the wide one pads to 128x256; 150 pads to 192 by the padding
        # offset, whose latent (96) the deepest Swin level's windows do not
        # divide, so the pipeline pads it on to 256
        x2_sizes = {"square": (128, 128), "wide": (100, 230), "odd": (100, 150)}
        for n, (h, w) in x2_sizes.items():
            (tmp / "x2" / f"{n}.png").write_bytes(png_encode(png(h, w, 3)))
        cli_infer(["--task", "realsr", "--scale", "2"], tmp / "x2", tmp / "x2_out",
                  subprocess_=False)
        for n, (h, w) in x2_sizes.items():
            read_output(tmp / "x2_out" / f"{n}.png", (2 * h, 2 * w, 3))

    # ---------------------------------------------------------------- 12
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 12: the port's tools through their main functions (full width, 2 timed "
          "calls each)",
          flush=True)
    counts = run_tools()
    launches["12"] = {key: counts.get(kern.name, 0) for key, kern in all_kernels.items()}
    launches["12"].update({key: counts.get(name, 0) for key, name in PROBE_KERNELS.items()})
    print(f"  launches in phase 12: {launches['12']}", flush=True)

    # ---------------------------------------------------------------- 13
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 13: serving in process: Predictor (realsr_v3, full width, bf16), buckets "
          "1-16 warmed up at 64x64, a concurrent burst", flush=True)
    import threading

    from resshift_tpu_torch.serve import Predictor, ServerBusyError

    burst, max_batch, max_queue = 40, 16, 40  # the whole burst fits in the queue
    pred = Predictor("realsr_v3", max_batch=max_batch, max_queue=max_queue,
                     batch_window_s=0.05, seed=14)
    try:
        t1 = time.perf_counter()
        pred.warmup((64, 64))
        print(f"  warmup of buckets {pred.batch_sizes}: {time.perf_counter() - t1:.1f} s",
              flush=True)
        n0 = len(pred.batch_sizes)
        img = torch.randint(0, 256, (64, 64, 3), generator=torch.Generator().manual_seed(15),
                            dtype=torch.uint8).numpy()
        outs, errors = {}, []

        def ask(i):
            try:
                outs[i] = pred.predict(img)
            except Exception as e:  # noqa: BLE001 -- raised below, after the join
                errors.append(e)

        reset()
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(burst)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t1
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"burst failed: {errors[:3]}")
        sizes = pred.batch_sizes[n0:]
        forwards = len(sizes)
        launches["13"] = read_launches(all_kernels, sb)  # read after the join
        per = expected_launches(pred.pipe.config, 64, 64)
        want = {k: v * forwards for k, v in per.items()}
        print(f"  batch sizes {sizes}; launches {launches['13']} (derived: {forwards} x {per})",
              flush=True)
        if launches["13"] != want or not all(launches["13"][k] for k in "ABCD"):
            raise AssertionError(f"launch counts {launches['13']}, want {want}")
        if sum(sizes) != burst or max(sizes) < 2:
            raise AssertionError(f"batch sizes {sizes}: want {burst} images in batches")
        for i in range(burst):
            o = outs[i]
            if o.shape != (256, 256, 3) or not np.isfinite(o).all():
                raise AssertionError(f"output {i}: {o.shape}, finite {np.isfinite(o).all()}")
            if i and np.array_equal(o, outs[0]):
                raise AssertionError(f"outputs 0 and {i} are equal for identical inputs")
        lat = sorted(list(pred._lat)[-forwards:])
        q = lambda f: lat[min(len(lat) - 1, int(f * len(lat)))] * 1e3
        serve13 = {"burst": burst, "max_batch": max_batch, "forwards_per_s": forwards / wall,
                   "mpx": burst * 256 * 256 / wall / 1e6}
        print(f"  {burst} requests in {wall * 1e3:.1f} ms: {forwards / wall:.3f} forwards/s, "
              f"{burst * 256 * 256 / wall / 1e6:.4f} Mpx/s of 256x256 output, forward p50 "
              f"{q(0.5):.1f} ms, p99 {q(0.99):.1f} ms, on {card}", flush=True)

        # one forward held at a gate, the queue filled: one more is refused
        gate, entered = threading.Event(), threading.Event()
        real = pred.pipe.sample

        def held(*a, **k):
            entered.set()
            gate.wait(120)
            return real(*a, **k)

        pred.pipe.sample = held
        errors.clear()
        waiting = [threading.Thread(target=ask, args=(burst,))]
        waiting[0].start()
        entered.wait(60)
        waiting += [threading.Thread(target=ask, args=(burst + 1 + i,))
                    for i in range(max_queue)]
        for t in waiting[1:]:
            t.start()
        deadline = time.monotonic() + 60
        while pred.queue_depth() < max_queue and time.monotonic() < deadline:
            time.sleep(0.01)
        refused = False
        try:
            pred.predict(img)
        except ServerBusyError:
            refused = True
        finally:
            gate.set()
        for t in waiting:
            t.join(timeout=600)
        pred.pipe.sample = real
        if not refused or errors:
            raise AssertionError(f"a request beyond max_queue {max_queue} was not refused "
                                 f"(refused {refused}, errors {errors[:3]})")
        print(f"  queue full at {max_queue}: the next request raised ServerBusyError; "
              f"metrics {pred.metrics()}", flush=True)
    finally:
        pred.close()
    del pred, outs

    # ---------------------------------------------------------------- 14
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 14: python -m resshift_tpu_torch.tools.serve_loadtest (the HTTP path, a "
          "server subprocess)", flush=True)
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    lt = dict(burst=48, threads=16, overload=64, max_queue=24, max_batch=16)
    cmd = [sys.executable, "-m", "resshift_tpu_torch.tools.serve_loadtest", "--device", "cuda",
           "--port", str(port), *[a for k, v in lt.items()
                                  for a in (f"--{k.replace('_', '-')}", str(v))]]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"serve_loadtest failed (rc {r.returncode}):\n{r.stdout}\n"
                             f"{r.stderr[-4000:]}")
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    b, o, m = rep["burst"], rep["overload"], rep["server_metrics"]
    warm = sum(2 ** i for i in range(int(math.log2(lt["max_batch"])) + 1))
    print(f"  card {rep['card']}; server up in {rep['startup_s']:.1f} s; burst {b}", flush=True)
    print(f"  overload {o}", flush=True)
    print(f"  /metrics {m}", flush=True)
    problems = [msg for bad, msg in (
        (b["ok"] != lt["burst"] or b["png_ok"] != b["ok"], "a burst request failed or its PNG "
                                                           "is not 256x256 RGB"),
        (o["rejected"] == 0 or not o["retry_after_set"], "the overload burst got no 429 with "
                                                         "Retry-After"),
        (o["ok"] != o["png_ok"] or o["ok"] + o["rejected"] != lt["overload"],
         "an overload request got neither a PNG nor 429"),
        (m["requests_rejected"] != o["rejected"], "/metrics rejected != 429s"),
        (m["requests_done"] != warm + 1 + b["ok"] + o["ok"] or m["requests_error"],
         "/metrics requests_done != warmup + first + 200s"),
        (sum(int(k) * v for k, v in m["batch_size_hist"].items()) != m["requests_done"],
         "the batch histogram does not add up")) if bad]
    if problems:
        raise AssertionError(f"serve_loadtest: {problems}")
    print(f"  through HTTP: {b['mpx_per_s']:.4f} Mpx/s, client p50 {b['p50_ms']:.1f} ms, p99 "
          f"{b['p99_ms']:.1f} ms; overload: {o['rejected']} of {lt['overload']} got 429 in at "
          f"most {o['reject_latency_ms_max']:.1f} ms", flush=True)

    # ---------------------------------------------------------------- 15
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 15: DDPM (configs/ddpm_ablation.yaml: DDIM, 50 of 1000 steps) on realsr_v1, "
          "full width, bf16, 8 x 64x64", flush=True)
    cfg = task_config("realsr_v1")
    cfg["diffusion"] = dict(variant="ddpm", steps=1000, beta_start=1.0e-4, beta_end=0.02,
                            predict_type="epsilon", timestep_respacing=50, sampler="ddim",
                            eta=0.0, scale_factor=1.0)
    dpipe = ResShiftPipeline(cfg, dtype=torch.bfloat16)
    dpipe.load_state_dicts(**v1_sds)
    steps = dpipe.sched.num_timesteps
    lq = torch.rand(BSZ, 64, 64, 3, generator=torch.Generator().manual_seed(16)).to(dev) * 2 - 1
    run = runner(dpipe, lq, 17)
    reset()
    t1 = time.perf_counter()
    out = run("kernel")
    first_ms = (time.perf_counter() - t1) * 1e3
    launches["15"] = read_launches(all_kernels, sb)
    want = expected_launches(cfg, 64, 64, steps=steps)
    want["C"] = 1  # the chain starts from pure noise: no encode, C in the decode only
    print(f"  launches in one sample call: {launches['15']} (derived: {want})", flush=True)
    if launches["15"] != want:
        raise AssertionError(f"launch counts {launches['15']}, want {want}")
    if out.shape != (BSZ, 256, 256, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"bad output {tuple(out.shape)}")
    ms, times = timed_calls(run, 2)
    print(f"  DDIM sample: {ms:.1f} ms per call (median of {times}; first call {first_ms:.1f}), "
          f"{BSZ * 256 * 256 / (ms / 1e3) / 1e6:.4f} Mpx/s, on {card}", flush=True)
    out_plain = plain_path(run, fa.attention_plain)
    a, b = latents["kernel"].double(), latents["plain"].double()
    psnr = 10 * math.log10(b.abs().max().item() ** 2 / max(((a - b) ** 2).mean().item(), 1e-30))
    psnr_img = 10 * math.log10(4.0 / max(((out - out_plain) ** 2).mean().item(), 1e-30))
    print(f"  final latent PSNR kernel vs plain: {psnr:.2f} dB (bar 35), image PSNR "
          f"{psnr_img:.2f} dB (not gated), latent range [{b.min().item():.3f}, "
          f"{b.max().item():.3f}]", flush=True)
    if not psnr >= 35.0:
        raise AssertionError(f"DDPM latent PSNR {psnr:.2f} dB below 35")
    del dpipe, run, out, out_plain

    # ---------------------------------------------------------------- 16
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 16: realsr_v1, 8 x 64x64: sample_time_parallel (Picard) and "
          "sample_progressive against sample", flush=True)
    pipe1 = ResShiftPipeline("realsr_v1", dtype=torch.bfloat16)
    pipe1.load_state_dicts(**v1_sds)
    steps = pipe1.sched.num_timesteps
    lq = torch.rand(BSZ, 64, 64, 3, generator=torch.Generator().manual_seed(18)).to(dev) * 2 - 1

    def capture(fn):
        """fn() with every latent that reaches the decoder kept; returns
        (result, latents, ms)."""
        zs, orig = [], pipe1._decode
        pipe1._decode = lambda vqm, z: zs.append(z.float().clone()) or orig(vqm, z)
        try:
            t1 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return res, zs, (time.perf_counter() - t1) * 1e3
        finally:
            pipe1._decode = orig

    gen = lambda: torch.Generator(device=dev).manual_seed(19)
    ref, (z_ref,), ref_ms = capture(lambda: pipe1.sample(lq, gen()))
    for tag, sweeps in (("16 T", steps), ("16 T//3", steps // 3)):
        reset()
        out, (z,), first = capture(lambda: pipe1.sample_time_parallel(lq, gen(), sweeps=sweeps))
        launches[tag] = read_launches(all_kernels, sb)
        want = expected_launches(pipe1.config, 64, 64, steps=sweeps)
        if launches[tag] != want:
            raise AssertionError(f"sweeps {sweeps}: launch counts {launches[tag]}, want {want}")
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"sweeps {sweeps}: bad output {tuple(out.shape)}")
        ms = statistics.median(
            [capture(lambda: pipe1.sample_time_parallel(lq, gen(), sweeps=sweeps))[2]
             for _ in range(2)])
        psnr, same = db(z, z_ref), (z == z_ref).float().mean().item()
        bar = "bar 35" if sweeps == steps else "not gated"
        print(f"  sweeps {sweeps} (a {steps * BSZ}-tile UNet batch): launches {launches[tag]}; "
              f"latent PSNR against sample {psnr:.2f} dB ({bar}), {100 * same:.2f}% of latent "
              f"values bit-equal, image PSNR {db(out, ref, 2.0):.2f} dB; {ms:.1f} ms per call "
              f"(first {first:.1f})", flush=True)
        if sweeps == steps and not psnr >= 35.0:
            raise AssertionError(f"time-parallel at sweeps = T: latent PSNR {psnr:.2f} below 35")
    seq_ms = statistics.median([capture(lambda: pipe1.sample(lq, gen()))[2] for _ in range(2)])
    print(f"  sample (sequential): {seq_ms:.1f} ms per call (first {ref_ms:.1f}), on {card}",
          flush=True)
    reset()
    (final, strip), zs, prog_ms = capture(lambda: pipe1.sample_progressive(lq, gen()))
    launches["16 progressive"] = read_launches(all_kernels, sb)
    want = expected_launches(pipe1.config, 64, 64)
    want.update({"C": steps + 2, "D": steps + 1, "D finalize": steps + 1})  # T + 1 decodes
    if launches["16 progressive"] != want:
        raise AssertionError(f"progressive: launch counts {launches['16 progressive']}, "
                             f"want {want}")
    if strip.shape != (steps, BSZ, 256, 256, 3) or not torch.isfinite(strip).all():
        raise AssertionError(f"progressive strip {tuple(strip.shape)}")
    psnr, same = db(zs[0], z_ref), (final == ref).float().mean().item()
    print(f"  progressive: launches {launches['16 progressive']}; strip {tuple(strip.shape)}; "
          f"final latent PSNR against sample {psnr:.2f} dB (bar 35), {100 * same:.2f}% of "
          f"output values bit-equal; {prog_ms:.1f} ms (first call)", flush=True)
    if not psnr >= 35.0:
        raise AssertionError(f"progressive final latent PSNR {psnr:.2f} dB below 35")
    del pipe1, ref, final, strip

    # ---------------------------------------------------------------- 17
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 17: realsr_v1 training, full width (UNet 160, Swin 192 / 6 x 32 / 8x8, f4 "
          "VQGAN), seeded random weights, bf16 compute on f32 masters, batch 64 in "
          "microbatches of 8, GT 256", flush=True)
    train_phase(dev, card, all_kernels, read_launches, reset, launches)

    # ---------------------------------------------------------------- 18
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 18: the LPIPS trainer at full width (bicsr, then inpaint_face), seeded "
          "random weights (LPIPS too: none ship), bf16 compute on f32 masters", flush=True)
    lpips_phase(dev, card, all_kernels, read_launches, reset, launches)

    # ---------------------------------------------------------------- 19
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 19: faceir training at full width (f8 VQGAN, UNet 160, GT 512), seeded "
          "random weights, bf16 compute on f32 masters; scripts celeba-faceir; the bsrgan "
          "loaders; the JPEG round trip", flush=True)
    faceir_phase(dev, card, all_kernels, read_launches, reset, launches)

    # ---------------------------------------------------------------- 20
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 20: the architecture options and the trainable variants: (a) realsr_v1 "
          "under the UNet options, (b) AutoencoderKL at KL-f16's shape, (c) UNetModel and "
          "UNetModelConv, (d) pixel-space training from packed files", flush=True)
    unet_options_phase(dev, card, all_kernels, read_launches, reset, launches)
    autoencoder_kl_phase(dev, card, all_kernels, read_launches, reset, launches)
    variants_phase(dev, card, all_kernels, read_launches, reset, launches)
    pixel_train_phase(dev, card, all_kernels, read_launches, reset, launches)

    # ---------------------------------------------------------------- 21
    print(f"[{time.perf_counter() - t_main:.1f} s into the run]", flush=True)
    print("phase 21: data parallelism over two replicas on the one card: (a) the batch- and "
          "tile-sharded samplers, (b) serving, (c) DP and FSDP training in a world-size-1 NCCL "
          "group", flush=True)
    parallel_phase(dev, card, all_kernels, read_launches, reset, launches, v1_sds, serve13)

    # ---------------------------------------------------------------- 22
    t22 = time.perf_counter()
    print(f"[{t22 - t_main:.1f} s into the run]", flush=True)
    print("phase 22: tensor and pipeline parallelism on the one card: (a) sample_tp over two "
          "gloo ranks sharing it, and in a world-size-1 NCCL group; (b) sample_pipelined over "
          "two stages, 2 x 2 stages x replicas, and [card, cpu]", flush=True)
    tp_phase(dev, card, all_kernels, read_launches, reset, launches, v1_sds)
    pp_phase(dev, card, all_kernels, read_launches, reset, launches, v1_sds)
    print(f"  phase 22 in {time.perf_counter() - t22:.1f} s", flush=True)
    print(f"chip_smoke: phases 1-22 in {time.perf_counter() - t_main:.1f} s", flush=True)

    rows = kernel_rows(launches, errs, timed)
    backward = {"A": "autograd Function: the plain version's gradient, recomputed",
                "B": "autograd Function: the plain version's gradient, recomputed",
                "C": "none (no VJP in JAX): raises where autograd would record it",
                "D": "none needed: integer indices",
                "E": "kernel E with inverse flipped",
                "F": "autograd Function: the plain composition's gradient, recomputed",
                "K9": "autograd Function: the plain version's gradient, recomputed"}
    by_name = {"swin_window_attn": "A", "swin_mlp": "B", "flash_attn_1h": "C",
               "vq_nearest": "D", "shift_tokens": "E", "gn_silu_conv3x3": "F", "gn_stats": "F",
               "window_attn": "K9"}
    for row in rows:  # K10, P1 and P2: no VJP in JAX
        kern = by_name.get(row["name"].removesuffix("_tc"))
        row["backward"] = backward.get(kern, "none (no VJP in JAX)")
        errs_k = [v for k, v in grad_errs.items()
                  if kern and k.startswith(kern + " ") and k.endswith(row.get("dtype", "bf16"))]
        row["backward_max_rel_err"] = max(errs_k) if errs_k else None
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
