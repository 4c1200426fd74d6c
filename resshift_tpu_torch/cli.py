"""Command-line interface of the port: `python -m resshift_tpu_torch.cli`.

  infer  restore a folder of images (or one image) with a task's sampler:
         --task realsr (--version v1|v2|v3, or --scale 2 for realsr_x2),
         bicsr, inpaint_imagenet, inpaint_face (with --mask-path) or faceir
  eval   `infer` with the chop and batch of a README reproduce protocol,
         then the PSNR/SSIM(Y) report (and LPIPS with --lpips-path)
  train  train a task from a config whose data.train names the images
         (--save-dir, --resume ckpts/step_XXXXXXXX); SIGTERM checkpoints

The JAX package's `cli infer` / `cli eval` / `cli train`, on one card or
several.  Images are grouped by shape into batches of `--bs`; a reader
thread reads ahead while the main thread launches the sampler, and a writer
thread waits for each batch's result and writes its PNGs.  The noise comes
from one `torch.Generator` on the device, seeded from `--seed`, which each
batch advances in turn.  Everything runs on CUDA unless `--device cpu` is
given.

Several cards.  Under `torchrun --nproc-per-node N` (or with
`--distributed`, which requires the process group to come up) each process
takes its own card, `infer` and `eval` restore every N-th file from the
rank's offset and rank 0 reports the metrics over all of them, and `train`
runs data-parallel (or FSDP with `train.fsdp: true`).  A single process
that owns several cards splits each batch over them
(`ResShiftPipeline.sample_batch_sharded`), or a single image larger than
the chop size by its tiles (`sample_tiles_sharded`).

`--tensor-parallel` (under torchrun) splits the models' weights over the
process group instead (`ResShiftPipeline.sample_tp`, parallel/tp.py):
every rank samples every file, one card's share of each layer a rank, and
rank 0 writes the images; it refuses `--distributed`, which splits the
folder.  `--pipeline-parallel` stages the reverse chain over the process's
cards (`sample_pipelined`, parallel/pp.py), chunks of `--chop-bs` tiles
streaming through.  Each falls through to the next mode where there is
only one process or one card, as in the JAX package.

`--time-parallel SWEEPS` runs an unchopped input's reverse chain as
Picard sweeps (`ResShiftPipeline.sample_time_parallel`), each sweep's batch
split over the process's cards.

Inpainting masks (`--mask-path`, a file or a folder) are read as gray and
mapped to [-1, 1] (white: the region to fill); each image takes the mask
of the same stem, else the first mask.  The output is pasted back,
sr * m + lq * (1 - m) with m = mask * 0.5 + 0.5, so that outside the mask
it keeps the input's pixels; `--mask-back` is on whatever is given, as in
the JAX package.

Checkpoints: `--ckpt` / `--vqgan-ckpt` name local copies of the released
`.pth` files; the port never downloads.  Without `--ckpt` it warns, prints
the release URLs and uses random weights seeded from `--seed`.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .config import CKPT_URLS, default_chop, load_yaml_config, task_config
from .parallel import mesh
from .pipeline import ResShiftPipeline
from .utils.image_io import from_model, imread, imwrite, list_images, to_model
from .utils.io_pipeline import AsyncWriter, prefetch

__all__ = ["EVAL_PROTOCOLS", "make_parser", "main", "report_metrics"]

# the README reproduce protocols: chop size and stride in LQ px, batch size
EVAL_PROTOCOLS = {
    "imagenet": dict(chop_size=64, chop_stride=64, bs=64),
    "realset": dict(chop_size=512, chop_stride=448, bs=1),
}


def _task_name(args) -> str:
    """The registry name: realsr takes its --version, or realsr_x2 at --scale 2."""
    if args.task != "realsr":
        return args.task
    return "realsr_x2" if args.scale == 2 else f"realsr_{args.version}"


def _config(args) -> dict:
    return load_yaml_config(args.config) if args.config else task_config(_task_name(args))


def _pipeline(args, cfg: dict) -> ResShiftPipeline:
    pipe = ResShiftPipeline(cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32,
                            device=mesh.process_device(args.device))
    if args.ckpt:
        pipe.load_torch_checkpoints(args.ckpt, args.vqgan_ckpt)
    else:
        unet_url, vq_url = CKPT_URLS.get(_task_name(args), ("?", "?"))
        print("WARNING: no --ckpt given; using RANDOM weights (demo/benchmark only).\n"
              f"Download the released checkpoints by hand:\n  unet:  {unet_url}\n"
              f"  vqgan: {vq_url}", file=sys.stderr)
        pipe.init_params(args.seed)
    return pipe


def _devices(pipe: ResShiftPipeline) -> list[torch.device]:
    """The devices a sampler may spread one call over: this process's cards,
    or the pipeline's one device off CUDA."""
    return mesh.local_devices() if pipe.device.type == "cuda" else [pipe.device]


def _infer(pipe: ResShiftPipeline, args) -> tuple[list[Path], float]:
    """Restore this process's share of the images under --in-path (every
    world-th file from its rank) into --out-path as PNG; returns all the
    input files and the wall time."""
    in_path, out_path = Path(args.in_path), Path(args.out_path)
    out_path.mkdir(parents=True, exist_ok=True)
    all_files = list_images(in_path) if in_path.is_dir() else [in_path]
    # tensor parallelism: every rank samples every image, rank 0 writes them
    tensor_parallel = getattr(args, "tensor_parallel", False) and mesh.world_size() > 1
    writes = not tensor_parallel or mesh.rank() == 0
    files = all_files if tensor_parallel else all_files[mesh.rank()::mesh.world_size()]
    devices = _devices(pipe)
    print(f"Found {len(all_files)} image(s) in {in_path}; process {mesh.rank()} of "
          f"{mesh.world_size()} restores {len(files)}, sampling on "
          f"{', '.join(map(str, devices))}", flush=True)
    generator = torch.Generator(device=pipe.device).manual_seed(args.seed)
    bs = max(1, args.bs)
    masks = None
    if args.mask_path:
        mp = Path(args.mask_path)
        masks = {f.stem: f for f in (list_images(mp) if mp.is_dir() else [mp])}
        if not masks:
            raise FileNotFoundError(f"no mask image under {mp}")

    def batches():
        pend: dict[tuple, list] = {}
        for f in files:
            im = imread(f)
            pend.setdefault(im.shape, []).append((f, im))
            if len(pend[im.shape]) == bs:
                yield pend.pop(im.shape)
        yield from pend.values()

    state = {"px": 0, "done": 0}
    lock = threading.Lock()
    t_start = time.perf_counter()
    with AsyncWriter(depth=2) as writer:
        for group in prefetch(batches(), depth=2):
            lq = torch.from_numpy(np.concatenate([to_model(im) for _, im in group], axis=0))
            mask = None
            if masks is not None:
                mask = np.concatenate([to_model(imread(masks.get(f.stem) or
                                                       next(iter(masks.values())), chn="gray"))
                                       for f, _ in group], axis=0)
            mask_t = None if mask is None else torch.from_numpy(mask)
            chopped = max(lq.shape[1:3]) > pipe.chop_size
            if tensor_parallel:  # each layer's weights over the process group
                sr = pipe.sample_tp(lq, generator, mask_t, noise_repeat=args.noise_repeat)
            elif getattr(args, "pipeline_parallel", False) and len(devices) > 1:
                # the chain's steps staged over the cards, chunks streaming through
                sr = pipe.sample_pipelined(lq, generator, devices, mask_t,
                                           noise_repeat=args.noise_repeat, chunk_bs=args.chop_bs)
            elif getattr(args, "time_parallel", 0) and not chopped:
                # the Picard chain: the UNet runs SWEEPS times on a (T*B) batch
                sr = pipe.sample_time_parallel(lq, generator, mask_t, sweeps=args.time_parallel,
                                               devices=devices)
            elif len(devices) > 1 and lq.shape[0] > 1:
                sr = pipe.sample_batch_sharded(lq, generator, devices, mask_t,
                                               noise_repeat=args.noise_repeat,
                                               tile_bs=args.chop_bs)
            elif len(devices) > 1 and chopped:  # one big image: its tiles over the cards
                sr = pipe.sample_tiles_sharded(lq, generator, devices, mask_t)
            else:
                sr = pipe.sample(lq, generator, mask_t, noise_repeat=args.noise_repeat,
                                 tile_bs=args.chop_bs)

            def write_one(arr, j, f, im, mask):
                sr01 = from_model(arr[j:j + 1])[0]
                if mask is not None and args.mask_back:
                    m01 = mask[j] * 0.5 + 0.5
                    sr01 = sr01 * m01 + im[..., :3] * (1 - m01)
                imwrite(sr01, out_path / f"{f.stem}.png")

            def write_job(pool, group=group, sr=sr, mask=mask):
                arr = sr.cpu().numpy()  # waits for the device to finish this batch
                list(pool.map(lambda jf: write_one(arr, jf[0], *jf[1], mask),
                              enumerate(group)))
                with lock:
                    state["px"] += arr.shape[0] * arr.shape[1] * arr.shape[2]
                    state["done"] += len(group)
                    done = state["done"]
                print(f"[{done}/{len(files)}] batch of {len(group)}: {arr.shape[2]}x{arr.shape[1]} "
                      f"({time.perf_counter() - t_start:.2f}s elapsed)", flush=True)

            if writes:
                writer.submit(write_job)
    seconds = time.perf_counter() - t_start
    print(f"Done: {state['px'] / max(seconds, 1e-9) / 1e6:.3f} Mpx/s wall (compute + "
          f"pipelined I/O) -> {out_path}", flush=True)
    if mesh.world_size() > 1:  # every rank's outputs are written before rank 0 reports
        torch.distributed.barrier()
    return all_files, seconds


def report_metrics(files, sr_dir: Path, gt_dir: Path, extra: dict | None = None,
                   lpips_path: str | None = None, device: str = "cpu"):
    """PSNR(Y) / SSIM(Y) of the saved outputs against the same-named files
    under `gt_dir`, and LPIPS (f32, on `device`) where `lpips_path` names
    its weights (a `.pth` of the lpips package's, or the port's own file);
    also writes `sr_dir/metrics.json` (with `extra` merged in).  Returns
    (psnr, ssim, lpips or None), or None when no output has a GT."""
    from .models.lpips import load_lpips
    from .ops.metrics import batch_psnr, batch_ssim

    lpips = None if not lpips_path else load_lpips(lpips_path, device=device)
    gts = {f.stem: f for f in list_images(gt_dir)}
    psnr = ssim = lpips_sum = 0.0
    n = 0
    for f in files:
        out = sr_dir / f"{f.stem}.png"
        if f.stem not in gts or not out.exists():
            continue
        sr, gt = imread(out)[None], imread(gts[f.stem])[None]
        psnr += batch_psnr(sr, gt, ycbcr=True)
        ssim += batch_ssim(sr, gt, ycbcr=True)
        if lpips is not None:
            with torch.no_grad():
                as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a * 2 - 1,
                                                                       np.float32)).to(device)
                lpips_sum += float(lpips(as_t(sr), as_t(gt))[0])
        n += 1
    if not n:
        return None
    msg = f"PSNR(Y): {psnr / n:.2f} dB  SSIM(Y): {ssim / n:.4f}"
    record = {"n": n, "psnr_y": float(psnr / n), "ssim_y": float(ssim / n)}
    if lpips is not None:
        msg += f"  LPIPS: {lpips_sum / n:.4f}"
        record["lpips"] = lpips_sum / n
    print(msg + f"  ({n} images)", flush=True)
    record.update(extra or {})
    (sr_dir / "metrics.json").write_text(json.dumps(record, indent=2))
    return psnr / n, ssim / n, (lpips_sum / n if lpips is not None else None)


def cmd_infer(args) -> None:
    cfg = _config(args)
    if args.chop_size:
        cs, st = default_chop(args.chop_size, cfg["sf"])
        cfg["inference"]["chop_size"] = cs
        cfg["inference"]["chop_stride"] = (args.chop_stride * (4 // cfg["sf"])
                                           if args.chop_stride else st)
    files, _ = _infer(_pipeline(args, cfg), args)
    if args.gt_path and mesh.rank() == 0:
        report_metrics(files, Path(args.out_path), Path(args.gt_path),
                       lpips_path=args.lpips_path, device=args.device)


def cmd_eval(args) -> None:
    """`infer` with a protocol's chop, stride and batch (no rescale), then
    the metric report."""
    proto = EVAL_PROTOCOLS[args.protocol]
    cfg = _config(args)
    cfg["inference"]["chop_size"] = proto["chop_size"]
    cfg["inference"]["chop_stride"] = proto["chop_stride"]
    args.bs, args.noise_repeat = proto["bs"], False
    args.mask_path, args.mask_back = None, False
    files, seconds = _infer(_pipeline(args, cfg), args)
    print(f"Protocol {args.protocol}: {len(files)} images in {seconds:.1f}s", flush=True)
    if args.gt_path and mesh.rank() == 0:
        report_metrics(files, Path(args.out_path), Path(args.gt_path),
                       extra={"protocol": args.protocol, "seconds": round(seconds, 1)},
                       lpips_path=args.lpips_path, device=args.device)


def cmd_train(args) -> None:
    """Train a task (`train_loop.Trainer`); SIGTERM / SIGINT checkpoint and
    stop at the next iteration boundary."""
    from .train_loop import Trainer

    cfg = _config(args)
    if not (cfg.get("data") or {}).get("train"):
        raise SystemExit("the config has no data.train section: give --config with dataset "
                         "paths")
    Trainer(cfg, save_dir=args.save_dir, resume=args.resume,
            dtype=torch.bfloat16 if args.bf16 else torch.float32, seed=args.seed,
            device=mesh.process_device(args.device)).train(handle_signals=True)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="resshift_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--task", default="realsr",
                        choices=["realsr", "bicsr", "inpaint_imagenet", "inpaint_face", "faceir"])
        sp.add_argument("--version", default="v3", choices=["v1", "v2", "v3"])
        sp.add_argument("--scale", type=int, default=4,
                        help="realsr only: 2 selects realsr_x2 (and ignores --version)")
        sp.add_argument("--config", default=None, help="custom YAML config")
        sp.add_argument("--ckpt", default=None, help="released denoiser .pth")
        sp.add_argument("--vqgan-ckpt", default=None, help="released VQGAN .pth")
        sp.add_argument("--seed", type=int, default=12345)
        sp.add_argument("--bf16", action="store_true", default=True)
        sp.add_argument("--fp32", dest="bf16", action="store_false")
        sp.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain versions of the kernels")
        sp.add_argument("--in-path", required=True)
        sp.add_argument("--out-path", required=True)
        sp.add_argument("--gt-path", default=None, help="GT folder for the PSNR/SSIM report")
        sp.add_argument("--lpips-path", default=None,
                        help="LPIPS weights (.pth) for the metric report: adds LPIPS")
        sp.add_argument("--chop-bs", type=int, default=1, help="tiles per sampler call")
        distributed(sp)

    def distributed(sp):
        sp.add_argument("--distributed", action="store_true",
                        help="require the process group (torchrun's environment; brought up "
                             "without this flag too wherever that names one)")

    pi = sub.add_parser("infer", help="restore a folder or a single image")
    common(pi)
    pi.add_argument("--chop-size", type=int, default=None, choices=[512, 256, 64])
    pi.add_argument("--chop-stride", type=int, default=None)
    pi.add_argument("--bs", type=int, default=1)
    pi.add_argument("--noise-repeat", action="store_true")
    pi.add_argument("--time-parallel", type=int, default=0, metavar="SWEEPS",
                    help="run the reverse chain as SWEEPS Picard sweeps over all steps at "
                         "once (inputs that are not chopped; SWEEPS = steps gives the "
                         "sequential result)")
    pi.add_argument("--tensor-parallel", action="store_true",
                    help="split the models' weights over the process group (torchrun; "
                         "parallel/tp.py; exact: the batch-1 latency mode)")
    pi.add_argument("--pipeline-parallel", action="store_true",
                    help="stage the reverse chain over this process's cards (parallel/pp.py; "
                         "exact: each card runs its slice of the steps, chunks of --chop-bs "
                         "tiles flow from card to card)")
    pi.add_argument("--mask-path", default=None, help="inpainting mask (file or folder)")
    pi.add_argument("--mask-back", action="store_true", default=True,
                    help="paste the input back outside the mask (always on, as in the "
                         "JAX package)")
    pi.set_defaults(fn=cmd_infer)

    pe = sub.add_parser("eval", help="README reproduce protocols "
                        "(imagenet: chop 64 / stride 64 / bs 64; realset: chop 512 / 448 / 1)")
    common(pe)
    pe.add_argument("--protocol", required=True, choices=sorted(EVAL_PROTOCOLS))
    pe.set_defaults(fn=cmd_eval)

    pt = sub.add_parser("train", help="train a task from a config with data paths")
    pt.add_argument("--config", default=None, help="YAML (or JSON) config with data.train")
    pt.add_argument("--task", default="realsr",
                    choices=["realsr", "bicsr", "inpaint_imagenet", "inpaint_face", "faceir"])
    pt.add_argument("--version", default="v3", choices=["v1", "v2", "v3"])
    pt.add_argument("--scale", type=int, default=4)
    pt.add_argument("--save-dir", default="./save_dir")
    pt.add_argument("--resume", default=None, help="a ckpts/step_XXXXXXXX directory")
    pt.add_argument("--seed", type=int, default=12345)
    pt.add_argument("--bf16", action="store_true", default=True)
    pt.add_argument("--fp32", dest="bf16", action="store_false")
    pt.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions of the kernels")
    distributed(pt)
    pt.set_defaults(fn=cmd_train)
    return p


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)
    if args.distributed and getattr(args, "tensor_parallel", False):
        raise SystemExit("--tensor-parallel splits each image's work over the process group and "
                         "--distributed splits the folder over it: give one of them")
    # before any tensor reaches a card: the group binds this process to its own
    mesh.maybe_init_distributed(force=args.distributed, device=args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
