"""Test-set preparation (the port's own copy of the JAX package's
`scripts.py`).

  * `imagenet-sr`: HQ images centre-cropped to 256 by the RealESRGAN
    dataset's testing mode, then degraded with the milder testing ranges
    (`TESTING_DEGRADATION`) by `RealESRGANDegrader` on the device;
  * `celeba-faceir`: `faces.face_degradation` with parameters drawn
    uniformly per face (sig_x, sig_y in [2, 10], theta in [0, pi], noise
    in [0, 15], JPEG quality in [40, 90]) from one generator, in the JAX
    package's order;
  * `pack`: every image under `--source` (recursively) into one packed file
    (`data/packfile.py`), keyed by its path relative to `--source`, which
    the datasets' `pack_path` / `extra_pack_path` read.

The first two write `gt/` and `lq/` PNGs under `--out`.

Run: python -m resshift_tpu_torch.scripts imagenet-sr --source DIR --out DIR [--device cpu]
     python -m resshift_tpu_torch.scripts celeba-faceir --source DIR --out DIR
     python -m resshift_tpu_torch.scripts pack --source DIR --out FILE
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .data.datasets import RealESRGANData
from .data.faces import face_degradation
from .data.realesrgan import DegradationConfig, RealESRGANDegrader
from .utils.image_io import imread, imwrite, list_images

__all__ = ["TESTING_DEGRADATION", "prepare_testing_imagenet_sr",
           "prepare_testing_celeba_faceir", "pack_folder", "main"]

# configs/degradation_testing_realesrgan.yaml's milder ranges
TESTING_DEGRADATION = DegradationConfig(
    sf=4,
    resize_prob=(0.2, 0.7, 0.1), resize_range=(0.3, 1.2),
    gaussian_noise_prob=0.5, noise_range=(1, 15),
    poisson_scale_range=(0.05, 1.5), gray_noise_prob=0.4, jpeg_range=(60, 95),
    second_order_prob=0.5, second_blur_prob=0.8,
    resize_prob2=(0.3, 0.4, 0.3), resize_range2=(0.6, 1.2),
    gaussian_noise_prob2=0.5, noise_range2=(1, 12),
    poisson_scale_range2=(0.05, 1.0), gray_noise_prob2=0.4, jpeg_range2=(60, 100),
    gt_size=256, resize_back=False, use_sharp=False, queue_size=0,
)


def _out_dirs(out: str) -> tuple[Path, Path]:
    out_lq, out_gt = Path(out) / "lq", Path(out) / "gt"
    out_lq.mkdir(parents=True, exist_ok=True)
    out_gt.mkdir(parents=True, exist_ok=True)
    return out_lq, out_gt


def prepare_testing_imagenet_sr(source: str, out: str, num_images: int | None = None,
                                seed: int = 10000, device: str = "cuda"):
    """Pairs 00000.png, ... of the HQ images under `source`; the noise of
    image i from a generator on `device` seeded with seed + i."""
    import torch

    out_lq, out_gt = _out_dirs(out)
    ds = RealESRGANData(dir_paths=[source], gt_size=256, mode="testing",
                        rescale_gt=False, seed=seed, length=num_images)
    degrader = RealESRGANDegrader(TESTING_DEGRADATION)
    rng = np.random.default_rng(seed)
    for i in range(len(ds)):
        batch = {k: v[None] for k, v in ds[i].items() if not isinstance(v, str)}
        pair = degrader(rng, torch.Generator(device=device).manual_seed(seed + i), batch)
        name = f"{i:05d}.png"
        imwrite(pair["gt"][0] * 0.5 + 0.5, out_gt / name)
        imwrite(pair["lq"][0] * 0.5 + 0.5, out_lq / name)
    print(f"wrote {len(ds)} pairs to {out}")


def prepare_testing_celeba_faceir(source: str, out: str, sf: int = 4,
                                  num_images: int | None = None, seed: int = 10000):
    out_lq, out_gt = _out_dirs(out)
    rng = np.random.default_rng(seed)
    files = list_images(source)
    if num_images:
        files = files[:num_images]
    for f in files:
        im = imread(f)
        lq = face_degradation(
            im, sf=sf,
            sig_x=rng.uniform(2, 10), sig_y=rng.uniform(2, 10),
            theta=rng.uniform(0, np.pi), nf=rng.uniform(0, 15),
            qf=rng.uniform(40, 90), rng=rng,
        )
        imwrite(im, out_gt / f"{f.stem}.png")
        imwrite(lq, out_lq / f"{f.stem}.png")
    print(f"wrote {len(files)} pairs to {out}")


def pack_folder(source: str, out: str, recursive: bool = True) -> int:
    """Every image under `source` into the packed file `out`, keyed by its
    path relative to `source`; returns the count."""
    from .data.packfile import PackWriter

    files = list_images(source, recursive=recursive)
    src = Path(source)
    with PackWriter(out) as w:
        for f in files:
            w.add(str(f.relative_to(src)), f.read_bytes())
    print(f"packed {len(files)} blobs -> {out}")
    return len(files)


def main(argv=None):
    p = argparse.ArgumentParser(prog="resshift_tpu_torch.scripts")
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("imagenet-sr")
    a.add_argument("--source", required=True)
    a.add_argument("--out", required=True)
    a.add_argument("--num-images", type=int, default=None)
    a.add_argument("--seed", type=int, default=10000)
    a.add_argument("--device", default="cuda",
                   help="torch device of the degradation; 'cpu' runs it on the CPU")
    b = sub.add_parser("celeba-faceir")
    b.add_argument("--source", required=True)
    b.add_argument("--out", required=True)
    b.add_argument("--sf", type=int, default=4)
    b.add_argument("--num-images", type=int, default=None)
    b.add_argument("--seed", type=int, default=10000)
    c = sub.add_parser("pack", help="pack an image folder into a PackFile")
    c.add_argument("--source", required=True)
    c.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.cmd == "imagenet-sr":
        prepare_testing_imagenet_sr(args.source, args.out, args.num_images, args.seed,
                                    args.device)
    elif args.cmd == "pack":
        pack_folder(args.source, args.out)
    else:
        prepare_testing_celeba_faceir(args.source, args.out, args.sf, args.num_images,
                                      args.seed)


if __name__ == "__main__":
    main()
