"""Host loader throughput: items of one dataset type, one after another and
on the loader's worker threads.

Writes `--n` seeded synthetic PNGs of `--size` px (smooth fields with
noise, the port's own codec), builds the dataset as the shipped configs do
(`gfpgan`: configs/faceir_gfpgan512_lpips.yaml's degradation; `bsrgan`,
`bsrganimagenet`: GT crops of `--gt-size`, the light and the full chain),
loads one item to warm up, then times the `--n` items serially and as one
batch of a `DataLoader` with `--threads` workers.  Prints one JSON line:
ms per item each way, the speedup, and the host's CPU count.  Runs on the
host only; no card is needed.

    python -m resshift_tpu_torch.tools.profile_loader [--type gfpgan] [--n 32] [--threads 8]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np

from ..data.datasets import DataLoader, create_dataset
from ..ops.resize import resize_np
from ..utils.image_io import imwrite

__all__ = ["main"]


def _params(kind: str, root: str, gt_size: int) -> dict:
    if kind == "gfpgan":
        return dict(dir_path=root, out_size=512, blur_kernel_size=41, kernel_list=["iso", "aniso"],
                    kernel_prob=[0.5, 0.5], blur_sigma=[0.1, 10], downsample_range=[0.8, 8],
                    noise_range=[0, 20], jpeg_range=[60, 100], use_hflip=True,
                    color_jitter_prob=None, gray_prob=0.01)
    return dict(dir_path=root, sf=4, gt_size=gt_size,
                degradation="bsrgan" if kind == "bsrganimagenet" else "bsrgan_light")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="resshift_tpu_torch.tools.profile_loader")
    p.add_argument("--type", default="gfpgan", choices=["gfpgan", "bsrgan", "bsrganimagenet"])
    p.add_argument("--n", type=int, default=32, help="items timed each way")
    p.add_argument("--size", type=int, default=512, help="side of the synthetic PNGs")
    p.add_argument("--gt-size", type=int, default=256, help="the BSRGAN types' GT crop")
    p.add_argument("--threads", type=int, default=8, help="the DataLoader's workers")
    args = p.parse_args(argv)
    rng = np.random.default_rng(0)
    side = args.size
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.n):
            field = resize_np(rng.uniform(0, 1, (max(side // 8, 2),) * 2 + (3,)), (side, side),
                              "bilinear")
            imwrite(np.clip(field + rng.normal(0, 0.03, field.shape), 0, 1),
                    Path(tmp) / f"{i:04d}.png")
        ds = create_dataset(dict(type=args.type, params=_params(args.type, tmp, args.gt_size)))
        ds[0]
        t0 = time.perf_counter()
        for i in range(args.n):
            ds[i]
        serial = (time.perf_counter() - t0) * 1e3 / args.n
        loader = DataLoader(ds, batch_size=args.n, shuffle=False, prefetch=0,
                            num_workers=args.threads)
        try:
            loader._ensure_workers()
            t0 = time.perf_counter()
            next(iter(loader))
            threaded = (time.perf_counter() - t0) * 1e3 / args.n
        finally:
            loader.close()
    out = {"type": args.type, "items": args.n, "size": side, "serial_ms_per_item": serial,
           "threads": args.threads, "threaded_ms_per_item": threaded,
           "speedup": serial / threaded, "cpu_count": os.cpu_count()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
