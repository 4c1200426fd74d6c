"""Host-side datasets and the loader (the port's own copy of the JAX
package's `data/datasets.py`).

  * `BaseData` (realsr's `val` type): images from a folder or a txt
    listing, with the paired GT from `extra_dir_path`, or from a packed
    file (`pack_path`, its keys sorted; the GT under the same key in
    `extra_pack_path`);
  * `RealESRGANData`: HQ crops (from files or a packed file) and each
    sample's three blur kernels, drawn
    from the dataset's `np.random.Generator` in the JAX package's order,
    so that the same seed and files give the same items bit for bit;
  * `BicubicData` (bicsr): GT crops and their MATLAB-bicubic LQ, flipped
    one of 8 ways; `InpaintingData`: LaMa distortions of the image and a
    LaMa mask (`masks.py`, `distortions.py`); `InpaintingValData`: lq /
    gt / mask triplets from folders;
  * `GFPGANData` (faceir's `gfpgan`): a face, flipped at random, and its
    GFPGAN-style degradation (`faces.py`); `BSRGANData` (`bsrgan`,
    `bsrganimagenet`): GT crops and the BSRGAN light or full chain
    (`bsrgan.py`); `SIDDValData` (`siddval`): noisy / clean pairs;
    `DegradedDataFromSource` (`deg_from_source`): images through a
    caller's degrade function;
  * `create_dataset` (the `type` factory) and `DataLoader` (epoch
    shuffling from (seed, epoch), `skip_batches` to resume, `num_workers`
    threads each with a reseeded deep copy of the dataset).
Images are NHWC float32, normalised to [-1, 1] (mean = std = 0.5) except
`RealESRGANData`'s GT, which the degrader takes in [0, 1].  With
`io_backend: {type: memcached, server: host:port}` `BaseData` and
`RealESRGANData` read their files through a memcached daemon
(`file_client.py`).
"""

from __future__ import annotations

import concurrent.futures
import copy
import math
import queue as _queue
import threading
import weakref
from pathlib import Path

import numpy as np

from ..ops.resize import imresize_matlab, resize_np
from ..utils.image_io import imread, list_images
from . import degradations as deg
from .faces import ffhq_degrade
from .file_client import FileClient
from .masks import MixedMaskGenerator

__all__ = ["create_dataset", "DataLoader", "BaseData", "RealESRGANData", "BicubicData",
           "InpaintingData", "InpaintingValData", "GFPGANData", "BSRGANData", "SIDDValData",
           "DegradedDataFromSource"]


def _collect_paths(dir_path=None, dir_paths=None, txt_path=None, txt_file_path=None,
                   recursive=True, length=None,
                   rng: np.random.Generator | None = None) -> list[str]:
    paths: list[str] = []
    dirs = list(dir_paths or [])
    if dir_path:
        dirs.append(dir_path)
    for d in dirs:
        paths.extend(str(p) for p in list_images(d, recursive=recursive))
    txts = list(txt_file_path if isinstance(txt_file_path, (list, tuple))
                else [txt_file_path] if txt_file_path else [])
    if txt_path:
        txts.append(txt_path)
    for t in txts:
        with open(t) as f:
            paths.extend(ln.strip() for ln in f if ln.strip())
    if length is not None and len(paths) > length:
        rng = rng or np.random.default_rng()
        paths = list(rng.choice(paths, size=length, replace=False))
    return paths


def _normalize(im: np.ndarray, mean=0.5, std=0.5) -> np.ndarray:
    return (im.astype(np.float32) - mean) / std


def _augment(rng, im, hflip=True, rot=True):
    """hflip / vflip / transpose, each with probability 1/2."""
    do_h = hflip and rng.uniform() < 0.5
    do_v = rot and rng.uniform() < 0.5
    do_r = rot and rng.uniform() < 0.5
    if do_h:
        im = im[:, ::-1]
    if do_v:
        im = im[::-1]
    if do_r:
        im = im.transpose(1, 0, 2)
    return np.ascontiguousarray(im)


def _memcached_client(io_backend) -> FileClient | None:
    """The memcached-fronted client that `io_backend` asks for, else None."""
    if (io_backend or {}).get("type") != "memcached":
        return None
    return FileClient("memcached", server=io_backend.get("server", "127.0.0.1:11211"))


class BaseData:
    """Images from a folder or txt listing; `extra_dir_path` gives the GT
    of the same file name.  With `pack_path`, the items are that packed
    file's keys (a seeded draw of `length` of them) and `extra_pack_path`
    holds the GT under the same keys."""

    def __init__(self, dir_path=None, txt_path=None, mean=0.5, std=0.5, extra_dir_path=None,
                 length=None, need_path=False, im_exts=None, recursive=False, seed=0,
                 pack_path=None, extra_pack_path=None, io_backend=None, **_):
        if pack_path:
            self.client = FileClient("pack", pack_path)
            self.paths = sorted(self.client.keys())
            if length is not None:
                rng = np.random.default_rng(seed)
                self.paths = [self.paths[i] for i in rng.permutation(len(self.paths))[:length]]
            self.extra_client = FileClient("pack", extra_pack_path) if extra_pack_path else None
        else:
            self.client, self.extra_client = _memcached_client(io_backend), None
            self.paths = _collect_paths(dir_path=dir_path, txt_path=txt_path,
                                        recursive=recursive, length=length,
                                        rng=np.random.default_rng(seed))
        self.mean, self.std = mean, std
        self.extra_dir_path = extra_dir_path
        self.need_path = need_path

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        p = self.paths[i]
        im = _normalize(imread(p) if self.client is None else self.client.imread(p), self.mean,
                        self.std)
        out = {"lq": im, "image": im}
        if self.extra_client is not None:
            out["gt"] = _normalize(self.extra_client.imread(p), self.mean, self.std)
        elif self.extra_dir_path is not None:
            out["gt"] = _normalize(imread(Path(self.extra_dir_path) / Path(p).name),
                                   self.mean, self.std)
        if self.need_path:
            out["path"] = str(p)
        return out


class RealESRGANData:
    """HQ crops (GT in [0, 1]) and per-sample kernels for the degrader."""

    def __init__(self, dir_paths=(), txt_file_path=(), im_exts=("JPEG",), blur_kernel_size=21,
                 kernel_list=None, kernel_prob=None, sinc_prob=0.1, blur_sigma=(0.2, 3.0),
                 betag_range=(0.5, 4.0), betap_range=(1, 2.0), blur_kernel_size2=15,
                 kernel_list2=None, kernel_prob2=None, sinc_prob2=0.1, blur_sigma2=(0.2, 1.5),
                 betag_range2=(0.5, 4.0), betap_range2=(1, 2.0), final_sinc_prob=0.8,
                 gt_size=256, crop_pad_size=300, use_hflip=True, use_rot=False,
                 rescale_gt=True, length=None, mode="training", seed=0, pack_path=None,
                 io_backend=None, **_):
        self.rng = np.random.default_rng(seed)
        if pack_path:
            self.client = FileClient("pack", pack_path)
            self.paths = sorted(self.client.keys())
            if length is not None:
                self.paths = [self.paths[i]
                              for i in self.rng.permutation(len(self.paths))[:length]]
        else:
            self.client = _memcached_client(io_backend)
            self.paths = _collect_paths(dir_paths=dir_paths, txt_file_path=txt_file_path,
                                        length=length, rng=self.rng)
        d = ["iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso",
             "plateau_aniso"]
        dp = [0.45, 0.25, 0.12, 0.03, 0.12, 0.03]
        self.k1 = dict(size=blur_kernel_size, lists=kernel_list or d, probs=kernel_prob or dp,
                       sinc=sinc_prob, sigma=blur_sigma, betag=betag_range, betap=betap_range)
        self.k2 = dict(size=blur_kernel_size2, lists=kernel_list2 or d,
                       probs=kernel_prob2 or dp, sinc=sinc_prob2, sigma=blur_sigma2,
                       betag=betag_range2, betap=betap_range2)
        self.final_sinc_prob = final_sinc_prob
        self.gt_size = gt_size
        self.crop_pad_size = crop_pad_size
        self.use_hflip, self.use_rot = use_hflip, use_rot
        self.rescale_gt = rescale_gt
        self.mode = mode

    def __len__(self):
        return len(self.paths)

    def _load_gt(self, i):
        """The file, or (after a failed read) another drawn at random; three tries."""
        read = imread if self.client is None else self.client.imread
        for _ in range(3):
            try:
                return read(self.paths[i])
            except (OSError, ValueError, KeyError):
                i = int(self.rng.integers(len(self.paths)))
        return read(self.paths[i])

    def _draw_kernel(self, spec) -> np.ndarray:
        rng = self.rng
        ks = int(rng.choice(np.arange(3, spec["size"], 2)))
        if rng.uniform() < spec["sinc"]:
            omega = rng.uniform(np.pi / 3 if ks < 13 else np.pi / 5, np.pi)
            k = deg.circular_lowpass_kernel(omega, ks)
        else:
            k = deg.random_mixed_kernels(rng, spec["lists"], spec["probs"], ks, spec["sigma"],
                                         spec["sigma"], (-math.pi, math.pi), spec["betag"],
                                         spec["betap"])
        p = (spec["size"] - ks) // 2
        return np.pad(k, ((p, p), (p, p))).astype(np.float32)

    def __getitem__(self, i):
        rng = self.rng
        img = self._load_gt(i)
        if self.mode == "testing":
            h, w = img.shape[:2]
            s = self.gt_size / min(h, w)
            img = resize_np(img, (max(self.gt_size, round(h * s)),
                                  max(self.gt_size, round(w * s))), "bicubic_matlab")
            top = (img.shape[0] - self.gt_size) // 2
            left = (img.shape[1] - self.gt_size) // 2
            img = img[top:top + self.gt_size, left:left + self.gt_size]
        else:
            img = _augment(rng, img, self.use_hflip, self.use_rot)
            h, w = img.shape[:2]
            cps = max(min(h, w), self.gt_size) if self.rescale_gt else self.crop_pad_size
            while h < cps or w < cps:  # reflect-pad until the crop fits
                ph, pw = min(max(0, cps - h), h), min(max(0, cps - w), w)
                img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="reflect")
                h, w = img.shape[:2]
            if h > cps or w > cps:
                top = int(rng.integers(0, h - cps + 1))
                left = int(rng.integers(0, w - cps + 1))
                img = img[top:top + cps, left:left + cps]
            if self.rescale_gt and cps != self.gt_size:
                img = resize_np(img, (self.gt_size, self.gt_size), "area")
        k1 = self._draw_kernel(self.k1)
        k2 = self._draw_kernel(self.k2)
        if rng.uniform() < self.final_sinc_prob:
            ks = int(rng.choice(np.arange(3, self.k2["size"], 2)))
            omega = rng.uniform(np.pi / 3, np.pi)
            sinc = deg.circular_lowpass_kernel(omega, ks, pad_to=self.k2["size"])
            sinc = sinc.astype(np.float32)
        else:
            sinc = deg.pulse_kernel(self.k2["size"])
        return {"gt": img.astype(np.float32), "kernel1": k1, "kernel2": k2, "sinc_kernel": sinc}


class BicubicData:
    """GT crops and their MATLAB-bicubic LQ (x `scale`), in the 8-way
    dihedral augmentation; draws: the crop, then the flip."""

    def __init__(self, source_path=None, source_txt_path=None, degrade_kwargs=None,
                 mean=0.5, std=0.5, length=None, need_path=False, im_exts="png",
                 recursive=False, seed=0, **_):
        self.rng = np.random.default_rng(seed)
        self.paths = _collect_paths(dir_path=source_path, txt_file_path=source_txt_path,
                                    recursive=recursive, length=length, rng=self.rng)
        dk = degrade_kwargs or {}
        self.scale = dk.get("scale", 0.25)
        self.gt_size = dk.get("pch_size", dk.get("gt_size", 256))
        self.resize_back = dk.get("resize_back", False)
        self.pass_crop = dk.get("pass_crop", False)
        self.pass_aug = dk.get("pass_aug", False)
        self.pass_smallmax = dk.get("pass_smallmaxresize", False)
        self.mean, self.std = mean, std
        self.need_path = need_path

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        rng = self.rng
        gt = imread(self.paths[i])
        if not self.pass_smallmax and min(gt.shape[:2]) != self.gt_size:
            h, w = gt.shape[:2]
            s = self.gt_size / min(h, w)
            gt = resize_np(gt, (max(self.gt_size, round(h * s)),
                                max(self.gt_size, round(w * s))), "bicubic_torch")
        if not self.pass_crop:
            h, w = gt.shape[:2]
            top = int(rng.integers(0, max(h - self.gt_size, 0) + 1))
            left = int(rng.integers(0, max(w - self.gt_size, 0) + 1))
            gt = gt[top:top + self.gt_size, left:left + self.gt_size]
        lq = imresize_matlab(gt, self.scale)
        if self.resize_back:
            lq = imresize_matlab(lq, 1.0 / self.scale)
        if not self.pass_aug:
            flag = int(rng.integers(8))
            gt, lq = (_flip8(gt, flag), _flip8(lq, flag))
        out = {"gt": _normalize(gt, self.mean, self.std),
               "lq": _normalize(np.clip(lq, 0, 1), self.mean, self.std)}
        if self.need_path:
            out["path"] = str(self.paths[i])
        return out


def _flip8(im: np.ndarray, flag: int) -> np.ndarray:
    """8-way dihedral augmentation: rot90 by flag % 4, then a vertical flip
    for flag >= 4."""
    if flag % 4 == 1:
        im = np.rot90(im)
    elif flag % 4 == 2:
        im = np.rot90(im, 2)
    elif flag % 4 == 3:
        im = np.rot90(im, 3)
    if flag >= 4:
        im = np.flipud(im)
    return np.ascontiguousarray(im)


class InpaintingData:
    """GT (LaMa distortions, or a random crop and flip) and a generated LaMa
    mask: lq = gt * (1 - mask) - mask * (mean / std), the mask normalised
    to [-1, 1].  The image, its distortion and the mask draw from one
    generator."""

    def __init__(self, dir_path=None, txt_file_path=None, mask_kwargs=None,
                 pch_size=256, mean=0.5, std=0.5, length=None, need_path=False,
                 im_exts="png", recursive=False, seed=0,
                 transform_type="lama_distortions", **_):
        self.rng = np.random.default_rng(seed)
        self.paths = _collect_paths(dir_path=dir_path, txt_file_path=txt_file_path,
                                    recursive=recursive, length=length, rng=self.rng)
        self.mask_gen = MixedMaskGenerator(rng=self.rng, **(mask_kwargs or {}))
        self.pch_size = pch_size
        self.mean, self.std = mean, std
        self.need_path = need_path
        self.iter_i = 0
        if transform_type == "lama_distortions":
            from .distortions import LamaDistortions

            self.distort = LamaDistortions(pch_size=pch_size)
        else:  # a random crop and horizontal flip
            self.distort = None

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        rng = self.rng
        im = imread(self.paths[i])
        if self.distort is not None:
            im = self.distort(im, rng)
        else:
            h, w = im.shape[:2]
            if min(h, w) < self.pch_size:
                s = self.pch_size / min(h, w)
                im = resize_np(im, (max(self.pch_size, round(h * s)),
                                    max(self.pch_size, round(w * s))), "bicubic_torch")
                h, w = im.shape[:2]
            top = int(rng.integers(0, h - self.pch_size + 1))
            left = int(rng.integers(0, w - self.pch_size + 1))
            im = im[top:top + self.pch_size, left:left + self.pch_size]
            if rng.uniform() < 0.5:
                im = np.ascontiguousarray(im[:, ::-1])
        gt = _normalize(im, self.mean, self.std)
        mask = self.mask_gen((self.pch_size, self.pch_size), iter_i=self.iter_i)
        self.iter_i += 1
        lq = gt * (1 - mask) - mask * (self.mean / self.std)
        out = {"gt": gt.astype(np.float32), "lq": lq.astype(np.float32),
               "mask": _normalize(mask, self.mean, self.std).astype(np.float32)}
        if self.need_path:
            out["path"] = str(self.paths[i])
        return out


class InpaintingValData:
    """lq / gt / mask triplets from folders, matched by file name; the mask
    read as gray."""

    def __init__(self, lq_path, gt_path=None, mask_path=None, mean=0.5, std=0.5,
                 length=None, need_path=False, im_exts="png", recursive=False,
                 seed=0, **_):
        self.paths = _collect_paths(dir_path=lq_path, recursive=recursive,
                                    length=length, rng=np.random.default_rng(seed))
        self.gt_path, self.mask_path = gt_path, mask_path
        self.mean, self.std = mean, std
        self.need_path = need_path

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        p = Path(self.paths[i])
        out = {"lq": _normalize(imread(p), self.mean, self.std)}
        if self.gt_path is not None:
            out["gt"] = _normalize(imread(Path(self.gt_path) / p.name), self.mean, self.std)
        mask = imread(Path(self.mask_path) / p.name, chn="gray")[..., None]
        out["mask"] = _normalize(mask, self.mean, self.std)
        if self.need_path:
            out["path"] = str(p)
        return out


class GFPGANData:
    """Faces and their GFPGAN-style degradation (`faces.ffhq_degrade`): the
    face flipped with probability 1/2 (when `use_hflip`), then blurred,
    downsampled, noised, JPEG-compressed and resized back; gt and lq
    normalised by `mean` / `std`.  One generator draws the paths' subset,
    the flips and the degradations."""

    def __init__(self, dir_path, im_exts="png", use_hflip=True, mean=(0.5,) * 3,
                 std=(0.5,) * 3, out_size=512, length=None, seed=0,
                 need_gt_path=False, **kwargs):
        self.rng = np.random.default_rng(seed)
        self.paths = _collect_paths(dir_path=dir_path, recursive=True,
                                    length=length, rng=self.rng)
        self.use_hflip = use_hflip
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.out_size = out_size
        keys = ("blur_kernel_size", "kernel_list", "kernel_prob", "blur_sigma",
                "downsample_range", "noise_range", "jpeg_range",
                "color_jitter_prob", "gray_prob", "gt_gray")
        self.deg_kwargs = {k: kwargs[k] for k in keys if k in kwargs}
        self.need_path = need_gt_path

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        rng = self.rng
        gt = imread(self.paths[i])
        if rng.uniform() < 0.5 and self.use_hflip:
            gt = np.ascontiguousarray(gt[:, ::-1])
        gt, lq = ffhq_degrade(rng, gt, **self.deg_kwargs)
        out = {"gt": (gt - self.mean) / self.std, "lq": (lq - self.mean) / self.std}
        if self.need_path:
            out["path"] = str(self.paths[i])
        return out


class BSRGANData:
    """BSRGAN pairs: a GT crop of `gt_size` (the image first upscaled by
    torch's bicubic where its short side is smaller), then the light
    ('bsrgan_light', the default) or full ('bsrgan') chain.  The full
    chain's `lq_patchsize` defaults to gt_size // sf, so the pair keeps
    `gt_size`."""

    def __init__(self, dir_path=None, txt_file_path=None, sf=4, gt_size=256,
                 use_sharp=False, mean=0.5, std=0.5, length=None, need_path=False,
                 im_exts="png", recursive=False, seed=0,
                 degradation="bsrgan_light", lq_patchsize=None, **_):
        if degradation not in ("bsrgan", "bsrgan_light"):
            raise ValueError(
                f"Except bsrgan or bsrgan_light for degradation, now is {degradation}")
        self.rng = np.random.default_rng(seed)
        self.paths = _collect_paths(dir_path=dir_path, txt_file_path=txt_file_path,
                                    recursive=recursive, length=length, rng=self.rng)
        self.sf, self.gt_size, self.use_sharp = sf, gt_size, use_sharp
        self.mean, self.std = mean, std
        self.need_path = need_path
        self.degradation = degradation
        self.lq_patchsize = lq_patchsize if lq_patchsize is not None else gt_size // sf

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        from .bsrgan import degradation_bsrgan, degradation_bsrgan_light

        rng = self.rng
        im = imread(self.paths[i])
        h, w = im.shape[:2]
        if min(h, w) < self.gt_size:
            s = self.gt_size / min(h, w)
            im = resize_np(im, (max(self.gt_size, round(h * s)),
                                max(self.gt_size, round(w * s))), "bicubic_torch")
            h, w = im.shape[:2]
        top = int(rng.integers(0, h - self.gt_size + 1))
        left = int(rng.integers(0, w - self.gt_size + 1))
        im = np.ascontiguousarray(im[top:top + self.gt_size, left:left + self.gt_size])
        if self.degradation == "bsrgan":
            lq, gt = degradation_bsrgan(rng, im, sf=self.sf, lq_patchsize=self.lq_patchsize,
                                        use_sharp=self.use_sharp)
        else:
            lq, gt = degradation_bsrgan_light(rng, im, sf=self.sf, use_sharp=self.use_sharp)
        out = {"gt": _normalize(gt, self.mean, self.std),
               "lq": _normalize(np.clip(lq, 0, 1), self.mean, self.std)}
        if self.need_path:
            out["path"] = str(self.paths[i])
        return out


class SIDDValData:
    """Paired noisy / clean validation images, matched by sorted order."""

    def __init__(self, noisy_path, gt_path, mean=0.5, std=0.5, **_):
        self.noisy = sorted(list_images(noisy_path))
        self.gt = sorted(list_images(gt_path))
        if len(self.noisy) != len(self.gt):
            raise ValueError(f"{len(self.noisy)} noisy images against {len(self.gt)} clean")
        self.mean, self.std = mean, std

    def __len__(self):
        return len(self.noisy)

    def __getitem__(self, i):
        return {"lq": _normalize(imread(self.noisy[i]), self.mean, self.std),
                "gt": _normalize(imread(self.gt[i]), self.mean, self.std)}


class DegradedDataFromSource:
    """Source images through `degrade_fn(rng, im) -> (lq, gt)` (identity
    pairs without one), drawn from the dataset's generator."""

    def __init__(self, source_path=None, source_txt_path=None, degrade_fn=None,
                 mean=0.5, std=0.5, length=None, need_path=False, im_exts="png",
                 recursive=False, seed=0, **_):
        self.rng = np.random.default_rng(seed)
        self.paths = _collect_paths(dir_path=source_path, txt_file_path=source_txt_path,
                                    recursive=recursive, length=length, rng=self.rng)
        self.degrade_fn = degrade_fn or (lambda rng, im: (im, im))
        self.mean, self.std = mean, std
        self.need_path = need_path

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        im = imread(self.paths[i])
        lq, gt = self.degrade_fn(self.rng, im)
        out = {"gt": _normalize(gt, self.mean, self.std),
               "lq": _normalize(lq, self.mean, self.std)}
        if self.need_path:
            out["path"] = str(self.paths[i])
        return out


_FACTORY = {"base": BaseData, "realesrgan": RealESRGANData, "bicubic": BicubicData,
            "inpainting": InpaintingData, "inpainting_val": InpaintingValData,
            "gfpgan": GFPGANData, "bsrgan": BSRGANData, "bsrganimagenet": BSRGANData,
            "siddval": SIDDValData, "deg_from_source": DegradedDataFromSource}


def create_dataset(config: dict):
    """The dataset of `config['type']` with `config['params']` (the
    reference's `transform_kwargs` mean/std flattened in)."""
    kind = config["type"]
    if kind not in _FACTORY:
        raise ValueError(f"unknown dataset type '{kind}'; have {sorted(_FACTORY)}")
    params = dict(config.get("params", {}))
    tk = params.pop("transform_kwargs", None) or {}
    params.setdefault("mean", tk.get("mean", 0.5))
    params.setdefault("std", tk.get("std", 0.5))
    params.pop("transform_type", None)
    # io_backend: memcached reaches the datasets that read through it; 'disk'
    # (the shipped default) is the plain path
    io = params.pop("io_backend", None) or {}
    if isinstance(io, dict) and io.get("type") == "memcached":
        params["io_backend"] = dict(io)
    return _FACTORY[kind](**params)


class DataLoader:
    """Epoch-shuffled batches with a prefetch thread and sharding by
    (shard_id, num_shards); `num_workers` > 0 loads items on that many
    threads, each with its own deep copy of the dataset whose generator is
    reseeded from (seed, worker), items assigned round robin (so a run is
    reproducible; its draws differ from `num_workers` = 0, as torch's
    DataLoader's do)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, shard_id: int = 0, num_shards: int = 1, prefetch: int = 2,
                 num_workers: int = 0):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard_id, self.num_shards = shard_id, num_shards
        self.prefetch = prefetch
        self.num_workers = num_workers
        self._pool = None
        self._workers = None
        self.epoch = 0

    def __len__(self):
        n = len(self.ds) // self.num_shards
        return n // self.bs if self.drop_last else math.ceil(n / self.bs)

    def _epoch_indices(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(idx)
        return idx[self.shard_id::self.num_shards]

    def _ensure_workers(self):
        if self._pool is not None:
            return
        copies = [copy.deepcopy(self.ds) for _ in range(self.num_workers)]
        for w, ds in enumerate(copies):
            rng = getattr(ds, "rng", None)
            if isinstance(rng, np.random.Generator):  # in place: aliases follow
                rng.bit_generator.state = np.random.default_rng(
                    (self.seed, 7919, w)).bit_generator.state
        self._workers = copies
        self._pool = [concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      for _ in range(self.num_workers)]
        weakref.finalize(self, DataLoader._shutdown_pool, self._pool)

    @staticmethod
    def _shutdown_pool(pool):
        for ex in pool:
            ex.shutdown(wait=False)

    def close(self):
        """Stop the worker threads and drop their dataset copies."""
        if self._pool is not None:
            self._shutdown_pool(self._pool)
            self._pool = self._workers = None

    def _fetch_items(self, chunk):
        if self.num_workers > 0:
            self._ensure_workers()
            futs = [self._pool[j % self.num_workers].submit(
                self._workers[j % self.num_workers].__getitem__, i) for j, i in enumerate(chunk)]
            return [f.result() for f in futs]
        return [self.ds[i] for i in chunk]

    def _batches(self, start_batch: int = 0):
        idx = self._epoch_indices()
        stop = len(idx) - (len(idx) % self.bs) if self.drop_last else len(idx)
        for s in range(start_batch * self.bs, stop, self.bs):
            items = self._fetch_items([int(i) for i in idx[s:s + self.bs]])
            yield {k: (np.stack([it[k] for it in items]) if not isinstance(items[0][k], str)
                       else [it[k] for it in items]) for k in items[0]}

    def _iter_from(self, start_batch: int = 0):
        if self.prefetch <= 0:
            yield from self._batches(start_batch)
            self.epoch += 1
            return
        q: _queue.Queue = _queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for b in self._batches(start_batch):
                    q.put(b)
            except Exception as e:  # handed to the consumer, which re-raises
                q.put(e)
            q.put(stop)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            b = q.get()
            if b is stop:
                break
            if isinstance(b, BaseException):
                raise b
            yield b
        self.epoch += 1

    def __iter__(self):
        yield from self._iter_from(0)

    def infinite(self, skip_batches: int = 0):
        """Endless batches.  `skip_batches` fast-forwards the index stream
        without loading items: the shuffle is a function of (seed, epoch),
        so a resumed run sees the batches an uninterrupted one would (bit
        for bit for datasets without draws of their own, such as paired
        folders)."""
        per_epoch = max(1, len(self))
        self.epoch += skip_batches // per_epoch
        start = skip_batches % per_epoch
        while True:
            yield from self._iter_from(start)
            start = 0
