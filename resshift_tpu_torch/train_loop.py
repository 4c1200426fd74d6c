"""The training loop around `trainer.TrainStep`: data, degradation,
logging, validation, checkpoints (the port's counterpart of the JAX
package's `train_loop.py`), on one card or one process per card.

Per iteration: a batch from the host loader -> the RealESRGAN degradation
on the device (realesrgan data) or the batch as it is -> the train step ->
every `log_freq[0]` iterations a JSON line of the metrics (with the
loader's, the degrader's and the step's milliseconds), every `log_freq[1]`
the lq / gt / x_t / x0-prediction grids, every `val_freq` validation (the
EMA weights through `sample` on the val set, PSNR/SSIM(Y) and the
progressive strip of the first image), every `save_freq` an asynchronous
checkpoint, and a blocking one at the end.

Randomness is indexed by the step: each iteration's draws come from
`step_generator(seed, step, rank, stream)` (stream 1: the degradation's
noise; 2: the step's t and noise; 3: the image grids), the rank folded in
as the JAX package folds `process_index`, so that a resumed run draws what
the uninterrupted one would and no two ranks draw the same.  With paired
data (no draws of the dataset's own) a resume continues bit for bit on the
CPU; the degrader's host draws (`np_rng`) and its queue restart, as in the
JAX package.

Several processes (`torchrun --nproc-per-node N -m resshift_tpu_torch.cli
train ...`): the process group comes up before the pipeline, on
`cuda:LOCAL_RANK` (`parallel.mesh`); the loader takes every N-th item of
each epoch's order from the rank's offset (`shard_id=rank`); the step
averages the gradients over the ranks, or shards the state (`train.fsdp`,
`trainer.TrainStep`).  Rank 0 alone writes the JSON log, the image grids,
validation's files and the checkpoints; every rank joins the gathers of an
FSDP state that those need.  Validation runs on every rank, each restoring
every N-th val item from its rank's offset, and the metrics' sums are
all-reduced (so no rank waits in a collective while another validates the
whole set); one process owning several cards splits its batches over them.

Pretrained weights: `model.ckpt_path` warm-starts the denoiser and
`autoencoder.ckpt_path` loads the frozen VQGAN, both `.pth` files (an
orbax directory raises: `checkpoint.load_params`).

The LPIPS trainer (`trainer: difir_lpips`, or `train.use_lpips`) adds the
LPIPS term to the step's loss (`trainer.TrainStep`) and `val_lpips` to
validation.  Its frozen network comes from `train.lpips_path`: a `.pth`
of the `lpips` package's weights, another path the port's own parameter
file, no path random weights (with a WARNING: no LPIPS weights ship with
the repository).  It is frozen, so checkpoints and resume carry nothing
more.
"""

from __future__ import annotations

import contextlib
import json
import signal
import time
from pathlib import Path

import numpy as np
import torch

from .checkpoint import AsyncSaver, restore_train_state
from .data.datasets import DataLoader, create_dataset
from .data.realesrgan import DegradationConfig, RealESRGANDegrader
from .diffusion import resshift as rs
from .models.lpips import load_lpips
from .ops.metrics import batch_psnr, batch_ssim
from .parallel.mesh import full_tensor, local_devices, rank, world_size
from .pipeline import ResShiftPipeline, load_pth
from .trainer import TrainConfig, TrainStep
from .utils.image_io import from_model, imwrite, make_grid

__all__ = ["Trainer", "graceful_stop", "step_generator"]


def step_generator(seed: int, step: int, rank: int = 0, stream: int = 0,
                   device: str | torch.device = "cpu") -> torch.Generator:
    """A generator on `device` seeded from (seed, rank, step, stream) alone."""
    s = np.random.SeedSequence([seed, rank, step, stream]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s) >> 1)


@contextlib.contextmanager
def graceful_stop(sigs=(signal.SIGTERM, signal.SIGINT)):
    """Turn SIGTERM / SIGINT into a stop request; yields a callable that
    says whether one came.  The loop checkpoints and returns at the next
    iteration boundary; a second signal goes to the previous handler.  On
    a thread other than the main one, no handler is installed."""
    flag = {"stop": False}
    prev = {}

    def _handler(signum, frame):
        if flag["stop"]:
            old = prev.get(signum)
            if callable(old):
                return old(signum, frame)
            raise KeyboardInterrupt
        flag["stop"] = True
        print(f"[signal] {signal.Signals(signum).name} received: will checkpoint and stop at "
              "the next iteration boundary", flush=True)

    try:
        for s in sigs:
            prev[s] = signal.signal(s, _handler)
    except ValueError:  # not on the main thread
        prev.clear()
    try:
        yield lambda: flag["stop"]
    finally:
        for s, old in prev.items():
            signal.signal(s, old)


class Trainer:
    """One training run: the pipeline (random weights from `seed`, or the
    config's `.pth` warm starts), its `TrainStep`, the loader and the
    degrader, writing under `save_dir`; `resume` names a checkpoint to
    continue.  `device` as the pipeline takes it (CUDA unless "cpu"); the
    rank and the world size are the process group's (0 and 1 without one)."""

    def __init__(self, config: dict, save_dir: str = "./save_dir", resume: str | None = None,
                 dtype: torch.dtype = torch.float32, seed: int = 123456,
                 device: str | torch.device | None = None):
        self.config = config
        self.save_dir = Path(save_dir)
        self.seed, self.rank, self.world = seed, rank(), world_size()
        self.rank0 = self.rank == 0
        if self.rank0:
            for sub in ("ckpts", "images/train", "images/val"):
                (self.save_dir / sub).mkdir(parents=True, exist_ok=True)
        traw = dict(config.get("train") or {})
        self.tcfg = TrainConfig.from_config(config)
        b = traw.get("batch", 16)
        self.batch = int(b[0] if isinstance(b, (list, tuple)) else b)
        self.save_freq = int(traw.get("save_freq", 10000))
        self.log_freq = traw.get("log_freq", [200, 2000])
        self.val_freq = int(traw.get("val_freq", self.save_freq))
        self.dtype = dtype

        self.pipe = ResShiftPipeline(config, dtype=dtype, device=device)
        self.device = self.pipe.device
        self.pipe.init_params(seed)
        for mod, key, what in ((self.pipe.unet, "model", "denoiser"),
                               (self.pipe.vq, "autoencoder", "frozen VQGAN")):
            path = (config.get(key) or {}).get("ckpt_path")
            if path and mod is not None:
                load_pth(mod, path)
                print(f"[init] {what} from {path}", flush=True)
        self.lpips = None
        if (config.get("trainer") in ("difir_lpips", "TrainerDifIRLPIPS")
                or traw.get("use_lpips")):
            self.lpips = self._build_lpips(traw.get("lpips_path"))
        self.step_fn = TrainStep(self.pipe, self.tcfg, lpips=self.lpips)

        dcfg = config.get("data") or {}
        train_cfg = dcfg.get("train")
        self.train_type = train_cfg["type"] if train_cfg else None
        self.loader = None
        if train_cfg:
            self.loader = DataLoader(create_dataset(train_cfg), batch_size=self.batch,
                                     shuffle=True, seed=seed, shard_id=self.rank,
                                     num_shards=self.world,
                                     num_workers=int(traw.get("num_workers", 0)))
        self.val_cfg = dcfg.get("val")
        self.degrader = None
        if self.train_type == "realesrgan":
            self.degrader = RealESRGANDegrader(
                DegradationConfig.from_dict(dict(config.get("degradation") or {})))
        self.np_rng = np.random.default_rng(seed + self.rank)
        self.start_iter = 0
        self.timings: list[dict] = []  # per iteration: loader, degrader and step ms
        self.val_items: list[int] = []  # the val items this rank restored last
        self._saver: AsyncSaver | None = None
        self._val_pipe: ResShiftPipeline | None = None
        if resume:
            self.resume(resume)

    def _build_lpips(self, path: str | None):
        """The frozen LPIPS(vgg) of the loss and of validation, in the
        compute dtype on the device."""
        if not path and self.rank0:
            print("WARNING: LPIPS enabled without train.lpips_path — using RANDOM weights "
                  "(tests/smoke only)", flush=True)
        return load_lpips(path or None, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------ the loop

    def _gen(self, it: int, stream: int) -> torch.Generator:
        return step_generator(self.seed, it, self.rank, stream, self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prepare_batch(self, raw: dict, generator: torch.Generator) -> dict:
        """The device degradation for realesrgan data, else the batch as it
        is; tensors on the device."""
        if self.degrader is not None:
            raw = self.degrader(self.np_rng, generator, raw)
        return {k: torch.as_tensor(v).to(self.device) for k, v in raw.items()
                if not isinstance(v, list)}

    def train_step(self, batch: dict, generator: torch.Generator) -> dict:
        return self.step_fn(batch, generator)

    def train(self, stop_iter: int | None = None, handle_signals: bool = False) -> TrainStep:
        """Run to `train.iterations`, or to the earlier `stop_iter` (the
        schedule and the draws stay those of the full run, so a later resume
        continues it).  `handle_signals` (the CLI's) turns SIGTERM / SIGINT
        into a checkpoint and a clean stop.  Returns the train state."""
        if self.loader is None:
            raise ValueError("the config has no data.train section")
        ctx = graceful_stop() if handle_signals else contextlib.nullcontext(lambda: False)
        with ctx as stop_requested:
            return self._train_loop(stop_iter, stop_requested)

    def _train_loop(self, stop_iter, stop_requested) -> TrainStep:
        log_path = self.save_dir / "train_log.jsonl"
        it = self.start_iter
        end = self.tcfg.iterations if stop_iter is None else min(stop_iter, self.tcfg.iterations)
        data_iter = self.loader.infinite(skip_batches=self.start_iter)
        t0 = time.time()
        while it < end:
            t_a = time.perf_counter()
            raw = next(data_iter)
            t_b = time.perf_counter()
            batch = self.prepare_batch(raw, self._gen(it, 1))
            self._sync()
            t_c = time.perf_counter()
            metrics = self.train_step(batch, self._gen(it, 2))
            self._sync()
            t_d = time.perf_counter()
            it += 1
            ms = {"loader_ms": (t_b - t_a) * 1e3, "degrade_ms": (t_c - t_b) * 1e3,
                  "step_ms": (t_d - t_c) * 1e3}
            self.timings.append({"iter": it, **ms})
            if self.rank0 and it % int(self.log_freq[0]) == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(iter=it, ips=int(self.log_freq[0]) / (time.time() - t0), **ms)
                t0 = time.time()
                with open(log_path, "a") as f:
                    f.write(json.dumps(m) + "\n")
                print(f"[{it}/{self.tcfg.iterations}] " +
                      " ".join(f"{k}={v:.4g}" for k, v in m.items() if k != "iter"), flush=True)
            if len(self.log_freq) > 1 and it % int(self.log_freq[1]) == 0:
                self.step_fn.sync_pipe()
                if self.rank0:
                    self.log_train_images(it, batch, self._gen(it, 3))
            if self.val_cfg and it % self.val_freq == 0:
                self.validate(it)
            if it % self.save_freq == 0:
                self.save(it, block=False)
            if stop_requested():
                self.save(it)
                if self.rank0:
                    print(f"[signal] stopped cleanly at step {it}; resume from "
                          f"{self.save_dir / 'ckpts'}/step_{it:08d}", flush=True)
                return self.step_fn
        self.save(it)
        return self.step_fn

    # ------------------------------------------------------------ images

    @torch.no_grad()
    def log_train_images(self, it: int, batch: dict, generator: torch.Generator,
                         max_n: int = 8) -> None:
        """lq / gt / diffused x_t / x0-prediction grids of the first `max_n`
        samples, through the current weights (the UNet's own pin)."""
        if "gt" not in batch or "lq" not in batch:
            return
        pipe = self.pipe
        sub = {k: v[:max_n] for k, v in batch.items()}
        z_y, z0 = self.step_fn.encode(sub)
        t = torch.randint(0, pipe.sched.num_timesteps, (z0.shape[0],), generator=generator,
                          device=z0.device)
        noise = torch.randn(z0.shape, generator=generator, device=z0.device)
        kw = {"lq": sub["lq"]} if pipe.cond_lq else {}
        if pipe.cond_mask and "mask" in sub:
            kw["mask"] = sub["mask"]
        _, z_t, pred = rs.training_losses(pipe.sched, pipe.unet, z0, z_y, t, noise,
                                          model_kwargs=kw)
        x_t = pipe._decode(pipe.vq, z_t).clamp(-1, 1)
        x0p = pipe._decode(pipe.vq, pred).clamp(-1, 1)
        for name, im in (("lq", sub["lq"]), ("gt", sub["gt"]), ("xt", x_t), ("x0pred", x0p)):
            grid = make_grid(from_model(im.float().cpu().numpy()), ncol=max_n)
            imwrite(grid, self.save_dir / "images" / "train" / f"{name}_{it:06d}.png")

    # ------------------------------------------------------------ validation

    def _val_pipeline(self, ema: dict) -> ResShiftPipeline:
        """A pipeline of its own for the EMA weights: `load_state_dicts`
        resets its cast copies, so `sample` never runs stale weights."""
        if self._val_pipe is None:
            self._val_pipe = ResShiftPipeline(self.config, dtype=self.dtype, device=self.device)
        vq = None if self.pipe.vq is None else self.pipe.vq.state_dict()
        self._val_pipe.load_state_dicts(unet=ema, vqgan=vq)
        return self._val_pipe

    def validate(self, it: int, max_images: int | None = None):
        """The reverse chain on the val set with the EMA weights (gathered
        whole from an FSDP state); PSNR / SSIM (Y) against the GT where
        there is one (and LPIPS, one batched call a shape group, for the
        LPIPS trainer), appended to the JSON log; the first image's
        restoration and progressive strip under images/val.
        `train.val_max_images` bounds the set.  Each rank restores its share
        of the items (`items[rank::world]`, their indices in `val_items`)
        and the sums are all-reduced, so every rank returns the metrics over
        the whole set.  Each shape group's batch is split over the process's
        cards where it owns several (one process on a multi-card host).
        Returns (psnr, ssim) or None."""
        ema = {n: full_tensor(e) for n, e in self.step_fn.ema.items()}
        if max_images is None:
            raw = dict(self.config.get("train") or {}).get("val_max_images")
            max_images = int(raw) if raw else None
        ds = create_dataset(self.val_cfg)
        vp = self._val_pipeline(ema)
        devices = local_devices() if self.world == 1 and self.device.type == "cuda" else []
        n_items = len(ds) if max_images is None else min(len(ds), max_images)
        self.val_items = list(range(self.rank, n_items, self.world))
        items = {i: ds[i] for i in self.val_items}
        val_dir = self.save_dir / "images" / "val"
        dev = self.device
        as_t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
        if 0 in items:  # rank 0's
            lq0 = as_t(items[0]["lq"])[None]
            mask0 = as_t(items[0]["mask"])[None] if "mask" in items[0] else None
            if max(lq0.shape[1:3]) <= vp.chop_size:
                _, strip = vp.sample_progressive(lq0, torch.Generator(device=dev).manual_seed(0),
                                                 mask=mask0)
                strip01 = from_model(strip[:, 0].cpu().numpy())
                imwrite(make_grid(strip01, ncol=strip01.shape[0]),
                        val_dir / f"progress_{it:06d}.png")
        groups: dict[tuple, list] = {}
        for i, item in items.items():
            groups.setdefault((item["lq"].shape, "mask" in item), []).append((i, item))
        psnr = ssim = lpips_sum = 0.0
        n = 0
        for gi, group in enumerate(groups.values()):
            lq = as_t(np.stack([item["lq"] for _, item in group]))
            mask = (as_t(np.stack([item["mask"] for _, item in group]))
                    if "mask" in group[0][1] else None)
            gen = torch.Generator(device=dev).manual_seed(gi + 1)
            sr = (vp.sample_batch_sharded(lq, gen, devices, mask)
                  if len(devices) > 1 and lq.shape[0] > 1 else vp.sample(lq, gen, mask))
            sr01 = from_model(sr.cpu().numpy())
            for j, (i, _) in enumerate(group):
                if i == 0:
                    imwrite(sr01[j], val_dir / f"val_{it:06d}.png")
            idx = [j for j, (_, item) in enumerate(group) if "gt" in item]
            if idx:
                gt = np.stack([np.asarray(group[j][1]["gt"]) for j in idx])
                gt01 = from_model(gt)
                psnr += batch_psnr(sr01[idx], gt01, ycbcr=True)  # sums over the batch
                ssim += batch_ssim(sr01[idx], gt01, ycbcr=True)
                if self.lpips is not None:
                    with torch.no_grad():
                        v = self.lpips(as_t(sr01[idx] * 2 - 1), as_t(gt))
                    lpips_sum += float(v.float().sum())
                n += len(idx)
        if self.world > 1:
            sums = torch.tensor([psnr, ssim, lpips_sum, n], dtype=torch.float64, device=dev)
            torch.distributed.all_reduce(sums)
            psnr, ssim, lpips_sum, n = sums.tolist()
            n = int(n)
        if not n:
            return None
        metrics = {"iter": it, "val_n": n, "val_psnr_y": float(psnr / n),
                   "val_ssim_y": float(ssim / n)}
        msg = f"[val @{it}] PSNR(Y)={psnr / n:.2f} SSIM(Y)={ssim / n:.4f}"
        if self.lpips is not None:
            metrics["val_lpips"] = lpips_sum / n
            msg += f" LPIPS={lpips_sum / n:.4f}"
        if self.rank0:
            with open(self.save_dir / "train_log.jsonl", "a") as f:
                f.write(json.dumps(metrics) + "\n")
            print(msg, flush=True)
        return psnr / n, ssim / n

    # ------------------------------------------------------------ checkpoints

    def save(self, it: int, block: bool = True) -> None:
        """Checkpoint the train state under ckpts/step_XXXXXXXX; `block=False`
        returns once the state is copied to the host.  Every rank gathers
        (an FSDP state), rank 0 writes."""
        state = self.step_fn.state_dict()
        if not self.rank0:
            return
        if self._saver is None:
            self._saver = AsyncSaver()
        self._saver.save(self.save_dir / "ckpts", state, step=it)
        if block:
            self._saver.wait()
        print(f"[ckpt] {'saved' if block else 'saving (async)'} step {it}", flush=True)

    def resume(self, path: str) -> None:
        """Continue from a checkpoint, whatever world size wrote it."""
        self.step_fn.load_state_dict(restore_train_state(path))
        self.start_iter = self.step_fn.step
        if self.rank0:
            print(f"[resume] from {path} at step {self.start_iter}", flush=True)
