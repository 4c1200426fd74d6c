"""The train step: AdamW with a warmup-then-cosine (or constant) learning
rate, an EMA of the weights, microbatch accumulation, rematerialisation.

One `TrainStep` call takes a batch {'gt', 'lq'[, 'mask']} in [-1, 1] (NHWC,
on the pipeline's device) and, per microbatch:
  * encodes both images with the frozen VQGAN under `torch.no_grad()` (the
    JAX package's stop_gradient; kernel C launches there on the card);
  * draws t ~ U[0, T) and the q_sample noise from `generator` (or takes
    them from `draws`, one (t, noise) pair a microbatch, as a test feeds
    the JAX package's);
  * runs the UNet pinned `use_pallas=False` (the plain composition, as the
    JAX trainer's `clone(use_pallas=False)`: the kernels' backward would
    recompute it anyway) in train mode, so dropout is live;
  * backpropagates the mean latent MSE (`diffusion.resshift.training_losses`),
    times `loss_coef[0]`;
  * with an `lpips` module (the LPIPS trainer, `trainer: difir_lpips`), also
    decodes the x0 prediction through `pipe.vq.clone(use_pallas=False)` (the
    same parameters on the plain attention and codebook search: kernel C has
    no backward, and the JAX package pins its UNet off the kernels under
    autograd for the same reason), clamps it to [-1, 1] and adds
    `loss_coef[1]` times the batch mean of LPIPS against the GT, NaN set to
    0 (metric `lpips`).  LPIPS and the VQGAN take no gradient.
The gradient is the mean over the microbatches; then the learning rate of
the step is set, `torch.optim.AdamW` steps (its update is optax.adamw's),
and the EMA follows.  Metrics: loss, mse (and lpips), the per-timestep
buckets (t = 0, T // 2, T - 1), lr and the global gradient norm, as 0-d
tensors.
`remat` ("dots": keep matmul and conv outputs, recompute the elementwise
chains; "full": keep nothing) wraps the UNet in `torch.utils.checkpoint`.

Across processes (a process group up: `parallel.mesh.maybe_init_distributed`)
each rank runs this step on its own part of the global batch:
  * DP: the gradients are averaged over the ranks before AdamW by one
    all-reduce of their concatenation, so every rank takes the same step and
    keeps the same EMA; with equal local batches that is the JAX package's
    mean over the global batch;
  * FSDP (`train.fsdp: true`): the train clone is sharded with `fully_shard`,
    so the parameters, their gradients, the AdamW moments and the EMA are
    each cut along dim 0 over the ranks (`named` holds the DTensors); the
    forward gathers the parameters, the backward reduce-scatters and
    averages the gradients.  `state_dict` gathers the whole state (every
    rank calls it), so a checkpoint is the same file at any world size, and
    `load_state_dict` takes each rank's piece of it.  Without a process
    group the step runs unsharded, as the JAX package's does on one device;
    the pipeline's own UNet stays whole and is refreshed by `sync_pipe`.
The metrics are the JAX step's over the global batch: averaged over the
ranks, except the per-timestep buckets without microbatches, which are each
bucket's sum over the ranks over its count (JAX takes the global batch as one
microbatch there; with microbatches each rank's are global microbatches of
its own, so the mean of the ranks' means is JAX's mean over microbatches).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .diffusion import resshift as rs
from .parallel.mesh import all_reduce_mean_, full_tensor, shard_like, shard_module
from .pipeline import ResShiftPipeline

__all__ = ["TrainConfig", "TrainStep", "lr_schedule_fn"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 5e-5
    lr_min: float = 2e-5
    lr_schedule: str | None = "cosin"
    warmup_iterations: int = 5000
    iterations: int = 300000
    weight_decay: float = 0.0
    ema_rate: float = 0.999
    microbatch: int | None = None  # None: no accumulation
    weighted_mse: bool = False
    loss_coef: tuple[float, float] = (1.0, 1.0)  # (mse, lpips)
    remat: str | None = None  # None, "dots" or "full"
    fsdp: bool = False

    @classmethod
    def from_config(cls, config: dict) -> "TrainConfig":
        """The `train:` block of a task config (`weighted_mse` may also sit
        under `diffusion:`, where the reference reads it)."""
        t = dict(config.get("train") or {})
        return cls(
            lr=float(t.get("lr", 5e-5)), lr_min=float(t.get("lr_min", 2e-5)),
            lr_schedule=t.get("lr_schedule"),
            warmup_iterations=int(t.get("warmup_iterations", 5000)),
            iterations=int(t.get("iterations", 300000)),
            weight_decay=float(t.get("weight_decay", 0.0)),
            ema_rate=float(t.get("ema_rate", 0.999)), microbatch=t.get("microbatch"),
            weighted_mse=bool(t.get("weighted_mse",
                                    (config.get("diffusion") or {}).get("weighted_mse", False))),
            loss_coef=tuple(t.get("loss_coef", (1.0, 1.0))), remat=t.get("remat"),
            fsdp=bool(t.get("fsdp", False)))


def lr_schedule_fn(cfg: TrainConfig) -> Callable[[int], float]:
    """Step -> learning rate: linear warmup over `warmup_iterations`, then a
    cosine from lr to lr_min over `iterations` (`lr_schedule: cosin`) or
    constant; in float32, as the JAX package computes it."""
    f32 = np.float32

    def fn(step: int) -> float:
        s = f32(step)
        warm = min(f32(1.0), (s + f32(1)) / f32(max(cfg.warmup_iterations, 1)))
        if cfg.lr_schedule == "cosin":
            prog = np.clip(s / f32(max(cfg.iterations, 1)), f32(0), f32(1))
            base = f32(cfg.lr_min) + f32(0.5) * (f32(cfg.lr) - f32(cfg.lr_min)) * (
                f32(1) + np.cos(f32(math.pi) * prog))
        else:
            base = f32(cfg.lr)
        return float(f32(base * warm))

    return fn


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.baddbmm.default, torch.ops.aten.convolution.default}


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


class TrainStep:
    """The train state (the UNet's parameters, AdamW, the EMA, the step) and
    its update.  The parameters are `pipe.unet`'s own (float32 masters,
    cast to the compute dtype at use), or their shards under FSDP; the
    VQGAN (and `lpips`, a frozen `models.lpips.LPIPS`, where given) stays
    frozen."""

    def __init__(self, pipe: ResShiftPipeline, cfg: TrainConfig,
                 lpips: torch.nn.Module | None = None):
        if cfg.remat not in (None, "dots", "full"):
            raise ValueError(f"remat must be 'dots', 'full' or null, got {cfg.remat!r}")
        self.pipe, self.cfg = pipe, cfg
        self.lr_fn = lr_schedule_fn(cfg)
        self.fsdp = cfg.fsdp and torch.distributed.is_initialized()
        self.train_unet = pipe.unet.clone(use_pallas=False).train()
        if self.fsdp:  # the clone's parameters become DTensor shards of their own
            shard_module(self.train_unet)
        self.named = list((self.train_unet if self.fsdp else pipe.unet).named_parameters())
        if pipe.vq is not None:
            pipe.vq.requires_grad_(False)
        self.lpips = lpips
        self.decode_vq = None
        if lpips is not None:
            if pipe.vq is None:
                raise ValueError("the LPIPS loss decodes the x0 prediction: it needs a VQGAN")
            lpips.requires_grad_(False)
            self.decode_vq = pipe.vq.clone(use_pallas=False)
        params = [p for _, p in self.named]
        self.opt = torch.optim.AdamW(params, lr=self.lr_fn(0), betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)
        self.ema = {n: p.detach().clone() for n, p in self.named}
        self.step = 0
        self.use_dropout = any(isinstance(m, torch.nn.Dropout) and m.p > 0
                               for m in self.train_unet.modules())

    # ------------------------------------------------------------- the loss

    def _model(self, x, t, **kw):
        if not self.cfg.remat:
            return self.train_unet(x, t, **kw)
        keys = list(kw)
        fn = lambda x, t, *vals: self.train_unet(x, t, **dict(zip(keys, vals)))
        extra = ({} if self.cfg.remat == "full" else
                 {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                  _save_dots)})
        return checkpoint(fn, x, t, *kw.values(), use_reentrant=False, **extra)

    def encode(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(z_y, z0): the LQ upsampled and encoded, the GT encoded; no graph."""
        with torch.no_grad():
            return (self.pipe._encode(self.pipe.vq, batch["lq"]),
                    self.pipe._encode(self.pipe.vq, batch["gt"], up_sample=False))

    def loss(self, batch: dict, generator: torch.Generator | None, draws=None):
        """One microbatch: (loss with its graph, detached metrics, the
        per-timestep buckets' sample counts)."""
        pipe, sched = self.pipe, self.pipe.sched
        z_y, z0 = self.encode(batch)
        if draws is None:
            t = torch.randint(0, sched.num_timesteps, (z0.shape[0],), generator=generator,
                              device=z0.device)
            noise = torch.randn(z0.shape, generator=generator, device=z0.device)
        else:
            t, noise = (torch.as_tensor(d).to(z0.device) for d in draws)
            t = t.long()
        kw = {}
        if pipe.cond_lq:
            kw["lq"] = batch["lq"]
        if pipe.cond_mask and "mask" in batch:
            kw["mask"] = batch["mask"]
        mse, _, pred_z0 = rs.training_losses(sched, self._model, z0, z_y, t, noise,
                                             model_kwargs=kw,
                                             weighted_mse=self.cfg.weighted_mse)
        loss = mse.mean() * self.cfg.loss_coef[0]
        mse = mse.detach()
        metrics = {"mse": mse.mean()}
        if self.lpips is not None:
            x0 = pipe._decode(self.decode_vq, pred_z0).clamp(-1.0, 1.0)
            lp = torch.nan_to_num(self.lpips(x0, batch["gt"]).float().mean())
            loss = loss + self.cfg.loss_coef[1] * lp
            metrics["lpips"] = lp.detach()
        counts = {}
        for name, tt in (("loss_t0", 0), ("loss_tmid", sched.num_timesteps // 2),
                         ("loss_tlast", sched.num_timesteps - 1)):
            sel = (t == tt).float()
            counts[name] = sel.sum()
            metrics[name] = (mse * sel).sum() / counts[name].clamp(min=1.0)
        metrics["loss"] = loss.detach()
        return loss, metrics, counts

    # ------------------------------------------------------------- the step

    def grads(self, batch: dict, generator: torch.Generator | None = None, draws=None):
        """The mean gradient over the microbatches into each parameter's
        `.grad` (zeros where a parameter has none); returns the metrics."""
        b = batch["gt"].shape[0]
        mb = int(self.cfg.microbatch or b)
        if b % mb:  # the JAX step's reshape to (n_micro, microbatch) fails there too
            raise ValueError(f"batch {b} is not a multiple of the microbatch {mb}")
        n_micro = b // mb
        for _, p in self.named:
            p.grad = None
        sums: dict[str, torch.Tensor] = {}
        for i in range(n_micro):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            with torch.random.fork_rng(devices=[part["gt"].device] if part["gt"].is_cuda else [],
                                       enabled=self.use_dropout):
                if self.use_dropout:  # a seed from the step's generator: resumes exactly
                    dev = None if generator is None else generator.device
                    torch.manual_seed(int(torch.randint(2**62, (1,), generator=generator,
                                                        device=dev)))
                loss, metrics, counts = self.loss(part, generator,
                                                  None if draws is None else draws[i])
                loss.backward()
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        for _, p in self.named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif n_micro > 1:
                p.grad.div_(n_micro)
        if not self.fsdp:  # FSDP's backward has reduce-scattered them already
            all_reduce_mean_([p.grad for _, p in self.named])
        metrics = {k: v / n_micro for k, v in sums.items()}
        buckets = {}
        if not self.cfg.microbatch and torch.distributed.is_initialized():
            buckets = {k: metrics.pop(k) for k in counts}  # one microbatch on this rank
            flat = torch.stack([buckets[k] * counts[k] for k in counts] + list(counts.values()))
            torch.distributed.all_reduce(flat)
            buckets = {k: flat[i] / flat[len(counts) + i].clamp(min=1.0)
                       for i, k in enumerate(counts)}
        all_reduce_mean_(list(metrics.values()))
        return {**metrics, **buckets}

    def __call__(self, batch: dict, generator: torch.Generator | None = None, draws=None):
        """One optimisation step; returns the metrics (0-d tensors)."""
        metrics = self.grads(batch, generator, draws)
        params = [p for _, p in self.named]
        metrics["grad_norm"] = self._grad_norm()
        lr = self.lr_fn(self.step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        r = self.cfg.ema_rate
        with torch.no_grad():
            ema = list(self.ema.values())
            torch._foreach_mul_(ema, r)
            torch._foreach_add_(ema, torch._foreach_mul(params, 1 - r))
        self.step += 1
        metrics["lr"] = torch.tensor(lr)
        return metrics

    def _grad_norm(self) -> torch.Tensor:
        """The global L2 norm of the (averaged) gradient; under FSDP from each
        rank's shards, summed over the ranks."""
        if not self.fsdp:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
                [p.grad for _, p in self.named])))
        sq = sum(p.grad.to_local().float().square().sum() for _, p in self.named)
        torch.distributed.all_reduce(sq)
        return sq.sqrt()

    # ------------------------------------------------------------ the state

    @torch.no_grad()
    def state_dict(self) -> dict:
        """{'step', 'params', 'ema', 'exp_avg', 'exp_avg_sq'}, the last four
        name -> tensor (references: `checkpoint.AsyncSaver` copies them);
        whole tensors under FSDP too, gathered from the shards (every rank
        calls it)."""
        st = self.opt.state
        moments = {k: {n: full_tensor(st[p][k]) for n, p in self.named if p in st}
                   for k in ("exp_avg", "exp_avg_sq")}
        return {"step": self.step,
                "params": {n: full_tensor(p.detach()) for n, p in self.named},
                "ema": {n: full_tensor(e) for n, e in self.ema.items()}, **moments}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Restore a `state_dict` (from this class or
        `convert.train_state_from_flax`), whole tensors whatever the world
        size it was saved at: under FSDP each rank takes its own piece."""
        self.step = int(sd["step"])
        for n, p in self.named:
            p.copy_(shard_like(torch.as_tensor(sd["params"][n]), p))
            self.ema[n].copy_(shard_like(torch.as_tensor(sd["ema"][n]), p))
            self.opt.state.pop(p, None)
            if self.step and n in sd.get("exp_avg", {}):
                self.opt.state[p] = {
                    "step": torch.tensor(float(self.step)),
                    "exp_avg": shard_like(torch.as_tensor(sd["exp_avg"][n]), p).clone(),
                    "exp_avg_sq": shard_like(torch.as_tensor(sd["exp_avg_sq"][n]), p).clone()}
        self.sync_pipe()

    @torch.no_grad()
    def sync_pipe(self) -> None:
        """Under FSDP, copy the gathered parameters into the pipeline's own
        UNet (a collective: every rank calls it), which the image grids run;
        otherwise they are the same tensors already."""
        if self.fsdp:
            own = dict(self.pipe.unet.named_parameters())
            for n, p in self.named:
                own[n].copy_(full_tensor(p.detach()))
