"""End-to-end ResShift sampler: bicubic x sf upsample (none at sf 1), VQGAN
encode, prior sample, the reverse chain over UNetModelSwin, VQGAN decode,
clamp to [-1, 1]; inputs larger than the chop size go through an
overlapping tile grid, their masks (inpainting) through the same grid.

  * `clip_denoised` is False whenever an autoencoder is present.
  * Inputs are reflect-padded to a multiple of `padding_offset` and cropped
    back after sampling.  A side that is not tiled is padded further where
    the UNet could not take it (at x2 an LQ side padding to 192 goes to
    256; the JAX package raises there); the reflection repeats where the
    padding is not smaller than the side.
  * `noise_repeat` repeats sample 0's noise across the batch.
  * A UNet with an LQ feature pyramid (lq_size != image_size: x2 SR,
    inpainting, faceir) gets its features once per call, not once per step.
  * A config's `model.use_pallas: true` launches kernel F in the UNet head
    (the JAX package's pin; `false` pins the UNet to the plain composition,
    with no kernel) and `autoencoder.use_pallas: true` in the VQGAN decoder
    tail (a key of this package only; `false` pins the VQGAN to its plain
    attention and codebook search, as `VQModel.clone(use_pallas=False)`).
  * `diffusion.variant: ddpm` swaps the residual-shifting chain for classic
    DDPM (`sampler: ancestral`) or DDIM (`sampler: ddim`, with `eta`) from
    pure noise at the latent shape, the LQ image conditioning the UNet
    through its kwargs; padding, chopping and the CLI are the same.
    `noise_repeat` raises there (the JAX package ignores it).
  * `sample_time_parallel` (Picard sweeps over the whole chain) and
    `sample_progressive` (every step's x0 prediction, decoded) take inputs
    that fit one tile.
  * Several cards of one process (the JAX package's single-host mesh):
    `sample_batch_sharded` splits the image batch over `devices`,
    `sample_tiles_sharded` one image's tile grid, and
    `sample_time_parallel(devices=)` the Picard sweep's (T*B) batch.  Each
    card runs a replica of the models (cast once per card, like the
    pipeline's own) and the schedule; the noise is drawn whole on the
    pipeline's device in `sample`'s order (`chain_draws`) and each shard
    takes its rows, so a sharded call draws what `sample` would.
  * Tensor parallelism (`sample_tp`, parallel/tp.py): every rank of a
    process group runs the chain on its pieces of the weights (the
    Megatron layout, plain compositions only, as the JAX package's
    `_tp_clone`), and every rank returns the same image.
  * Pipeline parallelism (`sample_pipelined`, parallel/pp.py): the chain's
    steps staged over devices of this process, chunks of tiles streaming
    through; each stage runs the kernels, as `sample` does.

The pipeline runs on CUDA unless the caller passes `device="cpu"`; without
CUDA and without that argument it raises.  Images are NHWC float32 in
[-1, 1].
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import task_config
from .diffusion import ddpm
from .diffusion import resshift as rs
from .diffusion.schedule import build_schedule
from .models.layers import GroupNorm32
from .models.unet import UNetModelSwin
from .models.vqgan import VQModel
from .ops.resize import resize
from .ops.tiling import TileGrid
from .parallel.mesh import local_devices

__all__ = ["ResShiftPipeline", "load_pth", "resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`None` means CUDA, which must then be present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU")
    return device


def _card(device: torch.device) -> torch.device:
    """`device` with the current card's index where a CUDA device has none
    (the key its replicas are cached under)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _replicas(devices: list) -> list[tuple[torch.device, int]]:
    """(card, slot) for each entry of a sharded call's `devices`: a card
    listed k times gets k replicas, slots 0 to k - 1."""
    seen: dict[torch.device, int] = {}
    out = []
    for d in devices:
        d = _card(torch.device(d))
        out.append((d, seen.get(d, 0)))
        seen[d] = out[-1][1] + 1
    return out


@torch.no_grad()
def _init_(module: nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal weights for every conv and linear (the output convs that
    the reference zero-initialises included), zero biases, unit GroupNorm
    scales, N(0, 0.02) rel-pos tables cut at 2 sigma, a U[0, 2/n) codebook.
    Drawn on the CPU."""
    def draw(p, t):
        p.copy_(t.to(p.device))

    for sub in module.modules():
        if isinstance(sub, GroupNorm32):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
        elif isinstance(sub, (nn.Conv2d, nn.Linear)):
            fan_in = sub.weight[0].numel()
            draw(sub.weight, torch.randn(sub.weight.shape, generator=generator) / math.sqrt(fan_in))
            sub.bias.zero_()
        elif isinstance(sub, nn.Embedding):
            draw(sub.weight, torch.rand(sub.weight.shape, generator=generator)
                 * (2.0 / sub.weight.shape[0]))
    for name, p in module.named_parameters():
        if name.endswith("relative_position_bias_table"):
            draw(p, torch.randn(p.shape, generator=generator).clamp_(-2, 2) * 0.02)


def load_pth(module: nn.Module, path: str) -> None:
    """Load a released `.pth` (reference layout) into `module`: the keys it
    has, the file's others ignored; a key it needs and the file lacks
    raises.  A directory (the JAX package's orbax format) raises."""
    from .convert import load_torch_state_dict

    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax checkpoint of the JAX package?); "
                         f"this port reads released .pth files")
    sd = load_torch_state_dict(path)
    missing = [k for k in module.state_dict() if k not in sd]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} keys, e.g. {missing[:3]}")
    module.load_state_dict({k: torch.as_tensor(sd[k]) for k in module.state_dict()})


class ResShiftPipeline:
    """Holds the models (float32 master weights) and the schedule; `sample`
    is the entry point."""

    def __init__(self, config: dict | str, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None):
        if isinstance(config, str):
            config = task_config(config)
        self.config = config
        self.device = resolve_device(device)
        self.dtype = dtype
        self.sf = int(config["sf"])
        d = config["diffusion"]
        self.variant = d.get("variant", "resshift")
        if self.variant == "ddpm":
            self.ddpm_sampler = d.get("sampler", "ancestral")
            if self.ddpm_sampler not in ("ancestral", "ddim"):
                raise ValueError(f"unknown diffusion.sampler '{self.ddpm_sampler}'")
            self.ddpm_eta = float(d.get("eta", 0.0))
            self.sched = ddpm.build_ddpm_schedule(
                steps=d.get("steps", 1000), beta_start=d.get("beta_start", 1e-4),
                beta_end=d.get("beta_end", 0.02),
                predict_xstart=d.get("predict_type", "epsilon") == "xstart",
                timestep_respacing=d.get("timestep_respacing"),
                scale_factor=float(d.get("scale_factor", 1.0)), sf=self.sf, device=self.device)
        elif self.variant == "resshift":
            self.sched = build_schedule(
                schedule_name=d.get("schedule_name", "exponential"), steps=d["steps"],
                min_noise_level=d["min_noise_level"], etas_end=d.get("etas_end", 0.99),
                kappa=d.get("kappa", 1.0), power=d.get("power", 0.3),
                predict_type=d.get("predict_type", "xstart"),
                timestep_respacing=d.get("timestep_respacing"),
                normalize_input=d.get("normalize_input", True),
                latent_flag=d.get("latent_flag", True),
                scale_factor=float(d.get("scale_factor", 1.0)), sf=self.sf, device=self.device)
        else:
            raise ValueError(f"unknown diffusion.variant '{self.variant}'")
        m = {k: v for k, v in config["model"].items() if k not in ("dims", "use_fp16", "ckpt_path")}
        self.unet = UNetModelSwin(dtype=dtype, **m).to(self.device).eval()
        self.cond_lq = m.get("cond_lq", True)
        self.cond_mask = m.get("cond_mask", False)
        ae = config.get("autoencoder")
        self.vq = None if ae is None else VQModel(
            ae["ddconfig"], n_embed=ae["n_embed"], embed_dim=ae["embed_dim"],
            dtype=dtype, use_pallas=ae.get("use_pallas")).to(self.device).eval()
        inf = config.get("inference", {})
        self.padding_offset = int(inf.get("padding_offset", m.get("lq_size", 64)))
        # the LQ side whose latent the UNet takes: latent = LQ * sf / f
        self.f = 1 if ae is None else 2 ** (len(ae["ddconfig"]["ch_mult"]) - 1)
        need = self.unet.size_multiple * self.f
        self.lq_multiple = need // math.gcd(need, self.sf)
        self.chop_size = int(inf.get("chop_size", 512))
        self.chop_stride = int(inf.get("chop_stride", 448))
        self._compute = None  # (card, slot) -> the models cast to the compute dtype
        self._scheds: dict = {}

    # ------------------------------------------------------------ params

    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights (drawn on the CPU, so the same on every device)."""
        g = torch.Generator().manual_seed(seed)
        for mod in (self.unet, self.vq):
            if mod is not None:
                _init_(mod, g)
        self._compute = None

    def load_state_dicts(self, unet: dict | None = None, vqgan: dict | None = None) -> None:
        """Reference-layout state_dicts (numpy arrays or tensors)."""
        for mod, sd in ((self.unet, unet), (self.vq, vqgan)):
            if sd is not None:
                mod.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
        self._compute = None

    def load_torch_checkpoints(self, unet_path: str, vqgan_path: str | None = None) -> None:
        """The released `.pth` files.  As the JAX package's converter, this
        reads the keys the models have and ignores the rest (derived buffers
        such as `relative_position_index` and `attn_mask`, training-only
        entries); a key the models need and the file lacks raises."""
        if self.vq is not None and vqgan_path is None:
            raise ValueError("this task has a VQGAN: give its checkpoint too")
        for mod, path in ((self.unet, unet_path), (self.vq, vqgan_path)):
            if mod is not None:
                load_pth(mod, path)
        self._compute = None

    def _compute_params(self, device: torch.device | None = None, slot: int = 0
                        ) -> tuple[nn.Module, nn.Module | None]:
        """Copies of the models with every conv and linear weight cast to the
        compute dtype once, except the UNet head conv (`out.2`), which runs
        in float32; GroupNorm, the rel-pos tables and the codebook stay f32.
        On `device` (the pipeline's by default): one replica per card and
        `slot` (a further replica on a card that a sharded call lists more
        than once), made at its first use and dropped with the others
        whenever the weights change."""
        home = (_card(self.device), 0)
        key = (home[0] if device is None else _card(torch.device(device)), slot)
        if self._compute is None:
            self._compute = {}
        if home not in self._compute:
            if self.dtype == torch.float32:
                self._compute[home] = (self.unet, self.vq)
            else:
                def cast(mod):
                    mod = copy.deepcopy(mod)
                    for name, sub in mod.named_modules():
                        if isinstance(sub, (nn.Conv2d, nn.Linear)) and name != "out.2":
                            sub.to(self.dtype)
                    return mod

                self._compute[home] = (cast(self.unet),
                                       None if self.vq is None else cast(self.vq))
        if key not in self._compute:
            self._compute[key] = tuple(None if m is None else copy.deepcopy(m).to(key[0])
                                       for m in self._compute[home])
        return self._compute[key]

    def _schedule(self, device: torch.device):
        """The schedule's tensors on `device` (the pipeline's own schedule on
        its device)."""
        device = _card(device)
        if device == _card(self.device):
            return self.sched
        if device not in self._scheds:
            self._scheds[device] = dataclasses.replace(self.sched, **{
                f.name: getattr(self.sched, f.name).to(device)
                for f in dataclasses.fields(self.sched)
                if isinstance(getattr(self.sched, f.name), torch.Tensor)})
        return self._scheds[device]

    # ------------------------------------------------------------- core

    def _encode(self, vq: nn.Module | None, y: torch.Tensor,
                up_sample: bool = True) -> torch.Tensor:
        """Bicubic x sf upsample (unless `up_sample` is off: the trainer's
        GT), then the VQGAN encoder (pre-quantization)."""
        if up_sample and self.sf != 1:
            _, h, w, _ = y.shape
            y = resize(y, (h * self.sf, w * self.sf))
        if vq is None:
            return y.float()
        return vq.encode(y).float() * self.sched.scale_factor

    def _decode(self, vq: nn.Module | None, z: torch.Tensor) -> torch.Tensor:
        if vq is None:
            return z
        return vq.decode(z / self.sched.scale_factor).float()

    def _cond_kwargs(self, unet: nn.Module, lq, mask) -> dict:
        """The UNet's conditioning: the pyramid's features, computed here once
        for every step (the reference recomputes them each step: same
        math), or the LQ image and mask as they are."""
        if not self.cond_lq:
            return {}
        mask = mask if self.cond_mask else None
        if unet.feature_extractor is not None:
            return {"lq_feat": unet(None, None, lq=lq, mask=mask, features_only=True)}
        return {"lq": lq} if mask is None else {"lq": lq, "mask": mask}

    def _latent_shape(self, b: int, h: int, w: int, c: int) -> tuple[int, int, int, int]:
        """The chain's shape for b LQ images (tiles) of h x w x c: the VQGAN
        latent (the UNet's input channels under DDPM, pure noise there), or
        the upsampled image where there is no VQGAN."""
        ch = (self.config["model"].get("in_channels", 3) if self.variant == "ddpm"
              else c if self.vq is None else self.vq.quantize.e_dim)
        return b, h * self.sf // self.f, w * self.sf // self.f, ch

    def _ddpm_chain(self, unet, lq, generator, model_kwargs, noise, step_noise):
        """The DDPM or DDIM chain from pure noise at the latent shape."""
        shape = self._latent_shape(*lq.shape)
        kw = dict(noise=noise, step_noise=step_noise, clip_denoised=self.vq is None,
                  model_kwargs=model_kwargs, device=lq.device)
        sched = self._schedule(lq.device)
        if self.ddpm_sampler == "ddim":
            return ddpm.ddim_sample_loop(sched, unet, shape, generator, eta=self.ddpm_eta, **kw)
        return ddpm.p_sample_loop(sched, unet, shape, generator, **kw)

    @torch.no_grad()
    def _sample_tile(self, lq: torch.Tensor, generator: torch.Generator | None, mask=None,
                     noise_repeat: bool = False, noise: torch.Tensor | None = None,
                     step_noise: torch.Tensor | None = None, slot: int = 0,
                     models: tuple | None = None) -> torch.Tensor:
        """One (padded) tile batch, on the card that `lq` lies on (that
        card's replica `slot` of the models, or `models`, a (unet, vq)
        pair).  `noise` / `step_noise` fix the Gaussian draws as the chain
        takes them; otherwise they come from `generator`, the prior (or x_T)
        draw first."""
        unet, vq = models or self._compute_params(lq.device, slot)
        if self.variant == "ddpm":
            if noise_repeat:
                raise ValueError("noise_repeat is not defined for diffusion.variant ddpm")
            z0 = self._ddpm_chain(unet, lq, generator, self._cond_kwargs(unet, lq, mask), noise,
                                  step_noise)
            return self._decode(vq, z0).clamp(-1.0, 1.0)
        z_y = self._encode(vq, lq)
        if noise is None:
            noise = torch.randn(z_y.shape, generator=generator, dtype=torch.float32,
                                device=z_y.device)
            if noise_repeat:
                noise = noise[:1].expand_as(noise)
        z0 = rs.sample_loop(self._schedule(lq.device), unet, z_y, generator, noise=noise,
                            clip_denoised=vq is None,
                            model_kwargs=self._cond_kwargs(unet, lq, mask),
                            noise_repeat=noise_repeat, step_noise=step_noise)
        return self._decode(vq, z0).clamp(-1.0, 1.0)

    def _padded(self, n: int, chop_size: int) -> int:
        """A side of n LQ pixels padded to a multiple of the padding offset,
        and on to one of `lq_multiple` where it stays within `chop_size`."""
        p = math.ceil(n / self.padding_offset) * self.padding_offset
        mult = self.lq_multiple
        return math.ceil(n / mult) * mult if p <= chop_size and p % mult else p

    def _pad(self, lq, mask, chop_size):
        """Reflect-pad `lq` (and `mask`) to `_padded`'s size.  Returns the
        padded pair."""
        _, h, w, _ = lq.shape
        hp, wp = self._padded(h, chop_size), self._padded(w, chop_size)

        def pad(t):
            t = t.permute(0, 3, 1, 2)
            while t.shape[2] < hp or t.shape[3] < wp:
                if min(t.shape[2:]) < 2:
                    raise ValueError(f"cannot reflect-pad a {h}x{w} input to {hp}x{wp}")
                t = F.pad(t, (0, min(wp - t.shape[3], t.shape[3] - 1), 0,
                              min(hp - t.shape[2], t.shape[2] - 1)), mode="reflect")
            return t.permute(0, 2, 3, 1)

        return pad(lq), None if mask is None else pad(mask)

    def _chunks(self, b: int, h: int, w: int, chop_size: int, chop_stride: int,
                tile_bs: int):
        """How `sample` cuts b padded h x w images: (grid or None when not
        tiled, the tile batches' sizes, the tile's h and w)."""
        if h <= chop_size and w <= chop_size:
            return None, [b], (h, w)
        grid = TileGrid(h, w, chop_size, chop_stride, sf=self.sf)
        t_total = grid.num_tiles * b
        tile_bs = max(1, min(int(tile_bs), t_total))
        return (grid, [min(tile_bs, t_total - i) for i in range(0, t_total, tile_bs)],
                grid.tile_hw)

    def chain_draws(self, lq_shape, generator: torch.Generator, *, noise_repeat: bool = False,
                    chop_size: int | None = None, chop_stride: int | None = None,
                    tile_bs: int = 1):
        """The Gaussian draws that `sample` takes from `generator` for an
        input of `lq_shape` (B, H, W, C) under these arguments: (noise
        (N, ...), step noise (T, N, ...)) over its N tiles in `sample`'s
        order (tile-major; the images where it does not tile), drawn on the
        generator's device tile batch by tile batch, each the prior first,
        then step by step.  `sample(..., draws=)` takes them back."""
        chop_size, chop_stride = chop_size or self.chop_size, chop_stride or self.chop_stride
        b, h, w, c = lq_shape
        _, sizes, (th, tw) = self._chunks(b, self._padded(h, chop_size),
                                          self._padded(w, chop_size), chop_size, chop_stride,
                                          tile_bs)
        if noise_repeat and self.variant == "ddpm":
            raise ValueError("noise_repeat is not defined for diffusion.variant ddpm")
        parts = [rs.chain_draws(self.sched.num_timesteps, self._latent_shape(n, th, tw, c),
                                generator, generator.device, noise_repeat) for n in sizes]
        return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts], dim=1))

    def _sample_padded(self, lq, generator, mask, noise_repeat, chop_size, chop_stride,
                       tile_bs, draws=None, slot=0):
        """Pad -> (maybe tile) -> sample -> crop, on replica `slot` of the
        card that `lq` lies on.  A side longer than the chop size is cut
        into chop-sized tiles; a shorter one stays whole and is padded on to
        a multiple of `lq_multiple`.  `draws` (as `chain_draws` gives them)
        replace the generator's."""
        b, h, w, c = lq.shape
        lq, mask = self._pad(lq, mask, chop_size)
        hp, wp = lq.shape[1:3]
        grid, sizes, _ = self._chunks(b, hp, wp, chop_size, chop_stride, tile_bs)
        tiles = lq if grid is None else grid.split(lq)
        mtiles = mask if grid is None or mask is None else grid.split(mask)
        outs, i = [], 0
        for n in sizes:
            sl = slice(i, i + n)
            kw = {} if draws is None else dict(noise=draws[0][sl].to(lq.device),
                                               step_noise=draws[1][:, sl].to(lq.device))
            if slot:
                kw["slot"] = slot
            outs.append(self._sample_tile(tiles[sl], generator,
                                          None if mtiles is None else mtiles[sl], noise_repeat,
                                          **kw))
            i += n
        out = outs[0] if grid is None else grid.gather(torch.cat(outs, dim=0), b)
        return out[:, :h * self.sf, :w * self.sf, :]

    def _one_tile(self, lq, generator, mask):
        """The inputs of `sample_time_parallel` and `sample_progressive`: on
        the device, padded as `sample` pads an untiled input; refused where
        `sample` would chop them.  Returns (lq, mask, generator, crop)."""
        if self.variant != "resshift":
            raise NotImplementedError("this sampler runs the residual-shifting chain only")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        lq = lq.to(self.device, torch.float32)
        mask = None if mask is None else mask.to(self.device, torch.float32)
        _, h, w, _ = lq.shape
        lq, mask = self._pad(lq, mask, self.chop_size)
        if max(lq.shape[1:3]) > self.chop_size:
            raise ValueError(f"a {h}x{w} input is chopped (chop size {self.chop_size}); this "
                             f"sampler takes one tile")
        return lq, mask, generator, (slice(None), slice(0, h * self.sf), slice(0, w * self.sf))

    def _spread(self, devices: list[torch.device]):
        """A denoiser call that cuts its batch (and its conditioning) into
        len(devices) parts, runs each on its own replica (`_replicas`), one
        after another, and gathers the outputs on the pipeline's device."""
        replicas = [(d, self._compute_params(d, s)[0]) for d, s in _replicas(devices)]

        def model_fn(x, t, **kw):
            n = len(devices)
            xs, ts = torch.tensor_split(x, n), torch.tensor_split(t, n)
            kws = [{k: v for k, v in zip(kw, vals)}
                   for vals in zip(*(torch.tensor_split(v, n) for v in kw.values()))] or [{}] * n
            outs = [unet(xp.to(d), tp.to(d), **{k: v.to(d) for k, v in kp.items()})
                    for (d, unet), xp, tp, kp in zip(replicas, xs, ts, kws)]
            return torch.cat([o.to(x.device) for o in outs])

        return model_fn

    @torch.no_grad()
    def sample_time_parallel(self, lq: torch.Tensor, generator: torch.Generator | None = None,
                             mask: torch.Tensor | None = None, *,
                             sweeps: int | None = None,
                             devices: list | None = None) -> torch.Tensor:
        """`sample` with the reverse chain run as Picard sweeps
        (`rs.sample_loop_parallel`): the UNet runs `sweeps` times on a
        (T*B) batch instead of T times on B.  The draws are taken as
        `sample` takes them, so `sweeps` = T gives `sample`'s result with
        the same seed; the default is T // 3.  The input must fit one tile.
        With two or more `devices` each sweep's (T*B) batch is cut over
        them, one part a replica (`_spread`), and gathered back; the
        encode, the decode and the chain's update stay on the pipeline's
        device."""
        lq, mask, generator, crop = self._one_tile(lq, generator, mask)
        unet, vq = self._compute_params()
        z_y = self._encode(vq, lq)
        shard_fn = (None if devices is None or len(devices) < 2
                    else self._spread([torch.device(d) for d in devices]))
        z0 = rs.sample_loop_parallel(self.sched, unet, z_y, generator, sweeps=sweeps,
                                     clip_denoised=vq is None,
                                     model_kwargs=self._cond_kwargs(unet, lq, mask),
                                     shard_fn=shard_fn)
        return self._decode(vq, z0).clamp(-1.0, 1.0)[crop]

    @torch.no_grad()
    def sample_progressive(self, lq: torch.Tensor, generator: torch.Generator | None = None,
                           mask: torch.Tensor | None = None):
        """`sample` that also returns the strip of every step's x0
        prediction, decoded and clamped: (final (B, H*sf, W*sf, C), strip
        (T, B, H*sf, W*sf, C)).  The input must fit one tile."""
        lq, mask, generator, crop = self._one_tile(lq, generator, mask)
        unet, vq = self._compute_params()
        z_y = self._encode(vq, lq)
        z0, _, preds = rs.sample_loop_progressive(
            self.sched, unet, z_y, generator, clip_denoised=vq is None,
            model_kwargs=self._cond_kwargs(unet, lq, mask))
        final = self._decode(vq, z0).clamp(-1.0, 1.0)[crop]
        strip = torch.stack([self._decode(vq, z).clamp(-1.0, 1.0)[crop] for z in preds])
        return final, strip

    @torch.no_grad()
    def sample(self, lq: torch.Tensor, generator: torch.Generator | None = None,
               mask: torch.Tensor | None = None, *, noise_repeat: bool = False,
               chop_size: int | None = None, chop_stride: int | None = None,
               tile_bs: int = 1, draws: tuple | None = None) -> torch.Tensor:
        """SR / restore a batch of LQ images, (B, H, W, 3) in [-1, 1] ->
        (B, H*sf, W*sf, 3).  `mask` (B, H, W, 1) in [-1, 1] is the
        inpainting mask (1 where the image is to be filled), for the models
        with `cond_mask`.  Noise comes from `generator` (a fresh one seeded
        0 on the pipeline's device when None), or is `draws`, as
        `chain_draws` gives them for the same arguments."""
        if generator is None and draws is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        lq = lq.to(self.device, torch.float32)
        if mask is not None:
            mask = mask.to(self.device, torch.float32)
        return self._sample_padded(lq, generator, mask, noise_repeat,
                                   chop_size or self.chop_size, chop_stride or self.chop_stride,
                                   tile_bs, draws)

    def _inputs(self, lq, mask, generator, devices):
        """The sharded samplers' inputs on the pipeline's device, their
        generator and their cards (this process's own by default)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        devices = local_devices() if devices is None else [torch.device(d) for d in devices]
        lq = lq.to(self.device, torch.float32)
        mask = None if mask is None else mask.to(self.device, torch.float32)
        return lq, mask, generator, devices

    def _tiled(self, lq, mask, generator, draws, noise_repeat, chop_size, chop_stride,
               tile_bs):
        """The set-up of the samplers that deal out tiles: `lq` and `mask` on
        the pipeline's device, padded as `sample` pads them and cut by its
        grid (the padded images where it does not tile), and the draws of
        `sample(..., tile_bs=tile_bs)` (every tile in one batch where
        `tile_bs` is None): `draws`, else taken from `generator` (a fresh
        one seeded 0 on the pipeline's device when None).  Returns (tiles,
        mask tiles or None, noise, eps, the grid or None, finish); `finish`
        gathers the tiles' outputs into the images and crops them."""
        if generator is None and draws is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        lq = lq.to(self.device, torch.float32)
        mask = None if mask is None else mask.to(self.device, torch.float32)
        b, h, w, _ = lq.shape
        lqp, maskp = self._pad(lq, mask, chop_size)
        grid, _, _ = self._chunks(b, *lqp.shape[1:3], chop_size, chop_stride, 1)
        tiles = lqp if grid is None else grid.split(lqp)
        mtiles = maskp if grid is None or maskp is None else grid.split(maskp)
        noise, eps = draws or self.chain_draws(lq.shape, generator, noise_repeat=noise_repeat,
                                               chop_size=chop_size, chop_stride=chop_stride,
                                               tile_bs=tile_bs or tiles.shape[0])

        def finish(out):
            out = out if grid is None else grid.gather(out, b)
            return out[:, :h * self.sf, :w * self.sf, :]

        return tiles, mtiles, noise, eps, grid, finish

    @torch.no_grad()
    def sample_batch_sharded(self, lq: torch.Tensor, generator: torch.Generator | None = None,
                             devices: list | None = None, mask: torch.Tensor | None = None, *,
                             noise_repeat: bool = False, chop_size: int | None = None,
                             chop_stride: int | None = None, tile_bs: int = 1) -> torch.Tensor:
        """`sample` with the image batch split over `devices` (this process's
        cards by default): the batch is padded to a multiple of their count
        by repeating the last image, and cropped back.  The whole padded
        batch's draws are taken from `generator` as `sample` would take them
        (`chain_draws`) and each card gets its images' rows, so that each
        shard is `sample` of its images with those draws, and the result is
        `sample`'s up to the rounding of a smaller batch.  Each entry of
        `devices` is a replica of its own (`_replicas`: a card listed twice
        holds two); the shards run one after another on this thread, each
        launching on its card while the cards before it compute."""
        lq, mask, generator, devices = self._inputs(lq, mask, generator, devices)
        chop_size, chop_stride = chop_size or self.chop_size, chop_stride or self.chop_stride
        b, n = lq.shape[0], len(devices)
        pad = (-b) % n
        if pad:
            lq = torch.cat([lq, lq[-1:].expand(pad, *lq.shape[1:])])
            if mask is not None:
                mask = torch.cat([mask, mask[-1:].expand(pad, *mask.shape[1:])])
        noise, eps = self.chain_draws(lq.shape, generator, noise_repeat=noise_repeat,
                                      chop_size=chop_size, chop_stride=chop_stride,
                                      tile_bs=tile_bs)
        per, big = lq.shape[0] // n, lq.shape[0]
        n_tiles = noise.shape[0] // big  # tile-major rows: tile j of image i is j * big + i
        outs = []
        for s, (dev, slot) in enumerate(_replicas(devices)):
            rows = (torch.arange(n_tiles)[:, None] * big + s * per
                    + torch.arange(per)[None]).reshape(-1).to(noise.device)
            part = slice(s * per, (s + 1) * per)
            outs.append(self._sample_padded(
                lq[part].to(dev), None, None if mask is None else mask[part].to(dev),
                noise_repeat, chop_size, chop_stride, tile_bs,
                draws=(noise[rows].to(dev), eps[:, rows].to(dev)), slot=slot))
        return torch.cat([o.to(self.device) for o in outs])[:b]

    @torch.no_grad()
    def sample_tiles_sharded(self, lq: torch.Tensor, generator: torch.Generator | None = None,
                             devices: list | None = None, mask: torch.Tensor | None = None, *,
                             chop_size: int | None = None,
                             chop_stride: int | None = None) -> torch.Tensor:
        """`sample(..., tile_bs=<every tile>)` with the tile batch split over
        `devices` (this process's cards by default): the input is padded as
        `sample` pads it and cut by the same grid, the tile count padded to a
        multiple of the cards' by repeating the first tiles, each card
        samples its tiles with their rows of the draws `sample` would take
        (`chain_draws`), and the overlap gather runs on the pipeline's
        device.  The result is `sample`'s up to the rounding of a smaller
        batch; the replicas and the order of the shards are
        `sample_batch_sharded`'s."""
        lq, mask, generator, devices = self._inputs(lq, mask, generator, devices)
        tiles, mtiles, noise, eps, _, finish = self._tiled(
            lq, mask, generator, None, False, chop_size or self.chop_size,
            chop_stride or self.chop_stride, None)
        t_total, n = tiles.shape[0], len(devices)
        pad = (-t_total) % n
        if pad:
            rep = lambda t, dim=0: torch.cat([t, t.narrow(dim, 0, pad)], dim=dim)
            tiles, noise, eps = rep(tiles), rep(noise), rep(eps, 1)
            mtiles = None if mtiles is None else rep(mtiles)
        per = tiles.shape[0] // n
        outs = []
        for s, (dev, slot) in enumerate(_replicas(devices)):
            part = slice(s * per, (s + 1) * per)
            outs.append(self._sample_tile(
                tiles[part].to(dev), None, None if mtiles is None else mtiles[part].to(dev),
                noise=noise[part].to(dev), step_noise=eps[:, part].to(dev), slot=slot))
        return finish(torch.cat([o.to(self.device) for o in outs])[:t_total])

    # ------------------------------------------------- tensor / pipeline

    def _tp_models(self, group) -> tuple:
        """This rank's tensor-parallel clones of the compute models
        (`tp.tp_clone`) for `group`, made once and dropped with the
        replicas whenever the weights change."""
        from .parallel import tp

        unet, vq = self._compute_params()
        ranks = None if group is None else tuple(torch.distributed.get_process_group_ranks(group))
        key = ("tp", ranks, _card(self.device))
        if key not in self._compute:
            self._compute[key] = (tp.tp_clone(unet, group),
                                  None if vq is None else tp.tp_clone(vq, group))
        return self._compute[key]

    @torch.no_grad()
    def sample_tp(self, lq: torch.Tensor, generator: torch.Generator | None = None,
                  mask: torch.Tensor | None = None, *, noise_repeat: bool = False,
                  chop_size: int | None = None, chop_stride: int | None = None,
                  data: int = 1, draws: tuple | None = None) -> torch.Tensor:
        """`sample` with the models' weights split over the ranks of the
        process group (parallel/tp.py), for the latency of one request.
        Every rank calls it with the same inputs and the same generator (or
        `draws`) and returns the same image.  `data` > 1 splits the world
        into `data` tensor-parallel groups of world // data consecutive
        ranks (DP x TP): an untiled batch is padded to a multiple of `data`
        by repeating its last image and each group samples its rows; a
        tiled input's tiles are wrap-padded to a multiple of `data` and
        walked in chunks of `data` tiles, one a group, as the JAX package
        walks them.  The draws are `sample`'s (`chain_draws`, at `tile_bs =
        data` where it tiles, the padding's rows repeating real ones), so
        the result is `sample(..., tile_bs=data)`'s on the same draws up to
        the order of the split sums."""
        from .parallel import tp

        if self.variant != "resshift":
            raise NotImplementedError("this sampler runs the residual-shifting chain only")
        group, g, size = tp.tp_groups(data)
        tiles, mtiles, noise, eps, grid, finish = self._tiled(
            lq, mask, generator, draws, noise_repeat, chop_size or self.chop_size,
            chop_stride or self.chop_stride, data)
        models = self._tp_models(group)
        n = tiles.shape[0]
        # the padding repeats the last image, or wraps round to the first tiles
        idx = (torch.arange(n + (-n) % data) % n if grid is not None
               else torch.arange(n + (-n) % data).clamp(max=n - 1))

        def run(rows):
            rows = rows.to(tiles.device)
            return self._sample_tile(tiles[rows], None,
                                     None if mtiles is None else mtiles[rows], noise_repeat,
                                     noise=noise[rows.to(noise.device)].to(tiles.device),
                                     step_noise=eps[:, rows.to(eps.device)].to(tiles.device),
                                     models=models)

        if grid is None:  # group g samples its rows at once
            per = len(idx) // data
            out = run(idx[g * per:(g + 1) * per])
        else:  # chunks of `data` tiles, tile g of each for group g
            out = torch.cat([run(idx[c + g:c + g + 1]) for c in range(0, len(idx), data)])
        if data > 1:  # each group's result from its first rank, in group order
            every = tp.all_gather(out, 0).unflatten(0, (-1, out.shape[0]))[::size]
            out = (every.reshape(-1, *out.shape[1:]) if grid is None
                   else every.transpose(0, 1).reshape(-1, *out.shape[1:]))
        return finish(out[:n])

    @torch.no_grad()
    def sample_pipelined(self, lq: torch.Tensor, generator: torch.Generator | None = None,
                         devices: list | None = None, mask: torch.Tensor | None = None, *,
                         noise_repeat: bool = False, chop_size: int | None = None,
                         chop_stride: int | None = None, chunk_bs: int = 1,
                         draws: tuple | None = None) -> torch.Tensor:
        """`sample(..., tile_bs=chunk_bs)` with the reverse chain staged over
        `devices` (this process's cards by default; parallel/pp.py): chunks
        of `chunk_bs` tiles (of images where the input is not tiled) stream
        through the stages; stage 0 encodes a chunk and draws its prior
        from its noise, each stage runs its slice of the steps
        (`pp.stage_slices`), the last decodes.  Each entry of `devices` is a
        replica of its own (`_replicas`), which launches the kernels as
        `sample` does; a row of devices for a stage (a 2-D `devices`, rows =
        stages) splits each chunk over the row's replicas (PP x DP).  The
        draws are `sample(..., tile_bs=chunk_bs)`'s (`chain_draws`, or
        `draws`), so the result is that call's up to the rounding of the
        smaller batches that a row or an untiled batch cut in chunks runs."""
        from .parallel import pp

        if self.variant != "resshift":
            raise NotImplementedError("this sampler runs the residual-shifting chain only")
        grid_devs = pp.stage_grid(devices)
        tiles, mtiles, noise, eps, _, finish = self._tiled(
            lq, mask, generator, draws, noise_repeat, chop_size or self.chop_size,
            chop_stride or self.chop_stride, chunk_bs)
        cb = max(1, min(int(chunk_bs), tiles.shape[0]))
        chunks = [torch.arange(i, min(i + cb, tiles.shape[0]))
                  for i in range(0, tiles.shape[0], cb)]
        n_parts = len(grid_devs[0])
        slots = iter(_replicas([d for row in grid_devs for d in row]))
        models = [[self._compute_params(*next(slots)) for _ in row] for row in grid_devs]
        starts, counts = pp.stage_slices(self.sched.num_timesteps, len(grid_devs))
        clip = self.vq is None

        def ingest(c, d, dev):
            rows = torch.tensor_split(chunks[c], n_parts)[d]
            if not len(rows):
                return None
            unet, vq = models[0][d]
            x_lq = tiles[rows.to(tiles.device)].to(dev)
            m = None if mtiles is None else mtiles[rows.to(tiles.device)].to(dev)
            z_y = self._encode(vq, x_lq)
            x = rs.prior_sample(self._schedule(dev), z_y, noise[rows.to(noise.device)].to(dev))
            return {"x": x, "y": z_y, "eps": eps[:, rows.to(eps.device)].to(dev),
                    "cond": self._cond_kwargs(unet, x_lq, m)}

        def work(s, d, dev, p):
            steps = range(starts[s], starts[s] - counts[s], -1)
            x = rs.run_steps(self._schedule(dev), models[s][d][0], p["x"], p["y"], steps,
                             p["eps"], clip_denoised=clip, model_kwargs=p["cond"])
            return {**p, "x": x}

        def emit(c, d, dev, p):
            return self._decode(models[-1][d][1], p["x"]).clamp(-1.0, 1.0).to(self.device)

        outs = pp.pipeline_stream(grid_devs, len(chunks), ingest, work, emit)
        return finish(torch.cat([o for parts in outs for o in parts if o is not None]))

