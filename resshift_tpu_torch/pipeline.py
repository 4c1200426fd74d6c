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

The pipeline runs on CUDA unless the caller passes `device="cpu"`; without
CUDA and without that argument it raises.  Images are NHWC float32 in
[-1, 1].
"""

from __future__ import annotations

import copy
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

__all__ = ["ResShiftPipeline", "load_pth", "resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`None` means CUDA, which must then be present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU")
    return device


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
        self._compute = None

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

    def _compute_params(self) -> tuple[nn.Module, nn.Module | None]:
        """Copies of the models with every conv and linear weight cast to the
        compute dtype once, except the UNet head conv (`out.2`), which runs
        in float32; GroupNorm, the rel-pos tables and the codebook stay f32."""
        if self._compute is None:
            if self.dtype == torch.float32:
                self._compute = (self.unet, self.vq)
            else:
                def cast(mod):
                    mod = copy.deepcopy(mod)
                    for name, sub in mod.named_modules():
                        if isinstance(sub, (nn.Conv2d, nn.Linear)) and name != "out.2":
                            sub.to(self.dtype)
                    return mod

                self._compute = (cast(self.unet), None if self.vq is None else cast(self.vq))
        return self._compute

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

    def _ddpm_chain(self, unet, lq, generator, model_kwargs, noise, step_noise):
        """The DDPM or DDIM chain from pure noise at the latent shape."""
        b, h, w, _ = lq.shape
        shape = (b, h * self.sf // self.f, w * self.sf // self.f,
                 self.config["model"].get("in_channels", 3))
        kw = dict(noise=noise, step_noise=step_noise, clip_denoised=self.vq is None,
                  model_kwargs=model_kwargs, device=self.device)
        if self.ddpm_sampler == "ddim":
            return ddpm.ddim_sample_loop(self.sched, unet, shape, generator, eta=self.ddpm_eta,
                                         **kw)
        return ddpm.p_sample_loop(self.sched, unet, shape, generator, **kw)

    @torch.no_grad()
    def _sample_tile(self, lq: torch.Tensor, generator: torch.Generator | None, mask=None,
                     noise_repeat: bool = False, noise: torch.Tensor | None = None,
                     step_noise: torch.Tensor | None = None) -> torch.Tensor:
        """One (padded) tile batch.  `noise` / `step_noise` fix the Gaussian
        draws as the chain takes them; otherwise they come from
        `generator`, the prior (or x_T) draw first."""
        unet, vq = self._compute_params()
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
        z0 = rs.sample_loop(self.sched, unet, z_y, generator, noise=noise,
                            clip_denoised=vq is None,
                            model_kwargs=self._cond_kwargs(unet, lq, mask),
                            noise_repeat=noise_repeat, step_noise=step_noise)
        return self._decode(vq, z0).clamp(-1.0, 1.0)

    def _pad(self, lq, mask, chop_size):
        """Reflect-pad `lq` (and `mask`) to a multiple of the padding offset;
        a side that stays within `chop_size` (not tiled) on to a multiple of
        `lq_multiple`.  Returns the padded pair."""
        _, h, w, _ = lq.shape
        offset, mult = self.padding_offset, self.lq_multiple

        def padded(n):
            p = math.ceil(n / offset) * offset
            return math.ceil(n / mult) * mult if p <= chop_size and p % mult else p

        hp, wp = padded(h), padded(w)

        def pad(t):
            t = t.permute(0, 3, 1, 2)
            while t.shape[2] < hp or t.shape[3] < wp:
                if min(t.shape[2:]) < 2:
                    raise ValueError(f"cannot reflect-pad a {h}x{w} input to {hp}x{wp}")
                t = F.pad(t, (0, min(wp - t.shape[3], t.shape[3] - 1), 0,
                              min(hp - t.shape[2], t.shape[2] - 1)), mode="reflect")
            return t.permute(0, 2, 3, 1)

        return pad(lq), None if mask is None else pad(mask)

    def _sample_padded(self, lq, generator, mask, noise_repeat, chop_size, chop_stride,
                       tile_bs):
        """Pad -> (maybe tile) -> sample -> crop.  A side longer than the
        chop size is cut into chop-sized tiles; a shorter one stays whole
        and is padded on to a multiple of `lq_multiple`."""
        b, h, w, c = lq.shape
        lq, mask = self._pad(lq, mask, chop_size)
        hp, wp = lq.shape[1:3]
        if hp <= chop_size and wp <= chop_size:
            out = self._sample_tile(lq, generator, mask, noise_repeat)
        else:
            grid = TileGrid(hp, wp, chop_size, chop_stride, sf=self.sf)
            tiles = grid.split(lq)
            mtiles = None if mask is None else grid.split(mask)
            t_total = grid.num_tiles * b
            tile_bs = max(1, min(int(tile_bs), t_total))
            outs = []
            for i in range(0, t_total, tile_bs):
                sl = slice(i, i + tile_bs)
                outs.append(self._sample_tile(tiles[sl], generator,
                                              None if mtiles is None else mtiles[sl],
                                              noise_repeat))
            out = grid.gather(torch.cat(outs, dim=0), b)
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

    @torch.no_grad()
    def sample_time_parallel(self, lq: torch.Tensor, generator: torch.Generator | None = None,
                             mask: torch.Tensor | None = None, *,
                             sweeps: int | None = None) -> torch.Tensor:
        """`sample` with the reverse chain run as Picard sweeps
        (`rs.sample_loop_parallel`): the UNet runs `sweeps` times on a
        (T*B) batch instead of T times on B.  The draws are taken as
        `sample` takes them, so `sweeps` = T gives `sample`'s result with
        the same seed; the default is T // 3.  The input must fit one tile."""
        lq, mask, generator, crop = self._one_tile(lq, generator, mask)
        unet, vq = self._compute_params()
        z_y = self._encode(vq, lq)
        z0 = rs.sample_loop_parallel(self.sched, unet, z_y, generator, sweeps=sweeps,
                                     clip_denoised=vq is None,
                                     model_kwargs=self._cond_kwargs(unet, lq, mask))
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
               tile_bs: int = 1) -> torch.Tensor:
        """SR / restore a batch of LQ images, (B, H, W, 3) in [-1, 1] ->
        (B, H*sf, W*sf, 3).  `mask` (B, H, W, 1) in [-1, 1] is the
        inpainting mask (1 where the image is to be filled), for the models
        with `cond_mask`.  Noise comes from `generator` (a fresh one seeded
        0 on the pipeline's device when None)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        lq = lq.to(self.device, torch.float32)
        if mask is not None:
            mask = mask.to(self.device, torch.float32)
        return self._sample_padded(lq, generator, mask, noise_repeat,
                                   chop_size or self.chop_size, chop_stride or self.chop_stride,
                                   tile_bs)
