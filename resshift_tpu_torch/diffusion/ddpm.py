"""Classic DDPM and DDIM on torch tensors (NHWC): the ablation variant.

A `DDPMSchedule` (linear-in-sqrt betas, respaced through cumulative-product
ratios), the forward draw `q_sample`, the model posterior, and the two
reverse chains from pure noise: ancestral (`p_sample_loop`) and DDIM
(`ddim_sample_loop`).  As in the JAX package, the ancestral chain uses the
clipped posterior variance (FIXED_SMALL).

The chains are Python loops over t = T-1 .. 0.  Gaussian draws come from
an explicit `torch.Generator` (x_T first, then one draw per step), or are
passed in as `noise=` (x_T) and `step_noise=` (T, B, ...; step_noise[i]
at t = T-1-i), so that a test can feed both packages the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .resshift import _extract as _ex
from .resshift import _t_vec
from .schedule import linear_betas, space_timesteps

__all__ = ["DDPMSchedule", "build_ddpm_schedule", "q_sample", "predict_xstart_from_eps",
           "predict_eps_from_xstart", "p_mean_variance", "p_sample_loop", "ddim_sample_loop",
           "training_losses"]

ModelFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Per-timestep constants as float32 tensors (int64 `timestep_map`)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    timestep_map: torch.Tensor
    num_timesteps: int = 1000
    model_mean_type: str = "epsilon"  # epsilon | xstart
    scale_factor: float = 1.0
    sf: int = 4


def build_ddpm_schedule(*, steps: int = 1000, beta_start: float = 0.0001,
                        beta_end: float = 0.02, predict_xstart: bool = False,
                        timestep_respacing: int | str | list | None = None,
                        scale_factor: float = 1.0, sf: int = 4,
                        device: str | torch.device = "cpu") -> DDPMSchedule:
    """Float64 host math, float32 tensors on `device`."""
    betas = linear_betas(steps, beta_start, beta_end)
    if timestep_respacing is None:
        tmap = np.arange(steps, dtype=np.int64)
        new_betas = betas
    else:  # respaced betas from the ratios of the kept cumulative products
        keep = set(space_timesteps(steps, timestep_respacing))
        acp = np.cumprod(1.0 - betas)
        last, new_betas, tmap = 1.0, [], []
        for i, a in enumerate(acp):
            if i in keep:
                new_betas.append(1 - a / last)
                last = a
                tmap.append(i)
        new_betas = np.asarray(new_betas)
        tmap = np.asarray(tmap, np.int64)

    alphas = 1.0 - new_betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    acp_next = np.append(acp[1:], 0.0)
    post_var = new_betas * (1.0 - acp_prev) / (1.0 - acp)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return DDPMSchedule(
        betas=f32(new_betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        alphas_cumprod_next=f32(acp_next),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1)),
        posterior_variance=f32(post_var),
        posterior_log_variance_clipped=f32(np.log(np.append(post_var[1], post_var[1:]))),
        posterior_mean_coef1=f32(new_betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        timestep_map=torch.as_tensor(tmap, device=device),
        num_timesteps=len(tmap),
        model_mean_type="xstart" if predict_xstart else "epsilon",
        scale_factor=float(scale_factor),
        sf=int(sf),
    )


def q_sample(s: DDPMSchedule, x0, t, noise):
    nd = x0.ndim
    return (_ex(s.sqrt_alphas_cumprod, t, nd) * x0
            + _ex(s.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def predict_xstart_from_eps(s: DDPMSchedule, x_t, t, eps):
    nd = x_t.ndim
    return (_ex(s.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - _ex(s.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def predict_eps_from_xstart(s: DDPMSchedule, x_t, t, x0):
    nd = x_t.ndim
    return ((_ex(s.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0)
            / _ex(s.sqrt_recipm1_alphas_cumprod, t, nd))


def p_mean_variance(s: DDPMSchedule, model_fn: ModelFn, x_t, t, *, clip_denoised: bool = True,
                    model_kwargs: dict[str, Any] | None = None):
    """(mean, log variance, x0 prediction) of p(x_{t-1} | x_t); `t` is an int
    or a [B] vector of respaced steps."""
    t_vec = _t_vec(t, x_t)
    out = model_fn(x_t, s.timestep_map[t_vec], **(model_kwargs or {})).float()
    x0 = predict_xstart_from_eps(s, x_t, t_vec, out) if s.model_mean_type == "epsilon" else out
    if clip_denoised:
        x0 = x0.clamp(-1.0, 1.0)
    nd = x_t.ndim
    mean = (_ex(s.posterior_mean_coef1, t_vec, nd) * x0
            + _ex(s.posterior_mean_coef2, t_vec, nd) * x_t)
    return mean, _ex(s.posterior_log_variance_clipped, t_vec, nd), x0


def _draws(shape, generator, noise, step_noise, device):
    """x_T and a function giving step i's draw, from the arguments or the
    generator (x_T first, then step by step)."""
    if noise is None:
        noise = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    if step_noise is not None:
        return noise, lambda i: step_noise[i]
    return noise, lambda i: torch.randn(shape, generator=generator, dtype=torch.float32,
                                        device=device)


def p_sample_loop(s: DDPMSchedule, model_fn: ModelFn, shape, generator=None, *,
                  noise: torch.Tensor | None = None, step_noise: torch.Tensor | None = None,
                  clip_denoised: bool = True, model_kwargs: dict[str, Any] | None = None,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """Ancestral sampling from pure noise of `shape`; returns x_0."""
    x, draw = _draws(shape, generator, noise, step_noise, device)
    for i, t in enumerate(range(s.num_timesteps - 1, -1, -1)):
        mean, logvar, _ = p_mean_variance(s, model_fn, x, t, clip_denoised=clip_denoised,
                                          model_kwargs=model_kwargs)
        eps = draw(i)
        x = mean + torch.exp(0.5 * logvar) * eps if t != 0 else mean
    return x


def ddim_sample_loop(s: DDPMSchedule, model_fn: ModelFn, shape, generator=None, *,
                     eta: float = 0.0, noise: torch.Tensor | None = None,
                     step_noise: torch.Tensor | None = None, clip_denoised: bool = True,
                     model_kwargs: dict[str, Any] | None = None,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    """DDIM sampling from pure noise of `shape` (`eta` 0: deterministic
    after x_T); returns x_0."""
    x, draw = _draws(shape, generator, noise, step_noise, device)
    for i, t in enumerate(range(s.num_timesteps - 1, -1, -1)):
        _, _, x0 = p_mean_variance(s, model_fn, x, t, clip_denoised=clip_denoised,
                                   model_kwargs=model_kwargs)
        t_vec = _t_vec(t, x)
        eps = predict_eps_from_xstart(s, x, t_vec, x0)
        nd = x.ndim
        ab = _ex(s.alphas_cumprod, t_vec, nd)
        ab_prev = _ex(s.alphas_cumprod_prev, t_vec, nd)
        sigma = eta * torch.sqrt((1 - ab_prev) / (1 - ab)) * torch.sqrt(1 - ab / ab_prev)
        noise_t = draw(i)
        x = x0 * torch.sqrt(ab_prev) + torch.sqrt(1 - ab_prev - sigma**2) * eps
        if t != 0:
            x = x + sigma * noise_t
    return x


def training_losses(s: DDPMSchedule, model_fn: ModelFn, x0, t, noise, *,
                    model_kwargs: dict[str, Any] | None = None) -> torch.Tensor:
    """Simple-loss DDPM training: per-sample MSE on eps or x0."""
    x_t = q_sample(s, x0, t, noise)
    out = model_fn(x_t, s.timestep_map[t], **(model_kwargs or {})).float()
    target = noise if s.model_mean_type == "epsilon" else x0
    return ((target - out) ** 2).mean(dim=tuple(range(1, x0.ndim)))
