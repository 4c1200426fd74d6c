"""Residual-shifting diffusion schedule.

Host float64 numpy construction (the exponential eta schedule, the
posterior coefficients from eta differences, respacing as a gather over
`timestep_map`), then float32 torch tensors on the caller's device.  The
same math as the JAX package's schedule, kept as a numpy copy because that
module imports jax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

__all__ = ["Schedule", "exponential_sqrt_etas", "linear_betas", "space_timesteps",
           "build_schedule"]


def exponential_sqrt_etas(steps: int, min_noise_level: float, etas_end: float = 0.99,
                          kappa: float = 1.0, power: float = 0.3) -> np.ndarray:
    """sqrt_eta[t] = base**(linspace(0,1,T)**power * (T-1)) * eta_start, with
    base chosen so that sqrt_eta[T-1] == etas_end."""
    etas_start = min(min_noise_level / kappa, min_noise_level)
    increaser = math.exp(1.0 / (steps - 1) * math.log(etas_end / etas_start))
    base = np.ones((steps,), dtype=np.float64) * increaser
    power_timestep = np.linspace(0.0, 1.0, steps, endpoint=True, dtype=np.float64) ** power
    power_timestep *= steps - 1
    return np.power(base, power_timestep) * etas_start


def linear_betas(steps: int, beta_start: float, beta_end: float) -> np.ndarray:
    """The classic DDPM betas, linear in sqrt(beta)."""
    return np.linspace(beta_start**0.5, beta_end**0.5, steps, dtype=np.float64) ** 2


def space_timesteps(num_timesteps: int, section_counts: int | str | Sequence[int]) -> list[int]:
    """Retained original-timestep indices for respacing: an int N, "ddimN",
    or per-section counts ("a,b,c" or a sequence)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            want = int(section_counts[4:])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == want:
                    return sorted(range(0, num_timesteps, stride))
            raise ValueError(f"no stride gives exactly {want} of {num_timesteps} steps")
        section_counts = [int(x) for x in section_counts.split(",")]
    elif isinstance(section_counts, int):
        section_counts = [section_counts]
    base, extra = divmod(num_timesteps, len(section_counts))
    kept: set[int] = set()
    start = 0
    for i, count in enumerate(section_counts):
        size = base + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"section of {size} steps cannot keep {count}")
        stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        kept.update(start + round(stride * j) for j in range(count))
        start += size
    return sorted(kept)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-timestep diffusion constants as float32 tensors (int64 for
    `timestep_map`), plus static metadata.  `host` keeps the float64 numpy
    arrays the tensors were made from."""

    sqrt_etas: torch.Tensor
    etas: torch.Tensor
    etas_prev: torch.Tensor
    alpha: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_variance_clipped: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    weight_loss_mse: torch.Tensor
    timestep_map: torch.Tensor
    host: dict
    kappa: float = 1.0
    num_timesteps: int = 15
    model_mean_type: str = "xstart"
    normalize_input: bool = True
    latent_flag: bool = True
    scale_factor: float = 1.0
    sf: int = 4


def build_schedule(*, schedule_name: str = "exponential", steps: int = 15,
                   min_noise_level: float = 0.04, etas_end: float = 0.99,
                   kappa: float = 2.0, power: float = 0.3, predict_type: str = "xstart",
                   timestep_respacing=None, normalize_input: bool = True,
                   latent_flag: bool = True, scale_factor: float = 1.0, sf: int = 4,
                   sqrt_etas: Sequence[float] | None = None,
                   device: str | torch.device = "cpu") -> Schedule:
    """The full schedule: float64 host math, float32 tensors on `device`."""
    if sqrt_etas is not None:
        sqrt_etas = np.asarray(sqrt_etas, dtype=np.float64)
    elif schedule_name == "exponential":
        sqrt_etas = exponential_sqrt_etas(steps, min_noise_level, etas_end, kappa, power)
    else:
        raise ValueError(f"unknown schedule_name: {schedule_name}")

    if timestep_respacing is None:
        timestep_map = np.arange(steps, dtype=np.int64)
    else:
        timestep_map = np.asarray(space_timesteps(steps, timestep_respacing), dtype=np.int64)
    sqrt_etas = sqrt_etas[timestep_map]

    etas = sqrt_etas**2
    if not ((etas > 0).all() and (etas <= 1).all()):
        raise ValueError("etas must lie in (0, 1]")
    etas_prev = np.append(0.0, etas[:-1])
    alpha = etas - etas_prev
    posterior_variance = kappa**2 * etas_prev / etas * alpha
    posterior_variance_clipped = np.append(posterior_variance[1], posterior_variance[1:])
    if predict_type in ("xstart", "residual"):
        weight_loss_mse = 0.5 / posterior_variance_clipped * (alpha / etas) ** 2
    elif predict_type in ("epsilon", "epsilon_scale"):
        weight_loss_mse = (0.5 / posterior_variance_clipped
                           * (kappa * alpha / ((1 - etas) * sqrt_etas)) ** 2)
    else:
        raise ValueError(f"unknown predict_type: {predict_type}")
    host = dict(
        sqrt_etas=sqrt_etas, etas=etas, etas_prev=etas_prev, alpha=alpha,
        posterior_variance=posterior_variance,
        posterior_variance_clipped=posterior_variance_clipped,
        posterior_log_variance_clipped=np.log(posterior_variance_clipped),
        posterior_mean_coef1=etas_prev / etas,
        posterior_mean_coef2=alpha / etas,
        weight_loss_mse=weight_loss_mse,
    )
    tensors = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in host.items()}
    return Schedule(
        **tensors,
        timestep_map=torch.as_tensor(timestep_map, device=device),
        host=host,
        kappa=float(kappa),
        num_timesteps=int(len(timestep_map)),
        model_mean_type=predict_type,
        normalize_input=bool(normalize_input),
        latent_flag=bool(latent_flag),
        scale_factor=float(scale_factor),
        sf=int(sf),
    )
