"""Likelihood helpers and timestep samplers (the port's own copy of the
JAX package's `diffusion/losses.py`).

`normal_kl` and `discretized_gaussian_log_likelihood` are elementwise on
tensors; `UniformSampler` and `LossSecondMomentResampler` draw timesteps
from an explicit `torch.Generator`.  The resampler's loss history lives on
the host (numpy); feed each batch's (t, loss) back with `update` (several
processes gather theirs first).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["normal_kl", "approx_standard_normal_cdf", "discretized_gaussian_log_likelihood",
           "UniformSampler", "LossSecondMomentResampler"]


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2) of diagonal Gaussians, elementwise."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of 8-bit data in [-1, 1] under a Gaussian: the CDF
    difference over the +-1/255 bin, one-sided at the ends."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_delta))


class UniformSampler:
    """t ~ U[0, T) with unit weights."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: torch.Generator | None, batch: int,
               device: str | torch.device = "cpu"):
        t = torch.randint(0, self.num_timesteps, (batch,), generator=generator, device=device)
        return t, torch.ones(batch, device=device)


class LossSecondMomentResampler:
    """Timesteps drawn in proportion to the root mean square of their recent
    losses (once every step has `history_per_term` of them; uniform until
    then), mixed with `uniform_prob` of the uniform law."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._history = np.zeros((num_timesteps, history_per_term), np.float64)
        self._counts = np.zeros((num_timesteps,), np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones((self.num_timesteps,), np.float64) / self.num_timesteps
        w = np.sqrt(np.mean(self._history**2, axis=-1))
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / len(w)

    def sample(self, generator: torch.Generator | None, batch: int,
               device: str | torch.device = "cpu"):
        w = torch.as_tensor(self.weights(), dtype=torch.float32, device=device)
        t = torch.multinomial(w, batch, replacement=True, generator=generator)
        return t, 1.0 / (self.num_timesteps * w[t])

    def update(self, ts, losses) -> None:
        """Record per-sample losses at their timesteps."""
        for t, loss in zip(np.asarray(ts).ravel(), np.asarray(losses).ravel()):
            if self._counts[t] == self.history_per_term:
                self._history[t, :-1] = self._history[t, 1:]
                self._history[t, -1] = loss
            else:
                self._history[t, self._counts[t]] = loss
                self._counts[t] += 1
