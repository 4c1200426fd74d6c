"""Host-side degradation kernel synthesis (numpy).

Per-sample random blur kernels for the RealESRGAN pipeline — parity with
`basicsr/data/degradations.py`: bivariate (generalized / plateau) Gaussian
kernels (:84-174), random mixed kernel sampling (:324-387), and the
circular sinc low-pass kernel via Bessel J1 (:389-417).

All randomness flows through an explicit `np.random.Generator`, giving
reproducible, per-worker-foldable streams (the reference uses global
`np.random` / `random` state seeded per rank — trainer.py:66-79).
"""

from __future__ import annotations

import math

import numpy as np
from scipy import special

__all__ = [
    "mesh_grid", "bivariate_gaussian", "bivariate_generalized_gaussian",
    "bivariate_plateau", "circular_lowpass_kernel", "random_mixed_kernels",
    "random_sinc_or_mixed", "pulse_kernel",
]


def mesh_grid(kernel_size: int):
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.stack([xx, yy], axis=-1)  # (K, K, 2)
    return xy, xx, yy


def _sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x**2, 0.0], [0.0, sig_y**2]])
    u = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def _quad_form(kernel_size: int, sig_x, sig_y, theta, isotropic: bool) -> np.ndarray:
    """grid^T Sigma^-1 grid for each kernel tap."""
    grid, _, _ = mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x**2, 0.0], [0.0, sig_x**2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    return np.sum((grid @ inv) * grid, axis=2)


def bivariate_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0, isotropic=True):
    q = _quad_form(kernel_size, sig_x, sig_y if sig_y is not None else sig_x, theta, isotropic)
    k = np.exp(-0.5 * q)
    return k / k.sum()


def bivariate_generalized_gaussian(kernel_size, sig_x, sig_y, theta, beta, isotropic=True):
    q = _quad_form(kernel_size, sig_x, sig_y, theta, isotropic)
    k = np.exp(-0.5 * np.power(q, beta))
    return k / k.sum()


def bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, isotropic=True):
    q = _quad_form(kernel_size, sig_x, sig_y, theta, isotropic)
    k = np.reciprocal(np.power(q, beta) + 1)
    return k / k.sum()


def circular_lowpass_kernel(cutoff: float, kernel_size: int, pad_to: int = 0) -> np.ndarray:
    """2-D sinc filter (degradations.py:389-417)."""
    assert kernel_size % 2 == 1
    c = (kernel_size - 1) / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        x, y = np.meshgrid(np.arange(kernel_size), np.arange(kernel_size), indexing="ij")
        r = np.sqrt((x - c) ** 2 + (y - c) ** 2)
        kernel = cutoff * special.j1(cutoff * r) / (2 * np.pi * r)
    kernel[int(c), int(c)] = cutoff**2 / (4 * np.pi)
    kernel = kernel / kernel.sum()
    if pad_to > kernel_size:
        p = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((p, p), (p, p)))
    return kernel


def _rand_beta(rng: np.random.Generator, beta_range) -> float:
    # reference splits the beta range around 1 with a coin flip (:256-259)
    if rng.uniform() < 0.5:
        return rng.uniform(beta_range[0], 1)
    return rng.uniform(1, beta_range[1])


def random_mixed_kernels(
    rng: np.random.Generator,
    kernel_list,
    kernel_prob,
    kernel_size: int = 21,
    sigma_x_range=(0.6, 5),
    sigma_y_range=(0.6, 5),
    rotation_range=(-math.pi, math.pi),
    betag_range=(0.5, 8),
    betap_range=(0.5, 8),
    noise_range=None,
) -> np.ndarray:
    """Sample one kernel from the mixed family (degradations.py:324-387)."""
    ktype = rng.choice(len(kernel_list), p=np.asarray(kernel_prob) / np.sum(kernel_prob))
    ktype = kernel_list[int(ktype)]
    sig_x = rng.uniform(*sigma_x_range)
    iso = not ktype.endswith("aniso")
    sig_y, theta = (sig_x, 0.0) if iso else (rng.uniform(*sigma_y_range),
                                             rng.uniform(*rotation_range))
    if ktype in ("iso", "aniso"):
        kernel = bivariate_gaussian(kernel_size, sig_x, sig_y, theta, isotropic=iso)
        if noise_range is not None:
            noise = rng.uniform(noise_range[0], noise_range[1], size=kernel.shape)
            kernel = kernel * noise
            kernel = kernel / kernel.sum()
    elif ktype.startswith("generalized"):
        beta = _rand_beta(rng, betag_range)
        kernel = bivariate_generalized_gaussian(kernel_size, sig_x, sig_y, theta, beta, iso)
    elif ktype.startswith("plateau"):
        beta = _rand_beta(rng, betap_range)
        kernel = bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, iso)
    else:
        raise ValueError(f"unknown kernel type {ktype}")
    return kernel.astype(np.float32)


def random_sinc_or_mixed(
    rng: np.random.Generator,
    kernel_size: int,
    sinc_prob: float,
    kernel_list,
    kernel_prob,
    blur_sigma,
    betag_range,
    betap_range,
    pad_to: int = 21,
) -> np.ndarray:
    """The per-sample kernel draw of RealESRGANDataset (:174-218): sinc with
    prob `sinc_prob` (cutoff range depends on size), else mixed kernel; the
    result is zero-padded to `pad_to`."""
    if rng.uniform() < sinc_prob:
        omega_c = rng.uniform(np.pi / 3 if kernel_size < 13 else np.pi / 5, np.pi)
        kernel = circular_lowpass_kernel(omega_c, kernel_size, pad_to=0)
    else:
        kernel = random_mixed_kernels(
            rng, kernel_list, kernel_prob, kernel_size,
            blur_sigma, blur_sigma, (-math.pi, math.pi),
            betag_range, betap_range, noise_range=None,
        )
    p = (pad_to - kernel_size) // 2
    if p > 0:
        kernel = np.pad(kernel, ((p, p), (p, p)))
    return kernel.astype(np.float32)


def pulse_kernel(size: int = 21) -> np.ndarray:
    """Identity (pulse) kernel used when the final sinc is skipped
    (realesrgan_dataset.py:220-227)."""
    k = np.zeros((size, size), dtype=np.float32)
    k[size // 2, size // 2] = 1.0
    return k
