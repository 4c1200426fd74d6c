"""Residual-shifting diffusion core on torch tensors (NHWC).

Functions over a :class:`~resshift_tpu_torch.diffusion.schedule.Schedule`.
The reverse chain is a Python loop over t = T-1 .. 0; Gaussian draws come
from an explicit `torch.Generator`, or are passed in (`noise=`,
`step_noise=`) so that a test can feed both this port and the JAX package
the same numbers.  `sample_loop_parallel` runs the same chain as Picard
sweeps over the whole trajectory at once, `sample_loop_progressive` keeps
every step's sample and x0 prediction.  `q_sample` and `training_losses`
are the training side: the forward process and the per-sample latent MSE.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .schedule import Schedule

__all__ = ["q_sample", "q_mean_variance", "q_posterior_mean_variance", "training_losses",
           "scale_input", "predict_xstart_from_eps",
           "predict_xstart_from_eps_scale", "predict_xstart_from_residual",
           "predict_eps_from_xstart", "prior_sample", "p_mean_variance",
           "p_sample", "sample_loop", "sample_loop_parallel", "sample_loop_progressive",
           "chain_draws", "run_steps", "PMeanVariance"]

# model_fn(x_scaled, t_original, **cond) -> model output; t_original is the
# timestep after mapping through sched.timestep_map (respacing)
ModelFn = Callable[..., torch.Tensor]


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """arr[t] as float32, broadcast over trailing dims (t is a [B] vector)."""
    out = arr[t].float()
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def _t_vec(t: int | torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`t` (an int, or a [B] vector on x's device) as a [B] vector; an int
    is filled on the device, with no copy from the host."""
    if isinstance(t, torch.Tensor):
        return t.long().expand(x.shape[0])
    return torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)


def q_sample(sched: Schedule, x_start, y, t, noise):
    """q(x_t | x0, y) = x0 + eta_t (y - x0) + kappa sqrt(eta_t) eps; `t` a [B]
    vector of respaced steps."""
    nd = x_start.ndim
    etas = _extract(sched.etas, t, nd)
    std = _extract(sched.sqrt_etas, t, nd) * sched.kappa
    return etas * (y - x_start) + x_start + std * noise


def q_mean_variance(sched: Schedule, x_start, y, t):
    """The mean, variance and log-variance of q(x_t | x0, y)."""
    etas = _extract(sched.etas, t, x_start.ndim)
    variance = etas * sched.kappa**2
    return etas * (y - x_start) + x_start, variance, torch.log(variance)


def q_posterior_mean_variance(sched: Schedule, x_start, x_t, t):
    """The mean, variance and clipped log-variance of q(x_{t-1} | x_t, x0)."""
    nd = x_t.ndim
    mean = (_extract(sched.posterior_mean_coef1, t, nd) * x_t
            + _extract(sched.posterior_mean_coef2, t, nd) * x_start)
    return (mean, _extract(sched.posterior_variance, t, nd),
            _extract(sched.posterior_log_variance_clipped, t, nd))


def training_losses(sched: Schedule, model_fn: ModelFn, z_start, z_y, t, noise, *,
                    model_kwargs: dict[str, Any] | None = None, weighted_mse: bool = False):
    """Per-sample MSE in latent space between the model output and its
    target (x0, the residual, eps or kappa sqrt(eta) eps, by the schedule's
    mean type; epsilon_scale divides by kappa^2 eta, `weighted_mse`
    multiplies by the schedule's `weight_loss_mse`).  `z_start`, `z_y` are
    the encoded latents, `t` a [B] vector, `noise` the q_sample draw.
    Returns (mse[B], z_t, pred_zstart)."""
    model_kwargs = model_kwargs or {}
    nd = z_start.ndim
    z_t = q_sample(sched, z_start, z_y, t, noise)
    model_output = model_fn(scale_input(sched, z_t, t), sched.timestep_map[t],
                            **model_kwargs).float()
    mtype = sched.model_mean_type
    if mtype == "xstart":
        target = z_start
    elif mtype == "residual":
        target = z_y - z_start
    elif mtype == "epsilon":
        target = noise
    elif mtype == "epsilon_scale":
        target = noise * sched.kappa * _extract(sched.sqrt_etas, t, nd)
    else:
        raise ValueError(f"unknown model_mean_type: {mtype}")
    mse = ((target - model_output) ** 2).mean(dim=tuple(range(1, nd)))
    if mtype == "epsilon_scale":
        mse = mse / (sched.kappa**2 * _extract(sched.etas, t, 1).reshape(-1))
    if weighted_mse:
        mse = mse * _extract(sched.weight_loss_mse, t, 1).reshape(-1)
    if mtype == "xstart":
        pred_zstart = model_output
    elif mtype == "epsilon":
        pred_zstart = predict_xstart_from_eps(sched, z_t, z_y, t, model_output)
    elif mtype == "residual":
        pred_zstart = predict_xstart_from_residual(z_y, model_output)
    else:
        pred_zstart = predict_xstart_from_eps_scale(sched, z_t, z_y, t, model_output)
    return mse, z_t, pred_zstart


def scale_input(sched: Schedule, x, t):
    """Input normalization before the denoiser."""
    if not sched.normalize_input:
        return x
    nd = x.ndim
    if sched.latent_flag:
        std = torch.sqrt(_extract(sched.etas, t, nd) * sched.kappa**2 + 1.0)
        return x / std
    max_val = _extract(sched.sqrt_etas, t, nd) * sched.kappa * 3.0 + 1.0
    return x / max_val


def predict_xstart_from_eps(sched: Schedule, x_t, y, t, eps):
    nd = x_t.ndim
    return ((x_t - _extract(sched.sqrt_etas, t, nd) * sched.kappa * eps
             - _extract(sched.etas, t, nd) * y) / _extract(1.0 - sched.etas, t, nd))


def predict_xstart_from_eps_scale(sched: Schedule, x_t, y, t, eps):
    nd = x_t.ndim
    return (x_t - eps - _extract(sched.etas, t, nd) * y) / _extract(1.0 - sched.etas, t, nd)


def predict_xstart_from_residual(y, residual):
    return y - residual


def predict_eps_from_xstart(sched: Schedule, x_t, y, t, pred_xstart):
    nd = x_t.ndim
    return ((x_t - _extract(1.0 - sched.etas, t, nd) * pred_xstart
             - _extract(sched.etas, t, nd) * y) / _extract(sched.kappa * sched.sqrt_etas, t, nd))


def prior_sample(sched: Schedule, y, noise):
    """x_T = y + kappa sqrt(eta_T) eps."""
    t = sched.num_timesteps - 1
    return y + sched.kappa * sched.sqrt_etas[t] * noise


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


def p_mean_variance(sched: Schedule, model_fn: ModelFn, x_t, y, t: int | torch.Tensor, *,
                    clip_denoised: bool = True,
                    model_kwargs: dict[str, Any] | None = None) -> PMeanVariance:
    """Model posterior p(x_{t-1} | x_t) at respaced step `t` (an int, or a
    [B] vector: one step per sample)."""
    model_kwargs = model_kwargs or {}
    nd = x_t.ndim
    t_vec = _t_vec(t, x_t)
    t_orig = sched.timestep_map[t_vec]
    model_output = model_fn(scale_input(sched, x_t, t_vec), t_orig, **model_kwargs).float()
    variance = _extract(sched.posterior_variance, t_vec, nd)
    log_variance = _extract(sched.posterior_log_variance_clipped, t_vec, nd)

    mtype = sched.model_mean_type
    if mtype == "xstart":
        pred_xstart = model_output
    elif mtype == "residual":
        pred_xstart = predict_xstart_from_residual(y, model_output)
    elif mtype == "epsilon":
        pred_xstart = predict_xstart_from_eps(sched, x_t, y, t_vec, model_output)
    elif mtype == "epsilon_scale":
        pred_xstart = predict_xstart_from_eps_scale(sched, x_t, y, t_vec, model_output)
    else:
        raise ValueError(f"unknown model_mean_type: {mtype}")
    if clip_denoised:
        pred_xstart = pred_xstart.clamp(-1.0, 1.0)
    mean = (_extract(sched.posterior_mean_coef1, t_vec, nd) * x_t
            + _extract(sched.posterior_mean_coef2, t_vec, nd) * pred_xstart)
    return PMeanVariance(mean, variance, log_variance, pred_xstart)


def _step(out: PMeanVariance, t: int, eps: torch.Tensor) -> torch.Tensor:
    nonzero = 1.0 if t != 0 else 0.0
    return out.mean + nonzero * torch.exp(0.5 * out.log_variance) * eps


def p_sample(sched: Schedule, model_fn: ModelFn, x_t, y, t: int,
             generator: torch.Generator | None, *, clip_denoised: bool = True,
             model_kwargs: dict[str, Any] | None = None, noise_repeat: bool = False):
    """One reverse step: sample x_{t-1}.  `noise_repeat` repeats sample 0's
    noise across the batch.  Returns (x_{t-1}, pred_xstart)."""
    out = p_mean_variance(sched, model_fn, x_t, y, t, clip_denoised=clip_denoised,
                          model_kwargs=model_kwargs)
    noise = torch.randn(x_t.shape, generator=generator, dtype=torch.float32, device=x_t.device)
    if noise_repeat:
        noise = noise[:1].expand_as(noise)
    return _step(out, t, noise), out.pred_xstart


def sample_loop(sched: Schedule, model_fn: ModelFn, z_y: torch.Tensor,
                generator: torch.Generator | None = None, *,
                noise: torch.Tensor | None = None, clip_denoised: bool = True,
                model_kwargs: dict[str, Any] | None = None, noise_repeat: bool = False,
                step_noise: torch.Tensor | None = None) -> torch.Tensor:
    """Full reverse chain over t = T-1 .. 0; returns the final latent x_0.

    `noise` fixes the prior draw and `step_noise` (T, B, ...) the per-step
    draws (step_noise[i] is used at t = T-1-i); otherwise both come from
    `generator`, prior first."""
    if noise is None:
        noise = torch.randn(z_y.shape, generator=generator, dtype=torch.float32,
                            device=z_y.device)
    x = prior_sample(sched, z_y, noise)
    steps = range(sched.num_timesteps - 1, -1, -1)
    if step_noise is not None:
        return run_steps(sched, model_fn, x, z_y, steps, step_noise,
                         clip_denoised=clip_denoised, model_kwargs=model_kwargs)
    for t in steps:
        x, _ = p_sample(sched, model_fn, x, z_y, t, generator, clip_denoised=clip_denoised,
                        model_kwargs=model_kwargs, noise_repeat=noise_repeat)
    return x


def run_steps(sched: Schedule, model_fn: ModelFn, x: torch.Tensor, z_y: torch.Tensor,
              steps, step_noise: torch.Tensor, *, clip_denoised: bool = True,
              model_kwargs: dict[str, Any] | None = None) -> torch.Tensor:
    """The reverse steps t of `steps` (descending) from x, each with its
    draw step_noise[T-1-t] (the chain's (T, B, ...) draws): a slice of
    `sample_loop`'s chain, as a pipeline stage runs it."""
    for t in steps:
        out = p_mean_variance(sched, model_fn, x, z_y, t, clip_denoised=clip_denoised,
                              model_kwargs=model_kwargs)
        x = _step(out, t, step_noise[sched.num_timesteps - 1 - t])
    return x


def chain_draws(num_timesteps: int, shape, generator: torch.Generator | None,
                device: str | torch.device, noise_repeat: bool = False, noise=None):
    """The prior draw (`shape`) and the T step draws (T, *shape), taken from
    `generator` in `sample_loop`'s order: the prior first (unless `noise` is
    given), then step by step.  `noise_repeat` repeats sample 0's draws
    across the batch, as `sample_loop` does."""
    if noise is None:
        noise = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        if noise_repeat:
            noise = noise[:1].expand_as(noise)
    eps = torch.stack([torch.randn(shape, generator=generator, dtype=torch.float32,
                                   device=device) for _ in range(num_timesteps)])
    if noise_repeat:
        eps = eps[:, :1].expand_as(eps)
    return noise, eps


def sample_loop_parallel(sched: Schedule, model_fn: ModelFn, z_y: torch.Tensor,
                         generator: torch.Generator | None = None, *,
                         sweeps: int | None = None, noise: torch.Tensor | None = None,
                         step_noise: torch.Tensor | None = None, clip_denoised: bool = True,
                         model_kwargs: dict[str, Any] | None = None,
                         noise_repeat: bool = False,
                         shard_fn: ModelFn | None = None) -> torch.Tensor:
    """Time-parallel (Picard) reverse chain; returns the final latent.

    With the per-step draws fixed, the chain x_{j+1} = F_j(x_j) over
    positions j = 0..T-1 (t = T-1-j) is swept whole: X[j+1] <- F_j(X[j])
    for every j at once, the denoiser running on a (T*B) batch.  After k
    sweeps the first k positions are exact, so `sweeps` = T gives
    `sample_loop`'s result; fewer trade accuracy for fewer denoiser calls
    (default T // 3).  The draws come as `sample_loop` takes them.
    `shard_fn`, where given, takes the sweep's denoiser call in place of
    `model_fn` (the same arguments: the (T*B) batch, its timesteps, the
    conditioning tiled T times) and spreads that batch over several cards
    (`ResShiftPipeline.sample_time_parallel(devices=)`), as the JAX
    package's `shard_fn` spreads it over its mesh."""
    model_kwargs = model_kwargs or {}
    t_steps, b = sched.num_timesteps, z_y.shape[0]
    sweeps = max(1, t_steps // 3) if sweeps is None else sweeps
    if step_noise is None:
        noise, step_noise = chain_draws(t_steps, z_y.shape, generator, z_y.device,
                                        noise_repeat, noise)
    elif noise is None:
        raise ValueError("step_noise needs noise (the prior draw) too")
    x_t = prior_sample(sched, z_y, noise)

    ts = torch.arange(t_steps - 1, -1, -1, device=z_y.device)
    t_vec = ts.repeat_interleave(b)
    tiled = {k: torch.cat([v] * t_steps, dim=0) for k, v in model_kwargs.items()}
    z_y_tiled = torch.cat([z_y] * t_steps, dim=0)
    bshape = (t_steps, b) + (1,) * (z_y.ndim - 1)
    nz = (ts != 0).float().reshape((t_steps,) + (1,) * z_y.ndim)
    xs = x_t.unsqueeze(0).expand((t_steps + 1,) + x_t.shape)
    for _ in range(sweeps):
        out = p_mean_variance(sched, shard_fn or model_fn,
                              xs[:-1].reshape((t_steps * b,) + z_y.shape[1:]),
                              z_y_tiled, t_vec, clip_denoised=clip_denoised,
                              model_kwargs=tiled)
        mean = out.mean.reshape((t_steps,) + z_y.shape)
        logv = out.log_variance.reshape(bshape)
        xs = torch.cat([xs[:1], mean + nz * torch.exp(0.5 * logv) * step_noise], dim=0)
    return xs[-1]


def sample_loop_progressive(sched: Schedule, model_fn: ModelFn, z_y: torch.Tensor,
                            generator: torch.Generator | None = None, *,
                            noise: torch.Tensor | None = None,
                            step_noise: torch.Tensor | None = None, clip_denoised: bool = True,
                            model_kwargs: dict[str, Any] | None = None,
                            noise_repeat: bool = False):
    """`sample_loop` that also returns every step's sample and x0
    prediction, stacked on a leading time axis: (x_0, samples, pred_x0s),
    the last two (T, B, ...).  The draws come as `sample_loop` takes them."""
    if noise is None:
        noise = torch.randn(z_y.shape, generator=generator, dtype=torch.float32,
                            device=z_y.device)
    x = prior_sample(sched, z_y, noise)
    samples, preds = [], []
    for i, t in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        if step_noise is None:
            x, pred = p_sample(sched, model_fn, x, z_y, t, generator,
                               clip_denoised=clip_denoised, model_kwargs=model_kwargs,
                               noise_repeat=noise_repeat)
        else:
            out = p_mean_variance(sched, model_fn, x, z_y, t, clip_denoised=clip_denoised,
                                  model_kwargs=model_kwargs)
            x, pred = _step(out, t, step_noise[i]), out.pred_xstart
        samples.append(x)
        preds.append(pred)
    return x, torch.stack(samples), torch.stack(preds)
