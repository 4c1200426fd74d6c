"""The port's DDPM/DDIM variant, Picard (time-parallel) chain and
progressive chain against the JAX package, on the CPU in f32.

  * `build_ddpm_schedule` equals JAX's bit for bit, with and without
    respacing.
  * `p_sample_loop` and `ddim_sample_loop` with a toy model equal JAX's
    with JAX's own draws handed over as `noise=` (x_T) and `step_noise=`
    (split as `resshift_tpu/diffusion/ddpm.py` splits its key).
  * A whole `variant: ddpm` tile (DDIM and ancestral) through both
    pipelines, at the RGB band rtol / atol 5e-3 of tests/test_e2e_parity.py;
    `configs/ddpm_ablation.yaml`'s diffusion block builds a port pipeline.
  * `sample_loop_parallel` at sweeps 1, T // 3 and T against JAX's, in the
    band the port's `sample_loop` test uses (rtol / atol 1e-5); at sweeps =
    T it equals the port's own `sample_loop` with the same generator, bit
    for bit; `sample_loop_progressive` against JAX's.
  * The pipeline's `sample_time_parallel` at sweeps = T and
    `sample_progressive`'s final output against `sample` with the same
    seed, and `cli infer --time-parallel`.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resshift_tpu.diffusion import build_schedule as jbuild_schedule
from resshift_tpu.diffusion import ddpm as jddpm
from resshift_tpu.diffusion import resshift as jrs
from resshift_tpu.pipeline import ResShiftPipeline as JPipeline
from resshift_tpu_torch import cli, config as tconfig
from resshift_tpu_torch.diffusion import build_schedule
from resshift_tpu_torch.diffusion import ddpm as tddpm
from resshift_tpu_torch.diffusion import resshift as trs
from resshift_tpu_torch.pipeline import ResShiftPipeline
from resshift_tpu_torch.utils import image_io
from tests.test_torch_pipeline import ROOT, _pipelines, small_config

torch.set_num_threads(1)


def _toy(xp):
    def fn(x, t, lq):
        return xp.tanh(0.7 * x + 0.01 * t.reshape(-1, 1, 1, 1)) + 0.1 * lq
    return fn


def _ddpm_draws(key, shape, steps):
    """x_T and the per-step draws as JAX's DDPM chains take them from `key`."""
    key, k0 = jax.random.split(key)
    x_t = jax.random.normal(k0, shape, jnp.float32)
    keys = jax.random.split(key, steps)
    eps = jnp.stack([jax.random.normal(k, shape, jnp.float32) for k in keys])
    return torch.tensor(np.asarray(x_t)), torch.tensor(np.asarray(eps))


# ------------------------------------------------------------------ DDPM

@pytest.mark.parametrize("respacing", [None, 50, "ddim25", "10,15"])
def test_ddpm_schedule_matches_jax(respacing):
    kw = dict(steps=1000, beta_start=1e-4, beta_end=0.02, timestep_respacing=respacing)
    js, ts = jddpm.build_ddpm_schedule(**kw), tddpm.build_ddpm_schedule(**kw)
    assert ts.num_timesteps == js.num_timesteps and ts.model_mean_type == "epsilon"
    np.testing.assert_array_equal(ts.timestep_map.numpy(), np.asarray(js.timestep_map))
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                 "posterior_variance", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)


@pytest.mark.parametrize("sampler,eta,xstart,clip", [("ancestral", 0.0, False, False),
                                                     ("ancestral", 0.0, True, True),
                                                     ("ddim", 0.0, False, False),
                                                     ("ddim", 0.5, False, True)])
def test_ddpm_chains_match_jax(sampler, eta, xstart, clip):
    kw = dict(steps=100, timestep_respacing=6, predict_xstart=xstart)
    js, ts = jddpm.build_ddpm_schedule(**kw), tddpm.build_ddpm_schedule(**kw)
    shape = (2, 8, 8, 3)
    lq = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    args = dict(clip_denoised=clip, model_kwargs={"lq": jnp.asarray(lq)})
    if sampler == "ddim":
        want = jddpm.ddim_sample_loop(js, _toy(jnp), shape, key, eta=eta, **args)
        fn, extra = tddpm.ddim_sample_loop, {"eta": eta}
    else:
        want = jddpm.p_sample_loop(js, _toy(jnp), shape, key, **args)
        fn, extra = tddpm.p_sample_loop, {}
    noise, step_noise = _ddpm_draws(key, shape, ts.num_timesteps)
    got = fn(ts, _toy(torch), shape, None, noise=noise, step_noise=step_noise,
             clip_denoised=clip, model_kwargs={"lq": torch.from_numpy(lq)}, **extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ddpm_training_losses_match_jax():
    js, ts = jddpm.build_ddpm_schedule(steps=50), tddpm.build_ddpm_schedule(steps=50)
    rng = np.random.default_rng(1)
    x0, noise = (rng.standard_normal((3, 4, 4, 3)).astype(np.float32) for _ in range(2))
    lq = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
    t = np.array([0, 17, 49])
    want = jddpm.training_losses(js, _toy(jnp), jnp.asarray(x0), jnp.asarray(t),
                                 jnp.asarray(noise), model_kwargs={"lq": jnp.asarray(lq)})
    got = tddpm.training_losses(ts, _toy(torch), torch.from_numpy(x0), torch.from_numpy(t),
                                torch.from_numpy(noise), model_kwargs={"lq": torch.from_numpy(lq)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _ddpm_cfg(sampler, eta=0.0):
    cfg = small_config()
    cfg["diffusion"] = dict(variant="ddpm", steps=200, beta_start=1e-4, beta_end=0.02,
                            predict_type="epsilon", timestep_respacing=4, sampler=sampler,
                            eta=eta, scale_factor=1.0)
    return cfg


@pytest.mark.parametrize("sampler,eta", [("ddim", 0.0), ("ancestral", 0.0)])
def test_ddpm_tile_matches_jax(sampler, eta):
    """A whole DDPM tile (latent chain, LQ conditioning, decode, clamp)
    through both pipelines with the same weights and JAX's draws."""
    _, params, base = _pipelines()
    cfg = _ddpm_cfg(sampler, eta)
    jp = JPipeline(cfg, dtype=jnp.float32)
    tp = ResShiftPipeline(cfg, dtype=torch.float32, device="cpu")
    tp.load_state_dicts(unet=base.unet.state_dict(), vqgan=base.vq.state_dict())
    lq = np.random.default_rng(5).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda p, x: jp._sample_tile(p, x, key))(params, lq)
    noise, step_noise = _ddpm_draws(key, (2, 16, 16, 3), tp.sched.num_timesteps)
    got = tp._sample_tile(torch.from_numpy(lq), None, noise=noise, step_noise=step_noise)
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3, atol=5e-3)
    # the generator path: x_T first, then one draw per step
    g = torch.Generator().manual_seed(2)
    noise = torch.randn((2, 16, 16, 3), generator=g)
    step_noise = torch.stack([torch.randn((2, 16, 16, 3), generator=g) for _ in range(4)])
    torch.testing.assert_close(
        tp.sample(torch.from_numpy(lq), torch.Generator().manual_seed(2)),
        tp._sample_tile(torch.from_numpy(lq), None, noise=noise, step_noise=step_noise),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="noise_repeat"):
        tp.sample(torch.from_numpy(lq), noise_repeat=True)


def test_ddpm_ablation_config_builds():
    """`configs/ddpm_ablation.yaml`'s diffusion block over realsr_v1."""
    cfg = tconfig.load_yaml_config(ROOT / "configs" / "ddpm_ablation.yaml")
    small = small_config()
    small["diffusion"] = cfg["diffusion"]
    tp = ResShiftPipeline(small, dtype=torch.float32, device="cpu")
    assert (tp.variant, tp.ddpm_sampler, tp.ddpm_eta) == ("ddpm", "ddim", 0.0)
    assert tp.sched.num_timesteps == 50 and tp.sched.model_mean_type == "epsilon"
    jp = JPipeline(small, dtype=jnp.float32)
    np.testing.assert_array_equal(tp.sched.timestep_map.numpy(), np.asarray(jp.sched.timestep_map))


# ------------------------------------------------------ Picard, progressive

def _chain_inputs(steps):
    kw = dict(steps=steps, min_noise_level=0.2, kappa=2.0)
    rng = np.random.default_rng(0)
    z_y, lq = (rng.standard_normal((2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    return jbuild_schedule(**kw), build_schedule(**kw), z_y, lq


@pytest.mark.parametrize("sweeps", [1, 2, 6])
def test_sample_loop_parallel_matches_jax(sweeps):
    js, ts, z_y, lq = _chain_inputs(6)
    key = jax.random.PRNGKey(4)
    want = jrs.sample_loop_parallel(js, _toy(jnp), jnp.asarray(z_y), key, sweeps=sweeps,
                                    clip_denoised=True, model_kwargs={"lq": jnp.asarray(lq)})
    key2, prior_key = jax.random.split(key)
    noise = jax.random.normal(prior_key, z_y.shape, jnp.float32)
    eps = jnp.stack([jax.random.normal(k, z_y.shape, jnp.float32)
                     for k in jax.random.split(key2, 6)])
    got = trs.sample_loop_parallel(ts, _toy(torch), torch.from_numpy(z_y), None, sweeps=sweeps,
                                   noise=torch.tensor(np.asarray(noise)),
                                   step_noise=torch.tensor(np.asarray(eps)),
                                   clip_denoised=True, model_kwargs={"lq": torch.from_numpy(lq)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("noise_repeat", [False, True])
def test_sample_loop_parallel_at_t_sweeps_is_sample_loop(noise_repeat):
    _, ts, z_y, lq = _chain_inputs(5)
    kw = dict(clip_denoised=False, model_kwargs={"lq": torch.from_numpy(lq)},
              noise_repeat=noise_repeat)
    z = torch.from_numpy(z_y)

    def prior(g):
        n = torch.randn(z.shape, generator=g)
        return n[:1].expand_as(n) if noise_repeat else n

    g = torch.Generator().manual_seed(9)
    want = trs.sample_loop(ts, _toy(torch), z, g, noise=prior(g), **kw)
    got = trs.sample_loop_parallel(ts, _toy(torch), z, torch.Generator().manual_seed(9),
                                   sweeps=5, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    fewer = trs.sample_loop_parallel(ts, _toy(torch), z, torch.Generator().manual_seed(9),
                                     sweeps=2, **kw)
    assert not torch.equal(fewer, want)


def test_sample_loop_progressive_matches_jax():
    js, ts, z_y, lq = _chain_inputs(4)
    key = jax.random.PRNGKey(6)
    jx0, jsamples, jpreds = jrs.sample_loop_progressive(
        js, _toy(jnp), jnp.asarray(z_y), key, clip_denoised=True,
        model_kwargs={"lq": jnp.asarray(lq)})
    key, prior_key = jax.random.split(key)
    noise = jax.random.normal(prior_key, z_y.shape, jnp.float32)
    eps = jnp.stack([jax.random.normal(k, z_y.shape, jnp.float32)
                     for k in jax.random.split(key, 4)])
    x0, samples, preds = trs.sample_loop_progressive(
        ts, _toy(torch), torch.from_numpy(z_y), None,
        noise=torch.tensor(np.asarray(noise)), step_noise=torch.tensor(np.asarray(eps)),
        clip_denoised=True, model_kwargs={"lq": torch.from_numpy(lq)})
    assert samples.shape == preds.shape == (4, 2, 8, 8, 3)
    for got, want in ((x0, jx0), (samples, jsamples), (preds, jpreds)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(samples[-1], x0, rtol=0, atol=0)


def test_pipeline_time_parallel_and_progressive_equal_sample():
    """Through the small pipeline: `sample_time_parallel` at sweeps = T and
    `sample_progressive`'s final output against `sample` with the same seed
    (the UNet at batch T*B against B: the CPU's convs may round apart)."""
    _, _, tp = _pipelines()
    lq = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, (2, 16, 16, 3))
                          .astype(np.float32))
    want = tp.sample(lq, torch.Generator().manual_seed(3))
    t = tp.sched.num_timesteps
    got = tp.sample_time_parallel(lq, torch.Generator().manual_seed(3), sweeps=t)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    final, strip = tp.sample_progressive(lq, torch.Generator().manual_seed(3))
    torch.testing.assert_close(final, want, rtol=0, atol=0)
    assert strip.shape == (t, 2, 64, 64, 3) and strip.abs().max() <= 1.0
    with pytest.raises(ValueError, match="one tile"):
        tp.sample_time_parallel(torch.zeros(1, 20, 20, 3))


def test_cli_infer_time_parallel(tmp_path, capsys):
    """`cli infer --time-parallel T` writes what `sample` gives with the
    seed (to within one 8-bit level)."""
    cfg = copy.deepcopy(small_config())
    cfg["inference"] = dict(chop_size=64, chop_stride=48, padding_offset=16)
    import yaml

    (tmp_path / "small.yaml").write_text(yaml.safe_dump(cfg))
    (tmp_path / "lq").mkdir()
    image_io.imwrite(np.random.default_rng(8).uniform(0, 1, (16, 24, 3)),
                     tmp_path / "lq" / "a.png")
    cli.main(["infer", "--config", str(tmp_path / "small.yaml"), "--fp32", "--device", "cpu",
              "--seed", "7", "--time-parallel", "3", "--in-path", str(tmp_path / "lq"),
              "--out-path", str(tmp_path / "out")])
    assert "Done:" in capsys.readouterr().out
    pipe = ResShiftPipeline(cfg, dtype=torch.float32, device="cpu")
    pipe.init_params(7)
    lq = torch.from_numpy(image_io.to_model(image_io.imread(tmp_path / "lq" / "a.png")))
    want = image_io.from_model(pipe.sample(lq, torch.Generator().manual_seed(7)).numpy())[0]
    got = image_io.imread(tmp_path / "out" / "a.png", dtype="uint8").astype(np.int16)
    assert got.shape == (64, 96, 3)
    want8 = np.round(np.clip(want, 0, 1) * 255).astype(np.int16)
    assert np.abs(got - want8).max() <= 1
