"""The port's sampler against the JAX package's, on the CPU in f32: the
schedule, the reverse chain with a toy model, resize and tiling, the small
end-to-end sample with injected noise, and a padded, chopped input.  Also
the port's import hygiene and its refusal to run without CUDA unless asked.

JAX and torch draw different random numbers from a seed, so the noise is
made with numpy and handed to both.  The end-to-end band rtol 5e-3 /
atol 5e-3 on RGB is tests/test_e2e_parity.py's.
"""

import functools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resshift_tpu.convert import convert_unet_swin, convert_vqgan
from resshift_tpu.diffusion import build_schedule as jbuild_schedule
from resshift_tpu.diffusion import resshift as jrs
from resshift_tpu.ops.resize import resize as jresize
from resshift_tpu.ops.tiling import TileGrid as JTileGrid
from resshift_tpu.pipeline import ResShiftPipeline as JPipeline
from resshift_tpu.diffusion import exponential_sqrt_etas as jetas
from resshift_tpu.diffusion import space_timesteps as jspace
from resshift_tpu_torch.convert import from_flax
from resshift_tpu_torch.diffusion import build_schedule, exponential_sqrt_etas, space_timesteps
from resshift_tpu_torch.diffusion import resshift as trs
from resshift_tpu_torch.ops.resize import resize
from resshift_tpu_torch.ops.tiling import TileGrid
from resshift_tpu_torch.pipeline import ResShiftPipeline

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def small_config(steps=3, min_noise_level=0.04):
    """The realsr structure at small width: window 4, lq 16, f4 VQGAN."""
    return dict(
        task="realsr", sf=4,
        model=dict(image_size=16, in_channels=3, model_channels=32, out_channels=3,
                   attention_resolutions=[16, 8], dropout=0.0, channel_mult=[1, 2],
                   num_res_blocks=[1, 1], conv_resample=True, num_head_channels=16,
                   use_scale_shift_norm=True, resblock_updown=False, swin_depth=2,
                   swin_embed_dim=32, window_size=4, mlp_ratio=2, cond_lq=True,
                   cond_mask=False, lq_size=16),
        diffusion=dict(schedule_name="exponential", steps=steps, min_noise_level=min_noise_level,
                       etas_end=0.99, kappa=2.0, power=0.3, predict_type="xstart",
                       timestep_respacing=None, normalize_input=True, latent_flag=True,
                       scale_factor=1.0, sf=4),
        autoencoder=dict(embed_dim=3, n_embed=64, ddconfig=dict(
            double_z=False, z_channels=3, resolution=64, in_channels=3, out_ch=3, ch=32,
            ch_mult=[1, 2, 4], num_res_blocks=1, attn_resolutions=[], dropout=0.0)),
        inference=dict(chop_size=16, chop_stride=12, padding_offset=16),
    )


# ------------------------------------------------------------- schedule

@pytest.mark.parametrize("steps,mnl,respacing", [(15, 0.04, None), (4, 0.2, None),
                                                 (15, 0.04, 5)])
def test_schedule_matches_jax(steps, mnl, respacing):
    # the host math in f64 is the same, bit for bit
    np.testing.assert_array_equal(exponential_sqrt_etas(steps, mnl, 0.99, 2.0, 0.3),
                                  jetas(steps, mnl, 0.99, 2.0, 0.3))
    if respacing is not None:
        for sections in (respacing, f"ddim{respacing}", "2,3"):
            assert space_timesteps(steps, sections) == jspace(steps, sections)
    kw = dict(steps=steps, min_noise_level=mnl, kappa=2.0, timestep_respacing=respacing)
    js = jbuild_schedule(**kw)
    ts = build_schedule(**kw)
    assert ts.num_timesteps == js.num_timesteps
    np.testing.assert_array_equal(ts.timestep_map.numpy(), np.asarray(js.timestep_map))
    for name, host in ts.host.items():
        want = np.asarray(getattr(js, name))
        np.testing.assert_array_equal(getattr(ts, name).numpy(), want, err_msg=name)
        np.testing.assert_allclose(host, want, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("predict_type,clip", [("xstart", True), ("epsilon", False),
                                               ("residual", True)])
def test_sample_loop_matches_jax(predict_type, clip):
    kw = dict(steps=5, min_noise_level=0.2, kappa=2.0, predict_type=predict_type)
    js, ts = jbuild_schedule(**kw), build_schedule(**kw)
    rng = np.random.default_rng(0)
    z_y = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    lq = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    noise = rng.standard_normal(z_y.shape).astype(np.float32)
    step_noise = rng.standard_normal((5,) + z_y.shape).astype(np.float32)

    def toy(xp):
        def fn(x, t, lq):
            return xp.tanh(0.7 * x + 0.01 * t.reshape(-1, 1, 1, 1)) + 0.1 * lq
        return fn

    want = jrs.sample_loop(js, toy(jnp), jnp.asarray(z_y), jax.random.PRNGKey(0),
                           noise=jnp.asarray(noise), step_noise=jnp.asarray(step_noise),
                           clip_denoised=clip, model_kwargs={"lq": jnp.asarray(lq)})
    got = trs.sample_loop(ts, toy(torch), torch.from_numpy(z_y), None,
                          noise=torch.from_numpy(noise), step_noise=torch.from_numpy(step_noise),
                          clip_denoised=clip, model_kwargs={"lq": torch.from_numpy(lq)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sample_loop_generator_is_deterministic():
    ts = build_schedule(steps=4, min_noise_level=0.2)
    z_y = torch.zeros(2, 4, 4, 3)
    runs = [trs.sample_loop(ts, lambda x, t: x, z_y, torch.Generator().manual_seed(5),
                            noise_repeat=True) for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


# ------------------------------------------------------- resize, tiling

def test_resize_and_tiling_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 13, 9, 3)).astype(np.float32)
    got = resize(torch.from_numpy(x), (52, 36))
    want = jresize(jnp.asarray(x), (52, 36), "bicubic_torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    im = rng.standard_normal((2, 40, 28, 3)).astype(np.float32)
    tg, jg = TileGrid(40, 28, 16, 12, sf=2), JTileGrid(40, 28, 16, 12, sf=2)
    assert tg.starts == jg.starts
    tiles = tg.split(torch.from_numpy(im))
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jg.split(jnp.asarray(im))))
    up = tiles.repeat_interleave(2, 1).repeat_interleave(2, 2)
    np.testing.assert_allclose(tg.gather(up, 2).numpy(),
                               np.asarray(jg.gather(jnp.asarray(up.numpy()), 2)),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ end to end

def _random_state_dict(module, g):
    sd = {}
    for name, p in module.state_dict().items():
        r = torch.randn(p.shape, generator=g)
        if p.dim() >= 2 and not name.endswith("relative_position_bias_table"):
            sd[name] = r / p[0].numel() ** 0.5
        elif name.endswith("weight") and "embedding" not in name:
            sd[name] = 1.0 + 0.1 * r
        else:
            sd[name] = 0.05 * r
    return sd


@functools.lru_cache(maxsize=None)
def _pipelines(steps=3, min_noise_level=0.04):
    """A JAX and a port pipeline with the same random weights."""
    cfg = small_config(steps, min_noise_level)
    tp = ResShiftPipeline(cfg, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    sds = {"unet": _random_state_dict(tp.unet, g), "vqgan": _random_state_dict(tp.vq, g)}
    m, dd = cfg["model"], cfg["autoencoder"]["ddconfig"]
    npsd = {k: {n: v.numpy() for n, v in sd.items()} for k, sd in sds.items()}
    params = {
        "unet": convert_unet_swin(npsd["unet"], image_size=m["image_size"],
                                  channel_mult=m["channel_mult"],
                                  num_res_blocks=m["num_res_blocks"],
                                  attention_resolutions=m["attention_resolutions"],
                                  lq_size=m["lq_size"]),
        "vqgan": convert_vqgan(npsd["vqgan"], ch_mult=dd["ch_mult"],
                               num_res_blocks=dd["num_res_blocks"]),
    }
    tp.load_state_dicts(
        unet=from_flax(params["unet"], "unet", image_size=m["image_size"],
                       channel_mult=m["channel_mult"], num_res_blocks=m["num_res_blocks"],
                       attention_resolutions=m["attention_resolutions"]),
        vqgan=from_flax(params["vqgan"], "vqgan", ch_mult=dd["ch_mult"],
                        num_res_blocks=dd["num_res_blocks"]))
    jp = JPipeline(cfg, dtype=jnp.float32)
    return jp, params, tp


@pytest.fixture(scope="module")
def pipelines():
    return _pipelines()


def _jax_tile(jp, params, lq, noise, step_noise):
    """JAX `_encode` -> `rs.sample_loop(noise=, step_noise=)` -> `_decode` -> clip."""
    z_y = jp._encode(params["vqgan"], lq, up_sample=True)

    def model_fn(x, t, **kw):
        return jp.unet.apply({"params": params["unet"]}, x, t, **kw)

    z0 = jrs.sample_loop(jp.sched, model_fn, z_y, jax.random.PRNGKey(0), noise=noise,
                         step_noise=step_noise, clip_denoised=False, model_kwargs={"lq": lq})
    return jnp.clip(jp._decode(params["vqgan"], z0), -1.0, 1.0)


def _noise(rng, b, steps=3, lat=16, lat_w=None):
    shape = (b, lat, lat_w or lat, 3)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((steps,) + shape).astype(np.float32))


def test_sample_tile_matches_jax(pipelines):
    jp, params, tp = pipelines
    rng = np.random.default_rng(1)
    lq = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    noise, step_noise = _noise(rng, 2)
    want = jax.jit(functools.partial(_jax_tile, jp))(params, lq, noise, step_noise)
    got = tp._sample_tile(torch.from_numpy(lq), None, noise=torch.from_numpy(noise),
                          step_noise=torch.from_numpy(step_noise))
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3, atol=5e-3)


def test_padded_chopped_sample_matches_jax(pipelines, monkeypatch):
    """112x80 output from a 28x20 LQ: reflect-pad to 32x32, nine 16px tiles
    (chop 16, stride 12) in one chunk, overlap-average, crop."""
    jp, params, tp = pipelines
    rng = np.random.default_rng(2)
    lq = rng.uniform(-1, 1, (1, 20, 28, 3)).astype(np.float32)
    noise, step_noise = _noise(rng, 9)

    monkeypatch.setattr(jp, "_sample_tile", lambda p, tl, key, mask=None, noise_repeat=False:
                        _jax_tile(jp, p, tl, noise, step_noise), raising=False)
    want = jax.jit(lambda p, x: jp._sample_padded(p, x, jax.random.PRNGKey(0), None, False,
                                                  16, 12, 9))(params, lq)
    orig = tp._sample_tile
    monkeypatch.setattr(tp, "_sample_tile", lambda tl, gen, mask=None, noise_repeat=False: orig(
        tl, gen, mask, noise_repeat, noise=torch.from_numpy(noise),
        step_noise=torch.from_numpy(step_noise)), raising=False)
    got = tp.sample(torch.from_numpy(lq), chop_size=16, chop_stride=12, tile_bs=9)
    assert got.shape == (1, 80, 112, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("steps,min_noise_level", [(3, 0.04), (4, 0.2)])
def test_unchopped_wide_sample_matches_jax(monkeypatch, steps, min_noise_level):
    """A whole 16x40 LQ photo, unchopped: reflect-pad to 16x48, one tile whose
    16x48 latent (and 8x24 second level) takes the token-permutation route
    of the shifted Swin blocks under a threshold patched alike in both
    packages, crop to 64x160.  Also the realsr_v3 schedule (4 steps,
    min_noise_level 0.2)."""
    from resshift_tpu.ops import swin_block_pallas as jsb
    from resshift_tpu_torch.ops import shift as tshift
    from resshift_tpu_torch.ops import swin_block as tsb

    def gate(wd, ws):
        return wd * ws <= 64  # the 16-wide maps of the other tests still fuse

    monkeypatch.setattr(jsb, "shift_fuse_fits", gate)
    monkeypatch.setattr(tsb, "shift_fuse_fits", gate)
    jp, params, tp = _pipelines(steps, min_noise_level)
    rng = np.random.default_rng(3)
    lq = rng.uniform(-1, 1, (1, 16, 40, 3)).astype(np.float32)
    noise, step_noise = _noise(rng, 1, steps, 16, 48)

    monkeypatch.setattr(jp, "_sample_tile", lambda p, tl, key, mask=None, noise_repeat=False:
                        _jax_tile(jp, p, tl, noise, step_noise), raising=False)
    want = jax.jit(lambda p, x: jp._sample_padded(p, x, jax.random.PRNGKey(0), None, False,
                                                  64, 48, 1))(params, lq)
    orig = tp._sample_tile
    monkeypatch.setattr(tp, "_sample_tile", lambda tl, gen, mask=None, noise_repeat=False: orig(
        tl, gen, mask, noise_repeat, noise=torch.from_numpy(noise),
        step_noise=torch.from_numpy(step_noise)), raising=False)
    widths = []
    orig_shift = tshift.shift_tokens
    monkeypatch.setattr(tshift, "shift_tokens", lambda *a, **k: widths.append(a[2]) or
                        orig_shift(*a, **k))
    got = tp.sample(torch.from_numpy(lq), chop_size=64, chop_stride=48)
    assert got.shape == (1, 64, 160, 3)
    assert sorted(set(widths)) == [24, 48] and len(widths) == steps * 5 * 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3, atol=5e-3)


# ------------------------------------------------------------- hygiene

def test_port_imports_no_jax_flax_yaml_or_jax_package():
    # every module, the serving layer, DDPM, the load test, training and the
    # data-parallel layer among them
    code = ("import sys, pkgutil, importlib, resshift_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'resshift_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "need = ['resshift_tpu_torch.' + m for m in ('serve', 'utils.observability', "
            "'diffusion.ddpm', 'tools.serve_loadtest', 'train_loop', 'trainer', 'checkpoint', "
            "'diffusion.losses', 'data.datasets', 'data.realesrgan', 'data.noise', "
            "'data.degradations', 'ops.filters', 'ops.diffjpeg', 'parallel.mesh', "
            "'tools.multiprocess_proof')]\n"
            "assert all(m in sys.modules for m in need), need\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'yaml', 'resshift_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    pat = re.compile(r"^\s*(from|import)\s+(resshift_tpu|jax|flax|optax|orbax)\b(?!_torch)",
                     re.M)
    for f in (ROOT / "resshift_tpu_torch").rglob("*.py"):
        assert not pat.search(f.read_text()), f


def test_pipeline_without_cuda_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResShiftPipeline(small_config())
    assert ResShiftPipeline(small_config(), device="cpu").device.type == "cpu"
