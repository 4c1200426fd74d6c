"""The port's inpainting, face-restoration and x2 pieces against the JAX
package on the CPU, in f32, at a small width:

  * UNetModelSwin with the LQ feature pyramid (lq_size > image_size), the
    mask channel and 8 latent channels, through `from_flax` (equal to
    `export_unet_swin` key for key); `features_only` / `lq_feat=` equal one
    forward;
  * an f8-shaped VQGAN (ch_mult [1, 2, 4, 8], num_res_blocks [1, 2, 3, 4],
    z 8, a 4096 x 8 codebook) encode / decode, and kernel D's plain
    version exact on that codebook;
  * inpaint-, faceir- and x2-shaped pipelines against the JAX package's
    `ResShiftPipeline` with the same noise, one of them padded and tiled
    with its mask; the tile grid with mask tiles at sf 1 and 2.
Bands: the UNet rtol 1e-3 / atol 1e-4 and the VQGAN 1e-4 of the port's
other model tests; RGB rtol / atol 5e-3 (tests/test_e2e_parity.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resshift_tpu.convert import convert_unet_swin, convert_vqgan, export_unet_swin, export_vqgan
from resshift_tpu.diffusion import resshift as jrs
from resshift_tpu.models import UNetModelSwin as JUNet
from resshift_tpu.models import VQModel as JVQModel
from resshift_tpu.ops.tiling import TileGrid as JTileGrid
from resshift_tpu.ops.vq_pallas import nearest_codebook_indices_xla
from resshift_tpu.pipeline import ResShiftPipeline as JPipeline
from resshift_tpu_torch.convert import from_flax
from resshift_tpu_torch.models.unet import UNetModelSwin
from resshift_tpu_torch.models.vqgan import VQModel
from resshift_tpu_torch.ops import vq
from resshift_tpu_torch.ops.tiling import TileGrid
from resshift_tpu_torch.pipeline import ResShiftPipeline

torch.set_num_threads(1)

F4 = dict(double_z=False, z_channels=3, resolution=64, in_channels=3, out_ch=3, ch=32,
          ch_mult=[1, 2, 4], num_res_blocks=1, attn_resolutions=[], dropout=0.0)
F8 = dict(double_z=False, z_channels=8, resolution=128, in_channels=3, out_ch=3, ch=32,
          ch_mult=[1, 2, 4, 8], num_res_blocks=[1, 2, 3, 4], attn_resolutions=[], dropout=0.0)


def _unet(in_ch=3, out_ch=3, lq_size=64, cond_mask=False) -> dict:
    """The task UNets' structure at 32 channels, a 16^2 latent, window 4."""
    return dict(image_size=16, in_channels=in_ch, model_channels=32, out_channels=out_ch,
                attention_resolutions=[16, 8], dropout=0.0, channel_mult=[1, 2],
                num_res_blocks=[1, 1], conv_resample=True, num_head_channels=16,
                use_scale_shift_norm=True, resblock_updown=False, swin_depth=2,
                swin_embed_dim=32, window_size=4, mlp_ratio=2, cond_lq=True,
                cond_mask=cond_mask, lq_size=lq_size)


def _diffusion(sf, steps=3):
    return dict(schedule_name="exponential", steps=steps, min_noise_level=0.2, etas_end=0.99,
                kappa=2.0, power=0.3, predict_type="xstart", timestep_respacing=None,
                normalize_input=True, latent_flag=True, scale_factor=1.0, sf=sf)


# the shipped tasks' structure (config.py), cut in width and size: the LQ
# is 4x (inpainting), 8x (faceir) or 2x (x2) the 16^2 latent's side
TASKS = {
    "inpaint": dict(task="inpaint", sf=1, model=_unet(lq_size=64, cond_mask=True),
                    diffusion=_diffusion(1), autoencoder=dict(embed_dim=3, n_embed=64,
                                                              ddconfig=F4),
                    inference=dict(chop_size=64, chop_stride=48, padding_offset=16)),
    "faceir": dict(task="faceir", sf=1, model=_unet(in_ch=8, out_ch=8, lq_size=128),
                   diffusion=_diffusion(1), autoencoder=dict(embed_dim=8, n_embed=4096,
                                                             ddconfig=F8),
                   inference=dict(chop_size=128, chop_stride=112, padding_offset=16)),
    "x2": dict(task="realsr", sf=2, model=_unet(lq_size=32), diffusion=_diffusion(2),
               autoencoder=dict(embed_dim=3, n_embed=64, ddconfig=F4),
               inference=dict(chop_size=32, chop_stride=28, padding_offset=16)),
}


def _walk(m: dict) -> dict:
    return {k: m[k] for k in ("image_size", "channel_mult", "num_res_blocks",
                              "attention_resolutions", "swin_depth", "cond_lq", "lq_size")}


def random_state_dict(module: torch.nn.Module, seed: int) -> dict:
    """Seeded non-zero weights for every parameter (biases and zero-init
    convs included), so that every term reaches the output."""
    g = torch.Generator().manual_seed(seed)
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


def _numpy(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


# ------------------------------------------------------------------ UNet

@pytest.mark.parametrize("kind", ["inpaint", "faceir", "x2"])
def test_pyramid_unet_matches_jax(kind):
    m = TASKS[kind]["model"]
    tm = UNetModelSwin(**m).eval()
    params = convert_unet_swin(_numpy(random_state_dict(tm, 1)), **_walk(m))
    ours, ref = from_flax(params, "unet", **_walk(m)), export_unet_swin(params, **_walk(m))
    assert list(ours) == list(ref) and set(tm.state_dict()) == set(ref)
    assert sum(k.startswith("feature_extractor.") for k in ours) == 4 * int(
        np.log2(m["lq_size"] // m["image_size"]))
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    tm.load_state_dict({k: torch.tensor(v) for k, v in ours.items()})

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, m["in_channels"])).astype(np.float32)
    lq = rng.uniform(-1, 1, (2, m["lq_size"], m["lq_size"], 3)).astype(np.float32)
    mask = (np.sign(rng.uniform(-1, 1, (2, m["lq_size"], m["lq_size"], 1)))
            .astype(np.float32) if m["cond_mask"] else None)
    t = np.array([0, 2], np.int32)
    jm = JUNet(**m, use_pallas=False)
    want = jax.jit(lambda p, a, b, c, d: jm.apply({"params": p}, a, b, lq=c, mask=d))(
        params, x, t, lq, mask)
    tt = lambda a: None if a is None else torch.from_numpy(a)
    with torch.no_grad():
        got = tm(tt(x), torch.from_numpy(t).long(), lq=tt(lq), mask=tt(mask))
        feat = tm(None, None, lq=tt(lq), mask=tt(mask), features_only=True)
        again = tm(tt(x), torch.from_numpy(t).long(), lq_feat=feat)
    assert got.shape == (2, 16, 16, m["out_channels"])
    assert feat.shape == (2, 16, 16, 16 * m["lq_size"] // m["image_size"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    jfeat = jm.apply({"params": params}, None, None, lq=lq, mask=mask, features_only=True)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------- VQGAN

def test_f8_vqgan_matches_jax():
    jm = JVQModel(ddconfig=F8, n_embed=4096, embed_dim=8, use_pallas=False)
    tm = VQModel(F8, n_embed=4096, embed_dim=8).eval()
    walk = dict(ch_mult=F8["ch_mult"], num_res_blocks=F8["num_res_blocks"])
    params = convert_vqgan(_numpy(random_state_dict(tm, 3)), **walk)
    ours, ref = from_flax(params, "vqgan", **walk), export_vqgan(params, **walk)
    assert list(ours) == list(ref) and set(tm.state_dict()) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    tm.load_state_dict({k: torch.tensor(v) for k, v in ours.items()})
    # the decoder walks the per-level block counts reversed: 5, 4, 3, 2 blocks
    assert [len(tm.decoder.up[i].block) for i in (3, 2, 1, 0)] == [5, 4, 3, 2]

    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    z_j = jax.jit(lambda p, a: jm.apply({"params": p}, a, method=jm.encode))(params, x)
    with torch.no_grad():
        z_t = tm.encode(torch.from_numpy(x))
    assert z_t.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-4, atol=1e-4)
    img_j = jax.jit(lambda p, a: jm.apply({"params": p}, a, method=jm.decode))(params, z_j)
    with torch.no_grad():
        img_t = tm.decode(torch.tensor(np.asarray(z_j)))
    assert img_t.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-4, atol=1e-4)


def test_nearest_codebook_plain_exact_f8():
    rng = np.random.default_rng(5)
    z = rng.standard_normal((4096, 8)).astype(np.float32)
    emb = rng.standard_normal((4096, 8)).astype(np.float32)
    want = np.asarray(nearest_codebook_indices_xla(jnp.asarray(z), jnp.asarray(emb)))
    got = vq.nearest_codebook_indices(torch.from_numpy(z), torch.from_numpy(emb))
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------- pipelines

@functools.lru_cache(maxsize=None)
def _pipelines(kind):
    """A JAX and a port pipeline of one task with the same random weights."""
    cfg = TASKS[kind]
    tp = ResShiftPipeline(cfg, dtype=torch.float32, device="cpu")
    m, dd = cfg["model"], cfg["autoencoder"]["ddconfig"]
    walk = dict(ch_mult=dd["ch_mult"], num_res_blocks=dd["num_res_blocks"])
    params = {"unet": convert_unet_swin(_numpy(random_state_dict(tp.unet, 6)), **_walk(m)),
              "vqgan": convert_vqgan(_numpy(random_state_dict(tp.vq, 7)), **walk)}
    tp.load_state_dicts(unet=from_flax(params["unet"], "unet", **_walk(m)),
                        vqgan=from_flax(params["vqgan"], "vqgan", **walk))
    return JPipeline(cfg, dtype=jnp.float32), params, tp


def _jax_tile(jp, params, lq, mask, noise, step_noise):
    """JAX `_sample_tile` with the noise given: `_encode`, `_cond_kwargs`,
    `rs.sample_loop(noise=, step_noise=)`, `_decode`, clip."""
    z_y = jp._encode(params["vqgan"], lq, up_sample=True)

    def model_fn(x, t, **kw):
        return jp.unet.apply({"params": params["unet"]}, x, t, **kw)

    z0 = jrs.sample_loop(jp.sched, model_fn, z_y, jax.random.PRNGKey(0), noise=noise,
                         step_noise=step_noise, clip_denoised=False,
                         model_kwargs=jp._cond_kwargs(params, lq, mask))
    return jnp.clip(jp._decode(params["vqgan"], z0), -1.0, 1.0)


def _data(kind, b, h, w, seed):
    cfg = TASKS[kind]
    rng = np.random.default_rng(seed)
    lq = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    mask = None
    if cfg["model"]["cond_mask"]:  # a rectangle to fill (1) in a kept field (-1)
        mask = -np.ones((b, h, w, 1), np.float32)
        mask[:, h // 4:h // 2 + 3, w // 3:w - 5] = 1.0
    return lq, mask


def _noise(kind, n, lat_h, lat_w, seed):
    cfg = TASKS[kind]
    rng = np.random.default_rng(seed)
    shape = (n, lat_h, lat_w, cfg["model"]["in_channels"])
    steps = cfg["diffusion"]["steps"]
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((steps,) + shape).astype(np.float32))


@pytest.mark.parametrize("kind,lq_side", [("inpaint", 64), ("faceir", 128), ("x2", 32)])
def test_task_sample_tile_matches_jax(kind, lq_side):
    jp, params, tp = _pipelines(kind)
    lq, mask = _data(kind, 2, lq_side, lq_side, 8)
    noise, step_noise = _noise(kind, 2, 16, 16, 9)
    want = jax.jit(functools.partial(_jax_tile, jp))(params, lq, mask, noise, step_noise)
    tt = lambda a: None if a is None else torch.from_numpy(a)
    got = tp._sample_tile(tt(lq), None, tt(mask), noise=tt(noise), step_noise=tt(step_noise))
    side = lq_side * TASKS[kind]["sf"]
    assert got.shape == (2, side, side, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3, atol=5e-3)


def test_inpaint_padded_tiled_with_mask_matches_jax(monkeypatch):
    """A 72x100 image and its mask: reflect-padded to 80x112 (offset 16),
    four 64-px tiles (chop 64, stride 48) of image and mask in one chunk,
    overlap-averaged and cropped."""
    jp, params, tp = _pipelines("inpaint")
    lq, mask = _data("inpaint", 1, 72, 100, 10)
    noise, step_noise = _noise("inpaint", 4, 16, 16, 11)
    seen = []

    def jtile(p, tl, key, mask=None, noise_repeat=False):
        seen.append(mask.shape)
        return _jax_tile(jp, p, tl, mask, noise, step_noise)

    monkeypatch.setattr(jp, "_sample_tile", jtile, raising=False)
    want = jax.jit(lambda p, x, mk: jp._sample_padded(p, x, jax.random.PRNGKey(0), mk, False,
                                                      64, 48, 4))(params, lq, mask)
    assert seen == [(4, 64, 64, 1)]
    orig = tp._sample_tile
    monkeypatch.setattr(tp, "_sample_tile", lambda tl, gen, mask=None, noise_repeat=False: orig(
        tl, gen, mask, noise_repeat, noise=torch.from_numpy(noise),
        step_noise=torch.from_numpy(step_noise)), raising=False)
    got = tp.sample(torch.from_numpy(lq), mask=torch.from_numpy(mask), chop_size=64,
                    chop_stride=48, tile_bs=4)
    assert got.shape == (1, 72, 100, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("sf", [1, 2])
def test_tile_grid_with_mask_tiles_matches_jax(sf):
    """Inpainting's chop 256 / stride 224 (and its x2 rescale) over a padded
    320x576 image and its mask."""
    rng = np.random.default_rng(12)
    im = rng.standard_normal((2, 320, 576, 4)).astype(np.float32)  # RGB + mask
    tg, jg = TileGrid(320, 576, 256, 224, sf=sf), JTileGrid(320, 576, 256, 224, sf=sf)
    assert tg.starts == jg.starts and tg.num_tiles == 6
    tiles = tg.split(torch.from_numpy(im))
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jg.split(jnp.asarray(im))))
    np.testing.assert_array_equal(tg.split(torch.from_numpy(im[..., 3:])).numpy(),
                                  tiles[..., 3:].numpy())
    up = tiles[..., :3].repeat_interleave(sf, 1).repeat_interleave(sf, 2)
    np.testing.assert_allclose(tg.gather(up, 2).numpy(),
                               np.asarray(jg.gather(jnp.asarray(up.numpy()), 2)),
                               rtol=1e-6, atol=1e-6)


def test_use_pallas_pins_follow_jax(monkeypatch):
    """The config keys `model.use_pallas` (the JAX package's) and
    `autoencoder.use_pallas` pin kernel F in the UNet head, once per step,
    and in the decoder tail.  `model.use_pallas: false` is the JAX
    package's pin to the plain composition: the Swin blocks call the plain
    versions and none of A's, B's or E's wrappers; `autoencoder.use_pallas:
    false` pins the VQGAN likewise (the tri-state of the JAX package's
    VQModel): none of C's or D's wrappers.  On the CPU the wrappers run the
    plain versions, so the output is the same bit for bit."""
    from resshift_tpu_torch.ops import flash_attention, swin_block, tail

    wrappers = [(swin_block, n) for n in ("norm_attn_residual_stats", "shift_attn_residual_stats",
                                          "norm_mlp_residual_stats", "mlp_unshift_residual_stats")]
    wrappers += [(flash_attention, "flash_attention_1h"), (vq, "nearest_codebook_indices"),
                 (tail, "gn_silu_conv3x3")]
    calls = []
    for mod, name in wrappers:
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: calls.append(
            (_n, k.get("use_pallas"))) or _o(*a, **k))
    lq, mask = _data("inpaint", 1, 64, 64, 14)
    outs = {}
    for pin in (True, False):
        cfg = dict(TASKS["inpaint"], model=dict(TASKS["inpaint"]["model"], use_pallas=pin),
                   autoencoder=dict(TASKS["inpaint"]["autoencoder"], use_pallas=pin))
        pipe = ResShiftPipeline(cfg, dtype=torch.float32, device="cpu")
        assert pipe.unet.use_pallas is pin and pipe.vq.decoder.use_pallas is pin
        pipe.init_params(0)
        calls.clear()
        outs[pin] = pipe.sample(torch.from_numpy(lq), torch.Generator().manual_seed(1),
                                torch.from_numpy(mask))
        steps = TASKS["inpaint"]["diffusion"]["steps"]
        assert calls.count(("gn_silu_conv3x3", pin)) == steps + 1
        pinned = {n for m, n in wrappers if m is not tail}  # A, B, E, C and D
        assert {n for n, _ in calls} == {n for _, n in wrappers} - (set() if pin else pinned)
    torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=0)


def test_x2_pads_an_untiled_side_to_the_unets_multiple(monkeypatch):
    """At x2 the latent is half the LQ side, so a side that `padding_offset`
    pads to an odd multiple of half the UNet's multiple gives a Swin level
    the windows do not divide (the JAX package raises there).  The port
    pads such a side on to `lq_multiple` by reflection: a 20x28 input
    (offset 8: 24x32) goes to 32x32, and the result equals the JAX tile on
    that padded input, cropped.  Where the padding exceeds the side the
    reflection repeats, as numpy's does."""
    cfg = dict(TASKS["x2"], inference=dict(TASKS["x2"]["inference"], padding_offset=8))
    jp, params, src = _pipelines("x2")
    tp = ResShiftPipeline(cfg, dtype=torch.float32, device="cpu")
    tp.unet, tp.vq = src.unet, src.vq
    assert tp.lq_multiple == 16 and 24 % tp.lq_multiple
    lq, _ = _data("x2", 1, 20, 28, 15)
    noise, step_noise = _noise("x2", 1, 16, 16, 16)
    lq_pad = np.pad(lq, ((0, 0), (0, 12), (0, 4), (0, 0)), mode="reflect")
    want = jax.jit(functools.partial(_jax_tile, jp))(params, lq_pad, None, noise, step_noise)
    seen = []
    orig = tp._sample_tile

    def tile(tl, gen, mask=None, noise_repeat=False):
        seen.append(tl.numpy().copy())
        return orig(tl, gen, mask, noise_repeat, noise=torch.from_numpy(noise),
                    step_noise=torch.from_numpy(step_noise))

    monkeypatch.setattr(tp, "_sample_tile", tile, raising=False)
    got = tp.sample(torch.from_numpy(lq))
    np.testing.assert_array_equal(seen[0], lq_pad)
    assert got.shape == (1, 40, 56, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :40, :56], rtol=5e-3, atol=5e-3)
    seen.clear()
    monkeypatch.setattr(tp, "_sample_tile", lambda tl, *a: seen.append(tl.numpy().copy()) or
                        torch.zeros(tl.shape[0], 2 * tl.shape[1], 2 * tl.shape[2], 3),
                        raising=False)
    small = lq[:, :6, :5]
    assert tp.sample(torch.from_numpy(small)).shape == (1, 12, 10, 3)
    np.testing.assert_array_equal(seen[0], np.pad(small, ((0, 0), (0, 10), (0, 11), (0, 0)),
                                                  mode="reflect"))
