"""The trainable variants of the port against the JAX package's, small and
in f32: `pixel_unshuffle`, the attention scale's rounding,
`GlobalAttentionBlock` in both qkv layouts, `UNetModel` (class labels,
pixel-unshuffled LQ, both attention orders) with `from_flax(...,
"unet_plain")` key for key against `export_unet_plain` and one gradient
against `jax.grad`, `UNetModelConv` with and without scale-shift and
`resblock_updown`, a VQModel with `attn_resolutions` and without resampling
convs, `AutoencoderKL`'s mode, decode and sampled posterior (JAX's noise
passed in), and `IdentityFirstStage`.

The JAX parameter trees come from `jax.eval_shape` of `init`, filled from
a numpy seed, and load strictly (`test_torch_unet_options.random_params`,
`_load`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resshift_tpu.convert import export_unet_plain, export_vqgan
from resshift_tpu.models import AutoencoderKL as JAutoencoderKL
from resshift_tpu.models import IdentityFirstStage as JIdentity
from resshift_tpu.models import UNetModel as JUNetModel
from resshift_tpu.models import UNetModelConv as JUNetModelConv
from resshift_tpu.models import VQModel as JVQModel
from resshift_tpu.models import unet_variants as jvariants
from resshift_tpu_torch.convert import from_flax
from resshift_tpu_torch.models import (AutoencoderKL, GlobalAttentionBlock, IdentityFirstStage,
                                       UNetModel, UNetModelConv, VQModel)
from resshift_tpu_torch.models import unet_variants
from test_torch_unet_options import _load, random_params

torch.set_num_threads(1)

ATTN = dict(channels=32, num_head_channels=16)
PLAIN = dict(image_size=16, model_channels=32, out_channels=3, num_res_blocks=1,
             attention_resolutions=(16, 8), channel_mult=(1, 2), cond_lq=True)
PLAIN_CASES = {  # (options, LQ side): a 32-px LQ is pixel-unshuffled to 12 channels
    "legacy_classes_unshuffled": (dict(num_classes=5, num_head_channels=16), 32),
    "new_order_updown_scale_shift": (dict(use_new_attention_order=True, num_heads=2,
                                          resblock_updown=True, use_scale_shift_norm=True), 16)}
PLAIN_WALK = ("image_size", "channel_mult", "num_res_blocks", "attention_resolutions",
              "num_classes", "resblock_updown")
CONV = dict(model_channels=16, out_channels=3, num_res_blocks=1, channel_mult=(1, 2),
            cond_lq=True)
CONV_CASES = {"plain_no_resample_conv": dict(conv_resample=False),
              "scale_shift": dict(use_scale_shift_norm=True),
              "scale_shift_updown": dict(use_scale_shift_norm=True, resblock_updown=True)}
DD = dict(z_channels=4, resolution=32, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
          num_res_blocks=1, attn_resolutions=[16], dropout=0.0)
VQ_CASES = {"attn_resolutions": dict(double_z=False),
            "attn_no_resample_conv": dict(double_z=True, resamp_with_conv=False)}


def _torch(x):
    return torch.from_numpy(np.array(x))


def test_pixel_unshuffle_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 3)).astype(np.float32)
    want = jvariants.pixel_unshuffle(jnp.asarray(x), 2)
    np.testing.assert_array_equal(unet_variants.pixel_unshuffle(_torch(x), 2).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_scale_rounds_as_jax(dtype):
    for hd in (3, 16, 20, 32, 40, 64, 80, 160):
        want = 1 / jnp.sqrt(jnp.sqrt(jnp.asarray(hd, jnp.float32))).astype(dtype)
        got = unet_variants.attention_scale(hd, getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype)
        assert got.float().item() == float(np.asarray(want, np.float32)), hd


@pytest.mark.parametrize("new_order", [False, True])
def test_global_attention_block_matches_jax(new_order):
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 32)).astype(np.float32)
    jm = jvariants.GlobalAttentionBlock(**ATTN, use_new_attention_order=new_order)
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0), x), 2)
    sd = {"norm.weight": params["norm"]["scale"], "norm.bias": params["norm"]["bias"]}
    for name in ("qkv", "proj_out"):  # Dense (in, out) -> Conv1d (out, in, 1)
        sd[f"{name}.weight"] = np.asarray(params[name]["kernel"]).T[:, :, None]
        sd[f"{name}.bias"] = params[name]["bias"]
    tm = _load(GlobalAttentionBlock(32, num_head_channels=16, use_new_attention_order=new_order),
               sd)
    want = jm.apply({"params": params}, x)
    with torch.no_grad():
        got = tm(_torch(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _plain_inputs(lq_side: int):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    lq = rng.uniform(-1, 1, (2, lq_side, lq_side, 3)).astype(np.float32)
    return x, lq, np.array([3, 11], np.int32), np.array([1, 4], np.int32)


def _plain_pair(case: str, **overrides):
    opts, lq_side = PLAIN_CASES[case]
    cfg = {**PLAIN, **opts, **overrides}
    x, lq, t, y = _plain_inputs(lq_side)
    y = y if cfg.get("num_classes") else None
    jm = JUNetModel(**cfg)
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0), x, t, y=y, lq=lq), 4)
    walk = {k: cfg[k] for k in PLAIN_WALK if k in cfg}
    lq_ch = 3 * (lq_side // 16) ** 2
    tm = UNetModel(**cfg, in_channels=3 + lq_ch)
    return jm, params, walk, tm, (x, lq, t, y)


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_unet_plain_matches_jax_and_export(case):
    jm, params, walk, tm, (x, lq, t, y) = _plain_pair(case)
    ours = from_flax(params, "unet_plain", **walk)
    ref = export_unet_plain(params, **walk)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    _load(tm, ours)
    want = jax.jit(lambda p: jm.apply({"params": p}, x, t, y=y, lq=lq))(params)
    with torch.no_grad():
        got = tm(_torch(x), _torch(t).long(), None if y is None else _torch(y).long(),
                 lq=_torch(lq))
    assert got.shape == (2, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


def test_unet_plain_gradient_matches_jax():
    """d/dparams of sum(out * w), each tensor within rtol 1e-4 and atol 1e-4
    of its largest magnitude (+ 1e-7): the band that the train step's whole
    UNet gradient is held to against JAX's.  64 channels, so that every
    GroupNorm group holds two channels and no conv bias before one has a
    gradient that is zero but for rounding."""
    jm, params, walk, tm, (x, lq, t, y) = _plain_pair("legacy_classes_unshuffled",
                                                      model_channels=64)
    _load(tm, from_flax(params, "unet_plain", **walk))
    w = np.random.default_rng(5).standard_normal((2, 16, 16, 3)).astype(np.float32)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, x, t, y=y, lq=lq) * w)))(
        params)
    want = from_flax(grads, "unet_plain", **walk)
    (tm(_torch(x), _torch(t).long(), _torch(y).long(), lq=_torch(lq)) * _torch(w)).sum().backward()
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[n], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[n]).max() + 1e-7, err_msg=n)
    assert all(g.abs().max() > 0 for g in got.values())


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_unet_conv_matches_jax(case):
    cfg = {**CONV, **CONV_CASES[case]}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    lq = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)  # pixel-unshuffled
    t = np.array([2, 9], np.int32)
    jm = JUNetModelConv(**cfg)
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0), x, t, lq=lq), 7)
    walk = {k: cfg[k] for k in ("channel_mult", "num_res_blocks", "resblock_updown",
                                "conv_resample") if k in cfg}
    tm = _load(UNetModelConv(**cfg, in_channels=15), from_flax(params, "unet_conv", **walk))
    want = jm.apply({"params": params}, x, t, lq=lq)
    with torch.no_grad():
        got = tm(_torch(x), _torch(t).long(), lq=_torch(lq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("case", sorted(VQ_CASES))
def test_vqmodel_options_match_jax(case):
    dd = {**DD, **VQ_CASES[case]}
    x = np.random.default_rng(8).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jm = JVQModel(ddconfig=dd, n_embed=64, embed_dim=4, use_pallas=False)
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0), x), 9)
    walk = {k: dd[k] for k in ("ch_mult", "num_res_blocks", "attn_resolutions", "resolution")}
    walk["resamp_with_conv"] = dd.get("resamp_with_conv", True)
    ours = from_flax(params, "vqgan", **walk)
    if walk["resamp_with_conv"]:  # the JAX walk maps only resampling with convs
        ref = export_vqgan(params, **{k: v for k, v in walk.items() if k != "resamp_with_conv"})
        assert list(ours) == list(ref)
    assert any(".attn.0." in k for k in ours)
    tm = _load(VQModel(dd, n_embed=64, embed_dim=4), ours)
    z_j = jax.jit(lambda p: jm.apply({"params": p}, x, method=jm.encode))(params)
    img_j = jax.jit(lambda p: jm.apply({"params": p}, z_j, method=jm.decode))(params)
    with torch.no_grad():
        z_t = tm.encode(_torch(x))
        img_t = tm.decode(_torch(z_j))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-4, atol=1e-4)


def test_autoencoder_kl_matches_jax():
    dd = {**DD, "double_z": True}
    x = np.random.default_rng(10).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jm = JAutoencoderKL(ddconfig=dd, embed_dim=4, use_pallas=False)
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0), x), 11)
    walk = {k: dd[k] for k in ("ch_mult", "num_res_blocks", "attn_resolutions", "resolution")}
    tm = _load(AutoencoderKL(dd, embed_dim=4), from_flax(params, "autoencoder_kl", **walk))
    key = jax.random.PRNGKey(12)
    mode_j, moments_j, sample_j, img_j = jax.jit(lambda p: (
        *jm.apply({"params": p}, x, None, True, True, method=jm.encode),
        jm.apply({"params": p}, x, key, True, method=jm.encode),
        jm.apply({"params": p}, jm.apply({"params": p}, x, method=jm.encode),
                 method=jm.decode)))(params)
    noise = jax.random.normal(key, mode_j.shape, dtype=jnp.float32)
    with torch.no_grad():
        mode_t, moments_t = tm.encode(_torch(x), return_moments=True)
        sample_t = tm.encode(_torch(x), noise=_torch(noise))
        drawn = tm.encode(_torch(x), generator=torch.Generator().manual_seed(0))
        img_t = tm.decode(_torch(mode_j))
    assert mode_t.shape == (2, 16, 16, 4) and moments_t.shape == (2, 16, 16, 8)
    for got, want in ((mode_t, mode_j), (moments_t, moments_j), (sample_t, sample_j),
                      (img_t, img_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert (sample_t - mode_t).abs().max() > 0 and (drawn - mode_t).abs().max() > 0
    with torch.no_grad():  # no posterior sample without a generator or noise
        torch.testing.assert_close(tm.encode(_torch(x)), mode_t, rtol=0, atol=0)
        torch.testing.assert_close(tm.encode(_torch(x), generator=torch.Generator(),
                                             sample_posterior=False), mode_t, rtol=0, atol=0)


def test_identity_first_stage():
    y = np.random.default_rng(13).standard_normal((1, 4, 4, 3)).astype(np.float32)
    ident = IdentityFirstStage()
    want = np.asarray(JIdentity().apply({}, y))
    for fn in (ident, ident.encode, ident.decode):
        np.testing.assert_array_equal(fn(_torch(y)).numpy(), want)
    assert not list(ident.parameters())


def test_chip_smoke_counts_the_kl_attention_blocks():
    """Phase 20(b)'s derived count of kernel C's launches equals the
    AttnBlocks of the model (attention at two levels, uneven blocks)."""
    import sys
    from pathlib import Path

    from resshift_tpu_torch.models.vqgan import AttnBlock

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    dd = dict(DD, double_z=True, ch=32, ch_mult=[1, 2, 2], num_res_blocks=[1, 2, 1],
              attn_resolutions=[32, 8], resolution=32)
    blocks = sum(isinstance(m, AttnBlock) for m in AutoencoderKL(dd, embed_dim=4).modules())
    assert chip_smoke.kl_attention_blocks(dd) == blocks == 2 + (1 + 2) + (1 + 2)
