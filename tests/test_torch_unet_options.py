"""The UNet options of the port against the JAX package's UNetModelSwin,
small and in f32: `resblock_updown`, `patch_norm`, `conv_resample=False`
and `use_scale_shift_norm=False`, each on its own and all four together,
through `from_flax(..., "unet")`; the ResBlock, Upsample and Downsample
options alone against the JAX layers.

The JAX parameter trees come from `jax.eval_shape` of `init` (no compile),
filled from a numpy seed with non-zero values everywhere, so that every
branch reaches the output.
"""

import numpy as np
import pytest
import torch

import jax
from flax.traverse_util import flatten_dict, unflatten_dict

from resshift_tpu.convert import export_unet_swin
from resshift_tpu.models import UNetModelSwin as JUNet
from resshift_tpu.models import layers as jlayers
from resshift_tpu_torch import convert
from resshift_tpu_torch.convert import from_flax
from resshift_tpu_torch.models import layers
from resshift_tpu_torch.models.unet import UNetModelSwin

torch.set_num_threads(1)

CFG = dict(image_size=16, in_channels=3, model_channels=32, out_channels=3,
           attention_resolutions=[16, 8], dropout=0.0, channel_mult=[1, 2],
           num_res_blocks=[1, 1], conv_resample=True, num_head_channels=16,
           use_scale_shift_norm=True, resblock_updown=False, swin_depth=2,
           swin_embed_dim=32, window_size=8, mlp_ratio=4, cond_lq=True, lq_size=16)
WALK_KEYS = ("image_size", "channel_mult", "num_res_blocks", "attention_resolutions",
             "swin_depth", "lq_size", "resblock_updown", "conv_resample")
OPTIONS = {"resblock_updown": dict(resblock_updown=True), "patch_norm": dict(patch_norm=True),
           "no_conv_resample": dict(conv_resample=False),
           "no_scale_shift": dict(use_scale_shift_norm=False),
           "all_four": dict(resblock_updown=True, patch_norm=True, conv_resample=False,
                            use_scale_shift_norm=False)}


def random_params(init, seed: int) -> dict:
    """A Flax parameter tree of `init`'s shapes, filled from a numpy seed:
    kernels ~ N(0, 1 / fan_in), GroupNorm scales 1 + N(0, 0.1), the rest
    N(0, 0.05)."""
    shapes = jax.eval_shape(init)["params"]
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flatten_dict(shapes).items():
        r = rng.standard_normal(v.shape).astype(np.float32)
        if v.ndim >= 2 and k[-1] != "relative_position_bias_table":
            out[k] = r / np.sqrt(np.prod(v.shape[:-1]))
        elif k[-1] == "scale":
            out[k] = 1 + 0.1 * r
        else:
            out[k] = 0.05 * r
    return unflatten_dict(out)


def _load(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})  # strict: every key
    return module.eval()


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_unet_option_matches_jax(option):
    cfg = {**CFG, **OPTIONS[option]}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    lq = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    t = np.array([3, 11], np.int32)
    jm = JUNet(**cfg, use_pallas=False)
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0), x, t, lq=lq), 0)
    walk = {k: cfg[k] for k in WALK_KEYS}
    ours = from_flax(params, "unet", **walk)
    if cfg["conv_resample"]:  # the JAX walk maps only resampling with convs
        ref = export_unet_swin(params, **{k: v for k, v in walk.items() if k != "conv_resample"})
        assert list(ours) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    tm = _load(UNetModelSwin(**cfg), ours)
    want = jax.jit(lambda p, a, b, c: jm.apply({"params": p}, a, b, lq=c))(params, x, t, lq)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long(), lq=torch.from_numpy(lq))
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


RESBLOCKS = {"up": dict(up=True), "down": dict(down=True),
             "conv_skip": dict(out_channels=64, use_conv=True),
             "no_scale_shift_down": dict(use_scale_shift_norm=False, down=True, out_channels=64)}


@pytest.mark.parametrize("case", sorted(RESBLOCKS))
def test_resblock_options_match_jax(case):
    kw = RESBLOCKS[case]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    emb = rng.standard_normal((2, 64)).astype(np.float32)
    jm = jlayers.ResBlock(channels=32, emb_channels=64, **kw)
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0), x, emb), 3)
    tm = layers.ResBlock(32, 64, out_channels=kw.get("out_channels"),
                         use_conv=kw.get("use_conv", False),
                         use_scale_shift_norm=kw.get("use_scale_shift_norm", True),
                         up=kw.get("up", False), down=kw.get("down", False))
    sd = {}
    convert._resblock(flatten_dict(params), sd, "blk", ())  # the UNet walks' mapping
    _load(tm, {k.removeprefix("blk."): v for k, v in sd.items()})
    want = jm.apply({"params": params}, x, emb)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(emb))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("up", [False, True])
def test_resample_without_conv_matches_jax(up):
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 16)).astype(np.float32)
    jm = (jlayers.Upsample if up else jlayers.Downsample)(16, False)
    want = jm.apply({}, x)
    tm = (layers.Upsample if up else layers.Downsample)(16, use_conv=False)
    assert not list(tm.parameters())
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("patch_norm", [False, True])
@pytest.mark.parametrize("side", [8, 16])
def test_basic_layer_hands_the_kernels_contiguous_tokens(monkeypatch, patch_norm, side):
    """The CPU tensors take the kernels' branch; each launch checks its
    tokens as the kernel wrappers do on the card (`_check_tokens`), then
    runs the plain version.  A single window (side 8) made a strided view of
    the patch-embedded map."""
    from resshift_tpu_torch.models.swin import BasicLayer
    from resshift_tpu_torch.ops import swin_block as tsb

    seen = []

    def launch(plain):
        def kernel(x, *args, geom):
            seen.append(tsb._check_tokens(x))
            return plain(x, *args) if geom is None else plain(x, *args, *geom)
        return kernel

    monkeypatch.setattr(tsb, "_on_cpu", lambda x: False)
    monkeypatch.setattr(tsb, "_attn_kernel", launch(tsb.norm_attn_residual_stats_plain))
    monkeypatch.setattr(tsb, "_mlp_kernel", launch(tsb.norm_mlp_residual_stats_plain))
    layer = BasicLayer(32, 32, 2, 8, depth=1, build_resolution=side, patch_norm=patch_norm)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 32, side, side)))
    with torch.no_grad():
        out = layer(x.float())
    assert out.shape == (2, 32, side, side) and len(seen) == 2
