"""The port's degradation modules against the JAX package's, on the CPU.

  * resize: every mode (bicubic_torch with and without antialias,
    bicubic_matlab, bilinear, nearest, area) on tensors within rtol 1e-5 /
    atol 1e-6; `resize_np` and `imresize_matlab` bit for bit (the same
    float64 numpy); `upsample_nearest` exactly;
  * `filter2d` (one kernel and one a sample) and `usm_sharp` within 1e-5;
  * `diff_jpeg`: values within 1e-4, except where a quantised coefficient
    rounds the other way (the two DCTs sum in other orders): those stay
    under 1% of the values;
  * the noise stages given the JAX package's draws (Gaussian: its unit
    normals; Poisson: its counts) within 1e-6, and `_vals_from_unique`
    exactly;
  * `degradations.py`'s kernels and `RealESRGANData` items bit for bit for
    the same seed and PNG files;
  * the whole degrader, its noise stages given JAX's draws: GT crops bit for
    bit, LQ within one 8-bit level except for under 1% of values;
  * the training-pair queue, which swaps from the 11th call at the default
    size of 10 batches.
Inputs come from numpy with a seed.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resshift_tpu.data import datasets as jds
from resshift_tpu.data import degradations as jdeg
from resshift_tpu.data import noise as jnoise
from resshift_tpu.data import realesrgan as jre
from resshift_tpu.ops import diffjpeg as jjpeg
from resshift_tpu.ops import filters as jfilters
from resshift_tpu_torch.data import datasets as tds
from resshift_tpu_torch.data import degradations as tdeg
from resshift_tpu_torch.data import noise as tnoise
from resshift_tpu_torch.data import realesrgan as tre
from resshift_tpu_torch.ops import diffjpeg as tjpeg
from resshift_tpu_torch.ops import filters as tfilters
from resshift_tpu_torch.ops import resize as tresize
from resshift_tpu_torch.utils.image_io import imwrite

torch.set_num_threads(2)
# the module (the package's `resize` name is the function)
jresize = importlib.import_module("resshift_tpu.ops.resize")


def _img(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("mode,aa", [("bicubic_torch", False), ("bicubic_torch", True),
                                     ("bicubic_matlab", True), ("bilinear", False),
                                     ("nearest", False), ("area", False)])
@pytest.mark.parametrize("out_hw", [(13, 29), (40, 17)])
def test_resize_modes_match_jax(mode, aa, out_hw):
    x = _img(0, 2, 24, 20, 3)
    want = np.asarray(jresize.resize(jnp.asarray(x), out_hw, mode, aa))
    got = tresize.resize(torch.from_numpy(x), out_hw, mode, aa)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for nd in (x[0], x[0, ..., 0]):  # HWC and HW
        want = np.asarray(jresize.resize(jnp.asarray(nd), out_hw, mode, aa))
        np.testing.assert_allclose(tresize.resize(torch.from_numpy(nd), out_hw, mode, aa).numpy(),
                                   want, rtol=1e-5, atol=1e-6)
    # the host version: the same float64 arithmetic, bit for bit
    np.testing.assert_array_equal(tresize.resize_np(x[0], out_hw, mode, aa),
                                  jresize.resize_np(x[0], out_hw, mode, aa))


@pytest.mark.parametrize("seed", range(6))
def test_resize_np_bit_identical_at_random_sizes(seed):
    """The banded host resize against the JAX package's dense einsum, bit for
    bit, at random sides (large downscales, where a band holds many taps,
    among them) in every mode."""
    rng = np.random.default_rng(100 + seed)
    for mode in ("bicubic_torch", "bicubic_matlab", "bilinear", "nearest", "area"):
        h, w = (int(v) for v in rng.integers(3, 700, 2))
        oh, ow = (int(v) for v in rng.integers(2, 300, 2))
        x = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        aa = bool(rng.integers(2))
        np.testing.assert_array_equal(tresize.resize_np(x, (oh, ow), mode, aa),
                                      jresize.resize_np(x, (oh, ow), mode, aa),
                                      err_msg=f"{mode} {(h, w)} -> {(oh, ow)} aa={aa}")


def test_resize_matrices_cached_per_device():
    m1 = tresize.resize_matrix(24, 13, "area")
    assert tresize.resize_matrix(24, 13, "area") is m1


def test_imresize_matlab_and_nearest_upsample_match_jax():
    x = _img(1, 30, 22, 3)
    for scale in (0.25, 0.5, 2.0):
        np.testing.assert_array_equal(tresize.imresize_matlab(x, scale),
                                      jresize.imresize_matlab(x, scale))
    y = _img(2, 2, 5, 7, 3)
    np.testing.assert_array_equal(tresize.upsample_nearest(torch.from_numpy(y), 3).numpy(),
                                  np.asarray(jresize.upsample_nearest(jnp.asarray(y), 3)))


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("k", [3, 21])
def test_filter2d_matches_jax(per_sample, k):
    x = _img(3, 3, 16, 18, 3)
    kern = np.random.default_rng(4).uniform(0, 1, (3 if per_sample else 1, k, k)).astype(
        np.float32)
    kern /= kern.sum((1, 2), keepdims=True)
    want = np.asarray(jfilters.filter2d(jnp.asarray(x), jnp.asarray(kern)))
    got = tfilters.filter2d(torch.from_numpy(x), torch.from_numpy(kern))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_usm_sharp_matches_jax():
    x = _img(5, 2, 40, 36, 3)
    np.testing.assert_array_equal(tfilters.gaussian_kernel2d(51, 0.0),
                                  jfilters.gaussian_kernel2d(51, 0.0))
    want = np.asarray(jfilters.usm_sharp(jnp.asarray(x)))
    got = tfilters.usm_sharp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("differentiable", [False, True])
def test_diff_jpeg_matches_jax(differentiable):
    x = _img(6, 2, 24, 40, 3)
    q = np.array([35.0, 80.0], np.float32)
    want = np.asarray(jjpeg.diff_jpeg(jnp.asarray(x), jnp.asarray(q), differentiable))
    got = tjpeg.diff_jpeg(torch.from_numpy(x), torch.from_numpy(q), differentiable).numpy()
    assert got.shape == want.shape
    flips = np.abs(got - want) > 1e-4
    # where a quantised coefficient rounds the other way the block moves
    # by up to a quantisation step; elsewhere the two agree within 1e-4
    assert flips.mean() < 0.01, flips.mean()
    np.testing.assert_array_equal(tjpeg.quality_to_factor(torch.tensor([20.0, 70.0])).numpy(),
                                  np.asarray(jjpeg.quality_to_factor(jnp.asarray([20.0, 70.0]))))


def test_diff_jpeg_differentiable_has_a_gradient():
    x = torch.from_numpy(_img(7, 1, 16, 16, 3)).requires_grad_(True)
    (g,) = torch.autograd.grad(tjpeg.diff_jpeg(x, 50.0, differentiable=True).sum(), x)
    assert g.abs().sum() > 0


def test_gaussian_noise_with_jax_draws():
    x = _img(8, 3, 12, 10, 3)
    sigma, gray = np.array([5.0, 20.0, 30.0], np.float32), np.array([0.0, 1.0, 0.0], np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jnoise.add_gaussian_noise(key, jnp.asarray(x), jnp.asarray(sigma),
                                                jnp.asarray(gray)))
    kc, kg = jax.random.split(key)
    draws = dict(noise=torch.tensor(np.asarray(jax.random.normal(kc, x.shape))),
                 gray_noise=torch.tensor(np.asarray(jax.random.normal(kg, (3, 12, 10, 1)))))
    got = tnoise.add_gaussian_noise(torch.from_numpy(x), torch.from_numpy(sigma),
                                    torch.from_numpy(gray), **draws)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_poisson_noise_with_jax_draws():
    x = _img(9, 2, 12, 10, 3)
    x[1] = np.round(x[1] * 8) / 8  # few levels: a small vals
    scale, gray = np.array([0.5, 2.0], np.float32), np.array([1.0, 0.0], np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jnoise.add_poisson_noise(key, jnp.asarray(x), jnp.asarray(scale),
                                               jnp.asarray(gray)))
    kc, kg = jax.random.split(key)
    imgq = jnp.clip(jnp.round(jnp.asarray(x) * 255.0), 0, 255) / 255.0
    vals = jnoise._vals_from_unique(imgq).reshape(2, 1, 1, 1)
    gq = jnp.clip(jnp.round(jnoise._to_gray(jnp.asarray(x)) * 255.0), 0, 255) / 255.0
    vals_g = jnoise._vals_from_unique(gq).reshape(2, 1, 1, 1)
    counts = jax.random.poisson(kc, imgq * vals, dtype=jnp.int32)
    gcounts = jax.random.poisson(kg, gq * vals_g, dtype=jnp.int32)
    got = tnoise.add_poisson_noise(torch.from_numpy(x), torch.from_numpy(scale),
                                   torch.from_numpy(gray),
                                   counts=torch.tensor(np.asarray(counts)),
                                   gray_counts=torch.tensor(np.asarray(gcounts)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tnoise._vals_from_unique(torch.tensor(np.asarray(imgq))),
                                  np.asarray(jnoise._vals_from_unique(imgq)))


def test_noise_draws_from_a_generator():
    x = torch.from_numpy(_img(10, 2, 8, 8, 3))
    a = tnoise.add_poisson_noise(x, torch.ones(2), torch.zeros(2), torch.Generator().manual_seed(1))
    b = tnoise.add_poisson_noise(x, torch.ones(2), torch.zeros(2), torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, x)


def test_degradation_kernels_bit_identical():
    lists = ["iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso",
             "plateau_aniso"]
    probs = [0.45, 0.25, 0.12, 0.03, 0.12, 0.03]
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(20):
        np.testing.assert_array_equal(
            tdeg.random_mixed_kernels(r1, lists, probs, 21, noise_range=(0.8, 1.2)),
            jdeg.random_mixed_kernels(r2, lists, probs, 21, noise_range=(0.8, 1.2)))
        np.testing.assert_array_equal(
            tdeg.random_sinc_or_mixed(r1, 13, 0.5, lists, probs, (0.2, 3), (0.5, 4), (1, 2)),
            jdeg.random_sinc_or_mixed(r2, 13, 0.5, lists, probs, (0.2, 3), (0.5, 4), (1, 2)))
    np.testing.assert_array_equal(tdeg.circular_lowpass_kernel(1.3, 9, pad_to=21),
                                  jdeg.circular_lowpass_kernel(1.3, 9, pad_to=21))
    np.testing.assert_array_equal(tdeg.pulse_kernel(15), jdeg.pulse_kernel(15))


@pytest.fixture(scope="module")
def hq_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hq")
    rng = np.random.default_rng(12)
    for i, (h, w) in enumerate([(100, 90), (64, 130), (50, 60), (96, 96)]):
        imwrite(rng.uniform(0, 1, (h, w, 3)), d / f"{i}.png")
    return d


@pytest.mark.parametrize("kw", [dict(), dict(use_rot=True, rescale_gt=False, crop_pad_size=80),
                                dict(mode="testing")])
def test_realesrgan_items_bit_identical(hq_dir, kw):
    args = dict(dir_paths=[str(hq_dir)], gt_size=64, seed=5, **kw)
    t, j = tds.create_dataset(dict(type="realesrgan", params=args)), jds.create_dataset(
        dict(type="realesrgan", params=args))
    assert t.paths == j.paths
    for i in [0, 1, 2, 3, 1]:
        a, b = t[i], j[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_other_dataset_types_name_the_roadmap():
    """Packed files are ported: a missing one raises OSError naming it."""
    with pytest.raises(OSError, match="x.pack"):
        tds.create_dataset(dict(type="base", params=dict(pack_path="x.pack")))


def _jax_draws(key):
    """The noise draws of the JAX degrader's stages, from its key."""
    keys = jax.random.split(key, 8)

    def draws(stage, gauss, img):
        assert gauss
        kc, kg = jax.random.split(keys[stage])
        b, h, w, _ = img.shape
        return dict(noise=torch.tensor(np.asarray(jax.random.normal(kc, tuple(img.shape)))),
                    gray_noise=torch.tensor(np.asarray(jax.random.normal(kg, (b, h, w, 1)))))
    return draws


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_degrader_matches_jax_with_its_draws(hq_dir, seed):
    ds = jds.create_dataset(dict(type="realesrgan", params=dict(
        dir_paths=[str(hq_dir)], gt_size=96, seed=seed)))
    batch = {k: np.stack([ds[i][k] for i in range(2)]) for k in ds[0]}
    cfg = dict(gt_size=64, gaussian_noise_prob=1.0, gaussian_noise_prob2=1.0, queue_size=0,
               second_order_prob=0.5 + 0.5 * (seed == 1))
    key = jax.random.PRNGKey(seed)
    want = jre.RealESRGANDegrader(cfg)(np.random.default_rng(seed), key, batch)
    got = tre.RealESRGANDegrader(cfg)(np.random.default_rng(seed), None, batch,
                                      noise_draws=_jax_draws(key))
    assert got["gt"].shape == want["gt"].shape == (2, 64, 64, 3)
    assert got["lq"].shape == want["lq"].shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(got["gt"], want["gt"])
    step = 2.0 / 255.0  # one 8-bit level in [-1, 1]
    diff = np.abs(got["lq"] - want["lq"])
    assert diff.max() <= step * 1.01 and (diff > 1e-6).mean() < 0.01, (diff.max(),
                                                                         (diff > 1e-6).mean())


def test_queue_swaps_from_the_eleventh_call():
    cfg = dict(queue_size=None)
    rt, rj = np.random.default_rng(3), np.random.default_rng(3)
    qt, qj = tre.RealESRGANDegrader(cfg), jre.RealESRGANDegrader(cfg)
    rng = np.random.default_rng(4)
    for call in range(14):
        batch = {"gt": rng.uniform(size=(2, 4, 4, 3)).astype(np.float32),
                 "lq": rng.uniform(size=(2, 1, 1, 3)).astype(np.float32)}
        a, b = qt._queue_swap(rt, dict(batch)), qj._queue_swap(rj, dict(batch))
        for k in batch:
            np.testing.assert_array_equal(a[k], b[k])
            assert np.array_equal(a[k], batch[k]) == (call < 10)
