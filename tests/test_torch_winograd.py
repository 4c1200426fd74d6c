"""The port's Winograd F(2x2, 3x3) conv (ops/winograd.py, the plain version
of kernel K10) against the JAX package's `winograd`: the Pallas kernel
`winograd_conv3x3` in interpret mode, `lax.conv_general_dilated`, the
kernel transform and the shape gate.

Inputs come from numpy with a seed and go to both sides, at the shapes of
tests/test_pallas_kernels.py's Winograd tests.  Bars: the Pallas kernel's
own against its XLA formulation (rtol 1e-5, atol 1e-6: the same rounding
points, other summation orders), the direct conv's (rtol 1e-4, atol 1e-5:
Winograd reassociates), one bf16 step of the largest output in bf16, and
the kernel transform exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from resshift_tpu.ops import winograd as wg
from resshift_tpu_torch.ops import winograd as twg

torch.set_num_threads(1)
SHAPES = [(2, 8, 8, 8, 16), (1, 16, 8, 16, 8)]


def _inputs(shape, seed=11):
    bsz, h, w, c, co = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bsz, h, w, c)).astype(np.float32) * 0.3,
            rng.standard_normal((3, 3, c, co)).astype(np.float32) * 0.1,
            rng.standard_normal(co).astype(np.float32) * 0.1)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(wg.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _direct(x, wk, b):
    return jax.lax.conv_general_dilated(x, wk, (1, 1), ((1, 1), (1, 1)),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel_and_direct_conv(interpret, shape):
    x, wk, b = _inputs(shape)
    got = twg.winograd_conv3x3_plain(*map(torch.from_numpy, (x, wk, b))).numpy()
    jx, jw, jb = map(jnp.asarray, (x, wk, b))
    np.testing.assert_allclose(got, np.asarray(wg.winograd_conv3x3(jx, jw, jb)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(_direct(jx, jw, jb)), rtol=1e-4, atol=1e-5)
    # without a bias, and through the public wrapper on a CPU tensor (no launch)
    launches = twg.WINOGRAD_CONV3X3.launches
    nob = twg.winograd_conv3x3(torch.from_numpy(x), torch.from_numpy(wk)).numpy()
    np.testing.assert_allclose(nob, np.asarray(wg.winograd_conv3x3_xla(jx, jw)),
                               rtol=1e-5, atol=1e-6)
    assert twg.WINOGRAD_CONV3X3.launches == launches


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel_bf16(interpret, shape):
    x, wk, b = _inputs(shape, seed=12)
    got = twg.winograd_conv3x3_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(wk),
                                     torch.from_numpy(b)).float().numpy()
    want = np.asarray(wg.winograd_conv3x3(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wk),
                                          jnp.asarray(b)).astype(jnp.float32))
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)  # one bf16 step at the top
    assert np.abs(got - want).max() <= step


def test_kernel_transform_is_exact():
    w = np.random.default_rng(13).standard_normal((3, 3, 24, 40)).astype(np.float32)
    np.testing.assert_array_equal(twg.winograd_kernel_transform(torch.from_numpy(w)).numpy(),
                                  np.asarray(wg.winograd_kernel_transform(jnp.asarray(w))))


def test_shape_gate_equals_jax():
    cases = [((1, 7, 8, 64), 64, 64), ((1, 64, 64, 32), 32, 64), ((1, 64, 64, 128), 128, 128),
             ((1, 6, 8, 64), 64, 64), ((1, 8, 2048, 64), 64, 64), ((2, 16, 16), 64, 64),
             ((1, 8, 8, 64), 64, 63)]
    for shape, c, co in cases:
        assert twg.winograd_available(shape, c, co) == wg.winograd_available(shape, c, co)


def test_odd_sides_raise():
    x, wk, b = _inputs((1, 8, 8, 4, 4))
    with pytest.raises(ValueError):
        twg.winograd_conv3x3(torch.from_numpy(x[:, :7]), torch.from_numpy(wk))
