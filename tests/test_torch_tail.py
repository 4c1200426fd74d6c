"""The port's GroupNorm + SiLU + conv3x3 tail (ops/tail.py, the plain version
of kernel F) against the JAX package's `tail_pallas.gn_silu_conv3x3`, which
runs its XLA composition `_reference` on the CPU.

Shapes are the tail's real channel counts (C = 64 and 128 of the VQGAN
decoders, 160 of the UNet head; co = 3 and 8) at a small map, with a
non-zero GroupNorm bias so that the zero border of the activated tensor
differs from a zero border of the input.  Tolerances: f32 rtol 2e-4
(summation order); bf16 one bf16 step of the output's largest values
(the exponential and the conv sums may differ in their last f32 bits).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resshift_tpu.models.layers import group_norm_fold as jfold
from resshift_tpu.ops.tail_pallas import gn_silu_conv3x3 as jtail
from resshift_tpu_torch.ops.tail import group_norm_fold
from resshift_tpu_torch.ops import tail

torch.set_num_threads(1)


def _inputs(c, co, seed, hw=(12, 16), b=2):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, c) + hw) * 1.5 + 0.3).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    gbias = (0.5 + 0.3 * rng.standard_normal(c)).astype(np.float32)  # silu(bias) != 0
    weight = (rng.standard_normal((co, c, 3, 3)) / np.sqrt(9 * c)).astype(np.float32)
    cbias = (0.1 * rng.standard_normal(co)).astype(np.float32)
    return x, scale, gbias, weight, cbias


def _jax(x, scale, gbias, weight, cbias, eps, dt):
    """JAX's tail on the NHWC copy of x, returned NCHW."""
    jx = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(dt)
    y = jtail(jx, jnp.asarray(scale), jnp.asarray(gbias),
              jnp.asarray(weight.transpose(2, 3, 1, 0)), jnp.asarray(cbias), eps=eps)
    return np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2)


def _bf16_step(v: np.ndarray) -> float:
    return float(np.abs(v).max()) * 2.0 ** -7


@pytest.mark.parametrize("c,co", [(64, 3), (128, 3), (160, 3), (160, 8)])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_plain_tail_matches_jax_f32(c, co, eps):
    x, scale, gbias, weight, cbias = _inputs(c, co, c + co)
    want = _jax(x, scale, gbias, weight, cbias, eps, jnp.float32)
    got = tail.gn_silu_conv3x3(*(torch.from_numpy(a) for a in (x, scale, gbias, weight, cbias)),
                               eps=eps, use_pallas=True)  # a CPU tensor: the plain version
    assert got.dtype == torch.float32 and got.shape == (2, co, 12, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("c,co", [(64, 3), (128, 3), (160, 8)])
def test_plain_tail_matches_jax_bf16(c, co):
    x, scale, gbias, weight, cbias = _inputs(c, co, 7 * c + co)
    want = _jax(x, scale, gbias, weight, cbias, 1e-6, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    got = tail.gn_silu_conv3x3(xt, *(torch.from_numpy(a) for a in (scale, gbias, weight, cbias)),
                               eps=1e-6)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= _bf16_step(want), (err, _bf16_step(want))


def test_bias_is_added_after_the_rounded_conv():
    """bf16: the conv result rounds before the bias is added in bf16, as in
    the JAX package; with the bias inside the conv's f32 sum the result is
    one rounding off.  The plain version equals its explicit form bit for
    bit."""
    x, scale, gbias, weight, cbias = _inputs(128, 3, 11, hw=(16, 16))
    xt = torch.from_numpy(x).bfloat16()
    w, b = group_norm_fold(xt, torch.from_numpy(scale), torch.from_numpy(gbias), eps=1e-6)
    wt, cb = torch.from_numpy(weight), torch.from_numpy(cbias)
    got = tail.gn_silu_conv3x3_plain(xt, w, b, wt, cb)
    a = (xt.float() * w[..., None, None] + b[..., None, None]).bfloat16()
    s = a * (1 / (1 + torch.exp(-a)))
    conv = torch.nn.functional.conv2d(s.float(), wt.bfloat16().float(), padding=1).bfloat16()
    explicit = (conv.float() + cb.bfloat16().float()[:, None, None]).bfloat16()
    assert torch.equal(got, explicit)
    folded = torch.nn.functional.conv2d(s, wt.bfloat16(), cb.bfloat16(), padding=1)
    assert not torch.equal(got, folded)  # the old order rounds elsewhere


def test_zero_border_is_after_the_silu():
    """The border taps read silu(activation) = 0, not silu(0 * w + b)."""
    x, scale, gbias, weight, cbias = _inputs(64, 3, 3)
    args = [torch.from_numpy(a) for a in (x, scale, gbias, weight, cbias)]
    got = tail.gn_silu_conv3x3(*args, eps=1e-6)
    w, b = group_norm_fold(args[0], args[1], args[2], eps=1e-6)
    a = torch.nn.functional.silu(args[0] * w[..., None, None] + b[..., None, None])
    wrong = torch.nn.functional.conv2d(  # zero x at the border, then normalize + SiLU
        torch.nn.functional.silu(torch.nn.functional.pad(args[0], (1, 1, 1, 1))
                                 * w[..., None, None] + b[..., None, None]),
        args[3]) + args[4][:, None, None]
    right = torch.nn.functional.conv2d(a, args[3], padding=1) + args[4][:, None, None]
    torch.testing.assert_close(got, right, rtol=1e-5, atol=1e-5)
    assert (got - wrong)[..., 0, :].abs().max() > 1e-2  # the border rows tell them apart
    torch.testing.assert_close(got[..., 1:-1, 1:-1], wrong[..., 1:-1, 1:-1], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dt", [np.float32, "bf16"])
def test_group_norm_fold_matches_jax(dt):
    x, scale, gbias, _, _ = _inputs(160, 3, 5)
    xt = torch.from_numpy(x)
    jx = jnp.asarray(x.transpose(0, 2, 3, 1))
    if dt == "bf16":
        xt, jx = xt.bfloat16(), jx.astype(jnp.bfloat16)
    w, b = group_norm_fold(xt, torch.from_numpy(scale), torch.from_numpy(gbias), eps=1e-5)
    jw, jb = jfold(jx, jnp.asarray(scale), jnp.asarray(gbias), 32, 1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-5)


def test_wrapper_dispatch_off_the_card():
    x, scale, gbias, weight, cbias = _inputs(64, 3, 9, b=1)
    args = [torch.from_numpy(a) for a in (x, scale, gbias, weight, cbias)]
    ref = tail.gn_silu_conv3x3(*args)
    for pin in (False, True):  # a CPU tensor takes the plain version whatever the pin
        assert torch.equal(tail.gn_silu_conv3x3(*args, use_pallas=pin), ref)
    assert tail.GN_SILU_CONV3X3.launches == 0
    with pytest.raises(RuntimeError, match="no kernel"):
        tail.gn_silu_conv3x3(*(a.to("meta") for a in args), use_pallas=True)
