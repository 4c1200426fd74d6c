"""The port's standalone window attention (ops/window_attention.py, the plain
version of kernel K9, its autograd.Function, and models/swin.py's
WindowAttention) against the JAX package's `swin_attention_pallas`: the
Pallas kernel `_forward_pallas` in interpret mode, `xla_window_attention`,
its VJP, and the Flax `WindowAttention`.

Inputs come from numpy with a seed and go to both sides.  The band
rtol 2e-4 / atol 2e-5 is tests/test_pallas_kernels.py's own for K9 against
XLA in f32: the two frameworks sum in other orders.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from resshift_tpu.models import swin as jswin
from resshift_tpu.ops import swin_attention_pallas as swa
from resshift_tpu_torch import convert
from resshift_tpu_torch.models import swin as tswin
from resshift_tpu_torch.ops import window_attention as twa

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5


def _inputs(seed, m, n, c, nh, nw):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return [f(m, n, c), f(c, 3 * c, sc=0.1), f(3 * c, sc=0.1), f(c, c, sc=0.1), f(c, sc=0.1),
            f(nw, nh, n, n, sc=0.2)]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(swa.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("m,n,c,nh,nw", [(32, 16, 32, 2, 1), (32, 16, 32, 2, 16),
                                         (16, 64, 192, 6, 1)])
def test_plain_matches_pallas_kernel_and_xla(interpret, m, n, c, nh, nw):
    args = _inputs(m + nw, m, n, c, nh, nw)
    got = twa.window_attention_plain(*map(torch.from_numpy, args), nh).numpy()
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(got, np.asarray(swa._forward_pallas(*jargs, nh)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(swa.xla_window_attention(*jargs, nh)),
                               rtol=RTOL, atol=ATOL)
    # on a CPU tensor the public wrapper is the plain version, no launch
    launches = twa.WINDOW_ATTN.launches
    wrapped = twa.window_attention(*map(torch.from_numpy, args), nh)
    np.testing.assert_array_equal(wrapped.detach().numpy(), got)
    assert twa.WINDOW_ATTN.launches == launches


def test_autograd_function_matches_jax_vjp():
    m, n, c, nh, nw = 8, 16, 32, 2, 4
    args = _inputs(5, m, n, c, nh, nw)
    g = np.random.default_rng(6).standard_normal((m, n, c)).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = twa.window_attention(*ts, nh)
    y.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda *a: swa.xla_window_attention(*a, num_heads=nh),
                     *[jnp.asarray(a) for a in args])
    want = vjp(jnp.asarray(g))
    assert len(want) == len(ts) == 6
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("qkv_bias,qk_scale,masked", [(True, 0.25, True), (False, None, False)])
def test_window_attention_module_matches_flax(qkv_bias, qk_scale, masked):
    dim, ws, nh, nwin, b = 32, 4, 2, 4, 2
    n = ws * ws
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b * nwin, n, dim)).astype(np.float32)
    mask = (jswin.shifted_window_mask(8, 8, ws, 2) if masked else None)
    mod = jswin.WindowAttention(dim=dim, window_size=ws, num_heads=nh, qkv_bias=qkv_bias,
                                qk_scale=qk_scale, use_pallas=False)
    jm = None if mask is None else jnp.asarray(mask)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jm)["params"]
    # the zero-initialised biases redrawn, so that they reach the output
    params = jax.tree_util.tree_map(
        lambda p: p if np.any(np.asarray(p))
        else jnp.asarray(0.1 * rng.standard_normal(p.shape), jnp.float32), params)
    want = mod.apply({"params": params}, jnp.asarray(x), jm)

    tmod = tswin.WindowAttention(dim, ws, nh, qkv_bias=qkv_bias, qk_scale=qk_scale)
    sd = convert.from_flax(jax.tree_util.tree_map(np.asarray, params), "window_attention")
    assert ("qkv.bias" in sd) == qkv_bias
    tmod.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})  # strict: every key
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
