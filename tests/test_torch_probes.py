"""The port's probe kernels' plain versions against the JAX package's probe
tools, run in Pallas interpret mode:
  * P1 (ops/conv3x3.py) against `tools/profile_conv_pallas.py::conv3x3_pallas`
    and `F.conv2d`;
  * P2 (ops/attn_variants.py), each softmax mode, against
    `tools/profile_attn_variants.py::call_variant`, and its f32 mode against
    kernel A's plain version.
The tools are imported by path; only their `pl.pallas_call` is patched.
The port's P2 has no super-windows: the JAX probe groups two windows of 64
tokens into one with a -1e9 cross mask, which leaves f32, mxsum and bf16exp
unchanged but lets noexp and none mix the two windows, so those two modes
are held against the probe with its grouping set to one window
(`_pick_gw`).

Bars: f32 rtol 2e-4 / atol 2e-5 (test_pallas_kernels.py's kernel band); the
none mode's outputs are sums of raw scores near -30 times the values (about
1e3 here), so its absolute floor is 2e-5 of the largest output; P1 rtol
1e-5 against the probe (the same three f32 products) and 1e-4 against the
direct conv; bf16 one bf16 step of the largest output.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental import pallas as pl

from resshift_tpu_torch.ops import attn_variants as tav
from resshift_tpu_torch.ops import conv3x3 as tc
from resshift_tpu_torch.ops import swin_block as tsb

torch.set_num_threads(1)
TOOLS = Path(__file__).resolve().parents[1] / "tools"
RTOL, ATOL = 2e-4, 2e-5
NH, N = 6, 64  # the JAX probe's heads and window tokens


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def conv_tool():
    return _tool("profile_conv_pallas")


@pytest.fixture(scope="module")
def attn_tool():
    return _tool("profile_attn_variants")


def _one_step(want):
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def test_conv3x3_plain_matches_probe_and_direct_conv(monkeypatch, conv_tool):
    monkeypatch.setattr(conv_tool.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 16, 16, 8)).astype(np.float32) * 0.3
    w = rng.standard_normal((3, 3, 8, 8)).astype(np.float32) * 0.1
    got = tc.conv3x3(torch.from_numpy(x), torch.from_numpy(w)).numpy()  # CPU: plain
    want = np.asarray(conv_tool.conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), 8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    direct = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(w).permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, direct.numpy(), rtol=1e-4, atol=1e-5)
    assert tc.CONV3X3.launches == 0


def _attn_inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    b, t, c = 1, 1024, 48
    return [f(b, t, c, sc=0.5), 1 + f(b, c, sc=0.1), f(b, c, sc=0.1), f(c, 3 * c, sc=0.2),
            f(3 * c, sc=0.1), f(c, c, sc=0.2), f(c, sc=0.1), f(1, NH, N, N, sc=0.2)]


@pytest.mark.parametrize("softmax", tav.SOFTMAX_MODES)
def test_attn_variant_plain_matches_probe(monkeypatch, attn_tool, softmax):
    monkeypatch.setattr(attn_tool.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    if softmax in ("noexp", "none"):  # one window per group (see the module docstring)
        monkeypatch.setattr(attn_tool.sbp, "_pick_gw", lambda *a: 1)
    args = _attn_inputs(1)
    got = tav.attn_variant(*map(torch.from_numpy, args), NH, N, softmax).numpy()
    want = np.asarray(attn_tool.call_variant(*map(jnp.asarray, args), softmax))
    atol = ATOL * (np.abs(want).max() if softmax == "none" else 1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    assert tav.ATTN_VARIANTS.launches == 0


@pytest.mark.parametrize("softmax", ["bf16exp", "f32"])
def test_attn_variant_plain_matches_probe_bf16(monkeypatch, attn_tool, softmax):
    monkeypatch.setattr(attn_tool.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    args = _attn_inputs(2)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    for i in (0, 3, 4, 5, 6):  # x and the weights in bf16; the affine and bias f32
        jargs[i] = jargs[i].astype(jnp.bfloat16)
        targs[i] = targs[i].bfloat16()
    got = tav.attn_variant_plain(*targs, NH, N, softmax).float().numpy()
    want = np.asarray(attn_tool.call_variant(*jargs, softmax).astype(jnp.float32))
    assert np.abs(got - want).max() <= _one_step(want)


def test_attn_variant_f32_mode_is_kernel_a_without_stats():
    args = [torch.from_numpy(a) for a in _attn_inputs(3)]
    np.testing.assert_allclose(tav.attn_variant_plain(*args, NH, N, "f32").numpy(),
                               tsb.norm_attn_residual_plain(*args, NH, N).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_attn_variant_rejects_unknown_softmax():
    with pytest.raises(ValueError):
        tav.attn_variant(*map(torch.from_numpy, _attn_inputs(4)), NH, N, "softmax2")
