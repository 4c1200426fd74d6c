"""Kernel E's plain version and the wide-map Swin route against the JAX
package, on the CPU.

  * `shift_tokens` both ways equals `shift_tokens_pallas` run in interpret
    mode, exactly (a permutation moves bits); the wide bf16 case is the
    JAX package's XLA-gather regime.
  * `shift_fuse_fits` equals the JAX package's gate.
  * One Swin block on the route through the token permutation (E, then the
    unshifted halves) equals the JAX block on its K7 route, in f32, at the
    kernel-against-composition band rtol 2e-4 / atol 2e-5 of
    tests/test_pallas_kernels.py.  Both packages' `shift_fuse_fits` are
    patched to the same small threshold, so that a small map takes that
    route; the JAX package itself is not changed.
  * The E route and the fused route give the same bits, and the block
    takes E exactly where `shift_fuse_fits` fails.

Inputs come from numpy with a seed and go to both sides.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resshift_tpu.models import swin as jswin
from resshift_tpu.ops import shift_pallas as jsp
from resshift_tpu.ops import swin_block_pallas as jsb
from resshift_tpu_torch import convert as tconvert
from resshift_tpu_torch.models import swin as tswin
from resshift_tpu_torch.ops import shift as tshift
from resshift_tpu_torch.ops import swin_block as tsb

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture
def interpret(monkeypatch):
    """Route every pallas_call through the interpreter, as the JAX package's
    own kernel tests do on the CPU."""
    if not jsp._PALLAS_OK:
        pytest.skip("pallas unavailable")
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("b,h,w,ws,shift,c,dt", [
    (2, 16, 16, 8, 4, 8, "float32"), (2, 16, 24, 8, 4, 8, "float32"),
    (2, 8, 8, 8, 4, 8, "float32"), (1, 16, 512, 8, 4, 192, "bfloat16")])
def test_shift_tokens_matches_pallas(interpret, b, h, w, ws, shift, c, dt):
    x = np.random.default_rng(h * w + c).standard_normal((b, h * w, c)).astype(np.float32)
    xj = jnp.asarray(x, dtype=getattr(jnp, dt))
    xt = torch.from_numpy(x).to(getattr(torch, dt))
    for inverse in (False, True):
        want = np.asarray(jsp.shift_tokens_pallas(xj, h, w, ws, shift, inverse).astype(jnp.float32))
        got = tshift.shift_tokens(xt, h, w, ws, shift, inverse)
        assert got.dtype == xt.dtype
        np.testing.assert_array_equal(got.float().numpy(), want)
    back = tshift.shift_tokens(tshift.shift_tokens(xt, h, w, ws, shift), h, w, ws, shift, True)
    assert torch.equal(back, xt)


@pytest.mark.parametrize("wd", [64, 128, 256, 512])
def test_shift_fuse_fits_matches_jax(wd):
    assert tsb.shift_fuse_fits(wd, 8) == jsb.shift_fuse_fits(wd, 8)
    assert tsb.shift_fuse_fits(wd, 8) == (wd <= 128)


# ------------------------------------------------------------ one block

B, H, W, WS, C, NH = 2, 8, 16, 4, 32, 2


def _small_gate(wd, ws):
    return wd * ws <= 32  # a 16-wide map at 4x4 windows fails it


def _blocks():
    """The JAX block's params and a port block loaded with the same ones."""
    jblk = jswin.SwinTransformerBlock(dim=C, build_resolution=(H, W), num_heads=NH,
                                      window_size=WS, shift=True)
    x = np.random.default_rng(0).standard_normal((B, H * W, C)).astype(np.float32) * 0.5
    params = jblk.init(jax.random.PRNGKey(1), jnp.asarray(x), H, W)["params"]
    # non-trivial norms and biases, so that every term reaches the output
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)
    flat = tconvert._flatten(params)
    sd: dict = {}
    for t, kind in (("norm1", "gn"), ("norm2", "gn"), ("attn.qkv", "linear"),
                    ("attn.proj", "linear"), ("mlp.fc1", "dense1x1"), ("mlp.fc2", "dense1x1")):
        tconvert._emit(flat, sd, t, tuple(t.replace("mlp.", "mlp_").split(".")), kind)
    tconvert._emit(flat, sd, "attn.relative_position_bias_table",
                   ("attn", "relative_position_bias_table"), "raw")
    tblk = tswin.SwinTransformerBlock(C, H, NH, WS, shift=True)
    tblk.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return jblk, params, tblk, x


@pytest.mark.parametrize("jax_route", ["pallas_interpret", "xla"])
def test_block_on_shift_kernel_route_matches_jax(monkeypatch, interpret, jax_route):
    jblk, params, tblk, x = _blocks()
    monkeypatch.setattr(jsb, "shift_fuse_fits", _small_gate)
    monkeypatch.setattr(tsb, "shift_fuse_fits", _small_gate)
    if jax_route == "pallas_interpret":  # K7, K1, K7 inverse, K2
        jblk = jblk.clone(use_pallas=True)
    want = jblk.apply({"params": params}, jnp.asarray(x), H, W)
    calls = []
    monkeypatch.setattr(tshift, "shift_tokens", lambda *a, **k: calls.append(a[1:]) or
                        tshift.shift_tokens_plain(*a, **k))
    with torch.no_grad():
        got = tblk(torch.from_numpy(x), H, W)
    assert calls == [(H, W, WS, WS // 2)] * 2
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
    # the (sum, sumsq) over H*W tokens: the same band, the floor scaled by the count
    for g, wv in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=RTOL, atol=H * W * ATOL)


def test_shift_kernel_route_equals_fused_route(monkeypatch):
    _, _, tblk, x = _blocks()
    with torch.no_grad():
        fused = tblk(torch.from_numpy(x), H, W)
        monkeypatch.setattr(tsb, "shift_fuse_fits", _small_gate)
        routed = tblk(torch.from_numpy(x), H, W)
    for a, b in zip(routed, fused):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("wd,shifted,want_e,want_fused", [
    (128, True, 0, 1), (256, True, 2, 0), (512, True, 2, 0), (256, False, 0, 0)])
def test_block_takes_shift_kernel_where_fused_route_does_not_fit(monkeypatch, wd, shifted,
                                                                  want_e, want_fused):
    h, ws = 8, 8
    blk = tswin.SwinTransformerBlock(16, 64, 2, ws, shift=shifted)
    counts = {"e": 0, "fused": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tshift, "shift_tokens", spy("e", tshift.shift_tokens))
    monkeypatch.setattr(tsb, "shift_attn_residual_stats",
                        spy("fused", tsb.shift_attn_residual_stats))
    x = torch.randn(1, h * wd, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = blk(x, h, wd)
    assert out[0].shape == x.shape and torch.isfinite(out[0]).all()
    assert counts == {"e": want_e, "fused": want_fused}


def test_shift_wrapper_rejects_other_devices():
    with pytest.raises(RuntimeError, match="no kernel"):
        tshift.shift_tokens(torch.zeros(1, 64, 8, device="meta"), 8, 8, 8, 4)
