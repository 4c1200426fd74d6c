"""The gradients of the port's kernel wrappers, the VQ straight-through and
the UNet's tri-state `use_pallas` pin, on the CPU against the JAX package.

A CUDA kernel cannot run here, so each wrapper's launch is stubbed by its
plain version under `torch.no_grad()` (the value a launch returns, with no
graph), and the dispatch is sent down the card's branch:
  * A, B (both variants each) and F: the wrapper's gradient (its
    `_ext.Recompute` Function) equals the plain version's, bit for bit;
    E's Function calls the kernel again with `inverse` flipped;
  * the plain versions' gradients equal `jax.vjp` of the JAX package's
    `*_xla` compositions (A, B), `tail_pallas._reference` after the fold
    (F) and `shift_tokens_pallas` in interpret mode (E), in f32, within
    rtol 1e-4 and atol 1e-6;
  * C refuses a launch that autograd would record;
  * `VQModel.decode`'s gradient in its latent equals `jax.grad` of the JAX
    decode (the straight-through passes it unchanged) and its codebook
    gets none;
  * `UNetModelSwin(use_pallas=False)` launches no kernel, None launches A
    and B but not F, True also F; `clone` shares the parameters; and a UNet
    on the kernels' route gives every Swin parameter the plain route's
    gradient.
Inputs come from numpy with a seed.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resshift_tpu.convert import convert_vqgan
from resshift_tpu.models import VQModel as JVQModel
from resshift_tpu.models import layers as jlayers
from resshift_tpu.ops import shift_pallas as jsp
from resshift_tpu.ops import swin_block_pallas as jsb
from resshift_tpu.ops import tail_pallas as jtail
from resshift_tpu_torch.convert import from_flax
from resshift_tpu_torch.models.swin import shifted_window_mask
from resshift_tpu_torch.models.unet import UNetModelSwin
from resshift_tpu_torch.models.vqgan import VectorQuantizer, VQModel
from resshift_tpu_torch.ops import flash_attention as fa
from resshift_tpu_torch.ops import shift as tshift
from resshift_tpu_torch.ops import swin_block as tsb
from resshift_tpu_torch.ops import tail

torch.set_num_threads(1)
# f32, the plain gradients against jax.vjp: rtol 1e-4 and atol 1e-6 on each
# gradient divided by its largest magnitude (the two sum in other orders,
# and a gradient summed from many terms cancels to values far below its
# scale, where f32's absolute rounding is the scale's)
RTOL, ATOL = 1e-4, 1e-6


def _close_to_jax(got, want, atol=ATOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale, np.asarray(want) / scale, rtol=RTOL,
                               atol=atol)
B, H, W, WS, C, NH, HID = 2, 8, 16, 4, 32, 2, 64
N = WS * WS


def _stub(plain):
    """A launch: the plain version's value, with no graph."""
    def launch(*a, **k):
        with torch.no_grad():
            return plain(*a, **k)
    return launch


@pytest.fixture
def on_card(monkeypatch):
    """The CPU tensors take the wrappers' CUDA branch; each launch is the
    plain version under no_grad, counted by name."""
    calls = []

    def attn(x, w, b, wqkv, bqkv, wproj, bproj, bm, nh, n, geom):
        calls.append(("A", geom))
        fn = (tsb.norm_attn_residual_stats_plain if geom is None else
              functools.partial(tsb.shift_attn_residual_stats_plain, h=geom[0], wd=geom[1],
                                ws=geom[2], shift=geom[3]))
        return _stub(fn)(x, w, b, wqkv, bqkv, wproj, bproj, bm, nh, n)

    def mlp(x, w, b, w1, b1, w2, b2, geom):
        calls.append(("B", geom))
        fn = (tsb.norm_mlp_residual_stats_plain if geom is None else
              functools.partial(tsb.mlp_unshift_residual_stats_plain, h=geom[0], wd=geom[1],
                                ws=geom[2], shift=geom[3]))
        return _stub(fn)(x, w, b, w1, b1, w2, b2)

    def shift_kernel(x, h, w, ws, shift, inverse):
        calls.append(("E", inverse))
        return _stub(tshift.shift_tokens_plain)(x, h, w, ws, shift, inverse)

    def tail_kernel(route, x, s, gb, wt, bi, num_groups, eps):
        calls.append(("F", route))
        return _stub(lambda: tail.gn_silu_conv3x3_plain(
            x, *tail.group_norm_fold(x, s, gb, num_groups, eps), wt, bi))()

    monkeypatch.setattr(tsb, "_on_cpu", lambda x: False)
    monkeypatch.setattr(tsb, "_attn_kernel", attn)
    monkeypatch.setattr(tsb, "_mlp_kernel", mlp)
    monkeypatch.setattr(tshift, "_kernel", shift_kernel)
    monkeypatch.setattr(tail, "tail_route", lambda dev, dt, c, co, use_pallas=True:
                        "tc" if use_pallas else "plain")
    monkeypatch.setattr(tail, "_kernel", tail_kernel)
    return calls


def _inputs(seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    x = r(B, H * W, C)
    w, b = 1 + r(B, C, sc=0.1), r(B, C, sc=0.1)
    attn = [r(C, 3 * C, sc=C ** -0.5), r(3 * C, sc=0.1), r(C, C, sc=C ** -0.5), r(C, sc=0.1)]
    mlp = [r(C, HID, sc=C ** -0.5), r(HID, sc=0.1), r(HID, C, sc=HID ** -0.5), r(C, sc=0.1)]
    nw = (H // WS) * (W // WS)
    bm = r(nw, NH, N, N, sc=0.02) + shifted_window_mask(H, W, WS, 2)[:, None]
    return x, w, b, attn, mlp, bm, [r(B, H * W, C), r(B, C), r(B, C)]


GEO = (H, W, WS, 2)
CASES = {  # wrapper, its plain version, the JAX composition, which weights, the kwargs
    "A": (tsb.norm_attn_residual_stats, tsb.norm_attn_residual_stats_plain,
          jsb.norm_attn_residual_stats_xla, "attn", dict(num_heads=NH, n_win=N)),
    "A shifted": (tsb.shift_attn_residual_stats, tsb.shift_attn_residual_stats_plain,
                  jsb.shift_attn_residual_stats_xla, "attn",
                  dict(num_heads=NH, n_win=N, h=H, wd=W, ws=WS, shift=2)),
    "B": (tsb.norm_mlp_residual_stats, tsb.norm_mlp_residual_stats_plain,
          jsb.norm_mlp_residual_stats_xla, "mlp", {}),
    "B unshifting": (tsb.mlp_unshift_residual_stats, tsb.mlp_unshift_residual_stats_plain,
                     jsb.mlp_unshift_residual_stats_xla, "mlp", dict(h=H, wd=W, ws=WS, shift=2)),
}


def _args(case, seed=0):
    x, w, b, attn, mlp, bm, cot = _inputs(seed)
    kind = CASES[case][3]
    return ([x, w, b, *attn, bm] if kind == "attn" else [x, w, b, *mlp]), cot


def _torch_grads(fn, args, cot, kw):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    outs = fn(*ts, **kw)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot))
    return [o.detach() for o in outs], torch.autograd.grad(loss, ts)


@pytest.mark.parametrize("case", list(CASES))
def test_swin_kernel_function_has_the_plain_gradient(on_card, case):
    wrapper, plain, _, kind, kw = CASES[case]
    args, cot = _args(case)
    outs, grads = _torch_grads(wrapper, args, cot, kw)
    assert [c[0] for c in on_card] == [case[0]]  # the kernel launched once (forward)
    p_outs, p_grads = _torch_grads(plain, args, cot, kw)
    for a, b in zip(outs + list(grads), p_outs + list(p_grads)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_swin_plain_gradient_matches_jax_vjp(case):
    _, plain, jfn, kind, kw = CASES[case]
    args, cot = _args(case, seed=1)
    _, grads = _torch_grads(plain, args, cot, kw)
    _, vjp = jax.vjp(lambda *a: jfn(*a, **kw), *(jnp.asarray(a) for a in args))
    want = vjp(tuple(jnp.asarray(c) for c in cot))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        _close_to_jax(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("inverse", [False, True])
def test_shift_tokens_backward_is_the_inverse_kernel(on_card, inverse):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, H * W, C)).astype(np.float32)
    g = rng.standard_normal((B, H * W, C)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tshift.ShiftTokensFn.apply(xt, H, W, WS, 2, inverse)  # the wrapper's CUDA branch
    (got,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), xt)
    assert on_card == [("E", inverse), ("E", not inverse)]
    xp = torch.from_numpy(x).requires_grad_(True)
    yp = tshift.shift_tokens_plain(xp, H, W, WS, 2, inverse)
    (want,) = torch.autograd.grad((yp * torch.from_numpy(g)).sum(), xp)
    assert torch.equal(y.detach(), yp.detach()) and torch.equal(got, want)


@pytest.mark.parametrize("inverse", [False, True])
def test_shift_plain_gradient_matches_jax_vjp(monkeypatch, inverse):
    if not jsp._PALLAS_OK:
        pytest.skip("pallas unavailable")
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, H * W, C)).astype(np.float32)
    g = rng.standard_normal((B, H * W, C)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tshift.shift_tokens_plain(xt, H, W, WS, 2, inverse)
    (got,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), xt)
    _, vjp = jax.vjp(lambda a: jsp.shift_tokens_pallas(a, H, W, WS, 2, inverse), jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def _tail_inputs(seed, c=64, co=3):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return [r(2, c, 8, 12, sc=1.5) + 0.3, 1 + r(c, sc=0.2), 0.5 + r(c, sc=0.3),
            r(co, c, 3, 3, sc=(9 * c) ** -0.5), r(co, sc=0.1)], r(2, co, 8, 12)


def _tail_plain(x, s, gb, wt, bi):
    return tail.gn_silu_conv3x3_plain(x, *tail.group_norm_fold(x, s, gb, 32, 1e-6), wt, bi)


def test_tail_kernel_function_has_the_plain_gradient(on_card):
    args, cot = _tail_inputs(4)
    outs, grads = _torch_grads(
        lambda *a: (tail.gn_silu_conv3x3(*a, eps=1e-6, use_pallas=True),), args, [cot], {})
    assert on_card == [("F", "tc")]
    p_outs, p_grads = _torch_grads(lambda *a: (_tail_plain(*a),), args, [cot], {})
    for a, b in zip(outs + list(grads), p_outs + list(p_grads)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_tail_plain_gradient_matches_jax_vjp():
    args, cot = _tail_inputs(5)
    _, grads = _torch_grads(lambda *a: (_tail_plain(*a),), args, [cot], {})
    x, s, gb, wt, bi = args

    def jfn(x, s, gb, k, cb):  # NHWC, HWIO, as the JAX package's tail takes them
        w, b = jlayers.group_norm_fold(x, s, gb, 32, 1e-6)
        return jtail._reference(x, w, b, k, cb, act_bf16=False)

    _, vjp = jax.vjp(jfn, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(s), jnp.asarray(gb),
                     jnp.asarray(wt.transpose(2, 3, 1, 0)), jnp.asarray(bi))
    gx, gs, gg, gk, gc = (np.asarray(v) for v in vjp(jnp.asarray(cot.transpose(0, 2, 3, 1))))
    for g, w in zip(grads, (gx.transpose(0, 3, 1, 2), gs, gg, gk.transpose(3, 2, 0, 1), gc)):
        _close_to_jax(g.numpy(), w)


def test_recompute_keeps_static_arguments_apart_from_tensors():
    """A static None among the arguments stays None in the backward's
    recomputation; the tensors on either side get their own gradients."""
    from resshift_tpu_torch import _ext

    def plain(a, scale, b, offset):
        assert scale is None and offset == 2
        return a * b + offset

    a, b = (torch.randn(3, requires_grad=True) for _ in range(2))
    out = _ext.Recompute.launch(_stub(plain), plain, a, None, b, 2)
    assert out.grad_fn is not None
    out.sum().backward()
    torch.testing.assert_close(a.grad, b.detach(), rtol=0, atol=0)
    torch.testing.assert_close(b.grad, a.detach(), rtol=0, atol=0)


def test_flash_attention_refuses_a_recorded_launch():
    q = torch.randn(1, 16, 512, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa._kernel(q, q, q)
    # the plain version on the CPU keeps its graph
    out = fa.flash_attention_1h(q, q, q)
    (g,) = torch.autograd.grad(out.sum(), q)
    assert torch.isfinite(g).all() and g.abs().max() > 0


# ------------------------------------------------------------ the quantizer

DDCONFIG = dict(double_z=False, z_channels=3, resolution=32, in_channels=3, out_ch=3, ch=32,
                ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0)


def test_vector_quantizer_straight_through():
    vq = VectorQuantizer(16, 3)
    z = torch.randn(2, 4, 4, 3, requires_grad=True)
    out = vq(z)
    out.sum().backward()
    torch.testing.assert_close(z.grad, torch.ones_like(z), rtol=0, atol=0)
    assert vq.embedding.weight.grad is None or not vq.embedding.weight.grad.any()
    with torch.no_grad():
        idx = ((z.reshape(-1, 1, 3) - vq.embedding.weight[None]) ** 2).sum(-1).argmin(1)
        torch.testing.assert_close(out, vq.embedding.weight[idx].reshape(z.shape))


def test_vqmodel_decode_gradient_matches_jax():
    jm = JVQModel(ddconfig=DDCONFIG, n_embed=32, embed_dim=3, use_pallas=False)
    tm = VQModel(DDCONFIG, n_embed=32, embed_dim=3).eval()
    g = torch.Generator().manual_seed(0)
    sd = {k: (torch.randn(v.shape, generator=g) / (v[0].numel() ** 0.5 if v.dim() >= 2 else 10)
              + (1.0 if k.endswith("weight") and v.dim() == 1 and "embedding" not in k else 0))
          for k, v in tm.state_dict().items()}
    params = convert_vqgan({k: v.numpy() for k, v in sd.items()}, ch_mult=[1, 2],
                           num_res_blocks=1)
    tm.load_state_dict({k: torch.tensor(v) for k, v in
                        from_flax(params, "vqgan", ch_mult=[1, 2], num_res_blocks=1).items()})
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, 8, 8, 3)).astype(np.float32) * 0.3
    r = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    want = jax.grad(lambda z: jnp.sum(jm.apply({"params": params}, z, method=jm.decode) * r))(
        jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    (tm.decode(ht) * torch.from_numpy(r)).sum().backward()
    # through the whole f32 decoder (the forward's own test holds 1e-4): atol
    # 1e-5 of the largest gradient
    _close_to_jax(ht.grad.numpy(), np.asarray(want), atol=1e-5)
    cb = tm.quantize.embedding.weight.grad
    assert cb is None or not cb.any()


# ------------------------------------------------------------ the pin

CFG = dict(image_size=16, in_channels=3, model_channels=32, out_channels=3,
           attention_resolutions=[16, 8], dropout=0.0, channel_mult=[1, 2], num_res_blocks=[1, 1],
           num_head_channels=16, swin_depth=2, swin_embed_dim=32, window_size=8, mlp_ratio=4,
           cond_lq=True, lq_size=16)


def _unet_run(unet, seed=7):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(np.float32))
    lq = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32))
    out = unet(x, torch.tensor([1, 3]), lq=lq)
    (out * torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in unet.named_parameters()}


@pytest.mark.parametrize("pin,kernels", [(None, {"A", "B"}), (True, {"A", "B", "F"}),
                                         (False, set())])
def test_unet_pin_is_tri_state(on_card, pin, kernels):
    unet = UNetModelSwin(**CFG, use_pallas=pin)
    torch.manual_seed(0)
    for p in unet.parameters():  # nonzero everywhere, so every branch reaches the output
        torch.nn.init.normal_(p, std=0.05)
    out, grads = _unet_run(unet)
    assert {name for name, _ in on_card} == kernels
    plain = unet.clone(use_pallas=False)
    assert all(a is b for a, b in zip(plain.parameters(), unet.parameters()))
    assert plain.use_pallas is False and unet.use_pallas is pin
    on_card.clear()
    unet.zero_grad()
    out_p, grads_p = _unet_run(plain)
    assert on_card == []
    torch.testing.assert_close(out, out_p, rtol=0, atol=0)
    swin = [n for n in grads if ".blocks." in n]
    assert swin and all(grads_p[n].abs().max() > 0 for n in swin)
    for n in grads:  # the kernels' route carries the plain route's gradient
        torch.testing.assert_close(grads[n], grads_p[n], rtol=0, atol=0, msg=n)
