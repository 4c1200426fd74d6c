"""The port's CUDA kernels against their plain PyTorch versions on the
card, at shapes off the main path (small windows, ragged tiles, other
widths, unaligned views), in float32 and bfloat16; for kernels B, C, K10
and P1, which launch a tensor-core kernel in bf16 and an FMA kernel in f32,
also which route ran (K10 and P1 also at full width, K10 at every conv
family of profile_winograd's census, and two bf16 calls giving the same
bits); the same for kernel A, whose two calls must also give the
same bits, and whose statistics reduce holds against an f64 sum over 4096
windows; for K9, whose bf16 route takes the tensor cores only at heads 16
or 32 wide, which route ran, and at full width two calls' bits; the same
for P2 in each of its five softmaxes, with two calls' bits at every shape;
for D,
which splits the codebook across CTAs, ragged rows and slices and exact
ties across slices; for F, its statistics pass `gn_stats` against the plain
fold, and both conv routes (bf16 at C % 16 == 0 on the tensor cores, else
the FMA kernel with its channels split across CTAs), which route ran, two
calls' bits, and how many bf16 elements differ from the plain version;
and the backward passes: A's, B's and F's gradients (their autograd
Functions) against the plain versions', E's (E inverted) bit for bit, and
C refusing a launch that autograd would record.

Needs a CUDA card and nvcc; skips elsewhere.  Where there is a card, run
    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
(`--noconftest` lets it run without JAX, which tests/conftest.py imports).
chip_smoke.py holds the kernels against the plain versions at the main
path's shapes.
"""

import pytest
import torch

from resshift_tpu_torch.models.swin import shifted_window_mask
from resshift_tpu_torch.ops import attn_variants as av
from resshift_tpu_torch.ops import conv3x3 as cv
from resshift_tpu_torch.ops import flash_attention as fa
from resshift_tpu_torch.ops import shift
from resshift_tpu_torch.ops import swin_block as sb
from resshift_tpu_torch.ops import tail
from resshift_tpu_torch.ops import vq
from resshift_tpu_torch.ops import window_attention as wa
from resshift_tpu_torch.ops import winograd as wg
from resshift_tpu_torch.tools import direct_conv, profile_winograd

pytestmark = pytest.mark.cuda

# bf16: a rounding flip or two of the largest value; f32: summation order
TOL = {torch.bfloat16: 2 ** -6, torch.float32: 1e-4}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the f32 comparisons need full f32 matmuls and convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dt):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-5 + TOL[dt] * want.float().abs().max().item(), err


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 2])
def test_swin_halves_small_windows(gen, dt, shift):
    b, h, w, ws, c, nh, hidden = 3, 8, 12, 4, 64, 2, 128
    t, n = h * w, ws * ws
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = rn(b, t, c).to(dt)
    wa, ba = sb.gn_fold(x, 1 + 0.1 * rn(c), 0.1 * rn(c))
    wts = [(rn(c, 3 * c) / c ** 0.5).to(dt), (0.1 * rn(3 * c)).to(dt),
           (rn(c, c) / c ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
    nw = (h // ws) * (w // ws) if shift else 1
    bm = 0.02 * rn(nw, nh, n, n)
    if shift:
        bm = bm + torch.as_tensor(shifted_window_mask(h, w, ws, shift), device="cuda")[:, None]
        geo = (h, w, ws, shift)
        got = sb.shift_attn_residual_stats(x, wa, ba, *wts, bm, nh, n, *geo)
        want = sb.shift_attn_residual_stats_plain(x, wa, ba, *wts, bm, nh, n, *geo)
    else:
        got = sb.norm_attn_residual_stats(x, wa, ba, *wts, bm, nh, n)
        want = sb.norm_attn_residual_stats_plain(x, wa, ba, *wts, bm, nh, n)
    for g_, w_ in zip(got, want):
        _close(g_, w_, dt)

    y = want[0]  # 96 tokens per image: the MLP's second row tile is ragged
    wm, bmm = sb.fold_stats(want[1:], 1 + 0.1 * rn(c), 0.1 * rn(c), t)
    mlp = [(rn(c, hidden) / c ** 0.5).to(dt), (0.1 * rn(hidden)).to(dt),
           (rn(hidden, c) / hidden ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
    if shift:
        got = sb.mlp_unshift_residual_stats(y, wm, bmm, *mlp, *geo)
        want = sb.mlp_unshift_residual_stats_plain(y, wm, bmm, *mlp, *geo)
    else:
        got = sb.norm_mlp_residual_stats(y, wm, bmm, *mlp)
        want = sb.norm_mlp_residual_stats_plain(y, wm, bmm, *mlp)
    for g_, w_ in zip(got, want):
        _close(g_, w_, dt)


def _routes(kernels):
    return [k.launches for k in kernels]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1000, 4096 + 37])
def test_flash_attention_ragged_tokens(gen, dt, n):
    """C on a ragged last query tile and key chunk; bf16 runs the
    tensor-core kernel, f32 the FMA kernel, one launch each."""
    q, k, v = (torch.randn(2, n, 512, generator=gen, device="cuda").to(dt)
               for _ in range(3))
    before = _routes((fa.FLASH_ATTN_1H_TC, fa.FLASH_ATTN_1H))
    got = fa.flash_attention_1h(q, k, v)
    tc = dt == torch.bfloat16
    assert _routes((fa.FLASH_ATTN_1H_TC, fa.FLASH_ATTN_1H)) == [before[0] + tc,
                                                                before[1] + (not tc)]
    _close(got, fa.attention_plain(q, k, v), dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hidden", [(64, 128), (64, 768), (192, 128), (192, 768), (256, 128)])
@pytest.mark.parametrize("tokens,geo", [(96, None), (4096 + 64 * 3 - 5, None),
                                        (96, (8, 12, 4, 2)), (44 * 100, (44, 100, 4, 2))])
def test_swin_mlp_routes(gen, dt, c, hidden, tokens, geo):
    """B at ragged token counts (the last 64-row tile cut short), with and
    without the unshift, in both routes: bf16 on the tensor-core kernel, f32
    on the FMA kernel, one launch each."""
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    b = 2
    y = rn(b, tokens, c).to(dt)
    wm, bm = sb.gn_fold(y, 1 + 0.1 * rn(c), 0.1 * rn(c))
    mlp = [(rn(c, hidden) / c ** 0.5).to(dt), (0.1 * rn(hidden)).to(dt),
           (rn(hidden, c) / hidden ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
    before = _routes((sb.SWIN_MLP_TC, sb.SWIN_MLP))
    if geo:
        got = sb.mlp_unshift_residual_stats(y, wm, bm, *mlp, *geo)
        want = sb.mlp_unshift_residual_stats_plain(y, wm, bm, *mlp, *geo)
    else:
        got = sb.norm_mlp_residual_stats(y, wm, bm, *mlp)
        want = sb.norm_mlp_residual_stats_plain(y, wm, bm, *mlp)
    tc = dt == torch.bfloat16
    assert _routes((sb.SWIN_MLP_TC, sb.SWIN_MLP)) == [before[0] + tc, before[1] + (not tc)]
    for g_, w_ in zip(got, want):
        _close(g_, w_, dt)


def _attn_case(gen, dt, b, n, c, nh, hw, shifted):
    """Kernel A's inputs at `b` images of an `hw` map of windows of n tokens:
    with a shift, the per-window bias plus the shift mask; else one bias."""
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    ws = int(n ** 0.5)
    h, w = hw
    x = rn(b, h * w, c).to(dt)
    wa_, ba = sb.gn_fold(x, 1 + 0.1 * rn(c), 0.1 * rn(c))
    wts = [(rn(c, 3 * c) / c ** 0.5).to(dt), (0.1 * rn(3 * c)).to(dt),
           (rn(c, c) / c ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
    if not shifted:
        return (x, wa_, ba, *wts, 0.2 * rn(1, nh, n, n), nh, n), None
    geo = (h, w, ws, ws // 2)
    bm = 0.2 * rn((h // ws) * (w // ws), nh, n, n)
    bm = bm + torch.as_tensor(shifted_window_mask(h, w, ws, ws // 2), device="cuda")[:, None]
    return (x, wa_, ba, *wts, bm, nh, n), geo


def _attn_call(args, geo, plain=False):
    if geo is None:
        fn = sb.norm_attn_residual_stats_plain if plain else sb.norm_attn_residual_stats
        return fn(*args)
    fn = sb.shift_attn_residual_stats_plain if plain else sb.shift_attn_residual_stats
    return fn(*args, *geo)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,nh", [(16, 64, 2), (64, 64, 2), (16, 192, 6), (64, 192, 6),
                                    (64, 256, 8), (16, 256, 16), (64, 96, 3)])
@pytest.mark.parametrize("shifted", [False, True])
def test_swin_window_attn_routes(gen, dt, n, c, nh, shifted):
    """A with one shared bias unshifted and with per-window biases plus the
    shift mask through the roll, at 3 images of 3 x 5 windows (45 windows,
    an odd count), head widths 32 and 16 (C = 96: a 64-column panel cut
    short); bf16 launches the tensor-core kernel once, f32 the FMA kernel
    once."""
    ws = int(n ** 0.5)
    args, geo = _attn_case(gen, dt, 3, n, c, nh, (3 * ws, 5 * ws), shifted)
    before = _routes((sb.SWIN_WINDOW_ATTN_TC, sb.SWIN_WINDOW_ATTN))
    got = _attn_call(args, geo)
    tc = dt == torch.bfloat16
    assert _routes((sb.SWIN_WINDOW_ATTN_TC, sb.SWIN_WINDOW_ATTN)) == [before[0] + tc,
                                                                      before[1] + (not tc)]
    for g_, w_ in zip(got, _attn_call(args, geo, plain=True)):
        _close(g_, w_, dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_swin_window_attn_same_bits(gen, dt):
    """Two identical calls of A (the main path's widths, shifted) give the
    same y and statistics, bit for bit."""
    args, geo = _attn_case(gen, dt, 2, 64, 192, 6, (32, 40), True)
    first, second = _attn_call(args, geo), _attn_call(args, geo)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_stats_reduce_over_4096_windows(gen, dt):
    """The second pass of A's statistics over 4096 window partials an image
    (a 256 x 256 map of 4 x 4 windows): within the statistics band of an f64
    sum of A's own output, and the same bits in two runs."""
    args, _ = _attn_case(gen, dt, 2, 16, 64, 2, (256, 256), False)
    y, s, q = _attn_call(args, None)
    y64 = y.double()
    band = {torch.bfloat16: 1e-3, torch.float32: 1e-5}[dt]  # relative, and absolute
    for got, want in ((s, y64.sum(1)), (q, (y64 * y64).sum(1))):
        err = (got.double() - want).abs().max().item()
        assert err <= band + band * want.abs().max().item(), err
    y2, s2, q2 = _attn_call(args, None)
    assert torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(q, q2)


@pytest.mark.parametrize("d", [3, 8])
def test_vq_nearest_ragged_rows(gen, d):
    z = torch.randn(1000, d, generator=gen, device="cuda")
    emb = torch.randn(300, d, generator=gen, device="cuda")
    torch.testing.assert_close(vq.nearest_codebook_indices(z, emb),
                               vq.nearest_codebook_indices_plain(z, emb), rtol=0, atol=0)


def _vq_near_ties(z, emb, got, want):
    """Rows where D's indices differ from the plain version's, checked to be
    near-ties: their f64 distances within 1e-6 of the row's scale
    (chip_smoke.py's rule).  Returns how many differ."""
    differ = (got != want).nonzero().flatten()
    if differ.numel():
        zz, e64 = z[differ].double(), emb.double()
        da = ((zz - e64[got[differ]]) ** 2).sum(1)
        db = ((zz - e64[want[differ]]) ** 2).sum(1)
        scale = (zz ** 2).sum(1) + torch.maximum((e64[got[differ]] ** 2).sum(1),
                                                 (e64[want[differ]] ** 2).sum(1))
        assert bool(((da - db).abs() <= 1e-6 * scale).all()), "indices differ beyond near-ties"
    return differ.numel()


@pytest.mark.parametrize("m", [1000, 4097])
@pytest.mark.parametrize("k", [300, 8191])
@pytest.mark.parametrize("d", [3, 8])
def test_vq_nearest_split(gen, m, k, d):
    """Row counts that no row block divides and codebooks that no slice
    divides, at both codebooks' D: the plain version's indices, except at
    near-ties; one search and one finalize a call."""
    z = torch.randn(m, d, generator=gen, device="cuda")
    emb = 0.5 * torch.randn(k, d, generator=gen, device="cuda")
    before = (vq.VQ_NEAREST.launches, vq.VQ_FINALIZE.launches)
    got = vq.nearest_codebook_indices(z, emb)
    assert (vq.VQ_NEAREST.launches, vq.VQ_FINALIZE.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.int64 and got.shape == (m,)
    _vq_near_ties(z, emb, got, vq.nearest_codebook_indices_plain(z, emb))


@pytest.mark.parametrize("d", [3, 8])
def test_vq_nearest_ties_across_slices(gen, d):
    """A codebook whose rows repeat two or three times, half a codebook and
    more apart (in other slices, whatever the plan): a row equal to a
    repeated code takes its first index, though a later slice may finish
    first; the other rows the plain version's indices, except at
    near-ties."""
    m, k = 4097, 8191
    emb = torch.randn(k, d, generator=gen, device="cuda")
    first = torch.arange(0, 2000, 7, device="cuda")
    emb[first + 4096] = emb[first]
    emb[first[::2] + 6144] = emb[first[::2]]
    z = torch.randn(m, d, generator=gen, device="cuda")
    rows = torch.arange(0, 3 * first.numel(), 3, device="cuda")
    z[rows] = emb[first]
    got, want = vq.nearest_codebook_indices(z, emb), vq.nearest_codebook_indices_plain(z, emb)
    assert torch.equal(got[rows], first) and torch.equal(want[rows], first)
    _vq_near_ties(z, emb, got, want)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c", [(2, 16, 24, 4), (3, 8, 40, 6), (1, 24, 32, 192)])
def test_shift_tokens_exact(gen, dt, b, h, w, c):
    x = torch.randn(b, h * w, c, generator=gen, device="cuda").to(dt)
    # a view one element off the allocation: not 16-byte aligned
    xv = torch.randn(x.numel() + 1, generator=gen, device="cuda").to(dt)[1:].view_as(x)
    for t in (x, xv):
        for inverse in (False, True):
            assert torch.equal(shift.shift_tokens(t, h, w, 8, 4, inverse),
                               shift.shift_tokens_plain(t, h, w, 8, 4, inverse))


F_KERNELS = (tail.GN_SILU_CONV3X3_TC, tail.GN_SILU_CONV3X3, tail.GN_STATS)


def _tail_args(gen, dt, b, c, h, w, co):
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = (1.5 * rn(b, c, h, w) + 0.3).to(dt)
    return (x, 1 + 0.2 * rn(c), 0.5 + 0.3 * rn(c), rn(co, c, 3, 3) / (9 * c) ** 0.5,
            0.1 * rn(co))


def _groups(c):
    """32 GroupNorm groups, or 8 where C is not a multiple of 32 (C = 40)."""
    return 32 if c % 32 == 0 or c < 32 else 8


def _tail_pinned(args, dt):
    """Kernel F pinned: gn_stats once, then the conv of the route tail_route
    picks once; returns the output."""
    c, co = args[0].shape[1], args[3].shape[0]
    route = tail.tail_route("cuda", dt, c, co)
    before = _routes(F_KERNELS)
    got = tail.gn_silu_conv3x3(*args, num_groups=_groups(c), eps=1e-6, use_pallas=True)
    assert _routes(F_KERNELS) == [before[0] + (route == "tc"), before[1] + (route == "fma"),
                                  before[2] + 1], route
    assert got.dtype == dt
    return got


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w,co", [(2, 160, 20, 36, 3), (1, 64, 33, 70, 8),
                                        (3, 24, 16, 32, 5), (1, 8, 5, 7, 1)])
def test_gn_silu_conv3x3_ragged_tiles(gen, dt, b, c, h, w, co):
    """Kernel F on maps that are not whole tiles, channel counts that are not
    whole chunks, and every co padding; a non-zero GN bias, so that a zero
    border of the input would show.  The route is the one tail_route picks
    (bf16 at C % 16 == 0 on the tensor cores, else the FMA kernel)."""
    args = _tail_args(gen, dt, b, c, h, w, co)
    got = _tail_pinned(args, dt)
    n = _routes(F_KERNELS)
    _close(got, tail.gn_silu_conv3x3(*args, eps=1e-6), dt)  # unpinned: plain, no launch
    assert _routes(F_KERNELS) == n


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w,co", [(1, 24, 17, 70, 1), (2, 40, 20, 36, 2),
                                        (1, 64, 33, 70, 8), (2, 160, 18, 65, 5),
                                        (1, 160, 64, 64, 8), (3, 64, 16, 64, 3),
                                        (2, 128, 40, 136, 4), (1, 96, 7, 200, 6)])
def test_gn_silu_conv3x3_routes(gen, dt, b, c, h, w, co):
    """Both routes at ragged shapes (C 24, 40, 64, 96, 128, 160; co 1-8; H and W
    not whole tiles, W % 8 != 0 on the tensor cores' element path): f32
    within 2e-4 and bf16 within the band of the plain version, two calls'
    bits equal (the fixed-order combines), and in bf16 few elements differ
    from the plain version (the conv's f32 sums in another order)."""
    args = _tail_args(gen, dt, b, c, h, w, co)
    got = _tail_pinned(args, dt)
    want = tail.gn_silu_conv3x3(*args, num_groups=_groups(c), eps=1e-6)
    err = (got.float() - want.float()).abs().max().item()
    rel = 2e-4 if dt == torch.float32 else TOL[dt]
    assert err <= 1e-5 + rel * want.float().abs().max().item(), err
    assert torch.equal(got, _tail_pinned(args, dt))
    if dt == torch.bfloat16:
        differ = (got != want).float().mean().item()
        print(f"bf16 {tuple(args[0].shape)} -> {co}: {differ:.4%} of the elements differ")
        assert differ <= 0.02, differ


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 5, 7), (3, 96, 33, 70), (8, 160, 64, 64),
                                   (1, 32, 128, 128), (1, 64, 512, 512)])
def test_gn_stats_matches_the_fold(gen, dt, shape):
    """gn_stats (the split statistics, folded on the card) against
    group_norm_fold, one launch a call, the same bits in two calls."""
    b, c, h, w = shape
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x, scale, gbias = (1.5 * rn(*shape) + 0.3).to(dt), 1 + 0.2 * rn(c), 0.5 + 0.3 * rn(c)
    n = tail.GN_STATS.launches
    got = tail.gn_stats(x, scale, gbias, eps=1e-6)
    assert tail.GN_STATS.launches == n + 1
    want = tail.group_norm_fold(x, scale, gbias, eps=1e-6)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-5)
    again = tail.gn_stats(x, scale, gbias, eps=1e-6)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,c,nh,nw", [(37, 16, 48, 3, 1), (24, 64, 192, 6, 8),
                                         (5, 49, 96, 4, 5)])
def test_window_attention_ragged(gen, dt, m, n, c, nh, nw):
    """K9 at window counts that are no multiple of a block, 49-token
    windows, and a per-window bias; its gradient against plain autograd.
    bf16 takes the tensor-core kernel at heads 16 and 32 wide and the FMA
    kernel at 24 (C = 96, 4 heads); f32 always the FMA kernel."""
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = rn(m, n, c).to(dt)
    wts = [(rn(c, 3 * c) / c ** 0.5).to(dt), (0.1 * rn(3 * c)).to(dt),
           (rn(c, c) / c ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
    bm = 0.2 * rn(nw, nh, n, n)
    tc = dt == torch.bfloat16 and c // nh in (16, 32)
    assert wa.window_attn_route(dt, n, c, nh) == ("tc" if tc else "fma")
    before = _routes((wa.WINDOW_ATTN_TC, wa.WINDOW_ATTN))
    _close(wa.window_attention(x, *wts, bm, nh), wa.window_attention_plain(x, *wts, bm, nh), dt)
    assert _routes((wa.WINDOW_ATTN_TC, wa.WINDOW_ATTN)) == [before[0] + tc, before[1] + (not tc)]
    if dt == torch.float32:
        ins = [t.clone().requires_grad_() for t in (x, *wts, bm)]
        ref = [t.clone().requires_grad_() for t in (x, *wts, bm)]
        g = rn(m, n, c)
        wa.window_attention(*ins, nh).backward(g)
        wa.window_attention_plain(*ref, nh).backward(g)
        for a, b in zip(ins, ref):
            _close(a.grad, b.grad, dt)


def test_window_attention_full_width(gen):
    """K9's bf16 route at the profiling tool's widths, 512 windows of 64
    tokens x 192 channels in 6 heads, with 64 bias rows (rel-pos bias plus
    the shift mask of a 64x64 map): the tensor-core kernel once a call,
    within the band of the plain version, and two calls' bits equal."""
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    m, n, c, nh, dt = 512, 64, 192, 6, torch.bfloat16
    x = rn(m, n, c).to(dt)
    wts = [(rn(c, 3 * c) / c ** 0.5).to(dt), (0.1 * rn(3 * c)).to(dt),
           (rn(c, c) / c ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
    bm = 0.02 * rn(64, nh, n, n) + torch.as_tensor(shifted_window_mask(64, 64, 8, 4),
                                                   device="cuda")[:, None]
    before = _routes((wa.WINDOW_ATTN_TC, wa.WINDOW_ATTN))
    first, second = wa.window_attention(x, *wts, bm, nh), wa.window_attention(x, *wts, bm, nh)
    assert _routes((wa.WINDOW_ATTN_TC, wa.WINDOW_ATTN)) == [before[0] + 2, before[1]]
    _close(first, wa.window_attention_plain(x, *wts, bm, nh), dt)
    assert torch.equal(first, second)


def _conv_routed(fn, tc, fma, dt, variant=None):
    """fn(), which must launch K10's or P1's tensor-core kernel `tc` once in
    bf16 (with `variant`) and its FMA kernel `fma` once in f32."""
    before = (tc.launches, fma.launches, tc.variants.get(variant, 0))
    out = fn()
    bf = dt == torch.bfloat16
    assert (tc.launches, fma.launches) == (before[0] + bf, before[1] + (not bf))
    if bf and variant is not None:
        assert tc.variants.get(variant, 0) == before[2] + 1
    return out


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,co", [(2, 8, 8, 24, 40), (1, 10, 70, 70, 130),
                                        (3, 16, 34, 160, 8)])
def test_winograd_ragged(gen, dt, b, h, w, c, co):
    """K10 with H = W = 8, strips of tiles past the image's edge, channel
    counts that are no multiple of a chunk and Co blocks cut short; bf16 on
    the tensor-core route (16-byte copies where C and Co are multiples of 8),
    f32 on the FMA route."""
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = (0.3 * rn(b, h, w, c)).to(dt)
    wk, bias = (rn(3, 3, c, co) / (9 * c) ** 0.5).to(dt), 0.1 * rn(co)
    variant = "vec" if c % 8 == 0 and co % 8 == 0 else "elem"
    for bb in (bias, None):
        got = _conv_routed(lambda: wg.winograd_conv3x3(x, wk, bb), wg.WINOGRAD_CONV3X3_TC,
                           wg.WINOGRAD_CONV3X3, dt, variant)
        _close(got, wg.winograd_conv3x3_plain(x, wk, bb), dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,co,rows", [(2, 8, 8, 24, 40, None), (1, 13, 70, 70, 130, 1),
                                             (3, 9, 20, 160, 8, 4), (1, 5, 3, 5, 3, 64)])
def test_conv3x3_ragged(gen, dt, b, h, w, c, co, rows):
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = (0.3 * rn(b, h, w, c)).to(dt)
    wk = (rn(3, 3, c, co) / (9 * c) ** 0.5).to(dt)
    variant = "vec" if c % 8 == 0 and co % 8 == 0 else "elem"
    got = _conv_routed(lambda: cv.conv3x3(x, wk, rows), cv.CONV3X3_TC, cv.CONV3X3, dt, variant)
    _close(got, cv.conv3x3_plain(x, wk), dt)


# full width: unet res@64 at batch 2, dec up0@256 (256 -> 128) at batch 1
FULL_WIDTH = [(2, 64, 64, 160, 160), (1, 256, 256, 256, 128)]


@pytest.mark.parametrize("kernel", ["K10", "P1"])
@pytest.mark.parametrize("b,h,w,c,co", FULL_WIDTH)
def test_conv_tc_full_width(gen, kernel, b, h, w, c, co):
    """The bf16 routes at the profiling tools' widths against the plain
    version, and against F.conv2d in f32 within the bf16 band; two calls
    give the same bits."""
    import torch.nn.functional as F

    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = (0.3 * rn(b, h, w, c)).bfloat16()
    wk = (0.05 * rn(3, 3, c, co)).bfloat16()
    bias = 0.1 * rn(co) if kernel == "K10" else None
    if kernel == "K10":
        fk = lambda: wg.winograd_conv3x3(x, wk, bias)
        got = _conv_routed(fk, wg.WINOGRAD_CONV3X3_TC, wg.WINOGRAD_CONV3X3, x.dtype, "vec")
        _close(got, wg.winograd_conv3x3_plain(x, wk, bias), x.dtype)
    else:
        fk = lambda: cv.conv3x3(x, wk)
        got = _conv_routed(fk, cv.CONV3X3_TC, cv.CONV3X3, x.dtype, "vec")
        _close(got, cv.conv3x3_plain(x, wk), x.dtype)
    ref = F.conv2d(x.float().permute(0, 3, 1, 2), wk.float().permute(3, 2, 0, 1), bias,
                   padding=1).permute(0, 2, 3, 1)
    _close(got, ref, x.dtype)
    assert torch.equal(fk(), got)


@pytest.mark.parametrize("h,c,co", [s[2:] for s in profile_winograd.SHAPES])
def test_winograd_tc_census(gen, h, c, co):
    """K10's bf16 route at every conv family of profile_winograd's census
    (H, C, Co), one image: the Co blocks and channel chunks of the widest
    families, against the plain version and F.conv2d in f32."""
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = (0.3 * rn(1, h, h, c)).bfloat16()
    wk, bias = (0.05 * rn(3, 3, c, co)).bfloat16(), 0.1 * rn(co)
    got = _conv_routed(lambda: wg.winograd_conv3x3(x, wk, bias), wg.WINOGRAD_CONV3X3_TC,
                       wg.WINOGRAD_CONV3X3, x.dtype, "vec")
    _close(got, wg.winograd_conv3x3_plain(x, wk, bias), x.dtype)
    _close(got, direct_conv(x.float(), wk.float(), bias), x.dtype)


# P2's shapes (B, T, C, heads, N, one bias row or one a window): bf16 takes
# the tensor-core route at heads 16 or 32 wide (a panel cut short at C = 48,
# the widest C at 256), the FMA route at heads 24 wide; f32 the FMA route
P2_SHAPES = [(3, 96, 64, 2, 16, False), (2, 98, 48, 3, 49, True), (2, 64, 256, 16, 16, True),
             (1, 98, 256, 8, 49, False), (2, 98, 96, 4, 49, True)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softmax", av.SOFTMAX_MODES)
@pytest.mark.parametrize("b,t,c,nh,n,one_bias", P2_SHAPES)
def test_attn_variants_small_windows(gen, dt, softmax, b, t, c, nh, n, one_bias):
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = rn(b, t, c).to(dt)
    wa_, ba = sb.gn_fold(x, 1 + 0.1 * rn(c), 0.1 * rn(c), num_groups=16 if c % 32 else 32)
    wts = [(rn(c, 3 * c) / c ** 0.5).to(dt), (0.1 * rn(3 * c)).to(dt),
           (rn(c, c) / c ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
    bm = 0.02 * rn(1 if one_bias else t // n, nh, n, n)
    route = av.attn_variant_route(dt, n, c, nh)
    assert route == ("tc" if dt == torch.bfloat16 and c // nh in (16, 32) else "fma")
    kern = av.ATTN_VARIANTS_TC if route == "tc" else av.ATTN_VARIANTS
    before = (av.ATTN_VARIANTS_TC.launches, av.ATTN_VARIANTS.launches)
    got = av.attn_variant(x, wa_, ba, *wts, bm, nh, n, softmax)
    again = av.attn_variant(x, wa_, ba, *wts, bm, nh, n, softmax)
    assert (av.ATTN_VARIANTS_TC.launches, av.ATTN_VARIANTS.launches) == (
        before[0] + 2 * (kern is av.ATTN_VARIANTS_TC), before[1] + 2 * (kern is av.ATTN_VARIANTS))
    assert torch.equal(got, again)
    _close(got, av.attn_variant_plain(x, wa_, ba, *wts, bm, nh, n, softmax), dt)
    if softmax == "f32" and dt == torch.float32:  # kernel A's y, but for the folded shift
        _close(got, sb.norm_attn_residual_stats(x, wa_, ba, *wts, bm, nh, n)[0], dt)


def test_wrappers_raise_on_unsupported_shapes(gen):
    q = torch.zeros(1, 64, 256, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_attention_1h(q, q, q)
    # B's tensor-core route (bf16) takes C % 16 == 0; the f32 route takes C = 24
    xm = torch.zeros(1, 64, 24, device="cuda")
    wm, bm = torch.ones(1, 24, device="cuda"), torch.zeros(1, 24, device="cuda")
    mlp = (torch.zeros(24, 64, device="cuda"), torch.zeros(64, device="cuda"),
           torch.zeros(64, 24, device="cuda"), torch.zeros(24, device="cuda"))
    with pytest.raises(ValueError):
        sb.norm_mlp_residual_stats(xm.bfloat16(), wm, bm, *(t.bfloat16() for t in mlp))
    assert sb.norm_mlp_residual_stats(xm, wm, bm, *mlp)[0].shape == xm.shape
    # A's tensor-core route (bf16) takes C % 16 == 0 and heads 16 or 32 wide;
    # the f32 route takes C = 40 and heads 64 wide
    for c, nh in ((40, 2), (128, 2)):
        xa = torch.zeros(1, 64, c, device="cuda")
        aw, ab = torch.ones(1, c, device="cuda"), torch.zeros(1, c, device="cuda")
        wts = (torch.zeros(c, 3 * c, device="cuda"), torch.zeros(3 * c, device="cuda"),
               torch.zeros(c, c, device="cuda"), torch.zeros(c, device="cuda"))
        bias = torch.zeros(1, nh, 16, 16, device="cuda")
        with pytest.raises(ValueError):
            sb.norm_attn_residual_stats(xa.bfloat16(), aw, ab, *(t.bfloat16() for t in wts),
                                        bias, nh, 16)
        assert sb.norm_attn_residual_stats(xa, aw, ab, *wts, bias, nh, 16)[0].shape == xa.shape
    with pytest.raises(ValueError):
        shift.shift_tokens(torch.zeros(1, 60, 8, device="cuda"), 6, 10, 8, 4)
    with pytest.raises(TypeError):
        shift.shift_tokens(torch.zeros(1, 64, 8, device="cuda", dtype=torch.float16), 8, 8, 8, 4)
    x, g = torch.ones(1, 16, 8, 8, device="cuda"), torch.ones(16, device="cuda")
    with pytest.raises(ValueError):  # co > 8
        tail.gn_silu_conv3x3(x, g, g, torch.ones(9, 16, 3, 3, device="cuda"),
                             torch.ones(9, device="cuda"), use_pallas=True)
    with pytest.raises(TypeError):
        tail.gn_silu_conv3x3(x.half(), g, g, torch.ones(3, 16, 3, 3, device="cuda"),
                             torch.ones(3, device="cuda"), use_pallas=True)
    xw = torch.zeros(4, 16, 32, device="cuda")
    with pytest.raises(ValueError):  # 3 windows of bias for 4 windows
        wa.window_attention(xw, torch.zeros(32, 96, device="cuda"), torch.zeros(96, device="cuda"),
                            torch.zeros(32, 32, device="cuda"), torch.zeros(32, device="cuda"),
                            torch.zeros(3, 2, 16, 16, device="cuda"), 2)
    with pytest.raises(ValueError):  # odd H
        wg.winograd_conv3x3(torch.zeros(1, 7, 8, 16, device="cuda"),
                            torch.zeros(3, 3, 16, 16, device="cuda"))
    with pytest.raises(TypeError):
        wg.winograd_conv3x3(torch.zeros(1, 8, 8, 16, device="cuda").half(),
                            torch.zeros(3, 3, 16, 16, device="cuda"))
    with pytest.raises(ValueError):  # rows must divide 64
        cv.conv3x3(torch.zeros(1, 8, 8, 16, device="cuda"),
                   torch.zeros(3, 3, 16, 16, device="cuda"), rows=3)
    with pytest.raises(ValueError):  # and 128 in bf16
        cv.conv3x3(torch.zeros(1, 8, 8, 16, device="cuda").bfloat16(),
                   torch.zeros(3, 3, 16, 16, device="cuda").bfloat16(), rows=3)
    with pytest.raises(ValueError):  # rows = 128 only in bf16
        cv.conv3x3(torch.zeros(1, 8, 8, 16, device="cuda"),
                   torch.zeros(3, 3, 16, 16, device="cuda"), rows=128)
    with pytest.raises(TypeError):
        cv.conv3x3(torch.zeros(1, 8, 8, 16, device="cuda").half(),
                   torch.zeros(3, 3, 16, 16, device="cuda").half())
    with pytest.raises(ValueError):  # odd W, bf16
        wg.winograd_conv3x3(torch.zeros(1, 8, 7, 16, device="cuda").bfloat16(),
                            torch.zeros(3, 3, 16, 16, device="cuda").bfloat16())
    xt = torch.zeros(1, 64, 32, device="cuda")
    aw, ab = torch.ones(1, 32, device="cuda"), torch.zeros(1, 32, device="cuda")
    attn_w = (torch.zeros(32, 96, device="cuda"), torch.zeros(96, device="cuda"),
              torch.zeros(32, 32, device="cuda"), torch.zeros(32, device="cuda"))
    with pytest.raises(ValueError):  # unknown softmax
        av.attn_variant(xt, aw, ab, *attn_w, torch.zeros(1, 2, 16, 16, device="cuda"), 2, 16,
                        "softmax2")
    with pytest.raises(ValueError):  # 72 tokens are no whole number of 16-token windows
        av.attn_variant(torch.zeros(1, 72, 32, device="cuda"), aw, ab, *attn_w,
                        torch.zeros(1, 2, 16, 16, device="cuda"), 2, 16)


def _backward_pair(fn, plain, ins, gen):
    """The gradients of sum(out * r) over every output, through `fn` and
    through `plain`, for every floating input."""
    ins = [t.detach().requires_grad_(True) if t.is_floating_point() else t for t in ins]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    rs = [torch.randn(o.shape, generator=gen, device="cuda") for o in outs]
    wanted = [t for t in ins if t.requires_grad]
    got = torch.autograd.grad(sum((o.float() * r).sum() for o, r in zip(outs, rs)), wanted)
    pouts = plain(*ins)
    pouts = pouts if isinstance(pouts, tuple) else (pouts,)
    want = torch.autograd.grad(sum((o.float() * r).sum() for o, r in zip(pouts, rs)), wanted)
    return got, want


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 2])
def test_swin_halves_backward(gen, dt, shift):
    """A's and B's autograd Functions: the kernel forward launches once, and
    every input's gradient is the plain version's (the backward recomputes
    it; only the order of its scatter-adds may differ)."""
    b, h, w, ws, c, nh, hidden = 2, 8, 12, 4, 64, 2, 128
    t, n = h * w, ws * ws
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = rn(b, t, c).to(dt)
    wa_, ba_ = sb.gn_fold(x, 1 + 0.1 * rn(c), 0.1 * rn(c))
    wts = [(rn(c, 3 * c) / c ** 0.5).to(dt), (0.1 * rn(3 * c)).to(dt),
           (rn(c, c) / c ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
    mlp = [(rn(c, hidden) / c ** 0.5).to(dt), (0.1 * rn(hidden)).to(dt),
           (rn(hidden, c) / hidden ** 0.5).to(dt), (0.1 * rn(c)).to(dt)]
    nw = (h // ws) * (w // ws) if shift else 1
    bm = 0.02 * rn(nw, nh, n, n)
    geo = (h, w, ws, shift)
    if shift:
        bm = bm + torch.as_tensor(shifted_window_mask(h, w, ws, shift), device="cuda")[:, None]
        pairs = [(lambda *a: sb.shift_attn_residual_stats(*a, nh, n, *geo),
                  lambda *a: sb.shift_attn_residual_stats_plain(*a, nh, n, *geo),
                  [x, wa_, ba_, *wts, bm]),
                 (lambda *a: sb.mlp_unshift_residual_stats(*a, *geo),
                  lambda *a: sb.mlp_unshift_residual_stats_plain(*a, *geo), [x, wa_, ba_, *mlp])]
    else:
        pairs = [(lambda *a: sb.norm_attn_residual_stats(*a, nh, n),
                  lambda *a: sb.norm_attn_residual_stats_plain(*a, nh, n),
                  [x, wa_, ba_, *wts, bm]),
                 (sb.norm_mlp_residual_stats, sb.norm_mlp_residual_stats_plain,
                  [x, wa_, ba_, *mlp])]
    for fn, plain, ins in pairs:
        got, want = _backward_pair(fn, plain, ins, gen)
        for a, b_ in zip(got, want):
            _close(a, b_, dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
def test_shift_tokens_backward_is_the_inverse_kernel(gen, dt, inverse):
    """E's backward launches E with `inverse` flipped and equals the plain
    gather's gradient bit for bit (a permutation)."""
    h, w = 16, 24
    x = torch.randn(2, h * w, 32, generator=gen, device="cuda").to(dt)
    n0 = shift.SHIFT_TOKENS.launches
    got, want = _backward_pair(lambda t: shift.shift_tokens(t, h, w, 8, 4, inverse),
                               lambda t: shift.shift_tokens_plain(t, h, w, 8, 4, inverse),
                               [x], gen)
    assert shift.SHIFT_TOKENS.launches - n0 == 2
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("dt,c", [(torch.float32, 40), (torch.bfloat16, 64)])
def test_gn_silu_conv3x3_backward(gen, dt, c):
    """F's autograd Function: the gradients of x, the GroupNorm's scale and
    bias, the conv's weight and bias are the plain composition's."""
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    b, h, w, co = 2, 12, 20, 3
    ins = [(1.5 * rn(b, c, h, w) + 0.3).to(dt), 1 + 0.2 * rn(c), 0.5 + 0.3 * rn(c),
           (rn(co, c, 3, 3) / (9 * c) ** 0.5).to(dt), (0.1 * rn(co)).to(dt)]
    groups = _groups(c)
    fn = lambda *a: tail.gn_silu_conv3x3(*a, num_groups=groups, eps=1e-6, use_pallas=True)
    plain = lambda x, s, gb, wt, bi: tail.gn_silu_conv3x3_plain(
        x, *tail.group_norm_fold(x, s, gb, groups, 1e-6), wt, bi)
    got, want = _backward_pair(fn, plain, ins, gen)
    for a, b_ in zip(got, want):
        _close(a, b_, dt)


def test_flash_attention_refuses_autograd(gen):
    """C has no backward: a launch that autograd would record raises."""
    q = torch.randn(1, 64, 512, generator=gen, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_1h(q, q, q)
    with torch.no_grad():
        assert fa.flash_attention_1h(q, q, q).shape == q.shape
