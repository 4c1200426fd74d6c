"""The route gate of kernel A (`ops/swin_block.attn_route`): which shapes
each dtype's route takes (bf16: the tensor-core kernel `swin_window_attn_tc`;
f32: the FMA kernel `swin_window_attn`) and which raise.  Runs on the CPU;
the kernels themselves are held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import pytest
import torch

from resshift_tpu_torch.ops import swin_block as sb

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("n_win,c,heads", [
    (64, 192, 6),   # every shipped config (8x8 windows, embed 192, 6 heads x 32)
    (16, 64, 2),    # the card tests' small windows
    (64, 256, 8),   # the widest C, heads of 32
    (16, 256, 16),  # heads of 16
    (64, 48, 3),    # a 64-column panel cut short
    (49, 96, 3),    # 7x7 windows
    (1, 16, 1),     # the smallest
])
def test_bf16_takes_the_tensor_core_route(n_win, c, heads):
    assert sb.attn_route(BF16, n_win, c, heads) == "tc"


@pytest.mark.parametrize("n_win,c,heads", [
    (64, 192, 6), (16, 64, 2), (64, 256, 8), (64, 128, 2), (64, 40, 2), (64, 72, 3),
])
def test_f32_takes_the_fma_route(n_win, c, heads):
    """f32 keeps the FMA route's wider gate: any C up to 256 and heads up to
    64 wide, C % 16 or not."""
    assert sb.attn_route(F32, n_win, c, heads) == "fma"


@pytest.mark.parametrize("n_win,c,heads,why", [
    (64, 40, 2, "C % 16 != 0"),
    (64, 72, 3, "heads 24 wide, C % 16 != 0"),
    (64, 128, 2, "heads 64 wide"),
    (64, 96, 2, "heads 48 wide"),
    (64, 64, 8, "heads 8 wide"),
    (64, 64, 1, "one head 64 wide"),
])
def test_bf16_raises_off_its_route(n_win, c, heads, why):
    with pytest.raises(ValueError):
        sb.attn_route(BF16, n_win, c, heads)


@pytest.mark.parametrize("dt", [BF16, F32])
@pytest.mark.parametrize("n_win,c,heads", [
    (65, 192, 6),   # windows over 64 tokens
    (0, 192, 6),
    (64, 272, 17),  # C over 256
    (64, 192, 5),   # C not a multiple of the heads
    (64, 192, 0),
    (64, 256, 2),   # heads 128 wide
])
def test_both_routes_raise(dt, n_win, c, heads):
    with pytest.raises(ValueError):
        sb.attn_route(dt, n_win, c, heads)


@pytest.mark.parametrize("dt", [torch.float16, torch.float64])
def test_other_dtypes_raise(dt):
    with pytest.raises(TypeError):
        sb.attn_route(dt, 64, 192, 6)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs the plain version in bf16, whatever the
    gate says, and launches neither route."""
    g = torch.Generator().manual_seed(0)
    b, t, c, nh, n = 2, 128, 64, 2, 64
    x = torch.randn(b, t, c, generator=g).to(BF16)
    w, bb = sb.gn_fold(x, torch.ones(c), torch.zeros(c))
    wts = [(torch.randn(c, 3 * c, generator=g) / 8).to(BF16), torch.zeros(3 * c, dtype=BF16),
           (torch.randn(c, c, generator=g) / 8).to(BF16), torch.zeros(c, dtype=BF16)]
    bm = 0.02 * torch.randn(1, nh, n, n, generator=g)
    before = (sb.SWIN_WINDOW_ATTN_TC.launches, sb.SWIN_WINDOW_ATTN.launches)
    got = sb.norm_attn_residual_stats(x, w, bb, *wts, bm, nh, n)
    want = sb.norm_attn_residual_stats_plain(x, w, bb, *wts, bm, nh, n)
    assert (sb.SWIN_WINDOW_ATTN_TC.launches, sb.SWIN_WINDOW_ATTN.launches) == before
    for a, e in zip(got, want):
        assert torch.equal(a, e)
