"""The route gate of kernel K9 (`ops/window_attention.window_attn_route`):
which shapes take the tensor-core kernel `window_attn_tc` (bf16, C % 16 ==
0, heads 16 or 32 wide), which take the FMA kernel `window_attn` (f32 at
every shape, bf16 at the other head widths), and which raise.  Runs on the
CPU; the kernels themselves are held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import pytest
import torch

from resshift_tpu_torch.ops import window_attention as wa

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("n,c,heads", [
    (64, 192, 6),   # the shipped Swin width: 8x8 windows, 6 heads x 32
    (16, 48, 3),    # the card tests' ragged windows, heads of 16
    (64, 256, 8),   # the widest C, heads of 32
    (16, 256, 16),  # heads of 16
    (64, 96, 3),    # a 64-column panel cut short
    (49, 192, 6),   # 7x7 windows
    (1, 16, 1),     # the smallest
])
def test_bf16_takes_the_tensor_core_route(n, c, heads):
    assert wa.window_attn_route(BF16, n, c, heads) == "tc"


@pytest.mark.parametrize("n,c,heads,why", [
    (49, 96, 4, "heads 24 wide: the card test's 7x7 windows"),
    (64, 40, 2, "C % 16 != 0"),
    (64, 128, 2, "heads 64 wide"),
    (64, 96, 2, "heads 48 wide"),
    (64, 64, 8, "heads 8 wide"),
    (64, 64, 1, "one head 64 wide"),
])
def test_bf16_off_the_tensor_core_gate_takes_the_fma_route(n, c, heads, why):
    assert wa.window_attn_route(BF16, n, c, heads) == "fma"


@pytest.mark.parametrize("n,c,heads", [
    (64, 192, 6), (16, 48, 3), (49, 96, 4), (64, 256, 8), (64, 40, 2), (64, 128, 2), (1, 16, 1),
])
def test_f32_takes_the_fma_route(n, c, heads):
    assert wa.window_attn_route(F32, n, c, heads) == "fma"


@pytest.mark.parametrize("dt", [BF16, F32])
@pytest.mark.parametrize("n,c,heads", [
    (65, 192, 6),   # windows over 64 tokens
    (0, 192, 6),
    (64, 272, 17),  # C over 256
    (64, 192, 5),   # C not a multiple of the heads
    (64, 192, 0),
    (64, 256, 2),   # heads 128 wide
])
def test_both_routes_raise(dt, n, c, heads):
    with pytest.raises(ValueError):
        wa.window_attn_route(dt, n, c, heads)


@pytest.mark.parametrize("dt", [torch.float16, torch.float64, torch.int32])
def test_other_dtypes_raise(dt):
    with pytest.raises(TypeError):
        wa.window_attn_route(dt, 64, 192, 6)


@pytest.mark.parametrize("dt", [BF16, F32])
def test_cpu_tensors_take_the_plain_version(dt):
    """On the CPU the wrapper runs the plain version, whatever the gate
    says, and launches neither kernel."""
    g = torch.Generator().manual_seed(0)
    m, n, c, nh = 6, 16, 48, 3
    x = torch.randn(m, n, c, generator=g).to(dt)
    wts = [(torch.randn(c, 3 * c, generator=g) / 7).to(dt), torch.zeros(3 * c, dtype=dt),
           (torch.randn(c, c, generator=g) / 7).to(dt), torch.zeros(c, dtype=dt)]
    bm = 0.02 * torch.randn(2, nh, n, n, generator=g)
    before = (wa.WINDOW_ATTN_TC.launches, wa.WINDOW_ATTN.launches)
    got = wa.window_attention(x, *wts, bm, nh)
    assert (wa.WINDOW_ATTN_TC.launches, wa.WINDOW_ATTN.launches) == before
    assert torch.equal(got, wa.window_attention_plain(x, *wts, bm, nh))
