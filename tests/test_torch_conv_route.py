"""The route gates of kernel K10 (`ops/winograd.conv_route`) and probe P1
(`ops/conv3x3.conv_route`): which route each dtype takes (bf16: the
tensor-core kernels `winograd_conv3x3_tc` and `conv3x3_tc`; f32: the FMA
kernels `winograd_conv3x3` and `conv3x3`) and which shapes raise.  Runs on
the CPU; the kernels themselves are held against the plain versions on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import pytest
import torch

from resshift_tpu_torch.ops import conv3x3 as cv
from resshift_tpu_torch.ops import winograd as wg

BF16, F32 = torch.bfloat16, torch.float32
ROUTE = {BF16: "tc", F32: "fma"}

# (x shape, Co): one of each shape class both routes take
K10_SHAPES = [
    ((8, 64, 64, 160), 160),   # unet res@64: C and Co multiples of 8
    ((1, 256, 256, 256), 128),  # dec up0@256
    ((2, 8, 8, 24), 40),       # C % 8 == 0, Co % 8 == 0, one short Co block
    ((1, 10, 70, 70), 130),    # C % 8 != 0, ragged Co
    ((3, 16, 34, 160), 8),     # Co under a warp's 16 channels
    ((1, 2, 2, 5), 3),         # one tile
]


@pytest.mark.parametrize("dt", [BF16, F32])
@pytest.mark.parametrize("x_shape,co", K10_SHAPES)
def test_k10_route_by_dtype(dt, x_shape, co):
    assert wg.conv_route(dt, x_shape, co) == ROUTE[dt]


@pytest.mark.parametrize("dt", [BF16, F32])
@pytest.mark.parametrize("x_shape,co,why", [
    ((1, 7, 8, 16), 16, "odd H"),
    ((1, 8, 9, 16), 16, "odd W"),
    ((1, 8, 8, 16), 0, "no output channels"),
    ((0, 8, 8, 16), 16, "no images"),
    ((8, 8, 16), 16, "not NHWC"),
])
def test_k10_raises_off_both_routes(dt, x_shape, co, why):
    with pytest.raises(ValueError):
        wg.conv_route(dt, x_shape, co)


def test_k10_fma_grid_limit():
    """The FMA route puts images x Co blocks on the grid's z axis (at most
    65535); the tensor-core route puts every block on its x axis."""
    with pytest.raises(ValueError):
        wg.conv_route(F32, (40000, 2, 2, 8), 128)
    assert wg.conv_route(BF16, (40000, 2, 2, 8), 128) == "tc"


# (x shape, Co, rows): shape classes both routes take
P1_SHAPES = [
    ((8, 64, 64, 160), 160, None),  # profile_conv's shape, whole rows
    ((8, 64, 64, 160), 160, 1),
    ((8, 64, 64, 160), 160, 4),
    ((2, 8, 8, 24), 40, None),      # C % 8 == 0, short Co block
    ((1, 13, 70, 70), 130, 1),      # C % 8 != 0, ragged Co, odd H
    ((3, 9, 20, 160), 8, 4),
    ((1, 5, 3, 5), 3, 64),          # a tile of 64 rows
]


@pytest.mark.parametrize("dt", [BF16, F32])
@pytest.mark.parametrize("x_shape,co,rows", P1_SHAPES)
def test_p1_route_by_dtype(dt, x_shape, co, rows):
    assert cv.conv_route(dt, x_shape, co, rows) == ROUTE[dt]


def test_p1_rows_divide_the_pixel_tile():
    """rows divides the route's pixels per CTA: 128 in bf16, 64 in f32."""
    assert cv.conv_route(BF16, (1, 8, 8, 16), 16, 128) == "tc"
    with pytest.raises(ValueError):
        cv.conv_route(F32, (1, 8, 8, 16), 16, 128)
    for rows in (3, 0, 256, 96):
        for dt in (BF16, F32):
            with pytest.raises(ValueError):
                cv.conv_route(dt, (1, 8, 8, 16), 16, rows)


@pytest.mark.parametrize("w,pix,want", [(64, 128, 2), (64, 64, 1), (3, 128, 32), (200, 128, 1),
                                        (16, 64, 4)])
def test_p1_default_rows_are_whole_rows(w, pix, want):
    assert cv._default_rows(w, pix) == want


@pytest.mark.parametrize("dt", [torch.float16, torch.float64, torch.int8])
def test_other_dtypes_raise(dt):
    with pytest.raises(TypeError):
        wg.conv_route(dt, (1, 8, 8, 16), 16)
    with pytest.raises(TypeError):
        cv.conv_route(dt, (1, 8, 8, 16), 16)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers run the plain versions in bf16 and launch
    neither route."""
    g = torch.Generator().manual_seed(0)
    x = (0.3 * torch.randn(2, 6, 10, 24, generator=g)).to(BF16)
    w = (0.1 * torch.randn(3, 3, 24, 40, generator=g)).to(BF16)
    b = 0.1 * torch.randn(40, generator=g)
    kernels = (wg.WINOGRAD_CONV3X3_TC, wg.WINOGRAD_CONV3X3, cv.CONV3X3_TC, cv.CONV3X3)
    before = [k.launches for k in kernels]
    assert torch.equal(wg.winograd_conv3x3(x, w, b), wg.winograd_conv3x3_plain(x, w, b))
    assert torch.equal(cv.conv3x3(x, w), cv.conv3x3_plain(x, w))
    assert [k.launches for k in kernels] == before


def test_kernel_u_is_the_kernel_transform():
    """The wrappers' U (adds and halvings of w's slices) is the plain
    version's G g G^T (an einsum), position-major, in f32 and rounded to
    bf16."""
    w = torch.randn(3, 3, 24, 40, generator=torch.Generator().manual_seed(1))
    want = wg.winograd_kernel_transform(w).reshape(16, 24, 40)
    torch.testing.assert_close(wg.kernel_u(w, F32), want, rtol=1e-6, atol=1e-7)
    assert wg.kernel_u(w, BF16).shape == (16, 24, 40) and wg.kernel_u(w, BF16).dtype == BF16
