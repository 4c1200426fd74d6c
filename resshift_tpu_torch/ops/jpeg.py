"""A baseline JPEG round trip in numpy that gives the pixels OpenCV's
`cv2.imdecode(cv2.imencode(".jpg", im, [IMWRITE_JPEG_QUALITY, q]))` gives
(OpenCV 5 on libjpeg-turbo 3: baseline, 4:2:0, the islow DCT both ways,
fancy upsampling), so that the data path runs where OpenCV is not
installed.

Entropy coding is lossless, so no bitstream is written: the decoded pixels
follow from these stages alone, each in libjpeg's integer arithmetic on
8x8 blocks held as batched numpy arrays (each DCT pass one matrix product
of integers held exactly in float64, then libjpeg's rounding shifts):

  * RGB -> YCbCr with 16-bit fixed-point tables (`jccolor.c`);
  * the h2v2 chroma downsample with its alternating 1/2 bias
    (`jcsample.c`), the planes extended by edge replication to whole blocks
    (`jcprepct.c`, `expand_right_edge`);
  * the islow forward DCT (`jfdctint.c`) and quantisation by the standard
    tables scaled for `quality` (`jcparam.c`), divided with rounding
    (`jcdctmgr.c`);
  * dequantisation and the islow inverse DCT with its range-limit table
    (`jidctint.c`, `jdmaster.c`);
  * the h2v2 fancy (triangular) upsample, or the box upsample where the
    chroma is at most two samples wide (`jdsample.c`);
  * YCbCr -> RGB with fixed-point tables (`jdcolor.c`).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["jpeg_roundtrip", "quant_tables"]

_STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64).reshape(8, 8)
_STD_CHROMA = np.full((8, 8), 99, np.int64)
_STD_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                       [47, 66, 99, 99]]

_CONST_BITS, _PASS1_BITS, _SCALEBITS = 13, 2, 16
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """The luma and chroma tables of `jpeg_set_quality(cinfo, quality,
    force_baseline=TRUE)`: the standard tables scaled by 5000 / q below 50,
    else 200 - 2q percent, rounded, clamped to 1..255."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_STD_LUMA, _STD_CHROMA))


def _fdct_lin(d: list) -> list:
    """One pass of `jpeg_fdct_islow` over the 8 inputs d[0..7], up to its
    final descale: each output is an integer combination of the inputs."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z1 = (tmp12 + tmp13) * _F0541
    even = [tmp10 + tmp11, z1 + tmp13 * _F0765, tmp10 - tmp11, z1 - tmp12 * _F1847]
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    odd = [tmp7 + z1 + z4, tmp6 + z2 + z3, tmp5 + z2 + z4, tmp4 + z1 + z3]
    return [even[0], odd[0], even[1], odd[1], even[2], odd[2], even[3], odd[3]]


def _idct_lin(d: list) -> list:
    """One pass of `jpeg_idct_islow` over the 8 inputs d[0..7], up to its
    final descale."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (d[0] + d[4]) * (1 << _CONST_BITS)
    tmp1 = (d[0] - d[4]) * (1 << _CONST_BITS)
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _F1175
    tmp0, tmp1, tmp2, tmp3 = tmp0 * _F0298, tmp1 * _F2053, tmp2 * _F3072, tmp3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    tmp0, tmp1 = tmp0 + z1 + z3, tmp1 + z2 + z4
    tmp2, tmp3 = tmp2 + z2 + z3, tmp3 + z1 + z4
    return [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
            tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]


@functools.lru_cache(maxsize=1)
def _passes() -> dict:
    """Each pass as (8x8 integer matrix, per-output right shift): the
    butterflies evaluated on the unit vectors.  The forward row pass scales
    its outputs 0 and 4 by 2**PASS1_BITS (shift 0); every other output is
    descaled with rounding, (v + 2**(n-1)) >> n."""
    eye = list(np.eye(8, dtype=np.int64))
    f, i = np.stack(_fdct_lin(eye)), np.stack(_idct_lin(eye))
    f_rows = f * np.array([1 << _PASS1_BITS, 1, 1, 1, 1 << _PASS1_BITS, 1, 1, 1])[:, None]
    odd = _CONST_BITS - _PASS1_BITS
    return {"fdct rows": (f_rows, [0, odd, odd, odd, 0, odd, odd, odd]),
            "fdct cols": (f, [_PASS1_BITS] + [_CONST_BITS + _PASS1_BITS] * 3 + [_PASS1_BITS]
                          + [_CONST_BITS + _PASS1_BITS] * 3),
            "idct cols": (i, [_CONST_BITS - _PASS1_BITS] * 8),
            "idct rows": (i, [_CONST_BITS + _PASS1_BITS + 3] * 8)}


def _pass(x: np.ndarray, name: str) -> np.ndarray:
    """A pass along the last axis of (N, 8, 8) integer-valued float64 x: one
    matrix product (exact: every sum stays below 2**53) and the descale."""
    m, shifts = _passes()[name]
    v = (x.reshape(-1, 8) @ m.T.astype(np.float64)).reshape(x.shape)
    shifts = np.asarray(shifts)
    half = np.where(shifts > 0, np.exp2(shifts - 1), 0.0)
    return np.floor((v + half) * np.exp2(-shifts))


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """`jpeg_fdct_islow` on (N, 8, 8) centred samples: rows, then columns;
    the result is 8x the true DCT."""
    rows = _pass(blocks.astype(np.float64), "fdct rows")
    return _pass(rows.transpose(0, 2, 1), "fdct cols").transpose(0, 2, 1)


@functools.lru_cache(maxsize=1)
def _idct_range_limit() -> np.ndarray:
    """The post-IDCT half of `prepare_range_limit_table`, indexed by
    (centred value & 1023): x + 128 clamped to 0..255 for |x| < 512, and
    libjpeg's wrap-around beyond."""
    t = np.empty(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[512:896] = 0
    t[896:] = np.arange(0, 128)
    return t


def _idct(coef: np.ndarray) -> np.ndarray:
    """`jpeg_idct_islow` on (N, 8, 8) dequantised coefficients: columns,
    then rows, then the range limit; uint8 samples."""
    cols = _pass(coef.transpose(0, 2, 1), "idct cols").transpose(0, 2, 1)
    rows = _pass(cols, "idct rows").astype(np.int64)
    return _idct_range_limit()[rows & 1023]


def _code_plane(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """A plane already extended to whole blocks -> its decoded samples:
    forward DCT, quantisation (rounded division by 8 q), dequantisation,
    inverse DCT."""
    h, w = plane.shape
    blocks = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    coef = _fdct(blocks - 128)
    div = (table << 3).astype(np.float64)
    q = np.floor((np.abs(coef) + np.floor(div / 2)) / div)
    out = _idct(np.where(coef < 0, -q, q) * table)
    return out.reshape(h // 8, w // 8, 8, 8).transpose(0, 2, 1, 3).reshape(h, w).astype(np.int64)


def _pad_edge(x: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(x, ((0, h - x.shape[0]), (0, w - x.shape[1])), mode="edge")


def _rgb_to_ycc(rgb: np.ndarray) -> tuple:
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, center = 1 << (_SCALEBITS - 1), 128 << _SCALEBITS
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> _SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + center + half - 1) \
        >> _SCALEBITS
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + center + half - 1) \
        >> _SCALEBITS
    return y, cb, cr


def _downsample_h2v2(c: np.ndarray, h_blocks: int, w_blocks: int) -> np.ndarray:
    """`h2v2_downsample`: the full-resolution plane extended right to
    2 * 8 * w_blocks columns and down to an even row count by replication,
    2x2 sums with a bias of 1, 2, 1, 2, ... along each row, >> 2; then the
    rows extended to 8 * h_blocks by replication."""
    h, w = c.shape
    c = _pad_edge(c, h + h % 2, 16 * w_blocks)
    s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
    bias = 1 + (np.arange(s.shape[1]) % 2)
    return _pad_edge((s + bias) >> 2, 8 * h_blocks, 8 * w_blocks)


def _upsample_h2v2(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """`h2v2_fancy_upsample` (triangular, 3/4 nearer and 1/4 further
    sample in each direction, biases 8 and 7 alternating along a row, the
    edges replicated) where the plane is more than 2 samples wide, else
    `h2v2_upsample` (each sample to 2x2); cropped to h x w."""
    if c.shape[1] <= 2:
        return np.repeat(np.repeat(c, 2, 0), 2, 1)[:h, :w]
    up = np.concatenate([c[:1], c[:-1]], 0)
    down = np.concatenate([c[1:], c[-1:]], 0)
    sums = np.empty((2 * c.shape[0], c.shape[1]), np.int64)
    sums[0::2] = 3 * c + up
    sums[1::2] = 3 * c + down
    left = np.concatenate([sums[:, :1], sums[:, :-1]], 1)
    right = np.concatenate([sums[:, 1:], sums[:, -1:]], 1)
    out = np.empty((sums.shape[0], 2 * sums.shape[1]), np.int64)
    out[:, 0::2] = (3 * sums + left + 8) >> 4
    out[:, 1::2] = (3 * sums + right + 7) >> 4
    return out[:h, :w]


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    half = 1 << (_SCALEBITS - 1)
    x_cb, x_cr = cb - 128, cr - 128
    r = y + ((_fix(1.40200) * x_cr + half) >> _SCALEBITS)
    g = y + ((-_fix(0.34414) * x_cb + half - _fix(0.71414) * x_cr) >> _SCALEBITS)
    b = y + ((_fix(1.77200) * x_cb + half) >> _SCALEBITS)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def jpeg_roundtrip(rgb: np.ndarray, quality: int) -> np.ndarray:
    """The decoded pixels of a baseline 4:2:0 JPEG of `rgb` (uint8 H x W x 3)
    at `quality` (1..100, clamped as libjpeg clamps it), as OpenCV's encoder
    and decoder give them."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"want uint8 H x W x 3, got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    t_luma, t_chroma = quant_tables(quality)
    y, cb, cr = _rgb_to_ycc(rgb)
    hb, wb = -(-h // 16), -(-w // 16)  # chroma blocks; luma has ceil(side / 8)
    y = _code_plane(_pad_edge(y, 8 * -(-h // 8), 8 * -(-w // 8)), t_luma)[:h, :w]
    h2, w2 = -(-h // 2), -(-w // 2)
    cb, cr = (_upsample_h2v2(_code_plane(_downsample_h2v2(c, hb, wb), t_chroma)[:h2, :w2],
                             h, w) for c in (cb, cr))
    return _ycc_to_rgb(y, cb, cr)
