"""Numpy stand-ins for the OpenCV calls that the data paths make (the LaMa
masks and distortions; the face and BSRGAN degradations' float32 resizes,
filter2D and gray), so that the port runs where OpenCV is not installed.
Each function names the call it replaces, with its flags.

They follow OpenCV's integer arithmetic where it is practical: the
fixed-point resize (11-bit coefficients), the 8-bit HSV conversion with its
division tables, CLAHE's clip, redistribution and float interpolation, and
the rasteriser of thick lines (a fixed-point convex polygon with rounded
caps) and filled circles, and the 8-bit RGB -> LAB tables.  The warps and
remap follow OpenCV 5's float32 bilinear kernel.  LAB -> RGB is computed
from OpenCV's formulas in floating point, where OpenCV uses integer tables.
The float32 resizes follow OpenCV 5's arithmetic: INTER_LINEAR as a fused
multiply-add lerp along each axis, INTER_AREA's tables and its integer-ratio
sums in OpenCV's order; INTER_CUBIC's sums are not OpenCV's (a few ulp).
filter2D with a large kernel is a float64 FFT, rounded once.  The bands that
remain are measured against OpenCV in the port's tests and listed in
ROADMAP.md section 3.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["resize_linear", "resize_float", "filter2d", "rgb_to_gray_float",
           "get_perspective_transform", "warp_perspective", "warp_affine",
           "copy_make_border_reflect101", "init_undistort_rectify_map", "remap",
           "rgb_to_lab", "lab_to_rgb", "clahe", "rgb_to_hsv", "hsv_to_rgb", "line", "circle"]

_RESIZE_BITS = 11


def _border_index(p: np.ndarray, n: int, mode: str) -> np.ndarray:
    """cv::borderInterpolate for "replicate", "reflect" (fedcba|abcdef) and
    "reflect101" (fedcb|abcdef) on an int array of coordinates."""
    p = np.asarray(p, np.int64)
    if mode == "replicate":
        return np.clip(p, 0, n - 1)
    if n == 1:
        return np.zeros_like(p)
    delta = 1 if mode == "reflect101" else 0
    while ((p < 0) | (p >= n)).any():  # reflect again until every index is inside
        p = np.where(p < 0, -p - 1 + delta, np.where(p >= n, n - 1 - (p - n) - delta, p))
    return p


def _round_half_even(x: np.ndarray) -> np.ndarray:
    return np.rint(x).astype(np.int64)


def _sat_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(x, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ resize

def _linear_taps(n_in: int, n_out: int):
    """INTER_LINEAR's source index and its two 11-bit weights along one
    axis (each rounded from its float32 value on its own, as OpenCV does)."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    edge = (s < 0) | (s >= n_in - 1)
    f = np.where(edge, np.float32(0), f)
    s = np.clip(s, 0, n_in - 1)
    one = np.float32(1 << _RESIZE_BITS)
    return s, _round_half_even((np.float32(1) - f) * one), _round_half_even(f * one)


def resize_linear(im: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR) on uint8 HWC:
    a horizontal pass in integers (11-bit weights), then the vertical one
    rounded as OpenCV's vector path does it."""
    w_out, h_out = size_wh
    h_in, w_in = im.shape[:2]
    x = im.astype(np.int64)
    sx, ax0, ax1 = _linear_taps(w_in, w_out)
    sy, by0, by1 = _linear_taps(h_in, h_out)
    sx1 = np.minimum(sx + 1, w_in - 1)
    sy1 = np.minimum(sy + 1, h_in - 1)
    col = lambda a: a.reshape((-1,) + (1,) * (im.ndim - 2))
    row = lambda a: a.reshape((-1,) + (1,) * (im.ndim - 1))
    horiz = x[:, sx] * col(ax0) + x[:, sx1] * col(ax1)  # (h_in, w_out[, c])
    r0, r1 = horiz[sy] >> 4, horiz[sy1] >> 4
    v = ((r0 * row(by0)) >> 16) + ((r1 * row(by1)) >> 16)
    return _sat_u8((v + 2) >> 2)


# ------------------------------------------------------------------ float32

def _coord_taps(n_in: int, n_out: int, area_mode: bool = False):
    """The source index and float32 fractional offset of each output
    sample along one axis, as cv::resize computes them from scale = 1 /
    (n_out / n_in): INTER_LINEAR's offset in double, rounded to float32 (an
    offset that rounds up to 1 moves to the next source with offset 0);
    INTER_AREA's enlarging mode floor(d * scale) and the float32 fraction of
    (d + 1) - (s + 1) / scale."""
    inv = n_out / n_in
    scale = 1.0 / inv
    d = np.arange(n_out, dtype=np.float64)
    if area_mode:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv).astype(np.float32)
        return s, np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    f = (d + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    up = f >= 1
    return s + up, np.where(up, np.float32(0), f)


def _linear_axis(x: np.ndarray, n_out: int, axis: int, area_mode: bool) -> np.ndarray:
    """INTER_LINEAR along one axis of float32 x: a source index left of 0
    or at the last sample takes that sample alone (offset 0).  OpenCV 5's
    INTER_LINEAR lerps as fma(p1 - p0, f, p0); its INTER_AREA enlarging
    path (the older kernel) as p0 * (1 - f) + p1 * f, each rounded."""
    n_in = x.shape[axis]
    s, f = _coord_taps(n_in, n_out, area_mode)
    f = np.where((s < 0) | (s >= n_in - 1), np.float32(0), f)
    s = np.clip(s, 0, n_in - 1)
    shape = [1] * x.ndim
    shape[axis] = -1
    f = f.reshape(shape)
    p0 = np.take(x, s, axis)
    p1 = np.take(x, np.minimum(s + 1, n_in - 1), axis)
    if area_mode:
        return p0 * (np.float32(1) - f) + p1 * f
    return _fma32(f, p1 - p0, p0)


def _cubic_axis(x: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """INTER_CUBIC (A = -0.75) along one axis of float32 x, the taps
    clamped to the edge; the four weights from the double offset, rounded
    to float32, the sum in float64 rounded once (OpenCV's float32 sums
    differ from it by a few ulp)."""
    n_in = x.shape[axis]
    s, f = _coord_taps(n_in, n_out)
    a = -0.75
    f = f.astype(np.float64)
    c0 = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
    c1 = ((a + 2) * f - (a + 3)) * f * f + 1
    c2 = ((a + 2) * (1 - f) - (a + 3)) * (1 - f) * (1 - f) + 1
    shape = [1] * x.ndim
    shape[axis] = -1
    out = np.zeros(x.shape[:axis] + (n_out,) + x.shape[axis + 1:], np.float64)
    for j, c in enumerate((c0, c1, c2, 1 - c0 - c1 - c2)):
        tap = np.take(x, np.clip(s + j - 1, 0, n_in - 1), axis)
        out += tap * c.astype(np.float32).astype(np.float64).reshape(shape)
    return out.astype(np.float32)


def _area_table(n_in: int, n_out: int, scale: float):
    """computeResizeAreaTab: for each output sample, its source indices and
    float32 weights in OpenCV's order, padded to one width (weight 0)."""
    rows = []
    for d in range(n_out):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, n_in - fs1)
        s2 = min(math.floor(fs2), n_in - 1)
        s1 = min(math.ceil(fs1), s2)
        taps = []
        if s1 - fs1 > 1e-3:
            taps.append((s1 - 1, (s1 - fs1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            taps.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((n_out, k), np.int64)
    wt = np.zeros((n_out, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, w) in enumerate(taps):
            idx[d, j], wt[d, j] = s, w
    return idx, wt


def _area_axis(x: np.ndarray, n_out: int, axis: int, scale: float) -> np.ndarray:
    """INTER_AREA shrinking along one axis: each output the float32 sum of
    its weighted sources in table order (an empty slot adds 0 * x)."""
    idx, wt = _area_table(x.shape[axis], n_out, scale)
    shape = [1] * x.ndim
    shape[axis] = -1
    acc = np.take(x, idx[:, 0], axis) * wt[:, 0].reshape(shape)
    for j in range(1, idx.shape[1]):
        acc = acc + np.take(x, idx[:, j], axis) * wt[:, j].reshape(shape)
    return acc


def _area_fast(x: np.ndarray, sx: int, sy: int) -> np.ndarray:
    """INTER_AREA at integer ratios: the sx * sy sources of each output in
    row-major order, summed four at a time as OpenCV's unrolled loop sums
    them, times float32(1 / (sx * sy))."""
    h, w = x.shape[0] // sy, x.shape[1] // sx
    src = [x[i::sy, j::sx][:h, :w] for i in range(sy) for j in range(sx)]
    total = np.zeros_like(src[0])
    k = 0
    while k + 4 <= len(src):
        total = total + (((src[k] + src[k + 1]) + src[k + 2]) + src[k + 3])
        k += 4
    for s in src[k:]:
        total = total + s
    return total * np.float32(1.0 / (sx * sy))


def resize_float(im: np.ndarray, size_wh: tuple[int, int], interpolation: str) -> np.ndarray:
    """cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR | INTER_CUBIC |
    INTER_AREA) on a float32 H x W [x C] image: "linear", "cubic" or
    "area".  The same size returns a copy, as OpenCV does."""
    x = np.asarray(im, np.float32)
    w_out, h_out = size_wh
    h_in, w_in = x.shape[:2]
    if (h_out, w_out) == (h_in, w_in):
        return x.copy()
    if interpolation == "linear":
        return _linear_axis(_linear_axis(x, w_out, 1, False), h_out, 0, False)
    if interpolation == "cubic":
        return _cubic_axis(_cubic_axis(x, w_out, 1), h_out, 0)
    if interpolation != "area":
        raise ValueError(f"interpolation {interpolation!r}: want linear, cubic or area")
    scale_x, scale_y = 1.0 / (w_out / w_in), 1.0 / (h_out / h_in)
    if scale_x >= 1 and scale_y >= 1:
        ix, iy = round(scale_x), round(scale_y)
        eps = np.finfo(np.float64).eps
        if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
            return _area_fast(x, ix, iy)
        return _area_axis(_area_axis(x, w_out, 1, scale_x), h_out, 0, scale_y)
    return _linear_axis(_linear_axis(x, w_out, 1, True), h_out, 0, True)


def filter2d(im: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.filter2D(im, -1, kernel) on a float32 H x W [x C] image: the
    correlation with `kernel` (anchor at its centre) over a
    BORDER_REFLECT_101 border.  Computed as a float64 FFT convolution with
    the flipped kernel (OpenCV filters large kernels through the DFT),
    rounded once to float32; scipy.fft's transforms release the GIL, so
    loader threads filter in parallel."""
    from scipy import fft

    x = np.asarray(im, np.float32)
    k = np.asarray(kernel, np.float64)
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    pad = copy_make_border_reflect101(x, ph, kh - 1 - ph, pw, kw - 1 - pw).astype(np.float64)
    h, w = pad.shape[:2]
    shape = (fft.next_fast_len(h, True), fft.next_fast_len(w, True))
    spec = fft.rfft2(k[::-1, ::-1], s=shape).reshape(shape[:1] + (-1,) + (1,) * (x.ndim - 2))
    out = fft.irfft2(fft.rfft2(pad, s=shape, axes=(0, 1)) * spec, s=shape, axes=(0, 1))
    return out[kh - 1:h, kw - 1:w].astype(np.float32)


def rgb_to_gray_float(im: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(im, cv2.COLOR_RGB2GRAY) on float32 H x W x 3: 0.299 R +
    0.587 G + 0.114 B as OpenCV's vector path computes it, fma(B, 0.114,
    fma(R, 0.299, G * 0.587)) in float32."""
    x = np.asarray(im, np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return _fma32(np.float32(0.114), b, _fma32(np.float32(0.299), r, g * np.float32(0.587)))


# ------------------------------------------------------------------ warps

def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getPerspectiveTransform(src, dst): the 3x3 homography (float64,
    M[2, 2] = 1) taking the four `src` points to `dst`."""
    src, dst = np.asarray(src, np.float64), np.asarray(dst, np.float64)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        (x, y), (u, v) = src[i], dst[i]
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def _fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add a * b + c: the product and sum in float64
    (a float32 product is exact there), rounded once to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _bilinear(im: np.ndarray, sx: np.ndarray, sy: np.ndarray, border: str) -> np.ndarray:
    """OpenCV 5's INTER_LINEAR warp kernel on uint8: float32 source
    coordinates, the four taps (the border rule for those outside), two
    horizontal lerps and a vertical one as float32 fused multiply-adds,
    rounded half to even and saturated."""
    h, w = im.shape[:2]
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = (sx - x0).astype(np.float32), (sy - y0).astype(np.float32)
    xi = np.clip(x0, -2 ** 31, 2 ** 31 - 2).astype(np.int64)
    yi = np.clip(y0, -2 ** 31, 2 ** 31 - 2).astype(np.int64)
    c0, c1 = _border_index(xi, w, border), _border_index(xi + 1, w, border)
    r0, r1 = _border_index(yi, h, border), _border_index(yi + 1, h, border)
    src = im.astype(np.float32)
    if im.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]
    p00, p01, p10, p11 = src[r0, c0], src[r0, c1], src[r1, c0], src[r1, c1]
    top = _fma32(ax, p01 - p00, p00)
    bot = _fma32(ax, p11 - p10, p10)
    return _sat_u8(np.rint(_fma32(ay, bot - top, top)))


def warp_perspective(im: np.ndarray, m: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """cv2.warpPerspective(im, m, (w, h), flags=cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_REPLICATE) on uint8: m inverted in double; each
    row's offsets in double, rounded to float32, the column terms added by
    float32 fused multiply-adds, divided by w; bilinear."""
    w, h = size_wh
    mi = np.linalg.inv(np.asarray(m, np.float64)).ravel()
    mf = mi.astype(np.float32)
    x = np.arange(w, dtype=np.float32)
    y = np.arange(h, dtype=np.float64)[:, None]
    off = [(y * mi[r + 1] + mi[r + 2]).astype(np.float32) for r in (0, 3, 6)]
    ww = _fma32(mf[6], x, off[2])
    inv = np.where(ww != 0, np.float32(1) / np.where(ww != 0, ww, np.float32(1)),
                   np.float32(0)).astype(np.float32)
    sx = _fma32(mf[0], x, off[0]) * inv
    sy = _fma32(mf[3], x, off[1]) * inv
    return _bilinear(im, sx, sy, "replicate")


def warp_affine(im: np.ndarray, m: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """cv2.warpAffine(im, m, (w, h), flags=cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_REFLECT) on uint8: the 2x3 `m` inverted in
    double; each row's offset in double, rounded to float32, the column
    term added by a float32 fused multiply-add; bilinear."""
    w, h = size_wh
    m = np.asarray(m, np.float64).ravel()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    a12, a21 = -m[1] * d, -m[3] * d
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    x = np.arange(w, dtype=np.float32)
    y = np.arange(h, dtype=np.float64)[:, None]
    sx = _fma32(np.float32(a11), x, (y * a12 + b1).astype(np.float32))
    sy = _fma32(np.float32(a21), x, (y * a22 + b2).astype(np.float32))
    return _bilinear(im, sx, sy, "reflect")


def copy_make_border_reflect101(im: np.ndarray, top: int, bottom: int, left: int,
                                right: int) -> np.ndarray:
    """cv2.copyMakeBorder(im, top, bottom, left, right, cv2.BORDER_REFLECT_101)."""
    h, w = im.shape[:2]
    rows = _border_index(np.arange(-top, h + bottom), h, "reflect101")
    cols = _border_index(np.arange(-left, w + right), w, "reflect101")
    return im[rows][:, cols]


def init_undistort_rectify_map(camera: np.ndarray, dist: np.ndarray,
                               size_wh: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """cv2.initUndistortRectifyMap(camera, dist, None, None, (w, h),
    cv2.CV_32FC1): no rectification, the new camera the old one with its
    principal point at the centre ((w - 1) / 2, (h - 1) / 2); distortion
    (k1, k2, p1, p2[, k3]).  Returns the float32 x and y maps."""
    w, h = size_wh
    a = np.asarray(camera, np.float64)
    k = np.zeros(5)
    dd = np.asarray(dist, np.float64).ravel()
    k[:min(5, dd.size)] = dd[:5]
    k1, k2, p1, p2, k3 = k
    ar = a.copy()
    ar[0, 2], ar[1, 2] = (w - 1) * 0.5, (h - 1) * 0.5
    ir = np.linalg.inv(ar).ravel()
    fx, fy, u0, v0 = a[0, 0], a[1, 1], a[0, 2], a[1, 2]
    i = np.arange(h, dtype=np.float64)[:, None]
    j = np.arange(w, dtype=np.float64)
    _x = i * ir[1] + ir[2] + j * ir[0]
    _y = i * ir[4] + ir[5] + j * ir[3]
    _w = i * ir[7] + ir[8] + j * ir[6]
    ww = 1.0 / _w
    x, y = _x * ww, _y * ww
    x2, y2 = x * x, y * y
    r2, _2xy = x2 + y2, 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
    return u.astype(np.float32), v.astype(np.float32)


def remap(im: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(im, map_x, map_y, interpolation=cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_REFLECT_101) with float32 maps on uint8."""
    return _bilinear(im, map_x.astype(np.float32), map_y.astype(np.float32), "reflect101")


# ------------------------------------------------------------------ colour

_HSV_SHIFT = 12


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], _round_half_even((255 << _HSV_SHIFT) / i)])
    hdiv = np.concatenate([[0], _round_half_even((180 << _HSV_SHIFT) / (6.0 * i))])
    return sdiv, hdiv


def rgb_to_hsv(im: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(im, cv2.COLOR_RGB2HSV) on uint8: H in [0, 180), S and V
    in [0, 255], by OpenCV's integer arithmetic and division tables."""
    sdiv, hdiv = _hsv_tables()
    r, g, b = (im[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([_sat_u8(h), s.astype(np.uint8), v.astype(np.uint8)], axis=-1)


def hsv_to_rgb(im: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(im, cv2.COLOR_HSV2RGB) on uint8 (H in [0, 180)): S and V
    scaled to [0, 1] and the sector formula in float32 (1 - s * h as a fused
    multiply-add), times 255, truncated, as OpenCV 5's kernel does."""
    f32 = np.float32
    h = im[..., 0].astype(f32) * f32(6.0 / 180)
    s = im[..., 1].astype(f32) * f32(1 / 255)
    v = im[..., 2].astype(f32) * f32(1 / 255)
    sector = np.floor(h).astype(np.int64)
    h = (h - sector.astype(f32)).astype(f32)
    one = np.ones_like(s)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, h, one), v * _fma32(-s, one - h, one)])
    order = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    bgr = np.take_along_axis(tab, order[np.clip(sector, 0, 5)].transpose(2, 0, 1)
                             .reshape(3, *sector.shape), axis=0)
    return _sat_u8(np.floor(bgr[::-1].transpose(1, 2, 0) * f32(255)))


# sRGB (D65) -> XYZ and back, and the D65 white point, OpenCV's constants
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535], [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]])
_WHITE = np.array([0.950456, 1.0, 1.088754])
_LAB_SHIFT, _GAMMA_SHIFT = 12, 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _srgb_to_linear(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _lab_tables():
    """OpenCV's 8-bit RGB -> LAB tables: sRGB gamma to 11 bits, the cube
    root (linear below 216/24389) to 15 bits, XYZ / white to 12 bits."""
    gamma = _round_half_even(255.0 * (1 << _GAMMA_SHIFT) * _srgb_to_linear(np.arange(256) / 255.0))
    x = np.arange(256 * 3 // 2 * (1 << _GAMMA_SHIFT)) / (255.0 * (1 << _GAMMA_SHIFT))
    cbrt = _round_half_even((1 << _LAB_SHIFT2) * np.where(
        x < 216.0 / 24389.0, x * (841.0 / 108.0) + 16.0 / 116.0, np.cbrt(x)))
    coeffs = _round_half_even((1 << _LAB_SHIFT) * _RGB2XYZ / _WHITE[:, None])
    return gamma, cbrt, coeffs


def rgb_to_lab(im: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(im, cv2.COLOR_RGB2LAB) on uint8 (L * 255 / 100, a + 128,
    b + 128) by OpenCV's integer tables: L equal on every colour, a and b
    on all but a few in 1e5 (a table entry rounded the other way)."""
    gamma, cbrt, c = _lab_tables()
    rgb = gamma[im[..., :3].astype(np.int64)]
    f = [cbrt[_descale(rgb @ c[i], _LAB_SHIFT)] for i in range(3)]
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    half = 128 * (1 << _LAB_SHIFT2)
    lab = [_descale(l_scale * f[1] + l_shift, _LAB_SHIFT2),
           _descale(500 * (f[0] - f[1]) + half, _LAB_SHIFT2),
           _descale(200 * (f[1] - f[2]) + half, _LAB_SHIFT2)]
    return _sat_u8(np.stack(lab, axis=-1))


def lab_to_rgb(im: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(im, cv2.COLOR_LAB2RGB) on uint8: OpenCV's formulas and
    XYZ -> sRGB constants in float32, the sRGB gamma in float64, rounded
    (OpenCV's integer tables: 97% of colours equal, all but 1 in 1e5
    within a level)."""
    f32 = np.float32
    lab = im.astype(f32)
    li = lab[..., 0] * f32(100.0 / 255.0)
    ai, bi = lab[..., 1] - f32(128), lab[..., 2] - f32(128)
    low = li <= 8
    fy_hi = (li + f32(16)) / f32(116)
    y = np.where(low, li / f32(903.3), fy_hi * fy_hi * fy_hi)
    fy = np.where(low, f32(7.787) * y + f32(16.0 / 116.0), fy_hi)
    inv = lambda v: np.where(v <= f32(6.0 / 29.0), (v - f32(16.0 / 116.0)) / f32(7.787),
                             v * v * v)
    x, z = inv(ai / f32(500) + fy), inv(fy - bi / f32(200))
    c = (_XYZ2RGB * _WHITE[None, :]).astype(f32)
    rgb = np.clip(np.stack([c[i, 0] * x + c[i, 1] * y + c[i, 2] * z for i in range(3)], -1),
                  0, 1).astype(np.float64)
    srgb = np.where(rgb <= 0.0031308, 12.92 * rgb, 1.055 * rgb ** (1 / 2.4) - 0.055)
    return _sat_u8(np.rint(srgb * 255.0))


def clahe(gray: np.ndarray, clip_limit: float, tiles: tuple[int, int] = (8, 8)) -> np.ndarray:
    """cv2.createCLAHE(clipLimit, tileGridSize=tiles).apply(gray) on a uint8
    plane: per tile a 256-bin histogram, clipped at clip_limit * area / 256
    with the excess spread evenly and its remainder stepped through the
    bins, its cumulative sum scaled to a lookup table; each pixel the
    bilinear blend (float32) of its four nearest tiles' tables."""
    tx, ty = tiles
    h, w = gray.shape
    src = gray
    if h % ty or w % tx:  # extended on to whole tiles, reflect-101
        src = copy_make_border_reflect101(gray, 0, (ty - h % ty) % ty, 0, (tx - w % tx) % tx)
    th, tw = src.shape[0] // ty, src.shape[1] // tx
    area = th * tw
    lut_scale = np.float32(255.0 / area)
    limit = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0
    luts = np.empty((ty, tx, 256), np.uint8)
    for i in range(ty):
        for j in range(tx):
            hist = np.bincount(src[i * th:(i + 1) * th, j * tw:(j + 1) * tw].ravel(),
                               minlength=256).astype(np.int64)
            if limit:
                clipped = int(np.maximum(hist - limit, 0).sum())
                hist = np.minimum(hist, limit) + clipped // 256
                residual = clipped % 256
                if residual:
                    step = max(256 // residual, 1)
                    hist[np.arange(0, 256, step)[:residual]] += 1
            luts[i, j] = _sat_u8(np.rint(np.cumsum(hist).astype(np.float32) * lut_scale))
    f32 = np.float32

    def axis(n, size, ntiles):
        t = np.arange(n, dtype=f32) * (f32(1) / f32(size)) - f32(0.5)
        t1 = np.floor(t).astype(np.int64)
        a = (t - t1.astype(f32)).astype(f32)
        return np.maximum(t1, 0), np.minimum(t1 + 1, ntiles - 1), a, (f32(1) - a)

    y1, y2, ya, ya1 = axis(h, th, ty)
    x1, x2, xa, xa1 = axis(w, tw, tx)
    v = gray.astype(np.int64)
    lut = luts.astype(f32)
    a11 = lut[y1[:, None], x1[None], v]
    a12 = lut[y1[:, None], x2[None], v]
    a21 = lut[y2[:, None], x1[None], v]
    a22 = lut[y2[:, None], x2[None], v]
    res = ((a11 * xa1 + a12 * xa) * ya1[:, None] + (a21 * xa1 + a22 * xa) * ya[:, None])
    return _sat_u8(np.rint(res.astype(f32)))


# ------------------------------------------------------------------ drawing

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _hline(img, y: int, x1: int, x2: int, value) -> None:
    h, w = img.shape[:2]
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = value


def _circle_filled(img, cx: int, cy: int, radius: int, value) -> None:
    """OpenCV's `Circle(..., fill=1)`: the midpoint walk, two spans a step."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            _hline(img, y, x1, x2, value)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _clip_line(w: int, h: int, p1: list, p2: list) -> bool:
    """cv::clipLine on 64-bit fixed-point coordinates, in place."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1)) if y2 != y1 else 0
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1)) if y2 != y1 else 0
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1)) if x2 != x1 else 0
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1)) if x2 != x1 else 0
                x2 = a
                c2 = 0
    p1[:], p2[:] = [x1, y1], [x2, y2]
    return (c1 | c2) == 0


def _line_fixed(img, p1: list, p2: list, value) -> None:
    """OpenCV's `Line2`: an 8-connected line between XY_SHIFT fixed-point ends."""
    h, w = img.shape[:2]
    p1, p2 = list(p1), list(p2)
    if not _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, p1, p2):
        return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if abs(dx) > abs(dy):
        if dx < 0:
            p1, p2 = p2, p1
            dy = -dy
        x_step, y_step = _XY_ONE, _tdiv(dy << _XY_SHIFT, abs(dx) | 1)
        ecount = (p2[0] - p1[0]) >> _XY_SHIFT
    else:
        if dy < 0:
            p1, p2 = p2, p1
            dx = -dx
        x_step, y_step = _tdiv(dx << _XY_SHIFT, abs(dy) | 1), _XY_ONE
        ecount = (p2[1] - p1[1]) >> _XY_SHIFT
    x, y = p1[0] + (_XY_ONE >> 1), p1[1] + (_XY_ONE >> 1)

    def put(px, py):
        if 0 <= px < w and 0 <= py < h:
            img[py, px] = value

    put((p2[0] + (_XY_ONE >> 1)) >> _XY_SHIFT, (p2[1] + (_XY_ONE >> 1)) >> _XY_SHIFT)
    if x_step == _XY_ONE:
        x >>= _XY_SHIFT
        for _ in range(ecount + 1):
            put(x, y >> _XY_SHIFT)
            x += 1
            y += y_step
    else:
        y >>= _XY_SHIFT
        for _ in range(ecount + 1):
            put(x >> _XY_SHIFT, y)
            x += x_step
            y += 1


def _fill_convex_poly(img, v: list, value) -> None:
    """OpenCV's `FillConvexPoly` for 8-connected drawing of XY_SHIFT
    fixed-point vertices: the outline, then the scanline fill between the
    two edge walks."""
    h, w = img.shape[:2]
    n = len(v)
    delta = _XY_ONE >> 1
    p0 = v[-1]
    imin, ymin, ymax = 0, v[0][1], v[0][1]
    xmin, xmax = v[0][0], v[0][0]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line_fixed(img, p0, p, value)
        p0 = p
    xmin, xmax = (xmin + delta) >> _XY_SHIFT, (xmax + delta) >> _XY_SHIFT
    ymin, ymax = (ymin + delta) >> _XY_SHIFT, (ymax + delta) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = [{"idx": imin, "di": 1, "x": -_XY_ONE, "dx": 0, "ye": ymin},
             {"idx": imin, "di": n - 1, "x": -_XY_ONE, "dx": 0, "ye": ymin}]
    remain = n
    y = ymin
    while True:
        for e in edges:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while remain > 0:
                    remain -= 1
                    ty = (v[idx][1] + delta) >> _XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e.update(ye=ty, x=xs, idx=idx,
                                 dx=_tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y)))
                        break
                    idx0, idx = idx, (idx + e["di"]) % n
        if remain < 0:
            break
        if y >= 0:
            left, right = sorted(edges, key=lambda e: e["x"])
            _hline(img, y, (left["x"] + delta) >> _XY_SHIFT, (right["x"] + delta) >> _XY_SHIFT,
                   value)
        for e in edges:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def line(img: np.ndarray, p0: tuple[int, int], p1: tuple[int, int], value, thickness: int
         ) -> None:
    """cv2.line(img, p0, p1, value, thickness) with thickness > 1 (LINE_8),
    in place: the body a convex quadrilateral at the ends offset by the
    rounded half-width normal (fixed point, XY_SHIFT 16), the caps filled
    circles of radius (thickness + 1) // 2."""
    if thickness <= 1:
        raise ValueError("line draws thick lines (thickness > 1)")
    a = [p0[0] << _XY_SHIFT, p0[1] << _XY_SHIFT]
    b = [p1[0] << _XY_SHIFT, p1[1] << _XY_SHIFT]
    dx, dy = (a[0] - b[0]) / _XY_ONE, (b[1] - a[1]) / _XY_ONE
    r = dx * dx + dy * dy
    half = thickness << (_XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (half + (thickness & 1) * _XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(img, [(a[0] + ox, a[1] + oy), (a[0] - ox, a[1] - oy),
                                (b[0] - ox, b[1] - oy), (b[0] + ox, b[1] + oy)], value)
    for c in (a, b):
        _circle_filled(img, (c[0] + (_XY_ONE >> 1)) >> _XY_SHIFT,
                       (c[1] + (_XY_ONE >> 1)) >> _XY_SHIFT,
                       (half + (_XY_ONE >> 1)) >> _XY_SHIFT, value)


def circle(img: np.ndarray, center: tuple[int, int], radius: int, value) -> None:
    """cv2.circle(img, center, radius, value, thickness=-1) (filled,
    LINE_8), in place."""
    _circle_filled(img, int(center[0]), int(center[1]), int(radius), value)
