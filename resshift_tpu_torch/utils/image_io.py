"""Image files <-> arrays on the host (the port's own copy).

The semantics of the JAX package's `utils/image_io.py`: `imread` gives HWC
RGB (or HW gray), float32 in [0, 1] by default (values divided by 255,
16-bit files included, as there); `imwrite` takes RGB HWC in [0, 1] or
uint8; `to_model` / `from_model` map to and from NHWC [-1, 1] model tensors.

OpenCV (`cv2`) reads and writes where it is installed, imported at the first
call.  Where it is not, PNG files go through the codec below, built on
`zlib` and numpy: it reads 8- and 16-bit gray, gray+alpha, RGB and RGBA,
non-interlaced, with filters 0-4, and writes 8- or 16-bit with filter 0.
Any other file then raises an error that names the missing package.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ["IM_EXTS", "imread", "imdecode", "imwrite", "list_images", "to_model", "from_model",
           "make_grid", "png_decode", "png_encode"]

IM_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".JPEG", ".PNG", ".JPG")
_NO_CV2 = "needs OpenCV (the cv2 module of opencv-python), which is not installed"


def _cv2():
    """The cv2 module, or None where OpenCV is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


# --------------------------------------------------------------- PNG codec

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> channels
_CTYPE = {c: t for t, c in _CHANNELS.items()}


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 255


def _average_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prev[i]) >> 1)) & 255


def png_decode(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> (H, W) or (H, W, ch) uint8 / uint16, channels
    in the file's order (gray, gray+alpha, RGB, RGBA)."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, hdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG file without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"PNG of colour type {ctype}, depth {depth}, interlace {interlace}: "
                         f"reading it {_NO_CV2}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError("truncated PNG data")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f = raw[y * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1)
        if f == 0:
            cur = line
        elif f == 1:  # Sub: a running sum over the pixels of the row
            cur = (np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.int64) & 255)
            cur = cur.astype(np.uint8).reshape(-1)
        elif f == 2:  # Up
            cur = line + prev
        elif f in (3, 4):  # Average, Paeth: each byte needs the one before
            buf = bytearray(line.tobytes())
            (_average_row if f == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {f}")
        out[y] = cur
        prev = out[y]
    im = out.reshape(h, w, bpp)
    if depth == 16:
        im = im.view(">u2").astype(np.uint16)
    return im[..., 0] if ch == 1 else im


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def png_encode(im: np.ndarray) -> bytes:
    """(H, W) or (H, W, 1..4) uint8 / uint16 -> PNG bytes (channels in the
    file's order: gray, gray+alpha, RGB, RGBA)."""
    im = np.asarray(im)
    if im.ndim == 2:
        im = im[..., None]
    if im.ndim != 3 or im.shape[2] not in _CTYPE or im.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"png_encode takes (H, W[, 1-4]) uint8 or uint16, not "
                         f"{im.shape} {im.dtype}")
    h, w, ch = im.shape
    depth = 8 if im.dtype == np.uint8 else 16
    rows = np.ascontiguousarray(im.astype(">u2") if depth == 16 else im).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.view(np.uint8)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _CTYPE[ch], 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _gray(rgb: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma of integer RGB with 14-bit fixed-point weights
    (OpenCV 4's rule; OpenCV 5 may differ by one level at ties)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(rgb.dtype)


# -------------------------------------------------------------- the API

def _cv2_channels(cv2, im: np.ndarray, chn: str) -> np.ndarray:
    """An image as OpenCV decodes it (BGR, BGRA or gray) -> RGB or gray."""
    if chn == "rgb":
        if im.ndim == 2:
            return cv2.cvtColor(im, cv2.COLOR_GRAY2RGB)
        return cv2.cvtColor(im[..., :3], cv2.COLOR_BGR2RGB)
    if chn == "gray" and im.ndim == 3:
        return cv2.cvtColor(im[..., :3], cv2.COLOR_BGR2GRAY)
    return im


def _png_channels(im: np.ndarray, chn: str) -> np.ndarray:
    """A decoded PNG (gray, gray+alpha, RGB, RGBA) -> RGB or gray, as cv2's
    colour or gray read gives it."""
    if im.ndim == 3 and im.shape[2] == 2:
        im = im[..., 0]  # gray + alpha: the alpha is dropped, as cv2 does
    if chn == "rgb":
        return np.repeat(im[..., None], 3, axis=2) if im.ndim == 2 else im[..., :3]
    if chn == "gray" and im.ndim == 3:
        return _gray(im[..., :3])
    return im


def _read_raw(path: Path, chn: str) -> np.ndarray:
    """HWC RGB / HW gray in the file's integer type."""
    cv2 = _cv2()
    if cv2 is not None:
        im = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if im is None:
            raise FileNotFoundError(f"cannot read image: {path}")
        return _cv2_channels(cv2, im, chn)
    if path.suffix.lower() != ".png":
        raise RuntimeError(f"reading {path.suffix} files {_NO_CV2}; PNG files need none")
    if not path.is_file():
        raise FileNotFoundError(f"cannot read image: {path}")
    return _png_channels(png_decode(path.read_bytes()), chn)


def _float(im: np.ndarray, dtype: str) -> np.ndarray:
    return im.astype(dtype) / 255.0 if dtype.startswith("float") else im


def imread(path: str | Path, chn: str = "rgb", dtype: str = "float32") -> np.ndarray:
    """Read an image -> HWC RGB (or HW for chn='gray'), in [0, 1] if float."""
    return _float(_read_raw(Path(path), chn), dtype)


def imdecode(data: bytes, chn: str = "rgb", dtype: str = "float32",
             name: str = "") -> np.ndarray:
    """`imread` of a file's bytes (a packed or cached blob; `name` for the
    errors): PNG through the codec above where OpenCV is missing."""
    cv2 = _cv2()
    if cv2 is not None:
        im = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        if im is None:
            raise ValueError(f"cannot decode image: {name}")
        return _float(_cv2_channels(cv2, im, chn), dtype)
    if data[:8] != _SIG:
        raise RuntimeError(f"decoding {name or 'a file'} other than PNG {_NO_CV2}; PNG files "
                           f"need none")
    return _float(_png_channels(png_decode(data), chn), dtype)


def imwrite(im: np.ndarray, path: str | Path, qf: int = 95) -> None:
    """Write an RGB HWC (or HW gray) image, [0, 1] float or uint8, as PNG
    (or JPEG with quality `qf`, which needs cv2)."""
    path = Path(path)
    if im.dtype != np.uint8:
        im = np.clip(np.round(np.clip(im, 0, 1) * 255.0), 0, 255).astype(np.uint8)
    cv2 = _cv2()
    if cv2 is None:
        if path.suffix.lower() != ".png":
            raise RuntimeError(f"writing {path.suffix} files {_NO_CV2}; PNG files need none")
        path.write_bytes(png_encode(im))
        return
    if im.ndim == 3:
        im = cv2.cvtColor(im, cv2.COLOR_RGB2BGR)
    flag = [int(cv2.IMWRITE_JPEG_QUALITY), qf] if path.suffix.lower() in (".jpg", ".jpeg") else []
    if not cv2.imwrite(str(path), im, flag):
        raise IOError(f"cannot write image: {path}")


def list_images(path: str | Path, recursive: bool = True) -> list[Path]:
    p = Path(path)
    it = p.rglob("*") if recursive else p.glob("*")
    return sorted(x for x in it if x.suffix in IM_EXTS)


def to_model(im: np.ndarray) -> np.ndarray:
    """HWC [0, 1] -> 1HWC [-1, 1] float32."""
    x = (im.astype(np.float32) - 0.5) / 0.5
    if x.ndim == 2:
        x = x[..., None]
    return x[None]


def from_model(x: np.ndarray) -> np.ndarray:
    """NHWC [-1, 1] -> NHWC [0, 1]."""
    return np.clip(np.asarray(x, dtype=np.float32) * 0.5 + 0.5, 0.0, 1.0)


def make_grid(ims: np.ndarray, ncol: int = 8, pad: int = 2) -> np.ndarray:
    """A batch NHWC in [0, 1] tiled into one HWC image, `ncol` to a row,
    `pad` white pixels between and around the tiles."""
    ims = np.asarray(ims, np.float32)
    n, h, w, c = ims.shape
    ncol = min(ncol, n)
    nrow = (n + ncol - 1) // ncol
    grid = np.ones((nrow * (h + pad) + pad, ncol * (w + pad) + pad, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0, x0 = pad + r * (h + pad), pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = ims[i]
    return grid
