"""Packed datasets: one flat file of blobs with a sorted key index (the
port's own copy of the JAX package's `data/packfile.py`).

The format (`RSPACK01`, little-endian) is the JAX package's, so a file
written by either package reads in the other:
  [0, 8) magic, [8, 16) u64 entry count, [16, 24) u64 index offset, then the
  blobs; at the index offset, per entry {u64 data_off, u64 data_len, u32
  key_off, u32 key_len}, then the keys' bytes, sorted ascending.

`PackReader` reads through the C++ mmap reader of `native/packfile.cpp`
(zero-copy views into the page cache, no per-file open or stat), compiled
with g++ into the ignored `_build/` at first use, or, where no compiler is
found, through the pure-Python mmap reader below: the same bytes either
way.  `native_available()` says whether the native reader loads.

Write with `PackWriter` or `python -m resshift_tpu_torch.scripts pack`.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import struct
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["PackWriter", "PackReader", "native_available"]

_MAGIC = b"RSPACK01"
_ENTRY = struct.Struct("<QQII")  # data_off, data_len, key_off, key_len

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "packfile.cpp"
_BUILD = _PKG / "_build"
_lock = threading.Lock()
_lib = None
_lib_tried = False


def _build_native() -> Path | None:
    """The reader's shared library, built once per source text: its name
    carries the source's hash, and it is written under a temporary name
    then renamed, so that a concurrent build never loads a partial file.
    None where g++ fails or is missing."""
    if not _SRC.is_file():
        return None
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    so = _BUILD / f"libpackfile-{digest}.so"
    if so.is_file():
        return so
    _BUILD.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_lib():
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so = _build_native()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.rspk_open.restype = ctypes.c_void_p
        lib.rspk_open.argtypes = [ctypes.c_char_p]
        lib.rspk_count.restype = ctypes.c_int64
        lib.rspk_count.argtypes = [ctypes.c_void_p]
        lib.rspk_find.restype = ctypes.c_int64
        lib.rspk_find.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.rspk_get.restype = ctypes.c_int
        lib.rspk_get.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                                 ctypes.POINTER(ctypes.c_uint64)]
        lib.rspk_key.restype = ctypes.c_int
        lib.rspk_key.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.POINTER(ctypes.c_uint32)]
        lib.rspk_prefetch.restype = ctypes.c_int
        lib.rspk_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.rspk_close.restype = None
        lib.rspk_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the C++ reader builds and loads here (else PackReader reads
    through Python's mmap)."""
    return _load_lib() is not None


class PackWriter:
    """Streaming writer; the keys are sorted into the index at close()."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.f = open(self.path, "wb")
        self.f.write(_MAGIC + b"\0" * 16)  # the count and the index offset, at close()
        self.entries: list[tuple[bytes, int, int]] = []  # key, offset, length

    def add(self, key: str, blob: bytes) -> None:
        off = self.f.tell()
        self.f.write(blob)
        self.entries.append((key.encode(), off, len(blob)))

    def add_file(self, key: str, file_path: str | Path) -> None:
        self.add(key, Path(file_path).read_bytes())

    def close(self) -> None:
        index_off = self.f.tell()
        self.entries.sort(key=lambda e: e[0])
        key_blob = bytearray()
        rows = []
        for key, off, ln in self.entries:
            rows.append((off, ln, len(key_blob), len(key)))
            key_blob += key
        for row in rows:
            self.f.write(_ENTRY.pack(*row))
        self.f.write(bytes(key_blob))
        self.f.seek(8)
        self.f.write(struct.pack("<QQ", len(self.entries), index_off))
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _NativeReader:
    def __init__(self, path: Path, lib):
        self.lib = lib
        self.h = lib.rspk_open(str(path).encode())
        if not self.h:
            raise OSError(f"cannot open pack file: {path}")

    def __len__(self):
        return int(self.lib.rspk_count(self.h))

    def find(self, key: str) -> int:
        kb = key.encode()
        return int(self.lib.rspk_find(self.h, kb, len(kb)))

    def get_index(self, idx: int) -> bytes:
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_uint64()
        if self.lib.rspk_get(self.h, idx, ctypes.byref(ptr), ctypes.byref(ln)):
            raise KeyError(idx)
        return ctypes.string_at(ptr, ln.value)

    def key(self, idx: int) -> str:
        ptr = ctypes.c_char_p()
        ln = ctypes.c_uint32()
        if self.lib.rspk_key(self.h, idx, ctypes.byref(ptr), ctypes.byref(ln)):
            raise KeyError(idx)
        return ctypes.string_at(ptr, ln.value).decode()

    def prefetch(self, idx: int) -> None:
        self.lib.rspk_prefetch(self.h, idx)

    def close(self):
        if self.h:
            self.lib.rspk_close(self.h)
            self.h = None


class _PyReader:
    """The same format through Python's mmap."""

    def __init__(self, path: Path):
        self.f = open(path, "rb")
        self.mm = mmap.mmap(self.f.fileno(), 0, access=mmap.ACCESS_READ)
        if self.mm[:8] != _MAGIC:
            self.close()
            raise OSError(f"bad pack magic in {path}")
        self.n, index_off = struct.unpack_from("<QQ", self.mm, 8)
        self.rows = list(_ENTRY.iter_unpack(self.mm[index_off:index_off + self.n * _ENTRY.size]))
        self.key_base = index_off + self.n * _ENTRY.size

    def __len__(self):
        return self.n

    def key(self, idx: int) -> str:
        _, _, koff, klen = self.rows[idx]
        return self.mm[self.key_base + koff:self.key_base + koff + klen].decode()

    def find(self, key: str) -> int:
        lo, hi = 0, self.n - 1
        kb = key.encode()
        while lo <= hi:
            mid = (lo + hi) // 2
            _, _, koff, klen = self.rows[mid]
            k = self.mm[self.key_base + koff:self.key_base + koff + klen]
            if k == kb:
                return mid
            if k < kb:
                lo = mid + 1
            else:
                hi = mid - 1
        return -1

    def get_index(self, idx: int) -> bytes:
        off, ln, _, _ = self.rows[idx]
        return self.mm[off:off + ln]

    def prefetch(self, idx: int) -> None:
        pass

    def close(self):
        self.mm.close()
        self.f.close()


class PackReader:
    """Key -> blob random access over a pack file: the native reader unless
    `native` is False or it is unavailable (`native=True` then raises);
    `self.native` says which.  A reader only reads, so a deep copy (a
    loader thread's copy of its dataset) shares it."""

    def __init__(self, path: str | Path, native: bool | None = None):
        path = Path(path)
        lib = _load_lib() if native in (None, True) else None
        if native is True and lib is None:
            raise RuntimeError("the native packfile reader is unavailable (g++ failed or "
                               "is missing)")
        self.impl = _NativeReader(path, lib) if lib else _PyReader(path)
        self.native = lib is not None

    def __len__(self):
        return len(self.impl)

    def keys(self) -> list[str]:
        return [self.impl.key(i) for i in range(len(self.impl))]

    def get(self, key: str) -> bytes:
        idx = self.impl.find(key)
        if idx < 0:
            raise KeyError(key)
        return self.impl.get_index(idx)

    def get_index(self, idx: int) -> bytes:
        return self.impl.get_index(idx)

    def key(self, idx: int) -> str:
        return self.impl.key(idx)

    def prefetch(self, idx: int) -> None:
        self.impl.prefetch(idx)

    def close(self):
        self.impl.close()

    def __deepcopy__(self, memo):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
