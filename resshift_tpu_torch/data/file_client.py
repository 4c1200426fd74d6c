"""Where a dataset's bytes come from (the port's own copy of the JAX
package's `data/file_client.py`):
  * 'disk': the file system;
  * 'pack': a packed file (`packfile.PackReader`), keys as they were packed;
  * 'memcached': a memcached daemon in front of the disk (`memcached.py`),
    read through: a miss reads the file and stores it, so a cold daemon
    works (values over its item limit stay uncached).
`imread` decodes as `utils.image_io.imread` does (`imdecode`: PNG without
OpenCV).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.image_io import imdecode
from .packfile import PackReader

__all__ = ["FileClient"]


class FileClient:
    def __init__(self, backend: str = "disk", pack_path: str | Path | None = None,
                 server: str = "127.0.0.1:11211"):
        if backend not in ("disk", "pack", "memcached"):
            raise ValueError(f"unknown FileClient backend: {backend!r} "
                             "(supported: disk, pack, memcached)")
        self.backend = backend
        self.pack = PackReader(pack_path) if backend == "pack" else None
        self.cache = None
        if backend == "memcached":
            from .memcached import MemcachedClient

            self.cache = MemcachedClient(server)

    def keys(self) -> list[str]:
        if self.pack is None:
            raise ValueError("keys() needs the pack backend")
        return self.pack.keys()

    def get(self, key: str | Path) -> bytes:
        if self.pack is not None:
            return self.pack.get(str(key))
        if self.cache is not None:
            hit = self.cache.get(str(key))
            if hit is not None:
                return hit
            data = Path(key).read_bytes()
            self.cache.set(str(key), data)  # a refused value is a later miss
            return data
        return Path(key).read_bytes()

    def imread(self, key: str | Path, chn: str = "rgb", dtype: str = "float32") -> np.ndarray:
        """The image at `key` -> HWC RGB (or HW gray), in [0, 1] if float."""
        return imdecode(self.get(key), chn, dtype, name=str(key))
