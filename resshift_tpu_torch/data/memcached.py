"""A minimal memcached text-protocol client on stdlib sockets (the port's own
copy of the JAX package's `data/memcached.py`).

It speaks the standard ASCII protocol (`get` / `set`), so any stock
memcached daemon serves as a shared byte cache for dataset reads (the
reference's MemcachedBackend role, without its proprietary `mc` client).
Values above the daemon's item limit (1 MiB by default) fail to store;
callers treat that as a plain miss.  Keys longer than 250 bytes or holding
whitespace or control characters (illegal in the protocol) are replaced by
their SHA-256 hex digest.
"""

from __future__ import annotations

import hashlib
import socket

__all__ = ["MemcachedClient", "sanitize_key"]

_MAX_KEY = 250


def sanitize_key(key: str) -> str:
    """Return a protocol-legal key: itself if legal, else its sha256 hex."""
    kb = key.encode("utf-8", "surrogatepass")
    if len(kb) <= _MAX_KEY and all(0x21 <= b <= 0x7E for b in kb):
        return key
    return "sha256:" + hashlib.sha256(kb).hexdigest()


class MemcachedClient:
    """One-server client with a persistent socket and reconnect-on-error."""

    def __init__(self, server: str = "127.0.0.1:11211", timeout: float = 2.0):
        host, _, port = server.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        self.timeout = timeout
        self._sock: socket.socket | None = None

    # a socket cannot be copied; the loader's threads deep-copy their
    # dataset, so a copy starts disconnected and dials at its first use
    def __getstate__(self):
        return {"addr": self.addr, "timeout": self.timeout}

    def __setstate__(self, state):
        self.addr = state["addr"]
        self.timeout = state["timeout"]
        self._sock = None

    # -- connection ---------------------------------------------------------
    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self.addr, timeout=self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            self._buf = b""
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _drop(self) -> None:
        self.close()

    def _read_line(self, s: socket.socket) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError("memcached closed connection")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, s: socket.socket, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError("memcached closed connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    # -- verbs --------------------------------------------------------------
    def get(self, key: str) -> bytes | None:
        """Fetch ``key``; None on miss or any connection/protocol error."""
        key = sanitize_key(key)
        try:
            s = self._connect()
            s.sendall(b"get " + key.encode() + b"\r\n")
            line = self._read_line(s)
            if line == b"END":
                return None
            if not line.startswith(b"VALUE "):
                raise ConnectionError(f"unexpected reply: {line[:64]!r}")
            nbytes = int(line.split()[3])
            data = self._read_exact(s, nbytes)
            self._read_exact(s, 2)            # trailing \r\n
            if self._read_line(s) != b"END":
                raise ConnectionError("missing END after VALUE block")
            return data
        except (OSError, ValueError, IndexError, ConnectionError):
            self._drop()
            return None

    def set(self, key: str, value: bytes, exptime: int = 0) -> bool:
        """Store ``key``; False on over-limit values or connection errors."""
        key = sanitize_key(key)
        try:
            s = self._connect()
            hdr = f"set {key} 0 {exptime} {len(value)}\r\n".encode()
            s.sendall(hdr + value + b"\r\n")
            reply = self._read_line(s)
            if reply == b"STORED":
                return True
            if reply.startswith((b"SERVER_ERROR", b"NOT_STORED", b"ERROR",
                                 b"CLIENT_ERROR")):
                # over-limit / rejected items: a miss, not a failure.  The
                # daemon may additionally close the connection on protocol
                # complaints; drop ours so the next verb reconnects clean.
                self._drop()
                return False
            raise ConnectionError(f"unexpected reply: {reply[:64]!r}")
        except (OSError, ConnectionError):
            self._drop()
            return False
