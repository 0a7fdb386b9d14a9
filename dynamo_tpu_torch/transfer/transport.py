"""Rendezvous message transport: native (C++) with pure-Python fallback.

The port's copy of `dynamo_tpu/transfer/transport.py`; the two packages'
ends talk to each other (tests/test_torch_disagg_wire.py).

Wire format (shared by both implementations, and by both packages):
  handshake: u32 BE magic 0x44594E4D ("DYNM") + 64-byte NUL-padded key
  messages:  u64 BE length + payload

The rendezvous shape mirrors the reference's NIXL bootstrap contract — the
decode side dials the prefill side's `--disaggregation-bootstrap-port` and
identifies the transfer by key
(reference examples/deploy/sglang/disagg.yaml:47-52).
"""

from __future__ import annotations

import ctypes
import socket
import struct
from typing import Optional, Tuple

from dynamo_tpu_torch.runtime.native import get_lib

MAGIC = 0x44594E4D
KEY_LEN = 64
HANDSHAKE_TIMEOUT_S = 10.0


class Connection:
    """One established transfer connection (either side)."""

    def __init__(self, fd: Optional[int] = None, sock: Optional[socket.socket] = None):
        self._fd = fd
        self._sock = sock
        self._lib = get_lib() if fd is not None else None

    # ------------------------------------------------------------- sending --
    def send_msg(self, data) -> None:
        data = bytes(data) if not isinstance(data, (bytes, bytearray, memoryview)) else data
        if self._fd is not None:
            buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
            if self._lib.dt_send_msg(self._fd, buf, len(data)) != 0:
                raise ConnectionError("native send failed")
        else:
            self._sock.sendall(struct.pack(">Q", len(data)))
            self._sock.sendall(data)

    def recv_msg(self, max_len: int = 1 << 34) -> bytes:
        if self._fd is not None:
            n = self._lib.dt_recv_len(self._fd)
            if n < 0 or n > max_len:
                raise ConnectionError(f"native recv failed (len={n})")
            buf = ctypes.create_string_buffer(n)
            if self._lib.dt_recv_into(self._fd, buf, n) != 0:
                raise ConnectionError("native recv payload failed")
            return buf.raw
        else:
            hdr = self._recv_exact(8)
            (n,) = struct.unpack(">Q", hdr)
            if n > max_len:
                raise ConnectionError(f"message too large: {n}")
            return self._recv_exact(n)

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n > 0:
            c = self._sock.recv(min(n, 1 << 20))
            if not c:
                raise ConnectionError("peer closed")
            chunks.append(c)
            n -= len(c)
        return b"".join(chunks)

    def close(self):
        if self._fd is not None:
            get_lib().dt_close(self._fd)
            self._fd = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class Listener:
    """Bootstrap listener (prefill-worker side)."""

    def __init__(self, port: int = 0, prefer_native: bool = True):
        self._lib = get_lib() if prefer_native else None
        if self._lib is not None:
            port_out = ctypes.c_uint16(0)
            fd = self._lib.dt_listen(port, ctypes.byref(port_out))
            if fd < 0:
                raise OSError(f"dt_listen({port}) failed")
            self._fd = fd
            self._sock = None
            self.port = port_out.value
        else:
            self._fd = None
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("0.0.0.0", port))
            s.listen(64)
            self._sock = s
            self.port = s.getsockname()[1]

    def accept(self, timeout_ms: int = -1) -> Tuple[Connection, str]:
        """Accept one transfer connection; returns (conn, rendezvous_key)."""
        if self._fd is not None:
            keybuf = ctypes.create_string_buffer(KEY_LEN + 1)
            fd = self._lib.dt_accept(self._fd, keybuf, timeout_ms)
            if fd == -2:
                raise TimeoutError("accept timed out")
            if fd < 0:
                raise ConnectionError("accept failed")
            return Connection(fd=fd), keybuf.value.decode(errors="replace")
        else:
            self._sock.settimeout(timeout_ms / 1000 if timeout_ms >= 0 else None)
            try:
                s, _ = self._sock.accept()
            except socket.timeout:
                raise TimeoutError("accept timed out")
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # bound the handshake so a silent dialer can't wedge the accept
            # loop; cleared once the peer has identified itself
            s.settimeout(HANDSHAKE_TIMEOUT_S)
            try:
                hdr = s.recv(4, socket.MSG_WAITALL)
                if len(hdr) != 4 or struct.unpack(">I", hdr)[0] != MAGIC:
                    raise ConnectionError("bad handshake magic")
                key = s.recv(KEY_LEN, socket.MSG_WAITALL)
                if len(key) != KEY_LEN:
                    raise ConnectionError("short handshake key")
            except socket.timeout:
                s.close()
                raise ConnectionError("handshake timed out")
            except ConnectionError:
                s.close()
                raise
            s.settimeout(None)
            return Connection(sock=s), key.rstrip(b"\x00").decode(errors="replace")

    def close(self):
        if self._fd is not None:
            get_lib().dt_close(self._fd)
            self._fd = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None


def connect(host: str, port: int, key: str,
            prefer_native: bool = True) -> Connection:
    lib = get_lib() if prefer_native else None
    if lib is not None:
        fd = lib.dt_connect(host.encode(), port, key.encode()[: KEY_LEN - 1])
        if fd < 0:
            raise ConnectionError(f"dt_connect({host}:{port}) failed")
        return Connection(fd=fd)
    s = socket.create_connection((host, port), timeout=30)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    s.settimeout(None)
    keyb = key.encode()[:KEY_LEN].ljust(KEY_LEN, b"\x00")
    s.sendall(struct.pack(">I", MAGIC) + keyb)
    return Connection(sock=s)
