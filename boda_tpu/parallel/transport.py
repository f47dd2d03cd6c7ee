"""Byte-stream transports for the remote-execution (IPC) backend.

Capability parity with stream_util.{H,cc}: a minimal stream interface with
implementations over inherited fds (`fds:R:W`), named fifos
(`fns:to_worker:to_master`), and TCP (`tcp:host:port`, `tcp-listen:port`) —
the same address syntax family (stream_util.cc:43-95). Framing is
length-prefixed binary (u32 length + payload), as in the reference's
bwrite/bread wire convention.

The native C++ implementation (csrc/stream.cc) is used when built (feature
'cpp'); this Python implementation is the always-available fallback and
the reference for the wire format.
"""

from __future__ import annotations

import os
import socket
import struct
from typing import Optional

from ..core.error import RtErr

_LEN = struct.Struct("<I")


class Stream:
    """Framed byte stream: write_frame/read_frame over a pair of fds or a
    socket."""

    def __init__(self, rfd: Optional[int] = None, wfd: Optional[int] = None,
                 sock: Optional[socket.socket] = None):
        self.sock = sock
        self.rfd = rfd
        self.wfd = wfd

    # -- raw exact IO --
    def _write(self, b: bytes) -> None:
        if self.sock is not None:
            self.sock.sendall(b)
            return
        off = 0
        while off < len(b):
            off += os.write(self.wfd, b[off:])

    def _read(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            if self.sock is not None:
                chunk = self.sock.recv(n - len(out))
            else:
                chunk = os.read(self.rfd, n - len(out))
            if not chunk:
                raise RtErr("stream: EOF while reading")
            out += chunk
        return bytes(out)

    # -- framing --
    def write_frame(self, payload: bytes) -> None:
        self._write(_LEN.pack(len(payload)) + payload)

    def read_frame(self) -> bytes:
        (n,) = _LEN.unpack(self._read(4))
        return self._read(n)

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
        else:
            for fd in (self.rfd, self.wfd):
                if fd is not None:
                    try:
                        os.close(fd)
                    except OSError:
                        pass


def make_stream(addr: str, is_server: bool = False, impl: str = "auto"):
    """Open a stream by address string (reference syntax family):
    fds:R:W | fns:rfifo:wfifo | tcp:host:port | tcp-listen:port

    impl: 'auto' uses the native transport (csrc/stream.cc) when built,
    'py'/'cpp' force one side; the wire format is identical so mixed
    peers interoperate."""
    method, _, rest = addr.partition(":")
    if impl != "py" and method in ("fds", "fns", "tcp", "tcp-listen"):
        from ..utils.cpplib import CppStream, cpp_available
        if impl == "cpp" or (impl == "auto" and cpp_available()):
            return CppStream(addr, is_server=is_server)
    if method == "fds":
        r, w = rest.split(":")
        return Stream(rfd=int(r), wfd=int(w))
    if method == "fns":
        rfn, wfn = rest.split(":")
        # open order matters to avoid deadlock: server opens read first
        if is_server:
            rfd = os.open(rfn, os.O_RDONLY)
            wfd = os.open(wfn, os.O_WRONLY)
        else:
            wfd = os.open(wfn, os.O_WRONLY)
            rfd = os.open(rfn, os.O_RDONLY)
        return Stream(rfd=rfd, wfd=wfd)
    if method == "tcp":
        host, port = rest.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=30)
        # the 30s bound applies to connection establishment only; reads
        # must tolerate long server-side work (the server's first XLA
        # compile of a whole net can exceed 30s)
        s.settimeout(None)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return Stream(sock=s)
    if method == "tcp-listen":
        port = int(rest)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(1)
        conn, _ = srv.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        srv.close()
        return Stream(sock=conn)
    raise RtErr(f"make_stream: unknown transport method '{method}' in '{addr}'")
