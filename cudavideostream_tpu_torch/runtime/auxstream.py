"""Live aux (visualizer) frame streaming (the counterpart of the JAX
package's ``runtime/auxstream.py``, the same wire format).

The reference gives DISPLAYING the visualizer frame its own thread and
pipe: ``writeNoise`` hands the aux frame to ``th_noise_hdl``, which
``imshow``s it (``threads.cpp:149-164``, fed from ``server.cpp:143``).
Here, headless, display becomes a second serving surface: a raw TCP side
stream that the client (``--aux``) and the ``--http`` viewer attach to.

Wire format (little-endian, like the main wire):

* header: ``b"CVSX"`` + u32 height + u32 width;
* per frame: u32 frame index + u32 payload length + payload (``h*w*3``
  raw BGR24 bytes; the length keeps the framing self-describing).

Unlike the reference's blocking pipe write (``threads.cpp:130-132``), the
sink is latest-frame-wins by default: a slow viewer drops frames and never
holds back the delta stream. ``drop=False`` hands over every frame, for
tests.

Every socket and thread here has a timeout: the accept loop polls its
closing flag, each viewer's sends give up after ``SEND_TIMEOUT_S``
seconds (the viewer is then dropped), and the client's reads after its
``timeout``.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

import numpy as np

MAGIC = b"CVSX"
_HDR = struct.Struct("<4sII")
_FRM = struct.Struct("<II")
# how often a waiting thread looks at its closing flag, seconds
_POLL_S = 0.2
# how long one frame's send to a viewer may take before it is dropped
SEND_TIMEOUT_S = 10.0


class AuxStreamSink:
    """Serve aux frames to any number of attached viewers.

    One daemon accept thread; one daemon send thread per viewer with a
    one-deep latest-wins mailbox (``drop=True``) or a handoff that waits
    for the previous frame to go (``drop=False``). :meth:`push` never
    raises on a viewer's failure: a dead viewer is detached."""

    def __init__(self, height: int, width: int, host: str = "127.0.0.1",
                 port: int = 0, drop: bool = True):
        self.height = height
        self.width = width
        self.drop = drop
        self._clients: list["_AuxClientState"] = []
        self._lock = threading.Lock()
        self._closed = False
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(8)
        srv.settimeout(_POLL_S)
        self._sock = srv
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="aux-accept", daemon=True)
        self._accept_thread.start()

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                conn.settimeout(SEND_TIMEOUT_S)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.sendall(_HDR.pack(MAGIC, self.height, self.width))
            except OSError:
                conn.close()
                continue
            st = _AuxClientState(conn, self.drop)
            with self._lock:
                if self._closed:
                    st.stop()
                    return
                self._clients.append(st)

    def push(self, idx: int, aux) -> None:
        """Offer one aux frame (a flat uint8 array) to every viewer."""
        if self._closed:
            return
        with self._lock:
            for c in [c for c in self._clients if c.dead]:
                self._clients.remove(c)
            clients = list(self._clients)
        if not clients:
            return
        buf = np.ascontiguousarray(aux, dtype=np.uint8).tobytes()
        for c in clients:
            c.offer(idx, buf)

    @property
    def n_clients(self) -> int:
        with self._lock:
            return sum(not c.dead for c in self._clients)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=5.0)
        with self._lock:
            clients, self._clients = self._clients, []
        for c in clients:
            c.stop()


class _AuxClientState:
    def __init__(self, conn: socket.socket, drop: bool):
        self.conn = conn
        self.drop = drop
        self.dead = False
        self._cv = threading.Condition()
        self._pending: Optional[tuple] = None
        self._thread = threading.Thread(target=self._send_loop,
                                        name="aux-send", daemon=True)
        self._thread.start()

    def offer(self, idx: int, buf: bytes) -> None:
        with self._cv:
            if not self.drop:
                # the previous frame goes first; a viewer whose send
                # times out is dead and ends the wait
                while self._pending is not None and not self.dead:
                    self._cv.wait(timeout=_POLL_S)
            if self.dead:
                return
            self._pending = (idx, buf)  # under drop: the latest wins
            self._cv.notify_all()

    def _send_loop(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self.dead:
                    self._cv.wait(timeout=_POLL_S)
                if self.dead:
                    return
                idx, buf = self._pending
                self._pending = None
                self._cv.notify_all()
            try:
                self.conn.sendall(_FRM.pack(idx, len(buf)) + buf)
            except OSError:  # the socket's timeout included
                self.stop()
                return

    def stop(self) -> None:
        with self._cv:
            self.dead = True
            self._pending = None
            self._cv.notify_all()
        try:
            self.conn.close()
        except OSError:
            pass


class AuxStreamClient:
    """Attach to an :class:`AuxStreamSink` (of either package) and read
    its aux frames; each read waits at most ``timeout`` seconds."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self.height = 0
        self.width = 0

    def connect(self) -> None:
        self.sock = socket.create_connection((self.host, self.port),
                                             timeout=self.timeout)
        magic, h, w = _HDR.unpack(self._read_exact(_HDR.size))
        if magic != MAGIC:
            raise ValueError(f"not an aux stream (magic {magic!r})")
        self.height, self.width = h, w

    def _read_exact(self, n: int) -> bytes:
        chunks = []
        while n > 0:
            b = self.sock.recv(min(n, 1 << 16))
            if not b:
                raise ConnectionError("aux stream closed")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def read_frame(self) -> tuple:
        """The next aux frame: ``(idx, flat uint8 array)``."""
        idx, length = _FRM.unpack(self._read_exact(_FRM.size))
        buf = self._read_exact(length)
        return idx, np.frombuffer(buf, dtype=np.uint8)

    def close(self) -> None:
        if self.sock:
            self.sock.close()
            self.sock = None
