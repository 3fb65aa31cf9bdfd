"""The TCP wire format v1 — the byte-exact compatibility contract.

A copy of the v1 subset of the JAX package's ``runtime/wire.py``. Layout
(little-endian, no framing, no checksum), exactly what the reference
server writes (``server/src/threads.cpp:224-231``) and the reference
client reads (``client/opencv.cpp:39-66``):

* On connect: the raw base frame, ``H*W*3`` bytes of BGR24.
* Per frame: ``[u32 pos][i32 xs[pos]][u8 vals[pos]]``.

The client applies ``frame[xs[i]] += vals[i]`` with uint8 wraparound and
is insensitive to payload order. Wire v2, v3 and v4 are not ported yet
(``ROADMAP.md`` M7, M8, M18).
"""

from __future__ import annotations

import socket
import struct
from typing import Tuple

import numpy as np

_U32 = struct.Struct("<I")


def pack_payload(pos: int, xs: np.ndarray, vals: np.ndarray) -> bytes:
    """Serialize one frame delta to wire bytes."""
    xs = np.ascontiguousarray(np.asarray(xs, dtype="<i4")[:pos])
    vals = np.ascontiguousarray(np.asarray(vals, dtype=np.uint8)[:pos])
    return _U32.pack(pos) + xs.tobytes() + vals.tobytes()


def unpack_payload(buf: bytes) -> Tuple[int, np.ndarray, np.ndarray, int]:
    """Parse one frame delta from ``buf``.

    Returns ``(pos, xs, vals, consumed_bytes)``; raises ``ValueError`` on a
    short buffer (streams should use :func:`read_payload` instead).
    """
    if len(buf) < 4:
        raise ValueError("short buffer: header")
    (pos,) = _U32.unpack_from(buf, 0)
    need = 4 + pos * 5
    if len(buf) < need:
        raise ValueError("short buffer: body")
    xs = np.frombuffer(buf, dtype="<i4", count=pos, offset=4).copy()
    vals = np.frombuffer(buf, dtype=np.uint8, count=pos, offset=4 + pos * 4).copy()
    return pos, xs, vals, need


def read_exact(sock: socket.socket, n: int) -> bytes:
    """Short-read-safe blocking read of exactly ``n`` bytes
    (the loop the reference client runs, ``client/opencv.cpp:40-42``)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _reader(src):
    """Normalize a frame-read source: a socket, or a ``read(n)->bytes``
    callable."""
    return src if callable(src) else (lambda n: read_exact(src, n))


def read_payload(src) -> Tuple[int, np.ndarray, np.ndarray]:
    """Blocking read of one frame delta (socket or ``read(n)``)."""
    rd = _reader(src)
    (pos,) = _U32.unpack(rd(4))
    xs = np.frombuffer(rd(pos * 4), dtype="<i4").copy()
    vals = np.frombuffer(rd(pos), dtype=np.uint8).copy()
    return pos, xs, vals


def read_base_frame(src, n_bytes: int) -> np.ndarray:
    return np.frombuffer(_reader(src)(n_bytes), dtype=np.uint8).copy()
