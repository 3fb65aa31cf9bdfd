"""The TCP wire formats v1, v2 and v3 — the byte-exact compatibility
contract.

A copy of the v1-v3 subset of the JAX package's ``runtime/wire.py`` (its
numpy paths: the JAX package's native encoder is a byte-identical fast
path, ``ROADMAP.md`` M18). Little-endian, no framing, no checksum.

**v1 (default)**, exactly what the reference server writes
(``server/src/threads.cpp:224-231``) and the reference client reads
(``client/opencv.cpp:39-66``):

* On connect: the raw base frame, ``H*W*3`` bytes of BGR24.
* Per frame: ``[u32 pos][i32 xs[pos]][u8 vals[pos]]``.

The client applies ``frame[xs[i]] += vals[i]`` with uint8 wraparound and
is insensitive to payload order.

**v2 "delta16"** (both ends opt in): on connect :data:`MAGIC_V2`, then
the base frame; per frame ``[u32 pos][u32 n_exc][u16 gap[pos]]
[u32 exc[n_exc]][u8 vals[pos]]`` with ``xs[i] = xs[i-1] + gap[i]``
(``xs[-1] = -1``); a gap of ``0xFFFF`` takes the next absolute index from
the exception stream.

**v3 "adaptive"**: on connect :data:`MAGIC_V3`, then the base frame; per
frame one mode byte and the cheapest body of three, by exact size (ties
go to the first listed): mode 0 the v2 body; mode 1 ``[u32 pos]
[u8 bitmask[ceil(n/8)]][u8 vals[pos]]`` (LSB-first change bits); mode 2
the raw reconstructed frame, which is also how a server resyncs a client
after a payload-capacity overflow. v4 (mode 3, the window bitmask) is not
ported yet (``ROADMAP.md`` M8).
"""

from __future__ import annotations

import dataclasses
import socket
import struct
from typing import Tuple

import numpy as np

_U32 = struct.Struct("<I")
_2U32 = struct.Struct("<II")

# stream prefixes of the opt-in formats (16 bytes each); v4's is known so
# that a client can name what it cannot decode
MAGIC_V2 = b"CVSTPU-WIRE-V2\x00\x01"
MAGIC_V3 = b"CVSTPU-WIRE-V3\x00\x01"
MAGIC_V4 = b"CVSTPU-WIRE-V4\x00\x01"
_GAP_ESC = 0xFFFF

# v3 per-frame mode prefix (one byte)
MODE_DELTA16 = 0
MODE_BITMASK = 1
MODE_RAW = 2


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


# -- tiled payloads --------------------------------------------------------

def prefix_slots(counts: np.ndarray, unit_bytes: int) -> np.ndarray:
    """Flat positions, in order, of the first ``counts[t]`` slots of each
    unit ``t`` of ``unit_bytes`` slots: entry ``k`` of unit ``t`` is at
    ``t * unit_bytes + k``. O(units + entries)."""
    c = np.asarray(counts, dtype=np.int64)
    total = int(c.sum())
    start = np.arange(c.size, dtype=np.int64) * unit_bytes - (np.cumsum(c) - c)
    return np.repeat(start, c) + np.arange(total, dtype=np.int64)


@dataclasses.dataclass
class TiledPayload:
    """One frame delta as the kernel's per-unit compacted blocks.

    Unit ``t`` holds ``counts[t]`` valid entries at ``xs[t, :counts[t]]``
    / ``vals[t, :counts[t]]``; global ascending order is unit order, and
    the wire bytes are those of the flat payload. ``xs``/``vals`` may
    hold fewer units than ``counts`` describes only if the extra counts
    are zero (executors drop all-empty units at either end).
    """

    pos: int
    counts: np.ndarray  # (n_units,) uint8, int16 or int32
    xs: np.ndarray      # (n_units, unit_bytes) int32, global indices
    vals: np.ndarray    # (n_units, unit_bytes) uint8

    def to_flat(self) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenate the units' prefixes into flat ``(xs, vals)`` host
        arrays: one gather of the ``sum(counts)`` entries (the JAX
        package's ``to_flat`` loops over units in Python, tens of ms at
        48,608 units; the arrays are the same)."""
        rows, cap = self.xs.shape
        slots = prefix_slots(self.counts[:rows], cap)
        if slots.size == 0:
            return (np.empty(0, np.int32), np.empty(0, np.uint8))
        return self.xs.reshape(-1)[slots], self.vals.reshape(-1)[slots]

    def to_wire_bytes(self) -> bytes:
        """The v1 bytes of this payload."""
        xs, vals = self.to_flat()
        return pack_payload(self.pos, xs, vals)


# -- v2 (delta16) ---------------------------------------------------------

def pack_payload_v2(pos: int, xs: np.ndarray, vals: np.ndarray) -> bytes:
    """Serialize one frame delta as delta16 wire bytes (ascending xs)."""
    xs = np.asarray(xs, dtype=np.int64)[:pos]
    vals = np.ascontiguousarray(np.asarray(vals, dtype=np.uint8)[:pos])
    gaps = np.diff(xs, prepend=-1)
    esc = gaps >= _GAP_ESC
    g16 = np.where(esc, _GAP_ESC, gaps).astype("<u2")
    exc = xs[esc].astype("<u4")
    return (
        _2U32.pack(pos, int(exc.size))
        + g16.tobytes()
        + exc.tobytes()
        + vals.tobytes()
    )


def unpack_payload_v2(buf: bytes, offset: int = 0):
    """Parse one delta16 frame. Returns ``(pos, xs, vals, consumed)``."""
    if len(buf) - offset < 8:
        raise ValueError("short buffer: v2 header")
    pos, n_exc = _2U32.unpack_from(buf, offset)
    need = 8 + 2 * pos + 4 * n_exc + pos
    if len(buf) - offset < need:
        raise ValueError("short buffer: v2 body")
    o = offset + 8
    gaps = np.frombuffer(buf, dtype="<u2", count=pos, offset=o).astype(np.int64)
    o += 2 * pos
    exc = np.frombuffer(buf, dtype="<u4", count=n_exc, offset=o)
    o += 4 * n_exc
    vals = np.frombuffer(buf, dtype=np.uint8, count=pos, offset=o).copy()
    return pos, decode_gaps(gaps, exc), vals, need


def decode_gaps(gaps: np.ndarray, exc: np.ndarray) -> np.ndarray:
    """Reconstruct ascending xs from u16 gaps + absolute exceptions: an
    escape gap sets ``xs[i] = exc[k]`` outright; the other gaps cumsum."""
    g = np.asarray(gaps, dtype=np.int64).copy()
    idx = np.nonzero(g == _GAP_ESC)[0]
    g[idx] = 0
    xs = np.cumsum(g) - 1
    for k, i in enumerate(idx):
        xs[i:] += int(exc[k]) - xs[i]
    return xs.astype(np.int32)


def read_payload_v2(src) -> Tuple[int, np.ndarray, np.ndarray]:
    """Blocking read of one delta16 frame (socket or ``read(n)``)."""
    rd = _reader(src)
    pos, n_exc = _2U32.unpack(rd(8))
    gaps = np.frombuffer(rd(2 * pos), dtype="<u2")
    exc = np.frombuffer(rd(4 * n_exc), dtype="<u4")
    vals = np.frombuffer(rd(pos), dtype=np.uint8).copy()
    return pos, decode_gaps(gaps, exc), vals


# -- v3 (adaptive) --------------------------------------------------------

def pack_bitmask_from_xs(xs: np.ndarray, n_bytes: int) -> np.ndarray:
    """LSB-first changed-byte bitmask from ascending indices: bit
    ``i % 8`` of byte ``i // 8`` is set iff ``i`` is in ``xs``."""
    bits = np.zeros(n_bytes, dtype=np.uint8)
    bits[np.asarray(xs, dtype=np.int64)] = 1
    return np.packbits(bits, bitorder="little")


def decode_bitmask(mask: np.ndarray, n_bytes: int) -> np.ndarray:
    """Ascending changed indices from an LSB-first bitmask."""
    bits = np.unpackbits(np.asarray(mask, dtype=np.uint8), bitorder="little")
    return np.nonzero(bits[:n_bytes])[0].astype(np.int32)


def v3_sizes(pos: int, n_exc: int, n_bytes: int) -> Tuple[int, int, int]:
    """Exact per-mode wire bytes (mode prefix included) for one frame."""
    return (
        1 + 8 + 3 * pos + 4 * n_exc,          # delta16
        1 + 4 + (n_bytes + 7) // 8 + pos,     # bitmask
        1 + n_bytes,                          # raw
    )


def encode_frame_v3_numpy(pos: int, xs: np.ndarray, vals: np.ndarray,
                          frame_after: np.ndarray) -> bytes:
    """One v3 frame, the cheapest of the three modes — the byte-layout
    spec. ``frame_after`` is the client state after this payload (what
    mode 2 ships)."""
    n = frame_after.size
    xs = np.asarray(xs, dtype=np.int64)[:pos]
    vals = np.asarray(vals, dtype=np.uint8)[:pos]
    n_exc = int(np.count_nonzero(np.diff(xs, prepend=-1) >= _GAP_ESC))
    size_d, size_b, size_r = v3_sizes(pos, n_exc, n)
    if size_d <= size_b and size_d <= size_r:
        return bytes([MODE_DELTA16]) + pack_payload_v2(pos, xs, vals)
    if size_b <= size_r:
        mask = pack_bitmask_from_xs(xs, n)
        return (
            bytes([MODE_BITMASK])
            + _U32.pack(pos)
            + mask.tobytes()
            + vals.tobytes()
        )
    return bytes([MODE_RAW]) + np.ascontiguousarray(
        frame_after, dtype=np.uint8
    ).tobytes()


class V3Encoder:
    """Per-connection adaptive encoder for the v3 wire.

    Keeps a shadow of the client's frame, applying every payload with the
    client's own uint8 wrap-add, so mode 2 ships the exact post-apply
    state whichever executor produced the payload (a pipelined executor's
    payloads lag a frame; a device snapshot would be off by one).
    """

    def __init__(self, base_frame: np.ndarray):
        self.frame = np.asarray(base_frame, dtype=np.uint8).ravel().copy()
        self.last_mode: int = MODE_DELTA16

    def encode(self, pos: int, xs, vals) -> bytes:
        """One frame -> ``[u8 mode][body]`` bytes, cheapest mode."""
        if isinstance(xs, TiledPayload):
            xs, vals = xs.to_flat()
        xs = np.asarray(xs, dtype=np.int64)[:pos]
        vals = np.asarray(vals, dtype=np.uint8)[:pos]
        if pos:
            self.frame[xs] = self.frame[xs] + vals  # uint8 wrap-add
        buf = encode_frame_v3_numpy(pos, xs, vals, self.frame)
        self.last_mode = buf[0]
        return buf

    def resync(self, frame: np.ndarray) -> bytes:
        """A forced raw frame (payload-capacity overflow recovery): the
        shadow becomes the server's post-step state, which is shipped
        whole as mode 2."""
        np.copyto(self.frame, np.asarray(frame, dtype=np.uint8).ravel())
        self.last_mode = MODE_RAW
        return bytes([MODE_RAW]) + self.frame.tobytes()


def _unknown_mode(mode: int) -> ValueError:
    if mode == 3:
        return ValueError("v3 mode 3 (the v4 window bitmask) is not ported "
                          "to cudavideostream_tpu_torch yet: see ROADMAP.md "
                          "M8")
    return ValueError(f"unknown v3 mode {mode}")


def unpack_frame_v3(buf: bytes, offset: int, n_bytes: int):
    """Parse one v3 frame from a buffer. Returns ``(pos, xs, vals, raw,
    consumed)``: ``raw`` is the full replacement frame of mode 2 (``xs``
    and ``vals`` None), else None."""
    if len(buf) - offset < 1:
        raise ValueError("short buffer: v3 mode byte")
    mode = buf[offset]
    o = offset + 1
    if mode == MODE_DELTA16:
        pos, xs, vals, used = unpack_payload_v2(buf, o)
        return pos, xs, vals, None, 1 + used
    if mode == MODE_BITMASK:
        mb = (n_bytes + 7) // 8
        if len(buf) - o < 4:
            raise ValueError("short buffer: v3 bitmask header")
        (pos,) = _U32.unpack_from(buf, o)
        need = 4 + mb + pos
        if len(buf) - o < need:
            raise ValueError("short buffer: v3 bitmask body")
        mask = np.frombuffer(buf, dtype=np.uint8, count=mb, offset=o + 4)
        vals = np.frombuffer(
            buf, dtype=np.uint8, count=pos, offset=o + 4 + mb
        ).copy()
        xs = decode_bitmask(mask, n_bytes)
        if xs.size != pos:
            raise ValueError(f"v3 bitmask popcount {xs.size} != pos {pos}")
        return pos, xs, vals, None, 1 + need
    if mode == MODE_RAW:
        if len(buf) - o < n_bytes:
            raise ValueError("short buffer: v3 raw body")
        raw = np.frombuffer(buf, dtype=np.uint8, count=n_bytes, offset=o).copy()
        return n_bytes, None, None, raw, 1 + n_bytes
    raise _unknown_mode(mode)


def read_frame_v3(src, n_bytes: int):
    """Blocking read of one v3 frame: ``(pos, xs, vals, raw)`` (socket or
    ``read(n)``)."""
    rd = _reader(src)
    mode = rd(1)[0]
    if mode == MODE_DELTA16:
        pos, xs, vals = read_payload_v2(rd)
        return pos, xs, vals, None
    if mode == MODE_BITMASK:
        (pos,) = _U32.unpack(rd(4))
        mask = np.frombuffer(rd((n_bytes + 7) // 8), dtype=np.uint8)
        vals = np.frombuffer(rd(pos), dtype=np.uint8).copy()
        xs = decode_bitmask(mask, n_bytes)
        if xs.size != pos:
            raise ValueError(f"v3 bitmask popcount {xs.size} != pos {pos}")
        return pos, xs, vals, None
    if mode == MODE_RAW:
        raw = np.frombuffer(rd(n_bytes), dtype=np.uint8).copy()
        return n_bytes, None, None, raw
    raise _unknown_mode(mode)
