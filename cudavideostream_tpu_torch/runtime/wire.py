"""The TCP wire formats v1 to v4 — the byte-exact compatibility contract.

A copy of the JAX package's ``runtime/wire.py``. Little-endian, no
framing, no checksum. The NumPy encoders here are the byte-layout spec;
:class:`V3Encoder`, :class:`V4Encoder` and :func:`encode_frame_v3` encode
through the native library's C encoder (``native.encode_v3_np``), straight
off a :class:`TiledPayload`'s blocks, to the same bytes.

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
after a payload-capacity overflow.

**v4 "window bitmask"**: on connect :data:`MAGIC_V4`, then the base
frame; per frame the cheapest of the three v3 bodies and mode 3
``[u32 pos][u32 byte_start][u32 win_bytes][u8 bits[win_bytes/8]]
[u8 vals[pos]]``: the LSB-first change bits of frame bytes
``[byte_start, byte_start + win_bytes)`` only (both multiples of 8),
ties going delta16 > winmask > bitmask > raw. A :class:`MaskPayload`
(the mask landing's bits window and merged vals) is forwarded in mode 3
without building an index stream (:class:`V4Encoder`).
"""

from __future__ import annotations

import dataclasses
import socket
import struct
from typing import Tuple

import numpy as np

from cudavideostream_tpu_torch import native

_U32 = struct.Struct("<I")
_2U32 = struct.Struct("<II")
_3U32 = struct.Struct("<III")

# stream prefixes of the opt-in formats (16 bytes each)
MAGIC_V2 = b"CVSTPU-WIRE-V2\x00\x01"
MAGIC_V3 = b"CVSTPU-WIRE-V3\x00\x01"
MAGIC_V4 = b"CVSTPU-WIRE-V4\x00\x01"
# the prefix a server sends before the base frame, by wire format (v1: none)
MAGICS = {"v2": MAGIC_V2, "v3": MAGIC_V3, "v4": MAGIC_V4}
_GAP_ESC = 0xFFFF

# v3 per-frame mode prefix (one byte); WINMASK appears in v4 streams only
MODE_DELTA16 = 0
MODE_BITMASK = 1
MODE_RAW = 2
MODE_WINMASK = 3

# per-byte-value tables of the LSB-first bit layout: set-bit count, lowest
# and highest set bit (entry 0 unused: callers index nonzero bytes only)
_POPCNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(axis=1).astype(np.int64)
_LOWBIT8 = np.array(
    [(v & -v).bit_length() - 1 if v else 0 for v in range(256)], np.int64
)
_HIGHBIT8 = np.array(
    [v.bit_length() - 1 if v else 0 for v in range(256)], np.int64
)


def apply_payload(frame: np.ndarray, xs: np.ndarray,
                  vals: np.ndarray) -> None:
    """The client's uint8 wrap-add scatter
    (``reference_cpu.client_apply``), in place on ``frame``: a server's
    mirror of a client's state. Payload indices are distinct."""
    if len(xs):
        frame[np.asarray(xs, dtype=np.int64)] += np.asarray(vals,
                                                          dtype=np.uint8)


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
    spec, which the native encoder matches byte for byte. ``frame_after``
    is the client state after this payload (what mode 2 ships)."""
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


def _native_v3(pos: int, xs, vals, shadow: np.ndarray, apply: bool) -> bytes:
    """The C encoder over a :class:`TiledPayload`'s blocks, or over a flat
    payload's first ``pos`` entries as one block."""
    if isinstance(xs, TiledPayload):
        return native.encode_v3_np(xs.counts, xs.xs, xs.vals, shadow, apply)
    return native.encode_v3_np([pos], np.asarray(xs)[:pos],
                               np.asarray(vals)[:pos], shadow, apply)


def encode_frame_v3(pos: int, xs, vals, frame_after: np.ndarray) -> bytes:
    """The stateless v3 encode of one frame, ``frame_after`` the client
    state after this payload (what mode 2 ships): for servers that keep a
    reconstruction per client already (multiserve's per-stream mirror);
    others use :class:`V3Encoder`. Through the C encoder, the bytes of
    :func:`encode_frame_v3_numpy`."""
    return _native_v3(pos, xs, vals,
                      np.ascontiguousarray(frame_after, dtype=np.uint8),
                      apply=False)


class V3Encoder:
    """Per-connection adaptive encoder for the v3 wire.

    Keeps a shadow of the client's frame, applying every payload with the
    client's own uint8 wrap-add, so mode 2 ships the exact post-apply
    state whichever executor produced the payload (a pipelined executor's
    payloads lag a frame; a device snapshot would be off by one). The C
    encoder applies and encodes in one pass, straight off a
    :class:`TiledPayload`'s blocks (no :meth:`TiledPayload.to_flat`).
    """

    def __init__(self, base_frame: np.ndarray):
        self.frame = np.asarray(base_frame, dtype=np.uint8).ravel().copy()
        self.last_mode: int = MODE_DELTA16

    def encode(self, pos: int, xs, vals) -> bytes:
        """One frame -> ``[u8 mode][body]`` bytes, cheapest mode."""
        if isinstance(xs, MaskPayload):
            # v3 has no winmask mode: rebuild the index stream once
            pos = xs.pos
            xs, vals = xs.to_flat()
        buf = _native_v3(pos, xs, vals, self.frame, apply=True)
        self.last_mode = buf[0]
        return buf

    def resync(self, frame: np.ndarray) -> bytes:
        """A forced raw frame (payload-capacity overflow recovery): the
        shadow becomes the server's post-step state, which is shipped
        whole as mode 2."""
        np.copyto(self.frame, np.asarray(frame, dtype=np.uint8).ravel())
        self.last_mode = MODE_RAW
        return bytes([MODE_RAW]) + self.frame.tobytes()


# -- v4 (window bitmask) --------------------------------------------------

def winmask_window(xs: np.ndarray) -> Tuple[int, int]:
    """The minimal 8-aligned ``(byte_start, win_bytes)`` window covering
    ascending indices ``xs`` (``(0, 0)`` when empty)."""
    if len(xs) == 0:
        return 0, 0
    start = (int(xs[0]) // 8) * 8
    end = (int(xs[-1]) // 8 + 1) * 8
    return start, end - start


def _window(pos: int, xs) -> Tuple[int, int]:
    """:func:`winmask_window` of a flat payload's first ``pos`` indices or
    of a :class:`TiledPayload` (its first and last entries)."""
    if not pos:
        return 0, 0
    if isinstance(xs, TiledPayload):
        rows = xs.xs.shape[0]
        nz = np.flatnonzero(np.asarray(xs.counts)[:rows])
        first = xs.xs[nz[0], 0]
        last = xs.xs[nz[-1], int(xs.counts[nz[-1]]) - 1]
        return winmask_window([first, last])
    return winmask_window(np.asarray(xs)[[0, pos - 1]])


def winmask_size(pos: int, win_bytes: int) -> int:
    """Exact mode-3 wire bytes: mode + 3 x u32 header + bits + vals."""
    return 13 + win_bytes // 8 + pos


def winmask_wins(size_w: int, size_d: int, size_b: int, size_r: int) -> bool:
    """Mode 3's tie rule: delta16 wins its ties with mode 3, which wins
    its own with bitmask and raw."""
    return size_w < size_d and size_w <= size_b and size_w <= size_r


def winmask_bytes(pos: int, xs, vals, start: int, win_bytes: int) -> bytes:
    """One mode-3 frame of the first ``pos`` ascending flat indices
    ``xs`` in the window ``(start, win_bytes)``."""
    window = np.zeros(win_bytes, dtype=np.uint8)
    window[np.asarray(xs, dtype=np.int64)[:pos] - start] = 1
    return (bytes([MODE_WINMASK]) + _3U32.pack(pos, start, win_bytes)
            + np.packbits(window, bitorder="little").tobytes()
            + np.asarray(vals, dtype=np.uint8)[:pos].tobytes())


def encode_frame_v4_numpy(pos: int, xs: np.ndarray, vals: np.ndarray,
                          frame_after: np.ndarray) -> bytes:
    """One v4 frame, the cheapest of the v3 modes and mode 3 by exact
    size, ties in the order delta16, winmask, bitmask, raw — the
    byte-layout spec. :meth:`V4Encoder.encode` of a :class:`MaskPayload`
    gives the same bytes."""
    n = frame_after.size
    xs = np.asarray(xs, dtype=np.int64)[:pos]
    vals = np.asarray(vals, dtype=np.uint8)[:pos]
    n_exc = int(np.count_nonzero(np.diff(xs, prepend=-1) >= _GAP_ESC))
    start, wb = winmask_window(xs)
    size_d, size_b, size_r = v3_sizes(pos, n_exc, n)
    if winmask_wins(winmask_size(pos, wb), size_d, size_b, size_r):
        return winmask_bytes(pos, xs, vals, start, wb)
    if size_d <= size_b and size_d <= size_r:
        return bytes([MODE_DELTA16]) + pack_payload_v2(pos, xs, vals)
    if size_b <= size_r:
        mask = pack_bitmask_from_xs(xs, n)
        return (bytes([MODE_BITMASK]) + _U32.pack(pos) + mask.tobytes()
                + vals.tobytes())
    return bytes([MODE_RAW]) + np.ascontiguousarray(
        frame_after, dtype=np.uint8
    ).tobytes()


# the stateless v4 encode of one frame, peer of encode_frame_v3 (the
# JAX package's has no native path either)
encode_frame_v4 = encode_frame_v4_numpy


def v3_frame_extent(data, off: int, n_bytes: int) -> int:
    """End offset of the v3 (or v4) frame whose mode byte is
    ``data[off]``, from its header alone, over an in-memory capture
    (bytes or mmap); the replayer's framing scan. Raises ``ValueError`` on
    a truncated frame or an unknown mode."""
    if off + 1 > len(data):
        raise ValueError("truncated v3 frame: mode byte")
    mode = data[off]
    if mode == MODE_RAW:
        end = off + 1 + n_bytes
    elif mode == MODE_BITMASK:
        if off + 5 > len(data):
            raise ValueError("truncated v3 frame: bitmask header")
        (pos,) = _U32.unpack_from(data, off + 1)
        end = off + 1 + 4 + (n_bytes + 7) // 8 + pos
    elif mode == MODE_DELTA16:
        if off + 9 > len(data):
            raise ValueError("truncated v3 frame: delta16 header")
        pos, n_exc = _2U32.unpack_from(data, off + 1)
        end = off + 1 + 8 + 3 * pos + 4 * n_exc
    elif mode == MODE_WINMASK:
        if off + 13 > len(data):
            raise ValueError("truncated v4 frame: winmask header")
        pos, _start, wb = _3U32.unpack_from(data, off + 1)
        end = off + 13 + wb // 8 + pos
    else:
        raise ValueError(f"unknown v3 mode {mode} at offset {off}")
    if end > len(data):
        raise ValueError("truncated v3 frame: body")
    return end


@dataclasses.dataclass
class MaskPayload:
    """One frame delta as the device's packed change-bits window and the
    merged ascending values: the mask landing's result under
    ``config.mask_payload``.

    ``bits`` is LSB-first: bit ``k`` of ``bits[j]`` covers frame byte
    ``start_byte + 8*j + k``; ``start_byte`` is a multiple of 8. The
    window may carry zero bytes at either end (encoders trim them).
    ``vals`` holds at least ``pos`` entries; ``vals[:pos]`` are the
    payload.
    """

    pos: int
    start_byte: int
    bits: np.ndarray  # (win_bytes/8,) uint8
    vals: np.ndarray  # (>= pos,) uint8

    def to_flat(self) -> Tuple[np.ndarray, np.ndarray]:
        """Flat ``(xs, vals)`` host arrays (for the v1/v2/v3 senders)."""
        xs = decode_bitmask(
            np.asarray(self.bits, np.uint8), 8 * len(self.bits)
        ) + np.int32(self.start_byte)
        if xs.size != self.pos:
            raise ValueError(
                f"mask payload popcount {xs.size} != pos {self.pos}"
            )
        return xs, np.asarray(self.vals, np.uint8)[: self.pos]


class V4Encoder(V3Encoder):
    """Per-connection adaptive encoder for the v4 wire: v3's shadow and
    modes plus mode 3. A :class:`MaskPayload` whose winmask encoding wins
    is trimmed and forwarded as it is — no index stream is built, and the
    shadow applies through the bits. Other payloads are sized first: where
    mode 3 must win the C encode is skipped, else the C v3 encoder runs
    (the shadow applied in the same pass) and mode 3 replaces its choice
    where :func:`winmask_wins`: the bytes of :func:`encode_frame_v4_numpy`."""

    def encode(self, pos: int, xs, vals) -> bytes:
        if isinstance(xs, MaskPayload):
            return self._encode_mask(xs)
        start, wb = _window(pos, xs)
        size_w = winmask_size(pos, wb)
        # delta16 is smallest with no escaped gap: if mode 3 beats even
        # that, it wins whatever the gaps, and the C encode is skipped
        if winmask_wins(size_w, *v3_sizes(pos, 0, self.frame.size)):
            if isinstance(xs, TiledPayload):
                xs, vals = xs.to_flat()
            native.client_apply_np(self.frame, np.asarray(xs)[:pos],
                                   np.asarray(vals)[:pos])
            buf = winmask_bytes(pos, xs, vals, start, wb)
        else:
            buf = _native_v3(pos, xs, vals, self.frame, apply=True)
            # the C encoder's choice is delta16 (its exact size) or a
            # mode smaller than delta16, so this is the tie rule
            if (size_w < len(buf) or (size_w == len(buf)
                                      and buf[0] != MODE_DELTA16)):
                if isinstance(xs, TiledPayload):
                    xs, vals = xs.to_flat()
                buf = winmask_bytes(pos, xs, vals, start, wb)
        self.last_mode = buf[0]
        return buf

    def _encode_mask(self, mp: MaskPayload) -> bytes:
        bits = np.asarray(mp.bits, np.uint8)
        nzb = np.flatnonzero(bits)
        if nzb.size == 0:
            if mp.pos:
                raise RuntimeError(
                    f"mask payload window is empty but pos={mp.pos} "
                    "(the landing window missed changed units)"
                )
            self.last_mode = MODE_DELTA16
            return bytes([MODE_DELTA16]) + pack_payload_v2(
                0, np.empty(0, np.int64), np.empty(0, np.uint8))
        pos = mp.pos
        nzv = bits[nzb]
        total = int(_POPCNT8[nzv].sum())
        if total != pos:
            raise RuntimeError(
                f"mask payload popcount {total} != device pos {pos} "
                "(invariant violation, never truncate)"
            )
        vals = np.asarray(mp.vals, np.uint8)[:pos]
        b0, b1 = int(nzb[0]), int(nzb[-1]) + 1
        start = mp.start_byte + 8 * b0
        wb = 8 * (b1 - b0)
        # the exact delta16 size without building xs: an escaped gap can
        # only span a run of zero bytes (within a byte a gap is <= 7), so
        # each nonzero byte's lowest and highest set bit give every
        # candidate gap
        glo = mp.start_byte + 8 * nzb + _LOWBIT8[nzv]
        ghi = mp.start_byte + 8 * nzb + _HIGHBIT8[nzv]
        n_exc = int(glo[0] + 1 >= _GAP_ESC) + int(
            np.count_nonzero(glo[1:] - ghi[:-1] >= _GAP_ESC))
        size_d, size_b, size_r = v3_sizes(pos, n_exc, self.frame.size)
        if winmask_wins(winmask_size(pos, wb), size_d, size_b, size_r):
            bw = bits[b0:b1]
            seg = self.frame[start: start + wb]
            m = np.unpackbits(bw, bitorder="little")[: seg.size].view(bool)
            seg[m] = seg[m] + vals  # uint8 wrap-add, ascending order
            self.last_mode = MODE_WINMASK
            return (bytes([MODE_WINMASK]) + _3U32.pack(pos, start, wb)
                    + bw.tobytes() + vals.tobytes())
        # a v3 mode is at least as small (or delta16 ties): rebuild the
        # indices once; same sizes and tie order, so the spec's bytes
        xs, vals = mp.to_flat()
        return self.encode(pos, xs, vals)


def unpack_frame_v3(buf: bytes, offset: int, n_bytes: int):
    """Parse one v3 or v4 frame from a buffer. Returns ``(pos, xs, vals,
    raw, consumed)``: ``raw`` is the full replacement frame of mode 2
    (``xs`` and ``vals`` None), else None. Mode 3's window bits are
    rebuilt into global ``xs``."""
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
    if mode == MODE_WINMASK:
        if len(buf) - o < 12:
            raise ValueError("short buffer: v4 winmask header")
        pos, start, wb = _3U32.unpack_from(buf, o)
        mb = wb // 8
        need = 12 + mb + pos
        if len(buf) - o < need:
            raise ValueError("short buffer: v4 winmask body")
        bits = np.frombuffer(buf, dtype=np.uint8, count=mb, offset=o + 12)
        vals = np.frombuffer(
            buf, dtype=np.uint8, count=pos, offset=o + 12 + mb
        ).copy()
        xs = decode_bitmask(bits, wb) + np.int32(start)
        if xs.size != pos:
            raise ValueError(f"v4 winmask popcount {xs.size} != pos {pos}")
        return pos, xs, vals, None, 1 + need
    raise ValueError(f"unknown v3 mode {mode}")


def read_frame_v3(src, n_bytes: int):
    """Blocking read of one v3 or v4 frame: ``(pos, xs, vals, raw)``
    (socket or ``read(n)``)."""
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
    if mode == MODE_WINMASK:
        pos, start, wb = _3U32.unpack(rd(12))
        bits = np.frombuffer(rd(wb // 8), dtype=np.uint8)
        vals = np.frombuffer(rd(pos), dtype=np.uint8).copy()
        xs = decode_bitmask(bits, wb) + np.int32(start)
        if xs.size != pos:
            raise ValueError(f"v4 winmask popcount {xs.size} != pos {pos}")
        return pos, xs, vals, None
    raise ValueError(f"unknown v3 mode {mode}")
