"""The port's native host library, ``native/csrc/cvstpu.c``, bound with
``ctypes`` (the counterpart of the JAX package's ``native/``).

It holds the host's hot loops: the senders of wire v1 payloads,
flat and tiled (:func:`wire_send_payload_fd`, :func:`wire_send_segments_fd`),
the adaptive v3 encoder straight off the tiled blocks (:func:`encode_v3_np`),
the client's wrap-add scatter and its C read loop (:func:`client_apply_np`,
:func:`client_decode_np`), the host packers (:func:`compact_bitmask_np`,
:func:`compact_update_np`) and the V4L2 capture that
``runtime.sources.V4L2Source`` drives.

The library is compiled by the C compiler (``$CC``, else ``cc``) with
:data:`CFLAGS` at first use, into ``build/native/`` at the root of the
checkout (listed in ``.gitignore``). Its file name carries a hash of the
source, the flags and the compiler's predefined macros for this machine
(what ``-march=native`` resolved to), so an edited source, or a checkout
copied to another CPU, is rebuilt. Nothing here runs at import time.

There is no fallback: without a compiler, or on a failed build or load,
:func:`load` raises. The NumPy versions of these functions
(``runtime.wire.pack_payload``, ``encode_frame_v3_numpy``,
``apply_payload``) are the plain versions the tests hold the library
against; the served paths do not use them.

Every wrapper checks dtypes, shapes, counts and indices before it passes a
pointer: out-of-range indices raise ``ValueError``, never reach C.

Build by hand: ``python -m cudavideostream_tpu_torch.native.build``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "cvstpu.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
# the C client's default bound on each read, so a stalled server ends its
# loop instead of blocking it forever
CLIENT_TIMEOUT_S = 60.0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_c = ctypes
_U8P = _c.POINTER(_c.c_uint8)
_I32P = _c.POINTER(_c.c_int32)
_SIGNATURES = {
    "wire_send_payload": ([_c.c_int, _c.c_uint32, _I32P, _U8P, _c.c_int],
                          _c.c_int),
    "wire_send_segments": ([_c.c_int, _c.c_uint32, _I32P, _U8P, _I32P,
                            _c.c_int, _c.c_int, _c.c_int], _c.c_int),
    "compact_bitmask": ([_U8P, _U8P, _c.c_int64, _I32P, _U8P], _c.c_int64),
    "compact_update": ([_U8P, _U8P, _U8P, _c.c_int64, _I32P, _U8P],
                       _c.c_int64),
    "client_apply": ([_U8P, _I32P, _U8P, _c.c_int64], None),
    "client_decode": ([_c.c_char_p, _c.c_int, _c.c_int64, _c.c_int64, _U8P,
                       _c.POINTER(_c.c_uint64), _c.c_int], _c.c_int64),
    "wire_encode_v3": ([_I32P, _c.c_int64, _c.c_int64, _I32P, _U8P, _U8P,
                        _c.c_int64, _c.c_int, _U8P, _c.c_int64], _c.c_int64),
    "v4l2_open": ([_c.c_char_p, _c.c_int, _c.c_int], _c.c_int),
    "v4l2_grab": ([_c.c_int, _U8P, _c.c_int64], _c.c_int),
    "v4l2_close": ([_c.c_int], None),
}


def compiler() -> str:
    return os.environ.get("CC", "cc")


def library_path() -> Path:
    """Where the library lives for this source, these flags, this
    compiler and this CPU (the macros ``-march=native`` defines)."""
    try:
        proc = subprocess.run(
            [compiler(), *CFLAGS[:2], "-E", "-dM", "-x", "c", os.devnull],
            capture_output=True, timeout=60)
    except OSError as e:
        raise RuntimeError(
            f"no C compiler ({compiler()}): the native library of "
            "cudavideostream_tpu_torch is built from source at first use"
        ) from e
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler()} failed to report its target "
                           f"(exit {proc.returncode}):\n"
                           f"{proc.stderr.decode(errors='replace')}")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CFLAGS).encode()
                            + proc.stdout).hexdigest()
    return BUILD_DIR / f"libcvstpu-{digest[:16]}.so"


def build() -> Path:
    """Compile ``csrc/cvstpu.c`` unless its library is already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name and rename: concurrent builders (test
    # workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler(), *CFLAGS, str(SOURCE), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} did not run: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"the C compiler failed on native/csrc/cvstpu.c "
                           f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, every function declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _blocks(counts, xs, vals):
    """``(counts, xs, vals)`` as the C functions read them: contiguous
    ``(rows, cap)`` int32 and uint8 blocks (1-D arrays are one row) and
    int32 counts of those rows. Counts past the rows must be zero (the
    executors drop empty units at either end); every count must lie in
    ``[0, cap]``."""
    xs = np.ascontiguousarray(xs, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.uint8)
    if xs.ndim == 1:
        xs, vals = xs.reshape(1, -1), vals.reshape(1, -1)
    if xs.ndim != 2 or xs.shape != vals.shape:
        raise ValueError(f"xs {xs.shape} and vals {vals.shape} blocks "
                         "disagree")
    rows, cap = xs.shape
    # int64 first: a uint8, int16 or int32 count keeps its value
    c = np.asarray(counts).astype(np.int64).reshape(-1)
    if c[rows:].any():
        raise ValueError("counts describe entries past the blocks' rows")
    c = c[:rows]
    if c.size != rows:
        raise ValueError(f"{c.size} counts for {rows} rows")
    if c.size and (c.min() < 0 or c.max() > cap):
        raise ValueError(f"a count lies outside [0, {cap}]")
    return np.ascontiguousarray(c, dtype=np.int32), xs, vals


def _check_indices(xs: np.ndarray, n: int) -> None:
    if xs.size and (int(xs.min()) < 0 or int(xs.max()) >= n):
        raise ValueError("payload index out of range")


def _timeout_ms(timeout: float | None) -> int:
    """A socket's timeout as the senders' bound: ``None`` (blocking)
    waits as long as it takes."""
    return -1 if timeout is None else int(timeout * 1000)


def wire_send_payload_fd(fd: int, pos: int, xs, vals,
                         timeout: float | None = None) -> int:
    """Send ``[u32 pos][i32 xs[:pos]][u8 vals[:pos]]`` on a raw fd with
    one ``writev`` (short-write safe). ``timeout`` is the socket's
    (``sock.gettimeout()``): a full send buffer is waited on for at most
    that many seconds in all, as ``sendall`` does. Returns 0, or
    ``-errno`` (``-ETIMEDOUT`` when the timeout runs out)."""
    xs = np.ascontiguousarray(xs, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.uint8)
    if pos < 0 or xs.size < pos or vals.size < pos:
        raise ValueError(f"pos {pos} exceeds the payload ({xs.size} xs, "
                         f"{vals.size} vals)")
    return load().wire_send_payload(fd, pos, _ptr(xs, ctypes.c_int32),
                                    _ptr(vals, ctypes.c_uint8),
                                    _timeout_ms(timeout))


def wire_send_segments_fd(fd: int, pos: int, counts, xs_t, vals_t,
                          timeout: float | None = None) -> int:
    """Send a tiled payload on a raw fd: the header, every unit's ``xs``
    prefix, then every unit's ``vals`` prefix, the bytes of the flat v1
    payload, gathered in C into one buffer and sent with one write (no
    repacking in Python). ``counts`` may be uint8, int16 or int32 and
    describe more units than the blocks hold if the extra counts are
    zero. ``timeout`` as in :func:`wire_send_payload_fd`. Returns 0, or
    ``-errno`` (``-ENOMEM`` when the buffer cannot be allocated,
    ``-ETIMEDOUT`` when the timeout runs out)."""
    c, xs_t, vals_t = _blocks(counts, xs_t, vals_t)
    if int(c.sum(dtype=np.int64)) != pos:
        raise ValueError(f"pos {pos} != the counts' sum {int(c.sum())}")
    rows, cap = xs_t.shape
    return load().wire_send_segments(
        fd, pos, _ptr(xs_t, ctypes.c_int32), _ptr(vals_t, ctypes.c_uint8),
        _ptr(c, ctypes.c_int32), rows, cap, _timeout_ms(timeout))


def encode_v3_np(counts, xs, vals, shadow: np.ndarray, apply: bool) -> bytes:
    """One adaptive v3 frame ``[u8 mode][body]`` encoded in C over tiled
    payload blocks (a flat payload passes 1-D ``xs`` and ``vals`` and
    ``counts=[pos]``), byte-identical to
    ``runtime.wire.encode_frame_v3_numpy``. ``shadow`` is the client-state
    frame: with ``apply`` the payload is first folded into it (the uint8
    wrap-add, :class:`~cudavideostream_tpu_torch.runtime.wire.V3Encoder`'s
    contract), without it it must already be the state after the payload.
    Raises ``ValueError`` on an index outside the shadow, before the
    shadow is touched."""
    if shadow.dtype != np.uint8 or not shadow.flags.c_contiguous:
        raise ValueError("shadow must be a contiguous uint8 array")
    if apply and not shadow.flags.writeable:
        raise ValueError("shadow must be writable when apply is set")
    c, xs, vals = _blocks(counts, xs, vals)
    rows, cap = xs.shape
    pos = int(c.sum(dtype=np.int64))
    n = shadow.size
    # the delta16 working area and any mode the encoder may choose
    out_cap = max(10 + 7 * pos, 1 + n)
    out = np.empty(out_cap, dtype=np.uint8)
    rc = load().wire_encode_v3(
        _ptr(c, ctypes.c_int32), rows, cap, _ptr(xs, ctypes.c_int32),
        _ptr(vals, ctypes.c_uint8), _ptr(shadow, ctypes.c_uint8), n,
        1 if apply else 0, _ptr(out, ctypes.c_uint8), out_cap)
    if rc == -2:
        raise ValueError("payload index out of range")
    if rc < 0:
        raise RuntimeError(f"wire_encode_v3 failed: {rc}")
    return out[:rc].tobytes()


def client_apply_np(frame: np.ndarray, xs, vals) -> None:
    """``frame[xs[i]] += vals[i]`` (uint8 wraparound) in place, in C;
    repeated indices accumulate, as the reference client's loop does.
    Raises ``ValueError`` on an index outside the frame."""
    if (frame.dtype != np.uint8 or not frame.flags.c_contiguous
            or not frame.flags.writeable):
        raise ValueError("frame must be a writable contiguous uint8 array")
    xs = np.ascontiguousarray(xs, dtype=np.int32).reshape(-1)
    vals = np.ascontiguousarray(vals, dtype=np.uint8).reshape(-1)
    if xs.size != vals.size:
        raise ValueError(f"{xs.size} xs for {vals.size} vals")
    _check_indices(xs, frame.size)
    load().client_apply(_ptr(frame, ctypes.c_uint8),
                        _ptr(xs, ctypes.c_int32),
                        _ptr(vals, ctypes.c_uint8), xs.size)


def client_decode_np(host: str, port: int, n_bytes: int, max_frames: int,
                     timeout: float = CLIENT_TIMEOUT_S):
    """Run the C decode loop, the reference client's read protocol over
    wire v1: connect, read the base frame, then apply up to
    ``max_frames`` payloads until the server closes. Returns ``(frames,
    final_frame, digest)``, the digest the sum of every byte of every
    reconstruction. Each read waits at most ``timeout`` seconds. Raises
    ``ValueError`` on a corrupt stream (the C side checks every index
    before its scatter) or a failed connection."""
    frame = np.zeros(n_bytes, dtype=np.uint8)
    digest = ctypes.c_uint64(0)
    frames = load().client_decode(
        host.encode(), port, n_bytes, max_frames, _ptr(frame, ctypes.c_uint8),
        ctypes.byref(digest), max(1, int(timeout * 1000)))
    if frames < 0:
        raise ValueError(f"native client_decode failed: {frames} (corrupt "
                         "stream or connection error)")
    return int(frames), frame, int(digest.value)


def _check_bitmask(bitmask: np.ndarray, n: int) -> None:
    if bitmask.size < (n + 7) // 8:
        raise ValueError(f"a bitmask of {bitmask.size} bytes covers fewer "
                         f"than {n} bytes")


def compact_bitmask_np(delta, bitmask):
    """``(xs, vals)`` of the bytes whose bit is set in the LSB-first
    ``bitmask``: ascending int32 indices and ``delta`` there."""
    delta = np.ascontiguousarray(delta, dtype=np.uint8).reshape(-1)
    bitmask = np.ascontiguousarray(bitmask, dtype=np.uint8).reshape(-1)
    _check_bitmask(bitmask, delta.size)
    xs = np.empty(delta.size, dtype=np.int32)
    vals = np.empty(delta.size, dtype=np.uint8)
    n = load().compact_bitmask(
        _ptr(delta, ctypes.c_uint8), _ptr(bitmask, ctypes.c_uint8),
        delta.size, _ptr(xs, ctypes.c_int32), _ptr(vals, ctypes.c_uint8))
    return xs[:n], vals[:n]


def compact_update_np(cur, prev: np.ndarray, bitmask):
    """The host-source packer: at every set bit, ``vals = cur - prev``
    (uint8 wrap) and ``prev`` updated in place to ``cur`` (the
    negative-feedback state update). Returns ``(xs, vals)``. ``prev``
    must be a writable contiguous uint8 array of ``cur``'s size."""
    cur = np.ascontiguousarray(cur, dtype=np.uint8).reshape(-1)
    if (prev.dtype != np.uint8 or not prev.flags.c_contiguous
            or not prev.flags.writeable):
        raise ValueError("prev must be a writable contiguous uint8 array "
                         "(it is updated in place)")
    if prev.size != cur.size:
        raise ValueError(f"prev has {prev.size} bytes, cur {cur.size}")
    bitmask = np.ascontiguousarray(bitmask, dtype=np.uint8).reshape(-1)
    _check_bitmask(bitmask, cur.size)
    xs = np.empty(cur.size, dtype=np.int32)
    vals = np.empty(cur.size, dtype=np.uint8)
    n = load().compact_update(
        _ptr(cur, ctypes.c_uint8), _ptr(prev, ctypes.c_uint8),
        _ptr(bitmask, ctypes.c_uint8), cur.size, _ptr(xs, ctypes.c_int32),
        _ptr(vals, ctypes.c_uint8))
    return xs[:n], vals[:n]
