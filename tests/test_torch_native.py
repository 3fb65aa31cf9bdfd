"""The port's native host library (``cudavideostream_tpu_torch/native``) on
the CPU: its build, and each wrapper against its NumPy plain version, the
NumPy spec and the JAX package's own native library, byte for byte.

Every socket has a timeout and every thread is joined with one.
"""

import dataclasses
import errno
import socket
import struct
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from cudavideostream_tpu import native as jax_native
from cudavideostream_tpu.runtime import wire as jax_wire
from cudavideostream_tpu_torch import native
from cudavideostream_tpu_torch.config import StreamConfig
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.executor import ExecMetrics
from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer
from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 30


@pytest.fixture
def cfg():
    return StreamConfig(height=48, width=64, overlay_scale=4, port=0)


# -- the build -------------------------------------------------------------

def test_library_builds_under_build_native():
    """The library is built from the port's own source into
    ``build/native/``, under a name that carries its hash, never loaded
    from the JAX package's ``native/_build``."""
    lib = native.load()
    path = Path(lib._name)
    assert path.parent == REPO / "build" / "native"
    assert path == native.library_path() and path.name.startswith("libcvstpu-")
    assert native.SOURCE == (REPO / "cudavideostream_tpu_torch" / "native"
                             / "csrc" / "cvstpu.c")
    assert native.load() is lib
    for name in ("wire_send_payload", "wire_send_segments", "wire_encode_v3",
                 "client_apply", "client_decode", "compact_bitmask",
                 "compact_update", "v4l2_open", "v4l2_grab", "v4l2_close"):
        assert getattr(lib, name).argtypes is not None, name


def test_concurrent_builds_agree(tmp_path, monkeypatch):
    """Builders racing on one directory (test workers) each compile to a
    private name and rename: every one returns the same complete library,
    and no temporary file is left."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    out, errors = [], []

    def run():
        try:
            out.append(native.build())
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    threads = [threading.Thread(target=run, daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT * 4)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(out)) == 1 and out[0].parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [out[0].name]
    assert out[0].read_bytes()[:4] == b"\x7fELF"


@pytest.mark.parametrize("fault", ["no_compiler", "bad_source"])
def test_failed_build_raises(fault, tmp_path, monkeypatch):
    """No fallback: a missing compiler or a source that does not compile
    raises, and leaves no library behind."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    if fault == "no_compiler":
        monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
        match = "no C compiler"
    else:
        bad = tmp_path / "cvstpu.c"
        bad.write_text("int f( {\n")
        monkeypatch.setattr(native, "SOURCE", bad)
        match = "C compiler failed"
    with pytest.raises(RuntimeError, match=match):
        native.build()
    out = tmp_path / "out"
    assert not out.exists() or not list(out.iterdir())


# -- host packers ------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 63, 64, 100, 6144, 9217])
@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
def test_compact_bitmask_matches_jax_and_oracle(n, density, rng):
    prev = rng.integers(0, 255, n, endpoint=True, dtype=np.uint8)
    cur = np.where(rng.random(n) < density, (prev.astype(np.int32) + 99) % 256,
                   prev).astype(np.uint8)
    pos, xs_r, vals_r, _ = ref.diff_encode(cur, prev)
    df = cur.astype(np.int32) - prev.astype(np.int32)
    bitmask = np.packbits(np.abs(df) > 20, bitorder="little")
    delta = df.astype(np.uint8)
    xs, vals = native.compact_bitmask_np(delta, bitmask)
    assert xs.dtype == np.int32 and vals.dtype == np.uint8
    np.testing.assert_array_equal(xs, xs_r[:pos])
    np.testing.assert_array_equal(vals, vals_r[:pos])
    jxs, jvals = jax_native.compact_bitmask_np(delta, bitmask)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(vals, jvals)


@pytest.mark.parametrize("n", [100, 6144, 9217])
def test_compact_update_matches_jax_and_oracle(n, rng):
    """vals = cur - prev at the set bits, prev updated in place there: the
    oracle's negative-feedback state and payload."""
    prev = rng.integers(0, 255, n, endpoint=True, dtype=np.uint8)
    cur = np.where(rng.random(n) < 0.1, (prev.astype(np.int32) + 77) % 256,
                   prev).astype(np.uint8)
    pos, xs_r, vals_r, new_prev = ref.diff_encode(cur, prev)
    mask = np.abs(cur.astype(np.int32) - prev.astype(np.int32)) > 20
    bitmask = np.packbits(mask, bitorder="little")
    p, jp = prev.copy(), prev.copy()
    xs, vals = native.compact_update_np(cur, p, bitmask)
    assert xs.size == pos
    np.testing.assert_array_equal(xs, xs_r)
    np.testing.assert_array_equal(vals, vals_r)
    np.testing.assert_array_equal(p, new_prev)
    jxs, jvals = jax_native.compact_update_np(cur, jp, bitmask)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(p, jp)


def test_packers_refuse_what_c_would_overrun():
    n = 100
    delta = np.zeros(n, np.uint8)
    with pytest.raises(ValueError, match="bitmask"):
        native.compact_bitmask_np(delta, np.zeros(12, np.uint8))
    with pytest.raises(ValueError, match="writable"):
        native.compact_update_np(delta, np.zeros(n, np.int16),
                                 np.zeros(13, np.uint8))
    frozen = np.zeros(n, np.uint8)
    frozen.flags.writeable = False
    with pytest.raises(ValueError, match="writable"):
        native.compact_update_np(delta, frozen, np.zeros(13, np.uint8))
    with pytest.raises(ValueError, match="bytes"):
        native.compact_update_np(delta, np.zeros(n + 1, np.uint8),
                                 np.zeros(13, np.uint8))


# -- the client scatter ------------------------------------------------------

@pytest.mark.parametrize("pos", [0, 1, 300, 5000])
def test_client_apply_matches_add_at(pos, rng):
    """The C wrap-add against ``np.add.at``, repeated indices included."""
    n = 4096
    frame = rng.integers(0, 255, n, endpoint=True, dtype=np.uint8)
    xs = rng.integers(0, n, pos).astype(np.int32)
    vals = rng.integers(0, 255, pos, endpoint=True, dtype=np.uint8)
    want = frame.copy()
    np.add.at(want, xs, vals)
    got = frame.copy()
    native.client_apply_np(got, xs, vals)
    np.testing.assert_array_equal(got, want)
    # distinct indices, as a payload has them: the spec's scatter and the
    # port's NumPy plain version
    ux, first = np.unique(xs, return_index=True)
    got = frame.copy()
    native.client_apply_np(got, ux, vals[first])
    np.testing.assert_array_equal(got, ref.client_apply(frame, ux,
                                                        vals[first]))
    plain = frame.copy()
    wire.apply_payload(plain, ux, vals[first])
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("bad", [[-1], [4096], [0, 2**31 - 1]])
def test_client_apply_rejects_out_of_range(bad):
    frame = np.zeros(4096, np.uint8)
    with pytest.raises(ValueError, match="out of range"):
        native.client_apply_np(frame, np.array(bad, np.int32),
                               np.ones(len(bad), np.uint8))
    assert not frame.any()


def test_client_apply_refuses_bad_frames():
    with pytest.raises(ValueError, match="writable"):
        native.client_apply_np(np.zeros(10, np.int16), [1], [1])
    frozen = np.zeros(10, np.uint8)
    frozen.flags.writeable = False
    with pytest.raises(ValueError, match="writable"):
        native.client_apply_np(frozen, [1], [1])
    with pytest.raises(ValueError, match="vals"):
        native.client_apply_np(np.zeros(10, np.uint8), [1, 2], [1])


# -- the writev senders ------------------------------------------------------

def _sent(send, blocking=True):
    """The bytes ``send(fd)`` writes on one end of a socketpair, read on
    the other (with a timeout) until that end is shut; ``send``'s
    result."""
    a, b = socket.socketpair()
    b.settimeout(TIMEOUT)
    if not blocking:
        a.settimeout(TIMEOUT)  # a non-blocking fd under the hood
    got = bytearray()

    def read():
        while chunk := b.recv(1 << 16):
            got.extend(chunk)

    t = threading.Thread(target=read, daemon=True)
    t.start()
    with a, b:
        rc = send(a.fileno())
        a.shutdown(socket.SHUT_WR)
        t.join(TIMEOUT)
        assert not t.is_alive()
    return rc, bytes(got)


def _tiled(rng, n_units, unit, density, counts_dtype=np.int32):
    """A TiledPayload of ascending global indices, zero past each count,
    empty units among them."""
    counts = np.where(rng.random(n_units) < 0.3, 0,
                      rng.binomial(unit, density, n_units))
    xs_t = np.zeros((n_units, unit), np.int32)
    vals_t = np.zeros((n_units, unit), np.uint8)
    for t, c in enumerate(counts):
        xs_t[t, :c] = t * unit + np.sort(rng.choice(unit, c, replace=False))
        vals_t[t, :c] = rng.integers(1, 255, c, endpoint=True)
    return wire.TiledPayload(int(counts.sum()), counts.astype(counts_dtype),
                             xs_t, vals_t)


@pytest.mark.parametrize("pos", [0, 1, 300, 200_000])
@pytest.mark.parametrize("blocking", [True, False])
def test_wire_send_payload_bytes(pos, blocking, rng):
    """One writev of a flat payload: the bytes of ``pack_payload`` and of
    the JAX package's sender, also on a socket with a timeout (a
    non-blocking fd) larger than the socket's buffer."""
    xs = np.sort(rng.choice(10 * max(pos, 1), pos, replace=False)
                 ).astype(np.int32)
    vals = rng.integers(1, 255, pos, endpoint=True, dtype=np.uint8)
    # a longer buffer than pos: only the first pos entries go out
    xs_buf, vals_buf = np.concatenate([xs, [7, 7]]), np.append(vals, [9, 9])
    rc, got = _sent(lambda fd: native.wire_send_payload_fd(fd, pos, xs_buf,
                                                           vals_buf),
                    blocking)
    assert rc == 0
    assert got == wire.pack_payload(pos, xs, vals)
    _, jax_got = _sent(lambda fd: jax_native.wire_send_payload_fd(
        fd, pos, xs, vals))
    assert got == jax_got


# (units, unit bytes, density): the segments are gathered into one buffer
# in C whatever their lengths
SEGMENTS = [
    (12, 128, 0.05),     # short segments, empty units among them
    (3000, 128, 0.02),   # thousands of short segments
    (40, 4096, 0.6),     # long segments
    (800, 2048, 0.9),    # more than 1,024 of them, a buffer of 8 MB
    (5, 64, 0.0),        # every unit empty: the header alone
]


# uint8 counts only where every count fits them, as the landings give them
@pytest.mark.parametrize("counts_dtype,n_units,unit,density", [
    (dt, *case) for dt in (np.uint8, np.int16, np.int32) for case in SEGMENTS
    if dt is not np.uint8 or case[1] < 256])
def test_wire_send_segments_bytes(counts_dtype, n_units, unit, density, rng):
    """The send of a tiled payload's segments: the flat payload's v1
    bytes and the JAX package's sender's, for uint8, int16 and int32
    counts, zero-count units, short and long segments, and more segments
    than the JAX sender's one writev takes."""
    tp = _tiled(rng, n_units, unit, density, counts_dtype)
    if n_units == 800:
        assert 2 * np.count_nonzero(tp.counts) + 1 > 1024
    rc, got = _sent(lambda fd: native.wire_send_segments_fd(
        fd, tp.pos, tp.counts, tp.xs, tp.vals), blocking=False)
    assert rc == 0
    assert got == tp.to_wire_bytes()
    _, jax_got = _sent(lambda fd: jax_native.wire_send_segments_fd(
        fd, tp.pos, tp.counts.astype(np.int32), tp.xs, tp.vals))
    assert got == jax_got


def test_wire_send_segments_counts_past_the_rows(rng):
    """Counts may describe units the blocks dropped at the end, if those
    counts are zero; a nonzero one is refused."""
    tp = _tiled(rng, 6, 64, 0.2)
    counts = np.concatenate([tp.counts, [0, 0]])
    rc, got = _sent(lambda fd: native.wire_send_segments_fd(
        fd, tp.pos, counts, tp.xs, tp.vals))
    assert rc == 0 and got == tp.to_wire_bytes()
    with pytest.raises(ValueError, match="past the blocks"):
        native.wire_send_segments_fd(-1, tp.pos + 1,
                                     np.append(tp.counts, 1), tp.xs, tp.vals)


@pytest.mark.parametrize("fault", ["pos", "count_over_cap", "count_negative",
                                   "shapes", "flat_pos"])
def test_senders_refuse_inconsistent_payloads(fault, rng):
    tp = _tiled(rng, 6, 64, 0.2)
    counts = tp.counts.astype(np.int32)
    with pytest.raises(ValueError):
        if fault == "pos":
            native.wire_send_segments_fd(-1, tp.pos + 1, counts, tp.xs,
                                         tp.vals)
        elif fault == "count_over_cap":
            counts[0] = 65
            native.wire_send_segments_fd(-1, int(counts.sum()), counts,
                                         tp.xs, tp.vals)
        elif fault == "count_negative":
            counts[0] = -1
            native.wire_send_segments_fd(-1, int(counts.sum()), counts,
                                         tp.xs, tp.vals)
        elif fault == "shapes":
            native.wire_send_segments_fd(-1, tp.pos, counts, tp.xs,
                                         tp.vals[:, :32])
        else:
            native.wire_send_payload_fd(-1, 5, np.zeros(4, np.int32),
                                        np.zeros(5, np.uint8))


def test_send_error_is_a_negative_errno(rng):
    """A closed peer gives -EPIPE (or -ECONNRESET), never an exception."""
    a, b = socket.socketpair()
    b.close()
    with a:
        rc = native.wire_send_payload_fd(a.fileno(), 3,
                                         np.arange(3, dtype=np.int32),
                                         np.ones(3, np.uint8))
    assert rc < 0


@pytest.mark.parametrize("sender", ["payload", "segments"])
def test_senders_time_out_on_a_peer_that_never_reads(sender, rng):
    """A live peer that never drains its socket: the senders wait for
    the socket's timeout in all, as ``sendall`` does, and return
    -ETIMEDOUT instead of blocking forever. The send runs in a thread;
    should it block, closing the peer ends it and the test fails."""
    a, b = socket.socketpair()
    a.settimeout(0.3)
    tp = _tiled(rng, 64, 1 << 16, 1.0)  # 20 MB: more than any send buffer
    xs, vals = tp.to_flat()
    out = {}

    def send():
        t0 = time.monotonic()
        if sender == "payload":
            out["rc"] = native.wire_send_payload_fd(
                a.fileno(), tp.pos, xs, vals, a.gettimeout())
        else:
            out["rc"] = native.wire_send_segments_fd(
                a.fileno(), tp.pos, tp.counts, tp.xs, tp.vals,
                a.gettimeout())
        out["waited"] = time.monotonic() - t0

    with a, b:
        t = threading.Thread(target=send, daemon=True)
        t.start()
        t.join(TIMEOUT)
        blocked = t.is_alive()
        if blocked:
            b.close()
            t.join(TIMEOUT)
    assert not blocked, "the sender ignored the socket's timeout"
    assert out["rc"] == -errno.ETIMEDOUT
    assert 0.25 <= out["waited"] < TIMEOUT


# -- the v3 encoder ----------------------------------------------------------

def _flat_payload(rng, n, k, spread=False):
    if spread:  # few indices, far apart: escaped gaps
        xs = np.sort(rng.choice(n, k, replace=False))
        xs[0] = n - 1 if k == 1 else xs[0]
    else:
        xs = np.sort(rng.choice(n, k, replace=False))
    vals = rng.integers(1, 255, k, endpoint=True, dtype=np.uint8)
    return xs.astype(np.int64), vals


def _as_tiled(xs, vals, n, unit):
    counts = np.bincount(xs // unit, minlength=n // unit)
    xs_t = np.zeros((n // unit, unit), np.int32)
    vals_t = np.zeros((n // unit, unit), np.uint8)
    slots = wire.prefix_slots(counts, unit)
    xs_t.reshape(-1)[slots] = xs
    vals_t.reshape(-1)[slots] = vals
    return wire.TiledPayload(xs.size, counts.astype(np.int16), xs_t, vals_t)


V3_CASES = [  # (frame bytes, changed bytes, spread)
    (20_000, 0, False), (20_000, 1, False), (20_000, 200, False),
    (20_000, 1800, False), (20_000, 2600, False), (20_000, 9000, False),
    (20_000, 20_000, False), (300_000, 4, True), (300_000, 40, True),
    (300_000, 30_000, False),
]


@pytest.mark.parametrize("n,k,spread", V3_CASES)
def test_encode_v3_matches_numpy_and_jax(n, k, spread, rng):
    """Every mode (delta16, bitmask, raw) near their crossovers and with
    escaped gaps: the C encoder over a flat payload and over tiled blocks,
    with the shadow applied or given, equals the port's NumPy encoder and
    the JAX package's native encoder, and leaves the same shadow."""
    xs, vals = _flat_payload(rng, n, k, spread)
    base = rng.integers(0, 255, n, endpoint=True, dtype=np.uint8)
    after = base.copy()
    after[xs] += vals
    want = wire.encode_frame_v3_numpy(k, xs, vals, after)
    tp = _as_tiled(xs, vals, n, 500)
    for counts, bx, bv in (([k], xs, vals),
                           (tp.counts, tp.xs, tp.vals)):
        shadow = base.copy()
        assert native.encode_v3_np(counts, bx, bv, shadow, apply=True) == want
        np.testing.assert_array_equal(shadow, after)
        given = after.copy()
        assert native.encode_v3_np(counts, bx, bv, given, apply=False) == want
        np.testing.assert_array_equal(given, after)
    jshadow = base.copy()
    assert jax_native.encode_v3_np(np.array([k], np.int32), xs, vals, jshadow,
                                   apply=True) == want


@pytest.mark.parametrize("n,k,spread", V3_CASES)
@pytest.mark.parametrize("encoder", ["v3", "v4"])
def test_encoders_through_c_equal_the_spec(n, k, spread, encoder, rng):
    """``V3Encoder`` and ``V4Encoder`` (the C encoder, mode 3 added for
    v4) on flat, tiled and mask payloads, and the stateless
    ``encode_frame_v3``: the bytes of the NumPy spec, frame after frame,
    and the spec's shadow."""
    cls, spec = ((wire.V3Encoder, wire.encode_frame_v3_numpy)
                 if encoder == "v3"
                 else (wire.V4Encoder, wire.encode_frame_v4_numpy))
    base = rng.integers(0, 255, n, endpoint=True, dtype=np.uint8)
    encs = [cls(base) for _ in range(3)]
    state = base.copy()
    for _ in range(2):
        xs, vals = _flat_payload(rng, n, k, spread)
        state[xs] += vals
        want = spec(k, xs, vals, state)
        tp = _as_tiled(xs, vals, n, 500)
        mp = wire.MaskPayload(k, 0, wire.pack_bitmask_from_xs(xs, n), vals)
        for enc, payload in zip(encs, ((k, xs, vals), (k, tp, None),
                                       (k, mp, None))):
            assert enc.encode(*payload) == want
            np.testing.assert_array_equal(enc.frame, state)
            assert enc.last_mode == want[0]
        if encoder == "v3":
            assert wire.encode_frame_v3(k, xs, vals, state) == want
            assert wire.encode_frame_v3(k, tp, None, state) == want


def _v4_case(case, n, rng):
    """Ascending indices that take each of ``V4Encoder.encode``'s ways:
    ``dense`` a 3,000-byte run, where mode 3 beats even gap-free delta16
    and the C encode is skipped; ``gaps`` two runs split by an escaped
    gap, sized so mode 3 wins only by delta16's exact size, after the C
    encode; ``scattered`` 40 indices, where a v3 mode wins."""
    if case == "dense":
        return np.arange(16_003, 19_003)
    if case == "scattered":
        return np.sort(rng.choice(n, 40, replace=False))
    for m in range(1, 10_000):
        run = np.arange(8, 8 + m)
        xs = np.concatenate([run, run + m - 1 + wire._GAP_ESC])
        n_exc = int(np.count_nonzero(np.diff(xs, prepend=-1)
                                     >= wire._GAP_ESC))
        size_w = wire.winmask_size(xs.size, wire.winmask_window(xs)[1])
        if (not wire.winmask_wins(size_w, *wire.v3_sizes(xs.size, 0, n))
                and wire.winmask_wins(
                    size_w, *wire.v3_sizes(xs.size, n_exc, n))):
            return xs
    raise AssertionError("no run length puts mode 3 between the sizes")


@pytest.mark.parametrize("case,c_calls,mode", [
    ("dense", 0, wire.MODE_WINMASK), ("gaps", 1, wire.MODE_WINMASK),
    ("scattered", 1, wire.MODE_DELTA16)])
def test_v4_encoder_skips_the_c_encode_where_mode3_must_win(
        case, c_calls, mode, rng, monkeypatch):
    """``V4Encoder.encode`` on flat and tiled payloads sizes mode 3 first:
    where it must win the C encode is skipped and the shadow applied on
    its own, else the C encode runs and mode 3 still replaces it by the
    tie rule. Every way gives the spec's bytes and shadow, and the JAX
    package's encoder's bytes."""
    n = 300_000
    xs = _v4_case(case, n, rng)
    vals = rng.integers(1, 255, xs.size, endpoint=True, dtype=np.uint8)
    base = rng.integers(0, 255, n, endpoint=True, dtype=np.uint8)
    after = base.copy()
    after[xs] += vals
    want = wire.encode_frame_v4_numpy(xs.size, xs, vals, after)
    assert want[0] == mode
    assert jax_wire.V4Encoder(base).encode(xs.size, xs, vals) == want
    calls = []
    c_encode = wire._native_v3
    monkeypatch.setattr(wire, "_native_v3",
                        lambda *a, **k: calls.append(1) or c_encode(*a, **k))
    for payload in ((xs, vals), (_as_tiled(xs, vals, n, 500), None)):
        calls.clear()
        enc = wire.V4Encoder(base)
        assert enc.encode(xs.size, *payload) == want
        assert len(calls) == c_calls and enc.last_mode == mode
        np.testing.assert_array_equal(enc.frame, after)


def test_encode_v3_rejects_out_of_range_before_writing(rng):
    """An index outside the shadow, or a count outside its block, is
    refused before the shadow is touched."""
    n = 1000
    shadow = rng.integers(0, 255, n, endpoint=True, dtype=np.uint8)
    keep = shadow.copy()
    for xs in ([5, n], [-1, 5], [3, 2**31 - 1]):
        with pytest.raises(ValueError, match="out of range"):
            native.encode_v3_np([2], np.array(xs, np.int32),
                                np.ones(2, np.uint8), shadow, apply=True)
        np.testing.assert_array_equal(shadow, keep)
    with pytest.raises(ValueError, match="outside"):
        native.encode_v3_np([3], np.arange(2, dtype=np.int32),
                            np.ones(2, np.uint8), shadow, apply=True)
    frozen = shadow.copy()
    frozen.flags.writeable = False
    with pytest.raises(ValueError, match="writable"):
        native.encode_v3_np([1], [1], [1], frozen, apply=True)
    with pytest.raises(ValueError, match="contiguous"):
        native.encode_v3_np([1], [1], [1], shadow[::2], apply=False)


# -- the C client --------------------------------------------------------------

@pytest.mark.parametrize("tiled", [False, True])
def test_client_decode_reads_the_port_server(cfg, tiled, monkeypatch):
    """The C read loop on the port server's v1 stream (flat: one writev a
    frame; tiled: the segments sender): frame count, final reconstruction
    and running digest equal a replay through ``step_oracle``."""
    monkeypatch.setattr(ExecMetrics, "status_line", lambda self, *a: None)
    cfg = dataclasses.replace(cfg, tiled_payload=tiled,
                              fetch_mode="tiles" if tiled else "auto")
    n_frames = 6
    server = DeltaStreamServer(cfg, SyntheticSource(cfg, seed=5),
                               verbose=False, device="cpu")
    server.listen()
    errors = []

    def serve():
        try:
            server.serve(max_frames=n_frames)
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    frames, final, digest = native.client_decode_np(
        "127.0.0.1", server.port, cfg.frame_bytes, n_frames + 5,
        timeout=TIMEOUT)
    t.join(TIMEOUT)
    server.close()
    assert not t.is_alive() and not errors
    replay = SyntheticSource(cfg, seed=5)
    prev, want_digest = replay.base_frame(), 0
    for _ in range(n_frames):
        prev = ref.step_oracle(prev, next(replay), cfg)[0]
        want_digest += int(prev.sum(dtype=np.uint64))
    assert frames == n_frames
    np.testing.assert_array_equal(final, prev)
    assert digest == want_digest


def test_client_decode_rejects_out_of_range_indices(cfg):
    """Network indices are checked before the C scatter: a payload that
    points past the frame is an error, never an out-of-bounds write."""
    n = cfg.frame_bytes
    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(TIMEOUT)
    port = srv.getsockname()[1]

    def hostile():
        with srv:
            conn, _ = srv.accept()
            with conn:
                conn.settimeout(TIMEOUT)
                conn.sendall(bytes(n))
                conn.sendall(struct.pack("<I", 2)
                             + np.array([0, n], "<i4").tobytes() + b"\x07\x07")

    t = threading.Thread(target=hostile, daemon=True)
    t.start()
    with pytest.raises(ValueError, match="client_decode"):
        native.client_decode_np("127.0.0.1", port, n, 4, timeout=TIMEOUT)
    t.join(TIMEOUT)
    assert not t.is_alive()


def test_client_decode_times_out_on_a_stalled_server(cfg):
    """A server that sends the base frame and then nothing: the C loop
    ends after its read timeout with the frames it has, instead of
    blocking."""
    n = cfg.frame_bytes
    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(TIMEOUT)
    port = srv.getsockname()[1]
    done = threading.Event()

    def stall():
        with srv:
            conn, _ = srv.accept()
            with conn:
                conn.sendall(bytes(range(256)) * (n // 256))
                done.wait(TIMEOUT)

    t = threading.Thread(target=stall, daemon=True)
    t.start()
    frames, final, digest = native.client_decode_np("127.0.0.1", port, n, 4,
                                                    timeout=0.3)
    done.set()
    t.join(TIMEOUT)
    assert frames == 0 and digest == 0
    assert final.tobytes() == bytes(range(256)) * (n // 256)
