"""The port's wire v2/v3 and ``TiledPayload`` against the JAX package's
spec functions, byte for byte: every v3 mode, the mode crossovers and
their ties, index-gap escapes, and the vectorized ``to_flat`` against the
JAX package's per-unit loop."""

import numpy as np
import pytest

from cudavideostream_tpu.runtime import wire as jax_wire
from cudavideostream_tpu_torch.runtime import wire

N = 8000  # frame bytes of the v3 cases


def _payload(rng, pos, n=N):
    xs = np.sort(rng.choice(n, pos, replace=False)).astype(np.int32)
    vals = rng.integers(1, 255, pos, endpoint=True, dtype=np.uint8)
    return xs, vals


def _reader(buf, step=7):
    """A read(n) callable over ``buf`` that is fed in ``step``-byte chunks
    (short reads)."""
    chunks = iter([buf[i:i + step] for i in range(0, len(buf), step)])
    pending = bytearray()

    def read(n):
        while len(pending) < n:
            pending.extend(next(chunks))
        out = bytes(pending[:n])
        del pending[:n]
        return out

    return read


V2_CASES = {
    "empty": np.empty(0, np.int64),
    "dense": np.arange(0, 5000, 2),
    "first_past_65534": np.array([65_534, 65_535, 70_000, 70_001]),
    "gap_0xfffe": np.array([3, 3 + 0xFFFE, 3 + 2 * 0xFFFE]),
    "gap_0xffff": np.array([3, 3 + 0xFFFF, 4 + 2 * 0xFFFF]),
    "index_0": np.array([0, 1, 0xFFFF, 0x1FFFF, 6_000_000]),
}


@pytest.mark.parametrize("case", list(V2_CASES))
def test_v2_bytes_match_jax(case):
    xs = V2_CASES[case].astype(np.int32)
    vals = np.arange(1, xs.size + 1).astype(np.uint8) | 1
    buf = wire.pack_payload_v2(xs.size, xs, vals)
    assert buf == jax_wire.pack_payload_v2(xs.size, xs, vals)
    pos, x2, v2, used = wire.unpack_payload_v2(buf + b"tail")
    assert pos == xs.size and used == len(buf)
    np.testing.assert_array_equal(x2, xs)
    np.testing.assert_array_equal(v2, vals)
    pos, x3, v3 = wire.read_payload_v2(_reader(buf))
    np.testing.assert_array_equal(x3, xs)
    np.testing.assert_array_equal(v3, vals)
    with pytest.raises(ValueError):
        wire.unpack_payload_v2(buf[:-1])


def _v3_pos(case):
    """pos of each v3 case at N = 8000 bytes: sizes are delta16 9 + 3p
    (no escapes), bitmask 5 + 1000 + p, raw 8001."""
    return {"zero": 0, "delta16": 100, "delta16_bitmask_tie": 498,
            "bitmask": 2000, "bitmask_raw_tie": 6996, "raw": 6997}[case]


@pytest.mark.parametrize("case", ["zero", "delta16", "delta16_bitmask_tie",
                                  "bitmask", "bitmask_raw_tie", "raw"])
def test_v3_bytes_match_jax(case, rng):
    """Each mode, and each tie, which goes to the first mode listed."""
    pos = _v3_pos(case)
    xs, vals = _payload(rng, pos)
    frame = rng.integers(0, 255, N, endpoint=True, dtype=np.uint8)
    buf = wire.encode_frame_v3_numpy(pos, xs, vals, frame)
    assert buf == jax_wire.encode_frame_v3_numpy(pos, xs, vals, frame)
    want_mode = {"zero": 0, "delta16": 0, "delta16_bitmask_tie": 0,
                 "bitmask": 1, "bitmask_raw_tie": 1, "raw": 2}[case]
    assert buf[0] == want_mode
    d, b, r = wire.v3_sizes(pos, 0, N)
    assert len(buf) == min(d, b, r)
    if case.endswith("tie"):
        assert sorted((d, b, r))[0] == sorted((d, b, r))[1]
    got = wire.unpack_frame_v3(buf, 0, N)
    assert got[4] == len(buf)
    rd = wire.read_frame_v3(_reader(buf), N)
    if want_mode == 2:
        np.testing.assert_array_equal(got[3], frame)
        np.testing.assert_array_equal(rd[3], frame)
    else:
        assert got[0] == rd[0] == pos and got[3] is None and rd[3] is None
        for x in (got[1], rd[1]):
            np.testing.assert_array_equal(x, xs)
        for v in (got[2], rd[2]):
            np.testing.assert_array_equal(v, vals)


def test_v3_escapes_move_the_crossover():
    """Each escaped gap costs 4 more bytes in delta16. At n = 2^22 and
    262,100 entries delta16 wins by 84 bytes when the entries are dense,
    and loses by 156 when 60 of them sit 65,535 apart."""
    n = 1 << 22
    frame = np.zeros(n, np.uint8)
    dense = np.arange(262_100, dtype=np.int32)
    spread = np.concatenate([
        np.arange(262_040), 262_039 + 65_535 * np.arange(1, 61),
    ]).astype(np.int32)
    for xs, mode, n_exc in ((dense, 0, 0), (spread, 1, 60)):
        vals = np.full(xs.size, 9, np.uint8)
        buf = wire.encode_frame_v3_numpy(xs.size, xs, vals, frame)
        assert buf == jax_wire.encode_frame_v3_numpy(xs.size, xs, vals, frame)
        assert buf[0] == mode
        assert len(buf) == min(wire.v3_sizes(xs.size, n_exc, n))
        got = wire.unpack_frame_v3(buf, 0, n)
        np.testing.assert_array_equal(got[1], xs)


def test_v3_encoder_matches_jax_over_a_stream(rng):
    """The stateful encoders, fed the same stream (flat and tiled
    payloads, a resync in the middle), emit the same bytes and keep the
    same client shadow."""
    base = rng.integers(0, 255, N, endpoint=True, dtype=np.uint8)
    ours, theirs = wire.V3Encoder(base), jax_wire.V3Encoder(base)
    for k, pos in enumerate([0, 50, 700, 3000, 7500, 10]):
        xs, vals = _payload(rng, pos)
        if k == 4:
            frame = rng.integers(0, 255, N, endpoint=True, dtype=np.uint8)
            assert ours.resync(frame) == theirs.resync(frame)
            continue
        if k % 2:
            cap, units = 128, -(-N // 128)
            c = np.bincount(xs // cap, minlength=units)
            rank = np.arange(pos) - np.repeat(np.cumsum(c) - c, c)
            xt = np.zeros((units, cap), np.int32)
            vt = np.zeros((units, cap), np.uint8)
            xt[xs // cap, rank] = xs
            vt[xs // cap, rank] = vals
            counts = c.astype(np.uint8)
            a = ours.encode(pos, wire.TiledPayload(pos, counts, xt, vt), None)
            b = theirs.encode(pos, jax_wire.TiledPayload(pos, counts, xt, vt),
                              None)
        else:
            a, b = ours.encode(pos, xs, vals), theirs.encode(pos, xs, vals)
        assert a == b and ours.last_mode == theirs.last_mode
        np.testing.assert_array_equal(ours.frame, theirs.frame)


def test_v3_mode_3_names_the_roadmap_item():
    """Mode 3 (v4's window bitmask) was refused until the mask slice
    (ROADMAP M8); it now decodes in both readers, as the JAX package's
    does, and an unknown mode still raises."""
    xs = np.array([16, 17, 23, 40], np.int32)
    vals = np.array([1, 2, 3, 4], np.uint8)
    buf = bytes([3]) + jax_wire._3U32.pack(4, 16, 32) + np.packbits(
        np.isin(np.arange(16, 48), xs).astype(np.uint8),
        bitorder="little").tobytes() + vals.tobytes()
    for got in (wire.unpack_frame_v3(buf, 0, N)[:4],
                wire.read_frame_v3(_reader(buf), N),
                jax_wire.unpack_frame_v3(buf, 0, N)[:4]):
        assert got[0] == 4 and got[3] is None
        np.testing.assert_array_equal(got[1], xs)
        np.testing.assert_array_equal(got[2], vals)
    assert wire.unpack_frame_v3(buf + b"tail", 0, N)[4] == len(buf)
    with pytest.raises(ValueError, match="short buffer"):
        wire.unpack_frame_v3(buf[:-1], 0, N)
    with pytest.raises(ValueError, match="unknown v3 mode 9"):
        wire.unpack_frame_v3(bytes([9]), 0, N)


def test_magics_and_bitmask_helpers_match_jax(rng):
    assert (wire.MAGIC_V2, wire.MAGIC_V3, wire.MAGIC_V4) == (
        jax_wire.MAGIC_V2, jax_wire.MAGIC_V3, jax_wire.MAGIC_V4)
    xs, _ = _payload(rng, 900)
    for n in (N, N + 3):
        m = wire.pack_bitmask_from_xs(xs, n)
        np.testing.assert_array_equal(m, jax_wire.pack_bitmask_from_xs(xs, n))
        np.testing.assert_array_equal(wire.decode_bitmask(m, n), xs)
        assert wire.v3_sizes(900, 3, n) == jax_wire.v3_sizes(900, 3, n)


def _tiled(rng, n_units, cap, density, counts_dtype, extra_zero_counts=0):
    counts = (rng.random(n_units) < density) * rng.integers(
        0, cap, n_units, endpoint=True)
    xs = np.zeros((n_units, cap), np.int32)
    vals = np.zeros((n_units, cap), np.uint8)
    for t, c in enumerate(counts):
        sel = np.sort(rng.choice(cap, c, replace=False))
        xs[t, :c] = t * cap + sel
        vals[t, :c] = rng.integers(1, 255, c, endpoint=True)
    counts = np.concatenate([counts, np.zeros(extra_zero_counts, int)])
    return int(counts.sum()), counts.astype(counts_dtype), xs, vals


@pytest.mark.parametrize("n_units,cap,density,dtype,extra", [
    (300, 128, 0.5, np.uint8, 0),
    (300, 128, 1.0, np.uint8, 0),
    (40, 1024, 0.3, np.int16, 0),
    (3, 63_488, 1.0, np.int32, 0),
    (50, 128, 0.0, np.uint8, 0),
    (20, 128, 0.5, np.uint8, 7),   # counts past the kept units are zero
    (0, 128, 0.0, np.uint8, 0),
], ids=["sub1", "sub1_full", "sub8", "tile", "empty", "extra_counts",
        "no_units"])
def test_tiled_payload_to_flat_matches_jax(rng, n_units, cap, density, dtype,
                                          extra):
    pos, counts, xs, vals = _tiled(rng, n_units, cap, density, dtype, extra)
    ours = wire.TiledPayload(pos, counts, xs, vals)
    theirs = jax_wire.TiledPayload(pos, counts, xs, vals)
    for a, b in zip(ours.to_flat(), theirs.to_flat()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours.to_wire_bytes() == theirs.to_wire_bytes()
