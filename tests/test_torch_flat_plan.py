"""The launch plan of the port's one-pass compactions, K1's flat emission,
K2 and K3 (``csrc/lookback.cuh``), on the CPU: the tiles cover the input
once, the tiles' bands of the zero tail cover ``[pos, cap)`` once, the
scratch is never shared between two streams, and a host model of one
launch built on the plan writes every output slot exactly once and
equals the plain versions. K1's tiled emission folds ``pos`` into its one
launch: a host model of its per-stream words gives the plain version's
``pos`` in any finishing order of the blocks and leaves the words zero.
The plain versions are also held against the JAX package at the new
tiles' boundaries (Pallas in interpret mode). Tolerance is zero
throughout.

The kernels themselves are held against their plain versions on the card
by ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_frame_pair
from cudavideostream_tpu.ops import logcompact as jax_logcompact
from cudavideostream_tpu_torch.kernels import launch
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.runtime import wire

CSRC = Path(logcompact.__file__).resolve().parent.parent / "csrc"


def _constexpr(source, name):
    """The value of ``constexpr int name = ...;`` in ``csrc/source``, its
    expression's constants read from the same file."""
    text = re.sub(r"//[^\n]*", "", (CSRC / source).read_text())
    expr = re.search(rf"constexpr\s+int\s+{name}\s*=\s*([^;]+);",
                     text).group(1)
    names = set(re.findall(r"[A-Za-z_]\w*", expr))
    return eval(expr, {"__builtins__": {}},
                {k: _constexpr(source, k) for k in names})


FLAT_TILE = _constexpr("logcompact.cu", "kFlatTile")
PAIR_TILE = _constexpr("pair_compact.cu", "kPairTile")
VALS_TILE = _constexpr("pair_compact.cu", "kValsTile")
TILED_TILE = _constexpr("logcompact.cu", "kTileBytes")
DONE_SHIFT = _constexpr("logcompact.cu", "kDoneShift")
MASK_BYTES = 6_225_920  # K3's stream at 1080p: the mask geometry's n_pad


def _tail_band_statements():
    """The expressions of ``lo`` and ``hi`` in ``csrc/lookback.cuh:
    tail_band``, which both kernels call: ``lo = A; hi = B; if (hi > cap)
    hi = cap;``."""
    text = (CSRC / "lookback.cuh").read_text()
    start = text.index("void tail_band(")
    body = text[text.index("{", start) + 1:text.index("\n}\n", start)]
    m = re.fullmatch(r"\s*lo = ([^;]+);\s*hi = ([^;]+);\s*"
                     r"if \(hi > cap\) hi = cap;\s*", body)
    assert m, f"tail_band is no longer lo = ...; hi = ...; cut at cap:{body}"
    return compile(m.group(1), "lo", "eval"), compile(m.group(2), "hi", "eval")


_LO, _HI = _tail_band_statements()


def _tail_band(start, end, excl, count, n, cap):
    """The band ``[lo, hi)`` of the zero tail that tile ``[start, end)`` of
    ``n`` entries writes, given its exclusive prefix ``excl`` and its count
    (empty when ``lo >= hi``), from the kernels' own statements. At most
    ``n - end`` entries follow the tile, so every slot from ``excl + count
    + n - end`` on is past ``pos``; the band runs from there to its
    predecessor's bound, ``excl + n - start``, cut at ``cap``."""
    env = {"start": start, "end": end, "excl": excl, "count": count,
           "n": n, "cap": cap}
    return (eval(_LO, {"__builtins__": {}}, env),
            min(eval(_HI, {"__builtins__": {}}, env), cap))


def test_tile_sizes_read_from_the_kernels():
    assert FLAT_TILE == PAIR_TILE == 8_192
    assert VALS_TILE % 4_096 == 0 and VALS_TILE >= 8_192
    assert TILED_TILE == logcompact.TILE_BYTES == 4_096
    assert _tail_band(0, 16, 0, 3, 40, 40) == (27, 40)


@pytest.mark.parametrize("tile", [FLAT_TILE, PAIR_TILE, 64])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 8_191, 8_192, 8_193, 16_383,
                               16_384, 16_385, 6_220_800, 6_221_824,
                               99_532_800])
def test_flat_plan_tiles_cover_the_input_once(n, tile):
    for blocks in (1, 264, 396, 10_000):
        plan = logcompact.flat_plan(n, n, blocks, tile)
        # tile t holds [t * tile, min(n, (t + 1) * tile)): contiguous,
        # disjoint, the last one non-empty and reaching n
        assert (plan.tiles - 1) * tile < n <= plan.tiles * tile
        assert plan.grid == min(blocks, plan.tiles) >= 1
        assert plan.scratch_words == 2 + plan.tiles


@pytest.mark.parametrize("bad", [(0, 0, 1, 16), (10, 11, 1, 16),
                                 (10, -1, 1, 16), (10, 10, 0, 16),
                                 (10, 10, 1, 0)])
def test_flat_plan_refuses_what_no_launch_takes(bad):
    with pytest.raises(ValueError):
        logcompact.flat_plan(*bad)


def _bands(counts, n, cap, tile):
    """Each tile's tail band, from its count and exclusive prefix."""
    excl = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return [_tail_band(t * tile, min(n, (t + 1) * tile),
                       int(excl[t]), int(c), n, cap)
            for t, c in enumerate(counts)]


def _check_bands(counts, n, cap, tile):
    """The bands cover [pos, cap) once, no slot below pos, and each is
    as long as its tile's entries that do not ship (cut at cap)."""
    pos = int(sum(counts))
    cover = np.zeros(cap, np.int64)
    for t, (lo, hi) in enumerate(_bands(counts, n, cap, tile)):
        assert lo >= pos
        if lo < hi:
            cover[lo:hi] += 1
        if hi == lo + min(n, (t + 1) * tile) - t * tile - counts[t]:
            continue
        assert hi == cap  # only the cut at cap shortens a band
    want = np.zeros(cap, np.int64)
    want[min(pos, cap):] = 1
    np.testing.assert_array_equal(cover, want)


@pytest.mark.parametrize("seed", range(12))
def test_tail_bands_cover_the_tail_once(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        tile = int(rng.choice([1, 16, 64, 1000]))
        n = int(rng.integers(1, 5_000))
        sizes = np.diff(np.minimum(np.arange(0, n + tile, tile), n))
        density = rng.choice([0.0, 0.1, 0.9, 1.0])
        counts = rng.binomial(sizes, density)
        pos = int(counts.sum())
        # cap from 0 through pos (cap < pos: no tail) to n
        for cap in (0, n, pos, max(pos - 1, 0), min(pos + 1, n),
                    int(rng.integers(0, n + 1))):
            _check_bands(counts, n, cap, tile)


@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("n,tile", [(6_220_800, FLAT_TILE),
                                    (6_221_824, PAIR_TILE), (17, PAIR_TILE)])
def test_tail_bands_at_the_frame_sizes(n, tile, density):
    rng = np.random.default_rng([n, int(density * 10)])
    sizes = np.diff(np.minimum(np.arange(0, n + tile, tile), n))
    counts = rng.binomial(sizes, density)
    _check_bands(counts, n, n, tile)


VALS_EDGES = [1, 15, 16, 17, VALS_TILE - 1, VALS_TILE, VALS_TILE + 1,
              2 * VALS_TILE - 1, 2 * VALS_TILE + 1, MASK_BYTES]


@pytest.mark.parametrize("n", VALS_EDGES)
def test_vals_plan_tiles_cover_the_input_once(n):
    """K3's plan at its own tile, read from ``csrc/pair_compact.cu``."""
    for blocks in (1, 132, 528, 1_056):
        plan = logcompact.flat_plan(n, n, blocks, VALS_TILE)
        assert (plan.tiles - 1) * VALS_TILE < n <= plan.tiles * VALS_TILE
        assert plan.grid == min(blocks, plan.tiles) >= 1
        assert plan.scratch_words == 2 + plan.tiles
    if n == MASK_BYTES:
        assert plan.tiles == -(-MASK_BYTES // VALS_TILE)


@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("n", [1, 17, VALS_TILE - 1, VALS_TILE,
                               VALS_TILE + 1, MASK_BYTES])
def test_vals_tail_bands(n, density):
    """K3's tiles' bands of the zero tail cover ``[pos, n)`` once, at its
    tile's edges and at the mask geometry."""
    rng = np.random.default_rng([n, int(density * 10), 3])
    sizes = np.diff(np.minimum(np.arange(0, n + VALS_TILE, VALS_TILE), n))
    counts = rng.binomial(sizes, density)
    _check_bands(counts, n, n, VALS_TILE)


def test_flat_scratch_is_keyed_by_device_and_stream(monkeypatch):
    monkeypatch.setattr(launch, "_scratch", {})
    cpu = torch.device("cpu")
    a = logcompact.flat_scratch(cpu, 11, 100)
    b = logcompact.flat_scratch(cpu, 12, 100)
    assert a.dtype == b.dtype == torch.int64
    assert not a.any() and not b.any()
    # two streams: two buffers, no byte in common
    a0, a1 = a.data_ptr(), a.data_ptr() + a.numel() * 8
    b0, b1 = b.data_ptr(), b.data_ptr() + b.numel() * 8
    assert a1 <= b0 or b1 <= a0
    # one stream: one buffer, grown (zeroed) when a launch needs more
    assert logcompact.flat_scratch(cpu, 11, 50) is a
    big = logcompact.flat_scratch(cpu, 11, 50_000)
    assert big.numel() >= 50_000 and not big.any() and big is not a
    assert logcompact.flat_scratch(cpu, 12, 100) is b
    assert set(launch._scratch) == {(cpu, 11, "lookback"),
                                    (cpu, 12, "lookback")}


def _one_launch(keep, payload, n, cap, blocks, tile, rng):
    """A host model of one launch on the plan: blocks take tiles in
    ascending ticket order (which block gets which is random), and each
    writes its tile's kept entries at the tile's exclusive prefix plus
    their rank (only below cap) and its band of the zero tail. Returns the
    outputs and how often each slot was written."""
    plan = logcompact.flat_plan(n, cap, blocks, tile)
    counts = [int(keep[t * tile:(t + 1) * tile].sum())
              for t in range(plan.tiles)]
    excl = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    pos = int(sum(counts))
    out = [np.full(cap, -1, np.int64) for _ in payload]
    writes = np.zeros(cap, np.int64)
    holder = rng.integers(0, plan.grid, plan.tiles)  # the ticket's taker
    for b in range(plan.grid):
        for t in np.flatnonzero(holder == b):
            kept = np.flatnonzero(keep[t * tile:(t + 1) * tile]) + t * tile
            for r, i in enumerate(kept):
                o = excl[t] + r
                if o < cap:
                    for dst, src in zip(out, payload):
                        dst[o] = src[i]
                    writes[o] += 1
            lo, hi = _tail_band(t * tile, min(n, (t + 1) * tile),
                                int(excl[t]), counts[t], n, cap)
            if lo < hi:
                for dst in out:
                    dst[lo:hi] = 0
                writes[lo:hi] += 1
    return pos, out, writes


@pytest.mark.parametrize("tile,blocks", [(16, 1), (16, 3), (64, 7),
                                         (64, 1_000), (1_024, 2)])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
def test_one_launch_model_matches_pair_compact(tile, blocks, density):
    rng = np.random.default_rng([tile, blocks, int(density * 10)])
    n = int(rng.integers(1, 3_000))
    xs = rng.integers(0, 3, n).astype(np.int32)  # index 0 is a valid pair
    vals = np.where(rng.random(n) < density,
                    rng.integers(1, 255, n, endpoint=True), 0).astype(np.uint8)
    pos, (m_xs, m_vals), writes = _one_launch(vals != 0, (xs, vals), n, n,
                                              blocks, tile, rng)
    want = logcompact.pair_compact_reference(torch.from_numpy(xs),
                                             torch.from_numpy(vals))
    assert (writes == 1).all()
    assert pos == int(want[0])
    np.testing.assert_array_equal(m_xs, want[1].numpy())
    np.testing.assert_array_equal(m_vals, want[2].numpy())


@pytest.mark.parametrize("capacity", [0, 1, 100, 1_000, None])
@pytest.mark.parametrize("blocks", [1, 5, 64])
def test_one_launch_model_matches_flat_k1(capacity, blocks):
    rng = np.random.default_rng([blocks, capacity or 7])
    n = 2_000
    prev, cur = make_frame_pair(rng, n, change_frac=0.2)
    want = logcompact.fused_diff_compact_reference(
        torch.from_numpy(cur), torch.from_numpy(prev.copy()), 20, True,
        capacity=capacity)
    cap = n if capacity is None else capacity
    c, p = cur.astype(np.int32), prev.astype(np.int32)
    keep = np.abs(c - p) > 20
    pos, (m_xs, m_vals), writes = _one_launch(
        keep, (np.arange(n), (c - p) & 255), n, cap, blocks, 64, rng)
    assert (writes == 1).all()  # pos may pass cap: then no tail at all
    assert pos == int(want[0])
    np.testing.assert_array_equal(m_xs, want[1].numpy())
    np.testing.assert_array_equal(m_vals, want[2].numpy())


@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("n", [1, 15, 16, 17, VALS_TILE - 1, VALS_TILE,
                               VALS_TILE + 1, 2 * VALS_TILE + 1])
def test_one_launch_model_matches_vals_compact(n, density):
    """A host model of one K3 launch at its own tile and the grid of one
    SM's worth of blocks, against the plain version: every slot written
    once."""
    rng = np.random.default_rng([n, int(density * 10), 5])
    vals = np.where(rng.random(n) < density,
                    rng.integers(1, 255, n, endpoint=True), 0).astype(np.uint8)
    pos, (m_vals,), writes = _one_launch(vals != 0, (vals,), n, n, 4,
                                         VALS_TILE, rng)
    want = logcompact.vals_compact_reference(torch.from_numpy(vals))
    assert (writes == 1).all()
    assert pos == int(want[0])
    np.testing.assert_array_equal(m_vals, want[1].numpy())


@pytest.mark.parametrize("n", [16, 17, VALS_TILE - 1, VALS_TILE + 1])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_vals_compact_matches_jax_at_tile_boundaries(n, density):
    rng = np.random.default_rng([n, int(density * 100), 7])
    vals = np.where(rng.random(n) < density,
                    rng.integers(1, 255, n, endpoint=True), 0).astype(np.uint8)
    counts, vals_t = (np.asarray(a) for a in jax_logcompact._vals_compact(
        jnp.asarray(vals), interpret=True))
    want = np.concatenate([vals_t[t, :c] for t, c in enumerate(counts)])
    pos, got = logcompact.vals_compact(torch.from_numpy(vals))
    pos = int(pos)
    assert pos == want.size
    np.testing.assert_array_equal(got[:pos].numpy(), want)
    assert not got[pos:].any()


def _block_totals(keep, n_pad, unit_bytes):
    """The totals that K1's tiled blocks add to their stream's ``pos``
    word, in block order: one per 4096-byte tile when the unit divides the
    tile, else one per 4096-byte chunk of each unit."""
    m = np.zeros(n_pad, np.int64)
    m[:keep.size] = keep
    if TILED_TILE % unit_bytes == 0:
        m = np.concatenate([m, np.zeros(-n_pad % TILED_TILE, np.int64)])
        return m.reshape(-1, TILED_TILE).sum(1)
    per_unit = -(-unit_bytes // TILED_TILE)
    units = m.reshape(-1, unit_bytes)
    return np.array([units[u, c * TILED_TILE:(c + 1) * TILED_TILE].sum()
                     for u in range(units.shape[0])
                     for c in range(per_unit)])


def _folded_pos(totals, streams, rng):
    """A host model of ``add_stream_total``: the blocks (``totals``, one
    row a stream) finish in a random order, each adds ``(1 << kDoneShift)
    | total`` to its stream's word; the one that finds every other block
    of its stream counted writes ``pos`` and zeroes the word. Returns each
    stream's ``pos``, how often it was written, and the words after."""
    per_stream = totals.shape[1]
    words = [0] * streams
    pos, written = [None] * streams, [0] * streams
    for blk in rng.permutation(streams * per_stream):
        s, total = blk // per_stream, int(totals.flat[blk])
        old = words[s]
        words[s] = old + ((1 << DONE_SHIFT) | total)
        if old >> DONE_SHIFT == per_stream - 1:
            pos[s] = (old & ((1 << DONE_SHIFT) - 1)) + total
            written[s] += 1
            words[s] = 0
    return pos, written, words


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sub", [1, 8, 0])
@pytest.mark.parametrize("streams,offset", [(1, 0), (1, 3 * 4096 + 128),
                                            (4, 0)])
def test_folded_pos_in_any_finishing_order(streams, offset, sub, seed):
    """K1 tiled's ``pos``, summed from the blocks' totals in any order in
    which they finish, is the plain version's, at B = 1 (with and without
    an index offset, which moves no count) and B = 4; each stream's pos is
    written once, and the words are left zero for the next launch."""
    rng = np.random.default_rng([streams, offset, sub, seed])
    n = 64 * 48 * 3
    prev = rng.integers(0, 256, streams * n, dtype=np.uint8)
    cur = ((prev.astype(np.int32) + np.where(
        rng.random(streams * n) < 0.2, rng.integers(30, 200, streams * n),
        rng.integers(-15, 16, streams * n))) % 256).astype(np.uint8)
    if streams == 1:
        want = [int(logcompact.fused_diff_compact_tiled_reference(
            torch.from_numpy(cur), torch.from_numpy(prev.copy()), 20, True,
            None, sub, index_offset=offset)[0])]
    else:
        want = logcompact.fused_diff_compact_batched_reference(
            torch.from_numpy(cur), torch.from_numpy(prev.copy()), streams,
            20, True, sub_rows=sub)[0].tolist()
    n_pad, unit_bytes = logcompact.tiled_geometry(n, sub)
    keep = np.abs(cur.astype(np.int32) - prev.astype(np.int32)) > 20
    totals = np.stack([_block_totals(keep[b * n:(b + 1) * n], n_pad,
                                     unit_bytes) for b in range(streams)])
    assert totals.shape[1] > 1
    pos, written, words = _folded_pos(totals, streams, rng)
    assert pos == want and sum(want) > 0
    assert written == [1] * streams and words == [0] * streams


@pytest.mark.parametrize("n", [16, 17, PAIR_TILE - 1, PAIR_TILE + 1])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_pair_compact_matches_jax_at_tile_boundaries(n, density):
    rng = np.random.default_rng([n, int(density * 100)])
    xs = rng.integers(0, 3, n).astype(np.int32)
    vals = np.where(rng.random(n) < density,
                    rng.integers(1, 255, n, endpoint=True), 0).astype(np.uint8)
    counts, xs_t, vals_t = (np.asarray(a) for a in jax_logcompact._pair_compact(
        jnp.asarray(xs), jnp.asarray(vals), interpret=True))
    j_xs, j_vals = wire.TiledPayload(int(counts.sum()), counts, xs_t,
                                     vals_t).to_flat()
    pos, p_xs, p_vals = logcompact.pair_compact(torch.from_numpy(xs),
                                                torch.from_numpy(vals))
    pos = int(pos)
    assert pos == j_xs.size
    np.testing.assert_array_equal(p_xs[:pos].numpy(), j_xs)
    np.testing.assert_array_equal(p_vals[:pos].numpy(), j_vals)
    assert not p_xs[pos:].any() and not p_vals[pos:].any()


@pytest.mark.parametrize("n", [FLAT_TILE - 1, FLAT_TILE, FLAT_TILE + 1])
@pytest.mark.parametrize("overlay", [False, True])
def test_flat_matches_jax_at_tile_boundaries(n, overlay):
    rng = np.random.default_rng([n, int(overlay)])
    prev, cur = make_frame_pair(rng, n, change_frac=0.1)
    # a region that ends inside the tile's last 16-byte group
    region = (rng.integers(0, 255, FLAT_TILE - 9, endpoint=True,
                           dtype=np.uint8) if overlay else None)
    prev_t = torch.from_numpy(prev.copy())
    pos, xs, vals, new_prev = logcompact.fused_diff_compact(
        torch.from_numpy(cur), prev_t, 20, True,
        None if region is None else torch.from_numpy(region))
    j_pos, j_xs, j_vals, j_prev = (np.asarray(a) for a in
                                   jax_logcompact.fused_diff_compact(
        jnp.asarray(cur), jnp.asarray(prev), threshold=20,
        negative_feedback=True, interpret=True,
        overlay_region=None if region is None else jnp.asarray(region)))
    pos = int(pos)
    assert pos == int(j_pos)
    np.testing.assert_array_equal(xs[:pos].numpy(), j_xs[:pos])
    np.testing.assert_array_equal(vals[:pos].numpy(), j_vals[:pos])
    assert not xs[pos:].any() and not vals[pos:].any()
    np.testing.assert_array_equal(new_prev.numpy(), j_prev)


def _function_body(source, name):
    """The body of function ``name`` in ``csrc/source``, its comments
    stripped."""
    text = re.sub(r"//[^\n]*", "", (CSRC / source).read_text())
    start = re.search(rf"^\S[^\n]*\b{name}\(", text, re.M).start()
    return text[start:text.index("\n}\n", start)]


# the kernel each entry point launches once a call, and in how many
# instances it picks that one from
ONE_KERNEL = {
    "cvs_fused_diff_compact": ("flat_lookback_kernel", 2),
    "cvs_pair_compact": ("pair_lookback_kernel", 1),
    "cvs_fused_diff_compact_tiled": ("tiled_unit_kernel", 2),
    "cvs_vals_compact": ("vals_lookback_kernel", 1),
}


@pytest.mark.parametrize("source,name", [
    ("logcompact.cu", "cvs_fused_diff_compact"),
    ("pair_compact.cu", "cvs_pair_compact"),
    ("logcompact.cu", "cvs_fused_diff_compact_tiled"),
    ("pair_compact.cu", "cvs_vals_compact"),
])
def test_one_launch_per_call(source, name):
    """Each entry point launches one kernel per call (K1 flat picks one
    of two instances, with or without the map; K1 tiled, on the unit path
    that every served emission takes, one of two, with or without the
    index blocks) and zeroes nothing apart: no memset, no second kernel
    for the tail, the counts or ``pos``."""
    body = _function_body(source, name)
    kernel, instances = ONE_KERNEL[name]
    if name == "cvs_fused_diff_compact_tiled":
        # the unit branch goes to launch_tiled_unit, whose launches count
        unit = re.search(r"if \(unit\)\s*e = ([^;]+);", body)
        assert unit and "launch_tiled_unit<" in unit.group(1)
        assert "chunks" not in unit.group(1) and "<<<" not in body
        body = _function_body(source, "launch_tiled_unit")
    launches = re.findall(r"(\w+)(?:<[^<>]*>)?<<<", body)
    assert set(launches) == {kernel}
    assert len(launches) == instances
    if instances == 2:
        assert "if (" in body and "else" in body
    assert "Memset" not in body and "count_kernel" not in body
    # the second kernels of the two-pass designs (sum_kernel, K3's
    # count_kernel and vals_compact_kernel) are gone from the source
    code = re.sub(r"//[^\n]*", "", (CSRC / source).read_text())
    defined = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                             r"\([^)]*\)\s+)?(\w+)\(", code))
    assert defined == KERNELS[source]


KERNELS = {
    "logcompact.cu": {"flat_lookback_kernel", "tiled_unit_kernel",
                      "tiled_chunk_count_kernel",
                      "tiled_chunk_compact_kernel"},
    "pair_compact.cu": {"pair_lookback_kernel", "vals_lookback_kernel"},
}
