"""The launch plans of K5 (``csrc/segment_compact.cu``) and K7
(``csrc/probe.cu``), on the CPU.

K5: one thread-block cluster a tile; the CTAs' chunks cover each tile's
16-byte leaves once, round by round, for every unit the JAX tile geometry
gives; their pieces of the zero tail tile ``[count, unit_bytes)``; and a
host model of one cluster launch (each CTA's segment tree over its chunk,
the walks of its paths by shuffles and in shared memory, the counts of the
CTAs before it walked over
the cluster's own small tree, the staging on the output's 16-slot grid,
the 16-byte stores and their ragged ends, the rounds and the batched
streams at ``n % 16 != 0``) equals the plain version and the JAX package's
segment scheme, solo and batched, with every slot written once.

K7: the slices of the flattened values cover each tile once, split where
a tile ends; every SM's share at 720p, 1080p and 4K is within 10% of the
mean (and no cluster-a-tile plan of at most 16 CTAs could be); and a host
model of the partial sums and the last CTA's gather equals the plain
version and the JAX probe (interpret mode).

The constants and the statements that cut the work are read from the
kernels' own sources, and each launch is one kernel with no memset.
Tolerance is zero throughout. The kernels themselves are held against
their plain versions on the card by ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_frame_pair
from cudavideostream_tpu.ops import hist_pallas as jax_hist
from cudavideostream_tpu.ops import logcompact as jax_logcompact
from cudavideostream_tpu_torch.kernels import launch
from cudavideostream_tpu_torch.ops import hist
from cudavideostream_tpu_torch.ops import logcompact

CSRC = Path(hist.__file__).resolve().parent.parent / "csrc"
SMS = 132  # an H100 SXM's SMs


def _code(source):
    return re.sub(r"//[^\n]*", "", (CSRC / source).read_text())


def _constexpr(source, name):
    """The value of ``constexpr int name = ...;`` in ``csrc/source``, its
    expression's constants read from the same file."""
    expr = re.search(rf"constexpr\s+int\s+{name}\s*=\s*([^;]+);",
                     _code(source)).group(1)
    names = set(re.findall(r"[A-Za-z_]\w*", expr))
    return eval(expr.replace("/", "//"), {"__builtins__": {}},
                {k: _constexpr(source, k) for k in names})


def _expr(source, pattern):
    """The C expression a regex group of ``csrc/source`` captures, as
    Python: casts dropped, ``a.`` fields as names, integer division."""
    m = re.search(pattern, _code(source))
    assert m, f"{pattern!r} no longer matches csrc/{source}"
    e = m.group(1).replace("(long long)", "").replace("(int)", "")
    return compile(" ".join(e.replace("a.", "").replace("/", "//").split()),
                   source, "eval")


def _eval(code, **env):
    return eval(code, {"__builtins__": {}}, env)


CLUSTER = _constexpr("segment_compact.cu", "kCluster")
SEG_THREADS = _constexpr("segment_compact.cu", "kThreads")
THREAD_LEAVES = _constexpr("segment_compact.cu", "kThreadLeaves")
ROUND_LEAVES = _constexpr("segment_compact.cu", "kRoundLeaves")
STAGE_SLOTS = _constexpr("segment_compact.cu", "kStageSlots")
GROUP_BYTES = _constexpr("segment_compact.cu", "kGroupBytes")
PROBE_THREADS = _constexpr("probe.cu", "kThreads")
PROBE_PER_SM = _constexpr("probe.cu", "kCtasPerSm")
PROBE_BINS = _constexpr("probe.cu", "kBins")

_ROUNDS = _expr("segment_compact.cu", r"const int rounds = ([^;]+);")
_L0 = _expr("segment_compact.cu", r"const int l0 = ([^;]+);")
_L1 = _expr("segment_compact.cu", r"const int l1 = ([^;]+);")
_TAIL_LO = _expr("segment_compact.cu", r"const int lo = (base \+[^;]+);")
_TAIL_HI = _expr("segment_compact.cu", r"const int hi = (base \+[^;]+);")
_SLICE_START = _expr("probe.cu", r"slice_start\(const Args& a, int c\) "
                                 r"\{\s*return ([^;]+);")
_SLICE_OF = _expr("probe.cu", r"slice_of\(const Args& a, long long v\) "
                              r"\{\s*return ([^;]+);")


def test_constants_read_from_the_kernels():
    assert CLUSTER in (2, 4, 8) and SEG_THREADS % 32 == 0
    assert THREAD_LEAVES * CLUSTER == 16
    assert ROUND_LEAVES == SEG_THREADS * THREAD_LEAVES
    assert ROUND_LEAVES * 16 <= 65_536  # a staged offset fits 16 bits
    assert STAGE_SLOTS == ROUND_LEAVES * 16 + 16 and STAGE_SLOTS % 16 == 0
    assert GROUP_BYTES == 1024 and (GROUP_BYTES // 16) % CLUSTER == 0
    assert PROBE_BINS == hist.NBINS
    assert PROBE_PER_SM == hist.PROBE_CTAS_PER_SM
    assert PROBE_THREADS * PROBE_PER_SM <= 2048  # threads an SM holds


# -- K5: the plan -----------------------------------------------------------

def _chunks(unit, cluster=CLUSTER, round_leaves=None):
    """``[(q, r, l0, l1)]``: chunk ``(q, r)`` of a tile, leaves ``[l0,
    l1)``, from the kernel's statements, in the tile's order."""
    if round_leaves is None:
        round_leaves = SEG_THREADS * 16 // cluster
    leaves = unit // 16
    rounds = _eval(_ROUNDS, leaves=leaves, kCluster=cluster,
                   kRoundLeaves=round_leaves)
    return [(q, r,
             _eval(_L0, q=q, rank=r, leaves=leaves, kCluster=cluster,
                   rounds=rounds),
             _eval(_L1, q=q, rank=r, leaves=leaves, kCluster=cluster,
                   rounds=rounds))
            for q in range(rounds) for r in range(cluster)]


PLAN_SIZES = {"1000": 1000, "9233": 9233, "86405": 86_405,
              "200000": 200_000, "720p": 1280 * 720 * 3,
              "1080p": 1920 * 1080 * 3, "4K": 3840 * 2160 * 3,
              "134230073": 134_230_073}


@pytest.mark.parametrize("cluster", sorted({CLUSTER, 2, 4, 8}))
@pytest.mark.parametrize("size", list(PLAN_SIZES))
def test_segment_chunks_cover_each_tile_once(size, cluster):
    """For every unit the tile geometry gives (the plan alone: nothing is
    allocated), the chunks cover the tile's leaves once, in order (round
    by round, CTA by CTA), none longer than a CTA's round, their sizes
    within one leaf of each other."""
    n_pad, unit = logcompact.tiled_geometry(PLAN_SIZES[size], 0)
    assert unit % GROUP_BYTES == 0 and n_pad % unit == 0
    round_leaves = SEG_THREADS * 16 // cluster
    chunks = _chunks(unit, cluster)
    at = 0
    for _, _, l0, l1 in chunks:
        assert l0 == at and 0 < l1 - l0 <= round_leaves
        at = l1
    assert at == unit // 16
    sizes = [l1 - l0 for *_, l0, l1 in chunks]
    assert max(sizes) - min(sizes) <= 1
    rounds = len(chunks) // cluster
    if size == "1080p":
        assert (n_pad // unit, unit, rounds) == (98, 63_488, 1)
        assert sizes == [3968 // cluster] * cluster
    if size in ("720p", "4K"):
        assert (unit, rounds) == (61_440, 1)
    if size == "134230073" and cluster == CLUSTER:
        # the first frame size whose tile outgrows one round of a CTA
        assert (unit, rounds) == (67_584, 2)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("size", list(PLAN_SIZES))
def test_segment_tail_pieces_tile_the_zero_tail(size, seed):
    """The CTAs' pieces of the zero tail are disjoint, meet end to end and
    cover ``[count, unit_bytes)`` once, whatever the count."""
    rng = np.random.default_rng([PLAN_SIZES[size], seed])
    _, unit = logcompact.tiled_geometry(PLAN_SIZES[size], 0)
    count = [0, unit, 1, unit - 1, int(rng.integers(0, unit)),
             int(rng.binomial(unit, 0.06))][seed]
    end = count
    for rank in range(CLUSTER):
        env = dict(base=count, free_slots=unit - count, rank=rank,
                   kCluster=CLUSTER)
        lo, hi = _eval(_TAIL_LO, **env), _eval(_TAIL_HI, **env)
        assert lo == end and hi >= lo
        end = hi
    assert end == unit


# -- K5: a host model of one cluster launch --------------------------------

def _cluster_walk(roots, rank):
    """The top of a path: the counts of the CTAs before ``rank`` and the
    round's total, walked over the cluster's tree as each warp walks it
    with shuffles (``c`` the count of the aligned group holding a lane)."""
    c = list(roots)
    excl, s = 0, 1
    while s < len(c):
        if (rank // s) & 1:
            excl += c[max(0, (rank // s - 1) * s)]
        c = [c[i] + c[i ^ s] for i in range(len(c))]
        s *= 2
    return excl, c[0]


def _chunk_stage(ship, threads, tl):
    """One CTA's chunk (``ship``: its leaves' masks, ``(len, 16)``), as
    the kernel ranks it: warp ``w`` owns leaves ``[32 tl w, 32 tl (w +
    1))``, lane ``l`` leaf ``32 j + l`` of them; inside each group of 32
    leaves the walk by shuffles (a lane in the right half of a level adds
    the left half's count), then the levels joining the warp's groups,
    then the tree over the warps' nodes in heap order and each warp's walk
    to the root. Returns the chunk's count and each shipped byte's rank in
    the chunk, in byte order."""
    warps = threads // 32
    cnt = np.zeros(threads * tl, np.int64)
    cnt[:len(ship)] = ship.sum(axis=1)
    x = cnt.reshape(warps, tl, 32).copy()  # [warp, group j, lane]
    pre = np.zeros_like(x)
    lanes = np.arange(32)
    s = 1
    while s < 32:
        o = x[:, :, lanes ^ s]
        pre += np.where(lanes & s, o, 0)
        x = x + o
        s *= 2
    tot = x[:, :, 0]  # each group's count, in every lane
    w = 1
    while w < tl:  # the levels that join a warp's groups
        for j in range(tl):
            if (j // w) & 1:
                pre[:, j] += tot[:, (j // w - 1) * w:(j // w) * w].sum(
                    axis=1)[:, None]
        w *= 2
    tree = np.zeros(2 * warps, np.int64)
    tree[warps:] = tot.sum(axis=1)
    for k in range(warps - 1, 0, -1):
        tree[k] = tree[2 * k] + tree[2 * k + 1]
    node = warps + np.arange(warps)
    walk = np.zeros(warps, np.int64)
    while (node > 1).any():
        walk += np.where(node & 1, tree[np.maximum(node - 1, 0)], 0)
        node >>= 1
    leaf_base = (walk[:, None, None] + pre).reshape(-1)[:len(ship)]
    rank = leaf_base[:, None] + np.cumsum(ship, axis=1) - ship
    return int(tree[1]), rank[ship]


def _vector_writes(lo, hi, width, g0, writes):
    """The 16-byte stores of slots ``[lo, hi)`` in vectors of ``width``
    slots: a whole vector at once (its staged slots aligned, when ``g0`` is
    the staging's first slot), the ragged ends slot by slot; each slot's
    writes counted."""
    for x in range(lo // width, -(-hi // width)):
        a, b = max(width * x, lo), min(width * x + width, hi)
        if b - a == width and g0 is not None:
            assert (width * x - g0) % width == 0
            assert 0 <= width * x - g0 <= STAGE_SLOTS - width
        writes[a:b] += 1


def _segment_launch(cur, prev, thr, negfeed, region=None, tmap=None,
                    n_streams=1, threads=SEG_THREADS, cluster=CLUSTER):
    """A host model of one K5 launch over ``n_streams`` frames: for each
    tile, round by round, each CTA of its cluster ranks its chunk
    (:func:`_chunk_stage`), learns the counts before it
    (:func:`_cluster_walk`), stages its entries shifted to the output's
    16-slot grid and stores them; then each CTA its piece of the zero
    tail. Returns ``(counts, xs_t, vals_t, new_prev)`` and how often each
    xs and vals slot was written."""
    tl = 16 // cluster
    n = cur.size // n_streams
    n_pad, unit = logcompact.tiled_geometry(n, 0)
    ups = n_pad // unit
    strip = 0 if region is None else region.size // n_streams
    units = n_streams * ups
    counts = np.zeros(units, np.int32)
    xs_t = np.zeros((units, unit), np.int64)
    vals_t = np.zeros((units, unit), np.int64)
    writes = np.zeros((2, units, unit), np.int64)
    new_prev = prev.copy()
    for s in range(n_streams):
        c = cur[s * n:(s + 1) * n].astype(np.int64)
        p = prev[s * n:(s + 1) * n].astype(np.int64)
        if strip:
            c[:strip] = region[s * strip:(s + 1) * strip]
        t = thr if tmap is None else tmap.astype(np.int64)
        ship = np.zeros(n_pad, bool)
        ship[:n] = np.abs(c - p) > t
        delta = np.zeros(n_pad, np.int64)
        delta[:n] = (c - p) & 255
        new_prev[s * n:(s + 1) * n] = np.where(ship[:n] | (not negfeed), c,
                                               p)
        for u in range(ups):
            b, tile0 = s * ups + u, u * unit
            chunks = _chunks(unit, cluster, threads * tl)
            base = 0
            for q in range(len(chunks) // cluster):
                rnd = chunks[q * cluster:(q + 1) * cluster]
                staged = [_chunk_stage(ship[tile0 + 16 * l0:tile0 + 16 * l1]
                                       .reshape(-1, 16), threads, tl)
                          for _, _, l0, l1 in rnd]
                roots = [mine for mine, _ in staged]
                for (_, r, l0, l1), (mine, rank) in zip(rnd, staged):
                    excl, total = _cluster_walk(roots, r)
                    at = base + excl
                    shift = at & 15
                    stage = shift + rank  # staging slots, byte order
                    assert (np.diff(stage) == 1).all() and stage.size == mine
                    assert mine == 0 or stage[-1] < STAGE_SLOTS
                    idx = tile0 + 16 * l0 + np.flatnonzero(
                        ship[tile0 + 16 * l0:tile0 + 16 * l1])
                    g0 = at & ~15
                    xs_t[b, g0 + stage] = idx
                    vals_t[b, g0 + stage] = delta[idx]
                    _vector_writes(at, at + mine, 4, g0, writes[0, b])
                    _vector_writes(at, at + mine, 16, g0, writes[1, b])
                base += total
            for r in range(cluster):
                env = dict(base=base, free_slots=unit - base, rank=r,
                           kCluster=cluster)
                lo, hi = _eval(_TAIL_LO, **env), _eval(_TAIL_HI, **env)
                _vector_writes(lo, hi, 4, None, writes[0, b])
                _vector_writes(lo, hi, 16, None, writes[1, b])
            counts[b] = base
    return (counts, xs_t.astype(np.int32), vals_t.astype(np.uint8),
            new_prev.astype(np.uint8)), writes


def _reference(cur, prev, thr, negfeed, region=None, tmap=None):
    got = logcompact.segment_compact_reference(
        torch.from_numpy(cur), torch.from_numpy(prev.copy()), thr, negfeed,
        None if region is None else torch.from_numpy(region),
        None if tmap is None else torch.from_numpy(tmap))
    return [t.numpy() for t in got]


SEG_CASES = [(20, True, 0.06, False), (0, False, 0.3, False),
             (255, True, 1.0, False), (20, True, 0.0, False),
             (20, True, 0.06, True), (10, False, 1.0, True)]


@pytest.mark.parametrize("threads", [SEG_THREADS, 32])
@pytest.mark.parametrize("thr,negfeed,density,extras", SEG_CASES)
@pytest.mark.parametrize("n", [129, 1000, 9000, 12_345])
def test_segment_cluster_model_matches_reference(n, thr, negfeed, density,
                                                 extras, threads):
    """The model, in the kernel's rounds and in rounds of one warp (several
    rounds a tile: the running base across rounds), against the
    plain version, with the overlay region and a map where ``extras``:
    every slot written once."""
    rng = np.random.default_rng([n, thr, int(density * 10), threads])
    prev, cur = make_frame_pair(rng, n, change_frac=density)
    region = tmap = None
    if extras:
        region = rng.integers(0, 256, min(n, 700), dtype=np.uint8)
        tmap = rng.integers(0, 60, n, dtype=np.uint8)
    got, writes = _segment_launch(cur, prev, thr, negfeed, region, tmap,
                                  threads=threads)
    assert (writes == 1).all()
    for a, b in zip(got, _reference(cur, prev, thr, negfeed, region, tmap)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cluster", sorted({2, 4, 8} - {CLUSTER}))
def test_segment_cluster_model_other_cluster_sizes(cluster):
    """Clusters of the other sizes the plan allows give the same bytes."""
    rng = np.random.default_rng(cluster)
    prev, cur = make_frame_pair(rng, 86_405, change_frac=0.1)
    got, writes = _segment_launch(cur, prev, 20, True, cluster=cluster)
    assert (writes == 1).all()
    for a, b in zip(got, _reference(cur, prev, 20, True)):
        np.testing.assert_array_equal(a, b)


def test_segment_band_full_beside_band_empty():
    """One CTA's chunk ships every byte and the next none, and the
    reverse: the staging's longest run and the tail's widest piece."""
    _, unit = logcompact.tiled_geometry(9233, 0)
    band = unit // CLUSTER
    prev = np.random.default_rng(3).integers(0, 128, 9233, dtype=np.uint8)
    at = np.arange(9233) % unit
    for ships in (at < band, (at >= band) & (at < 2 * band)):
        cur = np.where(ships, prev + 128, prev).astype(np.uint8)
        got, writes = _segment_launch(cur, prev, 20, True)
        assert (writes == 1).all()
        assert got[0][0] == ships.sum()
        for a, b in zip(got, _reference(cur, prev, 20, True)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,extras", [(129, False), (9233, False),
                                      (12_345, True)])
def test_segment_cluster_model_matches_jax(n, extras):
    """The model against the JAX package's segment scheme
    (``fused_diff_compact(scheme="segment", emit="tiled")``, Pallas in
    interpret mode): counts, blocks and new_prev."""
    rng = np.random.default_rng(n)
    prev, cur = make_frame_pair(rng, n, change_frac=0.1)
    region = rng.integers(0, 256, 700, dtype=np.uint8) if extras else None
    tmap = rng.integers(0, 40, n, dtype=np.uint8) if extras else None
    (counts, xs_t, vals_t, new_prev), _ = _segment_launch(
        cur, prev, 20, True, region, tmap)
    j_pos, j_counts, j_xs, j_vals, j_prev = (
        np.asarray(a) for a in jax_logcompact.fused_diff_compact(
            jnp.asarray(cur), jnp.asarray(prev), interpret=True,
            scheme="segment", emit="tiled",
            overlay_region=None if region is None else jnp.asarray(region),
            threshold_map=None if tmap is None else jnp.asarray(tmap)))
    assert int(j_pos) == counts.sum() > 0
    np.testing.assert_array_equal(counts, j_counts)
    np.testing.assert_array_equal(xs_t, j_xs)
    np.testing.assert_array_equal(vals_t, j_vals)
    np.testing.assert_array_equal(new_prev, j_prev)


BATCHED = {"3x9216": (3, 9216), "2x9233": (2, 9233), "4x1000": (4, 1000),
           "2x51328": (2, 128 * 401)}


@pytest.mark.parametrize("use_map", [False, True], ids=["nomap", "map"])
@pytest.mark.parametrize("geom", list(BATCHED))
def test_segment_batched_model_matches_reference_and_jax(geom, use_map):
    """The model over B streams in one launch (stream-local indices, the
    shared map, streams at ``n % 16 != 0`` whose bytes are not 16-byte
    aligned) against the batched plain version and the JAX package's
    ``fused_diff_compact_batched(scheme="segment")`` (interpret mode)."""
    b, n = BATCHED[geom]
    rng = np.random.default_rng([b, n, use_map])
    pairs = [make_frame_pair(rng, n, change_frac=0.1) for _ in range(b)]
    prev = np.concatenate([p for p, _ in pairs])
    cur = np.concatenate([c for _, c in pairs])
    tmap = rng.integers(0, 40, n, dtype=np.uint8) if use_map else None
    (counts, xs_t, vals_t, new_prev), writes = _segment_launch(
        cur, prev, 20, True, tmap=tmap, n_streams=b)
    assert (writes == 1).all()
    n_pad, unit = logcompact.tiled_geometry(n, 0)
    ups = n_pad // unit
    counts = counts.reshape(b, ups)
    want = logcompact.fused_diff_compact_batched_reference(
        torch.from_numpy(cur), torch.from_numpy(prev.copy()), b,
        scheme="segment",
        threshold_map=None if tmap is None else torch.from_numpy(tmap))
    j = jax_logcompact.fused_diff_compact_batched(
        jnp.asarray(cur), jnp.asarray(prev), n_streams=b, interpret=True,
        scheme="segment",
        threshold_map=None if tmap is None else jnp.asarray(tmap))
    for w in ([t.numpy() for t in want], [np.asarray(a) for a in j]):
        np.testing.assert_array_equal(counts.sum(axis=1), w[0])
        np.testing.assert_array_equal(counts, w[1])
        np.testing.assert_array_equal(xs_t.reshape(b, ups, unit), w[2])
        np.testing.assert_array_equal(vals_t.reshape(b, ups, unit), w[3])
        np.testing.assert_array_equal(new_prev, w[4])


def test_segment_batched_overlay_strips():
    """Per-stream overlay strips (strip s for stream s) at ``n % 16 != 0``
    against the batched plain version."""
    b, n = 3, 9233
    rng = np.random.default_rng(11)
    pairs = [make_frame_pair(rng, n, change_frac=0.1) for _ in range(b)]
    prev = np.concatenate([p for p, _ in pairs])
    cur = np.concatenate([c for _, c in pairs])
    region = rng.integers(0, 256, b * 701, dtype=np.uint8)
    got, writes = _segment_launch(cur, prev, 20, True, region, n_streams=b)
    assert (writes == 1).all()
    want = logcompact.fused_diff_compact_batched_reference(
        torch.from_numpy(cur), torch.from_numpy(prev.copy()), b,
        scheme="segment", overlay_region=torch.from_numpy(region))
    np.testing.assert_array_equal(got[1].reshape(want[2].shape),
                                  want[2].numpy())
    np.testing.assert_array_equal(got[2].reshape(want[3].shape),
                                  want[3].numpy())
    np.testing.assert_array_equal(got[3], want[4].numpy())


# -- K7 ---------------------------------------------------------------------

def _probe_geometry(rows):
    tile = hist.probe_tile(rows)
    return rows // tile, tile * 128 // 4  # tiles, vectors a tile


def _slices(tiles, sms=SMS):
    return hist.probe_slices(tiles, sms)


GRIDS = {"8 rows": 8, "360 rows": 360, "480 rows": 480, "1000 rows": 1000,
         "1001 rows": 1001, "720p": 7200, "1080p": 16_200, "4K": 64_800,
         "8K": 259_200, "thousands of tiles": 8 * 3001}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_probe_slices_cover_each_tile_once(grid):
    """Slice c is ``[c V // S, (c + 1) V // S)`` of the ``V`` vectors of
    the whole tiles; no slice is longer than a tile, so each touches at
    most two; each tile's vectors lie in its slices once, split at the
    tile's end; ``slice_of`` finds the slice of every vector. Rows past the
    last whole tile are never read."""
    tiles, tv = _probe_geometry(GRIDS[grid])
    s = _slices(tiles)
    assert s >= tiles and s % (PROBE_PER_SM * SMS) == 0
    assert s < tiles + PROBE_PER_SM * SMS  # the fewest whole waves
    vecs = tiles * tv
    start = [_eval(_SLICE_START, c=c, vecs=vecs, slices=s)
             for c in range(s + 1)]
    assert start[0] == 0 and start[-1] == vecs
    assert all(0 <= b - a <= tv for a, b in zip(start, start[1:]))
    seen = np.zeros(vecs, np.int64)
    for c in range(s):
        t0 = start[c] // tv
        split = min(start[c + 1], (t0 + 1) * tv)
        seen[start[c]:split] += 1
        seen[split:start[c + 1]] += 1
        assert start[c + 1] <= (t0 + 2) * tv  # at most two tiles
    np.testing.assert_array_equal(seen, 1)
    probe = np.unique(np.concatenate([np.array(start[:-1]),
                                      np.array(start[1:]) - 1,
                                      np.arange(0, vecs, max(1, vecs // 97))]))
    for v in probe[(probe >= 0) & (probe < vecs)]:
        c = _eval(_SLICE_OF, v=int(v), vecs=vecs, slices=s)
        assert start[c] <= v < start[c + 1]
    if grid == "1080p":
        assert (tiles, tv * 4, s) == (45, 46_080, 264)


@pytest.mark.parametrize("grid", ["720p", "1080p", "4K"])
def test_probe_every_sm_an_equal_share(grid):
    """The slices run kCtasPerSm an SM in whole waves: the busiest SM's
    values are within 10% of the mean (here within one vector a slice).
    No plan of one portable cluster (at most 8 CTAs) a tile could do that,
    nor at 720p one of up to 16: the busiest SM of the best is 10% over
    the mean or more."""
    tiles, tv = _probe_geometry(GRIDS[grid])
    s = _slices(tiles)
    vecs = tiles * tv
    start = np.array([_eval(_SLICE_START, c=c, vecs=vecs, slices=s)
                      for c in range(s + 1)])
    sizes = np.diff(start) * 4
    share = np.zeros(SMS, np.int64)
    np.add.at(share, np.arange(s) % SMS, sizes)  # a wave a slice each
    mean = vecs * 4 / SMS
    assert share.max() <= 1.1 * mean
    assert share.max() - share.min() <= 4 * (s // SMS)
    largest = 16 if grid == "720p" else 8
    best = min(-(-tiles * c // SMS) * (tv * 4 / c)
               for c in range(1, largest + 1))
    assert best >= 1.1 * mean - 1e-9


def _probe_launch(g2, sms=SMS):
    """A host model of one K7 launch: each slice's two partial sums (the
    256 compares per value, the vectors before the split into the first,
    the rest into the second), then the last CTA's gather of each tile's
    partials from the slices over it. Returns the checksums."""
    tiles, tv = _probe_geometry(g2.shape[0])
    s = _slices(tiles, sms)
    vecs = tiles * tv
    g = g2[:tiles * tv * 4 // 128].astype(np.int64).reshape(vecs, 4)
    per_vec = np.zeros(vecs, np.int64)
    for b in range(PROBE_BINS):
        per_vec += (g == b).sum(axis=1)
    part = np.full((s, 2), -1, np.int64)
    start = [_eval(_SLICE_START, c=c, vecs=vecs, slices=s)
             for c in range(s + 1)]
    for c in range(s):
        t0 = start[c] // tv
        split = min(start[c + 1], (t0 + 1) * tv)
        part[c] = (per_vec[start[c]:split].sum(),
                   per_vec[split:start[c + 1]].sum())
    out = np.zeros(tiles, np.int32)
    for t in range(tiles):
        ca = _eval(_SLICE_OF, v=t * tv, vecs=vecs, slices=s)
        cb = _eval(_SLICE_OF, v=t * tv + tv - 1, vecs=vecs, slices=s)
        out[t] = sum(part[k, 0 if start[k] // tv == t else 1]
                     for k in range(ca, cb + 1))
    return out


@pytest.mark.parametrize("sms", [SMS, 3])
@pytest.mark.parametrize("rows,lo,hi", [(8, 0, 256), (360, -300, 600),
                                        (1000, 0, 256), (1001, -50, 300),
                                        (7200, 0, 256)])
def test_probe_model_matches_reference(rows, lo, hi, sms):
    """The model, on an H100's plan and on a 3-SM one (slices over many
    tiles' boundaries), against the plain version."""
    rng = np.random.default_rng([rows, sms])
    g2 = rng.integers(lo, hi, (rows, 128)).astype(np.int32)
    np.testing.assert_array_equal(
        _probe_launch(g2, sms),
        hist.vpu_probe_reference(torch.from_numpy(g2)).numpy())


@pytest.mark.parametrize("rows", [8, 64, 200, 1001])
def test_probe_model_matches_jax(rows):
    """The model against the JAX probe (``vpu_probe(interpret=True)``),
    out-of-range values included."""
    rng = np.random.default_rng(rows)
    g2 = rng.integers(-100, 400, (rows, 128)).astype(np.int32)
    want = np.asarray(jax_hist.vpu_probe(jnp.asarray(g2), interpret=True))
    np.testing.assert_array_equal(_probe_launch(g2), want.reshape(-1))


def test_probe_slices_rejects_nothing_to_do():
    for bad in ((0, SMS), (45, 0)):
        with pytest.raises(ValueError):
            hist.probe_slices(*bad)


def test_probe_scratch_is_keyed_by_device_and_stream(monkeypatch):
    monkeypatch.setattr(launch, "_scratch", {})
    cpu = torch.device("cpu")
    a = hist.probe_scratch(cpu, 5)
    b = hist.probe_scratch(cpu, 6)
    assert a.dtype == b.dtype == torch.int32 and a.numel() == b.numel() == 1
    assert int(a) == int(b) == 0 and a.data_ptr() != b.data_ptr()
    assert hist.probe_scratch(cpu, 5) is a
    assert set(launch._scratch) == {(cpu, 5, "probe"), (cpu, 6, "probe")}


# -- both: one launch, no memset, independent sources ------------------------

def _body(code, signature):
    body = code[code.index(signature):]
    return body[:body.index("\n}\n")]


def _kernels(code):
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                          r"\([^)]*\)\s+)?(\w+)\(", code))


def _includes(code):
    return re.findall(r'#include\s+[<"]([^>"]+)[>"]', code)


def test_segment_is_one_cluster_launch():
    """``cvs_segment_compact`` launches ``segment_kernel`` once, as a
    cluster launch, zeroes nothing apart, and the source includes nothing
    of the other compactions (it stays an independent derivation)."""
    code = _code("segment_compact.cu")
    body = _body(code, "int cvs_segment_compact(")
    assert re.findall(r"cudaLaunchKernelEx\(&cfg, (\w+),", body) == [
        "segment_kernel"]
    assert "<<<" not in code and "Memset" not in code
    assert "cudaLaunchAttributeClusterDimension" in code
    assert _kernels(code) == {"segment_kernel"}
    assert not any(("lookback" in h or "logcompact" in h
                    or "register_compact" in h or "pair_compact" in h)
                   for h in _includes(code))
    for other in ("register_compact.cu", "logcompact.cu", "lookback.cuh"):
        names = set(re.findall(r"__device__\s+__forceinline__\s+\w+\s+"
                               r"(\w+)\(", _code(other)))
        assert not names & set(re.findall(r"\b(\w+)\(", code)), other


def test_probe_is_one_launch_without_atomics_into_out():
    """``cvs_vpu_probe`` launches ``probe_kernel`` once and zeroes nothing;
    ``out`` takes plain stores only, one a tile (the only atomic is the
    per-stream count of finished slices); the source includes none of the
    compactions."""
    code = _code("probe.cu")
    body = _body(code, "int cvs_vpu_probe(")
    assert re.findall(r"(\w+)<<<", body) == ["probe_kernel"]
    assert "Memset" not in code and _kernels(code) == {"probe_kernel"}
    assert re.findall(r"a\.out\[[^]]+\]\s*=", code) == ["a.out[t] ="]
    assert "atomicAdd" not in code and "atomicExch" not in code
    assert code.count("fetch_add(") == 1 and "done(*a.done)" in code
    assert not any(("compact" in h or "lookback" in h or "histogram" in h)
                   for h in _includes(code))
