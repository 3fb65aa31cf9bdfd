"""The launch plans of K4 (``csrc/histogram.cu``) and K6
(``csrc/register_compact.cu``), on the CPU: K4's blocks read every byte
once, and a host model of its per-block sums, merged through the
per-stream scratch by whichever block finishes last, equals the plain
version and the JAX package's Pallas kernel (interpret mode) and leaves
the scratch zero. K6's CTA bands cover each tile's vectors once for every
unit the JAX tile geometry gives, their bands of the zero tail tile
``[count, unit_bytes)``, and a host model of one cluster launch (the warp
ballots' ranks, the rounds, the offset passed between the CTAs) equals
the plain version and the JAX register scheme. The constants and the
band statements are read from the kernels' own sources. Tolerance is
zero throughout.

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
from cudavideostream_tpu.ops.hist_pallas import pallas_histogram
from cudavideostream_tpu_torch.ops import hist
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.ops import register_compact

CSRC = Path(hist.__file__).resolve().parent.parent / "csrc"


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


HIST_THREADS = _constexpr("histogram.cu", "kThreads")
HIST_BINS = _constexpr("histogram.cu", "kBins")
HIST_SCRATCH = _constexpr("histogram.cu", "kScratchWords")
CLUSTER = _constexpr("register_compact.cu", "kCluster")
REG_THREADS = _constexpr("register_compact.cu", "kThreads")
REG_VEC = _constexpr("register_compact.cu", "kVec")
ROUND_VECS = _constexpr("register_compact.cu", "kRoundVecs")
GROUP_BYTES = _constexpr("register_compact.cu", "kGroupBytes")
SMS = 132  # an H100 SXM's SMs


def test_constants_read_from_the_kernels():
    assert (HIST_THREADS, HIST_BINS) == (hist.HIST_THREADS, hist.NBINS)
    assert HIST_SCRATCH == HIST_BINS + 1  # the sums, then the done count
    assert HIST_SCRATCH == hist.HIST_SCRATCH_WORDS
    assert CLUSTER in (2, 4, 8) and REG_THREADS % 32 == 0
    assert REG_VEC * (REG_THREADS // 32) <= 32  # one warp scans the totals
    assert ROUND_VECS == REG_THREADS * REG_VEC and ROUND_VECS * 16 <= 65_536
    assert GROUP_BYTES == 1024


# -- K4 -------------------------------------------------------------------

def _hist_reads(n, grid):
    """How often K4's launch of ``grid`` blocks reads each byte: block
    ``b``'s thread ``t`` reads vector ``b * T + t`` and every ``grid * T``
    further, below ``n // 16``; block 0's first ``n % 16`` threads read
    one byte of the ragged tail each."""
    n16 = n // 16
    stride = grid * HIST_THREADS
    first = np.arange(stride)  # block first // T, thread first % T
    vec = first[:, None] + stride * np.arange(-(-n16 // stride))[None, :]
    vectors = np.zeros(n16, np.int64)
    np.add.at(vectors, vec[vec < n16], 1)
    reads = np.concatenate([np.repeat(vectors, 16), np.zeros(n % 16,
                                                             np.int64)])
    tail = n - n16 * 16
    assert tail < 16 <= HIST_THREADS
    reads[n16 * 16:] += 1
    return reads


BLOCK = HIST_THREADS * 16
HIST_EDGES = (list(range(1, 18)) + [BLOCK - 1, BLOCK, BLOCK + 1,
                                    SMS * BLOCK - 1, SMS * BLOCK,
                                    SMS * BLOCK + 1, 2_073_599, 2_073_601])


@pytest.mark.parametrize("n", HIST_EDGES)
def test_hist_plan_reads_every_byte_once(n):
    for sms in (1, 7, SMS):
        grid = hist.hist_plan(n, sms)
        assert 1 <= grid <= sms
        # no block without a vector to read, bar block 0 of a short input
        assert grid == 1 or (grid - 1) * HIST_THREADS < n // 16
        if n // 16 >= sms * HIST_THREADS:
            assert grid == sms  # a block on every SM
        np.testing.assert_array_equal(_hist_reads(n, grid), 1)


def test_hist_plan_at_1080p_and_its_shards():
    npx = 1920 * 1080
    assert hist.hist_plan(npx, SMS) == 127  # one vector a thread
    assert hist.hist_plan(npx // 4, SMS) == 32
    assert hist.hist_plan(npx // 8, SMS) == 16
    assert hist.hist_plan((1 << 31) - 1, SMS) == SMS
    for bad in ((0, SMS), (16, 0)):
        with pytest.raises(ValueError):
            hist.hist_plan(*bad)


def _add_vector(bins, words):
    """``add_vector``: a vector of sixteen equal bytes adds 16 once, and
    a word of four equal bytes adds 4 once."""
    b = [(int(w) >> (8 * k)) & 255 for w in words for k in range(4)]
    if len(set(b)) == 1:
        bins[b[0]] += 16
        return
    for w in range(4):
        if len(set(b[4 * w:4 * w + 4])) == 1:
            bins[b[4 * w]] += 4
        else:
            for v in b[4 * w:4 * w + 4]:
                bins[v] += 1


def _hist_launch(g, grid, rng, scratch):
    """A host model of one K4 launch: each block's warps count their
    threads' vectors (as 32-bit words) into their own bins, the block adds
    its summed bins to ``scratch``, then its done count; the blocks finish
    in a random order, and the one that finds every other block counted
    swaps the sums out into ``out``. Returns ``out``, written once."""
    n = g.size
    n16 = n // 16
    words = np.frombuffer(g[:n16 * 16].tobytes(), dtype="<u4")
    stride = grid * HIST_THREADS
    partial = np.zeros((grid, HIST_BINS), np.int64)
    for b in range(grid):
        warps = np.zeros((HIST_THREADS // 32, HIST_BINS), np.int64)
        for t in range(HIST_THREADS):
            for vec in range(b * HIST_THREADS + t, n16, stride):
                _add_vector(warps[t // 32], words[vec * 4:vec * 4 + 4])
            if b == 0 and n16 * 16 + t < n:
                warps[t // 32][g[n16 * 16 + t]] += 1
        partial[b] = warps.sum(axis=0)
    out, written = None, 0
    for b in rng.permutation(grid):
        scratch[:HIST_BINS] += partial[b]
        done = scratch[HIST_BINS]
        scratch[HIST_BINS] += 1
        if done == grid - 1:
            out, written = scratch[:HIST_BINS].copy(), written + 1
            scratch[:] = 0
    assert written == 1
    return out


@pytest.mark.parametrize("kind", ["random", "one value", "0 and 255"])
@pytest.mark.parametrize("n,sms", [(1, SMS), (17, SMS), (BLOCK + 1, SMS),
                                   (3 * BLOCK + 5, 2), (5 * BLOCK - 1, 3)])
def test_hist_merge_model_matches_reference(n, sms, kind):
    rng = np.random.default_rng([n, sms])
    g = {"random": rng.integers(0, 256, n, dtype=np.uint8),
         "one value": np.full(n, 137, np.uint8),
         "0 and 255": np.where(rng.random(n) < 0.5, 0, 255).astype(
             np.uint8)}[kind]
    scratch = np.zeros(HIST_SCRATCH, np.int64)
    grid = hist.hist_plan(n, sms)
    for _ in range(2):  # the second launch finds the scratch zero again
        got = _hist_launch(g, grid, rng, scratch)
        assert not scratch.any()
        np.testing.assert_array_equal(
            got, hist.histogram_reference(torch.from_numpy(g)).numpy())


@pytest.mark.parametrize("rows", [16, 64, 200])
def test_hist_merge_model_matches_pallas(rows):
    """The model against the JAX package's kernel on an (M, 128) grid of
    gray values (M a multiple of 8: its tiles read every row)."""
    rng = np.random.default_rng(rows)
    g = rng.integers(0, 256, rows * 128, dtype=np.uint8)
    g[: rows * 32] = 77  # a flat region: vectors of sixteen equal bytes
    g[rows * 32:rows * 32 + 8] = 78  # a word of four equal bytes
    want = np.asarray(pallas_histogram(
        jnp.asarray(g.astype(np.int32).reshape(rows, 128)), interpret=True))
    scratch = np.zeros(HIST_SCRATCH, np.int64)
    got = _hist_launch(g, hist.hist_plan(g.size, 3), rng, scratch)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        hist.histogram(torch.from_numpy(g)).numpy(), want)


def test_hist_scratch_is_keyed_by_device_and_stream(monkeypatch):
    monkeypatch.setattr(hist, "_scratch", {})
    cpu = torch.device("cpu")
    a = hist.hist_scratch(cpu, 11)
    b = hist.hist_scratch(cpu, 12)
    assert a.dtype == b.dtype == torch.int32
    assert a.numel() == b.numel() == HIST_SCRATCH
    assert not a.any() and not b.any()
    a0, a1 = a.data_ptr(), a.data_ptr() + a.numel() * 4
    b0, b1 = b.data_ptr(), b.data_ptr() + b.numel() * 4
    assert a1 <= b0 or b1 <= a0
    assert hist.hist_scratch(cpu, 11) is a
    assert set(hist._scratch) == {(cpu, 11), (cpu, 12)}


def test_hist_is_one_launch():
    """``cvs_histogram`` launches ``hist_kernel`` once and zeroes nothing
    apart: no memset, no second kernel."""
    code = _code("histogram.cu")
    body = code[code.index("int cvs_histogram("):]
    body = body[:body.index("\n}\n")]
    assert re.findall(r"(\w+)<<<", body) == ["hist_kernel"]
    assert "Memset" not in code
    assert set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                          r"\([^)]*\)\s+)?(\w+)\(", code)) == {"hist_kernel"}


# -- K6 -------------------------------------------------------------------

def _kernel_statements():
    """The band and tail-band statements of ``register_kernel``:
    ``band0 = A, band1 = B;`` and ``lo = C;`` ``hi = D;``."""
    code = _code("register_compact.cu")
    band = re.search(r"const int band0 = ([^,]+), band1 = ([^;]+);", code)
    lo = re.search(r"const long long lo = ([^;]+);", code)
    hi = re.search(r"const long long hi = ([^;]+);", code)
    assert band and lo and hi, "the band statements of register_kernel moved"
    # C's int division and casts, in Python
    return [compile(e.replace("(long long)", "").replace("/", "//"), "k6",
                    "eval")
            for e in (band.group(1), band.group(2), lo.group(1),
                      hi.group(1))]


_BAND0, _BAND1, _LO, _HI = _kernel_statements()


def _bands(unit_bytes, cluster=CLUSTER):
    """Each CTA's band of the tile's 16-byte vectors, ``[band0, band1)``,
    from the kernel's statement."""
    out = []
    for rank in range(cluster):
        env = {"rank": rank, "vecs": unit_bytes // 16, "kCluster": cluster}
        band0 = eval(_BAND0, {"__builtins__": {}}, env)
        out.append((band0, eval(_BAND1, {"__builtins__": {}},
                                {**env, "band0": band0})))
    return out


def _tail_band(total, band0, band1, excl, mine):
    env = {"total": total, "band0": band0, "band1": band1, "excl": excl,
           "mine": mine}
    return (eval(_LO, {"__builtins__": {}}, env),
            eval(_HI, {"__builtins__": {}}, env))


SIZES = [1, 15, 129, 1024, 1025, 9000, 12_345, 86_400, 200_000, 1_000_003,
         6_220_800, (1 << 27) + 12_345, 1 << 30]


@pytest.mark.parametrize("cluster", sorted({CLUSTER, 4, 8}))
@pytest.mark.parametrize("n", SIZES)
def test_register_bands_cover_each_tile_once(n, cluster):
    """For every unit the tile geometry gives (a multiple of 1,024 B,
    down to the 1,024-byte unit of 8 rows, which a cluster cannot split
    into one 8-row group a CTA), the CTAs' bands are equal, not empty,
    and cover the unit's vectors once; a band longer than one round is
    walked in rounds that cover it once."""
    n_pad, unit = logcompact.tiled_geometry(n, 0)
    assert unit % GROUP_BYTES == 0 and n_pad % unit == 0
    bands = _bands(unit, cluster)
    cover = np.zeros(unit // 16, np.int64)
    for band0, band1 in bands:
        assert band1 - band0 == unit // 16 // cluster > 0
        cover[band0:band1] += 1
        rounds = -(-(band1 - band0) // ROUND_VECS)
        seen = np.zeros(band1 - band0, np.int64)
        for q in range(rounds):
            seen[q * ROUND_VECS:min(band1 - band0, (q + 1) * ROUND_VECS)] += 1
        np.testing.assert_array_equal(seen, 1)
    np.testing.assert_array_equal(cover, 1)
    if n == 6_220_800:
        assert (n_pad // unit, unit) == (98, 63_488)
        assert bands[0][1] - bands[0][0] <= ROUND_VECS  # one round a CTA


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("n", [129, 9000, 12_345, 200_000, 6_220_800])
def test_register_tail_bands_tile_the_zero_tail(n, seed):
    """The CTAs' bands of the tile's zero tail are disjoint, meet end to
    end, cover ``[count, unit_bytes)`` once and add up to ``unit_bytes -
    count``; each CTA writes as many slots (entries and zeros) as it has
    bytes."""
    rng = np.random.default_rng([n, seed])
    _, unit = logcompact.tiled_geometry(n, 0)
    bands = _bands(unit)
    density = (0.0, 0.06, 0.5, 1.0)[seed % 4]
    counts = [int(rng.binomial((b1 - b0) * 16, density)) for b0, b1 in bands]
    if seed == 5:  # the first band ships everything, the next nothing
        counts = [(bands[0][1] - bands[0][0]) * 16] + [0] * (len(bands) - 1)
    total = sum(counts)
    cover = np.zeros(unit, np.int64)
    excl, end = 0, total
    for (band0, band1), mine in zip(bands, counts):
        lo, hi = _tail_band(total, band0, band1, excl, mine)
        assert lo == end  # meets the previous band
        assert hi - lo == (band1 - band0) * 16 - mine
        cover[excl:excl + mine] += 1  # its entries
        cover[lo:hi] += 1
        excl, end = excl + mine, hi
    assert end == unit
    np.testing.assert_array_equal(cover, 1)


@pytest.mark.parametrize("cnt_seed", range(6))
def test_ballot_prefix_is_the_exclusive_scan(cnt_seed):
    """A warp's ranks as ``rank_round`` builds them: for each bit of the
    lanes' counts (0..16) a ballot, the popcount of the ballot below the
    lane shifted by the bit, summed; the total likewise."""
    rng = np.random.default_rng(cnt_seed)
    cnt = rng.integers(0, 17, 32)
    if cnt_seed == 0:
        cnt[:] = 16
    lanes = np.arange(32)
    pre = np.zeros(32, np.int64)
    tot = 0
    for bit in range(5):
        ballot = (cnt >> bit) & 1
        pre += np.array([ballot[:lane].sum() for lane in lanes]) << bit
        tot += int(ballot.sum()) << bit
    np.testing.assert_array_equal(pre, np.cumsum(cnt) - cnt)
    assert tot == cnt.sum()


def test_bits4_packs_each_byte_top_bit():
    """``bits4``, read from the source: bit k of its result is the top
    bit of byte k of a byte-SIMD compare result."""
    code = _code("register_compact.cu")
    expr = re.search(r"unsigned bits4\(unsigned s\) \{\s*return ([^;]+);",
                     code).group(1)
    fn = compile(re.sub(r"(0x[0-9a-fA-F]+|\d+)u", r"\1", expr), "bits4",
                 "eval")
    for k in range(16):
        s = sum(0xFF << (8 * j) for j in range(4) if k >> j & 1)
        assert eval(fn, {"__builtins__": {}}, {"s": s}) == k
        assert eval(fn, {"__builtins__": {}}, {"s": s & 0x80808080}) == k


def _rank_round(ship, v0, v1, threads, vec):
    """``rank_round`` on the band's vectors ``[v0, v1)`` (``ship``: the
    band's bytes, 16 a vector): thread t takes vectors ``v0 + k * threads
    + t`` for k < vec; a lane's rank in its warp is the ballot prefix of
    the lanes' counts, a warp's offset the scan of the warps' totals in
    (k, warp) order; byte j of a vector goes after the vector's shipped
    bytes below it. Returns the round's entries (band byte offsets) in
    slot order."""
    warps = threads // 32
    m = np.zeros((vec, threads, 16), bool)
    for k in range(vec):
        for t in range(threads):
            v = v0 + k * threads + t
            if v < v1:
                m[k, t] = ship[v * 16:(v + 1) * 16]
    cnt = m.sum(axis=2)
    lanes = cnt.reshape(vec, warps, 32)
    pre = np.zeros_like(lanes)
    tot = np.zeros((vec, warps), np.int64)
    for bit in range(5):  # one ballot a bit of the counts (0..16)
        ballot = (lanes >> bit) & 1
        pre += (np.cumsum(ballot, axis=2) - ballot) << bit
        tot += ballot.sum(axis=2) << bit
    base = (np.cumsum(tot.ravel()) - tot.ravel()).reshape(vec, warps)
    slots = {}
    for k in range(vec):
        for t in range(threads):
            slot = base[k, t // 32] + pre[k, t // 32, t % 32]
            for j in np.flatnonzero(m[k, t]):
                slots[slot] = (v0 + k * threads + t) * 16 + j
                slot += 1
    assert sorted(slots) == list(range(len(slots)))
    return [slots[q] for q in range(len(slots))]


def _register_launch(cur, prev, thr, negfeed, threads=REG_THREADS,
                     vec=REG_VEC, cluster=CLUSTER):
    """A host model of one K6 launch: tile by tile, each CTA of the
    cluster ranks its band's shipped bytes round by round
    (:func:`_rank_round`, rounds of ``threads * vec`` vectors), learns its
    exclusive offset from the counts of the CTAs before it, writes its
    entries there and its band of the zero tail, and new_prev in place.
    Returns (counts, xs_t, vals_t, new_prev) and how often each slot was
    written."""
    n = cur.size
    n_pad, unit = logcompact.tiled_geometry(n, 0)
    c = np.zeros(n_pad, np.int64)
    p = np.zeros(n_pad, np.int64)
    c[:n], p[:n] = cur, prev
    ship = np.abs(c - p) > thr
    n_units = n_pad // unit
    counts = np.zeros(n_units, np.int32)
    xs_t = np.full((n_units, unit), -1, np.int64)
    vals_t = np.full((n_units, unit), -1, np.int64)
    writes = np.zeros((n_units, unit), np.int64)
    for t in range(n_units):
        mine, order = [], []
        tile = ship[t * unit:(t + 1) * unit]
        for band0, band1 in _bands(unit, cluster):
            entries = []
            for v0 in range(band0, band1, threads * vec):
                v1 = min(band1, v0 + threads * vec)
                entries += [t * unit + b for b in
                            _rank_round(tile, v0, v1, threads, vec)]
            order.append(entries)
            mine.append(len(entries))
        total = sum(mine)
        excl = 0
        for (band0, band1), entries in zip(_bands(unit, cluster), order):
            for s, i in enumerate(entries):
                xs_t[t, excl + s] = i
                vals_t[t, excl + s] = (c[i] - p[i]) & 255
                writes[t, excl + s] += 1
            lo, hi = _tail_band(total, band0, band1, excl, len(entries))
            xs_t[t, lo:hi] = 0
            vals_t[t, lo:hi] = 0
            writes[t, lo:hi] += 1
            excl += len(entries)
        counts[t] = total
    new_prev = np.where(ship[:n] | (not negfeed), cur, prev).astype(np.uint8)
    return (counts, xs_t.astype(np.int32), vals_t.astype(np.uint8),
            new_prev), writes


@pytest.mark.parametrize("threads,vec", [(REG_THREADS, REG_VEC), (32, 1)])
@pytest.mark.parametrize("thr,negfeed,density", [(20, True, 0.06),
                                                  (0, False, 0.3),
                                                  (255, True, 1.0),
                                                  (20, True, 0.0)])
@pytest.mark.parametrize("n", [129, 9000, 12_345, 48 * 64 * 3])
def test_register_cluster_model_matches_reference(n, thr, negfeed, density,
                                                  threads, vec):
    """The model, in one round a band and in rounds of 32 vectors (the
    two-pass walk of a long band), against the plain version: every slot
    written once."""
    rng = np.random.default_rng([n, thr, int(density * 10)])
    prev, cur = make_frame_pair(rng, n, change_frac=density)
    got, writes = _register_launch(cur, prev, thr, negfeed, threads, vec)
    assert (writes == 1).all()
    want = register_compact.register_compact_reference(
        torch.from_numpy(cur), torch.from_numpy(prev.copy()), thr, negfeed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("n", [129, 9000, 12_345])
def test_register_cluster_model_matches_jax(n):
    """The model against the JAX package's register scheme
    (``fused_diff_compact_tiled(scheme="register")``, Pallas in interpret
    mode on the CPU backend): counts, blocks and new_prev."""
    rng = np.random.default_rng(n)
    prev, cur = make_frame_pair(rng, n, change_frac=0.1)
    (counts, xs_t, vals_t, new_prev), _ = _register_launch(cur, prev, 20,
                                                           True)
    j_pos, j_counts, j_xs, j_vals, j_prev = (
        np.asarray(a) for a in jax_logcompact.fused_diff_compact(
            jnp.asarray(cur), jnp.asarray(prev), interpret=True,
            scheme="register", emit="tiled"))
    assert int(j_pos) == counts.sum() > 0
    np.testing.assert_array_equal(counts, j_counts)
    np.testing.assert_array_equal(xs_t, j_xs)
    np.testing.assert_array_equal(vals_t, j_vals)
    np.testing.assert_array_equal(new_prev, j_prev)


def test_register_is_one_cluster_launch():
    """``cvs_register_compact`` launches ``register_kernel`` once, as a
    cluster launch, and the source includes nothing of the other
    compactions (it stays an independent derivation)."""
    code = _code("register_compact.cu")
    body = code[code.index("int cvs_register_compact("):]
    body = body[:body.index("\n}\n")]
    assert re.findall(r"cudaLaunchKernelEx\(&cfg, (\w+),", body) == [
        "register_kernel"]
    assert "<<<" not in code and "Memset" not in code
    assert "cudaLaunchAttributeClusterDimension" in code
    includes = re.findall(r'#include\s+[<"]([^>"]+)[>"]', code)
    assert not any(("lookback" in h or "logcompact" in h
                    or "segment_compact" in h) for h in includes)
