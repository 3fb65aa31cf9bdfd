"""K11-K13, the hand-written visualizer kernels (``csrc/visualize.cu``:
the motion heatmap, the red modes and grayscale), on the CPU: each plain
version (``ops/filters.py`` ``heatmap_reference``,
``red_visualizer_reference``, ``grayscale_*_reference``, the entries on a
CPU tensor) against the JAX package's ``heatmap(use_sine=False)``,
``red_black``/``red_overlap`` on its ``diff_mask``'s mask and
``grayscale_*``, and against ``reference_cpu``, at 48x64 (the JAX ``(M,
384)`` layout) and 48x50 (its fallback), with the overlay region read in
place of the frame's prefix, thresholds 0 and 20 and a per-byte map; the
super-frame form (``streams=B``) against B solo calls and row shards
against the solo frame; host models of one launch: K11's and K12's
warp tiles lane by lane, K11 through a warp's shared tile, K12 in
registers (every output byte written once, by one lane, every read
inside its frame, stream, region or map, every shared index inside the
warp's tile; the lanes' arithmetic, and K12's shuffles, give the plain
version's and the JAX package's bytes at tile edges, strip ends, stream
boundaries inside a tile, ragged tails and unaligned views), K13's runs
of 16 pixels a thread, and the SMs' shares of each plan; the
pipelines' aux frames, made from the frame and the strip with no
overlaid copy; and the wrappers on a CUDA tensor, which launch or raise.
Tolerance is zero throughout.

The kernels themselves are held against their plain versions on the card
by ``chip_smoke.py``.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cudavideostream_tpu.ops import diff as jax_diff
from cudavideostream_tpu.ops import filters as jax_filters
from cudavideostream_tpu_torch.config import StreamConfig, Visualizer
from cudavideostream_tpu_torch.models import (
    BatchedDeltaPipeline,
    DeltaStreamPipeline,
)
from cudavideostream_tpu_torch.ops import diff, filters
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.parallel import ShardedDeltaPipeline, make_mesh
from cudavideostream_tpu_torch.parallel.sharded import gather
from cudavideostream_tpu_torch.utils import fonts
from torch_kernel_fixtures import no_kernel_build  # noqa: F401

CSRC = Path(filters.__file__).resolve().parent.parent / "csrc"
LAYOUTS = {"48x64": (48, 64), "48x50": (48, 50)}
SMS = 132  # an H100 SXM's SMs
OPS = ("heatmap", "red_black", "red_overlap", "grayscale_average",
       "grayscale_weighted")


def _constexpr(name):
    """``constexpr int name = ...;`` in ``csrc/visualize.cu``."""
    code = re.sub(r"//[^\n]*", "", (CSRC / "visualize.cu").read_text())
    expr = re.search(rf"constexpr\s+int\s+{name}\s*=\s*([^;]+);",
                     code).group(1)
    names = set(re.findall(r"[A-Za-z_]\w*", expr))
    return eval(expr.replace("/", "//"), {"__builtins__": {}},
                {k: _constexpr(k) for k in names})


THREADS = _constexpr("kThreads")
LUT_SIZE = _constexpr("kLutSize")
WARPS = _constexpr("kWarps")
TILE_VECS = _constexpr("kTileVecs")
TILE = _constexpr("kTile")
HEAT_BLOCKS_PER_SM = _constexpr("kHeatBlocksPerSm")
RED_BLOCKS_PER_SM = _constexpr("kRedBlocksPerSm")
PIX = _constexpr("kPix")
RUN = _constexpr("kRun")
RUN_BLOCKS_PER_SM = _constexpr("kRunBlocksPerSm")
# r_bytes: the R bytes of a vector at phase 0, 1, 2
R_BYTES = [int(v, 16) for v in re.search(
    r"r == 0 \? (0x[0-9a-f]+)u : r == 1 \? (0x[0-9a-f]+)u : (0x[0-9a-f]+)u",
    (CSRC / "visualize.cu").read_text()).groups()]


def _bytes(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _pair(seed, n):
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, n, dtype=np.uint8)
    step = rng.integers(-40, 41, n) * (rng.random(n) < 0.4)
    return np.clip(prev + step, 0, 255).astype(np.uint8), prev


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def test_constants_read_from_the_kernel():
    assert (THREADS, LUT_SIZE, WARPS) == (
        filters.VIS_THREADS, filters.LUT_SIZE, filters.VIS_WARPS)
    assert (TILE_VECS, TILE, HEAT_BLOCKS_PER_SM, RED_BLOCKS_PER_SM) == (
        filters.VIS_VECS, filters.VIS_TILE, filters.HEAT_BLOCKS_PER_SM,
        filters.RED_BLOCKS_PER_SM)
    assert (PIX, RUN_BLOCKS_PER_SM) == (filters.VIS_PIXELS,
                                        filters.VIS_BLOCKS_PER_SM)
    assert RUN == 3 * PIX and RUN % 16 == 0  # K13: three 16-byte vectors
    # a tile: rows of a warp's 32 16-byte vectors, whole pixels, and 48
    # bytes (16 pixels, three 16-byte shared words) a lane
    assert TILE == 512 * TILE_VECS and TILE % 3 == 0 and TILE == 32 * 48
    # bit j of R_BYTES[r] is set where byte j of a vector at phase r is R
    for r in range(3):
        assert R_BYTES[r] == sum(1 << j for j in range(16) if (r + j) % 3 == 2)
    # the op codes of the C entry
    code = (CSRC / "visualize.cu").read_text()
    enum = re.search(r"enum Op \{([^}]*)\}", code).group(1)
    codes = [int(v) for v in re.findall(r"=\s*(\d+)", enum)]
    assert codes == sorted(filters.VIS_OPS.values()) == list(range(5))


def test_lut_words_pack_the_spec_table():
    """K11's by-value LUT: 766 words, ``b | g << 8 | r << 16``, 3,064
    bytes (under the 4 KB of a launch's parameters), equal to
    ``reference_cpu.heatmap_lut``."""
    words = np.frombuffer(bytes(filters.heatmap_lut_words()), np.uint32)
    lut = ref.heatmap_lut().astype(np.uint32)
    assert words.size == LUT_SIZE == lut.shape[0]
    assert words.nbytes == 3064 < 4096
    np.testing.assert_array_equal(words & 255, lut[:, 0])
    np.testing.assert_array_equal(words >> 8 & 255, lut[:, 1])
    np.testing.assert_array_equal(words >> 16, lut[:, 2])


# -- the plain versions against the JAX package and the spec ----------------

def _overlaid(cur, region):
    out = cur.copy()
    if region is not None:
        out[:region.size] = region
    return out


def _jax_want(op, cur, prev, thr, region):
    """The JAX package's bytes of ``op`` on the overlaid frame, also held
    against ``reference_cpu``."""
    c = _overlaid(cur, region)
    jc, jp = jnp.asarray(c), jnp.asarray(prev)
    if op == "heatmap":
        got = jax_filters.heatmap(jc, jp, use_sine=False)
        spec = ref.heatmap(c, prev)
    elif op.startswith("grayscale"):
        got = getattr(jax_filters, op)(jc)
        spec = getattr(ref, op)(c)
    else:
        jt = jnp.asarray(thr) if isinstance(thr, np.ndarray) else thr
        mask = jax_diff.diff_mask(jc, jp, jt)[0]
        xs = ref.diff_encode(c, prev, thr)[1]
        if op == "red_black":
            got, spec = jax_filters.red_black(mask), ref.red_black(xs, c.size)
        else:
            got = jax_filters.red_overlap(jp, mask)
            spec = ref.red_overlap(prev, xs)
    got = np.asarray(got).ravel()
    np.testing.assert_array_equal(got, spec)
    return got


def _port(op, cur, prev, thr, region, streams=1):
    """The entry of ``op`` (the plain version, on the CPU)."""
    c, p, r = _t(cur), _t(prev), _t(region)
    if op == "heatmap":
        return filters.heatmap(c, p, r, streams)
    if op.startswith("grayscale"):
        return getattr(filters, op)(c, r, streams)
    tt = _t(thr) if isinstance(thr, np.ndarray) else thr
    return filters.red_visualizer(c, p, tt, op == "red_overlap", r, streams)


@pytest.mark.parametrize("region", ["none", "strip", "odd"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_matches_jax_and_spec(layout, op, region):
    h, w = LAYOUTS[layout]
    n = h * w * 3
    cur, prev = _pair(sum(map(ord, layout + op + region)), n)
    reg = {"none": None, "strip": _bytes(4, 9 * w * 3),
           "odd": _bytes(5, 3 * 341)}[region]
    thrs = (0, 20, _bytes(6, n)) if op.startswith("red") else (20,)
    for thr in thrs:
        got = _port(op, cur, prev, thr, reg)
        assert got.dtype == torch.uint8 and got.numel() == n
        np.testing.assert_array_equal(got.numpy(),
                                      _jax_want(op, cur, prev, thr, reg))


def test_red_map_of_0s_and_255s():
    """A map of 0s and 255s: 255 never ships, 0 ships any change."""
    h, w = LAYOUTS["48x50"]
    n = h * w * 3
    cur, prev = _pair(9, n)
    tm = np.where(_bytes(10, n) < 128, 0, 255).astype(np.uint8)
    for op in ("red_black", "red_overlap"):
        np.testing.assert_array_equal(
            _port(op, cur, prev, tm, None).numpy(),
            _jax_want(op, cur, prev, tm, None))


def test_heatmap_reaches_the_wrap():
    """Frame pairs whose per-pixel sums run over 510..765, where the
    reference's colormap wraps: every d of 0..765 occurs."""
    d = np.arange(766)
    px = np.stack([np.minimum(d, 255), np.clip(d - 255, 0, 255),
                   np.clip(d - 510, 0, 255)], axis=1)
    cur = px.astype(np.uint8).ravel()
    prev = np.zeros_like(cur)
    got = _port("heatmap", cur, prev, 0, None).numpy()
    np.testing.assert_array_equal(got, ref.heatmap_lut().ravel())
    np.testing.assert_array_equal(got, _jax_want("heatmap", cur, prev, 0,
                                                 None))


@settings(deadline=None, max_examples=15)
@given(st.integers(1, 400), st.sampled_from(OPS), st.integers(0, 255),
       st.integers(0, 1300), st.integers(0, 2 ** 31))
def test_plain_matches_jax_random(npx, op, thr, rlen, seed):
    cur, prev = _pair(seed, 3 * npx)
    reg = _bytes(seed + 1, min(rlen, 3 * npx))
    np.testing.assert_array_equal(
        _port(op, cur, prev, thr, reg).numpy(),
        _jax_want(op, cur, prev, thr, reg))


# -- the super-frame and the shards ------------------------------------------

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("b", [2, 3])
def test_streams_equal_solo_calls(b, op):
    """``streams=B``: B frames at a stride, each with its strip at
    ``region[s * strip:]`` and the one map of a stream's length, equal to
    B solo calls."""
    h, w = LAYOUTS["48x50"]
    sn = h * w * 3
    cur, prev = _pair(b, b * sn)
    strip = 7 * w * 3 + 6  # ends inside a run of 16 pixels
    strips = _bytes(b + 1, b * strip)
    tm = _bytes(b + 2, sn) if op.startswith("red") else 0
    got = _port(op, cur, prev, tm, strips, streams=b).numpy()
    for s in range(b):
        sl = slice(s * sn, (s + 1) * sn)
        np.testing.assert_array_equal(
            got[sl], _port(op, cur[sl], prev[sl], tm,
                           strips[s * strip:(s + 1) * strip]).numpy())
        np.testing.assert_array_equal(
            got[sl], _jax_want(op, cur[sl], prev[sl], tm,
                               strips[s * strip:(s + 1) * strip]))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("s_count", [2, 4])
def test_shards_equal_the_solo_frame(s_count, op):
    """Row shards, each with its part of the region as its own prefix and
    its slice of the map: the shards' outputs, concatenated, equal the
    solo frame's."""
    h, w = LAYOUTS["48x50"]
    n = h * w * 3
    ln = n // s_count
    cur, prev = _pair(s_count, n)
    region = _bytes(11, 13 * w * 3)  # spans shard boundaries at S = 4
    tm = _bytes(12, n) if op.startswith("red") else 0
    parts = []
    for s in range(s_count):
        sl = slice(s * ln, (s + 1) * ln)
        reg = region[s * ln:(s + 1) * ln] if s * ln < region.size else None
        parts.append(_port(op, cur[sl], prev[sl],
                           tm[sl] if isinstance(tm, np.ndarray) else tm,
                           reg).numpy())
    np.testing.assert_array_equal(np.concatenate(parts),
                                  _port(op, cur, prev, tm, region).numpy())


def test_refusals():
    f = torch.zeros(30, dtype=torch.uint8)
    p = torch.zeros(30, dtype=torch.uint8)
    for fn in (lambda: filters.heatmap(f[:-1], p[:-1]),
               lambda: filters.heatmap(f, p[:-3]),
               lambda: filters.heatmap(f.to(torch.int32), p),
               lambda: filters.grayscale_average(f[:0]),
               lambda: filters.grayscale_weighted(f, streams=4),
               lambda: filters.grayscale_weighted(
                   f, torch.zeros(31, dtype=torch.uint8)),
               lambda: filters.heatmap(f, p, torch.zeros(
                   3, dtype=torch.uint8), streams=2),
               lambda: filters.red_visualizer(f, p, 256, True),
               lambda: filters.red_visualizer(f, p, torch.zeros(
                   29, dtype=torch.uint8), False),
               lambda: filters.red_visualizer(f, p, torch.zeros(
                   30, dtype=torch.uint8), False, streams=2),
               lambda: filters.tile_plan(0, SMS, RED_BLOCKS_PER_SM),
               lambda: filters.tile_plan(3, 0, RED_BLOCKS_PER_SM),
               lambda: filters.tile_plan(3, SMS, 0),
               lambda: filters.vis_plan(0, SMS)):
        with pytest.raises(ValueError):
            fn()


# -- a host model of one launch ---------------------------------------------

def _load_vec(cur, region, sn, rlen, i0, n, offs, reads, paths):
    """Lane ``l``'s load of the overlaid bytes ``[i0, i0 + 16)``
    (``tile_load``): one 16-byte load where the vector lies whole in one
    stream, on one side of its strip's end and 16-byte aligned (``offs``:
    each array's address mod 16), else byte by byte, zero past the frame.
    Counts each byte read in ``reads`` and the path in ``paths``; returns
    the 16 bytes and their frame indices."""
    idx = np.arange(i0, min(i0 + 16, n))
    s_idx, j = np.divmod(idx, sn)
    in_reg = j < rlen
    src_idx = np.where(in_reg, s_idx * rlen + j, idx)
    whole = (idx.size == 16 and (s_idx == s_idx[0]).all()
             and (in_reg.all() or not in_reg.any()))
    src = "region" if in_reg[0] else "cur"
    aligned = (offs.get(src, 0) + int(src_idx[0])) % 16 == 0
    paths["vector" if whole and aligned else "bytes"] += 1
    cb = np.zeros(16, np.uint8)
    cb[:idx.size] = cur[idx]
    if rlen:
        cb[:idx.size][in_reg] = region[src_idx[in_reg]]
    np.add.at(reads["region"], src_idx[in_reg], 1)
    np.add.at(reads["cur"], idx[~in_reg], 1)
    return cb, idx, j


def _heat_model(cur, prev, region, b, offs=None):
    """One launch of ``heat_kernel`` on the host, lane by lane: tile ``t``
    of :data:`TILE` bytes belongs to global warp ``t mod (grid * WARPS)``;
    lane ``l`` loads the 16 bytes at ``512 k + 16 l`` of the overlaid
    frame and of prev as :func:`_load_vec` does and stages each byte's
    ``|c - p|`` at the same offset of the warp's shared tile; then takes
    the tile's pixels ``16 l .. 16 l + 15``, its shared bytes ``48 l .. 48
    l + 47``, looks them up and writes the 48 output bytes back over them;
    then stores the shared bytes at ``512 k + 16 l``, one 16-byte store
    where all 16 lie inside the frame, else byte by byte, nothing past it.
    Every shared index is checked to lie inside the warp's tile, every
    shared byte staged, computed and stored once. Returns ``(out, writer
    of each byte, writes of each byte, reads by array, the tiles' warps,
    loads by path, stores by path)``."""
    offs = offs or {}
    n = cur.size
    sn = n // b
    rlen = 0 if region is None else region.size // b
    tiles = -(-n // TILE)
    grid = filters.tile_plan(n, SMS, HEAT_BLOCKS_PER_SM)
    owners = np.arange(tiles) % (grid * WARPS)
    lut = ref.heatmap_lut()
    out = np.zeros(n, np.uint8)
    writer = np.full(n, -1, np.int64)
    wrote = np.zeros(n, np.int64)
    reads = {"cur": np.zeros(n, np.int64), "prev": np.zeros(n, np.int64),
             "region": np.zeros(max(b * rlen, 1), np.int64)}
    paths = {"vector": 0, "bytes": 0}
    stores = {"vector": 0, "bytes": 0}
    for t in range(tiles):
        sx = np.zeros(TILE, np.uint8)  # the warp's shared tile
        staged, computed, stored = (np.zeros(TILE, np.int64)
                                    for _ in range(3))
        for k in range(TILE_VECS):
            for lane in range(32):
                sh = 512 * k + 16 * lane
                i0 = t * TILE + sh
                assert 0 <= sh and sh + 16 <= TILE
                staged[sh:sh + 16] += 1
                if i0 >= n:
                    continue
                cb, idx, _ = _load_vec(cur, region, sn, rlen, i0, n, offs,
                                       reads, paths)
                pb = np.zeros(16, np.uint8)
                pb[:idx.size] = prev[idx]
                reads["prev"][idx] += 1
                sx[sh:sh + 16] = np.abs(cb.astype(np.int64) - pb)
        for lane in range(32):
            sh = 48 * lane
            assert 0 <= sh and sh + 48 <= TILE
            d = sx[sh:sh + 48].reshape(16, 3).astype(np.int64).sum(axis=1)
            sx[sh:sh + 48] = lut[d].ravel()
            computed[sh:sh + 48] += 1
        for k in range(TILE_VECS):
            for lane in range(32):
                i0 = t * TILE + 512 * k + 16 * lane
                sh = 512 * k + 16 * lane
                stored[sh:sh + 16] += 1
                valid = n - i0
                if valid <= 0:
                    continue
                stores["vector" if valid >= 16 else "bytes"] += 1
                m = min(16, valid)
                out[i0:i0 + m] = sx[sh:sh + m]
                writer[i0:i0 + m] = owners[t] * 32 + lane
                wrote[i0:i0 + m] += 1
        assert (staged == 1).all() and (computed == 1).all()
        assert (stored == 1).all()
    return out, writer, wrote, reads, owners, paths, stores


def _launch_model(n, sn, rlen, grid):
    """Where one launch of csrc/visualize.cu reads and writes, over ``n``
    bytes of ``n // sn`` streams: run ``r`` (thread ``r mod (grid *
    THREADS)``) reads its 48 bytes from cur, from stream b's strip at
    ``b * rlen + j`` or byte by byte (``load_src``), the map at ``i mod
    sn`` and writes its 48 output bytes; block 0's threads 0-15 take the
    ragged tail, a pixel each. Returns the source index of every overlaid
    byte (as ``("cur", i)`` or ``("region", k)``), the map index of every
    byte, the writes of every output byte and the runs' owners."""
    npx = n // 3
    runs = npx // PIX
    stride = grid * THREADS
    src = [None] * n
    map_idx = np.full(n, -1, np.int64)
    wrote = np.zeros(n, np.int64)

    def byte(i):
        j = i % sn
        return ("region", i // sn * rlen + j) if j < rlen else ("cur", i)

    owners = np.arange(runs) % stride
    for r in range(runs):
        i0 = RUN * r
        j0 = i0 % sn
        if j0 + RUN <= sn and j0 >= rlen:
            srcs = [("cur", i0 + m) for m in range(RUN)]
        elif j0 + RUN <= sn and j0 + RUN <= rlen:
            srcs = [("region", i0 // sn * rlen + j0 + m) for m in range(RUN)]
        else:
            srcs = [byte(i0 + m) for m in range(RUN)]
        for m in range(RUN):
            assert src[i0 + m] is None
            src[i0 + m] = srcs[m]
            map_idx[i0 + m] = ((j0 + m) if j0 + RUN <= sn
                               else (i0 + m) % sn)
            wrote[i0 + m] += 1
    tail = npx - runs * PIX
    assert tail < PIX <= THREADS  # block 0 has a thread a tail pixel
    for t in range(tail):
        for e in range(3):
            i = 3 * (runs * PIX + t) + e
            assert src[i] is None
            src[i] = byte(i)
            map_idx[i] = i % sn
            wrote[i] += 1
    return src, map_idx, wrote, owners


def _words(b):
    return np.frombuffer(np.asarray(b, np.uint8).tobytes(), np.uint32)


def _pack4(m):
    """``pack4`` of csrc/visualize.cu on uint32 words of 0x00/0xff bytes."""
    return (((m & 0x01010101) * 0x10204080) & 0xFFFFFFFF) >> 28


def _spread4(b):
    """``spread4``: 4 bits to 4 bytes, 0xff where the bit is set."""
    return (((b * 0x00204081) & 0x01010101) * 0xFF) & 0xFFFFFFFF


def _simd_mask(cb, pb, tb):
    """``pack4(__vcmpgtu4(__vabsdiffu4(c, p), t))`` of 4 words: bit j set
    where byte j changed."""
    d = np.abs(cb.astype(np.int64) - pb)
    m = np.where(d > tb, 0xFF, 0).astype(np.uint8)
    return sum(int(_pack4(int(w))) << (4 * q)
               for q, w in enumerate(_words(m)))


def _red_model(cur, prev, thr, region, b, overlap, offs=None):
    """One launch of ``red_kernel`` on the host, lane by lane: tile ``t``
    of :data:`TILE` bytes belongs to global warp ``t mod (grid * WARPS)``;
    lane ``l`` takes the 16 bytes at ``512 k + 16 l`` of the overlaid
    frame (:func:`_load_vec`), of prev and of the map at the stream's byte
    ``j = i mod sn``. Its 16 change bits take the vector before's last two
    (lane ``l - 1``, or lane 31 of vector ``k - 1`` for lane 0: the
    shuffles), and its R bytes by phase ``(l + 2 k) % 3``
    (:data:`R_BYTES`). Returns ``(out, writer of each byte, writes of each
    byte, reads by array, the tiles' warps, vectors by path)``."""
    offs = offs or {}
    n = cur.size
    sn = n // b
    rlen = 0 if region is None else region.size // b
    tmap = thr if isinstance(thr, np.ndarray) else None
    tiles = -(-n // TILE)
    grid = filters.tile_plan(n, SMS, RED_BLOCKS_PER_SM)
    owners = np.arange(tiles) % (grid * WARPS)
    out = np.zeros(n, np.uint8)
    writer = np.full(n, -1, np.int64)
    wrote = np.zeros(n, np.int64)
    reads = {"cur": np.zeros(n, np.int64), "prev": np.zeros(n, np.int64),
             "region": np.zeros(max(b * rlen, 1), np.int64),
             "map": np.zeros(sn, np.int64)}
    paths = {"vector": 0, "bytes": 0}
    for t in range(tiles):
        m = np.zeros((TILE_VECS, 32), np.int64)
        pws = {}
        for k in range(TILE_VECS):
            for lane in range(32):
                i0 = t * TILE + 512 * k + 16 * lane
                if i0 >= n:
                    continue
                cb, idx, j = _load_vec(cur, region, sn, rlen, i0, n, offs,
                                       reads, paths)
                pb, tb = (np.zeros(16, np.uint8) for _ in range(2))
                pb[:idx.size] = prev[idx]
                reads["prev"][idx] += 1
                if tmap is not None:
                    tb[:idx.size] = tmap[j]
                    np.add.at(reads["map"], j, 1)
                else:
                    tb[:] = thr
                m[k, lane] = _simd_mask(cb, pb, tb)
                pws[k, lane] = _words(pb)
        for k in range(TILE_VECS):
            for lane in range(32):
                i0 = t * TILE + 512 * k + 16 * lane
                if i0 >= n:
                    continue
                before = (m[k, lane - 1] if lane else m[k - 1, 31] if k
                          else 0)
                e = (int(m[k, lane]) << 2) | (int(before) >> 14)
                red = (e | e >> 1 | e >> 2) & R_BYTES[(lane + 2 * k) % 3]
                o = np.array([_spread4((red >> (4 * q)) & 15)
                              | (int(pws[k, lane][q]) if overlap else 0)
                              for q in range(4)], np.uint32)
                idx = np.arange(i0, min(i0 + 16, n))
                out[idx] = o.view(np.uint8)[:idx.size]
                writer[idx] = owners[t] * 32 + lane
                wrote[idx] += 1
    return out, writer, wrote, reads, owners, paths


VIEWS = {"cur": 3, "prev": 5, "map": 1, "region": 7}


@pytest.mark.parametrize("kernel", ["runs", "tiles", "tiles_views",
                                    "heat_tiles", "heat_tiles_views"])
@pytest.mark.parametrize("npx,b,rlen", [
    (1, 1, 0), (16, 1, 0), (17, 1, 3), (48 * 50, 1, 9 * 150 + 6),
    (48 * 64, 1, 48 * 64 * 3), (2 * 48 * 50, 2, 7 * 150 + 6),
    (3 * 271 * 19, 3, 5751), (4 * 5, 4, 6), (4 * 5, 4, 15),
    (3 * 512 + 1, 1, 1536 + 6), (2 * 512 * 3 - 2 * 47, 2, 1536 - 16)])
def test_launch_model_reads_inside_and_writes_once(npx, b, rlen, kernel):
    """Every output byte is written by exactly one lane; every overlaid
    byte is read once, from its own stream's strip below the strip's end
    (never past it) and from cur above it; every map read lies inside the
    stream's map; and the bytes the model computes equal the plain
    version's and the JAX package's, at tile edges, a strip's end inside a
    tile, stream boundaries inside a tile and ragged tails. ``tiles``:
    K12's warp tiles, through the lanes' word arithmetic and shuffles, in
    modes 2 and 3 with the int threshold and a map; ``heat_tiles``: K11,
    staged through the warp's shared tile of ``|c - p|``;
    ``_views``: the same with cur, prev, the map and the strips not
    16-byte aligned, every load byte by byte; ``runs``: K13's runs of 16
    pixels a thread."""
    n = 3 * npx
    sn = n // b
    cur = _bytes(npx, n)
    region = _bytes(npx + 1, b * rlen)
    reg = region if rlen else None
    views = kernel.endswith("_views")
    offs = VIEWS if views else {}
    prev = np.where(_bytes(npx + 2, n) < 200, cur,
                    _bytes(npx + 3, n)).astype(np.uint8)
    over = diff.region_frame(_t(cur), _t(reg), b).numpy()
    j = np.arange(n) % sn
    if kernel.startswith("tiles"):
        for thr, overlap in ((20, True), (20, False),
                             (_bytes(npx + 4, sn), True)):
            got, writer, wrote, reads, owners, paths = _red_model(
                cur, prev, thr, reg, b, overlap, offs)
            assert (wrote == 1).all() and (writer >= 0).all()
            assert owners.max() < filters.tile_plan(
                n, SMS, RED_BLOCKS_PER_SM) * WARPS
            assert (reads["prev"] == 1).all()
            assert (reads["cur"] == (j >= rlen)).all()
            if rlen:
                assert (reads["region"] == 1).all()
            if isinstance(thr, np.ndarray):
                assert (reads["map"] == b).all()
            if views:
                assert paths["vector"] == 0
            np.testing.assert_array_equal(
                got, filters.red_visualizer_reference(
                    _t(over), _t(prev), _t(thr) if isinstance(
                        thr, np.ndarray) else thr, overlap, None,
                    b).numpy())
            np.testing.assert_array_equal(
                got, _port("red_overlap" if overlap else "red_black", cur,
                           prev, thr, reg, b).numpy())
        return
    if kernel.startswith("heat"):
        got, writer, wrote, reads, owners, paths, stores = _heat_model(
            cur, prev, reg, b, offs)
        assert (wrote == 1).all() and (writer >= 0).all()
        assert owners.max() < filters.tile_plan(
            n, SMS, HEAT_BLOCKS_PER_SM) * WARPS
        assert (reads["prev"] == 1).all()
        assert (reads["cur"] == (j >= rlen)).all()
        if rlen:
            assert (reads["region"] == 1).all()
        if views:
            assert paths["vector"] == 0
        elif n >= 16 and rlen == 0:
            assert paths["vector"] > 0
        assert stores["vector"] == n // 16 and stores["bytes"] == (n % 16 > 0)
        np.testing.assert_array_equal(
            got, _port("heatmap", cur, prev, 0, reg, b).numpy())
        np.testing.assert_array_equal(
            got, _jax_want("heatmap", over, prev, 0, None))
        return
    grid = filters.vis_plan(npx, SMS)
    assert 1 <= grid <= RUN_BLOCKS_PER_SM * SMS
    src, map_idx, wrote, owners = _launch_model(n, sn, rlen, grid)
    assert (wrote == 1).all()
    assert owners.size == 0 or owners.max() < grid * THREADS
    assert ((map_idx >= 0) & (map_idx < sn)).all()
    got = np.empty(n, np.uint8)
    for i, (kind, k) in enumerate(src):
        s, j = divmod(i, sn)
        if kind == "region":
            assert s * rlen <= k < (s + 1) * rlen and j < rlen
            got[i] = region[k]
        else:
            assert k == i and j >= rlen
            got[i] = cur[k]
    np.testing.assert_array_equal(
        got, diff.region_frame(_t(cur), _t(region) if rlen else None,
                               b).numpy())


@pytest.mark.parametrize("kernel,per_sm", [
    ("heat_kernel", "kHeatBlocksPerSm"), ("red_kernel", "kRedBlocksPerSm"),
    ("vis_kernel", None)])
@pytest.mark.parametrize("npx", [1920 * 1080, 4 * 1920 * 1080, 17,
                                 1920 * 1080 // 4, 1920 * 1080 // 4 + 333])
def test_plan_spreads_runs_evenly(npx, kernel, per_sm):
    """``tile_plan`` (K11, K12), at the blocks an SM each kernel is
    compiled for (:data:`HEAT_BLOCKS_PER_SM`, :data:`RED_BLOCKS_PER_SM`):
    one wave, each tile one warp's, and with block ``b`` on SM ``b mod
    SMS`` the SMs' tiles differ by at most one (at 1080p 4,050 tiles, 30
    or 31 an SM). ``vis_plan`` (K13): the threads' runs differ by at most
    one."""
    if per_sm is None:
        grid = filters.vis_plan(npx, SMS)
        assert 1 <= grid <= RUN_BLOCKS_PER_SM * SMS
        runs = npx // PIX
        per_thread = np.bincount(np.arange(runs) % (grid * THREADS),
                                 minlength=grid * THREADS)
        assert per_thread.max() - per_thread.min() <= 1
        return
    code = (CSRC / "visualize.cu").read_text()
    assert re.search(rf"__launch_bounds__\(kThreads, {per_sm}\)\s*"
                     rf"{kernel}\(", code)
    blocks = _constexpr(per_sm)
    n = 3 * npx
    grid = filters.tile_plan(n, SMS, blocks)
    tiles = -(-n // TILE)
    assert grid == max(1, min(blocks * SMS, tiles))
    warp = np.arange(tiles) % (grid * WARPS)
    per_sm_tiles = np.bincount(warp % grid % SMS, minlength=SMS)
    assert per_sm_tiles.sum() == tiles
    assert per_sm_tiles.max() - per_sm_tiles.min() <= 1
    per_warp = np.bincount(warp, minlength=grid * WARPS)
    assert per_warp.max() - per_warp.min() <= 1
    if npx == 1920 * 1080:
        assert (tiles, grid, per_sm_tiles.max()) == (4050, blocks * SMS, 31)


# -- the pipelines: aux frames from the frame and the strip ------------------

VIS = [Visualizer.HEATMAP, Visualizer.RED_BLACK, Visualizer.RED_OVERLAP,
       Visualizer.GRAYSCALE]


def _spy_filters(monkeypatch, frames_seen):
    """Record each visualizer entry's call: its name, its frame argument
    and its region."""
    for name in ("heatmap", "red_visualizer", "grayscale_weighted"):
        real = getattr(filters, name)

        def spy(*a, _real=real, _name=name, **k):
            args = inspect.signature(_real).bind(*a, **k).arguments
            frames_seen.append((_name, a[0], args.get("region")))
            return _real(*a, **k)

        monkeypatch.setattr(filters, name, spy)


@pytest.mark.parametrize("vis", VIS, ids=lambda v: v.name)
def test_solo_and_batched_aux_read_the_strip_in_place(vis, monkeypatch):
    """``DeltaStreamPipeline`` and ``BatchedDeltaPipeline`` (B = 3) with
    overlay text: each visualizer entry is called once a step with the
    frame as it came (no overlaid copy) and the strip(s) as its region;
    each stream's aux frame equals ``step_oracle``'s."""
    cfg = StreamConfig(height=48, width=50, overlay_scale=4, visualizer=vis,
                       tiled_payload=True)
    n = cfg.frame_bytes
    seen = []
    _spy_filters(monkeypatch, seen)
    cur, prev = _pair(vis.value, 3 * n)
    texts = ["FPS 30", "", "B 7"]
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    aux = pipe.step(pipe.init_state(prev[:n]), torch.from_numpy(cur[:n]),
                    text=texts[0])[-1]
    e = ref.step_oracle(prev[:n], cur[:n], cfg, pipe.atlas_np,
                        fonts.encode_text(texts[0]))
    np.testing.assert_array_equal(aux.numpy(), e[4])
    bpipe = BatchedDeltaPipeline(cfg, 3, device="cpu")
    baux = bpipe.step(bpipe.init_state(prev.reshape(3, n)),
                      torch.from_numpy(cur), texts)[-1].numpy()
    for s in range(3):
        e = ref.step_oracle(prev[s * n:(s + 1) * n], cur[s * n:(s + 1) * n],
                            cfg, pipe.atlas_np, fonts.encode_text(texts[s]))
        np.testing.assert_array_equal(baux[s * n:(s + 1) * n], e[4])
    assert len(seen) == 2
    for (_, frame, region), want in zip(seen, (cur[:n], cur)):
        np.testing.assert_array_equal(frame.numpy(), want)  # not overlaid
        assert region is not None


@pytest.mark.parametrize("vis", VIS, ids=lambda v: v.name)
def test_sharded_aux_reads_each_shards_region(vis, monkeypatch):
    """``ShardedDeltaPipeline.step_flat`` at S = 4 with overlay text: one
    call a shard, each with the shard's rows as they came and its slice
    of the glyph band as its region where it holds one; the gathered aux
    frame equals ``step_oracle``'s."""
    cfg = StreamConfig(height=48, width=50, overlay_scale=4, visualizer=vis)
    seen = []
    _spy_filters(monkeypatch, seen)
    pipe = ShardedDeltaPipeline(cfg, make_mesh(4, device="cpu"))
    cur, prev = _pair(10 + vis.value, cfg.frame_bytes)
    state = pipe.init_state_flat(prev)
    out = pipe.step_flat(state, cur, text="FPS 30")
    e = ref.step_oracle(prev, cur, cfg, pipe.atlas_np,
                        fonts.encode_text("FPS 30"))
    np.testing.assert_array_equal(gather(out[-1]), e[4])
    ln = cfg.frame_bytes // 4
    assert len(seen) == 4
    cell_h = pipe.atlas_np.shape[1]
    for s, (_, frame, region) in enumerate(seen):
        np.testing.assert_array_equal(frame.numpy(),
                                      cur[s * ln:(s + 1) * ln])
        assert (region is not None) == (s * pipe.local_rows < cell_h)


# -- a CUDA tensor never reaching a plain version ----------------------------

def test_visualizers_on_cuda_launch_or_raise(monkeypatch, no_kernel_build):
    """Without a kernel build (no nvcc here) each entry raises on a CUDA
    tensor, no plain version is called and no launch is counted; the
    heatmap's LUT is never uploaded."""
    calls = []
    for name in ("heatmap_reference", "red_visualizer_reference",
                 "grayscale_average_reference",
                 "grayscale_weighted_reference", "_heatmap_lut",
                 "red_black", "red_overlap"):
        monkeypatch.setattr(filters, name, lambda *a, **k: calls.append(a))
    monkeypatch.setattr(diff, "region_frame",
                        lambda *a, **k: calls.append(a))
    n = 48 * 64 * 3
    cur = torch.zeros(n, dtype=torch.uint8)
    prev = torch.zeros(n, dtype=torch.uint8)
    region = torch.zeros(9 * 64 * 3, dtype=torch.uint8)
    tmap = torch.zeros(n, dtype=torch.uint8)
    counters = (filters.heatmap, filters.red_visualizer,
                filters.grayscale_average, filters.grayscale_weighted)
    before = [f.launches for f in counters]
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    for fn in (lambda: filters.heatmap(cur, prev, region),
               lambda: filters.red_visualizer(cur, prev, 20, False),
               lambda: filters.red_visualizer(cur, prev, tmap, True, region),
               lambda: filters.grayscale_average(cur),
               lambda: filters.grayscale_weighted(cur, region)):
        with pytest.raises(RuntimeError):
            fn()
    monkeypatch.undo()
    assert not calls
    assert [f.launches for f in counters] == before
