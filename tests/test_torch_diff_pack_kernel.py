"""K10, the HOST backend's hand-written device step (``csrc/diff_pack.cu``),
on the CPU: its plain version (``ops/diff.py`` ``diff_pack_reference``,
the entry ``diff_pack`` on a CPU tensor) against the JAX package's
``diff_mask`` + ``pack_bitmask`` and ``reference_cpu.diff_encode`` for
the bits, the wrapped delta and the new previous frame (written in place),
with and without negative feedback, thresholds 0 and 20, a per-byte map,
the overlay region and lengths that are not a multiple of 8; a host model
of one launch (the warp tiles' owners and their spread over the SMs,
every frame byte and bits byte written once by one lane, no read outside
the frame, the region or the map, the lanes' word arithmetic and bit
order, the byte path of a vector that is not whole, straddles the
region's end or is not aligned); the HOST pipeline step through it; and
the wrapper on a CUDA tensor, which launches or raises. Tolerance is zero
throughout.

The kernel itself is held against its plain version on the card by
``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cudavideostream_tpu.ops import diff as jax_diff
from cudavideostream_tpu_torch.config import CompactionBackend, StreamConfig
from cudavideostream_tpu_torch.models import DeltaStreamPipeline
from cudavideostream_tpu_torch.ops import diff
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.utils import fonts
from torch_kernel_fixtures import no_kernel_build  # noqa: F401

CSRC = Path(diff.__file__).resolve().parent.parent / "csrc"
LAYOUTS = {"48x64": (48, 64), "48x50": (48, 50)}
SMS = 132  # an H100 SXM's SMs


def _constexpr(name):
    """``constexpr int name = ...;`` in ``csrc/diff_pack.cu``."""
    code = re.sub(r"//[^\n]*", "", (CSRC / "diff_pack.cu").read_text())
    expr = re.search(rf"constexpr\s+int\s+{name}\s*=\s*([^;]+);",
                     code).group(1)
    names = set(re.findall(r"[A-Za-z_]\w*", expr))
    return eval(expr.replace("/", "//"), {"__builtins__": {}},
                {k: _constexpr(k) for k in names})


THREADS = _constexpr("kThreads")
WARPS = _constexpr("kWarps")
VECS = _constexpr("kVecs")
TILE = _constexpr("kTile")
BLOCKS_PER_SM = _constexpr("kBlocksPerSm")


def _bytes(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _pair(seed, n):
    """A previous frame and a current one that moves a third of its bytes
    by up to 40 (some under the threshold, some over) and leaves the rest."""
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, n, dtype=np.uint8)
    step = rng.integers(-40, 41, n) * (rng.random(n) < 0.33)
    return np.clip(prev + step, 0, 255).astype(np.uint8), prev


def test_constants_read_from_the_kernel():
    assert (THREADS, VECS, TILE, BLOCKS_PER_SM) == (
        diff.DP_THREADS, diff.DP_VECS, diff.DP_TILE, diff.DP_BLOCKS_PER_SM)
    # a tile is kVecs rows of a warp's 32 16-byte vectors, whole bit bytes
    assert TILE == VECS * 32 * 16 and WARPS == THREADS // 32 == diff.DP_WARPS


# -- the plain version against the JAX package and the spec ----------------

def _overlaid(cur, region):
    out = cur.copy()
    if region is not None:
        out[:region.size] = region
    return out


def _want(cur, prev, thr, negfeed, region):
    """The JAX package's bits, delta and new previous frame, on the
    overlaid frame, each also checked against ``diff_encode``."""
    c = _overlaid(cur, region)
    jt = jnp.asarray(thr) if isinstance(thr, np.ndarray) else thr
    m, v, np_ = jax_diff.diff_mask(jnp.asarray(c), jnp.asarray(prev), jt,
                                   negfeed)
    bits = np.asarray(jax_diff.pack_bitmask(m))
    pos, xs, vals, new_prev = ref.diff_encode(c, prev, thr, negfeed)
    np.testing.assert_array_equal(np.asarray(np_), new_prev)
    np.testing.assert_array_equal(np.nonzero(np.asarray(m))[0], xs)
    np.testing.assert_array_equal(np.asarray(v)[xs], vals)
    return bits, np.asarray(v), new_prev


@pytest.mark.parametrize("region", ["none", "strip", "odd"])
@pytest.mark.parametrize("thr", ["0", "20", "map"])
@pytest.mark.parametrize("negfeed", [True, False], ids=["negfeed", "nofeed"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_matches_jax_and_spec(layout, negfeed, thr, region):
    h, w = LAYOUTS[layout]
    n = h * w * 3
    cur, prev = _pair(sum(map(ord, layout + thr + region)), n)
    t = {"0": 0, "20": 20, "map": _bytes(3, n)}[thr]
    reg = {"none": None, "strip": _bytes(4, 9 * w * 3),
           "odd": _bytes(5, 1001)}[region]
    bits_w, delta_w, prev_w = _want(cur, prev, t, negfeed, reg)
    tp = torch.from_numpy(prev.copy())
    tt = torch.from_numpy(t) if isinstance(t, np.ndarray) else t
    bits, delta = diff.diff_pack(
        torch.from_numpy(cur), tp, tt, negfeed,
        None if reg is None else torch.from_numpy(reg), want_delta=True)
    np.testing.assert_array_equal(bits.numpy(), bits_w)
    np.testing.assert_array_equal(delta.numpy(), delta_w)
    np.testing.assert_array_equal(tp.numpy(), prev_w)  # in place
    # without the delta: the same bits and state, no delta
    tp2 = torch.from_numpy(prev.copy())
    bits2, none = diff.diff_pack(
        torch.from_numpy(cur), tp2, tt, negfeed,
        None if reg is None else torch.from_numpy(reg))
    assert none is None
    np.testing.assert_array_equal(bits2.numpy(), bits_w)
    np.testing.assert_array_equal(tp2.numpy(), prev_w)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 16, 17, 127, 128, 129, 1001])
def test_ragged_lengths_pad_with_zero_bits(n):
    """Lengths that are not a multiple of 8 (or of a chunk): the last bits
    byte's missing bits are zero, as the JAX ``pack_bitmask`` pads."""
    cur = np.full(n, 200, np.uint8)
    prev = np.zeros(n, np.uint8)  # every byte changes
    tp = torch.from_numpy(prev.copy())
    bits, delta = diff.diff_pack(torch.from_numpy(cur), tp, 20,
                                 want_delta=True)
    want = np.asarray(jax_diff.pack_bitmask(jnp.ones(n, bool)))
    np.testing.assert_array_equal(bits.numpy(), want)
    assert bits.numel() == (n + 7) // 8
    if n % 8:
        assert bits[-1] == (1 << (n % 8)) - 1
    np.testing.assert_array_equal(delta.numpy(), cur)
    np.testing.assert_array_equal(tp.numpy(), cur)


@settings(deadline=None, max_examples=20)
@given(st.integers(1, 700), st.integers(0, 255), st.booleans(),
       st.integers(0, 700), st.integers(0, 2 ** 31))
def test_plain_matches_jax_random(n, thr, negfeed, rlen, seed):
    cur, prev = _pair(seed, n)
    reg = _bytes(seed + 1, min(rlen, n))
    bits_w, delta_w, prev_w = _want(cur, prev, thr, negfeed, reg)
    tp = torch.from_numpy(prev.copy())
    bits, delta = diff.diff_pack(torch.from_numpy(cur), tp, thr, negfeed,
                                 torch.from_numpy(reg), want_delta=True)
    np.testing.assert_array_equal(bits.numpy(), bits_w)
    np.testing.assert_array_equal(delta.numpy(), delta_w)
    np.testing.assert_array_equal(tp.numpy(), prev_w)


def test_refusals():
    f = torch.zeros(30, dtype=torch.uint8)
    p = torch.zeros(30, dtype=torch.uint8)
    for args in ((f[:-1], p, 20), (f.to(torch.int32), p, 20),
                 (f[:0], p[:0], 20), (f, p, 256), (f, p, -1),
                 (f, p, torch.zeros(29, dtype=torch.uint8)),
                 (f, p, torch.zeros(30, dtype=torch.int16))):
        with pytest.raises(ValueError):
            diff.diff_pack(*args)
    with pytest.raises(ValueError):
        diff.diff_pack(f, p, 20, region=torch.zeros(31, dtype=torch.uint8))
    with pytest.raises(ValueError):
        diff.diff_pack_plan(0, SMS)


# -- a host model of one launch ---------------------------------------------

def _pack4(m):
    """``pack4`` of csrc/diff_pack.cu on uint32 words of 0x00/0xff bytes."""
    return (((m & 0x01010101) * 0x10204080) & 0xFFFFFFFF) >> 28


def _vcmpgtu4(a, b):
    """``__vcmpgtu4`` on uint32 words: 0xff per byte where a > b."""
    out = np.zeros_like(a)
    for e in range(4):
        sh = 8 * e
        gt = ((a >> sh) & 255) > ((b >> sh) & 255)
        out |= np.where(gt, 0xFF << sh, 0).astype(a.dtype)
    return out


def _vabsdiffu4(a, b):
    out = np.zeros_like(a)
    for e in range(4):
        sh = 8 * e
        d = np.abs(((a >> sh) & 255).astype(np.int64)
                   - ((b >> sh) & 255).astype(np.int64))
        out |= (d.astype(a.dtype) << sh)
    return out


def _words(b):
    """16 bytes as 4 little-endian uint32 words."""
    return np.frombuffer(np.asarray(b, np.uint8).tobytes(), np.uint32)


def _launch_model(cur, prev, thr, negfeed, region, tmap, grid, delta=False,
                  offs=None):
    """One launch of ``diff_pack_kernel`` on the host, lane by lane: tile
    ``t`` of :data:`TILE` bytes belongs to global warp ``t mod (grid *
    WARPS)`` (warp ``w`` of block ``b`` is ``w * grid + b``); lane ``l``
    takes the 16 bytes at ``512 q + 16 l`` for ``q < VECS``. A vector goes
    one load (and one store) per array where it is whole, on one side of
    the region's end and 16-byte aligned (``offs``: each array's address
    mod 16), else byte by byte, zero past the frame; the word arithmetic
    is the kernel's (``__vabsdiffu4``, ``__vcmpgtu4``, ``pack4``). Returns
    ``(bits, new_prev, delta, writer of each frame byte, writes of each
    frame byte, writes of each bits byte, reads by array, the tiles' warps,
    vectors by path)``."""
    offs = offs or {}
    n = cur.size
    rlen = 0 if region is None else region.size
    nbits = (n + 7) // 8
    tiles = -(-n // TILE)
    prev = prev.copy()
    bits = np.zeros(nbits, np.uint8)
    dl = np.zeros(n, np.uint8)
    writer = np.full(n, -1, np.int64)
    wrote = np.zeros(n, np.int64)
    wrote_bits = np.zeros(nbits, np.int64)
    reads = {"cur": np.zeros(n, np.int64), "prev": np.zeros(n, np.int64),
             "map": np.zeros(n, np.int64),
             "region": np.zeros(max(rlen, 1), np.int64)}
    paths = {"vector": 0, "bytes": 0}

    def aligned(name, i):
        return (offs.get(name, 0) + i) % 16 == 0

    owners = np.arange(tiles) % (grid * WARPS)
    for t in range(tiles):
        for q in range(VECS):
            for lane in range(32):
                i0 = t * TILE + 512 * q + 16 * lane
                valid = n - i0
                if valid <= 0:
                    continue
                idx = np.arange(i0, i0 + min(valid, 16))
                in_reg = idx < rlen
                whole = valid >= 16 and (in_reg.all() or not in_reg.any())
                src = "region" if in_reg.all() else "cur"
                vec = whole and aligned(src, i0) and aligned("prev", i0)
                paths["vector" if vec else "bytes"] += 1
                cb = np.zeros(16, np.uint8)
                pb = np.zeros(16, np.uint8)
                tb = np.zeros(16, np.uint8)
                cb[:idx.size] = np.where(in_reg, region[np.minimum(
                    idx, max(rlen - 1, 0))] if rlen else 0, cur[idx])
                np.add.at(reads["region"], idx[in_reg], 1)
                np.add.at(reads["cur"], idx[~in_reg], 1)
                pb[:idx.size] = prev[idx]
                reads["prev"][idx] += 1
                if tmap is not None:
                    tb[:idx.size] = tmap[idx]
                    reads["map"][idx] += 1
                cw, pw = _words(cb), _words(pb)
                tw = (_words(tb) if tmap is not None
                      else np.full(4, thr * 0x01010101, np.uint32))
                m = _vcmpgtu4(_vabsdiffu4(cw, pw), tw)
                nw = (cw & m) | (pw & ~m) if negfeed else cw
                m16 = sum(int(_pack4(int(m[k]))) << (4 * k) for k in range(4))
                prev[idx] = nw.view(np.uint8)[:idx.size]
                dl[idx] = (cb.astype(np.int64) - pb)[:idx.size] & 255
                writer[idx] = owners[t] * 32 + lane
                wrote[idx] += 1
                bits[i0 // 8] = m16 & 255
                wrote_bits[i0 // 8] += 1
                if valid > 8:
                    bits[i0 // 8 + 1] = m16 >> 8
                    wrote_bits[i0 // 8 + 1] += 1
    return (bits, prev, dl if delta else None, writer, wrote, wrote_bits,
            reads, owners, paths)


@pytest.mark.parametrize("offs", [{}, {"cur": 3, "prev": 3, "map": 3},
                                  {"region": 5}],
                         ids=["aligned", "views", "region_view"])
@pytest.mark.parametrize("n,rlen", [(1, 0), (8, 0), (129, 0), (128, 128),
                                    (48 * 50 * 3, 1001),
                                    (48 * 64 * 3, 9 * 64 * 3),
                                    (48 * 64 * 3 + 5, 0),
                                    (3 * TILE, TILE + 8),
                                    (4 * TILE - 7, 2 * TILE - 1)])
@pytest.mark.parametrize("thr", ["20", "map"])
def test_launch_model_writes_each_byte_once_and_matches(n, rlen, thr, offs):
    """Every frame byte and bits byte is written once, by one lane (the
    lane of the bits' 16 frame bytes), no read leaves the frame, the
    region or the map (the region's bytes are read instead of the
    frame's, never both), and the model's bits, state and delta, through
    the lanes' word arithmetic, equal the plain version's: at tile
    boundaries, a region's end inside a tile and inside a vector, ragged
    tails and views that are not 16-byte aligned."""
    cur, prev = _pair(n + rlen, n)
    region = _bytes(7, rlen) if rlen else None
    tmap = _bytes(8, n) if thr == "map" else None
    grid = diff.diff_pack_plan(n, SMS)
    assert 1 <= grid <= BLOCKS_PER_SM * SMS
    (bits, new_prev, dl, writer, wrote, wrote_bits, reads, owners,
     paths) = _launch_model(cur, prev, 20, True, region, tmap, grid, True,
                            offs)
    assert (wrote == 1).all() and (wrote_bits == 1).all()
    # bits byte k's 8 frame bytes are one lane's
    assert all(len(set(writer[8 * k:8 * k + 8])) == 1
               for k in range(wrote_bits.size))
    # each frame byte read once, from the region below its end, else cur
    assert (reads["cur"][:rlen] == 0).all()
    assert (reads["cur"][rlen:] == 1).all() and (reads["prev"] == 1).all()
    if rlen:
        assert (reads["region"] == 1).all()
    assert (reads["map"] == (tmap is not None)).all()
    assert owners.max() < grid * WARPS
    if n >= 16 and not offs:
        assert paths["vector"] > 0
    if offs.get("cur"):
        assert paths["vector"] == 0
    tp = torch.from_numpy(prev.copy())
    want_bits, want_delta = diff.diff_pack(
        torch.from_numpy(cur), tp, 20 if tmap is None else
        torch.from_numpy(tmap), True,
        None if region is None else torch.from_numpy(region), True)
    np.testing.assert_array_equal(bits, want_bits.numpy())
    np.testing.assert_array_equal(new_prev, tp.numpy())
    np.testing.assert_array_equal(dl, want_delta.numpy())


@pytest.mark.parametrize("n", [6_220_800, 6_220_800 // 4, 6_220_801, 1,
                               6_220_800 // 4 + 777, 32_768 * 132 * 9])
def test_plan_covers_every_chunk(n):
    """The 1080p frame, its S = 4 shard and the edges: each tile has one
    owner warp, the grid is one wave of at most :data:`BLOCKS_PER_SM`
    blocks an SM, and with block ``b`` on SM ``b mod SMS`` the SMs' tiles
    differ by at most one."""
    grid = diff.diff_pack_plan(n, SMS)
    tiles = -(-n // TILE)
    assert grid == max(1, min(BLOCKS_PER_SM * SMS, tiles))
    warp = np.arange(tiles) % (grid * WARPS)  # global warp w * grid + b
    block = warp % grid
    per_sm = np.bincount(block % SMS, minlength=SMS)
    assert per_sm.sum() == tiles
    assert per_sm.max() - per_sm.min() <= 1
    per_warp = np.bincount(warp, minlength=grid * WARPS)
    assert per_warp.max() - per_warp.min() <= 1
    if n == 6_220_800:  # 6,075 tiles: 46 or 47 an SM, 264 blocks
        assert (tiles, grid, per_sm.max()) == (6075, 264, 47)


def test_pack4_bit_order():
    """``pack4`` takes bit 7 of each byte, byte 0 lowest, for all 16
    patterns of 0x00/0xff bytes."""
    for k in range(16):
        m = sum(0xFF << (8 * e) for e in range(4) if k >> e & 1)
        assert _pack4(m) == k


# -- the HOST step, and a CUDA tensor never reaching the plain version ------

@pytest.mark.parametrize("nf", [False, True], ids=["fast", "noise_filter"])
def test_host_step_runs_diff_pack_once(nf, monkeypatch):
    """``--compaction host``: one ``diff_pack`` a step, which reads the
    overlay strip in place (never an overlaid copy of the frame) and
    updates the state in place; the step equals ``step_oracle``."""
    cfg = StreamConfig(height=48, width=50, overlay_scale=4,
                       compaction=CompactionBackend.HOST, noise_filter=nf)
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    calls = []
    real = diff.diff_pack

    def spy(cur, prev, thr, negfeed, region=None, want_delta=False):
        calls.append((region is not None, want_delta))
        return real(cur, prev, thr, negfeed, region, want_delta)

    monkeypatch.setattr(diff, "diff_pack", spy)
    cur, base = _pair(11, cfg.frame_bytes)
    prev = pipe.init_state(base)
    out = pipe.step(prev, cur, text="FPS 30")
    assert out[0] is prev
    assert calls == [(True, nf)]
    e_prev, e_pos, e_xs, e_vals, _ = ref.step_oracle(
        base, cur, cfg, pipe.atlas_np, fonts.encode_text("FPS 30"))
    np.testing.assert_array_equal(prev.numpy(), e_prev)
    assert out[1] == e_pos
    np.testing.assert_array_equal(out[2], e_xs)
    np.testing.assert_array_equal(out[3], e_vals)


def test_diff_pack_on_cuda_launches_or_raises(monkeypatch, no_kernel_build):
    """A CUDA tensor never takes the plain version: without a kernel
    build (no nvcc here) the entry raises, the plain version is not
    called, ``prev`` is not touched and no launch is counted."""
    calls = []
    for name in ("diff_pack_reference", "diff_mask", "pack_bitmask"):
        monkeypatch.setattr(diff, name, lambda *a, **k: calls.append(a))
    cur = torch.full((48 * 64 * 3,), 200, dtype=torch.uint8)
    prev = torch.zeros(48 * 64 * 3, dtype=torch.uint8)
    ptrs = iter(range(4096, 1 << 40, 4096))
    before = diff.diff_pack.launches
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: next(ptrs))
    for kw in ({}, {"want_delta": True}):
        with pytest.raises(RuntimeError):
            diff.diff_pack(cur, prev, 20, **kw)
    monkeypatch.undo()
    assert not calls and diff.diff_pack.launches == before
    assert not prev.any()
