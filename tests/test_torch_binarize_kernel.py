"""K9, the binarize visualizer's two hand-written launches
(``csrc/binarize.cu``), on the CPU: its plain version
(``ops/filters.py`` ``binarize_pipeline_reference``) against the JAX
package's ``binarize_pipeline(fused=True)`` and ``reference_cpu``; the two
entries, ``gray_hist`` and ``binarize_apply``, against
``binarize_pipeline``, and their sharded use (each shard's histogram
summed, the sum applied on each shard) against the solo frame; a host
model of each launch's plan (the blocks' runs of 16 pixels and the ragged
tail, every gray byte and output byte written once, no read outside the
frame; the per-block sums merged through the scratch, left zero) and of
the first warp's top-2 scan, against ``reference_cpu.top2_scan``; and the
wrappers on a CUDA tensor, which launch or raise. Tolerance is zero
throughout.

The kernels themselves are held against their plain version on the card
by ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cudavideostream_tpu.ops import filters as jax_filters
from cudavideostream_tpu_torch.config import StreamConfig, Visualizer
from cudavideostream_tpu_torch.models import BatchedDeltaPipeline
from cudavideostream_tpu_torch.ops import filters
from cudavideostream_tpu_torch.ops import hist
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from torch_kernel_fixtures import no_kernel_build  # noqa: F401

CSRC = Path(filters.__file__).resolve().parent.parent / "csrc"
LAYOUTS = {"48x64": (48, 64), "48x50": (48, 50)}
SMS = 132  # an H100 SXM's SMs


def _constexpr(name):
    """``constexpr int name = ...;`` in ``csrc/binarize.cu``."""
    code = re.sub(r"//[^\n]*", "", (CSRC / "binarize.cu").read_text())
    expr = re.search(rf"constexpr\s+int\s+{name}\s*=\s*([^;]+);",
                     code).group(1)
    names = set(re.findall(r"[A-Za-z_]\w*", expr))
    return eval(expr.replace("/", "//"), {"__builtins__": {}},
                {k: _constexpr(k) for k in names})


HIST_THREADS = _constexpr("kHistThreads")
APPLY_THREADS = _constexpr("kApplyThreads")
PIX = _constexpr("kPix")
BINS = _constexpr("kBins")
SCRATCH = _constexpr("kScratchWords")
REG_RUNS = _constexpr("kRegRuns")


def _frame(seed, npx):
    return np.random.default_rng(seed).integers(0, 256, 3 * npx,
                                                dtype=np.uint8)


def test_constants_read_from_the_kernel():
    assert (HIST_THREADS, APPLY_THREADS, PIX, REG_RUNS) == (
        filters.BIN_HIST_THREADS, filters.BIN_APPLY_THREADS,
        filters.BIN_PIXELS, filters.BIN_REG_RUNS)
    assert BINS == hist.NBINS and SCRATCH == hist.HIST_SCRATCH_WORDS
    # 16 pixels: 48 frame bytes (three 16-byte loads), 16 gray bytes (one)
    assert PIX * 3 % 16 == 0 and PIX % 16 == 0
    # the scan's warp: 32 lanes of 8 bins
    assert BINS == 32 * 8


# -- the plain version against the JAX package and the spec ----------------

def _tie_frame(npx):
    """A frame whose gray histogram ties: two bins of equal count hold
    every pixel (the scan's tie-break takes the later one)."""
    px = np.zeros((npx, 3), np.uint8)
    px[npx // 2:] = 200  # gray 200
    px[:npx // 2] = 90   # gray 90
    return px.reshape(-1)


@pytest.mark.parametrize("case", ["random", "one-value", "tie", "0-255"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_matches_jax_and_spec(layout, case):
    h, w = LAYOUTS[layout]
    npx = h * w
    frame = {"random": _frame(1, npx),
             "one-value": np.full(3 * npx, 77, np.uint8),
             "tie": _tie_frame(npx),
             "0-255": np.where(_frame(2, npx) < 128, 0, 255).astype(
                 np.uint8)}[case]
    got = filters.binarize_pipeline(torch.from_numpy(frame.copy()))
    assert got.dtype == torch.uint8 and got.numel() == frame.size
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_filters.binarize_pipeline(
            jnp.asarray(frame), fused=True)).ravel())
    np.testing.assert_array_equal(got.numpy(), ref.binarize_pipeline(frame))
    np.testing.assert_array_equal(
        filters.binarize_pipeline_reference(torch.from_numpy(frame)).numpy(),
        got.numpy())


@pytest.mark.parametrize("npx", [1, 15, 16, 17, 48 * 50, 12_345])
def test_entries_equal_the_pipeline(npx):
    """``gray_hist`` gives the gray values and their histogram;
    ``binarize_apply`` of the two, into a fresh tensor or a view, equals
    ``binarize_pipeline``, on ragged lengths."""
    frame = torch.from_numpy(_frame(npx, npx))
    gray, h = filters.gray_hist(frame)
    assert gray.dtype == torch.uint8 and h.dtype == torch.int32
    np.testing.assert_array_equal(gray.numpy(),
                                  filters.gray_pixels(frame).numpy())
    np.testing.assert_array_equal(
        h.numpy(), np.bincount(gray.numpy(), minlength=256))
    want = filters.binarize_pipeline(frame).numpy()
    np.testing.assert_array_equal(filters.binarize_apply(gray, h).numpy(),
                                  want)
    big = torch.full((3 * npx + 5,), 9, dtype=torch.uint8)
    filters.binarize_apply(gray, h, out=big[2:2 + 3 * npx])
    np.testing.assert_array_equal(big[2:2 + 3 * npx].numpy(), want)
    assert big[:2].eq(9).all() and big[-3:].eq(9).all()
    out = torch.empty(3 * npx, dtype=torch.uint8)
    assert filters.binarize_pipeline(frame, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("s", [2, 4])
def test_sharded_sum_equals_the_solo_histogram(s):
    """Each row shard's ``gray_hist``, the histograms summed (the JAX
    ``psum``), and ``binarize_apply`` of the sum on each shard: the solo
    frame's histogram and bytes."""
    h, w = 48, 50
    frame = _frame(s, h * w)
    ln = h // s * w * 3
    parts = [filters.gray_hist(torch.from_numpy(frame[i * ln:(i + 1) * ln]
                                                .copy())) for i in range(s)]
    total = sum(p[1] for p in parts)
    np.testing.assert_array_equal(
        total.numpy(), filters.gray_hist(torch.from_numpy(frame))[1].numpy())
    got = np.concatenate([filters.binarize_apply(g, total).numpy()
                          for g, _ in parts])
    np.testing.assert_array_equal(got, ref.binarize_pipeline(frame))


def test_refusals():
    f = torch.zeros(30, dtype=torch.uint8)
    g, h = filters.gray_hist(f)
    for bad in (f[:-1], f.to(torch.int32), f[:0], f.reshape(10, 3)[:, 0]):
        with pytest.raises(ValueError):
            filters.gray_hist(bad)
    for args in ((g.to(torch.int32), h), (g, h.to(torch.int64)),
                 (g, h[:-1])):
        with pytest.raises(ValueError):
            filters.binarize_apply(*args)
    with pytest.raises(ValueError):
        filters.binarize_apply(g, h, out=torch.empty(29, dtype=torch.uint8))
    for fn in (filters.gray_hist_plan, filters.apply_plan):
        with pytest.raises(ValueError):
            fn(0, SMS)


# -- host models of the two launches ----------------------------------------

def _lane_threshold(h):
    """The first warp's scan in ``binarize_apply_kernel``, lane by lane:
    8 bins a lane, the running max of the lanes before (-1 for lane 0),
    each lane's last two indices ``i`` with ``h[i] >= max(h[:i])``, and two
    maxima over the lanes; then the clamped threshold."""
    h = np.asarray(h, np.int64).reshape(32, 8)
    lmax = h.max(axis=1)
    excl = np.concatenate([[-1], np.maximum.accumulate(lmax)[:-1]])
    l1, l2 = np.full(32, -1), np.full(32, -1)
    for lane in range(32):
        run = excl[lane]
        for k in range(8):
            if h[lane, k] >= run:
                l2[lane], l1[lane] = l1[lane], 8 * lane + k
            run = max(run, h[lane, k])
    imax = l1.max()
    isec = np.where(l1 == imax, l2, l1).max()
    s = imax + isec
    return (imax, isec), min(200, max(50, s // 2 if s >= 0 else 0))


EDGE_HISTS = [{10: 5, 30: 5}, {200: 9, 100: 7}, {0: 100}, {255: 1}, {},
              {7: 3, 8: 3, 9: 3}, {0: 1, 255: 1}, {100: 2, 101: 1, 102: 2}]


@pytest.mark.parametrize("case", range(len(EDGE_HISTS)))
def test_lane_scan_matches_top2_scan_edges(case):
    hh = np.zeros(256, np.int64)
    for k, v in EDGE_HISTS[case].items():
        hh[k] = v
    (imax, isec), t = _lane_threshold(hh)
    assert (imax, isec) == ref.top2_scan(hh)
    assert t == ref.binarize_threshold(hh) == int(
        filters.binarize_threshold(torch.from_numpy(hh)))


@settings(deadline=None, max_examples=25)
@given(st.lists(st.integers(0, 50), min_size=256, max_size=256))
def test_lane_scan_and_threshold_match_top2_scan(hh):
    hh = np.asarray(hh, np.int64)
    (imax, isec), t = _lane_threshold(hh)
    assert (imax, isec) == ref.top2_scan(hh)
    assert t == ref.binarize_threshold(hh) == int(
        filters.binarize_threshold(torch.from_numpy(hh)))


def _runs(npx, grid, threads):
    """Which thread takes each run of 16 pixels (block ``b``'s thread
    ``t`` takes run ``b * threads + t`` and every ``grid * threads``
    further), and which takes each pixel of the ragged tail (block 0's
    thread ``t`` takes pixel ``16 * runs + t``): ``(run_owner,
    tail_owner)`` as global thread ids."""
    runs = npx // PIX
    stride = grid * threads
    owner = np.arange(runs) % stride  # thread b * threads + t
    tail = np.arange(npx - runs * PIX)
    assert (tail < threads).all()  # block 0 holds a thread per tail pixel
    return owner, tail


@pytest.mark.parametrize("npx", [1, 15, 16, 17, 1024 * 16 - 1,
                                 1024 * 16 + 17, SMS * 1024 * 16 + 5,
                                 1920 * 1080, 2 * 1920 * 1080 + 3])
def test_gray_hist_plan_covers_every_pixel_once(npx):
    """Launch 1: every pixel's three bytes read and its gray byte written
    by exactly one thread, every read inside the frame; the blocks' sums,
    added to the scratch and swapped out by the last block to finish,
    give the histogram and leave the scratch zero."""
    grid = filters.gray_hist_plan(npx, SMS)
    assert 1 <= grid <= SMS
    owner, tail = _runs(npx, grid, HIST_THREADS)
    runs = npx // PIX
    assert owner.size == 0 or owner.max() < grid * HIST_THREADS
    written = np.zeros(npx, np.int64)
    np.add.at(written, (np.arange(runs)[:, None] * PIX
                        + np.arange(PIX)).reshape(-1), 1)
    written[runs * PIX + tail] += 1
    assert (written == 1).all()
    # a run's 48 bytes start at 48 * run: inside the 3 * npx frame bytes
    assert runs == 0 or 48 * (runs - 1) + 48 <= 3 * npx
    if npx > 300_000:
        return  # the sums below, at the small lengths
    frame = _frame(npx, npx)
    gray = filters.gray_pixels(torch.from_numpy(frame)).numpy()
    block_of_run = owner // HIST_THREADS
    scratch = np.zeros(SCRATCH, np.int64)
    order = np.random.default_rng(npx).permutation(grid)  # finish order
    out = None
    for done, b in enumerate(order):
        px = (np.arange(runs)[block_of_run == b][:, None] * PIX
              + np.arange(PIX)).reshape(-1)
        if b == 0:
            px = np.concatenate([px, runs * PIX + tail])
        scratch[:BINS] += np.bincount(gray[px], minlength=BINS)
        scratch[BINS] += 1
        if scratch[BINS] == grid:  # the last block swaps the sums out
            assert done == grid - 1
            out, scratch[:] = scratch[:BINS].copy(), 0
    assert not scratch.any()
    np.testing.assert_array_equal(
        out, hist.histogram_reference(torch.from_numpy(gray)).numpy())


@pytest.mark.parametrize("npx", [1, 16, 17, 256 * 16 + 3, 1920 * 1080,
                                 SMS * 8 * 256 * 16 * 2 + 15])
def test_apply_plan_writes_every_byte_once(npx):
    """Launch 2: every pixel's three output bytes written by exactly one
    thread; every block scans the histogram itself, so any block's
    threshold is the frame's."""
    grid = filters.apply_plan(npx, SMS)
    assert 1 <= grid <= filters.BIN_APPLY_BLOCKS_PER_SM * SMS
    owner, tail = _runs(npx, grid, APPLY_THREADS)
    runs = npx // PIX
    written = np.zeros(3 * npx, np.int64)
    np.add.at(written, (np.arange(runs)[:, None] * 3 * PIX
                        + np.arange(3 * PIX)).reshape(-1), 1)
    for t in tail:
        written[3 * (runs * PIX + t) + np.arange(3)] += 1
    assert (written == 1).all()
    # runs per thread: whole grid strides, so the grid is never idle while
    # another wave would be needed
    per_thread = np.bincount(owner, minlength=grid * APPLY_THREADS)
    assert per_thread.max() - per_thread.min() <= 1


# -- the served path, and a CUDA tensor never reaching the plain version ----

def test_served_binarize_batched():
    """``--visualizer 5`` through the batched pipeline (B = 3, a pair of
    K9 calls a stream, each into its slice of the aux frame): each
    stream's aux frame equals the spec's."""
    cfg = StreamConfig(height=48, width=50, overlay_scale=4,
                       visualizer=Visualizer.BINARIZE, tiled_payload=True)
    b, n = 3, cfg.frame_bytes
    rng = np.random.default_rng(5)
    prev = rng.integers(0, 256, b * n, dtype=np.uint8)
    cur = rng.integers(0, 256, b * n, dtype=np.uint8)
    cur[n:2 * n] = 200  # one stream with one gray value
    aux = BatchedDeltaPipeline(cfg, b, device="cpu").step(
        torch.from_numpy(prev), torch.from_numpy(cur))[-1].numpy()
    for s in range(b):
        np.testing.assert_array_equal(aux[s * n:(s + 1) * n],
                                      ref.binarize_pipeline(
                                          cur[s * n:(s + 1) * n]))


def test_binarize_on_cuda_launches_or_raises(monkeypatch, no_kernel_build):
    """A CUDA tensor never takes the plain version: without a kernel
    build (no nvcc here) each entry raises, no plain version is called
    and no launch is counted."""
    calls = []
    for name in ("binarize_pipeline_reference", "gray_pixels",
                 "binarize_pixels", "binarize_threshold"):
        monkeypatch.setattr(filters, name, lambda *a, **k: calls.append(a))
    monkeypatch.setattr(hist, "histogram_reference",
                        lambda *a: calls.append(a))
    frame = torch.zeros(48 * 64 * 3, dtype=torch.uint8)
    gray = torch.zeros(48 * 64, dtype=torch.uint8)
    h = torch.zeros(256, dtype=torch.int32)
    before = (filters.gray_hist.launches, filters.binarize_apply.launches)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    for fn in (lambda: filters.binarize_pipeline(frame),
               lambda: filters.gray_hist(frame),
               lambda: filters.binarize_apply(gray, h)):
        with pytest.raises(RuntimeError):
            fn()
    monkeypatch.undo()
    assert not calls
    assert (filters.gray_hist.launches,
            filters.binarize_apply.launches) == before


# -- the overlay region, read in place of the frame's prefix ----------------

def _region_cases(w, npx):
    return {"strip": 9 * w * 3, "straddling": 9 * w * 3 + 6, "odd": 1001,
            "one run": 48, "whole": 3 * npx}


@pytest.mark.parametrize("case", ["strip", "straddling", "odd", "one run",
                                  "whole"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_region_matches_jax_on_the_overlaid_frame(layout, case):
    """``gray_hist`` and ``binarize_pipeline`` with ``region``: the gray
    values, the histogram and the output of the overlaid frame, equal to
    the JAX package's ``binarize_pipeline`` and the spec on it."""
    h, w = LAYOUTS[layout]
    npx = h * w
    frame = _frame(7, npx)
    region = _frame(8, npx)[:_region_cases(w, npx)[case]]
    overlaid = frame.copy()
    overlaid[:region.size] = region
    tf, tr = torch.from_numpy(frame), torch.from_numpy(region)
    gray, h_ = filters.gray_hist(tf, tr)
    np.testing.assert_array_equal(
        gray.numpy(), filters.gray_pixels(torch.from_numpy(overlaid)).numpy())
    np.testing.assert_array_equal(
        h_.numpy(), np.bincount(gray.numpy(), minlength=256))
    want = np.asarray(jax_filters.binarize_pipeline(
        jnp.asarray(overlaid), fused=True)).ravel()
    np.testing.assert_array_equal(want, ref.binarize_pipeline(overlaid))
    np.testing.assert_array_equal(
        filters.binarize_pipeline(tf, region=tr).numpy(), want)
    np.testing.assert_array_equal(
        filters.binarize_pipeline_reference(tf, tr).numpy(), want)
    out = torch.empty(3 * npx, dtype=torch.uint8)
    filters.binarize_pipeline(tf, out=out, region=tr)
    np.testing.assert_array_equal(out.numpy(), want)
    assert np.array_equal(frame, tf.numpy())  # the frame is never written


def test_region_refusals():
    f = torch.zeros(30, dtype=torch.uint8)
    for bad in (torch.zeros(31, dtype=torch.uint8),
                torch.zeros(3, dtype=torch.int32),
                torch.zeros(6, dtype=torch.uint8)[::2]):
        with pytest.raises(ValueError):
            filters.gray_hist(f, bad)
        with pytest.raises(ValueError):
            filters.binarize_pipeline(f, region=bad)


@pytest.mark.parametrize("npx,rlen", [(1, 3), (16, 47), (17, 48), (17, 49),
                                      (48 * 50, 9 * 150 + 6),
                                      (48 * 50, 3 * 48 * 50),
                                      (1920 * 1080, 16 * 5760 + 6),
                                      (1024 * 16 * 3 + 5, 1024 * 48 + 30)])
def test_gray_hist_plan_with_a_region_covers_every_pixel_once(npx, rlen):
    """Launch 1 with a region: the one run that straddles the region's end
    (when it is a whole run) is skipped by its owner and taken a pixel a
    thread by threads 16-31 of block 0, beside the ragged tail on threads
    0-15; every pixel is read and its gray byte written exactly once, a
    whole run's 48 bytes all from the region or all from the frame."""
    grid = filters.gray_hist_plan(npx, SMS)
    runs = npx // PIX
    straddle = rlen // 48 if rlen % 48 and rlen // 48 < runs else -1
    stride = grid * HIST_THREADS
    written = np.zeros(npx, np.int64)
    for tid in range(min(stride, max(runs, 1))):
        i = tid
        if i == straddle:
            i += stride
        while i < runs:
            j0 = 48 * i
            assert j0 >= rlen or j0 + 48 <= rlen  # one source a run
            written[i * PIX:(i + 1) * PIX] += 1
            i += stride
            if i == straddle:
                i += stride
    for t in range(2 * PIX):  # block 0's per-pixel threads
        if t < PIX:
            tp = runs * PIX + t
            if tp < npx:
                written[tp] += 1
        elif straddle >= 0:
            written[straddle * PIX + t - PIX] += 1
    assert (written == 1).all()


def test_gray_hist_with_a_region_on_cuda_launches_or_raises(
        monkeypatch, no_kernel_build):
    """With a region too, a CUDA tensor never takes the plain version and
    no overlaid copy is made: without a kernel build the entries raise."""
    calls = []
    for name in ("binarize_pipeline_reference", "gray_pixels"):
        monkeypatch.setattr(filters, name, lambda *a, **k: calls.append(a))
    monkeypatch.setattr(filters.diff_ops, "region_frame",
                        lambda *a, **k: calls.append(a))
    frame = torch.zeros(48 * 64 * 3, dtype=torch.uint8)
    region = torch.zeros(9 * 64 * 3, dtype=torch.uint8)
    before = filters.gray_hist.launches
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    for fn in (lambda: filters.gray_hist(frame, region),
               lambda: filters.binarize_pipeline(frame, region=region)):
        with pytest.raises(RuntimeError):
            fn()
    monkeypatch.undo()
    assert not calls and filters.gray_hist.launches == before


# -- the fused kernel: one cooperative launch for B streams -----------------

def _fused_model(frames, streams, region, coresident):
    """One launch of ``binarize_fused_kernel`` on the host, as
    ``binarize_plan`` lays it out: block ``g`` of stream ``g //
    per_stream`` takes, thread by thread, runs ``(j * block_runs + k) *
    HIST_THREADS + t``; the first ``REG_RUNS`` of a thread stay in its
    registers, the rest go through the spill buffer at ``b * chunks + i``;
    the stream's first block takes the ragged tail and the straddling run
    a pixel a thread. Each block adds its bincount to its stream's sums;
    the grid barrier waits for every block's arrival; each block's scan
    reads its stream's sums (the first warp's lane scan), arrives again,
    and the block that brings the word to twice the grid empties the
    scratch. Returns the output and the spill slots written; fails if a
    pixel is not taken exactly once, a spill slot twice, or a read leaves
    the stream."""
    n = frames.size // streams
    npx = n // 3
    grid, per_stream, block_runs = filters.binarize_plan(npx, streams,
                                                         coresident)
    assert 1 <= grid <= coresident and grid == streams * per_stream
    rlen = 0 if region is None else region.size // streams
    chunks = npx // PIX
    straddle = rlen // 48 if rlen % 48 and rlen // 48 < chunks else -1
    grays = []
    for b in range(streams):
        ov = frames[b * n:(b + 1) * n].copy()
        if rlen:
            ov[:rlen] = region[b * rlen:(b + 1) * rlen]
        grays.append(filters.gray_pixels(torch.from_numpy(ov)).numpy())
    taken = np.zeros((streams, npx), np.int64)
    spilled = np.zeros(streams * chunks, np.int64)
    scratch = np.zeros(streams * BINS + 1, np.int64)
    t = np.arange(HIST_THREADS)
    mine = []  # per block: (stream, pixels it writes)
    for g in range(grid):
        b, j = divmod(g, per_stream)
        px = []
        for k in range(block_runs):
            i = (j * block_runs + k) * HIST_THREADS + t
            i = i[(i < chunks) & (i != straddle)]
            j0 = 48 * i
            assert ((j0 >= rlen) | (j0 + 48 <= rlen)).all()  # one source
            assert (j0 + 48 <= n).all()
            if k >= REG_RUNS:
                spilled[b * chunks + i] += 1
            px.append((i[:, None] * PIX + np.arange(PIX)).reshape(-1))
        if j == 0:
            tail = chunks * PIX + np.arange(PIX)
            px.append(tail[tail < npx])
            if straddle >= 0:
                px.append(straddle * PIX + np.arange(PIX))
        px = np.concatenate(px) if px else np.zeros(0, np.int64)
        np.add.at(taken[b], px, 1)
        scratch[b * BINS:(b + 1) * BINS] += np.bincount(grays[b][px],
                                                        minlength=BINS)
        mine.append((b, px))
    assert (taken == 1).all() and (spilled <= 1).all()
    # the barrier: every block has arrived before any scan reads
    scratch[-1] += grid
    out = np.zeros(frames.size, np.uint8)
    order = np.random.default_rng(grid).permutation(grid)
    for done, g in enumerate(order):
        b, px = mine[g]
        _, thr = _lane_threshold(scratch[b * BINS:(b + 1) * BINS])
        v = np.where(grays[b][px] > thr, 255, 0).astype(np.uint8)
        for c in range(3):
            out[b * n + 3 * px + c] = v
        scratch[-1] += 1
        if scratch[-1] == 2 * grid:  # the last block empties the scratch
            assert done == grid - 1
            scratch[:] = 0
    assert not scratch.any()
    return out, int(spilled.sum())


@pytest.mark.parametrize("npx,streams,rlen,coresident", [
    (1, 1, 0, SMS), (15, 1, 3, SMS), (16, 1, 47, SMS), (17, 2, 49, SMS),
    (48 * 50, 3, 9 * 150 + 6, SMS), (12_345, 4, 1001, SMS),
    (1024 * 16 * 3 + 5, 1, 1024 * 48 + 30, 2),   # 4 runs a thread
    (1024 * 16 * 9 + 7, 2, 48 * 7, 4),           # past the register budget
    (1024 * 16 * 5, 1, 0, 1),                    # one block, 5 runs
    (777, 8, 0, 8)])
def test_fused_plan_covers_every_pixel_once(npx, streams, rlen, coresident):
    """The fused kernel's plan and model: every pixel of every stream
    taken by one thread, the overflow runs once each through the spill
    buffer, the scratch left zero, and the bytes of the plain version on
    each stream."""
    frames = _frame(npx + streams, npx * streams)
    region = (_frame(rlen, npx * streams)[:rlen * streams] if rlen
              else None)
    got, spilled = _fused_model(frames, streams, region, coresident)
    _, _, block_runs = filters.binarize_plan(npx, streams, coresident)
    assert (spilled > 0) == (block_runs > REG_RUNS and npx >= PIX
                             * HIST_THREADS * REG_RUNS)
    want = filters.binarize_pipeline(
        torch.from_numpy(frames), region=(None if region is None
                                          else torch.from_numpy(region)),
        streams=streams).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("streams", [1, 2, 3, 4, 8, 16, 132])
@pytest.mark.parametrize("coresident", [SMS, 2 * SMS, 7])
def test_binarize_plan_fits_the_card(streams, coresident):
    """The cooperative grid never exceeds the co-resident blocks it is
    given, covers every run of every stream, and keeps a 1080p frame and
    a batched 1080p frame of B = 4 in registers on an H100 (one block an
    SM); more streams than co-resident blocks raise."""
    npx = 1920 * 1080
    if streams > coresident:
        with pytest.raises(ValueError):
            filters.binarize_plan(npx, streams, coresident)
        return
    grid, per_stream, block_runs = filters.binarize_plan(npx, streams,
                                                         coresident)
    assert grid == streams * per_stream <= coresident
    assert per_stream * block_runs * HIST_THREADS >= npx // PIX
    # no block idle: the last block of a stream has a run
    assert (per_stream - 1) * block_runs * HIST_THREADS < npx // PIX
    if coresident == SMS and streams <= 4:
        assert block_runs <= REG_RUNS
    if (coresident, streams) == (SMS, 1):
        assert (grid, block_runs) == (127, 1)
    if (coresident, streams) == (SMS, 4):
        assert (grid, block_runs) == (128, 4)


def test_binarize_plan_refusals():
    for args in ((0, 1, SMS), (16, 0, SMS), (16, 1, 0)):
        with pytest.raises(ValueError):
            filters.binarize_plan(*args)


@pytest.mark.parametrize("b", [2, 3, 4])
@pytest.mark.parametrize("rlen", [0, 9 * 150 + 6])
def test_batched_fused_call_equals_solo_calls_and_jax(b, rlen):
    """``binarize_pipeline(streams=B)`` with each stream's strip equals B
    solo plain calls and the JAX ``binarize_pipeline`` on each stream's
    overlaid frame, a stream of one gray value included; into ``out`` as
    well."""
    h, w = 48, 50
    n = h * w * 3
    frames = _frame(b + rlen, h * w * b)
    frames[n:2 * n] = 200  # one stream of one gray value
    strips = _frame(b * 7, h * w * b)[:b * rlen] if rlen else None
    got = filters.binarize_pipeline(
        torch.from_numpy(frames),
        region=None if strips is None else torch.from_numpy(strips),
        streams=b).numpy()
    for s in range(b):
        fr = frames[s * n:(s + 1) * n]
        reg = None if strips is None else strips[s * rlen:(s + 1) * rlen]
        solo = filters.binarize_pipeline_reference(
            torch.from_numpy(fr.copy()),
            None if reg is None else torch.from_numpy(reg.copy())).numpy()
        np.testing.assert_array_equal(got[s * n:(s + 1) * n], solo)
        ov = fr.copy()
        if reg is not None:
            ov[:rlen] = reg
        np.testing.assert_array_equal(
            got[s * n:(s + 1) * n], np.asarray(jax_filters.binarize_pipeline(
                jnp.asarray(ov), fused=True)).ravel())
    out = torch.empty(b * n, dtype=torch.uint8)
    assert filters.binarize_pipeline(
        torch.from_numpy(frames), out=out,
        region=None if strips is None else torch.from_numpy(strips),
        streams=b) is out
    np.testing.assert_array_equal(out.numpy(), got)


def test_fused_refusals():
    f = torch.zeros(2 * 30, dtype=torch.uint8)
    for kw in ({"streams": 0}, {"streams": 7},
               {"streams": 2, "region": torch.zeros(3, dtype=torch.uint8)},
               {"out": torch.empty(59, dtype=torch.uint8)}):
        with pytest.raises(ValueError):
            filters.binarize_pipeline(f, **kw)


def test_fused_on_cuda_launches_or_raises(monkeypatch, no_kernel_build):
    """The batched call on a CUDA tensor never takes the plain version:
    without a kernel build it raises and counts no launch."""
    calls = []
    monkeypatch.setattr(filters, "binarize_pipeline_reference",
                        lambda *a, **k: calls.append(a))
    frame = torch.zeros(4 * 48 * 64 * 3, dtype=torch.uint8)
    before = filters.binarize_pipeline.launches
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    with pytest.raises(RuntimeError):
        filters.binarize_pipeline(frame, streams=4)
    monkeypatch.undo()
    assert not calls and filters.binarize_pipeline.launches == before


def _run_bits(gray16, t):
    """``run_bits``: per 4 gray bytes a byte compare (``__vcmpgtu4``), its
    0x80 bits times 0x00204081 shifted down 28, 4 bits a word."""
    words = np.asarray(gray16, np.uint8).view(np.uint32)
    m = 0
    for q, g in enumerate(words):
        b = np.frombuffer(np.uint32(g).tobytes(), np.uint8)
        c = int(np.frombuffer(np.where(b > t, 0xFF, 0).astype(np.uint8)
                              .tobytes(), np.uint32)[0]) & 0x80808080
        m |= (((c * 0x00204081) & 0xFFFFFFFF) >> 28) << (4 * q)
    return m


def _store_table():
    """``make_store_table``: entry ``64 r + m``, 16 bytes from ``r`` bytes
    into a pixel over the 6 pixels whose bits are ``m``."""
    lut = np.zeros((3 * 64, 16), np.uint8)
    for e in range(3 * 64):
        r, m = divmod(e, 64)
        for j in range(16):
            if (m >> ((r + j) // 3)) & 1:
                lut[e, j] = 255
    return lut


@pytest.mark.parametrize("seed", range(6))
def test_warp_store_model_writes_each_pixels_bytes(seed):
    """A warp's coalesced store (``store_warp``): lane ``l``'s 16-byte
    chunk ``32 i + l`` of the warp's 1,536 bytes, from the bits of two
    lanes' runs (two shuffles) through the table, gives every pixel's
    three bytes 255 or 0 by its gray value against the threshold; and
    ``run_bits`` gives a run's bits."""
    rng = np.random.default_rng(seed)
    t = int(rng.integers(50, 201))
    gray = rng.integers(0, 256, (32, PIX), dtype=np.uint8)
    if seed == 1:
        gray[:] = t       # equal to the threshold: all 0
    if seed == 2:
        gray[:] = t + 1   # just above: all 255
    bits = [_run_bits(g, t) for g in gray]
    for g, m in zip(gray, bits):
        assert m == sum(1 << k for k in range(PIX) if g[k] > t)
    lut = _store_table()
    out = np.zeros(32 * 3 * PIX, np.uint8)  # 1,536 bytes
    written = np.zeros(out.size, np.int64)
    for i in range(3):
        for lane in range(32):
            b0 = 16 * (32 * i + lane)
            p0, r = divmod(b0, 3)
            a = p0 >> 4
            ma, mb = bits[a], bits[min(a + 1, 31)]
            m6 = ((ma | (mb << 16)) >> (p0 & 15)) & 63
            out[b0:b0 + 16] = lut[64 * r + m6]
            written[b0:b0 + 16] += 1
    assert (written == 1).all()
    want = np.repeat(np.where(gray.reshape(-1) > t, 255, 0).astype(np.uint8),
                     3)
    np.testing.assert_array_equal(out, want)
