"""K14, the hand-written status-text overlay (``csrc/overlay.cu``), on the
CPU: its plain version (``ops/overlay.py`` ``overlay_blit_reference``,
the entry on a CPU tensor) against ``reference_cpu.overlay_blit`` and the
JAX package's ``overlay_blit``, byte for byte, at 48x64 and on 1080p
strips, in both fonts, with 0, 1, 18 and 28 characters, a text longer
than a row holds and a cell taller than the frame; the B-stream form
(``overlay_blit_streams``) against B solo calls, a text and a count
drawn a stream; a host model of one launch, lane by lane (every output
byte written once, by one lane; every frame read inside its stream's
strip and under a glyph only at its edge, every atlas read inside the
cells of the stream's first ``n_fit`` ids; the bytes at the glyph rows'
90-B edges and at the glyph/frame edge inside a vector equal the plain
version's); the
plan's one wave; the pipelines' one call a step; and the wrappers on a
CUDA tensor, which launch or raise. Tolerance is zero throughout.

The kernel itself is held against its plain version on the card by
``chip_smoke.py``.
"""

import collections
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavideostream_tpu.ops import overlay as jax_overlay
from cudavideostream_tpu_torch.config import StreamConfig
from cudavideostream_tpu_torch.kernels import build, launch
from cudavideostream_tpu_torch.models import (
    BatchedDeltaPipeline,
    DeltaStreamPipeline,
)
from cudavideostream_tpu_torch.models.pipeline import MAX_OVERLAY_CHARS
from cudavideostream_tpu_torch.ops import overlay
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.utils import fonts
from torch_kernel_fixtures import no_kernel_build  # noqa: F401

CSRC = Path(overlay.__file__).resolve().parent.parent / "csrc"
SMS = 132  # an H100 SXM's SMs
STATUS = "FPS: 30 BW: 5 kbps"  # the benchmark's 18-character status line
LONG = "FPS: 30 BW: 1234567 kbps OK!"  # 28 characters, MAX_OVERLAY_CHARS
FONTS = {"stroke5": (5, "stroke"), "stroke4": (4, "stroke"),
         "bitmap5": (5, "bitmap"), "bitmap2": (2, "bitmap")}


def _constexpr(name):
    """``constexpr int name = ...;`` in ``csrc/overlay.cu``."""
    code = re.sub(r"//[^\n]*", "", (CSRC / "overlay.cu").read_text())
    return int(re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+);",
                         code).group(1))


THREADS = _constexpr("kThreads")
BLOCKS_PER_SM = _constexpr("kBlocksPerSm")
VEC = _constexpr("kVec")


def _bytes(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _atlas(font):
    scale, style = FONTS[font]
    return fonts.make_atlas(scale, style)


def _text(n_chars):
    return (LONG * 2)[:n_chars]


def test_constants_read_from_the_kernel():
    assert (THREADS, BLOCKS_PER_SM, VEC) == (
        overlay.OVERLAY_THREADS, overlay.OVERLAY_BLOCKS_PER_SM,
        overlay.OVERLAY_VEC)
    assert THREADS % 32 == 0 and VEC == 16
    assert len(LONG) == MAX_OVERLAY_CHARS and len(STATUS) == 18


# -- the plain version against the spec and the JAX package ------------------

# (height, width, rows blended): a whole 48x64 frame, the 1080p strip
LAYOUTS = {"48x64": (48, 64, None), "1080p_strip": (1080, 1920, "cell")}


@pytest.mark.parametrize("font", list(FONTS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("n_chars", [0, 1, 18, 28])
def test_plain_matches_spec_and_jax(layout, font, n_chars):
    """``overlay_blit`` on a CPU frame (its plain version) equals
    ``reference_cpu.overlay_blit`` and the JAX package's blit on the same
    bytes. At 48x64 most fonts hold fewer cells than the text (a text
    longer than fits) and ``stroke5``'s 50-row cell is taller than the
    frame (the frame comes back unchanged)."""
    h, w, rows = LAYOUTS[layout]
    atlas = _atlas(font)
    cell_h, cell_w = atlas.shape[1:3]
    rows = cell_h if rows == "cell" else h
    n = rows * w * 3
    cur = _bytes(n_chars + cell_h, n)
    text = _text(n_chars)
    ids = fonts.encode_text(text, MAX_OVERLAY_CHARS)
    got = overlay.overlay_blit(torch.from_numpy(cur), torch.from_numpy(atlas),
                               torch.tensor(ids, dtype=torch.int32), n_chars,
                               rows, w).numpy()
    want = ref.overlay_blit(cur, atlas, ids[:n_chars], rows, w)
    np.testing.assert_array_equal(got, want)
    jax_got = jax_overlay.overlay_blit(
        jnp.asarray(cur), jnp.asarray(atlas), jnp.asarray(ids, jnp.int32),
        jnp.int32(n_chars), rows, w)
    np.testing.assert_array_equal(np.asarray(jax_got), want)
    fit = min(n_chars, w // cell_w) if cell_h <= rows else 0
    changed = (got != cur).reshape(rows, w * 3)
    assert not changed[:, fit * cell_w * 3:].any()
    assert not changed[cell_h:].any()
    if layout == "48x64" and font == "stroke5":
        assert cell_h > h and not changed.any()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_plain_takes_either_index_type(dtype):
    atlas = _atlas("stroke4")
    cur = _bytes(3, 40 * 64 * 3)
    ids = fonts.encode_text(STATUS, MAX_OVERLAY_CHARS)
    got = overlay.overlay_blit(torch.from_numpy(cur), torch.from_numpy(atlas),
                               torch.tensor(ids, dtype=dtype), 18, 40, 64)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.overlay_blit(cur, atlas, ids, 40, 64))


def test_refusals():
    atlas = torch.from_numpy(_atlas("stroke4"))
    f = torch.zeros(40 * 64 * 3, dtype=torch.uint8)
    ids = torch.zeros(MAX_OVERLAY_CHARS, dtype=torch.int32)
    bids, nfit = overlay.text_glyphs(["A", "B"], MAX_OVERLAY_CHARS, 2, "cpu")
    for fn in (lambda: overlay.overlay_blit(f[:-1], atlas, ids, 1, 40, 64),
               lambda: overlay.overlay_blit(f.view(40, -1), atlas, ids, 1,
                                            40, 64),
               lambda: overlay.overlay_blit(f.to(torch.int32), atlas, ids, 1,
                                            40, 64),
               lambda: overlay.overlay_blit(f, atlas[..., :2], ids, 1, 40,
                                            64),
               lambda: overlay.overlay_blit_streams(f, atlas, bids, nfit, 40,
                                                    64, 2),
               lambda: overlay.overlay_blit_streams(
                   torch.cat([f, f]), atlas, bids[:1], nfit, 40, 64, 2),
               lambda: overlay.overlay_blit_streams(
                   torch.cat([f, f]), atlas, bids, nfit[:1], 40, 64, 2),
               lambda: overlay.overlay_plan(0, SMS),
               lambda: overlay.overlay_plan(16, 0)):
        with pytest.raises(ValueError):
            fn()


# -- B streams in one call ---------------------------------------------------

@pytest.mark.parametrize("font", ["stroke5", "bitmap2"])
@pytest.mark.parametrize("texts", [
    [STATUS], [STATUS, "", LONG, "A"], ["", "X", STATUS + " more"],
    ["", ""]], ids=["b1", "b4", "b3_long", "b2_empty"])
def test_streams_equal_solo_calls(texts, font):
    """``overlay_blit_streams`` on B 1080p frames, each with its own text
    (and ``n_fit``), equals B solo calls on each stream's strip, in
    stream order; ``text_glyphs`` gives each stream's ids and count."""
    atlas = _atlas(font)
    cell_h, cell_w = atlas.shape[1:3]
    b, sn = len(texts), 1080 * 1920 * 3
    frames = _bytes(b, b * sn)
    ids, n_fit = overlay.text_glyphs(texts, MAX_OVERLAY_CHARS,
                                     1920 // cell_w, "cpu")
    assert ids.dtype == n_fit.dtype == torch.int32
    assert ids.shape == (b, MAX_OVERLAY_CHARS)
    assert n_fit.tolist() == [min(len(t), MAX_OVERLAY_CHARS, 1920 // cell_w)
                              for t in texts]
    got = overlay.overlay_blit_streams(
        torch.from_numpy(frames), torch.from_numpy(atlas), ids, n_fit, cell_h,
        1920, b).numpy()
    strip = cell_h * 1920 * 3
    assert got.shape == (b * strip,)
    for s, t in enumerate(texts):
        solo = overlay.overlay_blit(
            torch.from_numpy(frames[s * sn:s * sn + strip]),
            torch.from_numpy(atlas), ids[s], min(len(t), MAX_OVERLAY_CHARS),
            cell_h, 1920).numpy()
        np.testing.assert_array_equal(got[s * strip:(s + 1) * strip], solo)
        np.testing.assert_array_equal(
            solo, ref.overlay_blit(frames[s * sn:s * sn + strip], atlas,
                                   fonts.encode_text(t)[:MAX_OVERLAY_CHARS],
                                   cell_h, 1920))


def test_streams_with_a_cell_taller_than_the_frame():
    atlas = torch.from_numpy(_atlas("stroke5"))  # 50-row cells
    frames = torch.from_numpy(_bytes(9, 2 * 48 * 64 * 3))
    ids, n_fit = overlay.text_glyphs(["AB", "C"], MAX_OVERLAY_CHARS, 2, "cpu")
    got = overlay.overlay_blit_streams(frames, atlas, ids, n_fit, 48, 64, 2)
    np.testing.assert_array_equal(got.numpy(), frames.numpy())
    assert got.data_ptr() != frames.data_ptr()


# -- a host model of one launch, lane by lane ---------------------------------

def _k14_model(frames, stride, atlas, ids, n_fit, nfit, rows, width,
               streams, frame_off=0):
    """One K14 launch as ``csrc/overlay.cu`` runs it, vector by vector:
    each lane's path (``vector``: one 16-byte copy; ``glyph``: its 16
    bytes picked from the atlas; ``edge``: the frame's vector with the
    atlas bytes left of the glyphs' edge merged in; ``bytes``: byte by
    byte), its reads and its writes. ``frame_off`` is the frame's address
    mod 16 (a view; the output comes from ``torch.empty``, aligned)."""
    n_glyphs, cell_h, cell_w, _ = atlas.shape
    cw3, row = cell_w * 3, width * 3
    strip = rows * row
    total = streams * strip
    max_chars = ids.shape[1]
    flat = atlas.reshape(-1)
    out = np.zeros(total, np.uint8)
    wrote = np.zeros(total, np.int64)
    owner = np.full(total, -1, np.int64)
    frame_reads, atlas_reads, id_reads, edge_vectors = [], [], [], []
    paths = collections.Counter()
    grid = overlay.overlay_plan(total, SMS)

    def drawn(b):
        nf = int(n_fit[b]) if n_fit is not None else nfit
        return max(0, min(nf, max_chars, row // cw3))

    def glyph_row(b, j, r):
        id_reads.append((b, j))
        g = min(max(int(ids[b, j]), 0), n_glyphs - 1)
        return g, (g * cell_h + r) * cw3

    def blit_byte(o):
        b, k = divmod(o, strip)
        r, c = divmod(k, row)
        if r < cell_h and c < drawn(b) * cw3:
            j = c // cw3
            g, base = glyph_row(b, j, r)
            atlas_reads.append((b, g, r, c - j * cw3))
            return flat[base + c - j * cw3]
        frame_reads.append((b, b * stride + k))
        return frames[b * stride + k]

    def put(o, value, v):
        out[o] = value
        wrote[o] += 1
        owner[o] = v % (grid * THREADS)

    for v in range(-(-total // VEC)):
        o0 = v * VEC
        b, k0 = divmod(o0, strip)
        r, c0 = divmod(k0, row)
        src = b * stride + k0
        if (k0 + VEC <= strip and c0 + VEC <= row
                and (frame_off + src) % 16 == 0):
            edge = drawn(b) * cw3 if r < cell_h else 0
            if c0 >= edge:
                for e in range(VEC):
                    frame_reads.append((b, src + e))
                    put(o0 + e, frames[src + e], v)
                paths["vector"] += 1
                continue
            if cw3 >= VEC:
                m = min(edge - c0, VEC)
                j, off = divmod(c0, cw3)
                cells = [glyph_row(b, j, r)]
                cells.append(glyph_row(b, j + 1, r) if off + m > cw3
                             else cells[0])
                if m < VEC:
                    frame_reads.extend((b, src + e) for e in range(VEC))
                    edge_vectors.append(src)
                for e in range(VEC):
                    if e < m:
                        o = off + e
                        g, base = cells[o >= cw3]
                        o -= cw3 * (o >= cw3)
                        atlas_reads.append((b, g, r, o))
                        put(o0 + e, flat[base + o], v)
                    else:
                        put(o0 + e, frames[src + e], v)
                paths["glyph" if m == VEC else "edge"] += 1
                continue
        for e in range(min(VEC, total - o0)):
            put(o0 + e, blit_byte(o0 + e), v)
        paths["bytes"] += 1
    return (out, wrote, owner, frame_reads, atlas_reads, id_reads,
            edge_vectors, paths, drawn)


# (height, width, rows blended, font, texts, nfit by value, frame offset)
MODEL_CASES = {
    "1080p_b1_status": (1080, 1920, "cell", "stroke5", [STATUS], None, 0),
    "1080p_b1_by_value": (1080, 1920, "cell", "stroke5", [STATUS], 18, 0),
    "1080p_b4_texts": (1080, 1920, "cell", "stroke5",
                       [STATUS, "", LONG, "A"], None, 0),
    "1080p_b2_bitmap": (1080, 1920, "cell", "bitmap5", [LONG, "FPS 9"],
                        None, 0),
    "48x64_long": (48, 64, "cell", "stroke4", [LONG, STATUS], None, 0),
    "48x64_whole_frame": (48, 64, None, "stroke4", ["AB"], None, 0),
    "48x50_rows_straddle": (48, 50, "cell", "bitmap2", [STATUS, "Q"],
                            None, 0),
    "48x64_view_3": (48, 64, "cell", "bitmap2", [STATUS, "", "Z"], None, 3),
    "271x1917_view_7": (271, 1917, "cell", "stroke5", [LONG, STATUS],
                        None, 7),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_launch_model_reads_inside_and_writes_once(case):
    """Every output byte is written once, by one lane of the plan's grid;
    each frame byte right of the glyphs (or below the cells) is read once,
    inside its stream's strip, and a frame byte under a glyph only by the
    vector across a row's glyph edge; every atlas read is a byte of row r of a cell of the stream's first
    ``n_fit`` ids, and every id read one of those; the bytes equal the
    plain version's, at the 90-B edges of the glyph rows inside a vector,
    at the glyph/frame edge inside a vector, at rows and streams that
    split a vector and on unaligned views. On aligned 1080p strips no
    vector goes byte by byte: only the one holding a row's glyph edge
    reads frame bytes under the glyphs."""
    h, w, rows, font, texts, nfit, frame_off = MODEL_CASES[case]
    atlas = _atlas(font)
    cell_h, cell_w = atlas.shape[1:3]
    cw3 = cell_w * 3
    rows = cell_h if rows == "cell" else h
    b = len(texts)
    stride = h * w * 3
    strip = rows * w * 3
    frames = _bytes(b + h, b * stride)
    ids, n_fit = overlay.text_glyphs(texts, MAX_OVERLAY_CHARS, w // cell_w,
                                     "cpu")
    ids_np = ids.numpy()
    (got, wrote, owner, frame_reads, atlas_reads, id_reads, edge_vectors,
     paths, drawn) = _k14_model(frames, stride, atlas, ids_np,
                                None if nfit is not None else n_fit.numpy(),
                                nfit, rows, w, b, frame_off)
    assert (wrote == 1).all()
    assert owner.min() >= 0
    assert owner.max() < overlay.overlay_plan(b * strip, SMS) * THREADS
    # the frame: each byte right of the glyphs (or below the cells) once;
    # under a glyph only inside a vector across the glyphs' edge
    glyph = np.zeros((b, rows, w * 3), bool)
    for s in range(b):
        glyph[s, :cell_h, :drawn(s) * cw3] = True
    reads = np.zeros(b * stride, np.int64)
    for s, i in frame_reads:
        assert s * stride <= i < s * stride + strip
        reads[i] += 1
    want_reads = np.zeros((b, stride), np.int64)
    want_reads[:, :strip] = ~glyph.reshape(b, -1)
    want_reads = want_reads.reshape(-1)
    for src in edge_vectors:
        want_reads[src:src + VEC] = 1
    np.testing.assert_array_equal(reads, want_reads)
    # the atlas: row r of a cell of the stream's first n_fit ids
    for s, j in id_reads:
        assert 0 <= j < drawn(s)
    for s, g, r, off in atlas_reads:
        assert g in set(ids_np[s, :drawn(s)].tolist())
        assert 0 <= r < cell_h and 0 <= off < cw3
    assert len(atlas_reads) == glyph.sum()
    want = np.concatenate([
        overlay.overlay_blit_reference(
            torch.from_numpy(frames[s * stride:s * stride + strip]),
            torch.from_numpy(atlas), ids[s],
            nfit if nfit is not None else len(texts[s]), rows, w).numpy()
        for s in range(b)])
    np.testing.assert_array_equal(got, want)
    if frame_off:
        assert paths["vector"] == paths["glyph"] == paths["edge"] == 0
    if case.startswith("1080p"):
        # one vector a row holds the glyph edge (18 x 90 = 1,620 B, 4 past
        # a vector), except where the edge falls on a vector's boundary;
        # no vector goes byte by byte
        edges = sum(cell_h for s in range(b)
                    if drawn(s) and drawn(s) * cw3 % VEC)
        assert paths["bytes"] == 0 and paths["edge"] == edges
        assert sum(paths.values()) == b * strip // VEC
        assert paths["glyph"] == sum(
            cell_h * (drawn(s) * cw3 // VEC) for s in range(b))


@pytest.mark.parametrize("n,want", [
    (288_000, 141),           # one 1080p strip: 18,000 vectors
    (4 * 288_000, 563),       # four strips
    (16 * 288_000, 8 * SMS),  # sixteen: one wave, two vectors some lanes
    (1, 1), (16 * THREADS, 1), (16 * THREADS + 1, 2)])
def test_plan_is_one_wave(n, want):
    grid = overlay.overlay_plan(n, SMS)
    assert grid == want
    assert grid <= BLOCKS_PER_SM * SMS
    vecs = -(-n // VEC)
    per_lane = np.bincount(np.arange(vecs) % (grid * THREADS))
    assert per_lane.max() - per_lane.min() <= 1


# -- the pipelines: one call a step --------------------------------------------

def _spy(monkeypatch, name, calls):
    real = getattr(overlay, name)

    def spy(*a, **k):
        calls.append((name, a))
        return real(*a, **k)

    monkeypatch.setattr(overlay, name, spy)


@pytest.mark.parametrize("streams", [1, 3])
def test_pipelines_blit_once_a_step(streams, monkeypatch):
    """The solo step calls ``overlay_blit`` once a step on its strip, the
    batched step ``overlay_blit_streams`` once for every stream (no
    ``torch.cat`` of solo strips), each with the int32 ids its
    ``overlay.Glyphs`` keeps for the text (the tuple of texts): the same
    buffers every step, so a CUDA graph's pointers stay valid. Each
    stream's payload equals ``step_oracle``'s."""
    cfg = StreamConfig(height=48, width=64, overlay_scale=4,
                       tiled_payload=True)
    n = cfg.frame_bytes
    calls = []
    _spy(monkeypatch, "overlay_blit", calls)
    _spy(monkeypatch, "overlay_blit_streams", calls)
    texts = ["FPS 30", "", "AB C"][:streams]
    prev = _bytes(1, streams * n)
    frames = [_bytes(2 + i, streams * n) for i in range(2)]
    if streams == 1:
        pipe = DeltaStreamPipeline(cfg, device="cpu")
        state = pipe.init_state(prev)
        outs = [pipe.step(state, f, text=texts[0]) for f in frames]
    else:
        pipe = BatchedDeltaPipeline(cfg, streams, device="cpu")
        state = pipe.init_state(prev.reshape(streams, n))
        outs = [pipe.step(state, f, texts) for f in frames]
    want = "overlay_blit" if streams == 1 else "overlay_blit_streams"
    assert [c[0] for c in calls] == [want, want]
    cell_h = pipe.atlas_np.shape[1]
    for (_, a) in calls:
        assert a[0].numel() == (cell_h * 64 * 3 if streams == 1
                                else streams * n)
        ids = a[2]
        assert ids.dtype == torch.int32
        assert ids.data_ptr() == calls[0][1][2].data_ptr()
        if streams > 1:
            assert a[3] is calls[0][1][3]
            assert a[3].tolist() == [min(len(t), 64 // 24) for t in texts]
            assert a[4:] == (cell_h, 64, streams)
    # the payload of the last step against the oracle, every stream
    ref_prev = prev.copy()
    for f in frames:
        for s in range(streams):
            e = ref.step_oracle(ref_prev[s * n:(s + 1) * n],
                                f[s * n:(s + 1) * n], cfg, pipe.atlas_np,
                                fonts.encode_text(texts[s]))
            ref_prev[s * n:(s + 1) * n] = e[0]
    np.testing.assert_array_equal(state.numpy(), ref_prev)
    del outs


# -- a CUDA tensor launches K14 or raises ------------------------------------

class _FakeLib:
    """``csrc/overlay.cu``'s C entry as ``ctypes`` would bind it,
    recording each launch's arguments."""

    def __init__(self, rc=0):
        self.rc = rc
        self.launches = []

    def cvs_overlay(self, *args):
        self.launches.append(args)
        return self.rc

    def cvs_error_string(self, rc):
        return b"invalid argument"


@pytest.fixture
def on_cuda(monkeypatch):
    """Every tensor reports ``cuda:0`` and the card's queries answer as an
    H100's, asked anew (``launch``'s device facts start empty); buffers
    stay on the CPU. No plain version may be called."""
    calls = []
    monkeypatch.setattr(launch, "_facts", {})
    monkeypatch.setattr(overlay, "overlay_blit_reference",
                        lambda *a, **k: calls.append(a))
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k:
                        real_empty(*a, **k))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i:
                        type("P", (), {"multi_processor_count": SMS}))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    yield calls
    monkeypatch.undo()
    assert not calls


def _solo_args():
    atlas = torch.from_numpy(_atlas("stroke5"))
    frame = torch.from_numpy(_bytes(4, 50 * 1920 * 3))
    ids = torch.tensor(fonts.encode_text(STATUS, MAX_OVERLAY_CHARS),
                       dtype=torch.int32)
    return frame, atlas, ids


def _batched_args(b=4):
    atlas = torch.from_numpy(_atlas("stroke5"))
    frames = torch.from_numpy(_bytes(5, b * 60 * 1920 * 3))
    ids, n_fit = overlay.text_glyphs([STATUS, "", LONG, "A"][:b],
                                     MAX_OVERLAY_CHARS, 64, "cpu")
    return frames, atlas, ids, n_fit


@pytest.mark.parametrize("entry", ["solo", "solo_int64", "streams"])
def test_on_cuda_one_launch(entry, on_cuda, monkeypatch):
    """With the library bound, each entry makes exactly one launch (one
    more in ``overlay_blit.launches``) with the geometry of its strips:
    the row, the rows, the stride between streams, the characters drawn
    by value (solo) or through the device ``n_fit`` (streams), the
    plan's grid; it returns the launch's output, one strip a stream."""
    lib = _FakeLib()
    monkeypatch.setattr(build, "_loaded", {"overlay": lib})
    before = overlay.overlay_blit.launches
    if entry.startswith("solo"):
        frame, atlas, ids = _solo_args()
        if entry == "solo_int64":
            ids = ids.to(torch.int64)
        out = overlay.overlay_blit(frame, atlas, ids, len(STATUS), 50, 1920)
        b, stride, nfit_ptr, nfit = 1, frame.numel(), None, 18
    else:
        frame, atlas, ids, n_fit = _batched_args()
        out = overlay.overlay_blit_streams(frame, atlas, ids, n_fit, 50, 1920,
                                           4)
        b, stride = 4, 60 * 1920 * 3
        nfit_ptr, nfit = n_fit.data_ptr(), 0
    assert overlay.overlay_blit.launches == before + 1
    (args,) = lib.launches
    (dev, fptr, got_stride, aptr, n_glyphs, cell_h, cw3, iptr, max_chars,
     nptr, got_nfit, row, rows, streams, grid, optr, stream) = args
    assert (dev, fptr, got_stride, aptr) == (0, frame.data_ptr(), stride,
                                             atlas.data_ptr())
    assert (n_glyphs, cell_h, cw3, max_chars) == (22, 50, 90,
                                                  MAX_OVERLAY_CHARS)
    if entry == "streams":
        assert iptr == ids.data_ptr()
    assert (nptr, got_nfit) == (nfit_ptr, nfit)
    assert (row, rows, streams, stream) == (1920 * 3, 50, b, 7)
    assert grid == overlay.overlay_plan(b * 288_000, SMS)
    assert out.numel() == b * 288_000 and optr == out.data_ptr()


def test_on_cuda_a_failed_launch_raises(on_cuda, monkeypatch):
    monkeypatch.setattr(build, "_loaded", {"overlay": _FakeLib(rc=1)})
    before = overlay.overlay_blit.launches
    frame, atlas, ids = _solo_args()
    with pytest.raises(RuntimeError, match="invalid argument"):
        overlay.overlay_blit(frame, atlas, ids, 18, 50, 1920)
    assert overlay.overlay_blit.launches == before


def test_on_cuda_without_a_build_raises(on_cuda, no_kernel_build):
    """Without a kernel build (no nvcc here) each entry raises on a CUDA
    tensor, no plain version is called and no launch is counted."""
    before = overlay.overlay_blit.launches
    frame, atlas, ids = _solo_args()
    bframes, batlas, bids, n_fit = _batched_args()
    for fn in (lambda: overlay.overlay_blit(frame, atlas, ids, 18, 50, 1920),
               lambda: overlay.overlay_blit(frame, atlas, ids, 0, 50, 1920),
               lambda: overlay.overlay_blit_streams(bframes, batlas, bids,
                                                    n_fit, 50, 1920, 4)):
        with pytest.raises(RuntimeError, match="nvcc"):
            fn()
    assert overlay.overlay_blit.launches == before


def test_on_cuda_a_cell_taller_than_the_frame_clones(on_cuda, monkeypatch):
    """The one path that launches nothing: no cell fits the frame."""
    lib = _FakeLib()
    monkeypatch.setattr(build, "_loaded", {"overlay": lib})
    before = overlay.overlay_blit.launches
    atlas = torch.from_numpy(_atlas("stroke5"))
    frame = torch.from_numpy(_bytes(6, 48 * 64 * 3))
    ids = torch.zeros(MAX_OVERLAY_CHARS, dtype=torch.int32)
    out = overlay.overlay_blit(frame, atlas, ids, 5, 48, 64)
    assert torch.equal(out, frame) and out.data_ptr() != frame.data_ptr()
    assert not lib.launches and overlay.overlay_blit.launches == before


def test_sharded_band_launches_k14_on_its_shards(on_cuda, monkeypatch):
    """The sharded step at S = 8 on 48x64 frames (6 rows a shard) with the
    10-row glyph band of scale 1: only shards 0 and 1 launch K14, each on
    its first ``h`` rows (6, then 4) with its rows of the atlas and the
    text's ids, and K1 takes each launch's output as the shard's region;
    the other shards launch nothing and K1 takes no region there."""
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.parallel import (
        ShardedDeltaPipeline,
        make_mesh,
    )

    cfg = StreamConfig(height=48, width=64, overlay_scale=1)
    pipe = ShardedDeltaPipeline(cfg, make_mesh(8, device="cpu"),
                                payload_layout="sharded")
    cell_h, cell_w = pipe.atlas_np.shape[1:3]
    assert (pipe.local_rows, cell_h) == (6, 10)
    lib = _FakeLib()
    monkeypatch.setattr(build, "_loaded", {"overlay": lib})
    # buffers stay on the CPU while they report cuda:0
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k: self)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    blits, k1 = [], []
    real_blit = overlay.overlay_blit

    def blit(*a):
        blits.append(a)
        return real_blit(*a)

    blit.launches = 0  # the launch counter K14 adds to, on the module's name

    def k1_tiled(cur, prev, **kw):
        k1.append(kw)
        return None, None, None, None, prev

    monkeypatch.setattr(overlay, "overlay_blit", blit)
    monkeypatch.setattr(logcompact, "fused_diff_compact_tiled", k1_tiled)
    state = pipe.init_state_flat(_bytes(7, cfg.frame_bytes))
    text = "FPS: 30 BW: 5"
    pipe.step_flat(state, _bytes(8, cfg.frame_bytes), text=text)
    assert len(lib.launches) == len(blits) == blit.launches == 2
    want_ids = fonts.encode_text(text, MAX_OVERLAY_CHARS)
    for s, (args, (frame, atlas, ids, n_chars, h, w)) in enumerate(
            zip(lib.launches, blits)):
        g0 = 6 * s
        assert h == min(6, cell_h - g0) and w == 64
        assert frame.numel() == h * 64 * 3
        assert atlas.is_contiguous()
        np.testing.assert_array_equal(atlas.numpy(),
                                      pipe.atlas_np[:, g0:g0 + h])
        assert ids.tolist() == want_ids and n_chars == len(text)
        (_, fptr, stride, aptr, n_glyphs, got_h, cw3, iptr, max_chars, nptr,
         nfit, row, rows, streams, _, optr, _) = args
        assert (fptr, stride, aptr, iptr) == (frame.data_ptr(), h * 64 * 3,
                                              atlas.data_ptr(),
                                              ids.data_ptr())
        assert (n_glyphs, got_h, cw3, max_chars) == (22, h, cell_w * 3,
                                                     MAX_OVERLAY_CHARS)
        assert (nptr, nfit) == (None, min(len(text), 64 // cell_w))
        assert (row, rows, streams) == (64 * 3, h, 1)
        region = k1[s]["overlay_region"]
        assert region.numel() == h * 64 * 3 and region.data_ptr() == optr
    assert [kw["overlay_region"] for kw in k1[2:]] == [None] * 6
    assert [kw["index_offset"] for kw in k1] == [
        s * pipe.local_bytes for s in range(8)]


def test_glyphs_upload_once_a_tuple_of_texts(monkeypatch):
    """``Glyphs`` uploads the ids and counts of a tuple of texts once and
    hands back the same tensors while the texts hold, and uploads again
    when they change: into the same memory while the number of texts
    holds (a captured graph keeps its pointers), into new tensors when it
    does not."""
    uploads = []
    real = overlay.text_glyphs

    def text_glyphs(*a):
        uploads.append(a)
        return real(*a)

    monkeypatch.setattr(overlay, "text_glyphs", text_glyphs)
    glyphs = overlay.Glyphs("cpu", 3)
    first = glyphs(["AB", "C"])
    assert glyphs(("AB", "C")) is first and len(uploads) == 1
    ids, n_fit = first
    assert ids.shape == (2, MAX_OVERLAY_CHARS) and ids.dtype == torch.int32
    assert n_fit.tolist() == [2, 1]
    assert ids[0].tolist() == fonts.encode_text("AB", MAX_OVERLAY_CHARS)
    ptrs = [t.data_ptr() for t in first]
    second = glyphs(["AB", "LONG TEXT"])
    assert len(uploads) == 2 and second[1].tolist() == [2, 3]
    assert [t.data_ptr() for t in second] == ptrs
    assert ids[1].tolist() == fonts.encode_text("LONG TEXT",
                                                MAX_OVERLAY_CHARS)
    assert glyphs(["AB", "LONG TEXT"]) is second and len(uploads) == 2
    assert uploads[1] == (("AB", "LONG TEXT"), MAX_OVERLAY_CHARS, 3,
                          torch.device("cpu"))
    third = glyphs(["XY"])
    assert len(uploads) == 3 and third[0].shape == (1, MAX_OVERLAY_CHARS)
    assert third[1].tolist() == [2] and second[1].tolist() == [2, 3]
