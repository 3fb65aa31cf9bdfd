"""K8, the noise filter's hand-written stencil (``csrc/convolve.cu``), on
the CPU: its plain version (``ops/convolve.py``) against the JAX
package's ``convolve_q16`` and ``reference_cpu.convolve`` for K = 1-15,
even K and signed, unnormalized taps included; the ``streams=B`` form
against B solo calls; the halo form (``parallel/halo_conv.py``) against
the solo frame at S = 2 and 4; a host model of one K8 launch (its blocks,
staged tiles and halo reads, read from the kernel's own source) that
writes every output byte once, reads nothing outside its frame or stream
and gives the plain version's bytes; and the wrapper on a CUDA tensor,
which launches or raises. Tolerance is zero throughout.

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

from cudavideostream_tpu.ops import convolve as jax_convolve
from cudavideostream_tpu_torch.config import StreamConfig
from cudavideostream_tpu_torch.models import (
    BatchedDeltaPipeline,
    DeltaStreamPipeline,
)
from cudavideostream_tpu_torch.ops import convolve
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.parallel import halo_conv
from torch_kernel_fixtures import no_kernel_build  # noqa: F401

CSRC = Path(convolve.__file__).resolve().parent.parent / "csrc"
LAYOUTS = {"48x64": (48, 64), "48x50": (48, 50)}


def _constexpr(name):
    """``constexpr int name = ...;`` in ``csrc/convolve.cu``."""
    code = re.sub(r"//[^\n]*", "", (CSRC / "convolve.cu").read_text())
    expr = re.search(rf"constexpr\s+int\s+{name}\s*=\s*([^;]+);",
                     code).group(1)
    names = set(re.findall(r"[A-Za-z_]\w*", expr))
    return eval(expr, {"__builtins__": {}},
                {k: _constexpr(k) for k in names})


THREADS = _constexpr("kThreads")
STRIP = _constexpr("kStrip")
TILE_BYTES = _constexpr("kTileBytes")
BAND = _constexpr("kBand")
MAX_K = _constexpr("kMaxK")
SMS = 132  # an H100 SXM's SMs


def _geo(k):
    """``Geo<K>`` of ``csrc/convolve.cu``, read from the source: (p, the
    thread window's halo H, the stage's halo Hs, staged bytes a row SW,
    ring rows NS, window words W)."""
    code = re.sub(r"//[^\n]*", "", (CSRC / "convolve.cu").read_text())
    geo = code[code.index("struct Geo {"):]
    geo = geo[:geo.index("};")]
    env = {"K": k, "kBand": BAND, "kStrip": STRIP, "kTileBytes": TILE_BYTES}
    for name, expr in re.findall(
            r"static\s+constexpr\s+int\s+(\w+)\s*=\s*([^;]+);", geo):
        env[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, env)
    return tuple(env[n] for n in ("p", "H", "Hs", "SW", "NS", "W"))


def _frame(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, h * w * 3,
                                                dtype=np.uint8)


def _taps(kind, k, seed=0):
    """Q16 taps: a Gaussian, a mean, or signed unnormalized integers (small
    enough that the int64 spec's sum stays in int32 for K up to 15:
    225 x 35,000 x 255 < 2^31)."""
    if kind == "gauss":
        return ref.quantize_kernel_q16(ref.gaussian_kernel(k))
    if kind == "mean":
        return ref.quantize_kernel_q16(ref.mean_kernel(k))
    return np.random.default_rng([k, seed]).integers(
        -25_000, 35_000, (k, k)).astype(np.int64)


def test_constants_read_from_the_kernel():
    assert (THREADS, STRIP, BAND, MAX_K) == (
        convolve.CONV_THREADS, convolve.CONV_STRIP_BYTES,
        convolve.CONV_BAND_ROWS, convolve.CONV_MAX_K)
    assert TILE_BYTES == convolve.CONV_TILE_BYTES == THREADS * STRIP
    assert TILE_BYTES % 16 == 0 and THREADS % 32 == 0
    for k in range(1, MAX_K + 1):
        p, h, hs, sw, ns, words = _geo(k)
        # the window holds the widest reach: 3p bytes on the left and
        # 3(K - 1 - p) on the right, in whole 8-byte words (LDS.64), and
        # the stage's halo holds the window, in whole 16-byte chunks
        assert 3 * p <= h <= hs and 3 * (k - 1 - p) <= h
        assert h % 8 == 0 and hs % 16 == 0 and sw % 16 == 0
        assert words % 2 == 0 and (hs - h) % 8 == 0
        # the ring holds one band being summed, the next band in flight
        # and the first band's K - 1 rows above it; its shared memory stays
        # under the 48 KB of a static allocation
        assert ns == 2 * BAND + k - 1 and ns * sw <= 48 * 1024


# -- the plain version against the JAX package and the spec ----------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", ["gauss", "signed"])
@pytest.mark.parametrize("k", range(1, 16))
def test_plain_matches_jax_and_spec(k, kind, layout):
    """K = 1-15, odd and even, Gaussian and signed unnormalized taps: the
    plain version equals the JAX ``convolve_q16`` and the spec's int64
    convolution (the taps as Q16 floats, which quantize back exactly)."""
    h, w = LAYOUTS[layout]
    frame = _frame(k, h, w)
    wq = _taps(kind, k)
    src = torch.from_numpy(frame.copy())
    got = convolve.convolve_q16(src, wq, h, w)
    assert got.dtype == torch.uint8 and got.numel() == frame.size
    np.testing.assert_array_equal(src.numpy(), frame)  # input not written
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jax_convolve.convolve_q16(jnp.asarray(frame), wq, h, w)))
    np.testing.assert_array_equal(got.numpy(),
                                  ref.convolve(frame, wq / 65536.0, h, w))


def test_plain_wraps_in_int32_as_jax():
    """Taps large enough that the sum leaves int32: the plain version
    wraps as the JAX package's int32 sum does (the kernel's unsigned sum
    wraps the same way)."""
    h, w = 48, 50
    frame = _frame(7, h, w)
    wq = np.full((3, 3), 2_000_000, dtype=np.int64)
    wq[1, 1] = -2_000_000_000
    got = convolve.convolve_q16(torch.from_numpy(frame), wq, h, w)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jax_convolve.convolve_q16(jnp.asarray(frame), wq, h, w)))


@settings(deadline=None, max_examples=12)
@given(h=st.integers(1, 20), w=st.integers(1, 20), k=st.integers(1, 15),
       seed=st.integers(0, 2**32 - 1))
def test_plain_matches_spec_property(h, w, k, seed):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, h * w * 3, dtype=np.uint8)
    wq = rng.integers(-30_000, 30_000, (k, k))  # |sum| < 2^31
    got = convolve.convolve_q16(torch.from_numpy(frame), wq, h, w)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.convolve(frame, wq / 65536.0, h, w))


# -- the streams=B form and the halo form --------------------------------------

@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("k", [2, 3, 5])
def test_streams_form_equals_solo_calls(b, k):
    h, w = 48, 50
    n = h * w * 3
    frames = np.concatenate([_frame(s, h, w) for s in range(b)])
    wq = _taps("gauss", k)
    got = convolve.convolve_q16(torch.from_numpy(frames), wq, h, w,
                                streams=b)
    want = np.concatenate([
        convolve.convolve_q16(torch.from_numpy(frames[s * n:(s + 1) * n]),
                              wq, h, w).numpy() for s in range(b)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 15])
def test_halo_form_equals_the_solo_frame(s, k):
    """Each shard's uint8 rows with their halo (``halo_exchange_rows``)
    through ``convolve_q16_halo`` equal the solo frame's rows."""
    h, w = 48, 64
    rows = h // s
    frame = _frame(k + s, h, w)
    wq = _taps("signed", k)
    ln = rows * w * 3
    got = halo_conv.sharded_convolve_q16(
        [torch.from_numpy(frame[i * ln:(i + 1) * ln].copy())
         for i in range(s)], wq, rows, w)
    assert all(g.dtype == torch.uint8 and g.numel() == ln for g in got)
    np.testing.assert_array_equal(
        np.concatenate([g.numpy() for g in got]),
        convolve.convolve_q16(torch.from_numpy(frame), wq, h, w).numpy())


def test_halo_exchange_moves_uint8_rows():
    """The exchange keeps the shards' dtype: uint8 rows cross, not int32."""
    shards = [torch.full((6, 9), i, dtype=torch.uint8) for i in range(3)]
    out = halo_conv.halo_exchange_rows(shards, 2)
    assert all(o.dtype == torch.uint8 and o.shape == (10, 9) for o in out)
    assert out[1][:2].eq(0).all() and out[1][-2:].eq(2).all()


def test_refusals():
    f = torch.zeros(48 * 50 * 3, dtype=torch.uint8)
    wq = _taps("gauss", 3)
    with pytest.raises(ValueError):
        convolve.convolve_q16(f[:-1], wq, 48, 50)
    with pytest.raises(ValueError):
        convolve.convolve_q16(f.to(torch.int32), wq, 48, 50)
    with pytest.raises(ValueError):
        convolve.convolve_q16(f, wq, 48, 50, streams=2)
    with pytest.raises(ValueError):
        convolve._taps(np.ones((16, 16), dtype=np.int64))
    with pytest.raises(ValueError):
        convolve._taps(np.ones((3, 4), dtype=np.int64))
    with pytest.raises(ValueError):
        convolve._taps(np.full((3, 3), 1 << 31, dtype=np.int64))
    with pytest.raises(ValueError):
        convolve._taps(np.full((3, 3), 0.5))


# -- a host model of one K8 launch ----------------------------------------

def _model_launch(src, src_stride, src_rows, row_off, rows, row_bytes, wq,
                  streams, sms=SMS):
    """One K8 launch on the host, block by block as ``conv_kernel`` runs
    it, on ``conv_plan``'s grid: each block stages its input rows a band
    of ``BAND`` at a time into a ring of ``2 * BAND + K - 1`` slots (row
    ``q`` of the block, input row ``r0 + row_off + q``, into slot ``q %
    NS``; bytes ``c0 - Hs`` on, zero outside the rows and the row), the
    next band issued before the current one is summed; thread ``x`` takes
    each staged row once, as the window of bytes ``[c - H, c + STRIP +
    H)`` around its strip ``c = c0 + STRIP * x``, and adds byte ``H - 3p
    + v + 3j`` of it, times tap ``(K - 1 - t, j)``, to partial sum ``t``
    of strip byte ``v`` (output row ``q - K + 1 + t``), in unsigned 32-bit
    arithmetic; partial sum 0 leaves as output row ``q - K + 1``, shifted
    as int32 and clamped, bytes past the row's end not written. Fails if a
    slot is refilled before its row was summed, if a summed slot holds
    another row, or if a read leaves the stream's bytes. Returns the
    output and how often each output byte was written."""
    k = wq.shape[0]
    p, hh, hs, sw, ns, words = _geo(k)
    taps = wq.astype(np.int64).astype(np.uint32)
    (gx, gy, gz), tile_rows = convolve.conv_plan(rows, row_bytes, streams,
                                                 sms)
    out = np.zeros(streams * rows * row_bytes, np.uint8)
    writes = np.zeros(out.size, np.int64)
    x = np.arange(THREADS)
    v = np.arange(STRIP)
    for bz in range(gz):
        base = bz * src_stride
        for by in range(gy):
            r0 = by * tile_rows
            nrows = min(tile_rows, rows - r0)
            for bx in range(gx):
                c0 = bx * TILE_BYTES
                ring = np.zeros((ns, sw), np.uint32)
                held = [None] * ns  # the block row each slot holds
                taken = 0           # rows summed so far

                def stage(q0, q1):
                    for q in range(q0, q1):
                        old = held[q % ns]
                        assert old is None or old < taken  # summed already
                        held[q % ns] = q
                        ring[q % ns] = 0
                        gr = r0 + row_off + q
                        if not 0 <= gr < src_rows:
                            continue
                        gc = c0 - hs + np.arange(sw)
                        ok = (gc >= 0) & (gc < row_bytes)
                        addr = base + gr * row_bytes + gc[ok]
                        assert ((addr >= base)
                                & (addr < base + src_rows * row_bytes)).all()
                        ring[q % ns, ok] = src[addr]

                c = c0 + STRIP * x
                live = c < row_bytes
                acc = np.zeros((k, THREADS, STRIP), np.uint32)
                nbands = -(-nrows // BAND)
                stage(0, min(BAND, nrows) + k - 1)
                for band in range(nbands):
                    qend = min((band + 1) * BAND, nrows) + k - 1
                    if band + 1 < nbands:
                        stage(qend, min((band + 2) * BAND, nrows) + k - 1)
                    for q in range(taken, qend):
                        assert held[q % ns] == q
                        col = hs - hh + STRIP * x[:, None] + np.arange(
                            4 * words)
                        assert col.min() >= 0 and col.max() < sw
                        win = ring[q % ns][col]
                        for t in range(k):
                            for j in range(k):
                                acc[t] += taps[k - 1 - t, j] * win[
                                    :, hh - 3 * p + v + 3 * j]
                        if q >= k - 1:
                            o = (bz * rows * row_bytes
                                 + (r0 + q - k + 1) * row_bytes
                                 + c[:, None] + v)
                            ok = live[:, None] & (c[:, None] + v < row_bytes)
                            val = np.clip(acc[0].view(np.int32) >> 16, 0, 255)
                            out[o[ok]] = val[ok]
                            writes[o[ok]] += 1
                        acc[:-1] = acc[1:].copy()
                        acc[-1] = 0
                    taken = qend
    return out, writes


@pytest.mark.parametrize("h,w,k,streams,kind", [
    (48, 64, 3, 1, "gauss"),    # one column tile, six row tiles
    (48, 50, 2, 1, "signed"),   # ragged width (150 B), even K
    (40, 100, 7, 2, "mean"),    # ragged rows (5 tiles of 8), B = 2
    (33, 90, 15, 3, "signed"),  # 270 B a row: a strip straddles its end
    (5, 3, 9, 2, "gauss"),      # smaller than the window
])
def test_launch_model_writes_each_byte_once(h, w, k, streams, kind):
    n = h * w * 3
    frames = np.concatenate([_frame(s + 11, h, w) for s in range(streams)])
    wq = _taps(kind, k)
    got, writes = _model_launch(frames, n, h, -(k // 2), h, w * 3, wq,
                                streams)
    assert (writes == 1).all()
    want = convolve.convolve_q16(torch.from_numpy(frames), wq, h, w,
                                 streams=streams).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,k,streams,sms", [
    (40, 350, 3, 1, 1),   # 1,050 B a row: two column tiles, the second
                          # 26 B (a strip straddles the row's end); tiles
                          # of 20 rows, bands of 8, 8 and 4
    (37, 342, 5, 2, 1),   # 1,026 B: a 2-byte second tile, B = 2, 37 rows
    (61, 20, 15, 1, 1),   # 60 B, K = 15: tiles of 16 rows, 4 bands each
    (19, 700, 8, 1, 2),   # 2,100 B (% 16 = 4), even K, three column tiles
])
def test_launch_model_bands_and_column_tiles(h, w, k, streams, sms):
    """Tiles of several bands (the ring refilled while it is read) and
    rows of several column tiles, the last one partial: every output byte
    written once and equal to the plain version."""
    n = h * w * 3
    frames = np.concatenate([_frame(s + 5, h, w) for s in range(streams)])
    wq = _taps("signed", k)
    got, writes = _model_launch(frames, n, h, -(k // 2), h, w * 3, wq,
                                streams, sms)
    assert (writes == 1).all()
    want = convolve.convolve_q16(torch.from_numpy(frames), wq, h, w,
                                 streams=streams).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows,row_bytes,streams", [
    (1080, 5760, 1), (1080, 5760, 2), (1080, 5760, 4), (271, 5751, 4),
    (270, 5760, 1), (1, 3, 1), (7, 5760, 200), (200_000, 6, 1)])
def test_conv_plan_one_wave(rows, row_bytes, streams):
    """The plan covers every row and byte, keeps the grid within one wave
    of CONV_BLOCKS_PER_SM blocks an SM wherever bands allow, and within the
    grid's limits."""
    (x, y, z), tile_rows = convolve.conv_plan(rows, row_bytes, streams, SMS)
    assert x * TILE_BYTES >= row_bytes > (x - 1) * TILE_BYTES
    assert y * tile_rows >= rows > (y - 1) * tile_rows and z == streams
    assert tile_rows >= BAND and y <= 65535
    if tile_rows > BAND:  # not held up by the band: one wave
        assert x * y * z <= convolve.CONV_BLOCKS_PER_SM * SMS
    if (rows, row_bytes, streams) == (1080, 5760, 1):
        assert (x, y, z, tile_rows) == (6, 84, 1, 13)


@pytest.mark.parametrize("s,k", [(2, 3), (4, 5), (4, 2)])
def test_launch_model_halo_form(s, k):
    """The halo form (``row_off = 0`` over ``rows + 2p`` staged input rows)
    writes each byte of the shard once and equals the plain version."""
    h, w = 48, 50
    rows, ln = h // s, h // s * w * 3
    frame = _frame(s * k, h, w)
    wq = _taps("signed", k)
    shards = halo_conv.halo_exchange_rows(
        [torch.from_numpy(frame[i * ln:(i + 1) * ln].copy()).reshape(
            rows, w * 3) for i in range(s)], k // 2)
    for sh in shards:
        src = sh.reshape(-1).numpy()
        for sms in (SMS, 1):
            got, writes = _model_launch(src, 0, rows + 2 * (k // 2), 0, rows,
                                        w * 3, wq, 1, sms)
            assert (writes == 1).all()
            np.testing.assert_array_equal(
                got, convolve.convolve_q16_halo(sh, wq, rows, w).numpy())


def test_no_shared_byte_load_in_the_tap_loop():
    """The kernel takes its window from shared memory as 8-byte words
    (uint2) and its bytes out of them with byte permutes: no shared-memory
    byte is indexed in the tap loop (the first version's ``col[...]``
    loads)."""
    code = re.sub(r"//[^\n]*", "", (CSRC / "convolve.cu").read_text())
    take = code[code.index("take_row(unsigned"):code.index("conv_kernel(")]
    body = code[code.index("conv_kernel("):code.index("cudaError_t launch")]
    loop = body[body.index("if (live) {"):]
    assert "reinterpret_cast<const uint2*>(win" in loop
    assert "take_row<K, true>(acc, u," in loop
    assert "byte_at(u," in take and "__byte_perm" in code
    for part in (take, loop):
        assert "stage[" not in part and "win[" not in part


# -- the served paths, and a CUDA tensor never reaching the plain version --

@pytest.mark.parametrize("k", [3, 4])
def test_served_noise_filter_solo_and_batched(k):
    """``--noise-filter --conv-k K`` through the solo pipeline and the
    batched one (B = 3, one K8 call for every stream) equals step_oracle's
    state and payload on each stream."""
    cfg = StreamConfig(height=48, width=64, overlay_scale=4,
                       noise_filter=True, conv_k=k, tiled_payload=True)
    rng = np.random.default_rng(k)
    b, n = 3, cfg.frame_bytes
    prev = rng.integers(0, 256, b * n, dtype=np.uint8)
    cur = rng.integers(0, 256, b * n, dtype=np.uint8)
    bpipe = BatchedDeltaPipeline(cfg, b, device="cpu")
    new_prev = bpipe.step(torch.from_numpy(prev.copy()),
                          torch.from_numpy(cur))[0].numpy()
    solo = DeltaStreamPipeline(cfg, device="cpu")
    for s in range(b):
        want = ref.step_oracle(prev[s * n:(s + 1) * n], cur[s * n:(s + 1) * n],
                               cfg, atlas=solo.atlas_np,
                               char_ids=None)
        np.testing.assert_array_equal(new_prev[s * n:(s + 1) * n], want[0])
        got = solo.step(torch.from_numpy(prev[s * n:(s + 1) * n].copy()),
                        cur[s * n:(s + 1) * n])
        np.testing.assert_array_equal(got[0].numpy(), want[0])


def _no_plain(monkeypatch):
    """Records every call of K8's plain versions; returns the calls."""
    calls = []
    monkeypatch.setattr(convolve, "convolve_q16_reference",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(convolve, "accumulate_q16_reference",
                        lambda *a: calls.append(a))
    return calls


def test_convolve_on_cuda_launches_or_raises(monkeypatch, no_kernel_build):
    """A CUDA tensor never takes the plain version: without a kernel
    build the wrapper raises, the plain version is not called and no
    launch is counted, on the solo, the streams and the halo form."""
    calls = _no_plain(monkeypatch)
    wq = _taps("gauss", 3)
    frame = torch.zeros(2 * 48 * 64 * 3, dtype=torch.uint8)
    shard = torch.zeros((26, 64 * 3), dtype=torch.uint8)
    before = convolve.convolve_q16.launches
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    for fn in (lambda: convolve.convolve_q16(frame[:48 * 64 * 3], wq, 48, 64),
               lambda: convolve.convolve_q16(frame, wq, 48, 64, streams=2),
               lambda: convolve.convolve_q16_halo(shard, wq, 24, 64)):
        with pytest.raises(RuntimeError):
            fn()
    monkeypatch.undo()
    assert not calls and convolve.convolve_q16.launches == before
