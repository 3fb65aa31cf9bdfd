"""The port's mask slice against the JAX package: K1's bitmask-only
emission (``fused_diff_compact(emit="mask")``, Pallas in interpret mode),
K1's tiled emission with the packed bits of ``emit_bitmask``, the vals
merge (K3, both JAX branches), the two new pipeline configurations, wire
v4, the ``mask`` landing and ``BatchedLandExecutor``, and TCP loopbacks
decoded by both packages' clients. Tolerance is zero: every output is
compared byte for byte, dtypes and shapes included.

On CPU tensors the port's wrappers run the kernels' plain PyTorch
versions; the CUDA kernels themselves are held against those versions on
the card by ``chip_smoke.py``.
"""

import dataclasses
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_frame_pair
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.models import DeltaStreamPipeline as JaxPipeline
from cudavideostream_tpu.ops import diff as jax_diff
from cudavideostream_tpu.ops import logcompact as jax_logcompact
from cudavideostream_tpu.runtime import wire as jax_wire
from cudavideostream_tpu.runtime.client import DeltaStreamClient as JaxClient
from cudavideostream_tpu.runtime.executor import StreamExecutor as JaxExecutor
from cudavideostream_tpu.runtime.executor import TiledLander as JaxLander
from cudavideostream_tpu_torch.config import StreamConfig
from cudavideostream_tpu_torch.models import DeltaStreamPipeline
from cudavideostream_tpu_torch.ops import diff as diff_ops
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.ops import reference_cpu
from cudavideostream_tpu_torch.runtime import client as client_mod
from cudavideostream_tpu_torch.runtime import server as server_mod
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
from cudavideostream_tpu_torch.runtime.executor import (
    BatchedLandExecutor,
    StreamExecutor,
    TiledLander,
)
from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer
from cudavideostream_tpu_torch.runtime.sources import SyntheticSource
from cudavideostream_tpu_torch.utils import fonts

SIZES = {
    "96x128": 96 * 128 * 3,    # one 320-row mask tile
    "120x160": 120 * 160 * 3,  # 512-row tile: 512 units of 128 B
    "odd1000": 1000,           # not a multiple of 16 or of 128
}
REGION_BYTES = 700
SUB_ROWS = [1, 8, 0]
N_1080P = 1920 * 1080 * 3
TEXTS = ["12", "13", "13", "", "P5"]


def _case(size, density, overlay, seed=0):
    n = SIZES[size]
    rng = np.random.default_rng([seed, n, int(density * 100), int(overlay)])
    prev, cur = make_frame_pair(rng, n, change_frac=density)
    region = None
    if overlay:
        region = rng.integers(0, 255, min(n, REGION_BYTES), endpoint=True,
                              dtype=np.uint8)
    return prev, cur, region


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _port_mask(prev, cur, region, thr, negfeed, sub_rows):
    prev_t = torch.from_numpy(prev.copy())
    out = logcompact.fused_diff_compact_mask(
        torch.from_numpy(cur), prev_t, threshold=thr,
        negative_feedback=negfeed, overlay_region=_t(region),
        sub_rows=sub_rows)
    assert out[4] is prev_t  # updated in place
    assert out[0].dtype == torch.int32 and out[0].dim() == 0
    return (int(out[0]),) + tuple(t.numpy() for t in out[1:])


def _jax_mask(prev, cur, region, thr, negfeed, sub_rows):
    out = jax_logcompact.fused_diff_compact(
        jnp.asarray(cur), jnp.asarray(prev), threshold=thr,
        negative_feedback=negfeed, interpret=True, emit="mask",
        sub_rows=sub_rows,
        overlay_region=None if region is None else jnp.asarray(region))
    return (int(out[0]),) + tuple(np.asarray(a) for a in out[1:])


def _assert_same(got, want):
    assert got[0] == want[0]
    assert len(got) == len(want)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _spec(prev, cur, region, thr, negfeed):
    c = cur.copy()
    if region is not None:
        c[: region.size] = region
    return reference_cpu.diff_encode(c, prev, thr, negfeed)


# -- K1: the bitmask-only emission ----------------------------------------

@pytest.mark.parametrize("overlay", [False, True], ids=["plain", "overlay"])
@pytest.mark.parametrize("negfeed", [True, False], ids=["negfeed", "nofeed"])
@pytest.mark.parametrize("sub_rows", SUB_ROWS, ids=lambda s: f"sub{s}")
@pytest.mark.parametrize("size", list(SIZES))
def test_mask_emission_matches_jax(size, sub_rows, negfeed, overlay):
    """pos, narrowed counts, the vals blocks, the flat bits and new_prev
    against JAX emit="mask"; the bits and the units' vals prefixes are
    the NumPy spec's payload."""
    prev, cur, region = _case(size, 0.06, overlay)
    got = _port_mask(prev, cur, region, 20, negfeed, sub_rows)
    _assert_same(got, _jax_mask(prev, cur, region, 20, negfeed, sub_rows))
    pos, counts, vals_t, bits, new_prev = got
    e_pos, e_xs, e_vals, e_prev = _spec(prev, cur, region, 20, negfeed)
    assert pos == e_pos > 0
    np.testing.assert_array_equal(TiledLander.rebuild_mask_xs(
        bits, pos, 0, vals_t.shape[1]), e_xs)
    np.testing.assert_array_equal(
        vals_t.reshape(-1)[vals_t.reshape(-1) != 0], e_vals)
    np.testing.assert_array_equal(new_prev, e_prev)


@pytest.mark.parametrize("density", [0.0, 1.0], ids=["d0", "d100"])
@pytest.mark.parametrize("thr", [0, 255])
def test_mask_emission_threshold_extremes(thr, density):
    prev, cur, region = _case("96x128", density, True)
    got = _port_mask(prev, cur, region, thr, True, 1)
    _assert_same(got, _jax_mask(prev, cur, region, thr, True, 1))


@pytest.mark.parametrize("sub_rows", SUB_ROWS, ids=lambda s: f"sub{s}")
def test_1080p_mask_geometry_matches_jax(sub_rows):
    """At 1080p the mask geometry pads to 48,640 rows of 512-row tiles
    (n_pad 6,225,920, not the tiled emission's 6,221,824)."""
    rows, tile_rows = jax_logcompact._tile_geometry_mask(-(-N_1080P // 128))
    assert (rows, tile_rows) == (48_640, 512)
    n_pad, unit_bytes = logcompact.tiled_geometry_mask(N_1080P, sub_rows)
    assert n_pad == 6_225_920
    want = {1: (48_640, 128, torch.uint8), 8: (6_080, 1_024, torch.int16),
            0: (95, 65_536, torch.int32)}
    assert (n_pad // unit_bytes, unit_bytes,
            logcompact.counts_dtype(unit_bytes)) == want[sub_rows]


@pytest.mark.parametrize("rows", [1, 8, 64, 450, 1000, 48_600, 4_200_000])
def test_mask_tile_geometry_copy_matches_jax(rows):
    assert logcompact._tile_geometry_mask(rows) == \
        jax_logcompact._tile_geometry_mask(rows)


# -- K1: the tiled emission with packed bits ------------------------------

@pytest.mark.parametrize("negfeed", [True, False], ids=["negfeed", "nofeed"])
@pytest.mark.parametrize("sub_rows", SUB_ROWS, ids=lambda s: f"sub{s}")
@pytest.mark.parametrize("size", ["120x160", "odd1000"])
def test_tiled_emit_bits_matches_jax(size, sub_rows, negfeed):
    """emit_bits: the tiled outputs are JAX emit="tiled"'s, and the bits
    are what the JAX pipeline packs after its kernel (pipeline.py:208-227:
    ``new_prev != prev`` under negative feedback, else the diff mask,
    padded to the blocks' coverage)."""
    prev, cur, region = _case(size, 0.06, True)
    prev_t = torch.from_numpy(prev.copy())
    out = logcompact.fused_diff_compact_tiled(
        torch.from_numpy(cur), prev_t, 20, negfeed, _t(region), sub_rows,
        emit_bits=True)
    assert len(out) == 6 and out[5] is prev_t
    j = jax_logcompact.fused_diff_compact(
        jnp.asarray(cur), jnp.asarray(prev), threshold=20,
        negative_feedback=negfeed, interpret=True, emit="tiled",
        sub_rows=sub_rows, overlay_region=jnp.asarray(region))
    _assert_same((int(out[0]),) + tuple(t.numpy() for t in out[1:4])
                 + (out[5].numpy(),),
                 (int(j[0]),) + tuple(np.asarray(a) for a in j[1:]))
    if negfeed:
        bmask = j[4] != jnp.asarray(prev)
    else:
        c = cur.copy()
        c[: region.size] = region
        bmask = jax_diff.diff_mask(jnp.asarray(c), jnp.asarray(prev), 20)[0]
    bmask = jnp.pad(bmask, (0, j[2].size - bmask.shape[0]))
    want = np.asarray(jax_diff.pack_bitmask(bmask))
    bits = out[4].numpy()
    assert bits.dtype == want.dtype and bits.shape == want.shape
    np.testing.assert_array_equal(bits, want)


@pytest.mark.parametrize("n", [1, 7, 8, 384, 1001])
def test_pack_bitmask_matches_jax(n, rng):
    mask = rng.random(n) < 0.4
    got = diff_ops.pack_bitmask(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_diff.pack_bitmask(jnp.asarray(mask))))


# -- K3: vals_compact / merge_vals ----------------------------------------

@pytest.mark.parametrize("sub_rows", [1, 8], ids=["two_stage", "serial"])
def test_merge_vals_matches_jax(sub_rows):
    """Port merge_vals == JAX merge_vals on the pos prefix, with a zero
    tail, on both sides of MERGE_SERIAL_MAX_UNITS (512 units of 128 B
    take the two-stage branch, 64 units of 1 KB the serial one)."""
    prev, cur, _ = _case("120x160", 0.3, False, seed=3)
    pos, counts, vals_t, _, _ = _jax_mask(prev, cur, None, 20, True,
                                          sub_rows)
    two_stage = counts.shape[0] > jax_logcompact.MERGE_SERIAL_MAX_UNITS
    assert two_stage == (sub_rows == 1)
    want = np.asarray(jax_logcompact.merge_vals(jnp.asarray(counts),
                                                jnp.asarray(vals_t)))
    got = logcompact.merge_vals(torch.from_numpy(counts.copy()),
                                torch.from_numpy(vals_t.copy()))
    assert got.dtype == torch.uint8 and got.numel() == vals_t.size
    got = got.numpy()
    np.testing.assert_array_equal(got[:pos], want[:pos])
    assert not got[pos:].any() and not want[pos:].any()


@pytest.mark.parametrize("n,density", [
    (5_000, 0.3), (70_000, 0.05), (70_000, 1.0), (70_000, 0.0), (999, 0.5),
])
def test_vals_compact_matches_jax(n, density):
    """Raw streams against the concatenated tile prefixes of JAX
    ``_vals_compact``."""
    rng = np.random.default_rng([n, int(density * 100)])
    vals = np.where(rng.random(n) < density,
                    rng.integers(1, 255, n, endpoint=True), 0).astype(np.uint8)
    counts, vals_t = (np.asarray(a) for a in jax_logcompact._vals_compact(
        jnp.asarray(vals), interpret=True))
    want = np.concatenate([vals_t[t, :c] for t, c in enumerate(counts)])
    pos, got = logcompact.vals_compact(torch.from_numpy(vals))
    pos = int(pos)
    assert pos == want.size == int(np.count_nonzero(vals))
    assert got.numel() == n
    np.testing.assert_array_equal(got[:pos].numpy(), want)
    assert not got[pos:].any()


@pytest.mark.parametrize("bad", ["dtype", "2d", "empty", "device",
                                 "counts_shape"])
def test_vals_compact_rejects_bad_inputs(bad):
    vals = torch.zeros(64, dtype=torch.uint8)
    if bad == "counts_shape":
        with pytest.raises(ValueError):
            logcompact.merge_vals(torch.zeros(3, dtype=torch.uint8),
                                  vals.reshape(4, 16))
        return
    if bad == "dtype":
        vals = vals.to(torch.int32)
    elif bad == "2d":
        vals = vals.reshape(8, 8)
    elif bad == "empty":
        vals = vals[:0]
    elif bad == "device":
        vals = vals.to("meta")
    with pytest.raises(ValueError):
        logcompact.vals_compact(vals)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the mask emission and K3 run their plain versions
    and launch no kernel."""
    prev, cur, region = _case("120x160", 0.06, True)
    before = (logcompact.fused_diff_compact_mask.launches,
              logcompact.fused_diff_compact_tiled.launches,
              logcompact.vals_compact.launches)
    got = _port_mask(prev, cur, region, 20, True, 1)
    ref = logcompact.fused_diff_compact_mask_reference(
        torch.from_numpy(cur), torch.from_numpy(prev.copy()), 20, True,
        torch.from_numpy(region), 1)
    _assert_same(got, (int(ref[0]),) + tuple(t.numpy() for t in ref[1:]))
    logcompact.merge_vals(torch.from_numpy(got[1]), torch.from_numpy(got[2]))
    logcompact.fused_diff_compact_tiled(
        torch.from_numpy(cur), torch.from_numpy(prev.copy()), emit_bits=True)
    assert (logcompact.fused_diff_compact_mask.launches,
            logcompact.fused_diff_compact_tiled.launches,
            logcompact.vals_compact.launches) == before == (0, 0, 0)


# -- the pipeline ---------------------------------------------------------

def _mask_configs(negfeed):
    base = dict(height=96, width=128, overlay_scale=4, tiled_payload=True,
                emit_bitmask=True, negative_feedback=negfeed)
    return {
        "bitmask": base,
        "maskonly": dict(base, fetch_mode="mask", maskonly_payload=True),
    }


@pytest.mark.parametrize("negfeed", [True, False], ids=["negfeed", "nofeed"])
@pytest.mark.parametrize("kind", ["bitmask", "maskonly"])
def test_mask_pipeline_matches_jax(kind, negfeed, rng):
    """The two new configurations' steps, frame after frame with a
    changing overlay text: every output equals the JAX pipeline's, and
    the payload rebuilt from the bits equals step_oracle's."""
    kw = _mask_configs(negfeed)[kind]
    jpipe = JaxPipeline(JaxConfig(**kw))
    cfg = StreamConfig(**kw)
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    base, _ = make_frame_pair(rng, cfg.frame_bytes)
    jprev, prev = jpipe.init_state(base), pipe.init_state(base)
    oracle_prev = base.copy()
    for k, text in enumerate(TEXTS):
        frame = (make_frame_pair(rng, cfg.frame_bytes)[1] if k != 2
                 else frame)
        jout = jpipe.step(jprev, frame, text=text)
        out = pipe.step(prev, frame, text=text)
        assert len(out) == len(jout) == (6 if kind == "maskonly" else 7)
        assert out[-1] is None and out[0] is prev
        _assert_same((int(out[1]),) + tuple(t.numpy() for t in out[2:-1])
                     + (out[0].numpy(),),
                     (int(jout[1]),) + tuple(np.asarray(a)
                                             for a in jout[2:-1])
                     + (np.asarray(jout[0]),))
        pos, counts, bits = int(out[1]), out[2], out[-2]
        vals_t = out[3] if kind == "maskonly" else out[4]
        vals = logcompact.merge_vals(counts, vals_t)[:pos].numpy()
        xs = TiledLander.rebuild_mask_xs(bits.numpy(), pos, 0,
                                         vals_t.shape[1])
        oracle_prev, e_pos, e_xs, e_vals, _ = reference_cpu.step_oracle(
            oracle_prev, frame, cfg, atlas=pipe.atlas_np,
            char_ids=fonts.encode_text(text))
        assert pos == e_pos
        np.testing.assert_array_equal(xs, e_xs)
        np.testing.assert_array_equal(vals, e_vals)
        np.testing.assert_array_equal(out[0].numpy(), oracle_prev)
        jprev, prev = jout[0], out[0]


def test_1080p_maskonly_step_matches_step_oracle():
    """One full-size bitmask-only step of the plain path against the
    NumPy spec, through MaskPayload.to_flat."""
    cfg = StreamConfig(tiled_payload=True, emit_bitmask=True,
                       fetch_mode="mask", maskonly_payload=True)
    rng = np.random.default_rng(1080)
    prev_np, cur = make_frame_pair(rng, cfg.frame_bytes)
    text = "FPS: 30 BW: 1234 kbps"
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    new_prev, pos, counts, vals_t, bits, aux = pipe.step(
        pipe.init_state(prev_np), cur, text=text)
    assert aux is None and tuple(vals_t.shape) == (48_640, 128)
    assert bits.numel() == 6_225_920 // 8 and counts.dtype == torch.uint8
    e_prev, e_pos, e_xs, e_vals, _ = reference_cpu.step_oracle(
        prev_np, cur, cfg, atlas=pipe.atlas_np,
        char_ids=fonts.encode_text(text))
    vals = logcompact.merge_vals(counts, vals_t).numpy()
    xs, v = wire.MaskPayload(int(pos), 0, bits.numpy(), vals).to_flat()
    assert int(pos) == e_pos > 0
    np.testing.assert_array_equal(xs, e_xs)
    np.testing.assert_array_equal(v, e_vals)
    np.testing.assert_array_equal(new_prev.numpy(), e_prev)


# -- wire v4 --------------------------------------------------------------

N = 8000


def _xs_in(rng, lo, hi, pos):
    """pos ascending indices in [lo, hi), the first and last included."""
    mid = rng.choice(np.arange(lo + 1, hi - 1), pos - 2, replace=False)
    return np.sort(np.concatenate([[lo, hi - 1], mid])).astype(np.int32)


V4_CASES = {
    # name: (lo, hi, pos, mode); sizes at N = 8000: delta16 9 + 3p,
    # winmask 13 + wb/8 + p, bitmask 1005 + p, raw 8001
    "delta16": (0, 8000, 100, 0),
    "delta16_winmask_tie": (0, 128, 10, 0),     # 39 == 39
    "winmask": (800, 1280, 400, 3),
    "winmask_bitmask_tie": (0, 7936, 600, 3),   # 1605 == 1605
    "bitmask": (0, 8000, 2000, 1),
    "raw": (0, 8000, 7000, 2),
}


@pytest.mark.parametrize("case", ["zero"] + list(V4_CASES))
def test_v4_bytes_match_jax(case, rng):
    """Each mode, and each tie, which goes to the mode listed first
    (delta16, winmask, bitmask, raw); both packages' readers decode it."""
    if case == "zero":
        xs, mode = np.empty(0, np.int32), 0
    else:
        lo, hi, pos, mode = V4_CASES[case]
        xs = _xs_in(rng, lo, hi, pos)
    pos = xs.size
    vals = rng.integers(1, 255, pos, endpoint=True, dtype=np.uint8)
    frame = rng.integers(0, 255, N, endpoint=True, dtype=np.uint8)
    buf = wire.encode_frame_v4_numpy(pos, xs, vals, frame)
    assert buf == jax_wire.encode_frame_v4_numpy(pos, xs, vals, frame)
    assert buf[0] == mode
    start, wb = wire.winmask_window(xs)
    assert (start, wb) == jax_wire.winmask_window(xs)
    sizes = wire.v3_sizes(pos, 0, N) + (wire.winmask_size(pos, wb),)
    assert len(buf) == min(sizes)
    if case.endswith("tie"):
        assert sorted(sizes)[0] == sorted(sizes)[1]
    for got in (wire.unpack_frame_v3(buf, 0, N)[:4],
                jax_wire.unpack_frame_v3(buf, 0, N)[:4]):
        if mode == 2:
            np.testing.assert_array_equal(got[3], frame)
        else:
            np.testing.assert_array_equal(got[1], xs)
            np.testing.assert_array_equal(got[2], vals)


def _mask_payload(mod, xs, vals, margin_lo, margin_hi):
    """A MaskPayload of ascending ``xs`` whose window carries
    ``margin_lo``/``margin_hi`` zero bytes beyond the data's bytes."""
    b0 = int(xs[0]) // 8 - margin_lo if xs.size else 0
    b1 = int(xs[-1]) // 8 + 1 + margin_hi if xs.size else 0
    bits = np.zeros(8 * (b1 - b0), np.uint8)
    bits[xs - 8 * b0] = 1
    return mod.MaskPayload(xs.size, 8 * b0,
                           np.packbits(bits, bitorder="little"),
                           np.concatenate([vals, np.zeros(5, np.uint8)]))


def test_v4_encoder_on_mask_payloads_matches_jax_and_the_spec(rng):
    """V4Encoder over a stream of MaskPayloads (zero margins on either
    side, no margins, an empty window, every mode) and flat payloads:
    the bytes equal the JAX encoder's and the spec's for the same flat
    payload, and the client shadows stay equal."""
    base = rng.integers(0, 255, N, endpoint=True, dtype=np.uint8)
    ours, theirs = wire.V4Encoder(base), jax_wire.V4Encoder(base)
    spec = base.copy()
    stream = [("winmask", 3, 2), ("delta16", 0, 0), ("bitmask", 1, 0),
              ("winmask", 0, 0), ("zero", 0, 0), ("raw", 0, 4),
              ("flat", 0, 0), ("delta16_winmask_tie", 2, 2)]
    for case, lo_m, hi_m in stream:
        if case in ("zero",):
            xs = np.empty(0, np.int32)
        elif case == "flat":
            xs = _xs_in(rng, 50, 4000, 300)
        else:
            lo, hi, pos, _ = V4_CASES[case]
            xs = _xs_in(rng, lo, hi, pos)
        vals = rng.integers(1, 255, xs.size, endpoint=True, dtype=np.uint8)
        pos = xs.size
        if case == "flat":
            a, b = ours.encode(pos, xs, vals), theirs.encode(pos, xs, vals)
        else:
            if lo_m or hi_m:  # margins must stay inside the frame
                lo_m = min(lo_m, int(xs[0]) // 8) if pos else 0
                hi_m = min(hi_m, N // 8 - 1 - int(xs[-1]) // 8) if pos else 0
            a = ours.encode(pos, _mask_payload(wire, xs, vals, lo_m, hi_m),
                            None)
            b = theirs.encode(pos, _mask_payload(jax_wire, xs, vals, lo_m,
                                                 hi_m), None)
        if pos:
            spec[xs] += vals
        assert a == b == wire.encode_frame_v4_numpy(pos, xs, vals, spec)
        assert ours.last_mode == theirs.last_mode == a[0]
        np.testing.assert_array_equal(ours.frame, spec)
        np.testing.assert_array_equal(theirs.frame, spec)


def test_mask_payload_to_flat_and_v3(rng):
    """MaskPayload.to_flat equals the JAX one; a v3 encoder rebuilds its
    indices; a popcount that disagrees with pos raises."""
    xs = _xs_in(rng, 100, 3000, 250)
    vals = rng.integers(1, 255, xs.size, endpoint=True, dtype=np.uint8)
    ours = _mask_payload(wire, xs, vals, 2, 3)
    theirs = _mask_payload(jax_wire, xs, vals, 2, 3)
    for a, b in zip(ours.to_flat(), theirs.to_flat()):
        np.testing.assert_array_equal(a, b)
    base = np.zeros(N, np.uint8)
    assert (wire.V3Encoder(base).encode(0, ours, None)
            == wire.V3Encoder(base).encode(xs.size, xs, vals))
    bad = dataclasses.replace(ours, pos=ours.pos + 1)
    with pytest.raises(ValueError, match="popcount"):
        bad.to_flat()
    with pytest.raises(RuntimeError, match="popcount"):
        wire.V4Encoder(base).encode(bad.pos, bad, None)


# -- the mask landing -----------------------------------------------------

@pytest.mark.parametrize("start_unit,unit_bytes", [(0, 128), (7, 128),
                                                   (3, 1024), (1, 65_536)])
def test_rebuild_mask_xs_matches_jax(rng, start_unit, unit_bytes):
    bits = np.where(rng.random(900) < 0.3,
                    rng.integers(1, 255, 900, endpoint=True), 0
                    ).astype(np.uint8)
    pos = int(np.unpackbits(bits).sum())
    got = TiledLander.rebuild_mask_xs(bits, pos, start_unit, unit_bytes)
    want = JaxLander._rebuild_mask_xs(bits, pos, start_unit, unit_bytes)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="never truncate|missed"):
        TiledLander.rebuild_mask_xs(bits, pos - 1, start_unit, unit_bytes)


def _frames(cfg, n, seed):
    src = SyntheticSource(cfg, seed=seed)
    return src.base_frame(), [next(src) for _ in range(n)]


def _flat(res):
    """(pos, (xs, vals)) of an executor result of either package."""
    pos, xs, vals, _ = res
    if hasattr(xs, "to_flat"):  # a tiled or mask payload
        return pos, xs.to_flat()
    return pos, (xs, vals)


@pytest.mark.parametrize("kind", ["bitmask", "maskonly"])
@pytest.mark.parametrize("v4", [False, True], ids=["arrays", "mask_payload"])
def test_mask_landing_matches_jax_executor(kind, v4):
    """StreamExecutor with fetch_mode='mask' lands what the JAX executor
    lands, frame for frame: a MaskPayload under mask_payload, else the
    arrays rebuilt from the bits."""
    kw = dict(_mask_configs(True)[kind], fetch_mode="mask",
              mask_payload=v4)
    cfg, jcfg = StreamConfig(**kw), JaxConfig(**kw)
    base, frames = _frames(cfg, 4, seed=9)
    ours, theirs = StreamExecutor(cfg, device="cpu"), JaxExecutor(jcfg)
    ours.start(base)
    theirs.start(base)
    for f in frames:
        a, b = ours.process(f), theirs.process(f)
        assert isinstance(a[1], wire.MaskPayload) == v4
        pa, (xa, va) = _flat(a)
        pb, (xb, vb) = _flat(b)
        assert pa == pb > 0
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(va, vb)
    assert ours.fetch_counts == {"tiles": 0, "flat": 0, "mask": len(frames)}


@pytest.mark.parametrize("mode", ["tiles", "flat", "auto"])
def test_maskonly_payload_lands_only_through_mask(mode):
    """A bitmask-only payload under any other flavor raises (no index
    blocks exist), as does the mask flavor without bits."""
    cfg = StreamConfig(**_mask_configs(True)["maskonly"])
    base, frames = _frames(cfg, 1, seed=1)
    ex = StreamExecutor(cfg, device="cpu")
    ex.start(base)
    ex.lander.mode = mode
    with pytest.raises(ValueError, match="mask"):
        ex.process(frames[0])
    tcfg = StreamConfig(**dict(_mask_configs(True)["bitmask"],
                               emit_bitmask=False))
    ex = StreamExecutor(tcfg, device="cpu")
    ex.start(base)
    ex.lander.mode = "mask"
    with pytest.raises(ValueError, match="emit_bitmask"):
        ex.process(frames[0])


def test_auto_three_way_warms_each_flavor_then_follows_the_model():
    """With bits, auto lands tiles, tiles, flat, flat, mask, mask (the
    first of each untimed), then the byte model's pick; every landing is
    the spec's payload."""
    cfg = StreamConfig(**_mask_configs(True)["bitmask"])
    base, frames = _frames(cfg, 9, seed=4)
    ex = StreamExecutor(cfg, device="cpu")
    ex.start(base)
    prev = base.copy()
    picks = []
    for f in frames:
        before = dict(ex.fetch_counts)
        pos, (xs, vals) = _flat(ex.process(f))
        picks.append(next(k for k in before
                          if ex.fetch_counts[k] != before[k]))
        prev, e_pos, e_xs, e_vals, _ = reference_cpu.step_oracle(prev, f,
                                                                 cfg)
        assert pos == e_pos > 0
        np.testing.assert_array_equal(xs, e_xs)
        np.testing.assert_array_equal(vals, e_vals)
    assert picks[:6] == ["tiles", "tiles", "flat", "flat", "mask", "mask"]
    lander = ex.lander
    assert lander.copy_bytes_per_s and all(
        v is not None for v in lander.extra_s.values())


def test_batched_land_executor_matches_stream_executor():
    """Depth 3: None until the batch fills, then the batch's results in
    order; flush lands the tail; resync drops the queue. Every result
    equals the StreamExecutor's for the same frames."""
    cfg = StreamConfig(**_mask_configs(True)["maskonly"])
    base, frames = _frames(cfg, 7, seed=6)
    sync = StreamExecutor(cfg, device="cpu")
    batched = BatchedLandExecutor(cfg, device="cpu", depth=3)
    sync.start(base)
    batched.start(base)
    want = [sync.process(f) for f in frames]
    outs = [batched.process(f) for f in frames]
    assert [o is None for o in outs] == [True, True, False] * 2 + [True]
    tail = batched.flush()
    assert len(tail) == 1 and batched.flush() is None
    got = outs[2] + outs[5] + tail
    assert len(got) == len(want)
    for a, b in zip(got, want):
        pa, (xa, va) = _flat(a)
        pb, (xb, vb) = _flat(b)
        assert pa == pb
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(va, vb)
    batched.process(frames[0])
    np.testing.assert_array_equal(batched.resync(), batched._state.numpy())
    assert batched.flush() is None
    with pytest.raises(ValueError, match="tiled_payload"):
        BatchedLandExecutor(StreamConfig(height=48, width=64),
                            device="cpu")


# -- loopbacks ------------------------------------------------------------

def _serve(server, n_frames):
    errors = []

    def run():
        try:
            server.serve(max_frames=n_frames)
        except BaseException as e:  # surfaced by the test
            errors.append(e)

    server.listen()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, errors


def _drain(cli):
    got = []
    try:
        while True:
            pos, recon = cli.read_frame()
            got.append((pos, recon.copy()))
    except ConnectionError:
        pass
    finally:
        cli.close()
    return got


LOOPBACKS = {
    "bitmask_mask_v4": (dict(emit_bitmask=True, fetch_mode="mask",
                             mask_payload=True, wire_format="v4"), 0),
    "maskonly_batch4_v4": (dict(emit_bitmask=True, fetch_mode="mask",
                                mask_payload=True, maskonly_payload=True,
                                wire_format="v4"), 4),
    "bitmask_mask_v1": (dict(emit_bitmask=True, fetch_mode="mask"), 0),
}


@pytest.mark.parametrize("client_kind", ["port", "jax"])
@pytest.mark.parametrize("path", list(LOOPBACKS))
def test_mask_loopback_byte_exact(path, client_kind):
    """The mask paths over a real socket, decoded by the port's and the
    JAX package's clients (wire auto): the reconstruction equals an
    oracle replay every frame. Under v1 the MaskPayload goes through
    to_flat."""
    kw, depth = LOOPBACKS[path]
    cfg = StreamConfig(height=48, width=64, overlay_scale=4, port=0,
                       tiled_payload=True, **kw)
    n_frames = 6
    ex = (BatchedLandExecutor(cfg, device="cpu", depth=depth) if depth
          else StreamExecutor(cfg, device="cpu"))
    server = DeltaStreamServer(cfg, SyntheticSource(cfg, seed=3),
                               executor=ex, verbose=False,
                               overlay_status=False)
    t, errors = _serve(server, n_frames)
    if client_kind == "port":
        cli = DeltaStreamClient("127.0.0.1", server.port, cfg.height,
                                cfg.width)
    else:
        cli = JaxClient("127.0.0.1", server.port, cfg.height, cfg.width,
                        wire_format="auto")
    cli.connect()
    assert cli.wire_format == cfg.wire_format
    replay = SyntheticSource(cfg, seed=3)
    prev = next(replay).copy()
    np.testing.assert_array_equal(cli.frame, prev)
    got = _drain(cli)
    t.join(timeout=30)
    server.close()
    assert not t.is_alive() and not errors
    assert len(got) == n_frames
    for pos, recon in got:
        prev, e_pos = reference_cpu.step_oracle(prev, next(replay), cfg)[:2]
        assert pos == e_pos > 0
        np.testing.assert_array_equal(recon, prev)
    assert ex.fetch_counts["mask"] == n_frames


def test_server_main_maskonly_v4_land_batch(capsys):
    """The command-line entry points on the bitmask-only v4 path with a
    landing batch whose tail is flushed (5 frames at depth 2)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = ["--height", "48", "--width", "64", "--frames", "5",
            "--port", str(port), "--device", "cpu", "--tiled", "--fetch",
            "mask", "--maskonly", "--wire", "v4", "--land-batch", "2"]
    errors = []

    def run():
        try:
            server_mod.main(args)
        except BaseException as e:
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    for _ in range(200):  # until the server listens
        try:
            rc = client_mod.main(["--port", str(port), "--height", "48",
                                  "--width", "64", "--frames", "5"])
            break
        except ConnectionRefusedError:
            threading.Event().wait(0.05)
    t.join(timeout=30)
    assert rc == 0 and not errors and not t.is_alive()
    assert "decoded 5 frames" in capsys.readouterr().out


def test_static_scene_ships_nothing_on_every_mask_path():
    """Frames equal to the base land as empty results in each flavor and
    encode as an empty delta16 frame under v4."""
    cfg = StreamConfig(**dict(_mask_configs(True)["maskonly"],
                              mask_payload=True))
    base = np.zeros(cfg.frame_bytes, np.uint8)
    ex = StreamExecutor(cfg, device="cpu")
    ex.start(base)
    pos, mp, _, _ = ex.process(base)
    assert pos == 0 and isinstance(mp, wire.MaskPayload) and mp.pos == 0
    enc = wire.V4Encoder(base)
    assert enc.encode(0, mp, None) == jax_wire.V4Encoder(base).encode(
        0, np.empty(0, np.int32), np.empty(0, np.uint8))
