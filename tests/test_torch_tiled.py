"""The port's tiled emission of K1 and its merge (K2) against the JAX
package: ``fused_diff_compact(emit="tiled")`` with the Pallas kernel in
interpret mode, ``merge_tiles`` (the two-stage pair-kernel branch past 256
units and the serial one below) and ``_pair_compact``. Tolerance is zero:
every output is compared byte for byte, full length, dtypes included.

On CPU tensors the port's wrappers run the kernels' plain PyTorch
versions; the CUDA kernels themselves are held against those versions on
the card by ``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_frame_pair
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.models import DeltaStreamPipeline as JaxPipeline
from cudavideostream_tpu.ops import logcompact as jax_logcompact
from cudavideostream_tpu.ops import reference_cpu as jax_ref
from cudavideostream_tpu_torch.config import StreamConfig
from cudavideostream_tpu_torch.models import DeltaStreamPipeline
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.ops import reference_cpu
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.utils import fonts

SIZES = {
    "48x64": 48 * 64 * 3,      # one 72-row tile
    "240x320": 240 * 320 * 3,  # four tiles with padded rows
    "odd1000": 1000,           # not a multiple of 16 or of 128
}
DENSITY = {"d0": 0.0, "d6": 0.06, "d100": 1.0}
REGION_BYTES = 700  # shorter than any unit of a tile, not a multiple of 16
SUB_ROWS = [0, 1, 8, 32]

N_1080P = 1920 * 1080 * 3


def _case(size, density, overlay, seed=0):
    n = SIZES[size]
    rng = np.random.default_rng(
        [seed, n, int(DENSITY[density] * 100), int(overlay)])
    prev, cur = make_frame_pair(rng, n, change_frac=DENSITY[density])
    region = None
    if overlay:
        region = rng.integers(0, 255, min(n, REGION_BYTES), endpoint=True,
                              dtype=np.uint8)
    return prev, cur, region


def _port_tiled(prev, cur, region, thr, negfeed, sub_rows):
    prev_t = torch.from_numpy(prev.copy())
    pos, counts, xs_t, vals_t, new_prev = logcompact.fused_diff_compact_tiled(
        torch.from_numpy(cur), prev_t, threshold=thr,
        negative_feedback=negfeed,
        overlay_region=None if region is None else torch.from_numpy(region),
        sub_rows=sub_rows,
    )
    assert new_prev is prev_t  # updated in place
    assert pos.dtype == torch.int32 and pos.dim() == 0
    return (int(pos), counts.numpy(), xs_t.numpy(), vals_t.numpy(),
            new_prev.numpy())


def _jax_tiled(prev, cur, region, thr, negfeed, sub_rows):
    out = jax_logcompact.fused_diff_compact(
        jnp.asarray(cur), jnp.asarray(prev), threshold=thr,
        negative_feedback=negfeed, interpret=True, emit="tiled",
        sub_rows=sub_rows,
        overlay_region=None if region is None else jnp.asarray(region),
    )
    return (int(out[0]),) + tuple(np.asarray(a) for a in out[1:])


def _assert_same(got, want):
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("overlay", [False, True], ids=["plain", "overlay"])
@pytest.mark.parametrize("negfeed", [True, False], ids=["negfeed", "nofeed"])
@pytest.mark.parametrize("thr", [0, 20, 255])
@pytest.mark.parametrize("density", list(DENSITY))
@pytest.mark.parametrize("sub_rows", SUB_ROWS, ids=lambda s: f"sub{s}")
@pytest.mark.parametrize("size", list(SIZES))
def test_tiled_matches_jax(size, sub_rows, density, thr, negfeed, overlay):
    """pos, narrowed counts, the full blocks and new_prev, against the
    JAX package's tiled emission (Pallas in interpret mode)."""
    prev, cur, region = _case(size, density, overlay)
    got = _port_tiled(prev, cur, region, thr, negfeed, sub_rows)
    _assert_same(got, _jax_tiled(prev, cur, region, thr, negfeed, sub_rows))
    # the units' prefixes are the flat payload of the NumPy spec
    c = cur.copy()
    if region is not None:
        c[: region.size] = region
    e_pos, e_xs, e_vals, e_prev = jax_ref.diff_encode(c, prev, thr, negfeed)
    xs, vals = wire.TiledPayload(*got[:4]).to_flat()
    assert got[0] == e_pos
    np.testing.assert_array_equal(xs, e_xs)
    np.testing.assert_array_equal(vals, e_vals)


@pytest.mark.parametrize("sub_rows", SUB_ROWS, ids=lambda s: f"sub{s}")
def test_1080p_geometry_matches_jax(sub_rows):
    """At 1080p the rows pad from 48,600 to 48,608 with 496-row tiles;
    units, unit size and counts dtype are the JAX package's (sub_rows=32
    does not divide 496 and falls back to whole tiles)."""
    rows, tile_rows = jax_logcompact._tile_geometry(-(-N_1080P // 128))
    assert (rows, tile_rows) == (48_608, 496)
    assert logcompact._tile_geometry(48_600) == (rows, tile_rows)
    n_pad, unit_bytes = logcompact.tiled_geometry(N_1080P, sub_rows)
    want = {0: (98, 63_488, torch.int32), 1: (48_608, 128, torch.uint8),
            8: (6_076, 1_024, torch.int16), 32: (98, 63_488, torch.int32)}
    assert n_pad == rows * 128
    assert (n_pad // unit_bytes, unit_bytes,
            logcompact.counts_dtype(unit_bytes)) == want[sub_rows]
    j = jax_logcompact._narrow_counts(jnp.zeros(4, jnp.int32), unit_bytes)
    assert np.dtype(str(logcompact.counts_dtype(unit_bytes))[6:]) == j.dtype


@pytest.mark.parametrize("rows", [1, 7, 8, 360, 1000, 48_600, 4_200_000])
def test_tile_geometry_copy_matches_jax(rows):
    """The copied geometry, including the grown tiles past 2000 tiles."""
    assert logcompact._tile_geometry(rows) == jax_logcompact._tile_geometry(
        rows)


def test_1080p_tiled_step_matches_step_oracle():
    """One full-size tiled pipeline step of the plain path against the
    NumPy spec, after concatenating the units' prefixes."""
    cfg = StreamConfig(tiled_payload=True)
    rng = np.random.default_rng(1080)
    prev_np, cur = make_frame_pair(rng, cfg.frame_bytes)
    text = "FPS: 30 BW: 1234 kbps"
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    new_prev, pos, counts, xs_t, vals_t, aux = pipe.step(
        pipe.init_state(prev_np), cur, text=text)
    assert aux is None and tuple(xs_t.shape) == (48_608, 128)
    assert counts.dtype == torch.uint8
    e_prev, e_pos, e_xs, e_vals, _ = reference_cpu.step_oracle(
        prev_np, cur, cfg, atlas=pipe.atlas_np,
        char_ids=fonts.encode_text(text))
    xs, vals = wire.TiledPayload(int(pos), counts.numpy(), xs_t.numpy(),
                                 vals_t.numpy()).to_flat()
    assert int(pos) == e_pos > 0
    np.testing.assert_array_equal(xs, e_xs)
    np.testing.assert_array_equal(vals, e_vals)
    np.testing.assert_array_equal(new_prev.numpy(), e_prev)


def _port_config(jax_cfg):
    return StreamConfig(**{f.name: getattr(jax_cfg, f.name)
                           for f in dataclasses.fields(StreamConfig)
                           if f.name not in ("visualizer", "compaction")})


@pytest.mark.parametrize("negfeed", [True, False], ids=["negfeed", "nofeed"])
@pytest.mark.parametrize("sub_rows", [0, 1, 8], ids=lambda s: f"sub{s}")
def test_tiled_pipeline_matches_jax(small_config, rng, sub_rows, negfeed):
    """The tiled pipeline step, frame after frame with a changing overlay
    text, against the JAX pipeline's tiled step."""
    jcfg = dataclasses.replace(small_config, tiled_payload=True,
                               subtile_rows=sub_rows,
                               negative_feedback=negfeed)
    jpipe = JaxPipeline(jcfg)
    pipe = DeltaStreamPipeline(_port_config(jcfg), device="cpu")
    base, _ = make_frame_pair(rng, jcfg.frame_bytes)
    jprev, prev = jpipe.init_state(base), pipe.init_state(base)
    for k, text in enumerate(["12", "13", "13", "", "P5"]):
        frame = (make_frame_pair(rng, jcfg.frame_bytes)[1] if k != 2
                 else frame)
        jout = jpipe.step(jprev, frame, text=text)
        out = pipe.step(prev, frame, text=text)
        assert len(out) == len(jout) == 6 and out[5] is None
        assert out[0] is prev
        _assert_same((int(out[1]),) + tuple(t.numpy() for t in out[2:5])
                     + (out[0].numpy(),),
                     (int(jout[1]),) + tuple(np.asarray(a) for a in jout[2:5])
                     + (np.asarray(jout[0]),))
        jprev, prev = jout[0], out[0]


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions and launch no
    kernel."""
    prev, cur, region = _case("240x320", "d6", True)
    before = (logcompact.fused_diff_compact_tiled.launches,
              logcompact.pair_compact.launches)
    got = _port_tiled(prev, cur, region, 20, True, 1)
    ref = logcompact.fused_diff_compact_tiled_reference(
        torch.from_numpy(cur), torch.from_numpy(prev.copy()), 20, True,
        torch.from_numpy(region), 1)
    _assert_same(got, (int(ref[0]),) + tuple(t.numpy() for t in ref[1:]))
    logcompact.merge_tiles(*(torch.from_numpy(a) for a in got[1:4]))
    assert (logcompact.fused_diff_compact_tiled.launches,
            logcompact.pair_compact.launches) == before == (0, 0)


@pytest.mark.parametrize("bad", ["dtype", "2d", "length", "threshold",
                                 "region_len", "device"])
def test_tiled_wrapper_rejects_bad_inputs(bad):
    cur = torch.zeros(1024, dtype=torch.uint8)
    prev = torch.zeros(1024, dtype=torch.uint8)
    kw = {"sub_rows": 1}
    if bad == "dtype":
        cur = cur.to(torch.int32)
    elif bad == "2d":
        cur = cur.reshape(8, 128)
    elif bad == "length":
        prev = prev[:512]
    elif bad == "threshold":
        kw["threshold"] = -1
    elif bad == "region_len":
        kw["overlay_region"] = torch.zeros(1025, dtype=torch.uint8)
    elif bad == "device":
        cur, prev = cur.to("meta"), prev.to("meta")
    with pytest.raises(ValueError):
        logcompact.fused_diff_compact_tiled(cur, prev, **kw)


def _tiled_blocks(n, sub_rows, seed):
    rng = np.random.default_rng([seed, n, sub_rows])
    prev = rng.integers(0, 255, n, endpoint=True, dtype=np.uint8)
    cur = np.where(rng.random(n) < 0.06,
                   (prev.astype(np.int32) + 100) % 256, prev).astype(np.uint8)
    return _jax_tiled(prev, cur, None, 20, True, sub_rows)


@pytest.mark.parametrize("n,sub_rows", [
    (600_000, 8),   # 586 units: the JAX two-stage pair-kernel branch
    (600_000, 1),   # 4,688 units of 128 B
    (48 * 64 * 3, 8),  # 9 units: the serial branch
    (48 * 64 * 3, 0),  # 1 unit
], ids=["two_stage_sub8", "two_stage_sub1", "serial_sub8", "serial_sub0"])
def test_merge_tiles_matches_jax(n, sub_rows):
    """Port merge_tiles == JAX merge_tiles on the pos prefix, with a zero
    tail, on both sides of MERGE_SERIAL_MAX_UNITS."""
    pos, counts, xs_t, vals_t, _ = _tiled_blocks(n, sub_rows, 5)
    two_stage = counts.shape[0] > jax_logcompact.MERGE_SERIAL_MAX_UNITS
    assert two_stage == (n > 100_000)
    j_xs, j_vals = (np.asarray(a) for a in jax_logcompact.merge_tiles(
        jnp.asarray(counts), jnp.asarray(xs_t), jnp.asarray(vals_t)))
    xs, vals = logcompact.merge_tiles(*(torch.from_numpy(a.copy())
                                        for a in (counts, xs_t, vals_t)))
    assert xs.dtype == torch.int32 and vals.dtype == torch.uint8
    assert xs.numel() == vals.numel() == xs_t.size
    xs, vals = xs.numpy(), vals.numpy()
    np.testing.assert_array_equal(xs[:pos], j_xs[:pos])
    np.testing.assert_array_equal(vals[:pos], j_vals[:pos])
    assert not xs[pos:].any() and not vals[pos:].any()
    assert not j_xs[pos:].any() and not j_vals[pos:].any()


@pytest.mark.parametrize("n,density", [
    (5_000, 0.3), (70_000, 0.05), (70_000, 1.0), (70_000, 0.0), (999, 0.5),
])
def test_pair_compact_matches_jax(n, density):
    """Raw pairs, with xs == 0 entries (index 0 is valid: occupancy
    follows vals) and interior zero vals, against the concatenated tile
    prefixes of JAX ``_pair_compact``."""
    rng = np.random.default_rng([n, int(density * 100)])
    xs = rng.integers(0, 3, n).astype(np.int32)  # a third are 0
    vals = np.where(rng.random(n) < density,
                    rng.integers(1, 255, n, endpoint=True), 0).astype(np.uint8)
    counts, xs_t, vals_t = (np.asarray(a) for a in
                            jax_logcompact._pair_compact(
                                jnp.asarray(xs), jnp.asarray(vals),
                                interpret=True))
    j_xs, j_vals = wire.TiledPayload(int(counts.sum()), counts, xs_t,
                                     vals_t).to_flat()
    pos, p_xs, p_vals = logcompact.pair_compact(torch.from_numpy(xs),
                                                torch.from_numpy(vals))
    pos = int(pos)
    assert pos == j_xs.size == int(np.count_nonzero(vals))
    assert p_xs.numel() == p_vals.numel() == n
    np.testing.assert_array_equal(p_xs[:pos].numpy(), j_xs)
    np.testing.assert_array_equal(p_vals[:pos].numpy(), j_vals)
    assert not p_xs[pos:].any() and not p_vals[pos:].any()
    if density == 0.3:  # a kept pair with index 0 survives
        assert (p_xs[:pos] == 0).any()


@pytest.mark.parametrize("bad", ["xs_dtype", "vals_dtype", "length", "2d",
                                 "empty", "device"])
def test_pair_compact_rejects_bad_inputs(bad):
    xs = torch.zeros(64, dtype=torch.int32)
    vals = torch.zeros(64, dtype=torch.uint8)
    if bad == "xs_dtype":
        xs = xs.to(torch.int64)
    elif bad == "vals_dtype":
        vals = vals.to(torch.int32)
    elif bad == "length":
        vals = vals[:32]
    elif bad == "2d":
        xs, vals = xs.reshape(8, 8), vals.reshape(8, 8)
    elif bad == "empty":
        xs, vals = xs[:0], vals[:0]
    elif bad == "device":
        xs, vals = xs.to("meta"), vals.to("meta")
    with pytest.raises(ValueError):
        logcompact.pair_compact(xs, vals)


def test_merge_tiles_rejects_mismatched_blocks():
    counts = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(ValueError):
        logcompact.merge_tiles(counts, torch.zeros((4, 128), dtype=torch.int32),
                               torch.zeros((4, 64), dtype=torch.uint8))
    with pytest.raises(ValueError):
        logcompact.merge_tiles(counts[:3],
                               torch.zeros((4, 128), dtype=torch.int32),
                               torch.zeros((4, 128), dtype=torch.uint8))


def test_config_tiled_fields_match_jax():
    """The tiled fields validate as in the JAX config."""
    for kw in ({"tiled_payload": True, "payload_capacity": 10},
               {"fetch_mode": "flat"}, {"subtile_rows": 3}):
        with pytest.raises(ValueError):
            JaxConfig(**kw)
        with pytest.raises(ValueError):
            StreamConfig(**kw)
