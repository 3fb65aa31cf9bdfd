"""The port's two cross-check compaction schemes and the compare probe:
K5 (``scheme="segment"``, ``logcompact.segment_compact``) and K6
(``scheme="register"``, ``ops.register_compact``) against the JAX
``fused_diff_compact(..., scheme=..., interpret=True)``, flat and tiled,
on every output (``new_prev``, the full-length zero-filled buffers, the
counts and their dtype); the schemes' refusals; and K7 (``vpu_probe``)
against the JAX probe in interpret mode, out-of-range values included.
On the CPU each wrapper runs its plain version, which follows its own
scheme (segment merging, a row loop), so three derivations meet here.
Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_frame_pair
from cudavideostream_tpu.ops import hist_pallas as jax_hist
from cudavideostream_tpu.ops import logcompact as jax_logcompact
from cudavideostream_tpu_torch.ops import hist
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.ops import reference_cpu
from cudavideostream_tpu_torch.ops import register_compact
from torch_kernel_fixtures import no_kernel_build  # noqa: F401

SIZES = {
    "48x64": 48 * 64 * 3,     # one tile of 72 rows
    "120x240": 120 * 240 * 3,  # 86,400 B: 2 tiles of 400 rows
}


def _case(n, seed, density=0.06, extras=False):
    rng = np.random.default_rng([seed, n])
    prev, cur = make_frame_pair(rng, n, change_frac=density)
    region = tm = None
    if extras:
        region = rng.integers(0, 256, min(n, 700), dtype=np.uint8)
        tm = rng.integers(0, 40, n, dtype=np.uint8)
        tm[rng.random(n) < 0.05] = 0
        tm[rng.random(n) < 0.05] = 255
    return prev, cur, region, tm


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _port(emit, scheme, prev, cur, region=None, tm=None, **kw):
    prev_t = torch.from_numpy(prev.copy())
    fn = (logcompact.fused_diff_compact if emit == "flat"
          else logcompact.fused_diff_compact_tiled)
    out = fn(torch.from_numpy(cur), prev_t, overlay_region=_t(region),
             threshold_map=_t(tm), scheme=scheme, **kw)
    assert out[-1] is prev_t  # updated in place
    assert out[0].dtype == torch.int32 and out[0].dim() == 0
    return (int(out[0]),) + tuple(t.numpy() for t in out[1:])


def _jax(emit, scheme, prev, cur, region=None, tm=None, **kw):
    out = jax_logcompact.fused_diff_compact(
        jnp.asarray(cur), jnp.asarray(prev), interpret=True, scheme=scheme,
        emit=emit, overlay_region=None if region is None else
        jnp.asarray(region), threshold_map=None if tm is None else
        jnp.asarray(tm), **kw)
    return (int(out[0]),) + tuple(np.asarray(a) for a in out[1:])


def _assert_same(got, want):
    assert got[0] == want[0] and len(got) == len(want)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("emit", ["flat", "tiled"])
@pytest.mark.parametrize("scheme", ["segment", "register"])
def test_scheme_matches_jax(scheme, emit, size):
    """Every output of the flat and tiled emissions against JAX; on the
    tiled one ``sub_rows=1`` is passed and ignored (whole tiles), as the
    JAX package ignores it for these schemes."""
    prev, cur, _, _ = _case(SIZES[size], 0)
    kw = {} if emit == "flat" else {"sub_rows": 1}
    got = _port(emit, scheme, prev, cur, **kw)
    _assert_same(got, _jax(emit, scheme, prev, cur, **kw))
    assert got[0] > 0
    if emit == "tiled":
        n_pad, unit_bytes = logcompact.tiled_geometry(SIZES[size], 0)
        assert got[2].shape == (n_pad // unit_bytes, unit_bytes)
        assert (torch.from_numpy(got[1]).dtype
                == logcompact.counts_dtype(unit_bytes))


@pytest.mark.parametrize("emit", ["flat", "tiled"])
@pytest.mark.parametrize("extras", ["map", "region_and_map"])
def test_segment_with_region_and_map_matches_jax(extras, emit):
    """K5 takes the overlay region and the per-byte map, as the JAX
    segment kernel does."""
    prev, cur, region, tm = _case(SIZES["48x64"], 1, extras=True)
    if extras == "map":
        region = None
    got = _port(emit, "segment", prev, cur, region, tm)
    _assert_same(got, _jax(emit, "segment", prev, cur, region, tm))


@pytest.mark.parametrize("n", [129, 9000])
@pytest.mark.parametrize("scheme", ["segment", "register"])
def test_ragged_lengths_match_jax(scheme, n):
    """Frames that pad to a partial row and to a partial tile."""
    prev, cur, _, _ = _case(n, 2)
    _assert_same(_port("flat", scheme, prev, cur),
                 _jax("flat", scheme, prev, cur))


@pytest.mark.parametrize("density", [0.0, 0.06, 1.0])
@pytest.mark.parametrize("thr,negfeed", [(0, True), (20, False),
                                         (255, True)])
def test_three_plain_derivations_agree(thr, negfeed, density):
    """Without JAX: K1's, K5's and K6's plain versions give the same
    whole-tile blocks, and the flat payload is the NumPy spec's."""
    n = SIZES["120x240"]
    prev, cur, _, _ = _case(n, 3, density)
    outs = {s: _port("tiled", s, prev, cur, threshold=thr,
                     negative_feedback=negfeed)
            for s in logcompact.SCHEMES}
    for s in ("segment", "register"):
        _assert_same(outs[s], outs["element"])
    e_pos, e_xs, e_vals, e_prev = reference_cpu.diff_encode(cur, prev, thr,
                                                            negfeed)
    for s in logcompact.SCHEMES:
        pos, xs, vals, new_prev = _port("flat", s, prev, cur, threshold=thr,
                                        negative_feedback=negfeed)
        assert pos == e_pos
        np.testing.assert_array_equal(xs[:pos], e_xs)
        np.testing.assert_array_equal(vals[:pos], e_vals)
        assert not xs[pos:].any() and not vals[pos:].any()
        np.testing.assert_array_equal(new_prev, e_prev)


def test_flat_scheme_honours_capacity():
    prev, cur, _, _ = _case(SIZES["48x64"], 4, 0.5)
    for s in logcompact.SCHEMES:
        pos, xs, vals, _ = _port("flat", s, prev, cur, capacity=100)
        assert pos > 100 and xs.shape == (100,) and vals.shape == (100,)
        want = reference_cpu.diff_encode(cur, prev)
        np.testing.assert_array_equal(xs, want[1][:100])


def test_mask_emission_is_element_scheme_only():
    """emit="mask" with another scheme raises with the JAX message
    (``tests/test_maskonly.py:134-141``); so does the tiled emission's
    packed bits."""
    prev, cur, _, _ = _case(SIZES["48x64"], 5)
    with pytest.raises(ValueError, match="element scheme"):
        _jax("mask", "segment", prev, cur)
    c, p = torch.from_numpy(cur), torch.from_numpy(prev.copy())
    for scheme in ("segment", "register"):
        with pytest.raises(ValueError, match="element scheme"):
            logcompact.fused_diff_compact_mask(c, p, scheme=scheme)
        with pytest.raises(ValueError, match="element scheme"):
            logcompact.fused_diff_compact_tiled(c, p, emit_bits=True,
                                                scheme=scheme)
    np.testing.assert_array_equal(p.numpy(), prev)  # nothing ran


@pytest.mark.parametrize("emit", ["flat", "tiled"])
@pytest.mark.parametrize("extra", ["region", "map"])
def test_register_refuses_region_and_map(extra, emit):
    """The register scheme takes neither the overlay region nor a map:
    the JAX package refuses both (``logcompact.py:671-675``), with the
    same message."""
    prev, cur, region, tm = _case(SIZES["48x64"], 6, extras=True)
    args = (region, None) if extra == "region" else (None, tm)
    match = "element/segment schemes only"
    with pytest.raises(ValueError, match=match):
        _jax(emit, "register", prev, cur, *args)
    with pytest.raises(ValueError, match=match):
        _port(emit, "register", prev, cur, *args)


def test_unknown_scheme_raises():
    c = torch.zeros(100, dtype=torch.uint8)
    for fn in (logcompact.fused_diff_compact,
               logcompact.fused_diff_compact_tiled,
               logcompact.fused_diff_compact_mask):
        with pytest.raises(ValueError, match="unknown scheme"):
            fn(c, c.clone(), scheme="bogus")


def test_empty_region_is_no_region_for_register():
    """A zero-length region is no region (the JAX package drops it)."""
    prev, cur, _, _ = _case(SIZES["48x64"], 7)
    got = _port("tiled", "register", prev, cur, np.zeros(0, np.uint8))
    _assert_same(got, _port("tiled", "register", prev, cur))


def test_cpu_tensors_count_no_launch():
    """On the CPU the wrappers run their plain versions: no launch is
    counted, and the counts of the kernels they do not use stay put."""
    prev, cur, _, _ = _case(SIZES["48x64"], 8)
    fns = (logcompact.segment_compact, register_compact.register_compact,
           hist.vpu_probe, logcompact.fused_diff_compact,
           logcompact.pair_compact)
    before = [f.launches for f in fns]
    for s in logcompact.SCHEMES:
        _port("flat", s, prev, cur)
        _port("tiled", s, prev, cur)
    hist.vpu_probe(torch.zeros((8, 128), dtype=torch.int32))
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("which", ["segment", "register", "probe"])
def test_new_kernels_on_cuda_launch_or_raise(which, monkeypatch,
                                            no_kernel_build):
    """A CUDA tensor never takes a plain version: without a kernel build
    (no nvcc here) each wrapper raises, its plain version is not called
    and no launch is counted."""
    calls = []
    fn, ref_mod, ref_name = {
        "segment": (logcompact.segment_compact, logcompact,
                    "segment_compact_reference"),
        "register": (register_compact.register_compact, register_compact,
                     "register_compact_reference"),
        "probe": (hist.vpu_probe, hist, "vpu_probe_reference"),
    }[which]
    monkeypatch.setattr(ref_mod, ref_name, lambda *a, **k: calls.append(a))
    frame = torch.zeros(4096, dtype=torch.uint8)
    prev = torch.ones(4096, dtype=torch.uint8)
    grid = torch.zeros((8, 128), dtype=torch.int32)
    before = fn.launches
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    ptrs = iter(range(4096, 1 << 20, 4096))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: next(ptrs))
    with pytest.raises(RuntimeError, match="nvcc"):
        if which == "probe":
            fn(grid)
        else:
            fn(frame, prev)
    monkeypatch.undo()
    assert not calls and fn.launches == before


# -- K7 ---------------------------------------------------------------------

@pytest.mark.parametrize("rows,lo,hi", [
    (16, 0, 256),       # gray values: each checksum is the tile's count
    (45, -300, 600),    # out-of-range values add nothing
    (360, -(1 << 31), (1 << 31) - 1),
    (201, -5, 300),     # no tile divides: 25 tiles of 8, the last row unread
], ids=["gray16", "oor45", "int32_360", "ragged201"])
def test_vpu_probe_matches_jax(rows, lo, hi):
    rng = np.random.default_rng(rows)
    g = rng.integers(lo, hi, (rows, 128), dtype=np.int64).astype(np.int32)
    got = hist.vpu_probe(torch.from_numpy(g))
    want = np.asarray(jax_hist.vpu_probe(jnp.asarray(g), interpret=True))
    assert got.dtype == torch.int32 and got.numpy().shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    tile = hist.probe_tile(rows)
    assert tile == jax_hist._tile(rows)
    in_range = ((g >= 0) & (g <= 255))[: rows // tile * tile]
    np.testing.assert_array_equal(
        got.numpy(), in_range.reshape(rows // tile, -1).sum(axis=1))


def test_vpu_probe_takes_unroll_and_casts_like_jax():
    """``unroll`` changes no value; a uint8 grid is cast to int32."""
    g = np.arange(16 * 128, dtype=np.int64).reshape(16, 128) % 256
    g8 = torch.from_numpy(g.astype(np.uint8))
    a = hist.vpu_probe(g8, unroll=True)
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(jax_hist.vpu_probe(jnp.asarray(g.astype(
            np.uint8)), interpret=True, unroll=True)))
    np.testing.assert_array_equal(a.numpy(), [16 * 128])


@pytest.mark.parametrize("bad", ["1d", "width", "float", "rows"])
def test_vpu_probe_rejects_bad_grids(bad):
    g = {"1d": torch.zeros(128, dtype=torch.int32),
         "width": torch.zeros((8, 64), dtype=torch.int32),
         "float": torch.zeros((8, 128)),
         "rows": torch.zeros((7, 128), dtype=torch.int32)}[bad]
    with pytest.raises(ValueError, match="vpu_probe"):
        hist.vpu_probe(g)
