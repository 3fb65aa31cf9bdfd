"""The port's fused diff+compact (K1, flat emission) against the JAX
package's ``fused_diff_compact`` (Pallas kernel in interpret mode) and the
NumPy spec ``reference_cpu.diff_encode``. Tolerance is zero: every output
is compared byte for byte, full length.

On CPU tensors the port's wrapper runs the kernel's plain PyTorch version;
the CUDA kernel itself is held against that version on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_frame_pair
from cudavideostream_tpu.ops import logcompact as jax_logcompact
from cudavideostream_tpu.ops import reference_cpu as jax_ref
from cudavideostream_tpu_torch.ops import diff as diff_ops
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.ops import reference_cpu

SIZES = {
    "48x64": 48 * 64 * 3,      # 1 tile of the TPU kernel
    "256x256": 256 * 256 * 3,  # 3 tiles
    "240x320": 240 * 320 * 3,  # 4 tiles with padded rows
    "odd1000": 1000,           # not a multiple of 16 or of 128
}
DENSITY = {"d0": 0.0, "d6": 0.06, "d100": 1.0}
REGION_BYTES = 700  # shorter than any tile, not a multiple of 16


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


def _port(prev, cur, region, thr, negfeed, capacity=None):
    prev_t = torch.from_numpy(prev.copy())
    out = logcompact.fused_diff_compact(
        torch.from_numpy(cur), prev_t, threshold=thr,
        negative_feedback=negfeed,
        overlay_region=None if region is None else torch.from_numpy(region),
        capacity=capacity,
    )
    pos, xs, vals, new_prev = out
    assert new_prev is prev_t  # updated in place
    assert pos.dtype == torch.int32 and pos.dim() == 0
    assert xs.dtype == torch.int32 and vals.dtype == torch.uint8
    return int(pos), xs.numpy(), vals.numpy(), new_prev.numpy()


@pytest.mark.parametrize("overlay", [False, True], ids=["plain", "overlay"])
@pytest.mark.parametrize("negfeed", [True, False], ids=["negfeed", "nofeed"])
@pytest.mark.parametrize("thr", [0, 20, 255])
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("density", list(DENSITY))
def test_flat_matches_jax_and_spec(size, density, thr, negfeed, overlay):
    prev, cur, region = _case(size, density, overlay)
    pos, xs, vals, new_prev = _port(prev, cur, region, thr, negfeed)

    # the JAX package, Pallas kernel in interpret mode
    j_pos, j_xs, j_vals, j_new_prev = jax_logcompact.fused_diff_compact(
        jnp.asarray(cur), jnp.asarray(prev), threshold=thr,
        negative_feedback=negfeed, interpret=True,
        overlay_region=None if region is None else jnp.asarray(region),
    )
    assert pos == int(j_pos)
    np.testing.assert_array_equal(xs, np.asarray(j_xs))
    np.testing.assert_array_equal(vals, np.asarray(j_vals))
    np.testing.assert_array_equal(new_prev, np.asarray(j_new_prev))

    # the NumPy spec on the region-substituted frame
    c = cur.copy()
    if region is not None:
        c[: region.size] = region
    e_pos, e_xs, e_vals, e_new_prev = jax_ref.diff_encode(c, prev, thr, negfeed)
    assert pos == e_pos
    np.testing.assert_array_equal(xs[:pos], e_xs)
    np.testing.assert_array_equal(vals[:pos], e_vals)
    assert not xs[pos:].any() and not vals[pos:].any()  # zero past pos
    np.testing.assert_array_equal(new_prev, e_new_prev)
    # the port's own copy of the spec agrees with the JAX package's
    p_pos, p_xs, p_vals, p_new_prev = reference_cpu.diff_encode(
        c, prev, thr, negfeed)
    assert p_pos == e_pos
    np.testing.assert_array_equal(p_xs, e_xs)
    np.testing.assert_array_equal(p_vals, e_vals)
    np.testing.assert_array_equal(p_new_prev, e_new_prev)


@pytest.mark.parametrize("capacity", [1, 100, 2000, 10_000_000])
def test_capacity_truncates_buffers_not_pos(capacity):
    """Buffers hold min(capacity, n) entries; pos stays the true count, so
    the executor can refuse the frame instead of truncating it."""
    prev, cur, _ = _case("48x64", "d6", False)
    full = _port(prev, cur, None, 20, True)
    pos, xs, vals, new_prev = _port(prev, cur, None, 20, True,
                                    capacity=capacity)
    n = SIZES["48x64"]
    assert pos == full[0] and xs.size == vals.size == min(capacity, n)
    np.testing.assert_array_equal(xs, full[1][: xs.size])
    np.testing.assert_array_equal(vals, full[2][: vals.size])
    np.testing.assert_array_equal(new_prev, full[3])


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version, never launches
    the kernel, and matches calling the plain version directly."""
    prev, cur, region = _case("256x256", "d6", True)
    before = logcompact.fused_diff_compact.launches
    out = _port(prev, cur, region, 20, True)
    assert logcompact.fused_diff_compact.launches == before == 0
    prev_t = torch.from_numpy(prev.copy())
    ref = logcompact.fused_diff_compact_reference(
        torch.from_numpy(cur), prev_t, 20, True, torch.from_numpy(region))
    assert out[0] == int(ref[0])
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("bad", ["dtype", "2d", "length", "threshold",
                                 "region_len", "device", "prev_stores_dtype",
                                 "prev_stores_scheme"])
def test_wrapper_rejects_bad_inputs(bad):
    cur = torch.zeros(64, dtype=torch.uint8)
    prev = torch.zeros(64, dtype=torch.uint8)
    kw = {}
    if bad == "dtype":
        cur = cur.to(torch.int32)
    elif bad == "2d":
        cur = cur.reshape(8, 8)
    elif bad == "length":
        prev = prev[:32]
    elif bad == "threshold":
        kw["threshold"] = 256
    elif bad == "region_len":
        kw["overlay_region"] = torch.zeros(65, dtype=torch.uint8)
    elif bad == "device":
        cur, prev = cur.to("meta"), prev.to("meta")
    elif bad == "prev_stores_dtype":
        kw["prev_stores"] = torch.zeros(1, dtype=torch.int32)
    elif bad == "prev_stores_scheme":  # K5 stores every vector, counts none
        kw.update(prev_stores=torch.zeros(1, dtype=torch.int64),
                  scheme="segment")
    with pytest.raises(ValueError):
        logcompact.fused_diff_compact(cur, prev, **kw)


@pytest.mark.parametrize("thr", [0, 20, 255])
def test_diff_mask_matches_jax(thr, rng):
    """The elementwise half of the plain version against the JAX
    ``diff_mask`` (int diff, strict >, wrapped vals)."""
    from cudavideostream_tpu.ops import diff as jax_diff

    prev, cur = make_frame_pair(rng, 4096, change_frac=0.3)
    for negfeed in (True, False):
        m, v, npv = diff_ops.diff_mask(torch.from_numpy(cur),
                                       torch.from_numpy(prev), thr, negfeed)
        jm, jv, jnp_ = jax_diff.diff_mask(jnp.asarray(cur), jnp.asarray(prev),
                                          thr, negfeed)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(npv.numpy(), np.asarray(jnp_))



# -- prev_stores: the 16-byte vectors of prev that K1 stores ---------------

EMISSIONS = ("flat", "tiled", "mask", "batched")


def _k1(emission, cur, prev, thr, negfeed, streams, stores=None):
    """One K1 call of ``emission`` (on CPU tensors: its plain version),
    ``prev`` updated in place, the vectors stored added to ``stores``."""
    if emission == "flat":
        return logcompact.fused_diff_compact(cur, prev, thr, negfeed,
                                             prev_stores=stores)
    if emission == "tiled":
        return logcompact.fused_diff_compact_tiled(
            cur, prev, thr, negfeed, None, 1, prev_stores=stores)
    if emission == "mask":
        return logcompact.fused_diff_compact_mask(
            cur, prev, thr, negfeed, None, 1, prev_stores=stores)
    return logcompact.fused_diff_compact_batched(
        cur, prev, streams, thr, negfeed, sub_rows=1, prev_stores=stores)


def _changed_vectors(prev, cur, thr, negfeed, streams):
    """The NumPy count: 16-byte vectors, counted from each stream's first
    byte (a partial last vector is one), in which new_prev differs from
    prev."""
    c, p = cur.astype(np.int32), prev.astype(np.int32)
    new = np.where(np.abs(c - p) > thr, c, p) if negfeed else c
    changed = (new != p).reshape(streams, -1)
    changed = np.pad(changed, ((0, 0), (0, -changed.shape[1] % 16)))
    return int(changed.reshape(streams, -1, 16).any(axis=2).sum())


def _stores_frames(kind, seed):
    """``(prev, cur, streams, want)`` of a ``prev_stores`` case; ``want``
    None: the NumPy count."""
    rng = np.random.default_rng([seed, len(kind)])
    if kind in ("density6", "streams3"):
        streams = 3 if kind == "streams3" else 1
        n = 1000 if streams == 3 else SIZES["48x64"]
        prev, cur = make_frame_pair(rng, streams * n, change_frac=0.06)
        return prev, cur, streams, None
    n = 1000 if kind in ("ragged", "streams3_edges") else SIZES["48x64"]
    streams = 3 if kind == "streams3_edges" else 1
    prev = rng.integers(30, 120, streams * n, dtype=np.uint8)  # +100 fits
    cur = prev.copy()
    if kind == "one_shipped":  # one byte past the threshold: one vector
        cur[5000] += 100
        return prev, cur, 1, (1, 1)
    if kind == "below_threshold":  # a whole vector moved by 5 < 20
        cur[5008:5024] += 5
        return prev, cur, 1, (0, 1)
    if kind == "ragged":  # n % 16 == 8: the first and the partial last
        cur[0] += 100
        cur[996] += 100
        return prev, cur, 1, (2, 2)
    # stream 0's last byte and stream 1's first share a vector counted
    # from the frame's first byte (992-1007), but not from each stream's
    cur[999] += 100
    cur[1000] += 100
    return prev, cur, 3, (2, 2)


STORE_CASES = (
    [pytest.param("density6", e, nf, thr,
                  id=f"density6-{e}-{'negfeed' if nf else 'nofeed'}-{thr}")
     for e in EMISSIONS for nf in (True, False) for thr in (0, 20, 255)]
    + [pytest.param(kind, e, nf, 20,
                    id=f"{kind}-{e}-{'negfeed' if nf else 'nofeed'}")
       for kind in ("one_shipped", "below_threshold", "ragged")
       for e in EMISSIONS for nf in (True, False)]
    + [pytest.param("streams3", "batched", nf, thr,
                    id=f"streams3-{'negfeed' if nf else 'nofeed'}-{thr}")
       for nf in (True, False) for thr in (0, 20, 255)]
    + [pytest.param("streams3_edges", "batched", nf, 20,
                    id=f"streams3_edges-{'negfeed' if nf else 'nofeed'}")
       for nf in (True, False)])


@pytest.mark.parametrize("kind,emission,negfeed,thr", STORE_CASES)
def test_prev_stores_counts_the_changed_vectors(kind, emission, negfeed,
                                                thr):
    """``prev_stores`` gains the 16-byte vectors of ``prev`` whose new
    bytes differ from the old ones, counted from each stream's first byte:
    under negative feedback the vectors with a shipped byte, without it
    those where ``cur`` differs from ``prev``. Passing it changes no
    output and no byte of the state."""
    prev, cur, streams, want = _stores_frames(kind, thr)
    expect = _changed_vectors(prev, cur, thr, negfeed, streams)
    if want is not None:
        assert expect == want[0 if negfeed else 1]
    stores = torch.tensor([7], dtype=torch.int64)  # the call adds to it
    prev_a = torch.from_numpy(prev.copy())
    out = _k1(emission, torch.from_numpy(cur), prev_a, thr, negfeed,
              streams, stores)
    assert int(stores) == 7 + expect
    prev_b = torch.from_numpy(prev.copy())
    plain = _k1(emission, torch.from_numpy(cur), prev_b, thr, negfeed,
                streams)
    assert len(out) == len(plain)
    for a, b in zip(out, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(prev_a.numpy(), prev_b.numpy())
