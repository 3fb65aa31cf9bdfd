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
                                 "region_len", "device"])
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

