"""The port's sort compaction (``ops/compact.py``) on the CPU against the
JAX package's: ``compact_sort``, ``compact_padded``, ``flatten_padded``
and ``compact`` on the same seeded numpy inputs, byte-exact with no
tolerance, at densities 0, 0.06 and 1, capacities under and over ``pos``
and odd lengths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavideostream_tpu.ops import compact as jax_compact
from cudavideostream_tpu_torch.ops import compact

DENSITIES = [0.0, 0.06, 1.0]
LENGTHS = [1, 17, 1000, 4099]


def _inputs(n, density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < density
    vals = rng.integers(0, 256, n, dtype=np.uint8)
    return mask, vals


def _equal(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("cap", ["under", "at", "over"])
def test_compact_sort_matches_jax(n, density, cap):
    """``(pos, xs, vals)`` equal to the JAX ``compact_sort``'s, zero past
    ``pos``; the capacity below the count, at it, or past the frame."""
    mask, vals = _inputs(n, density, seed=n)
    pos = int(mask.sum())
    capacity = {"under": max(1, pos // 2), "at": max(1, pos),
                "over": n + 5}[cap]
    got = compact.compact_sort(torch.from_numpy(mask), torch.from_numpy(vals),
                               capacity)
    want = jax_compact.compact_sort(jnp.asarray(mask), jnp.asarray(vals),
                                    capacity)
    for g, w in zip(got, want):
        _equal(g, w)
    assert int(got[0]) == pos
    xs, v = got[1].numpy(), got[2].numpy()
    kept = min(pos, xs.size)
    np.testing.assert_array_equal(xs[:kept], np.flatnonzero(mask)[:kept])
    assert not xs[kept:].any() and not v[kept:].any()


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("rows,row_len", [(1, 16), (7, 32), (5, 1024)])
def test_compact_padded_matches_jax(rows, row_len, density):
    """The padded rows, their counts and ``pos`` equal the JAX
    ``compact_padded``'s: each row's prefix ascending global indices, the
    rest zero."""
    n = rows * row_len
    mask, vals = _inputs(n, density, seed=rows * 31 + row_len)
    got = compact.compact_padded(torch.from_numpy(mask),
                                 torch.from_numpy(vals), row_len)
    want = jax_compact.compact_padded(jnp.asarray(mask), jnp.asarray(vals),
                                      row_len)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("cap", ["under", "over"])
def test_flatten_padded_matches_jax(density, cap):
    """The gather of the padded rows into ``capacity`` flat entries."""
    rows, row_len = 9, 64
    mask, vals = _inputs(rows * row_len, density, seed=9)
    pos, xs_pad, vals_pad, counts = compact.compact_padded(
        torch.from_numpy(mask), torch.from_numpy(vals), row_len)
    capacity = max(1, int(pos) // 3) if cap == "under" else rows * row_len + 3
    got = compact.flatten_padded(xs_pad, vals_pad, counts, capacity)
    want = jax_compact.flatten_padded(
        jnp.asarray(xs_pad.numpy()), jnp.asarray(vals_pad.numpy()),
        jnp.asarray(counts.numpy()), capacity)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("backend", ["sort", "padded"])
def test_compact_dispatch_matches_jax(backend, density):
    """``compact`` through either backend: the same ``(pos, xs, vals)`` as
    the JAX dispatch, and both backends agree."""
    n, row_len = 2048, 256
    mask, vals = _inputs(n, density, seed=5)
    capacity = n
    got = compact.compact(torch.from_numpy(mask), torch.from_numpy(vals),
                          capacity, backend, row_len=row_len)
    want = jax_compact.compact(jnp.asarray(mask), jnp.asarray(vals), capacity,
                               backend, row_len=row_len)
    for g, w in zip(got, want):
        _equal(g, w)
    other = compact.compact(torch.from_numpy(mask), torch.from_numpy(vals),
                            capacity, "sort")
    for g, o in zip(got, other):
        np.testing.assert_array_equal(g.numpy(), o.numpy())


def test_refusals_match_jax():
    """The packed-key limit (asked on meta tensors, which hold no bytes),
    a row length that does not divide the frame, an unknown backend."""
    n = compact._MAX_PACKED_ELEMS + 1
    assert compact._MAX_PACKED_ELEMS == jax_compact._MAX_PACKED_ELEMS
    meta = torch.empty(n, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="packed-key compaction limit"):
        compact.compact_sort(meta, meta.to(torch.uint8), 10)
    with pytest.raises(ValueError, match="not divisible by row_len"):
        compact.compact_padded(torch.zeros(100, dtype=torch.bool),
                               torch.zeros(100, dtype=torch.uint8), 64)
    with pytest.raises(ValueError, match="unknown compaction backend"):
        compact.compact(torch.zeros(8, dtype=torch.bool),
                        torch.zeros(8, dtype=torch.uint8), 8, "atomic")


def test_compact_sort_at_the_packed_limit_keeps_the_last_index():
    """The largest frame the packed keys take: its last byte's key is
    ``(limit - 1) * 256 + 255``, still below the pad."""
    n = compact._MAX_PACKED_ELEMS
    mask = torch.zeros(n, dtype=torch.bool)
    mask[[0, n - 1]] = True
    vals = torch.full((n,), 255, dtype=torch.uint8)
    pos, xs, v = compact.compact_sort(mask, vals, 4)
    assert int(pos) == 2
    assert xs.tolist() == [0, n - 1, 0, 0] and v.tolist() == [255, 255, 0, 0]
