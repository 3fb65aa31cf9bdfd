"""The port's ``median_filter`` (``ops/convolve.py``) and its NumPy spec
copy (``ops/reference_cpu.py``) on the CPU against the JAX package's
``median_filter`` and ``reference_cpu.median_filter``, byte-exact, for
k = 1, 3, 5, 7 on odd geometries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavideostream_tpu.ops import convolve as jax_convolve
from cudavideostream_tpu.ops import reference_cpu as jax_ref
from cudavideostream_tpu_torch.ops import convolve
from cudavideostream_tpu_torch.ops import reference_cpu as ref

GEOMETRIES = [(7, 9), (13, 5), (3, 31), (17, 17)]


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_median_filter_matches_jax_and_spec(h, w, k):
    rng = np.random.default_rng(h * 100 + w * 10 + k)
    frame = rng.integers(0, 256, h * w * 3, dtype=np.uint8)
    t = torch.from_numpy(frame.copy())
    got = convolve.median_filter(t, k, h, w)
    assert got.dtype == torch.uint8 and got.shape == (h * w * 3,)
    np.testing.assert_array_equal(t.numpy(), frame)  # not written
    got = got.numpy()
    np.testing.assert_array_equal(got, ref.median_filter(frame, k, h, w))
    np.testing.assert_array_equal(got, jax_ref.median_filter(frame, k, h, w))
    np.testing.assert_array_equal(
        got, np.asarray(jax_convolve.median_filter(jnp.asarray(frame), k, h,
                                                   w)))


@pytest.mark.parametrize("n", [1, 2, 9, 25, 49, 64])
def test_merge_network_matches_jax_and_sorts(n):
    """The compare-exchange pairs are the JAX network's, and they sort
    every input (checked on random ones and all 0/1 ones for small n)."""
    pairs = convolve._oddeven_merge_network(n)
    assert pairs == jax_convolve._oddeven_merge_network(n)
    rng = np.random.default_rng(n)
    inputs = [rng.integers(0, 9, n) for _ in range(50)]
    if n <= 9:
        inputs += [np.array([(m >> i) & 1 for i in range(n)])
                   for m in range(1 << n)]
    for x in inputs:
        x = list(x)
        for a, b in pairs:
            x[a], x[b] = min(x[a], x[b]), max(x[a], x[b])
        assert x == sorted(x)


def test_median_of_constant_and_impulse_frames():
    """A flat frame keeps its value inside (zero padding pulls the border
    of a k=3 window down only where more than half of it is padding: the
    corners); a lone impulse vanishes."""
    h, w = 9, 11
    flat = torch.full((h * w * 3,), 77, dtype=torch.uint8)
    out = convolve.median_filter(flat, 3, h, w).reshape(h, w, 3)
    assert (out[1:-1, 1:-1] == 77).all() and (out[0, 0] == 0).all()
    imp = torch.zeros(h * w * 3, dtype=torch.uint8)
    imp[(4 * w + 5) * 3 + 1] = 255
    assert not convolve.median_filter(imp, 3, h, w).any()
