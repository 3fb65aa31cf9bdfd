"""The port's batched (multi-stream) slice against the JAX package:
``fused_diff_compact_batched`` (K1's and K5's super-frame mode, JAX side in
interpret mode) and ``BatchedDeltaPipeline``. Tolerance is zero: every
output is compared byte for byte, full length, dtypes and shapes included.

On CPU tensors the port's wrappers run the kernels' plain PyTorch
versions; the CUDA kernels are held against those on the card by
``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_frame_pair
from cudavideostream_tpu.config import Visualizer as JaxVisualizer
from cudavideostream_tpu.models.batched import (
    BatchedDeltaPipeline as JaxBatched,
)
from cudavideostream_tpu.ops import logcompact as jax_logcompact
from cudavideostream_tpu_torch.config import StreamConfig, Visualizer
from cudavideostream_tpu_torch.models import (
    BatchedDeltaPipeline,
    DeltaStreamPipeline,
    from_jax_batched,
)
from cudavideostream_tpu_torch.ops import logcompact

# the JAX package's batched geometries (tests/test_device_ops.py:676-684):
# one and three whole-tile streams, and three that pad every stream
GEOMETRIES = {"1x9216": (1, 9216), "3x9216": (3, 9216),
              "2x9233": (2, 9216 + 17), "2x128x401": (2, 128 * 401),
              "4x1000": (4, 1000)}


def _streams(b, n, seed, change_frac=1 / 7):
    rng = np.random.default_rng([seed, b, n])
    prev = rng.integers(0, 256, (b, n), dtype=np.uint8)
    cur = prev.copy()
    for s in range(b):
        idx = rng.choice(n, size=int(n * change_frac), replace=False)
        cur[s, idx] = rng.integers(0, 256, idx.size, dtype=np.uint8)
    tm = rng.integers(0, 60, n, endpoint=True, dtype=np.uint8)
    tm[rng.random(n) < 0.02] = 255
    return prev.reshape(-1), cur.reshape(-1), tm


def _port(prev, cur, b, scheme, sub, tm, region=None):
    prev_t = torch.from_numpy(prev.copy())
    out = logcompact.fused_diff_compact_batched(
        torch.from_numpy(cur), prev_t, b, scheme=scheme, sub_rows=sub,
        threshold_map=None if tm is None else torch.from_numpy(tm),
        overlay_region=None if region is None else torch.from_numpy(region))
    assert out[-1] is prev_t  # updated in place
    return [t.numpy() for t in out]


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        np.testing.assert_array_equal(a, b)


def _assert_solo(got, prev, cur, b, scheme, sub, tm, region=None):
    """Each stream equals a solo tiled call of the port on its frame."""
    n = cur.size // b
    strip = 0 if region is None else region.size // b
    for s in range(b):
        solo = logcompact.fused_diff_compact_tiled(
            torch.from_numpy(cur[s * n:(s + 1) * n].copy()),
            torch.from_numpy(prev[s * n:(s + 1) * n].copy()),
            overlay_region=(None if region is None else torch.from_numpy(
                region[s * strip:(s + 1) * strip].copy())),
            sub_rows=sub, scheme=scheme,
            threshold_map=None if tm is None else torch.from_numpy(tm))
        _assert_same([got[0][s], got[1][s], got[2][s], got[3][s],
                      got[4][s * n:(s + 1) * n]], [t.numpy() for t in solo])


CASES = ([("element", sub, m) for sub in (0, 1, 8) for m in (False, True)]
         + [("segment", 1, False)])


@pytest.mark.parametrize("scheme,sub,use_map", CASES,
                         ids=[f"{s}-sub{r}-{'map' if m else 'nomap'}"
                              for s, r, m in CASES])
@pytest.mark.parametrize("geom", list(GEOMETRIES), ids=list(GEOMETRIES))
def test_batched_matches_jax_and_solo(geom, scheme, sub, use_map):
    """Every output of the port's batched call equals the JAX function's
    (interpret mode), and each stream equals a solo tiled call: indices
    rebased per stream, counts narrowed as ``_narrow_counts``, zero fill,
    and no stream's bytes in its neighbour's padding. The segment scheme
    takes whole tiles whatever ``sub_rows`` says."""
    b, n = GEOMETRIES[geom]
    prev, cur, tm = _streams(b, n, 1)
    tm = tm if use_map else None
    got = _port(prev, cur, b, scheme, sub, tm)
    want = jax_logcompact.fused_diff_compact_batched(
        jnp.asarray(cur), jnp.asarray(prev), n_streams=b, interpret=True,
        scheme=scheme, sub_rows=sub,
        threshold_map=None if tm is None else jnp.asarray(tm))
    _assert_same(got, want)
    assert got[0].sum() > 0
    _assert_solo(got, prev, cur, b, scheme, sub, tm)


@pytest.mark.parametrize("geom", ["3x9216", "2x9233"])
def test_segment_with_a_map_matches_jax(geom):
    b, n = GEOMETRIES[geom]
    prev, cur, tm = _streams(b, n, 2)
    got = _port(prev, cur, b, "segment", 0, tm)
    _assert_same(got, jax_logcompact.fused_diff_compact_batched(
        jnp.asarray(cur), jnp.asarray(prev), n_streams=b, interpret=True,
        scheme="segment", threshold_map=jnp.asarray(tm)))
    _assert_same(got, _port(prev, cur, b, "element", 0, tm))


@pytest.mark.parametrize("scheme", ["element", "segment"])
@pytest.mark.parametrize("geom", ["3x9216", "4x1000"])
def test_per_stream_overlay_region(geom, scheme):
    """The port's per-stream region (the JAX function has none): strip b
    replaces stream b's first bytes, as a solo call with that region
    does."""
    b, n = GEOMETRIES[geom]
    prev, cur, tm = _streams(b, n, 3)
    rng = np.random.default_rng(4)
    region = rng.integers(0, 256, b * 700, dtype=np.uint8)
    got = _port(prev, cur, b, scheme, 1, tm, region)
    _assert_solo(got, prev, cur, b, scheme, 1, tm, region)
    # and it is the same as substituting the strips into the frames
    sub = cur.copy().reshape(b, n)
    sub[:, :700] = region.reshape(b, 700)
    _assert_same(got, _port(prev, sub.reshape(-1), b, scheme, 1, tm))


@pytest.mark.parametrize("kwargs,match", [
    (dict(current=np.zeros((2, 9216), np.uint8)), "flat"),
    (dict(n_streams=5), "flat"),
    (dict(scheme="register"), "batching"),
    (dict(threshold_map=np.zeros(100, np.uint8)), "threshold_map length"),
    (dict(n_streams=0), "at least one stream"),
], ids=["not_flat", "not_divisible", "register", "map_length", "no_streams"])
def test_batched_refusals(kwargs, match):
    """The JAX package's refusals: a non-flat input, the register scheme
    (K6 does not batch) and a map of the wrong length."""
    args = dict(current=np.zeros(2 * 9216, np.uint8),
                previous=np.zeros(2 * 9216, np.uint8), n_streams=2)
    args.update(kwargs)
    if args["current"].ndim == 2:
        args["previous"] = np.zeros_like(args["current"])
    tensors = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in args.items()}
    for fn in (logcompact.fused_diff_compact_batched,
               logcompact.fused_diff_compact_batched_reference):
        with pytest.raises(ValueError, match=match):
            fn(**tensors)


def test_batched_geometry_cutoff():
    """JAX's sub_rows cutoff (``logcompact.py:1040-1043``): whole tiles for
    the segment scheme and when sub_rows does not divide the tile."""
    n = 48 * 64 * 3  # one 72-row tile
    assert logcompact.batched_geometry(n, "element", 1) == (9216, 128)
    assert logcompact.batched_geometry(n, "element", 16) == (9216, 9216)
    assert logcompact.batched_geometry(n, "segment", 1) == (9216, 9216)


# -- BatchedDeltaPipeline ---------------------------------------------------

def port_config(jax_cfg) -> StreamConfig:
    kw = {f.name: getattr(jax_cfg, f.name)
          for f in dataclasses.fields(StreamConfig)
          if f.name not in ("visualizer", "compaction")}
    return StreamConfig(visualizer=Visualizer(jax_cfg.visualizer.value), **kw)


TEXTS = [["ab", "", "x1"], ["ab", "zz", "12"], ["", "", ""]]
PIPES = {f"vis{v}": dict(visualizer=v) for v in range(6)}
PIPES.update({"noise_filter": dict(noise_filter=True, visualizer=1),
              "map_red_overlap": dict(visualizer=3, map=True),
              "map": dict(map=True), "sub8": dict(subtile_rows=8),
              "sub0": dict(subtile_rows=0)})


def _jax_and_port(small_config, tiled, visualizer=0, map=False, **kw):
    jcfg = dataclasses.replace(
        small_config, tiled_payload=tiled,
        payload_capacity=None if tiled else 3000,
        visualizer=JaxVisualizer(visualizer), **kw)
    tm = None
    if map:
        tm = np.random.default_rng(5).integers(0, 40, jcfg.frame_bytes,
                                               dtype=np.uint8)
    b = len(TEXTS[0])
    return (JaxBatched(jcfg, b, threshold_map=tm),
            BatchedDeltaPipeline(port_config(jcfg), b, device="cpu",
                                 threshold_map=tm), jcfg)


@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "flat"])
@pytest.mark.parametrize("name", list(PIPES), ids=list(PIPES))
def test_batched_pipeline_matches_jax(small_config, tiled, name):
    """B = 3 streams, three frames with per-stream texts (one repeated,
    then none): every output equals the JAX pipeline's — the fast path
    (one batched launch) and the flat ``capacity`` path (the solo step per
    stream), each visualizer, the noise filter and a shared map."""
    jpipe, pipe, jcfg = _jax_and_port(small_config, tiled, **PIPES[name])
    assert pipe._fast == jpipe._fast == tiled
    rng = np.random.default_rng(6)
    b, n = pipe.n_streams, jcfg.frame_bytes
    bases = rng.integers(0, 256, (b, n), dtype=np.uint8)
    jprev, prev = jpipe.init_state(bases), pipe.init_state(bases)
    for texts in TEXTS:
        frames = np.stack([make_frame_pair(rng, n, 0.05)[1]
                           for _ in range(b)])
        jout = jpipe.step(jprev, frames, texts)
        out = pipe.step(prev, frames, texts)
        assert out[0] is prev  # the state, updated in place
        _assert_same([t for t in out if t is not None],
                     [t for t in jout if t is not None])
        assert (out[-1] is None) == (jout[-1] is None)
        jprev, prev = jout[0], out[0]


def test_batched_pipeline_equals_solo(small_config):
    """Stream b of the batched step is the solo pipeline's step on stream
    b's inputs, the aux frame included (binarize: one histogram per
    stream)."""
    cfg = port_config(dataclasses.replace(
        small_config, tiled_payload=True,
        visualizer=JaxVisualizer.BINARIZE))
    b, n = 3, cfg.frame_bytes
    pipe = BatchedDeltaPipeline(cfg, b, device="cpu")
    solo = DeltaStreamPipeline(cfg, device="cpu")
    rng = np.random.default_rng(7)
    bases = rng.integers(0, 256, (b, n), dtype=np.uint8)
    frames = rng.integers(0, 256, (b, n), dtype=np.uint8)
    out = pipe.step(pipe.init_state(bases), frames, ["a", "b", "c"])
    for s, text in enumerate("abc"):
        one = solo.step(solo.init_state(bases[s]), frames[s], text=text)
        _assert_same([out[0][s * n:(s + 1) * n], out[1][s], out[2][s],
                      out[3][s], out[4][s], out[5][s * n:(s + 1) * n]],
                     [t.numpy() for t in one])


def test_from_jax_batched_carries_the_state(small_config):
    """A mid-stream handover from the JAX batched pipeline (noise filter,
    heatmap, a map): the port takes its flat state, atlas, taps and map
    and goes on in lockstep."""
    jpipe, _, jcfg = _jax_and_port(small_config, True, visualizer=1,
                                   map=True, noise_filter=True)
    rng = np.random.default_rng(8)
    b, n = jpipe.n_streams, jcfg.frame_bytes
    jprev = jpipe.init_state(rng.integers(0, 256, (b, n), dtype=np.uint8))
    for texts in TEXTS[:2]:
        frames = rng.integers(0, 256, (b, n), dtype=np.uint8)
        jprev = jpipe.step(jprev, frames, texts)[0]
    pipe, prev = from_jax_batched(
        port_config(jcfg), b, np.asarray(jprev), jpipe.atlas_np,
        jpipe._solo.conv_weights_q16, jpipe._solo.threshold_map_np,
        device="cpu")
    np.testing.assert_array_equal(prev.numpy(), np.asarray(jprev))
    for texts in TEXTS:
        frames = rng.integers(0, 256, (b, n), dtype=np.uint8)
        jout = jpipe.step(jprev, frames, texts)
        out = pipe.step(prev, frames, texts)
        _assert_same([t for t in out if t is not None],
                     [t for t in jout if t is not None])
        jprev, prev = jout[0], out[0]
    with pytest.raises(ValueError, match="state size"):
        from_jax_batched(port_config(jcfg), b + 1, np.asarray(jprev),
                         device="cpu")


def test_batched_pipeline_refusals(small_config):
    cfg = port_config(dataclasses.replace(small_config, tiled_payload=True))
    with pytest.raises(ValueError, match="at least one stream"):
        BatchedDeltaPipeline(cfg, 0, device="cpu")
    pipe = BatchedDeltaPipeline(cfg, 2, device="cpu")
    prev = pipe.init_state(np.zeros((2, cfg.frame_bytes), np.uint8))
    frames = np.zeros((2, cfg.frame_bytes), np.uint8)
    with pytest.raises(ValueError, match="texts"):
        pipe.step(prev, frames, ["a"])
    with pytest.raises(ValueError, match="frames size"):
        pipe.step(prev, frames[:1], ["a", "b"])
    with pytest.raises(ValueError, match="base frame size"):
        pipe.init_state(np.zeros((2, 7), np.uint8))
    with pytest.raises(NotImplementedError, match="ROADMAP.md M12"):
        BatchedDeltaPipeline(dataclasses.replace(
            cfg, tiled_payload=False,
            compaction=type(cfg.compaction)("sort")), 2, device="cpu")
