"""The port's sharded slice against the JAX package, on the CPU: K1's
``index_offset`` mode (the JAX side in interpret mode), the halo exchange
and the row-sharded convolution, and ``ShardedDeltaPipeline.step_flat``
(the ``server --mesh`` step) on ``(1, S)`` meshes, S = 1, 2, 4 and 8, in
both payload layouts. The JAX side runs on ``tests/conftest.py``'s eight
virtual CPU devices; the port's shards are all on the CPU.

Tolerance is zero: every output is compared byte for byte, full length,
dtypes and shapes included, and against ``step_oracle``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import make_frame_pair
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.config import Visualizer as JaxVisualizer
from cudavideostream_tpu.ops import logcompact as jax_logcompact
from cudavideostream_tpu.parallel import ShardedDeltaPipeline as JaxSharded
from cudavideostream_tpu.parallel import halo_conv as jax_halo
from cudavideostream_tpu.parallel import make_mesh as jax_make_mesh
from cudavideostream_tpu_torch.config import StreamConfig, Visualizer
from cudavideostream_tpu_torch.models import from_jax_sharded
from cudavideostream_tpu_torch.ops import convolve as conv_ops
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.parallel import (
    ShardedDeltaPipeline,
    halo_conv,
    make_mesh,
)
from cudavideostream_tpu_torch.parallel.sharded import gather
from cudavideostream_tpu_torch.utils import fonts

H, W = 48, 64


def jax_config(cfg) -> JaxConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JaxConfig)
          if f.name not in ("visualizer", "compaction")}
    return JaxConfig(visualizer=JaxVisualizer(cfg.visualizer.value), **kw)


def _assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


# -- K1 index_offset -----------------------------------------------------------

# one shard of a 48x64 frame cut in two: 4,608 bytes, padded to 5,120
LN = H * W * 3 // 2
N_PAD = logcompact.tiled_geometry(LN, 0)[0]
EMITS = [("flat", 0), ("tiled", 1), ("tiled", 8), ("tiled", 0)]
OFFSETS = {"0": 0, "Ln": LN, "large": (1 << 31) - N_PAD - 1}


def _k1_inputs(extras, seed=7):
    rng = np.random.default_rng(seed)
    prev, cur = make_frame_pair(rng, LN, change_frac=0.1)
    tm = region = None
    if extras:
        tm = rng.integers(0, 40, LN, endpoint=True, dtype=np.uint8)
        region = rng.integers(0, 256, 700, dtype=np.uint8)
    return prev, cur, tm, region


def _port_k1(emit, sub, prev, cur, tm, region, off):
    t = lambda a: None if a is None else torch.from_numpy(a.copy())
    kw = dict(threshold_map=t(tm), overlay_region=t(region), index_offset=off)
    prev_t = t(prev)
    if emit == "flat":
        out = logcompact.fused_diff_compact(t(cur), prev_t, **kw)
    else:
        out = logcompact.fused_diff_compact_tiled(t(cur), prev_t,
                                                  sub_rows=sub, **kw)
    assert out[-1] is prev_t  # new_prev, in place
    return [o.numpy() for o in out]


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "map-region"])
@pytest.mark.parametrize("offset", list(OFFSETS))
@pytest.mark.parametrize("emit,sub", EMITS,
                         ids=[f"{e}{s}" for e, s in EMITS])
def test_index_offset_matches_jax(emit, sub, offset, extras):
    """K1's plain version with ``index_offset`` equals JAX
    ``fused_diff_compact(index_offset=, interpret=True)``, every output,
    and equals the offset-free call with the offset added to the valid
    entries only (the zero fill stays 0)."""
    off = OFFSETS[offset]
    prev, cur, tm, region = _k1_inputs(extras)
    got = _port_k1(emit, sub, prev, cur, tm, region, off)
    want = jax_logcompact.fused_diff_compact(
        cur, prev, interpret=True, emit=emit, sub_rows=sub,
        threshold_map=tm, overlay_region=region,
        index_offset=np.int32(off))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same(g, w)
    base = _port_k1(emit, sub, prev, cur, tm, region, 0)
    xs_i = 1 if emit == "flat" else 2
    valid = (got[xs_i + 1] != 0)
    _assert_same(got[xs_i], np.where(valid, base[xs_i] + off, 0)
                 .astype(np.int32))
    assert valid.sum() == int(got[0]) > 0


def test_index_offset_refusals():
    """``index_offset`` is element scheme only, as in the JAX package (whose
    register branch returns before that check and drops the offset: the
    port refuses it there too, rather than emit shard-local indices), and
    the port refuses an offset that would carry an index past int32 (where
    the JAX package would wrap) or below 0."""
    prev, cur, _, _ = _k1_inputs(False)
    c, p = torch.from_numpy(cur), torch.from_numpy(prev.copy())
    with pytest.raises(ValueError, match="element scheme only"):
        jax_logcompact.fused_diff_compact(
            cur, prev, interpret=True, scheme="segment", emit="tiled",
            index_offset=np.int32(LN))
    for scheme in ("segment", "register"):
        for fn in (logcompact.fused_diff_compact,
                   logcompact.fused_diff_compact_tiled):
            with pytest.raises(ValueError, match="element scheme only"):
                fn(c, p, scheme=scheme, index_offset=LN)
    for fn in (logcompact.fused_diff_compact,
               logcompact.fused_diff_compact_tiled,
               logcompact.fused_diff_compact_reference,
               logcompact.fused_diff_compact_tiled_reference):
        with pytest.raises(ValueError, match="exceed int32"):
            fn(c, p, index_offset=(1 << 31) - N_PAD)
        with pytest.raises(ValueError, match=">= 0"):
            fn(c, p, index_offset=-1)
    np.testing.assert_array_equal(p.numpy(), prev)  # refused before work


# -- the halo exchange and the row-sharded convolution ---------------------------

def _jax_shard_map(fn, x, s):
    mesh = jax_make_mesh(s)
    f = jax.shard_map(fn, mesh=mesh, in_specs=P("space"),
                      out_specs=P("space"), check_vma=False)
    return np.asarray(jax.jit(f)(x))


@pytest.mark.parametrize("conv_k", [1, 3, 5])
@pytest.mark.parametrize("s", [2, 4, 8])
def test_halo_exchange_matches_jax(s, conv_k):
    """Each shard's rows with ``conv_k // 2`` rows of each neighbour, zeros
    at the frame's edges, as JAX ``halo_exchange_rows`` under
    ``shard_map`` gives them (no exchange at ``conv_k=1``)."""
    pad = conv_k // 2
    rng = np.random.default_rng([s, conv_k])
    rows = H // s
    img = rng.integers(-9, 300, (H, W * 3)).astype(np.int32)
    want = _jax_shard_map(
        lambda x: jax_halo.halo_exchange_rows(x, pad, "space"), img, s)
    got = halo_conv.halo_exchange_rows(
        [torch.from_numpy(img[i * rows:(i + 1) * rows]) for i in range(s)],
        pad)
    _assert_same(gather(got), want)
    assert gather(got).shape == (s * (rows + 2 * pad), W * 3)


@pytest.mark.parametrize("conv_k", [1, 3, 5])
def test_sharded_convolve_matches_jax(conv_k):
    """The row-sharded Q16 convolution at S = 8 equals JAX
    ``sharded_convolve_q16`` under ``shard_map`` and the port's solo
    ``convolve_q16`` of the whole frame."""
    s, rows = 8, H // 8
    wq = ref.quantize_kernel_q16(ref.gaussian_kernel(conv_k))
    frame = np.random.default_rng(conv_k).integers(
        0, 256, H * W * 3, dtype=np.uint8)
    want = _jax_shard_map(
        lambda x: jax_halo.sharded_convolve_q16(x, wq, rows, W, "space"),
        frame, s)
    ln = rows * W * 3
    got = halo_conv.sharded_convolve_q16(
        [torch.from_numpy(frame[i * ln:(i + 1) * ln].copy())
         for i in range(s)], wq, rows, W)
    _assert_same(gather(got), want)
    _assert_same(gather(got), conv_ops.convolve_q16(
        torch.from_numpy(frame), wq, H, W).numpy())


def test_halo_deeper_than_a_shard_refused():
    """A halo deeper than one shard's rows needs rows from two shards
    away: refused by the exchange, and by both pipelines at construction
    (48 rows over 8 shards hold 6 each; K = 15 needs 7)."""
    with pytest.raises(ValueError, match="halo"):
        halo_conv.halo_exchange_rows([torch.zeros((6, 3), dtype=torch.int32)]
                                     * 8, 7)
    cfg = StreamConfig(height=H, width=W, overlay_scale=1, noise_filter=True,
                       conv_k=15)
    with pytest.raises(ValueError, match="halo"):
        JaxSharded(jax_config(cfg), jax_make_mesh(8))
    with pytest.raises(ValueError, match="halo"):
        ShardedDeltaPipeline(cfg, make_mesh(8, device="cpu"))
    ShardedDeltaPipeline(cfg, make_mesh(4, device="cpu"))  # 12 rows: fits


# -- step_flat: the server --mesh step --------------------------------------------

# the JAX package's matrix (tests/test_parallel.py:476-530)
MATRIX = [(Visualizer.NONE, True, False), (Visualizer.HEATMAP, True, True),
          (Visualizer.GRAYSCALE, False, True),
          (Visualizer.BINARIZE, False, True),
          (Visualizer.RED_BLACK, False, False),
          (Visualizer.RED_OVERLAP, False, True)]
MESHES = [(s, layout) for s in (1, 2, 4, 8)
          for layout in ("sharded", "replicated")]
# texts of every length up to the 28 a 64-pixel frame cuts to 10 cells;
# the 10-row glyph band spans shards 0 and 1 at S = 8 (6 rows each)
TEXTS = ["FPS: 7", "", "BW: 123456 kbps 0123456789", "FPS: 7"]


def _run_step_flat(cfg, s, layout, threshold_map=None, n_frames=3):
    """The port (carried over from the JAX pipeline by
    ``from_jax_sharded``) and the JAX pipeline on the same frames, every
    output compared, and both against step_oracle."""
    jpipe = JaxSharded(jax_config(cfg), jax_make_mesh(s),
                       payload_layout=layout, threshold_map=threshold_map)
    rng = np.random.default_rng([s, cfg.visualizer.value])
    base = rng.integers(0, 256, cfg.frame_bytes, dtype=np.uint8)
    jst = jpipe.init_state_flat(base)
    pipe, st = from_jax_sharded(cfg, make_mesh(s, device="cpu"),
                                np.asarray(jst),
                                conv_weights_q16=jpipe.conv_q16,
                                threshold_map=jpipe.threshold_map_np,
                                payload_layout=layout)
    assert pipe.local_bytes == jpipe.local_bytes
    prev_ref = base.copy()
    for k in range(n_frames):
        frame = make_frame_pair(rng, cfg.frame_bytes)[1]
        text = TEXTS[k % len(TEXTS)]
        out = jpipe.step_flat(jst, frame, text=text)
        jst = out[0]  # the old state was donated
        want = [np.asarray(o) for o in out]
        st, *got = pipe.step_flat(st, frame, text=text)
        _assert_same(gather(st), want[0])
        for g, w in zip(got[:3], want[1:4]):
            _assert_same(gather(g), w)
        if got[3] is None:
            assert not want[4].any()
        else:
            _assert_same(gather(got[3]), want[4])
        exp = ref.step_oracle(prev_ref, frame, cfg, atlas=pipe.atlas_np,
                              char_ids=fonts.encode_text(text),
                              threshold_map=threshold_map)
        _assert_same(gather(st), exp[0])
        if layout == "sharded":
            counts = gather(got[0]).astype(np.int64)
            slots = np.concatenate([u * got[1][0].shape[1] + np.arange(c)
                                    for u, c in enumerate(counts)])
            xs, vals = (gather(got[1]).reshape(-1)[slots],
                        gather(got[2]).reshape(-1)[slots])
        else:
            pos = int(got[0])
            xs, vals = got[1][:pos].numpy(), got[2][:pos].numpy()
        _assert_same(xs, exp[2])
        _assert_same(vals, exp[3])
        if exp[4] is not None:
            _assert_same(gather(got[3]), exp[4])
        prev_ref = exp[0]
    return pipe


@pytest.mark.parametrize("viz,noise,negfeed", MATRIX,
                         ids=[f"{v.name.lower()}-{n}-{f}"
                              for v, n, f in MATRIX])
@pytest.mark.parametrize("s,layout", MESHES,
                         ids=[f"S{s}-{lay}" for s, lay in MESHES])
def test_step_flat_matches_jax_and_oracle(s, layout, viz, noise, negfeed):
    """``step_flat`` over S row shards, each launching K1 with its shard
    base as ``index_offset``: the state, the payload (per-shard tiled
    blocks, or the assembled flat payload) and the aux frame equal the JAX
    sharded pipeline's and step_oracle's, over overlay texts that span
    shards."""
    cfg = StreamConfig(height=H, width=W, overlay_scale=1, visualizer=viz,
                       noise_filter=noise, negative_feedback=negfeed)
    _run_step_flat(cfg, s, layout)


@pytest.mark.parametrize("s,layout", MESHES,
                         ids=[f"S{s}-{lay}" for s, lay in MESHES])
def test_step_flat_threshold_map(s, layout):
    """A per-byte map cut along rows like the frame, with the red-overlap
    visualizer (whose mask reads the map): equal to JAX and to
    step_oracle(threshold_map=)."""
    cfg = StreamConfig(height=H, width=W, overlay_scale=1,
                       visualizer=Visualizer.RED_OVERLAP)
    rng = np.random.default_rng(s)
    tm = rng.integers(0, 60, cfg.frame_bytes, endpoint=True, dtype=np.uint8)
    tm[: cfg.frame_bytes // 3] = 2
    pipe = _run_step_flat(cfg, s, layout, threshold_map=tm)
    _assert_same(pipe.threshold_map_np, tm)
