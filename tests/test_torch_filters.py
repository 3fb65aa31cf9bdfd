"""The port's filter bank (``ops/filters.py``), K4's plain version
(``ops/hist.py``), the noise filter (``ops/convolve.py``), the NumPy spec's
filter subset and the eight named variants against the JAX package,
byte for byte (zero tolerance), on the same seeded inputs.

Two layouts: 48x64 (``frame_bytes % 384 == 0``, the JAX package's matmul
path) and 48x50 (its pixel-view fallback, ``_layout_ok`` false); the port
has one path for both."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_frame_pair
from cudavideostream_tpu.config import StreamConfig as JaxConfig
from cudavideostream_tpu.config import Visualizer as JaxVisualizer
from cudavideostream_tpu.models import DeltaStreamPipeline as JaxPipeline
from cudavideostream_tpu.models import variants as jax_variants
from cudavideostream_tpu.ops import convolve as jax_convolve
from cudavideostream_tpu.ops import filters as jax_filters
from cudavideostream_tpu.ops import reference_cpu as jax_ref
from cudavideostream_tpu.ops.hist_pallas import pallas_histogram
from cudavideostream_tpu_torch.config import StreamConfig, Visualizer
from cudavideostream_tpu_torch.models import DeltaStreamPipeline
from cudavideostream_tpu_torch.models import variants
from cudavideostream_tpu_torch.models.pipeline import from_jax_pipeline
from cudavideostream_tpu_torch.ops import convolve
from cudavideostream_tpu_torch.ops import filters
from cudavideostream_tpu_torch.ops import hist
from cudavideostream_tpu_torch.ops import reference_cpu
from cudavideostream_tpu_torch.utils import fonts
from torch_kernel_fixtures import no_kernel_build  # noqa: F401

LAYOUTS = {"48x64": (48, 64), "48x50": (48, 50)}
TEXTS = ["12", "13", "", "P5"]


def port_config(jax_cfg) -> StreamConfig:
    """The port's copy of a JAX config; the two packages' enums differ,
    so the visualizer is mapped by value."""
    kw = {f.name: getattr(jax_cfg, f.name)
          for f in dataclasses.fields(StreamConfig)
          if f.name not in ("visualizer", "compaction")}
    return StreamConfig(visualizer=Visualizer(jax_cfg.visualizer.value), **kw)


def _eq(port, jax_out):
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_out).ravel())


@pytest.fixture(params=list(LAYOUTS), ids=list(LAYOUTS))
def frames(request, rng):
    """(prev, cur) of one layout, with the extremes in each channel."""
    h, w = LAYOUTS[request.param]
    prev, cur = make_frame_pair(rng, h * w * 3, change_frac=0.3)
    prev[:3], cur[:3] = 0, 255          # pixel 0: d = 765
    prev[3:6], cur[3:6] = 255, 0        # pixel 1: d = 765 the other way
    prev[6:9], cur[6:9] = (0, 0, 0), (171, 170, 170)  # d = 511, past 510
    return prev, cur


def test_odd_layout_takes_the_jax_fallback(frames):
    """The 48x50 frame is the JAX package's other branch."""
    prev, _ = frames
    assert jax_filters._layout_ok(jnp.asarray(prev)) == (
        prev.size % 384 == 0)


@pytest.mark.parametrize("name", ["grayscale_average", "grayscale_weighted",
                                  "gray_pixels"])
def test_grayscale_matches_jax(frames, name):
    _, cur = frames
    got = getattr(filters, name)(torch.from_numpy(cur))
    assert got.dtype == torch.uint8
    _eq(got, getattr(jax_filters, name)(jnp.asarray(cur)))


def test_grayscale_matches_spec(frames):
    _, cur = frames
    t = torch.from_numpy(cur)
    np.testing.assert_array_equal(filters.grayscale_average(t).numpy(),
                                  reference_cpu.grayscale_average(cur))
    np.testing.assert_array_equal(filters.grayscale_weighted(t).numpy(),
                                  reference_cpu.grayscale_weighted(cur))


def test_histograms_match_jax(frames):
    _, cur = frames
    gv = filters.gray_pixels(torch.from_numpy(cur))
    jgv = jax_filters.gray_pixels(jnp.asarray(cur))
    _eq(filters.value_histogram(gv), jax_filters.value_histogram(jgv))
    gray = reference_cpu.grayscale_weighted(cur)
    _eq(filters.gray_histogram(torch.from_numpy(gray)),
        jax_filters.gray_histogram(jnp.asarray(gray)))
    np.testing.assert_array_equal(
        filters.gray_histogram(torch.from_numpy(gray)).numpy(),
        reference_cpu.gray_histogram(gray))


def test_histogram_reference_matches_pallas_interpret():
    """K4's plain version against the TPU kernel itself (interpret mode)
    and the XLA compare-reduce, on a (64, 128) grid with both extremes."""
    rng = np.random.default_rng(7)
    g = rng.integers(0, 256, size=(64, 128), dtype=np.int64)
    g[0, 0], g[-1, -1] = 0, 255
    jg = jnp.asarray(g, jnp.int32)
    want = np.asarray(pallas_histogram(jg, interpret=True))
    np.testing.assert_array_equal(want, np.asarray(
        jax_filters._value_histogram_xla(jg)))
    got = hist.histogram_reference(torch.from_numpy(g.astype(np.int32)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (256,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper on a CPU uint8 tensor is the plain version
    np.testing.assert_array_equal(
        hist.histogram(torch.from_numpy(g.astype(np.uint8))).numpy(), want)


@pytest.mark.parametrize("n,kind", [(1, "rand"), (77, "rand"),
                                    (4099, "one"), (10_000, "0/255")])
def test_histogram_reference_edge_lengths(n, kind, rng):
    if kind == "rand":
        a = rng.integers(0, 256, n, dtype=np.uint8)
    elif kind == "one":
        a = np.full(n, 137, np.uint8)
    else:
        a = np.where(rng.random(n) < 0.5, 0, 255).astype(np.uint8)
    got = hist.histogram(torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(a, minlength=256))


@pytest.mark.parametrize("bad", ["dtype", "device", "empty"])
def test_histogram_rejects(bad):
    g = torch.zeros(64, dtype=torch.uint8)
    if bad == "dtype":
        g = g.to(torch.int32)
    elif bad == "device":
        g = g.to("meta")
    else:
        g = g[:0]
    with pytest.raises(ValueError):
        hist.histogram(g)


def test_histogram_on_cuda_launches_or_raises(monkeypatch, no_kernel_build):
    """A CUDA tensor never takes the plain version: without a kernel
    build (no nvcc here) the wrapper raises, the plain version is not
    called and no launch is counted; so do the filters that reach it."""
    calls = []
    monkeypatch.setattr(hist, "histogram_reference",
                        lambda g: calls.append(g))
    g = torch.zeros(4096, dtype=torch.uint8)
    frame = torch.zeros(48 * 64 * 3, dtype=torch.uint8)
    before = hist.histogram.launches
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 4096)
    for fn in (lambda: hist.histogram(g),
               lambda: filters.value_histogram(g),
               lambda: filters.binarize_pipeline(frame)):
        with pytest.raises(RuntimeError):
            fn()
    monkeypatch.undo()
    assert not calls and hist.histogram.launches == before


@pytest.mark.parametrize("h", [
    {10: 5, 30: 5},            # tie -> later wins
    {200: 9, 100: 7},
    {0: 100},                  # degenerate single update run
    {255: 1},
    {},                        # all-zero histogram
], ids=["tie", "two", "single", "last", "empty"])
def test_top2_and_threshold_edge_histograms(h):
    """The five edge histograms of the JAX package's tests: the CPU
    scan's tie-break and C truncation, on 0-d tensors."""
    hh = np.zeros(256, np.int64)
    for k, v in h.items():
        hh[k] = v
    imax, isec = filters.top2_prefix_max(torch.from_numpy(hh))
    assert imax.dim() == 0 and isec.dim() == 0
    assert (int(imax), int(isec)) == reference_cpu.top2_scan(hh)
    t = filters.binarize_threshold(torch.from_numpy(hh))
    assert t.dim() == 0
    assert int(t) == reference_cpu.binarize_threshold(hh) == int(
        jax_filters.binarize_threshold(jnp.asarray(hh)))


def test_top2_random_histograms(rng):
    for _ in range(50):
        hh = rng.integers(0, 40, 256)
        got = filters.top2_prefix_max(torch.from_numpy(hh))
        assert tuple(int(x) for x in got) == reference_cpu.top2_scan(hh)


def test_binarize_matches_jax(frames):
    _, cur = frames
    t = torch.from_numpy(cur)
    _eq(filters.binarize_pipeline(t), jax_filters.binarize_pipeline(
        jnp.asarray(cur)))
    np.testing.assert_array_equal(filters.binarize_pipeline(t).numpy(),
                                  reference_cpu.binarize_pipeline(cur))
    gray = filters.grayscale_weighted(t)
    thr = torch.tensor(97, dtype=torch.int32)
    _eq(filters.binarize(gray, thr),
        jax_filters.binarize(jnp.asarray(gray.numpy()), jnp.int32(97)))
    gv = filters.gray_pixels(t)
    _eq(filters.binarize_pixels(gv, thr), jax_filters.binarize_pixels(
        jax_filters.gray_pixels(jnp.asarray(cur)), jnp.int32(97)))


def test_heatmap_matches_jax(frames):
    """The LUT, with pixels at d = 765 and d = 511 (the wrap past 510)."""
    prev, cur = frames
    got = filters.heatmap(torch.from_numpy(cur), torch.from_numpy(prev))
    _eq(got, jax_filters.heatmap(jnp.asarray(cur), jnp.asarray(prev)))
    np.testing.assert_array_equal(got.numpy(),
                                  reference_cpu.heatmap(cur, prev))
    lut = reference_cpu.heatmap_lut()
    np.testing.assert_array_equal(got.numpy()[:6], lut[[765, 765]].ravel())
    np.testing.assert_array_equal(got.numpy()[6:9], lut[511])


@pytest.mark.parametrize("thr", [0, 20])
def test_red_modes_match_jax(frames, thr):
    prev, cur = frames
    mask = np.abs(cur.astype(np.int32) - prev.astype(np.int32)) > thr
    tm = torch.from_numpy(mask)
    np.testing.assert_array_equal(
        filters.changed_pixels(tm).numpy(),
        np.asarray(jax_filters.changed_pixels(jnp.asarray(mask))))
    _eq(filters.red_black(tm), jax_filters.red_black(jnp.asarray(mask)))
    _eq(filters.red_overlap(torch.from_numpy(prev), tm),
        jax_filters.red_overlap(jnp.asarray(prev), jnp.asarray(mask)))
    xs = np.flatnonzero(mask)
    np.testing.assert_array_equal(filters.red_black(tm).numpy(),
                                  reference_cpu.red_black(xs, mask.size))
    np.testing.assert_array_equal(
        filters.red_overlap(torch.from_numpy(prev), tm).numpy(),
        reference_cpu.red_overlap(prev, xs))


@pytest.mark.parametrize("weights", ["g1", "g3", "g5", "g15", "mean3"])
def test_convolve_q16_matches_jax(frames, weights):
    prev, _ = frames
    h, w = (48, 64) if prev.size == 48 * 64 * 3 else (48, 50)
    if weights.startswith("g"):
        wf = reference_cpu.gaussian_kernel(int(weights[1:]))
    else:
        wf = reference_cpu.mean_kernel(3)
    wq = reference_cpu.quantize_kernel_q16(wf)
    np.testing.assert_array_equal(wq, jax_ref.quantize_kernel_q16(wf))
    src = torch.from_numpy(prev)
    got = convolve.convolve_q16(src, wq, h, w)
    assert got.dtype == torch.uint8 and got.numel() == prev.size
    np.testing.assert_array_equal(src.numpy(), prev)  # input not written
    _eq(got, jax_convolve.convolve_q16(jnp.asarray(prev), wq, h, w))
    np.testing.assert_array_equal(got.numpy(),
                                  reference_cpu.convolve(prev, wf, h, w))


def test_spec_copy_matches_jax_spec(frames):
    """The port's NumPy spec is a copy: the same bytes from the same
    inputs, for every filter and the full step_oracle."""
    prev, cur = frames
    h, w = (48, 64) if prev.size == 48 * 64 * 3 else (48, 50)
    for name in ("grayscale_average", "grayscale_weighted",
                 "binarize_pipeline"):
        np.testing.assert_array_equal(getattr(reference_cpu, name)(cur),
                                      getattr(jax_ref, name)(cur))
    np.testing.assert_array_equal(reference_cpu.heatmap(cur, prev),
                                  jax_ref.heatmap(cur, prev))
    wf = reference_cpu.gaussian_kernel(5)
    np.testing.assert_array_equal(wf, jax_ref.gaussian_kernel(5))
    np.testing.assert_array_equal(reference_cpu.convolve(cur, wf, h, w),
                                  jax_ref.convolve(cur, wf, h, w))
    atlas = fonts.make_atlas(4, "stroke")
    for vis in JaxVisualizer:
        jcfg = JaxConfig(height=h, width=w, overlay_scale=4, visualizer=vis,
                         noise_filter=vis.value % 2 == 1)
        got = reference_cpu.step_oracle(prev, cur, port_config(jcfg), atlas,
                                        fonts.encode_text("12"))
        want = jax_ref.step_oracle(prev, cur, jcfg, atlas,
                                   fonts.encode_text("12"))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_variant_registry_is_a_copy():
    assert variants.available() == jax_variants.available()
    assert len(variants.available()) == 8
    for name in variants.available():
        assert variants.get_config(name) == port_config(
            jax_variants.get_config(name))
    assert variants.get_config("binarize", threshold=9).threshold == 9
    with pytest.raises(KeyError):
        variants.get_config("nope")


def _frames(n_bytes, rng, n=4):
    base, _ = make_frame_pair(rng, n_bytes)
    return base, [make_frame_pair(rng, n_bytes)[1] for _ in range(n)]


@pytest.mark.parametrize("name", sorted(jax_variants.available()))
def test_variant_steps_match_jax(name, rng):
    """Each named variant at 48x64 through DeltaStreamPipeline.step and
    the JAX pipeline over 4 frames with changing overlay text: every
    output, the aux frame included, equal."""
    jcfg = jax_variants.get_config(name, height=48, width=64,
                                   overlay_scale=4)
    cfg = variants.get_config(name, height=48, width=64, overlay_scale=4)
    assert cfg == port_config(jcfg)
    jpipe, pipe = JaxPipeline(jcfg), DeltaStreamPipeline(cfg, device="cpu")
    np.testing.assert_array_equal(pipe.conv_weights_q16,
                                  jpipe.conv_weights_q16)
    base, frames = _frames(cfg.frame_bytes, rng)
    jprev, prev = jpipe.init_state(base), pipe.init_state(base)
    for frame, text in zip(frames, TEXTS):
        src = frame.copy()
        jout = jpipe.step(jprev, frame, text=text)
        out = pipe.step(prev, frame, text=text)
        np.testing.assert_array_equal(frame, src)  # the frame is not written
        assert len(out) == len(jout)
        for a, b in zip(out, jout):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if cfg.visualizer != Visualizer.NONE:
            assert out[-1].dtype == torch.uint8
            assert out[-1].numel() == cfg.frame_bytes
        jprev, prev = jout[0], out[0]


def test_1080p_binarize_step_matches_step_oracle():
    """One full-size --visualizer 5 step of the plain path against the
    NumPy spec (no JAX at this size)."""
    cfg = StreamConfig(visualizer=Visualizer.BINARIZE)
    rng = np.random.default_rng(1080)
    prev_np, cur = make_frame_pair(rng, cfg.frame_bytes)
    text = "FPS: 30 BW: 1234 kbps"
    pipe = DeltaStreamPipeline(cfg, device="cpu")
    out = pipe.step(pipe.init_state(prev_np), cur, text=text)
    e_prev, e_pos, e_xs, e_vals, e_aux = reference_cpu.step_oracle(
        prev_np, cur, cfg, atlas=pipe.atlas_np,
        char_ids=fonts.encode_text(text))
    pos = int(out[1])
    assert pos == e_pos > 0
    np.testing.assert_array_equal(out[2][:pos].numpy(), e_xs)
    np.testing.assert_array_equal(out[0].numpy(), e_prev)
    np.testing.assert_array_equal(out[4].numpy(), e_aux)
    assert set(np.unique(e_aux)) == {0, 255}


def test_weight_carry_with_mean_kernel(rng):
    """A mid-stream handover from a JAX pipeline built with a mean
    kernel: the port takes its exact Q16 taps with its state and goes on
    in lockstep (noise filter and heatmap)."""
    jcfg = JaxConfig(height=48, width=64, overlay_scale=4, noise_filter=True,
                     visualizer=JaxVisualizer.HEATMAP)
    jpipe = JaxPipeline(jcfg, conv_weights=jax_ref.mean_kernel(3))
    base, frames = _frames(jcfg.frame_bytes, rng)
    jprev = jpipe.init_state(base)
    for frame, text in zip(frames[:2], TEXTS[:2]):
        jprev = jpipe.step(jprev, frame, text=text)[0]
    pipe, prev = from_jax_pipeline(port_config(jcfg), np.asarray(jprev),
                                   jpipe.atlas_np, jpipe.conv_weights_q16,
                                   device="cpu")
    # the default taps would differ: the carry is what makes them equal
    assert not np.array_equal(
        DeltaStreamPipeline(port_config(jcfg), device="cpu").conv_weights_q16,
        jpipe.conv_weights_q16)
    for frame, text in zip(frames[2:], TEXTS[2:]):
        jout = jpipe.step(jprev, frame, text=text)
        out = pipe.step(prev, frame, text=text)
        for a, b in zip(out, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jprev, prev = jout[0], out[0]
    # the float mean taps, quantized by the port, are the same taps
    np.testing.assert_array_equal(
        DeltaStreamPipeline(port_config(jcfg), device="cpu",
                            conv_weights=reference_cpu.mean_kernel(3)
                            ).conv_weights_q16, jpipe.conv_weights_q16)


def test_conv_weights_must_be_square():
    with pytest.raises(ValueError, match="square"):
        DeltaStreamPipeline(StreamConfig(height=48, width=64,
                                         noise_filter=True), device="cpu",
                            conv_weights=np.ones((3, 2)))
