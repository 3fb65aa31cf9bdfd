"""The port's measurement utilities (``cudavideostream_tpu_torch/utils``:
``shapes``, ``png``, ``timing``, ``profiling``) against the JAX
package's, on the CPU."""

import json
import time

import numpy as np
import pytest
import torch

from cudavideostream_tpu import utils as jax_utils
from cudavideostream_tpu.utils import png as jax_png
from cudavideostream_tpu.utils import profiling as jax_profiling
from cudavideostream_tpu.utils import shapes as jax_shapes
from cudavideostream_tpu.utils import timing as jax_timing
from cudavideostream_tpu_torch import utils
from cudavideostream_tpu_torch.utils import png, profiling, shapes, timing


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 5, 3), (48, 64, 3),
                                   (3, 200, 3)])
def test_write_png_same_bytes_as_jax(shape, tmp_path):
    rgb = np.random.default_rng(sum(shape)).integers(
        0, 255, shape, endpoint=True, dtype=np.uint8)
    png.write_png(str(tmp_path / "port.png"), rgb)
    jax_png.write_png(str(tmp_path / "jax.png"), rgb)
    got = (tmp_path / "port.png").read_bytes()
    assert got == (tmp_path / "jax.png").read_bytes()
    assert got.startswith(b"\x89PNG\r\n\x1a\n")


def test_write_png_takes_any_array_like_as_jax(tmp_path):
    """A list of ints and an int array are written as uint8, as the JAX
    writer does."""
    img = [[[0, 128, 255], [1, 2, 3]]]
    png.write_png(str(tmp_path / "a.png"), img)
    jax_png.write_png(str(tmp_path / "b.png"), np.array(img, np.int64))
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


@pytest.mark.parametrize("shape", [(4, 5), (4, 5, 4), (2, 3, 3, 1), (12,)])
def test_write_png_refuses_a_wrong_shape_as_jax(shape, tmp_path):
    bad = np.zeros(shape, np.uint8)
    with pytest.raises(ValueError, match="expected"):
        png.write_png(str(tmp_path / "p.png"), bad)
    with pytest.raises(ValueError, match="expected"):
        jax_png.write_png(str(tmp_path / "j.png"), bad)


@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (48, 64)])
def test_bgr_frame_to_rgb_equals_jax(hw):
    h, w = hw
    frame = np.random.default_rng(h * w).integers(
        0, 255, h * w * 3, endpoint=True, dtype=np.uint8)
    got = png.bgr_frame_to_rgb(frame, h, w)
    want = jax_png.bgr_frame_to_rgb(frame, h, w)
    assert got.shape == want.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., 0], frame.reshape(h, w, 3)[..., 2])


def test_matsize_equals_jax():
    for h, w in ((1080, 1920), (48, 64), (0, 5)):
        m, j = shapes.MatSize(h, w), jax_shapes.MatSize(h, w)
        assert (m.height, m.width, m.area) == (j.height, j.width, j.area)
        assert m == shapes.MatSize(h, w) and hash(m) == hash(shapes.MatSize(h, w))
    with pytest.raises(AttributeError):
        shapes.MatSize(1, 2).height = 3  # frozen, as the JAX one


def test_utils_exports_what_jax_does():
    assert utils.__all__ == jax_utils.__all__ == ["MatSize", "Timer",
                                                  "bench_op"]
    assert utils.MatSize is shapes.MatSize and utils.Timer is timing.Timer
    assert utils.bench_op is timing.bench_op
    from cudavideostream_tpu_torch.utils import fonts

    assert fonts.CHARS  # the fonts module stays beside them


class _Clock:
    """A fake ``perf_counter``: each read advances by the next step."""

    def __init__(self, steps):
        self.t = 0.0
        self.steps = iter(steps)

    def __call__(self):
        self.t += next(self.steps)
        return self.t


def test_timer_means_equal_jax(monkeypatch):
    steps = [0.0, 0.010, 0.5, 0.030, 0.0, 0.002]
    means = []
    for mod in (timing, jax_timing):
        monkeypatch.setattr(time, "perf_counter", _Clock(list(steps)))
        t = mod.Timer()
        t.start("a")
        assert t.stop("a") == pytest.approx(0.010)
        t.start("a")
        t.stop("a")
        t.start("b")
        t.stop("b")
        means.append((t.mean_ms("a"), t.mean_ms("b"), t.mean_ms("none"),
                      dict(t.counts)))
        t.reset()
        assert t.mean_ms("a") == 0.0 and not t.counts
    assert means[0] == means[1]
    assert means[0][0] == pytest.approx(20.0)
    assert means[0][1] == pytest.approx(2.0)
    assert means[0][3] == {"a": 2, "b": 1}


@pytest.mark.parametrize("k,iters", [(1, 1), (3, 2), (5, 4)])
def test_bench_scan_chain_cpu_calls_and_threads_the_carry(k, iters):
    """On CPU tensors: 2k warm-up calls and k * iters timed ones, each
    call's input the last call's output."""
    seen = []

    def chain(c):
        seen.append(int(c[0]))
        return (c[0] + 1, c[1] * 1)

    ms = timing.bench_scan_chain(chain, (torch.zeros((), dtype=torch.int64),
                                         torch.ones(3)), k=k, iters=iters)
    assert len(seen) == 2 * k + k * iters
    assert seen == list(range(2 * k + k * iters))
    assert ms >= 0.0


def test_bench_scan_chain_refuses_a_carry_without_one_device():
    with pytest.raises(ValueError, match="one device"):
        timing.bench_scan_chain(lambda c: c, (1, 2), k=2, iters=1)
    with pytest.raises(ValueError, match="iters"):
        timing.bench_scan_chain(lambda c: c, torch.zeros(1), k=2, iters=0)


def test_chain_graph_needs_a_cuda_carry():
    """The graph path captures CUDA work only: a CPU carry is refused,
    never run eagerly in its place."""
    with pytest.raises(ValueError, match="CUDA device"):
        timing.ChainGraph(lambda c, i: c, torch.zeros(2), k=2)
    with pytest.raises(ValueError, match="one step"):
        timing.ChainGraph(lambda c, i: c, torch.zeros(2), k=0)


def test_sync_reads_one_element_of_each_leaf(monkeypatch):
    reads = []
    real = torch.Tensor.item

    def item(self):
        reads.append(self.shape)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "item", item)
    timing._sync({"a": torch.zeros(4, 5), "b": [torch.tensor(3),
                                               torch.empty(0), 7]})
    assert reads == [torch.Size([]), torch.Size([])]


def test_bench_op_and_amortized_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    x = torch.arange(10)
    assert timing.bench_op(fn, x, warmup=2, iters=5) >= 0.0
    assert len(calls) == 7
    calls.clear()
    assert timing.bench_op_amortized(fn, x, warmup=2, iters=5) >= 0.0
    assert len(calls) == 2 + 1 + 5
    rtt = timing.measure_rtt(torch.arange(6).reshape(2, 3), samples=3)
    assert 0.0 <= rtt < 1.0


def test_copy_into_refuses_another_structure():
    with pytest.raises(ValueError, match="structure"):
        timing._copy_into((torch.zeros(1),), (torch.zeros(1), torch.zeros(1)))
    a, b = torch.zeros(3), torch.arange(3.0)
    timing._copy_into([a], [b])
    assert torch.equal(a, b)


def test_frame_profiler_summary_equals_jax():
    samples = {"source": [0.001, 0.003, 0.002], "step": [0.0004],
               "land": [], "a_first": [0.25, 0.125]}
    port, jax_p = profiling.FrameProfiler(), jax_profiling.FrameProfiler()
    port.samples = {k: list(v) for k, v in samples.items()}
    jax_p.samples = {k: list(v) for k, v in samples.items()}
    assert port.summary() == jax_p.summary()
    assert port.summary().startswith("a_first: 187.50ms (max 250.00)")


def test_frame_profiler_keeps_its_window():
    p = profiling.FrameProfiler(window=3)
    for _ in range(5):
        with p.stage("x"):
            pass
    assert len(p.samples["x"]) == 3
    with pytest.raises(RuntimeError):
        with p.stage("y"):
            raise RuntimeError("boom")
    assert len(p.samples["y"]) == 1  # the failed stage is timed too


def test_trace_on_the_cpu_holds_an_annotated_span(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir), device="cpu") as d:
        assert d == str(logdir)
        with profiling.annotate("cvs-annotated-span"):
            torch.ones(64).sum()
    trace = json.loads((logdir / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "cvs-annotated-span" in names


def test_trace_runs_on_the_card_unless_asked_for_the_cpu(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        with profiling.trace(str(tmp_path / "t")):
            pass
    assert not (tmp_path / "t").exists()
