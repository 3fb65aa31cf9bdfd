"""The port's stage spans (``utils/profiling.py``: ``annotate``,
``STAGES``, ``trace_stages``, ``attribute``) in the steps of
``models/pipeline.py`` and ``models/batched.py``, on the CPU at
``small_config``'s geometry: the spans' order and nesting, every ATen op
inside a stage, the same outputs with and without a profiler, no
``record_function`` while none records, and the rule that puts a device
record down to a stage."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cudavideostream_tpu_torch.config import (
    CompactionBackend,
    StreamConfig,
    Visualizer,
)
from cudavideostream_tpu_torch.models import (
    BatchedDeltaPipeline,
    DeltaStreamPipeline,
)
from cudavideostream_tpu_torch.utils import profiling
from cudavideostream_tpu_torch.utils.profiling import OUTSIDE, STAGES, STEP

TEXT = "FPS: 30"
TILED = dict(tiled_payload=True)
# name: (StreamConfig keywords, streams or None for the solo pipeline,
#        the spans one step opens, in order)
SOLO = [STEP, "cvs.upload", "cvs.overlay", "cvs.compact"]
VIS = [STEP, "cvs.upload", "cvs.overlay", "cvs.visualizer", "cvs.compact"]
CASES = {
    "tiled": (TILED, None, SOLO),
    "flat": ({}, None, SOLO),
    "maskonly": (dict(TILED, emit_bitmask=True, fetch_mode="mask",
                      maskonly_payload=True), None, SOLO),
    "denoise": (dict(TILED, noise_filter=True), None,
                [STEP, "cvs.upload", "cvs.filter", "cvs.overlay",
                 "cvs.compact"]),
    **{f"vis{v}": (dict(TILED, visualizer=Visualizer(v)), None, VIS)
       for v in range(1, 6)},
    "sort": (dict(compaction=CompactionBackend.SORT), None, SOLO),
    "host": (dict(compaction=CompactionBackend.HOST), None,
             SOLO + ["cvs.host_pack"]),
    "batched_fast": (TILED, 2, SOLO),
    # the flat payload runs the solo step per stream, nested in the
    # batched one
    "batched_per_stream": ({}, 2, [STEP, "cvs.upload", "cvs.upload",
                                   *SOLO, *SOLO, "cvs.compact"]),
}


def _config(small_config, kw):
    return StreamConfig(height=small_config.height, width=small_config.width,
                        overlay_scale=small_config.overlay_scale, **kw)


def _setup(small_config, name, seed=7):
    """A pipeline of case ``name`` with its state, and a step callable
    over one frame (or B frames) of that seed."""
    kw, streams, _ = CASES[name]
    cfg = _config(small_config, kw)
    rng = np.random.default_rng(seed)
    n = cfg.frame_bytes
    b = streams or 1
    base = rng.integers(0, 256, (b, n), dtype=np.uint8)
    noise = rng.integers(-40, 41, (b, n))
    frames = ((base.astype(np.int16) + noise) % 256).astype(np.uint8)
    if streams is None:
        pipe = DeltaStreamPipeline(cfg, device="cpu")
        state = pipe.init_state(base[0])
        return pipe, lambda: pipe.step(state, frames[0], text=TEXT)
    pipe = BatchedDeltaPipeline(cfg, streams, device="cpu")
    state = pipe.init_state(base)
    return pipe, lambda: pipe.step(state, frames, [TEXT] * streams)


def _host(outs):
    return [None if o is None else np.asarray(
        o.numpy() if isinstance(o, torch.Tensor) else o) for o in outs]


def _stage_of(event):
    e = event.cpu_parent
    while e is not None:
        if e.name in STAGES:
            return e.name
        e = e.cpu_parent
    return None


@pytest.mark.parametrize("name", list(CASES))
def test_step_spans_in_order_and_every_op_in_a_stage(small_config, name):
    pipe, step = _setup(small_config, name)
    step()  # the first step caches the overlay's glyph indices
    records, spans = profiling.trace_stages(step, "cpu")
    assert records == []  # no device on the CPU
    names = [s[0] for s in spans]
    assert names == CASES[name][2]
    assert set(names) <= set(STAGES) | {STEP}
    outer = spans[0]
    assert outer[3] == {"seq": 2, "streams": CASES[name][1] or 1}
    assert pipe.steps == 2
    assert all(outer[1] <= s[1] <= s[2] <= outer[2] for s in spans[1:])
    inner = [s for s in spans[1:] if s[0] == STEP]
    assert [s[3]["streams"] for s in inner] == [1] * len(inner)
    # every ATen op of the step lies inside a stage span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    assert ops
    assert [e.name for e in ops if _stage_of(e) is None] == []


@pytest.mark.parametrize("name", list(CASES))
def test_outputs_equal_with_and_without_a_profiler(small_config, name):
    _, plain = _setup(small_config, name)
    _, traced = _setup(small_config, name)
    for _ in range(2):
        want = _host(plain())
        got = []
        profiling.trace_stages(lambda: got.extend(traced()), "cpu")
        got = _host(got)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("name", ["tiled", "denoise", "vis5", "host",
                                  "batched_fast", "batched_per_stream"])
def test_no_record_function_while_no_profiler_records(small_config, name,
                                                      monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _, step = _setup(small_config, name)
    step()
    step()
    assert profiling.annotate("cvs.overlay") is profiling.annotate(STEP)


def test_annotate_records_its_span_and_args_while_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("cvs.compact", {"seq": 3}):
            torch.ones(8).sum()
    spans = [e for e in prof.events() if e.name == "cvs.compact"]
    assert len(spans) == 1
    assert [c.name for c in spans[0].cpu_children] == ["aten::ones",
                                                        "aten::sum"]


def test_trace_stages_keeps_span_args_in_start_order():
    def run():
        for k in range(3):
            with profiling.annotate(STEP, {"seq": k, "streams": 1}):
                with profiling.annotate("cvs.upload"):
                    torch.zeros(4)

    records, spans = profiling.trace_stages(run, "cpu")
    assert records == []
    assert [s[0] for s in spans] == [STEP, "cvs.upload"] * 3
    assert [s[3] for s in spans[::2]] == [{"seq": k, "streams": 1}
                                          for k in range(3)]
    assert [s[3] for s in spans[1::2]] == [None] * 3
    assert all(a[1] <= b[1] for a, b in zip(spans, spans[1:]))


# -- the attribution rule on synthetic events -----------------------------

SPANS = [(STEP, 0.0, 100.0, {"seq": 1, "streams": 1}),
         ("cvs.overlay", 10.0, 40.0, None),
         ("cvs.visualizer", 20.0, 30.0, None),  # nested: innermost wins
         ("cvs.compact", 50.0, 90.0, None)]


@pytest.mark.parametrize("launch, stage", [
    (15.0, "cvs.overlay"),
    (25.0, "cvs.visualizer"),
    (35.0, "cvs.overlay"),      # the inner span has closed again
    (60.0, "cvs.compact"),
    (45.0, OUTSIDE),            # inside cvs.step, in no stage
    (95.0, OUTSIDE),
    (150.0, OUTSIDE),           # after every span
])
def test_attribute_by_the_launch_time(launch, stage):
    # the device record starts late; only its launch decides
    out = profiling.attribute([("k", 500.0, 510.0, 7)], {7: launch}, SPANS)
    assert out == [("k", 500.0, 510.0, stage)]


def test_attribute_follows_the_correlation():
    device = [("a", 100.0, 101.0, 1), ("b", 101.0, 102.0, 2),
              ("c", 102.0, 103.0, 3)]
    launches = {1: 60.0, 2: 15.0}  # no launch correlates with record 3
    out = profiling.attribute(device, launches, SPANS)
    assert [r[3] for r in out] == ["cvs.compact", "cvs.overlay", OUTSIDE]
    assert [r[:3] for r in out] == [d[:3] for d in device]


def test_attribute_without_spans_is_outside():
    out = profiling.attribute([("k", 1.0, 2.0, 1)], {1: 0.5}, [])
    assert out == [("k", 1.0, 2.0, OUTSIDE)]
