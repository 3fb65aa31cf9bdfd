"""The stage labels of a traced slice (``cvsbench/stages.py``) and the
``overlay_ms`` reader, on made-up records; one short labelled slice on
the card."""

import pytest
import torch

from cvsbench import harness, stages, trace
from cvsbench.metrics import overlay_ms

K1 = "void tiled_unit_kernel<true, false>(unsigned char const*, int)"
GATHER = ("void at::native::_scatter_gather_elementwise_kernel<128, 8>"
          "(int, at::native::_cuda_scatter_gather_internal_kernel)")
COPY = ("void at::native::elementwise_kernel<128, 4, at::native::"
        "direct_copy_kernel_cuda(at::TensorIteratorBase&)>(int)")
# one eager step: the clone as the runtime's copy, then the gather, a
# copy and K1
EAGER = [("Memcpy DtoD (Device -> Device)", 0.0, 1.0, "cvs.overlay"),
         (GATHER, 2.0, 4.0, "cvs.overlay"),
         (COPY, 5.0, 6.0, "cvs.overlay"),
         (K1, 8.0, 20.0, "cvs.compact")]
# the graph runs the clone as the driver's copy kernel
REPLAY = ["memcpy32_post", GATHER, COPY, K1]


def replays(n, names=REPLAY, period=25.0):
    """``n`` replays of the graph, back to back, each record 2 us long
    and 1 us after the last."""
    recs = []
    for k in range(n):
        for i, name in enumerate(names):
            t = k * period + 3.0 * i
            recs.append(trace.Record(name, t, t + 2.0))
    return recs


def test_same_kind_matches_a_graph_copy_with_an_eager_one():
    assert stages.same_kind("memcpy32_post") == stages.same_kind(
        "Memcpy DtoD") == "memcpy"
    assert stages.same_kind("Memset (Device)") == "memset"
    assert stages.same_kind("tiled_unit_kernel") == "tiled_unit_kernel"


def test_label_by_position():
    got = stages.label(replays(3), EAGER, nodes=4, replays=3)
    assert got == [e[3] for e in EAGER] * 3


@pytest.mark.parametrize("case", ["eager short", "eager long",
                                  "slice short", "slice long", "no nodes"])
def test_label_refuses_a_count_mismatch(case):
    eager, recs, nodes = EAGER, replays(3), 4
    if case == "eager short":
        eager = EAGER[:3]
    elif case == "eager long":
        eager = EAGER + EAGER[:1]
    elif case == "slice short":
        recs = recs[:-1]
    elif case == "slice long":
        recs = replays(4)
    else:
        nodes = None
    assert stages.label(recs, eager, nodes, 3) is None


@pytest.mark.parametrize("at", [0, 5, 11])
def test_label_refuses_an_op_mismatch(at):
    recs = replays(3)
    recs[at] = trace.Record("conv_kernel", recs[at].start_us,
                            recs[at].end_us)
    assert stages.label(recs, EAGER, 4, 3) is None


def _labelled(recs, labels, frames=2):
    s = trace.Slice(records=recs, frames=frames,
                    busy_s=trace.busy_us(recs) * 1e-6,
                    window_s=trace.span_us(recs) * 1e-6,
                    frame_bytes=6220800, pos_mean=373000.0, stream={})
    if labels is not None:
        s.stages = labels
    return s


def test_overlay_ms_reads_the_overlay_records():
    recs = replays(2)
    s = _labelled(recs, stages.label(recs, EAGER, 4, 2))
    # three 2 us overlay records a replay, two replays over two frames
    assert overlay_ms.read(s) == pytest.approx(1e3 * 6e-6)


def test_overlay_ms_without_labels_is_none():
    assert overlay_ms.read(_labelled(replays(2), None)) is None
    assert overlay_ms.read(_labelled(replays(2), [])) is None


def test_overlay_ms_with_no_overlay_record_is_zero():
    recs = replays(1)
    assert overlay_ms.read(_labelled(recs, ["cvs.compact"] * 4)) == 0.0


def test_stage_breakdown_sums_ops_and_gaps_by_stage():
    recs = replays(2)
    out = stages.stage_breakdown(recs, stages.label(recs, EAGER, 4, 2))
    assert set(out) == {"stage_ops", "stage_gaps"}
    ops = dict(out["stage_ops"])
    assert ops == pytest.approx({"cvs.overlay": 12e-6, "cvs.compact": 4e-6})
    gaps = dict(out["stage_gaps"])
    # 1 us between records; 14 us from one replay's K1 to the next's copy
    assert gaps == pytest.approx({"cvs.overlay -> cvs.overlay": 4e-6,
                                  "cvs.overlay -> cvs.compact": 2e-6,
                                  "cvs.compact -> cvs.overlay": 14e-6})


@pytest.mark.parametrize("step_end, compact_end, last", [
    (30.0, 30.0, "cvs.compact"),
    (30.0, 19.0, "cvs.step"),
    (19.5, 19.0, "outside"),
])
def test_eager_idle_by_host_takes_the_innermost_open_span(step_end,
                                                           compact_end,
                                                           last):
    spans = [("cvs.step", 0.0, step_end, {"seq": 1, "streams": 1}),
             ("cvs.overlay", 0.5, 6.5, None),
             ("cvs.compact", 7.0, compact_end, None)]
    # gaps begin at 1.0, 4.0 and 6.0 (1, 1 and 2 us, in the overlay's
    # span) and at 20.0 (25 us, to the record at 45.0)
    eager = EAGER + [("k", 45.0, 46.0, "outside")]
    got = dict(stages.eager_idle_by_host(eager, spans))
    assert got == pytest.approx({"cvs.overlay": 4e-6, last: 25e-6})


@pytest.mark.card
def test_slice_labelled_on_the_card():
    """A short labelled slice of the first cell on the card: K1's records
    are the compaction stage's, and none is outside a stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell("cvs_1080p.cam1")
    cell.traffic = dict(cell.traffic, bank_frames=4, warm_replays=1,
                        trace_replays=2)
    out = stages.staged(cell, 7)
    assert out["labelled"] is True
    assert out["ops_by_stage"]["cvs.compact"] == ["tiled_unit_kernel"]
    assert "outside" not in out["ops_by_stage"]
    assert out["overlay_ms"] == pytest.approx(out["torch_ops_ms"])
