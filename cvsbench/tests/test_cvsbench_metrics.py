"""The per-layer readers and the trace arithmetic on made-up records."""

import importlib
import json
from pathlib import Path

import pytest

from cvsbench import roofline, trace

ROOT = Path(__file__).resolve().parents[2]
METRICS = [m["name"] for m in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["per_layer"]]
K1 = "void tiled_unit_kernel<true, false>(unsigned char const*, int)"
K8 = "void conv_kernel<3>(unsigned char const*, unsigned char*)"
COPY = ("void at::native::unrolled_elementwise_kernel<at::native::"
        "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}"
        "::operator()() const::{lambda(unsigned char)#1}>(int)")


def make_slice(records, frames=2, noise_filter=True, visualizer=0):
    recs = [trace.Record(n, a, b) for n, a, b in records]
    return trace.Slice(records=recs, frames=frames,
                       busy_s=trace.busy_us(recs) * 1e-6,
                       window_s=trace.span_us(recs) * 1e-6,
                       frame_bytes=6220800, pos_mean=373000.0,
                       stream={"noise_filter": noise_filter, "conv_k": 3,
                               "visualizer": visualizer})


SLICE = [(COPY, 0.0, 4.0), (K8, 5.0, 15.0), (K1, 16.0, 36.0),
         (COPY, 40.0, 44.0), ("Memset (Device)", 44.0, 45.0),
         (K8, 46.0, 56.0), (K1, 57.0, 77.0)]


def test_busy_and_span():
    recs = [trace.Record("a", 0, 10), trace.Record("b", 5, 12),
            trace.Record("c", 20, 25), trace.Record("d", 21, 22)]
    assert trace.busy_us(recs) == 17
    assert trace.span_us(recs) == 25
    assert trace.busy_us([]) == 0 and trace.span_us([]) == 0


def test_op_names():
    assert trace.op_name(K1) == "tiled_unit_kernel"
    assert trace.op_name(COPY) == "unrolled_elementwise_kernel[" \
        "direct_copy_kernel_cuda]"
    assert trace.op_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"


def test_breakdown():
    b = trace.breakdown(make_slice(SLICE).records)
    ops = dict(b["device_ops"])
    assert ops["tiled_unit_kernel"] == pytest.approx(40e-6)
    gaps = dict(b["idle_gaps"])
    assert gaps["tiled_unit_kernel -> unrolled_elementwise_kernel["
                "direct_copy_kernel_cuda]"] == pytest.approx(4e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_readers():
    s = make_slice(SLICE)
    read = {m: importlib.import_module(f"cvsbench.metrics.{m}").read(s)
            for m in METRICS}
    least = roofline.step_least_bytes(6220800, 373000) / \
        roofline.HBM_BYTES_PER_S
    assert read["k1_roofline"] == pytest.approx(100 * least / 20e-6)
    assert read["k8_roofline"] == pytest.approx(
        100 * roofline.filter_least_s(6220800, 3) / 10e-6)
    assert read["step_roofline"] == pytest.approx(
        100 * least / (s.busy_s / 2))
    assert read["device_ops_per_frame"] == 3.5
    assert read["torch_ops_ms"] == pytest.approx(1e3 * 9e-6 / 2)
    assert read["idle_pct"] == pytest.approx(100 * (1 - 69 / 77))


@pytest.mark.parametrize("visualizer", [1, 5])
def test_step_roofline_counts_the_aux_frame(visualizer):
    reader = importlib.import_module("cvsbench.metrics.step_roofline")
    s = make_slice(SLICE, visualizer=visualizer)
    least = roofline.step_least_bytes(6220800, 373000, aux=True) / \
        roofline.HBM_BYTES_PER_S
    assert reader.read(s) == pytest.approx(100 * least / (s.busy_s / 2))
    assert reader.read(s) > reader.read(make_slice(SLICE))


@pytest.mark.parametrize("metric", METRICS)
def test_reader_returns_nothing_without_records(metric):
    reader = importlib.import_module(f"cvsbench.metrics.{metric}")
    assert reader.read(make_slice([])) is None


def test_k8_silent_without_the_filter():
    reader = importlib.import_module("cvsbench.metrics.k8_roofline")
    assert reader.read(make_slice(SLICE, noise_filter=False)) is None
    no_k8 = [r for r in SLICE if r[0] != K8]
    assert reader.read(make_slice(no_k8)) is None
