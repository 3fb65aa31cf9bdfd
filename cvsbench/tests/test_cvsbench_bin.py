"""The binarize configuration's own files: the ``k9_roofline`` reader on
made-up records, and a reference that imports nothing of the port."""

import ast
from pathlib import Path

import pytest

from cvsbench import roofline, trace
from cvsbench.metrics import k9_roofline

BENCH_DIR = Path(__file__).resolve().parents[1]
N = 6220800
FUSED = ("void binarize_fused_kernel<false>(unsigned char const*, long long,"
         " int, unsigned char*)")
GRAY = "binarize_gray_kernel(unsigned char const*, long long, int*)"
APPLY = "binarize_apply_kernel(unsigned char const*, int const*)"
K1 = "void tiled_unit_kernel<true, false>(unsigned char const*, int)"
OVERLAY = "overlay_kernel(unsigned char const*, int const*)"


def make_slice(records, frames=2, visualizer=5):
    recs = [trace.Record(n, a, b) for n, a, b in records]
    return trace.Slice(records=recs, frames=frames,
                       busy_s=trace.busy_us(recs) * 1e-6,
                       window_s=trace.span_us(recs) * 1e-6,
                       frame_bytes=N, pos_mean=373000.0,
                       stream={"noise_filter": False, "conv_k": 3,
                               "visualizer": visualizer})


# two camera frames: K14, K9 (9 and 11 us), K1
SLICE = [(OVERLAY, 0.0, 3.0), (FUSED, 3.5, 12.5), (K1, 13.0, 30.0),
         (OVERLAY, 31.0, 34.0), (FUSED, 34.5, 45.5), (K1, 46.0, 63.0)]


def test_two_n_over_k9_time():
    least = 2 * N / roofline.HBM_BYTES_PER_S
    assert k9_roofline.read(make_slice(SLICE)) == pytest.approx(
        100 * least / 10e-6)


def test_sharded_launches_summed():
    recs = [(GRAY, 0.0, 6.0), (APPLY, 7.0, 11.0), (GRAY, 12.0, 18.0),
            (APPLY, 19.0, 23.0)]
    least = 2 * N / roofline.HBM_BYTES_PER_S
    assert k9_roofline.read(make_slice(recs)) == pytest.approx(
        100 * least / 10e-6)


@pytest.mark.parametrize("visualizer", [0, 1, 3, 4])
def test_none_without_visualizer_5(visualizer):
    assert k9_roofline.read(make_slice(SLICE, visualizer=visualizer)) is None


def test_none_without_records():
    assert k9_roofline.read(make_slice([])) is None
    no_k9 = [r for r in SLICE if r[0] != FUSED]
    assert k9_roofline.read(make_slice(no_k9)) is None


def test_reference_imports_only_numpy_and_the_reference():
    names = set()
    tree = ast.parse((BENCH_DIR / "bin_reference.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.update(f"{node.module}.{a.name}" for a in node.names)
    assert names <= {"__future__.annotations", "typing.Dict",
                     "typing.Tuple", "numpy", "cvsbench.reference"}
