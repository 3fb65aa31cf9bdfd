"""The port's per-kernel table (``cudavideostream_tpu_torch/kernel_table.py``,
``bench --full``) against the JAX package's ``benchmarks/kernels.py``: the
same rows in the same order under the same names and Jetson values (read
from the JAX file by an ``ast`` scan, never imported), and each row's
chain, three steps on the CPU at 48x64, equal to the JAX package's calls
on the same numpy inputs, exactly; the JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavideostream_tpu.ops import convolve as jax_convolve
from cudavideostream_tpu.ops import diff as jax_diff
from cudavideostream_tpu.ops import filters as jax_filters
from cudavideostream_tpu.ops import logcompact as jax_logcompact
from cudavideostream_tpu.ops import overlay as jax_overlay
from cudavideostream_tpu.ops import reference_cpu as jax_ref
from cudavideostream_tpu.utils import fonts as jax_fonts
from cudavideostream_tpu_torch import bench, kernel_table
from cudavideostream_tpu_torch.config import StreamConfig

REPO = Path(__file__).resolve().parents[1]
H, W = 48, 64
STEPS = 3
# overlay_scale 4: two stroke cells fit the 48-row frame, so the text row
# blits glyphs
CFG = StreamConfig(height=H, width=W, overlay_scale=4)


def _value(node, env):
    """The value of one expression of the JAX table's row literals: a
    constant, a loop variable, ``+`` and ``*``, an f-string, and the
    ``sine_ok`` choice taken as False (the sine heatmap is not ported:
    the port's row is ``heatmap_lut``)."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        return env[node.id]
    if isinstance(node, ast.BinOp):
        a, b = _value(node.left, env), _value(node.right, env)
        return {ast.Add: lambda: a + b, ast.Mult: lambda: a * b}[
            type(node.op)]()
    if isinstance(node, ast.JoinedStr):
        return "".join(str(_value(v, env)) for v in node.values)
    if isinstance(node, ast.FormattedValue):
        return _value(node.value, env)
    if isinstance(node, ast.IfExp):
        assert ast.unparse(node.test) == "sine_ok"
        return _value(node.orelse, env)
    raise AssertionError(f"unexpected expression {ast.unparse(node)}")


def _appended(stmt):
    """The tuple of an ``entries.append((...))`` statement, else None."""
    if (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and ast.unparse(stmt.value.func) == "entries.append"):
        return stmt.value.args[0]
    return None


def jax_table_rows():
    """``[(name, jetson_ms), ...]`` of ``benchmarks/kernels.py``'s
    ``entries``, in order, read from its source."""
    tree = ast.parse((REPO / "benchmarks" / "kernels.py").read_text())
    run = next(n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "run")
    out = []
    for stmt in run.body:
        if (isinstance(stmt, ast.Assign)
                and ast.unparse(stmt.targets[0]) == "entries"):
            out += [(_value(e.elts[0], {}), _value(e.elts[1], {}))
                    for e in stmt.value.elts]
        elif isinstance(stmt, ast.For) and any(
                _appended(inner) is not None for inner in stmt.body):
            names = [t.id for t in stmt.target.elts]
            for binding in stmt.iter.elts:
                env = dict(zip(names, (_value(v, {})
                                       for v in binding.elts)))
                for inner in stmt.body:
                    tup = _appended(inner)
                    if tup is not None:
                        out.append((_value(tup.elts[0], env),
                                    _value(tup.elts[1], env)))
        elif _appended(stmt) is not None:
            tup = _appended(stmt)
            out.append((_value(tup.elts[0], {}), _value(tup.elts[1], {})))
    return out


def test_rows_and_jetson_values_equal_the_jax_table():
    """The port's rows are the JAX table's, in its order, with its Jetson
    values, but for ``histogram_mxu`` (absent: not ported, by design) and
    the heatmap row, ``heatmap_lut``."""
    want = [(n, ms) for n, ms in jax_table_rows() if n != "histogram_mxu"]
    assert len(want) == 22 and ("heatmap_lut", 20.99) in want
    got = [(r.name, r.jetson_ms) for r in kernel_table.rows(CFG, "cpu")]
    assert got == want


def test_frames_are_the_jax_tables_draw():
    """``frames`` draws as ``kernels.py:45-61``: 6% of the bytes moved by
    +100 mod 256, the clustered frame's as many bytes in its first 6%."""
    n = 100_000
    prev, cur, clus = kernel_table.frames(n)
    rng = np.random.default_rng(0)
    want_prev = rng.integers(0, 255, n, endpoint=True, dtype=np.uint8)
    moved = rng.random(n) < 0.06
    np.testing.assert_array_equal(prev, want_prev)
    np.testing.assert_array_equal(cur != prev, moved)
    np.testing.assert_array_equal(cur[moved],
                                  (prev[moved].astype(int) + 100) % 256)
    band = int(0.06 * n)
    assert (clus[:band] != prev[:band]).all()
    np.testing.assert_array_equal(clus[band:], prev[band:])


def _jax_chains():
    """The JAX table's chains (``kernels.py:68-136``) by row name, its
    Pallas kernels in interpret mode."""
    lc, h, w = jax_logcompact, H, W

    def tiled(sub):
        def chain(c):
            a, b, acc = c
            _, _, xs_t, vals_t, new_prev = lc.fused_diff_compact(
                a, b, emit="tiled", sub_rows=sub, interpret=True)
            return b, new_prev, acc + xs_t[0, 0] + vals_t[0, 0].astype(
                jnp.int32)

        return chain

    def flat(c):
        a, b, acc = c
        _, xs, vals, new_prev = lc.fused_diff_compact(a, b, interpret=True)
        return b, new_prev, acc + jnp.sum(xs[:1]) + vals[0].astype(jnp.int32)

    def segment(c):
        a, b, acc = c
        _, xs, vals, new_prev = lc.fused_diff_compact(
            a, b, scheme="segment", interpret=True)
        return b, new_prev, acc + xs[0] + vals[0].astype(jnp.int32)

    def mask_only(c):
        a, b = c
        return b, jax_diff.diff_mask(a, b, 20)[2]

    def host_offload(c):
        a, b, acc = c
        m, _, np_ = jax_diff.diff_mask(a, b, 20)
        bm = jax_diff.pack_bitmask(m)
        return b, np_, acc + bm[0].astype(jnp.int32)

    def hist(frame):
        g = jax_filters.gray_histogram(frame)
        return frame ^ jnp.bitwise_and(g[0], 1).astype(jnp.uint8)

    def heat(c):
        a, b = c
        return b, jax_filters.heatmap(a, b, use_sine=False)

    def red(c):
        a, b = c
        m, _, _ = jax_diff.diff_mask(a, b, 20)
        return b, jax_filters.red_overlap(a, m)

    def gaussian(k):
        wq = jax_ref.quantize_kernel_q16(jax_ref.gaussian_kernel(k))
        return lambda f: jax_convolve.convolve_q16(f, wq, h, w)

    atlas = jnp.asarray(jax_fonts.make_atlas(CFG.overlay_scale))
    ids = jnp.asarray(jax_fonts.encode_text("FPS: 30 BW: 5 kbps", 28),
                      jnp.int32)
    chains = {
        "diff+compact_tiled": tiled(0),
        "diff+compact_subtiled1": tiled(1),
        "diff+compact_subtiled1_clustered": tiled(1),
        "diff+compact_subtiled8": tiled(8),
        "diff+compact_subtiled8_clustered": tiled(8),
        "diff+compact_tiled_clustered": tiled(0),
        "diff+compact_pallas": flat,
        "diff+compact_segment": segment,
        "diff_mask_only": mask_only,
        "host_offload_step": host_offload,
        "grayscale_avg": jax_filters.grayscale_average,
        "grayscale_weighted": jax_filters.grayscale_weighted,
        "histogram": hist,
        "binarize_pipeline": jax_filters.binarize_pipeline,
        "heatmap_lut": heat,
        "red_overlap": red,
        "median_k5": lambda f: jax_convolve.median_filter(f, 5, h, w),
        "text_overlay_18ch": lambda f: jax_overlay.overlay_blit(
            f, atlas, ids, jnp.int32(18), h, w),
    }
    for k in (3, 5, 7, 9):
        chains[f"gaussian_conv_k{k}"] = gaussian(k)
    return chains


def _leaves(carry):
    return list(carry) if isinstance(carry, tuple) else [carry]


ROW_NAMES = [n for n, _ in jax_table_rows() if n != "histogram_mxu"]


@pytest.mark.parametrize("name", ROW_NAMES)
def test_row_chain_equals_the_jax_chain(name):
    """Three chained steps of the port's row from its carry equal three
    steps of the JAX table's chain from the same numpy carry, every leaf
    (the state, the next frame and the int32 payload digest) exactly; and
    the port's steps leave their starting carry as it was."""
    row = next(r for r in kernel_table.rows(CFG, "cpu") if r.name == name)
    start = [t.clone() for t in _leaves(row.init)]
    port = row.init
    for _ in range(STEPS):
        port = row.chain(port)
    jchain = _jax_chains()[name]
    jax_carry = tuple(jnp.asarray(t.numpy()) for t in _leaves(row.init))
    jax_carry = jax_carry if isinstance(row.init, tuple) else jax_carry[0]
    for _ in range(STEPS):
        jax_carry = jchain(jax_carry)
    got, want = _leaves(port), _leaves(jax_carry)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    for t, s in zip(_leaves(row.init), start):
        assert torch.equal(t, s)


def test_copy_row_is_the_diff_rows_copy_of_prev():
    """``prev_copy`` chains the copy each diff row makes of ``prev``: a new
    tensor of the same bytes, from the diff rows' ``prev``."""
    row = kernel_table.copy_row(CFG, "cpu")
    diff_row = kernel_table.rows(CFG, "cpu")[0]
    assert torch.equal(row.init, diff_row.init[1])
    out = row.chain(row.init)
    assert torch.equal(out, row.init)
    assert out.data_ptr() != row.init.data_ptr()


def test_rechain_rule_keeps_the_longer_reading(monkeypatch):
    """A row under 0.15 ms is timed again over 320 steps and 3 runs, and
    that reading is kept; a slower row is timed once."""
    calls = []

    def fake(chain, init, k, iters):
        calls.append((k, iters))
        return {24: 0.1, 320: 0.2}[k] if len(calls) < 3 else 0.5

    monkeypatch.setattr("cudavideostream_tpu_torch.utils.timing."
                        "bench_scan_chain", fake)
    row = kernel_table.rows(CFG, "cpu")[0]
    assert kernel_table.time_row(row) == 0.2
    assert calls == [(24, 4), (320, 3)]
    assert kernel_table.time_row(row) == 0.5
    assert calls[2:] == [(24, 4)]


def test_run_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        kernel_table.run()


def test_bench_full_prints_every_row(capsys):
    """``bench --full --device cpu``: the headline JSON line stays the one
    line on stdout; stderr holds the table after the headline, every row
    in the JAX order with a finite time above 0, and one line for
    ``histogram_mxu``, then the ``prev_copy`` line."""
    assert bench.main(["--full", "--device", "cpu", "--frames", "2",
                       "--iters", "1"]) == 0
    captured = capsys.readouterr()
    out = captured.out.strip().splitlines()
    assert len(out) == 1 and '"metric": ' in out[0]
    err = captured.err.splitlines()
    start = next(i for i, line in enumerate(err)
                 if line.startswith("kernel table: 48x64"))
    assert any("[headline]" in line for line in err[:start])
    table = err[start + 1:]
    assert table[13].startswith("histogram_mxu: no row")
    del table[13]
    assert [line.split()[0] for line in table] == ROW_NAMES + ["prev_copy"]
    assert table[-1].endswith(kernel_table.COPY_LINE)
    for line in table:
        ms = float(line.split()[1])
        assert np.isfinite(ms) and ms > 0


def test_out_writes_the_tsv(tmp_path, monkeypatch, capsys):
    """``kernel_table.main(["--out", ...])`` writes ``name\\tms\\tjetson``
    lines, as ``kernels.py:200-204`` does (an empty jetson field where the
    reference has none), the rows only. Two steps a row, one run each,
    keep the test short."""
    for name, value in (("K", 2), ("ITERS", 1), ("RECHAIN_K", 2),
                        ("RECHAIN_ITERS", 1)):
        monkeypatch.setattr(kernel_table, name, value)
    path = tmp_path / "times.tsv"
    assert kernel_table.main(["--device", "cpu", "--out", str(path)]) == 0
    assert f"wrote {path}" in capsys.readouterr().out
    lines = [line.split("\t") for line in path.read_text().splitlines()]
    jetson = dict(jax_table_rows())
    assert [f[0] for f in lines] == ROW_NAMES
    for name, ms, ref in lines:
        assert float(ms) > 0 and len(ms.split(".")[1]) == 4
        assert ref == ("" if jetson[name] is None else str(jetson[name]))
