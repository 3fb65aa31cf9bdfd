"""The per-kernel table of the headline bench (``bench --full``): the port
of the JAX package's ``benchmarks/kernels.py``, the rebuild of the
reference's nvprof tables (``report.tex``).

Each row chains one function ``k`` times, its output threaded back into
its input so that nothing loop-invariant can be hoisted, as the JAX
table's ``lax.scan`` does. Here the ``k`` steps are captured in one CUDA
graph and replayed ``iters`` times, timed by CUDA events
(``utils/timing.py:bench_scan_chain``: two warm-up passes on the capture
stream, one untimed replay that uploads the graph). A row under
:data:`RECHAIN_BELOW_MS` is timed again over :data:`RECHAIN_K` steps and
:data:`RECHAIN_ITERS` replays, and that reading is kept, the JAX table's
rule (``kernels.py:184-194``): with one graph launch a replay, the longer
window lowers the launch's share of the shortest rows.

The rows, their order, their names and the ``jetson`` column are the JAX
table's. ``jetson`` holds the reference's own Jetson Nano times
(``report.tex``, as ``kernels.py`` carries them): they are neither this
port's numbers nor a TPU's. Two JAX rows differ. ``histogram_mxu`` gets
one line and no row: the MXU histogram is not ported, by design. The
heatmap row is ``heatmap_lut``: the sine heatmap is not ported, by design,
and the LUT gives the same bytes. The register scheme has no row, as in
the JAX table.

The diff rows thread ``(cur, prev, acc)`` as the JAX chains do: each
step diffs ``cur`` against ``prev``, the next step diffs the old ``prev``
against the new state, and the payload's first index and value add into
the int32 scalar ``acc``, never into the state, so that every step stays
at the frames' density. The port's K1 and K5 write the new state into
``prev`` in place, where the JAX kernel returns a new array, so each step
hands them a copy of ``prev`` (6,220,800 B read and written at 1080p,
inside the row's time). That copy is timed alone, by the same rule, and
printed after the rows as ``prev_copy``: a diff row's time is its
kernels plus that copy, on inputs the last step left warm in L2, not a
kernel's time alone.

    python -m cudavideostream_tpu_torch.kernel_table [--out FILE.tsv]
        [--device cpu]

It runs on the card at the ``StreamConfig()`` default, 1080p BGR24, and
raises without one unless ``--device cpu`` is given: then the plain
PyTorch versions run at the bench's CPU size (48x64), timed on the host
clock, which is no device metric.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

K = 24  # steps in one CUDA graph
ITERS = 4  # graph replays timed
RECHAIN_BELOW_MS = 0.15
RECHAIN_K, RECHAIN_ITERS = 320, 3
CHANGED = 0.06  # share of bytes moved, the reference's rate (report.tex:2594)
THRESHOLD = 20
OVERLAY_TEXT, OVERLAY_SLOTS, OVERLAY_CHARS = "FPS: 30 BW: 5 kbps", 28, 18
COPY_NAME = "prev_copy"
COPY_LINE = ("the copy of prev alone, timed as a row; inside each "
             "diff+compact row's time (no JAX row)")
MXU_LINE = ("histogram_mxu: no row; gray_histogram(mxu=True), the JAX "
            "package's MXU histogram, is not ported, by design (ROADMAP.md)")


@dataclasses.dataclass(frozen=True)
class Row:
    """One row: its name, the reference's Jetson Nano time in ms (None
    where ``report.tex`` has none), ``chain(carry) -> carry`` and the
    carry it starts from."""

    name: str
    jetson_ms: Optional[float]
    chain: Callable
    init: object


def frames(n: int):
    """``(prev, cur, clustered)``, uint8 numpy frames of ``n`` bytes, drawn
    as the JAX table draws them (``kernels.py:45-61``): ``prev`` uniform
    from ``default_rng(0)``; ``cur`` with about 6% of its bytes moved by
    +100 mod 256; ``clustered`` with as many bytes moved, all in the first
    6% of the frame (a moving object; the rest of the tiles static)."""
    rng = np.random.default_rng(0)
    prev = rng.integers(0, 255, n, endpoint=True, dtype=np.uint8)
    cur = np.where(rng.random(n) < CHANGED,
                   (prev.astype(np.int32) + 100) % 256, prev).astype(np.uint8)
    clus = prev.copy()
    band = slice(0, int(CHANGED * n))
    clus[band] = ((clus[band].astype(np.int32) + 100) % 256).astype(np.uint8)
    return prev, cur, clus


def rows(cfg, device) -> List[Row]:
    """The table's rows at ``cfg``'s frame size, their carries on
    ``device``, in the JAX table's order. Every step is legal inside a
    CUDA graph capture: no upload from the host and no read of a device
    value on it."""
    from cudavideostream_tpu_torch.ops import (
        convolve,
        diff,
        filters,
        logcompact,
        overlay,
        reference_cpu,
    )
    from cudavideostream_tpu_torch.utils import fonts

    dev = torch.device(device)
    h, w = cfg.height, cfg.width
    prev, cur, clus = (torch.from_numpy(f).to(dev)
                       for f in frames(cfg.frame_bytes))
    acc0 = torch.zeros((), dtype=torch.int32, device=dev)
    atlas = torch.from_numpy(fonts.make_atlas(cfg.overlay_scale)).to(dev)
    ids = torch.tensor(fonts.encode_text(OVERLAY_TEXT, OVERLAY_SLOTS),
                       dtype=torch.int32, device=dev)

    def tiled(sub_rows):
        def chain(c):
            a, b, acc = c
            _, _, xs_t, vals_t, new_prev = logcompact.fused_diff_compact_tiled(
                a, b.clone(), THRESHOLD, sub_rows=sub_rows)
            return b, new_prev, acc + xs_t[0, 0] + vals_t[0, 0].to(torch.int32)

        return chain

    def flat(c):
        a, b, acc = c
        _, xs, vals, new_prev = logcompact.fused_diff_compact(
            a, b.clone(), THRESHOLD)
        return b, new_prev, (acc + xs[:1].sum(dtype=torch.int32)
                             + vals[0].to(torch.int32))

    def segment(c):
        a, b, acc = c
        _, xs, vals, new_prev = logcompact.fused_diff_compact(
            a, b.clone(), THRESHOLD, scheme="segment")
        return b, new_prev, acc + xs[0] + vals[0].to(torch.int32)

    def mask_only(c):
        a, b = c
        return b, diff.diff_mask(a, b, THRESHOLD)[2]

    def host_offload(c):
        # the HOST backend's device step (K10): the n/8-byte bitmask and
        # the negative-feedback state, no compaction on the card; K10
        # updates its prev in place, so it gets a copy, as K1 does above
        a, b, acc = c
        new_prev = b.clone()
        bits, _ = diff.diff_pack(a, new_prev, THRESHOLD)
        return b, new_prev, acc + bits[0].to(torch.int32)

    def hist(frame):
        g = filters.gray_histogram(frame)
        return frame ^ (g[0] & 1).to(torch.uint8)

    def heat(c):
        a, b = c
        return b, filters.heatmap(a, b)

    def red(c):
        # red_overlap(a, diff_mask(a, b)[0]) in one K12 launch: the mask is
        # symmetric in a and b, and the output is a with R = 255 on it
        a, b = c
        return b, filters.red_visualizer(b, a, THRESHOLD, overlap=True)

    def gaussian(k):
        wq = reference_cpu.quantize_kernel_q16(reference_cpu.gaussian_kernel(k))
        return lambda f: convolve.convolve_q16(f, wq, h, w)

    pair = (cur, prev, acc0)
    table = [
        Row("diff+compact_tiled", 3.42, tiled(0), pair),
        Row("diff+compact_subtiled1", 3.42, tiled(1), pair),
        Row("diff+compact_subtiled1_clustered", 3.42, tiled(1),
            (clus, prev, acc0)),
        Row("diff+compact_subtiled8", 3.42, tiled(8), pair),
        Row("diff+compact_subtiled8_clustered", 3.42, tiled(8),
            (clus, prev, acc0)),
        Row("diff+compact_tiled_clustered", 3.42, tiled(0),
            (clus, prev, acc0)),
        Row("diff+compact_pallas", 3.42, flat, pair),
        Row("diff+compact_segment", 3.42, segment, pair),
        Row("diff_mask_only", 3.42, mask_only, (cur, prev)),
        Row("host_offload_step", 3.42, host_offload, pair),
        Row("grayscale_avg", None, filters.grayscale_average, cur),
        Row("grayscale_weighted", None, filters.grayscale_weighted, cur),
        Row("histogram", None, hist, cur),
        Row("binarize_pipeline", None, filters.binarize_pipeline, cur),
        Row("heatmap_lut", 20.99, heat, (cur, prev)),
        Row("red_overlap", 0.915, red, (prev, cur)),
    ]
    for k, ref_ms in ((3, 5.1), (5, 9.8), (7, 17.7), (9, 27.7)):
        table.append(Row(f"gaussian_conv_k{k}", ref_ms, gaussian(k), cur))
    table.append(Row("median_k5", 574.67,
                     lambda f: convolve.median_filter(f, 5, h, w), cur))
    table.append(Row("text_overlay_18ch", OVERLAY_CHARS * 0.001868,
                     lambda f: overlay.overlay_blit(f, atlas, ids,
                                                    OVERLAY_CHARS, h, w),
                     cur))
    return table


def copy_row(cfg, device) -> Row:
    """The copy of ``prev`` that each diff row makes every step, alone:
    ``prev.clone()`` chained, each step's copy the next one's input, so
    that it too reads what the last step wrote."""
    prev = torch.from_numpy(frames(cfg.frame_bytes)[0]).to(device)
    return Row(COPY_NAME, None, lambda b: b.clone(), prev)


def time_row(row: Row) -> float:
    """ms a step of ``row``: :func:`bench_scan_chain` over :data:`K` steps
    and :data:`ITERS` replays, and under :data:`RECHAIN_BELOW_MS` the
    reading over :data:`RECHAIN_K` steps and :data:`RECHAIN_ITERS`
    replays instead."""
    from cudavideostream_tpu_torch.utils.timing import bench_scan_chain

    ms = bench_scan_chain(row.chain, row.init, k=K, iters=ITERS)
    if ms < RECHAIN_BELOW_MS:
        ms = bench_scan_chain(row.chain, row.init, k=RECHAIN_K,
                              iters=RECHAIN_ITERS)
    return ms


def run(out_path: Optional[str] = None, device=None, file=None):
    """Time every row and print it to ``file`` (stdout by default), as the
    JAX table does, then the ``prev_copy`` line; with ``out_path`` also
    write the rows as TSV lines ``name\\tms\\tjetson``. Returns
    ``[(name, ms, jetson_ms), ...]``, the rows only.

    Runs on the card, at ``StreamConfig()`` (1080p), unless
    ``device="cpu"``: then at the bench's 48x64."""
    from cudavideostream_tpu_torch.bench import CPU_HEIGHT, CPU_WIDTH, card_line
    from cudavideostream_tpu_torch.config import StreamConfig
    from cudavideostream_tpu_torch.models.pipeline import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = StreamConfig()
    if not on_card:
        cfg = dataclasses.replace(cfg, height=CPU_HEIGHT, width=CPU_WIDTH)
    out = sys.stdout if file is None else file
    rechain = (f"rows under {RECHAIN_BELOW_MS} ms: {RECHAIN_K} steps, "
               f"{RECHAIN_ITERS} times")
    if on_card:
        print(f"kernel table: {cfg.height}x{cfg.width} on "
              f"{torch.cuda.get_device_name(dev)} ({card_line()}); ms a "
              f"step, {K} steps in one CUDA graph replayed {ITERS} times, "
              f"CUDA events ({rechain}); jetson: the reference's Jetson "
              f"Nano (report.tex), not this card", file=out, flush=True)
    else:
        print(f"kernel table: {cfg.height}x{cfg.width} on the CPU, the "
              f"plain PyTorch versions; ms a step on the host clock, not a "
              f"device metric ({K} steps after 2 x {K} warm-up, {ITERS} "
              f"times; {rechain}); jetson: the reference's Jetson Nano "
              f"(report.tex)", file=out, flush=True)
    results = []
    for row in rows(cfg, dev):
        ms = time_row(row)
        ref_ms = row.jetson_ms
        ratio = (f"{ref_ms / ms:7.1f}x" if on_card and ref_ms and ms > 1e-6
                 else "      -")
        results.append((row.name, ms, ref_ms))
        print(f"{row.name:32s} {ms:9.4f} ms   jetson "
              f"{ref_ms or float('nan'):8.3f} ms  {ratio}", file=out,
              flush=True)
        if row.name == "histogram":
            print(MXU_LINE, file=out, flush=True)
    print(f"{COPY_NAME:32s} {time_row(copy_row(cfg, dev)):9.4f} ms   "
          f"{COPY_LINE}", file=out, flush=True)
    if out_path:
        with open(out_path, "w") as f:
            for name, ms, ref_ms in results:
                f.write(f"{name}\t{ms:.4f}\t"
                        f"{'' if ref_ms is None else ref_ms}\n")
        print(f"wrote {out_path}", file=out, flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cudavideostream_tpu_torch.kernel_table",
        description="ms a step of each filter and compaction kernel, "
                    "CUDA-graph-chained on the card (the JAX package's "
                    "benchmarks/kernels.py)")
    p.add_argument("--out", default=None,
                   help="also write the rows as TSV: name, ms, jetson")
    p.add_argument("--device", default=None,
                   help="cpu: the plain PyTorch versions at 48x64 on the "
                        "host clock (default: the card)")
    args = p.parse_args(argv)
    run(args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
