#!/usr/bin/env python3
"""Time the K1 emissions, K2-K14 and the tiled and sharded steps of one
checkout, at 1080p.

    python3 tools/time_k1_flat.py CHECKOUT_ROOT [MODE ...]

Imports ``cudavideostream_tpu_torch`` from ``CHECKOUT_ROOT`` and prints,
for each MODE (default ``flat``), one line of five medians, each of 100
CUDA-event-timed launches at 1080p (~6% changed bytes plus a 288,000-byte
overlay region, ``prev`` fresh and ``cur`` rotated over 8 copies, so both
are cold in L2), with the queue held behind a sleep kernel so that the
events time the device alone. Modes:

* ``flat``: K1's flat emission (``fused_diff_compact``);
* ``map``: the same with a per-byte map of 20s (the scalar run's bytes);
* ``tiled``: K1 tiled at ``subtile_rows=1`` (``fused_diff_compact_tiled``);
* ``mask``: K1's bitmask-only emission at ``subtile_rows=1``;
* ``batched``: K1 batched over B = 4 streams of that frame, ``subtile_rows=1``;
* ``band``: K1 flat, tiled and bitmask-only (``subtile_rows=1``) and
  batched (B = 4) on a frame whose changes are one band of 5.937% of the
  bytes under +-10 noise, as the benchmark's scene (``cvsbench/scene.py``)
  makes them, no overlay region: four lines, each with the vectors of
  ``prev`` the launch stores where the checkout's K1 counts them
  (``prev_stores``);
* ``offset``: K1 tiled at ``subtile_rows=1`` with ``index_offset`` on the
  last row shard of the frame cut into S = 4 and into S = 8 shards (the
  sharded path's per-shard launch; one line for each S);
* ``step``: the tiled ``pipeline.step`` (``--tiled``: overlay text, then K1
  tiled at ``subtile_rows=1``), five medians of 30 calls (a step is
  several launches: the backlog must outlast their enqueueing);
* ``sharded``: ``ShardedDeltaPipeline.step_flat`` on S = 4 row shards, all
  four on ``cuda:0`` (the ``server --mesh`` step, four K1 tiled launches
  with their ``index_offset``), timed as ``step`` is;
* ``pair``: K2 (``merge_tiles``) on the ``tiled`` blocks of the same frame,
  4 copies in turn (31 MB each), so they are cold in L2;
* ``vals``: K3 (``merge_vals``) on the ``mask`` blocks, 16 copies in turn;
* ``hist``: K4 (``histogram``) on the gray values of the synthetic scene
  (hot in L2, as the binarize chain leaves them), then on a frame of one
  value everywhere (every add on one bin): two lines;
* ``register``: K6 (``register_compact``, threshold 20, negative
  feedback) on the frame, ``prev`` fresh and ``cur`` rotated as for K1;
* ``segment``: K5 (``segment_compact``, threshold 20, negative feedback,
  the overlay region) on the frame, as ``register``;
* ``segment_map``: the same with a per-byte map of 20s;
* ``segment_batched``: K5 batched over B = 4 streams of that frame
  (``fused_diff_compact_batched(scheme="segment")``);
* ``probe``: K7 (``vpu_probe``) on the synthetic scene's gray values as
  an ``(M, 128)`` int32 grid (45 tiles of 360 rows);
* ``conv``: K8 (``convolve_q16``) with the Gaussian taps at K = 3, 5, 7
  and 9 (one line each), on 16 copies of the frame in turn (100 MB, cold
  in L2);
* ``binarize``: K9 (``binarize_pipeline``, every launch of a call) on 16
  copies of the frame in turn, then on the synthetic scene (mostly flat:
  16 equal gray values take one histogram add), on the copies through K8
  at K = 3 (a gray histogram peaked near 127, as the benchmark's
  ``cvs_1080p_bin`` frames give), and on 16 frames of one value each
  (every add of a frame on one bin): four lines;
* ``binarize_batched``: K9 on B = 4 streams of the frame (4 sets in turn),
  as ``BatchedDeltaPipeline`` calls it: one ``streams=4`` call where the
  checkout takes one, else a call a stream into its slice of the output;
* ``diff_pack``: K10 (``diff_pack``, the HOST step) on 16 copies of the
  frame and of ``prev`` in turn (200 MB, cold in L2), threshold 20
  without the delta, with the delta, and with a map of 20s: three lines;
* ``red``: K12 (``red_visualizer``) on the same copies, mode 3, mode 2
  and mode 3 with a map of 20s: three lines;
* ``heat``: K11 (``heatmap``) on the same copies, without a strip and
  with the 288,000-byte overlay strip: two lines;
* ``gray``: K13 (``grayscale_weighted``, ``grayscale_average``) on the
  same copies of the frame: two lines;
* ``overlay``: the overlay stage as each checkout's pipelines run it (K14
  where the checkout has it, else its PyTorch ops) with the 18-character
  status line: ``overlay_blit`` on the 1080p strip of 16 copies of the
  frame in turn, as ``DeltaStreamPipeline`` calls it, and
  ``BatchedDeltaPipeline._strips`` on 4 sets of B = 4 streams in turn:
  two lines.

To compare two commits, unpack the other one into a git-ignored directory
(``git archive COMMIT | tar -x -C build/parent``) and time both in one
call to one card, in turns::

    for t in build/parent . . build/parent; do
        python3 tools/time_k1_flat.py "$(cd $t && pwd)" flat pair; done

Each line names the card and its power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them.
"""

import statistics
import subprocess
import sys

import numpy as np
import torch

MODES = ("flat", "map", "tiled", "mask", "batched", "band", "offset",
         "step", "sharded", "pair", "vals", "hist", "register", "segment",
         "segment_map", "segment_batched", "probe", "conv", "binarize",
         "binarize_batched", "diff_pack", "red", "heat", "gray",
         "overlay")


def _medians(fn, refill=None, iters=100):
    """Five medians of ``iters`` CUDA-event-timed calls of ``fn(i)``."""
    fn(0)
    medians = []
    for _ in range(5):
        if refill is not None:
            refill()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        for i in range(iters):
            starts[i].record()
            fn(i)
            ends[i].record()
        torch.cuda.synchronize()
        medians.append(statistics.median(
            a.elapsed_time(b) for a, b in zip(starts, ends)))
    return medians


def _filters(root, mode, card, c0, rng):
    """The ``conv``, ``binarize`` and ``binarize_batched`` modes."""
    import inspect

    from cudavideostream_tpu_torch.config import StreamConfig
    from cudavideostream_tpu_torch.ops import convolve, filters
    from cudavideostream_tpu_torch.ops import reference_cpu as ref
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    h, w = 1080, 1920
    n = h * w * 3
    copies = [c0.roll(int(rng.integers(1, n))) for _ in range(16)]
    if mode == "conv":
        for k in (3, 5, 7, 9):
            wq = ref.quantize_kernel_q16(ref.gaussian_kernel(k))
            medians = _medians(lambda i, wq=wq: convolve.convolve_q16(
                copies[i % 16], wq, h, w))
            print(root, f"conv K={k}", card,
                  " ".join(f"{m:.4f}" for m in medians), "ms", flush=True)
        return
    if mode == "binarize":
        src = SyntheticSource(StreamConfig(), seed=2734)
        src.base_frame()
        scene = torch.from_numpy(next(src)).to(c0.device)
        scenes = [scene.roll(3 * 1009 * j) for j in range(16)]
        wq = ref.quantize_kernel_q16(ref.gaussian_kernel(3))
        filtered = [convolve.convolve_q16(c, wq, h, w) for c in copies]
        flat = [torch.full((n,), 16 * j + 7, dtype=torch.uint8,
                           device=c0.device) for j in range(16)]
        for label, frames in (("binarize", copies),
                              ("binarize scene", scenes),
                              ("binarize filtered", filtered),
                              ("binarize one value", flat)):
            medians = _medians(lambda i, frames=frames:
                               filters.binarize_pipeline(frames[i % 16]))
            print(root, label, card, " ".join(f"{m:.4f}" for m in medians),
                  "ms", flush=True)
        return
    quads = [torch.cat(copies[4 * j:4 * j + 4]) for j in range(4)]
    outs = [torch.empty_like(q) for q in quads]
    if "streams" in inspect.signature(filters.binarize_pipeline).parameters:
        def fn(i):
            filters.binarize_pipeline(quads[i % 4], streams=4)
    else:
        def fn(i):
            for b in range(4):
                filters.binarize_pipeline(quads[i % 4][b * n:(b + 1) * n],
                                          out=outs[i % 4][b * n:(b + 1) * n])
    medians = _medians(fn)
    print(root, mode, card, " ".join(f"{m:.4f}" for m in medians), "ms",
          flush=True)


def _k10_k13(root, mode, card, c0, p0, rng, region):
    """The ``diff_pack``, ``red``, ``heat`` and ``gray`` modes."""
    from cudavideostream_tpu_torch.ops import diff, filters

    n = c0.numel()
    curs = [c0.roll(int(rng.integers(1, n))) for _ in range(16)]
    prevs = [p0.roll(int(rng.integers(1, n))) for _ in range(16)]
    tmaps = [torch.full_like(c0, 20) for _ in range(16)]
    forms = {
        "diff_pack": {
            "": lambda i: diff.diff_pack(curs[i % 16], prevs[i % 16], 20),
            " delta": lambda i: diff.diff_pack(curs[i % 16], prevs[i % 16],
                                               20, want_delta=True),
            " map": lambda i: diff.diff_pack(curs[i % 16], prevs[i % 16],
                                             tmaps[i % 16])},
        "red": {
            " mode 3": lambda i: filters.red_visualizer(
                curs[i % 16], prevs[i % 16], 20, True),
            " mode 2": lambda i: filters.red_visualizer(
                curs[i % 16], prevs[i % 16], 20, False),
            " mode 3 map": lambda i: filters.red_visualizer(
                curs[i % 16], prevs[i % 16], tmaps[i % 16], True)},
        "heat": {
            "": lambda i: filters.heatmap(curs[i % 16], prevs[i % 16]),
            " strip": lambda i: filters.heatmap(curs[i % 16], prevs[i % 16],
                                                region)},
        "gray": {
            " weighted": lambda i: filters.grayscale_weighted(curs[i % 16]),
            " average": lambda i: filters.grayscale_average(curs[i % 16])}}
    for label, fn in forms[mode].items():
        medians = _medians(fn)
        print(root, mode + label, card,
              " ".join(f"{m:.4f}" for m in medians), "ms", flush=True)


def _overlay(root, card, c0, rng):
    """The ``overlay`` mode."""
    import dataclasses

    from cudavideostream_tpu_torch.config import StreamConfig
    from cudavideostream_tpu_torch.models import (
        BatchedDeltaPipeline,
        DeltaStreamPipeline,
    )
    from cudavideostream_tpu_torch.models.pipeline import MAX_OVERLAY_CHARS
    from cudavideostream_tpu_torch.ops import overlay as overlay_ops

    cfg = dataclasses.replace(StreamConfig(), tiled_payload=True)
    text = "FPS: 30 BW: 5 kbps"
    n = c0.numel()
    copies = [c0.roll(int(rng.integers(1, n))) for _ in range(16)]
    pipe = DeltaStreamPipeline(cfg)
    cell_h = pipe.atlas.shape[1]
    strip = cell_h * cfg.width * 3
    # the step's ids (text_glyphs: in the parent and in the change)
    ids = overlay_ops.text_glyphs([text], MAX_OVERLAY_CHARS,
                                  cfg.width // pipe.atlas.shape[2],
                                  c0.device)[0][0]
    medians = _medians(lambda i: overlay_ops.overlay_blit(
        copies[i % 16][:strip], pipe.atlas, ids, len(text), cell_h,
        cfg.width))
    print(root, "overlay B=1", card, " ".join(f"{m:.4f}" for m in medians),
          "ms", flush=True)
    bpipe = BatchedDeltaPipeline(cfg, 4)
    quads = [torch.cat(copies[4 * j:4 * j + 4]) for j in range(4)]
    medians = _medians(lambda i: bpipe._strips(quads[i % 4], [text] * 4))
    print(root, "overlay B=4", card, " ".join(f"{m:.4f}" for m in medians),
          "ms", flush=True)


def _band(root, card, lc, p0):
    """The ``band`` mode: K1's emissions on the scene's layout of change,
    timed as the other K1 modes, with the vectors each stores."""
    import inspect

    n = p0.numel()
    gen = torch.Generator(device=p0.device)
    gen.manual_seed(2736)
    start, band = n // 3, round(0.05937339 * n)
    c0 = p0.to(torch.int16)
    c0[start:start + band] = (c0[start:start + band] + 77) % 256
    noise = torch.randint(-10, 11, (n,), generator=gen, device=p0.device)
    c0 = (c0 + noise).clamp_(0, 255).to(torch.uint8)
    counted = "prev_stores" in inspect.signature(
        lc.fused_diff_compact_tiled).parameters
    for label, b, k1 in (
            ("flat", 1, lambda c, p, **kw: lc.fused_diff_compact(
                c, p, 20, True, **kw)),
            ("tiled", 1, lambda c, p, **kw: lc.fused_diff_compact_tiled(
                c, p, 20, True, None, 1, **kw)),
            ("mask", 1, lambda c, p, **kw: lc.fused_diff_compact_mask(
                c, p, 20, True, None, 1, **kw)),
            ("batched", 4, lambda c, p, **kw: lc.fused_diff_compact_batched(
                c, p, 4, 20, True, sub_rows=1, **kw))):
        pb, cb = p0.repeat(b), c0.repeat(b)
        prevs = [pb.clone() for _ in range(100)]
        curs = [cb.clone() for _ in range(8)]

        def refill(prevs=prevs, pb=pb):
            for p in prevs:
                p.copy_(pb)

        def fn(i, k1=k1, curs=curs, prevs=prevs):
            k1(curs[i % 8], prevs[i])

        stored = "prev_stores not in this checkout"
        if counted:
            st = torch.zeros(1, dtype=torch.int64, device=p0.device)
            k1(cb, pb.clone(), prev_stores=st)
            vectors = b * -(-n // 16)
            stored = (f"stored {int(st)} of {vectors} vectors "
                      f"({100 * int(st) / vectors:.3f}%)")
        medians = _medians(fn, refill)
        print(root, f"band {label}", card,
              " ".join(f"{m:.4f}" for m in medians), "ms;", stored,
              flush=True)


def main() -> int:
    root = sys.argv[1]
    modes = sys.argv[2:] or ["flat"]
    if set(modes) - set(MODES):
        raise SystemExit(f"unknown mode(s) {set(modes) - set(MODES)}: "
                         f"choose from {MODES}")
    sys.path.insert(0, root)
    import cudavideostream_tpu_torch
    from cudavideostream_tpu_torch.ops import logcompact as lc

    if not cudavideostream_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {cudavideostream_tpu_torch.__file__}, "
                           f"not the package under {root}")
    dev = torch.device("cuda")
    n = 1920 * 1080 * 3
    rng = np.random.default_rng(2735)
    prev = rng.integers(0, 256, n, dtype=np.uint8)
    jump = rng.integers(30, 200, n) * rng.choice([-1, 1], n)
    delta = np.where(rng.random(n) < 0.06, jump, rng.integers(-15, 16, n))
    cur = ((prev.astype(np.int32) + delta) % 256).astype(np.uint8)
    p0 = torch.from_numpy(prev).to(dev)
    c0 = torch.from_numpy(cur).to(dev)
    region = torch.from_numpy(
        rng.integers(0, 256, 288_000, dtype=np.uint8)).to(dev)
    tm = torch.full((n,), 20, dtype=torch.uint8, device=dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    for mode in modes:
        if mode in ("conv", "binarize", "binarize_batched"):
            _filters(root, mode, card, c0, rng)
            continue
        if mode in ("diff_pack", "red", "heat", "gray"):
            _k10_k13(root, mode, card, c0, p0, rng, region)
            continue
        if mode == "overlay":
            _overlay(root, card, c0, rng)
            continue
        if mode == "band":
            _band(root, card, lc, p0)
            continue
        if mode in ("hist", "probe"):
            from cudavideostream_tpu_torch.config import StreamConfig
            from cudavideostream_tpu_torch.ops import filters, hist
            from cudavideostream_tpu_torch.runtime.sources import (
                SyntheticSource,
            )

            src = SyntheticSource(StreamConfig(), seed=2734)
            src.base_frame()
            g = filters.gray_pixels(torch.from_numpy(next(src)).to(dev))
            if mode == "probe":
                g2 = g.to(torch.int32).view(-1, 128)
                medians = _medians(lambda i: hist.vpu_probe(g2))
                print(root, mode, card,
                      " ".join(f"{m:.4f}" for m in medians), "ms",
                      flush=True)
                continue
            for label, gv in (("hist", g), ("hist one",
                                            torch.full_like(g, 137))):
                medians = _medians(lambda i, gv=gv: hist.histogram(gv))
                print(root, label, card,
                      " ".join(f"{m:.4f}" for m in medians), "ms",
                      flush=True)
            continue
        if mode == "offset":
            for s_count in (4, 8):
                ln = n // s_count
                off = (s_count - 1) * ln  # the last shard's base
                c_s = c0[off:off + ln].clone()
                p_s = p0[off:off + ln].clone()
                prevs = [p_s.clone() for _ in range(100)]
                curs = [c_s.clone() for _ in range(8)]

                def refill(prevs=prevs, p_s=p_s):
                    for p in prevs:
                        p.copy_(p_s)

                def fn(i, prevs=prevs, curs=curs, off=off):
                    lc.fused_diff_compact_tiled(curs[i % 8], prevs[i], 20,
                                                True, None, 1,
                                                index_offset=off)

                medians = _medians(fn, refill)
                print(root, f"offset S={s_count}", card,
                      " ".join(f"{m:.4f}" for m in medians), "ms",
                      flush=True)
            continue
        refill = None
        if mode in ("step", "sharded"):
            import dataclasses

            from cudavideostream_tpu_torch.config import StreamConfig
            from cudavideostream_tpu_torch.models import DeltaStreamPipeline
            from cudavideostream_tpu_torch.parallel import (
                ShardedDeltaPipeline,
                make_mesh,
            )

            cfg = StreamConfig()
            text = "FPS: 30 BW: 1234 kbps"
            curs = [c0.clone() for _ in range(8)]
            if mode == "step":
                pipe = DeltaStreamPipeline(
                    dataclasses.replace(cfg, tiled_payload=True))
                init, step = pipe.init_state, pipe.step
            else:
                pipe = ShardedDeltaPipeline(
                    cfg, make_mesh(4, devices=["cuda:0"] * 4),
                    payload_layout="sharded")
                init, step = pipe.init_state_flat, pipe.step_flat
            states = [None] * 30

            def refill(states=states, init=init):
                for i in range(len(states)):
                    states[i] = init(prev)

            def fn(i, step=step, states=states, curs=curs):
                step(states[i], curs[i % 8], text=text)

            refill()
            medians = _medians(fn, refill, iters=30)
            print(root, mode, card, " ".join(f"{m:.4f}" for m in medians),
                  "ms", flush=True)
            continue
        if mode in ("flat", "map", "tiled", "mask", "batched", "segment",
                    "segment_map", "segment_batched"):
            b = 4 if mode.endswith("batched") else 1
            pb, cb = p0.repeat(b), c0.repeat(b)
            prevs = [pb.clone() for _ in range(100)]
            curs = [cb.clone() for _ in range(8)]

            def refill():
                for p in prevs:
                    p.copy_(pb)

            k1 = {
                "flat": lambda c, p: lc.fused_diff_compact(c, p, 20, True,
                                                           region),
                "map": lambda c, p: lc.fused_diff_compact(
                    c, p, 20, True, region, threshold_map=tm),
                "tiled": lambda c, p: lc.fused_diff_compact_tiled(
                    c, p, 20, True, region, 1),
                "mask": lambda c, p: lc.fused_diff_compact_mask(
                    c, p, 20, True, region, 1),
                "batched": lambda c, p: lc.fused_diff_compact_batched(
                    c, p, 4, 20, True, sub_rows=1),
                "segment": lambda c, p: lc.segment_compact(c, p, 20, True,
                                                           region),
                "segment_map": lambda c, p: lc.segment_compact(
                    c, p, 20, True, region, tm),
                "segment_batched": lambda c, p: lc.fused_diff_compact_batched(
                    c, p, 4, 20, True, scheme="segment"),
            }[mode]

            def fn(i, k1=k1, curs=curs, prevs=prevs):
                k1(curs[i % 8], prevs[i])
        elif mode == "register":
            from cudavideostream_tpu_torch.ops import register_compact

            prevs = [p0.clone() for _ in range(100)]
            curs = [c0.clone() for _ in range(8)]

            def refill():
                for p in prevs:
                    p.copy_(p0)

            def fn(i, curs=curs, prevs=prevs):
                register_compact.register_compact(curs[i % 8], prevs[i])
        elif mode == "pair":
            out = lc.fused_diff_compact_tiled(c0, p0.clone(), 20, True,
                                              region, 1)
            blocks = [(out[1], out[2].clone(), out[3].clone())
                      for _ in range(4)]

            def fn(i, blocks=blocks):
                lc.merge_tiles(*blocks[i % 4])
        else:  # vals
            out = lc.fused_diff_compact_mask(c0, p0.clone(), 20, True,
                                             region, 1)
            blocks = [(out[1], out[2].clone()) for _ in range(16)]

            def fn(i, blocks=blocks):
                lc.merge_vals(*blocks[i % 16])
        medians = _medians(fn, refill)
        print(root, mode, card, " ".join(f"{m:.4f}" for m in medians), "ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
