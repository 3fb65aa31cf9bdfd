#!/usr/bin/env python3
"""Time the K1 emissions, K2 and K3 of one checkout, at 1080p.

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
* ``pair``: K2 (``merge_tiles``) on the ``tiled`` blocks of the same frame,
  4 copies in turn (31 MB each), so they are cold in L2;
* ``vals``: K3 (``merge_vals``) on the ``mask`` blocks, 16 copies in turn.

To compare two commits, unpack the other one into a git-ignored directory
(``git archive COMMIT | tar -x -C build/parent``) and time both in one
call to one card, in turns::

    for t in build/parent . . build/parent; do
        python3 tools/time_k1_flat.py "$(cd $t && pwd)" flat pair; done
"""

import statistics
import sys

import numpy as np
import torch

MODES = ("flat", "map", "tiled", "mask", "batched", "pair", "vals")


def _medians(fn, refill=None):
    """Five medians of 100 CUDA-event-timed calls of ``fn(i)``."""
    fn(0)
    medians = []
    for _ in range(5):
        if refill is not None:
            refill()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(100)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(100)]
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        for i in range(100):
            starts[i].record()
            fn(i)
            ends[i].record()
        torch.cuda.synchronize()
        medians.append(statistics.median(
            a.elapsed_time(b) for a, b in zip(starts, ends)))
    return medians


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
    for mode in modes:
        refill = None
        if mode in ("flat", "map", "tiled", "mask", "batched"):
            b = 4 if mode == "batched" else 1
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
            }[mode]

            def fn(i, k1=k1, curs=curs, prevs=prevs):
                k1(curs[i % 8], prevs[i])
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
        print(root, mode, torch.cuda.get_device_name(0),
              " ".join(f"{m:.4f}" for m in medians), "ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
