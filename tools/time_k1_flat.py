#!/usr/bin/env python3
"""Time K1's flat emission (``fused_diff_compact``), or with ``tiled``
its tiled emission at ``subtile_rows=1`` (``fused_diff_compact_tiled``),
of one checkout.

    python3 tools/time_k1_flat.py CHECKOUT_ROOT [flat|tiled]

Imports ``cudavideostream_tpu_torch`` from ``CHECKOUT_ROOT`` and prints
five medians, each of 100 CUDA-event-timed launches at 1080p (~6% changed
bytes plus a 288,000-byte overlay region, ``prev`` fresh and ``cur``
rotated over 8 copies, so both are cold in L2), with the queue held behind
a sleep kernel so that the events time the device alone.

To compare two commits, unpack the other one into a git-ignored directory
(``git archive COMMIT | tar -x -C build/parent``) and time both in one
call to one card, in turns::

    for t in build/parent . . build/parent; do
        python3 tools/time_k1_flat.py "$(cd $t && pwd)" tiled; done
"""

import statistics
import sys

import numpy as np
import torch


def main() -> int:
    root = sys.argv[1]
    emission = sys.argv[2] if len(sys.argv) > 2 else "flat"
    sys.path.insert(0, root)
    import cudavideostream_tpu_torch
    from cudavideostream_tpu_torch.ops import logcompact

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
    prevs = [p0.clone() for _ in range(100)]
    curs = [c0.clone() for _ in range(8)]
    k1 = {"flat": logcompact.fused_diff_compact,
          "tiled": lambda c, p, *a: logcompact.fused_diff_compact_tiled(
              c, p, *a, 1)}[emission]
    k1(c0, p0.clone(), 20, True, region)
    medians = []
    for _ in range(5):
        for p in prevs:
            p.copy_(p0)
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(100)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(100)]
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        for i in range(100):
            starts[i].record()
            k1(curs[i % 8], prevs[i], 20, True, region)
            ends[i].record()
        torch.cuda.synchronize()
        medians.append(statistics.median(
            a.elapsed_time(b) for a, b in zip(starts, ends)))
    print(root, emission, torch.cuda.get_device_name(0),
          " ".join(f"{m:.4f}" for m in medians), "ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
