#!/usr/bin/env python3
"""Where a 1080p visualizer step spends its device time.

    python3 tools/profile_visualizer_step.py [VISUALIZER ...]

For each visualizer number (default: 5, the binarize chain), runs 20
``DeltaStreamPipeline.step`` calls of that configuration at 1080p (~6%
changed bytes, the overlay text) under ``torch.profiler`` and prints the
device time per step of the 15 largest kernel and operator names, then the CUDA
event median of 30 steps with the queue held behind a sleep kernel (the
device alone) and without (device and host launch overhead). Needs a
CUDA card.
"""

import dataclasses
import pathlib
import statistics
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from cudavideostream_tpu_torch.config import StreamConfig, Visualizer  # noqa: E402
from cudavideostream_tpu_torch.models import DeltaStreamPipeline  # noqa: E402

STEPS = 20
# steps per event median: ~50 launches each, so that all of them fit the
# launch queue behind the sleep kernel (100 steps did not)
TIMED = 30


def _median_ms(fn, iters, backlog):
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    if backlog:
        torch.cuda._sleep(200_000_000)
    for i in range(iters):
        starts[i].record()
        fn(i)
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    modes = [int(a) for a in sys.argv[1:]] or [5]
    cfg = StreamConfig()
    rng = np.random.default_rng(2736)
    n = cfg.frame_bytes
    prev = rng.integers(0, 256, n, dtype=np.uint8)
    jump = rng.integers(30, 200, n) * rng.choice([-1, 1], n)
    noise = rng.integers(-15, 15, n, endpoint=True)
    cur = ((prev.astype(np.int32)
            + np.where(rng.random(n) < 0.06, jump, noise)) % 256)
    cur = torch.from_numpy(cur.astype(np.uint8)).cuda()
    prev0 = torch.from_numpy(prev).cuda()
    text = "FPS: 30 BW: 1234 kbps"
    for mode in modes:
        pipe = DeltaStreamPipeline(dataclasses.replace(
            cfg, visualizer=Visualizer(mode)))
        prevs = [prev0.clone() for _ in range(TIMED)]
        pipe.step(prev0.clone(), cur, text=text)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(STEPS):
                pipe.step(prevs[i], cur, text=text)
            torch.cuda.synchronize()
        rows = sorted(((e.device_time_total / STEPS / 1e3, e.count // STEPS,
                        e.key) for e in prof.key_averages()
                       if e.device_time_total > 0), reverse=True)
        print(f"--visualizer {mode}: device time per step by kernel "
              f"(ms, launches per step, name)")
        for ms, count, key in rows[:15]:
            print(f"  {ms:9.4f} {count:3d}  {key[:110]}")
        for p in prevs:
            p.copy_(prev0)
        dev_ms = _median_ms(lambda i: pipe.step(prevs[i], cur, text=text),
                            TIMED, True)
        for p in prevs:
            p.copy_(prev0)
        wall_ms = _median_ms(lambda i: pipe.step(prevs[i], cur, text=text),
                             TIMED, False)
        print(f"--visualizer {mode}: step {dev_ms:.4f} ms with the queue "
              f"held (device), {wall_ms:.4f} ms without (device and host)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
