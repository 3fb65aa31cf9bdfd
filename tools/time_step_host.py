#!/usr/bin/env python3
"""Time the host side of one checkout's eager step, with no profiler and
with one recording.

    python3 tools/time_step_host.py CHECKOUT_ROOT [STEPS] [REPS]

Imports ``cudavideostream_tpu_torch`` and ``cvsbench`` from
``CHECKOUT_ROOT`` and drives the step of the benchmark cell
``cvs_1080p.cam1`` (``cvsbench.harness.Program``: one 1080p camera, the
status text, K1's tiled emission) eagerly over the cell's bank of 64
frames on the card, STEPS steps a repetition (default 1,000). It prints
one JSON line: for REPS repetitions (default 5) with no profiler, then
REPS inside one ``torch.profiler`` session each (CPU and CUDA activity),
the host microseconds a step to enqueue the steps and to the
synchronise after them. Run two checkouts in turns to compare them.
"""

import json
import os
import sys
import time

SEED = 2_147_483_929


def _pass(program, state, bank, steps: int):
    """``(enqueue us, wall us)`` a step of ``steps`` eager steps."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        program.step(state, bank[i % bank.shape[0]])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return 1e6 * (t1 - t0) / steps, 1e6 * (t2 - t0) / steps


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import cudavideostream_tpu_torch
    from cvsbench import harness, run, scene

    if not cudavideostream_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {cudavideostream_tpu_torch.__file__}, "
                           f"not the package under {root}")
    run.cache_dirs()
    cell = harness.load_cell("cvs_1080p.cam1")
    dev = torch.device("cuda", 0)
    stream = cell.config["stream"]
    bank, base = scene.make_bank(cell.traffic, stream["height"],
                                 stream["width"], SEED, dev)
    program = harness.Program(stream, 1, cell.config["text"], dev)
    state = base.reshape(-1).clone()
    _pass(program, state, bank, 2 * bank.shape[0])  # build and warm up
    plain = [_pass(program, state, bank, steps) for _ in range(reps)]
    traced = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            traced.append(_pass(program, state, bank, steps))
    print(json.dumps({"checkout": root, "steps": steps,
                      "device": torch.cuda.get_device_name(dev),
                      "no_profiler_us": plain, "profiler_us": traced}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
