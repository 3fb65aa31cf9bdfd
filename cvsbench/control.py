"""The control of the comparison: the configuration's plain reference
(``check.reference_step``) put in the program's place with the
configuration's negative feedback switched off (every state byte takes
the new frame's value), one guarantee that every configuration states,
and the side outputs worked out from that state. The comparison must come
out not correct.

    python3 -m cvsbench.control --workload CELL --seeds N [N ...]

It makes each seed's bank on the card as a run does, runs the broken
reference for three replays of the bank (the first, one for the window,
the last) and prints, for each seed, every number compared beside its
limit and the verdict, then one JSON line of all of them. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from cvsbench import check, harness, scene


def control(cell: harness.Cell, seed: int, device: str = "cuda",
            feedback: bool = False):
    """The numbers of one seed with the reference (``feedback`` as given)
    in the program's place."""
    stream = dict(cell.config["stream"])
    if device == "cpu":
        stream.update(height=harness.CPU_HEIGHT, width=harness.CPU_WIDTH)
    bank, base = scene.make_bank(cell.traffic, stream["height"],
                                 stream["width"], seed, torch.device(device))
    frames, base = bank.cpu().numpy(), base.cpu().numpy()
    del bank
    unit_bytes = 128 * int(stream["subtile_rows"])
    # the configuration's own reference, with every side output its step
    # hands back
    step = check.reference_step(cell.config, stream)
    out = check.simulate(step, frames, base, 3, unit_bytes,
                         feedback=feedback,
                         sides=check.side_outputs(stream))
    return check.compare(step, frames, base, out, unit_bytes)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m cvsbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    stream = cell.config["stream"]
    readings = {}
    for seed in args.seeds:
        t = time.perf_counter()
        numbers = control(cell, seed)
        ok = check.verdict(numbers, stream)
        for line in check.lines(numbers, stream):
            print(f"{args.workload} seed {seed}: {line}", file=sys.stderr)
        print(f"{args.workload} seed {seed}: correct {ok} "
              f"({time.perf_counter() - t:.1f} s)", file=sys.stderr)
        readings[seed] = dict(numbers, correct=ok)
    print(json.dumps({"workload": args.workload, "control": "negative "
                      "feedback off", "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
