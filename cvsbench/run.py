"""One run of one cell of the port's benchmark.

    python3 -m cvsbench.run --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout. It needs a CUDA card (and as many as
the cell asks for): without, it exits 2 and prints no result. The last
line of standard output is the result's JSON object; the last lines of
standard error are the numbers compared, each beside its limit.
"""

import time

_T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# modules whose presence after the window refuses the run, by whole
# top-level name (the port's own name begins with the last one's)
FORBIDDEN = ("jax", "jaxlib", "flax", "cudavideostream_tpu")


def cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    the port builds its kernels into ``build/kernels`` and
    ``build/native`` there itself."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(root / "build" / "cuda_cache")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m cvsbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    import torch

    from cvsbench import harness

    cell = harness.load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"cvsbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    result, lines = harness.run(cell, args.seed, args.seconds,
                                bool(args.trace), t0=_T0)
    found = forbidden_modules()
    if found:
        print(f"cvsbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
