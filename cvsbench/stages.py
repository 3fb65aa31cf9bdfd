"""The step's stages on the traced slice: each graph replay's device
records labelled with the stage of the port's step that launched them.

    python3 -m cvsbench.stages --workload CELL --seeds N [N ...]

A graph replay runs no host code, so the port's stage spans
(``cudavideostream_tpu_torch.utils.profiling.STAGES``) never show in a
slice of replays. The capture is one stream, so each replay's device
records come in the order of one eager pass's launches. One eager pass
of the bank's T steps under ``profiling.trace_stages``, on a clone of the
state and on the chain's stream, labels every device node of the graph
with its stage (:func:`stage_pass`); the slice's records take the labels
by their position modulo the graph's nodes (:func:`label`). The eager
pass also puts the program's spans and its device records on one clock,
so each idle gap of the eager step can be put down to the host span open
when it began (:func:`eager_idle_by_host`): the served path's view, which
the replayed slice cannot give.

For each seed the command sets a cell up as a run does, takes the traced
slice (``harness.traced_slice``), then the eager pass, and prints one
JSON line: the three stage keys of a run's ``breakdown`` (``stage_ops``,
``stage_gaps``, ``eager_idle_by_host``), the ops each stage holds,
``overlay_ms`` (``metrics/overlay_ms.py``) beside ``torch_ops_ms``, and
one note line on standard error. It needs a card and the port's stage
spans; the benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cvsbench import harness, scene, trace

OUTSIDE = "outside"  # a record no stage span encloses (profiling.OUTSIDE)


def same_kind(op: str) -> str:
    """An op as a graph replay and an eager pass both name it: a graph's
    copy and set nodes run as the driver's own kernels
    (``memcpy32_post``), where an eager pass records ``Memcpy DtoD``."""
    low = op.lower()
    for kind in ("memcpy", "memset"):
        if low.startswith(kind):
            return kind
    return op


def label(records: List[trace.Record], eager: Sequence[Tuple],
          nodes: Optional[int], replays: int) -> Optional[List[str]]:
    """The stage of each of the slice's ``records``: that of the eager
    record ``(name, start_us, end_us, stage)`` at its position modulo the
    graph's ``nodes``. None unless the eager pass holds exactly ``nodes``
    records, the slice is whole (``nodes`` x ``replays``) and each
    record's op is the eager one's at its position."""
    if (not nodes or len(eager) != nodes
            or len(records) != nodes * replays):
        return None
    ops = [same_kind(trace.op_name(e[0])) for e in eager]
    if any(same_kind(r.op) != ops[i % nodes] for i, r in enumerate(records)):
        return None
    return [eager[i % nodes][3] for i in range(len(records))]


def stage_breakdown(records: List[trace.Record], stages: List[str],
                    top: int = 10) -> Dict:
    """``trace.breakdown`` by stage: ``{"stage_ops": [[stage, s], ...],
    "stage_gaps": [["stage -> stage", s], ...]}``, device seconds and idle
    seconds summed over the slice."""
    ops: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    end, last = None, None
    for r, st in sorted(zip(records, stages), key=lambda p: p[0].start_us):
        ops[st] = ops.get(st, 0.0) + r.dur_us * 1e-6
        if end is not None and r.start_us > end:
            key = f"{last} -> {st}"
            gaps[key] = gaps.get(key, 0.0) + (r.start_us - end) * 1e-6
        if end is None or r.end_us > end:
            end, last = r.end_us, st
    return {"stage_ops": trace._top(ops, top),
            "stage_gaps": trace._top(gaps, top)}


def eager_idle_by_host(eager: Sequence[Tuple], spans: Sequence[Tuple],
                       top: int = 10) -> List[List]:
    """The eager pass's idle device seconds, each gap put down to the
    innermost ``cvs.`` host span (``(name, start_us, end_us, args)``) open
    when it began, or ``outside``: ``[[span, s], ...]``."""
    idle: Dict[str, float] = {}
    end = None
    for name, start, stop, _ in sorted(eager, key=lambda e: e[1]):
        if end is not None and start > end:
            host = OUTSIDE
            for s in spans:  # in start order: the last open one is inmost
                if s[1] <= end <= s[2]:
                    host = s[0]
            idle[host] = idle.get(host, 0.0) + (start - end) * 1e-6
        if end is None or stop > end:
            end = stop
    return trace._top(idle, top)


def stage_pass(chain: harness.Chain, nodes: Optional[int]):
    """One eager pass of the bank's T steps under ``trace_stages`` on a
    clone of the state, on the chain's stream, its outputs discarded;
    taken again (at most ``harness.TRACE_ATTEMPTS`` times) while it holds
    another number of device records than the graph's ``nodes``. Returns
    ``(records, spans, attempts)``."""
    from cudavideostream_tpu_torch.utils.profiling import trace_stages

    state = chain.state.clone()

    def steps():
        for t in range(chain.bank.shape[0]):
            chain.program.step(state, chain.bank[t])

    chain.sync()
    with torch.cuda.stream(chain.stream):
        for attempt in range(1, harness.TRACE_ATTEMPTS + 1):
            records, spans = trace_stages(steps, state.device)
            if nodes is None or len(records) == nodes:
                break
    return records, spans, attempt


def staged(cell: harness.Cell, seed: int) -> Dict:
    """One seed of ``cell``: the traced slice, the eager stage pass and
    what :func:`label` makes of them."""
    dev = torch.device("cuda", 0)
    traffic, config = cell.traffic, cell.config
    stream = dict(config["stream"])
    streams, replays = int(traffic["streams"]), int(traffic["trace_replays"])
    h, w = stream["height"], stream["width"]
    bank, base = scene.make_bank(traffic, h, w, seed, dev)
    program = harness.Program(stream, streams, config["text"], dev)
    chain = harness.Chain(program, bank, base.reshape(-1).clone())
    for _ in range(1 + int(traffic["warm_replays"])):
        chain.replay()
    records, attempts, nodes = harness.traced_slice(chain, replays)
    eager, spans, eager_attempts = stage_pass(chain, nodes)
    stages = label(records, eager, nodes, replays)
    out = {"workload": cell.name, "seed": seed, "nodes": nodes,
           "slice_records": len(records), "slice_attempts": attempts,
           "eager_records": len(eager), "eager_attempts": eager_attempts,
           "labelled": stages is not None}
    note = (f"stages: {len(eager)} eager device records for {nodes} graph "
            f"nodes, {eager_attempts} attempt(s); ")
    if stages is None:
        print(note + "the slice is not labelled", file=sys.stderr)
        return out
    # the stage metrics read neither the payload's size nor the busy time
    sl = trace.Slice(records=records,
                     frames=replays * int(traffic["bank_frames"]) * streams,
                     busy_s=trace.busy_us(records) * 1e-6,
                     window_s=trace.span_us(records) * 1e-6,
                     frame_bytes=h * w * 3, pos_mean=0.0, stream=stream)
    sl.stages = stages
    by_stage: Dict[str, List[str]] = {}
    for r, st in zip(records, stages):
        if r.op not in by_stage.setdefault(st, []):
            by_stage[st].append(r.op)
    out.update(stage_breakdown(records, stages))
    out["eager_idle_by_host"] = eager_idle_by_host(eager, spans)
    out["ops_by_stage"] = by_stage
    for name in ("overlay_ms", "torch_ops_ms"):
        out[name] = importlib.import_module(
            f"cvsbench.metrics.{name}").read(sl)
    print(note + f"{len(records)} slice records labelled over "
          f"{sl.frames} camera frames", file=sys.stderr)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m cvsbench.stages",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from cvsbench import run

    run.cache_dirs()
    if not torch.cuda.is_available():
        print("cvsbench.stages: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(staged(cell, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
