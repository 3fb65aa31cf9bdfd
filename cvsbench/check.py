"""The comparison that decides ``correct``: the program's outputs against
the plain reference (:mod:`cvsbench.reference`), each number beside its
limit.

The program hands over, as host arrays (:class:`Outputs`): the state
after its first replay from the base frame (``start``), the state that
entered the window's last replay (``entry``), every step of that last
replay (``pos``, the per-unit ``counts`` and the shipped ``xs`` and
``vals`` of each stream, its blocks read in order by their counts) and
the state after it (``final``). The reference works out again, from the
raw frames and the base frame that the harness made:

* ``start_state_bytes``: the state after the bank's T frames from the
  base frame, byte for byte;
* ``entry_state_bytes``: what the window's earlier replays leave, which
  the reference cannot follow step by step: every byte of ``entry`` must
  lie within the threshold of the last frame's (the step guarantees it)
  and equal a value that byte has held (the base frame or one of the
  bank's frames);
* ``frames_mismatched``: the camera frames of the last replay, from
  ``entry``, whose pos, counts, indices or deltas differ;
* ``final_state_bytes``: the state after the last replay.

Every comparison is exact: each limit is 0.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from cvsbench.reference import Step, absdiff, bands


def reference_step(config: Dict, stream: Dict) -> Step:
    """The reference step of a configuration, for its ``stream`` block
    (as run) and status text."""
    return Step(stream, config["text"])


LIMITS = {"start_state_bytes": 0, "entry_state_bytes": 0,
          "frames_mismatched": 0, "final_state_bytes": 0}
BANDS_PER_STREAM = 8


@dataclasses.dataclass
class Outputs:
    """One side's outputs as host arrays: states ``(B, n)`` uint8; ``pos``
    ``(T, B)``; ``counts[t][b]``, ``xs[t][b]`` (int64 or int32) and
    ``vals[t][b]`` (uint8) for step t of the last replay."""
    start: np.ndarray
    entry: np.ndarray
    final: np.ndarray
    pos: np.ndarray
    counts: List[List[np.ndarray]]
    xs: List[List[np.ndarray]]
    vals: List[List[np.ndarray]]


def _band(step: Step, frames: np.ndarray, base: np.ndarray,
          out: Outputs, b: int, r0: int, r1: int) -> Dict:
    """Stream ``b``'s rows ``[r0, r1)`` through every check."""
    lo, hi = r0 * step.row_bytes, r1 * step.row_bytes
    T = frames.shape[0]
    cur = [step.frame_rows(frames[t, b], r0, r1) for t in range(T)]
    state = base[b, lo:hi].copy()
    for c in cur:
        step.update(state, c)
    start_bad = int(np.count_nonzero(state != out.start[b, lo:hi]))

    entry = out.entry[b, lo:hi]
    last = cur[-1]
    gap = absdiff(entry, last)
    held = entry == base[b, lo:hi]
    for c in cur:
        held |= entry == c
    entry_bad = int(np.count_nonzero((gap > step.threshold) | ~held))

    state = entry.copy()
    bad_steps, covered = [], []
    for t, c in enumerate(cur):
        xs, vals = step.update(state, c)
        pxs = out.xs[t][b]
        i0, i1 = np.searchsorted(pxs, [lo, hi])
        covered.append(int(i1 - i0))
        if not (np.array_equal(pxs[i0:i1] - lo, xs)
                and np.array_equal(out.vals[t][b][i0:i1], vals)):
            bad_steps.append(t)
    final_bad = int(np.count_nonzero(state != out.final[b, lo:hi]))
    return {"b": b, "start": start_bad, "entry": entry_bad,
            "final": final_bad, "bad_steps": bad_steps, "covered": covered}


def compare(step: Step, frames: np.ndarray, base: np.ndarray,
            out: Outputs, unit_bytes: int) -> Dict:
    """Every number of the module's docstring, ``{name: value}``, from the
    raw ``frames`` ``(T, B, n)`` and ``base`` ``(B, n)``. The bands of
    rows run in threads, one a CPU (at most 8)."""
    T, B, n = frames.shape
    jobs = [(b, r0, r1) for b in range(B)
            for r0, r1 in bands(step.height, BANDS_PER_STREAM)]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        parts = list(pool.map(
            lambda j: _band(step, frames, base, out, *j), jobs))
    bad = set()
    covered = np.zeros((T, B), np.int64)
    for p in parts:
        bad.update((t, p["b"]) for t in p["bad_steps"])
        covered[:, p["b"]] += p["covered"]
    for t in range(T):
        for b in range(B):
            xs = out.xs[t][b]
            if xs.size and xs.min() < 0:
                bad.add((t, b))
                continue
            units = np.bincount(xs // unit_bytes,
                                minlength=out.counts[t][b].size)
            if (covered[t, b] != xs.size or out.pos[t, b] != xs.size
                    or not np.array_equal(units, out.counts[t][b])):
                bad.add((t, b))
    return {"start_state_bytes": sum(p["start"] for p in parts),
            "entry_state_bytes": sum(p["entry"] for p in parts),
            "frames_mismatched": len(bad),
            "final_state_bytes": sum(p["final"] for p in parts)}


def verdict(numbers: Dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def lines(numbers: Dict) -> List[str]:
    """One line a number, with its limit."""
    return [f"check {k}: {numbers[k]} (limit {LIMITS[k]})" for k in LIMITS]


def as_json(numbers: Dict) -> Dict:
    return {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}


def simulate(step: Step, frames: np.ndarray, base: np.ndarray,
             replays: int, unit_bytes: int, feedback: bool) -> Outputs:
    """The reference put in the program's place: ``replays`` replays of
    the bank from the base frame (at least 3: the first, the window's,
    the last), with ``feedback`` as given (False breaks the
    configuration's negative feedback: the control). Returns what the
    program would hand over."""
    T, B, n = frames.shape
    state = base.copy()
    start = entry = None
    pos = np.zeros((T, B), np.int64)
    xs_out = [[None] * B for _ in range(T)]
    vals_out = [[None] * B for _ in range(T)]
    counts = [[None] * B for _ in range(T)]
    units = -(-n // unit_bytes)
    for r in range(max(3, replays)):
        last = r == max(3, replays) - 1
        if last:
            entry = state.copy()
        for t in range(T):
            for b in range(B):
                cur = step.frame_rows(frames[t, b], 0, step.height)
                xs, vals = step.update(state[b], cur, feedback=feedback)
                if last:
                    pos[t, b] = xs.size
                    xs_out[t][b], vals_out[t][b] = xs, vals
                    counts[t][b] = np.bincount(xs // unit_bytes,
                                               minlength=units)
        if r == 0:
            start = state.copy()
    return Outputs(start=start, entry=entry, final=state, pos=pos,
                   counts=counts, xs=xs_out, vals=vals_out)
