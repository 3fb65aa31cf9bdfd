"""The comparison that decides ``correct``: the program's outputs against
the plain reference, each number beside its limit.

The reference is found by name: a configuration file may hold
``"reference": "<dotted module under cvsbench>"``; without the key it is
:mod:`cvsbench.reference`. The module's ``Step(stream, text)`` judges the
configuration. A ``Step`` has:

* ``height``, ``row_bytes`` and ``threshold``;
* ``frame_rows(raw, r0, r1)``: rows ``[r0, r1)`` of the frame the diff
  reads, from one flat raw camera frame;
* ``update(state, cur, feedback=None)``: one diff over a band of rows,
  the state updated in place; returns the band-local indices that ship
  and their deltas;
* ``outputs``: the side outputs the Step works out, a tuple of ``"aux"``
  (the visualizer's frame, n bytes a camera) and ``"bits"`` (the n/8-byte
  change bitmask of ``emit_bitmask``); empty on :mod:`cvsbench.reference`.
  The bits need no method: they are the mask ``update`` computes, and the
  check holds the program's bits (LSB first) against it itself, so every
  Step covers them whether it names them or not;
* where it works out ``"aux"``: ``prepare(raw) -> ctx``, the values that
  cover the whole frame (a histogram, a threshold), computed once for
  each camera frame of the last replay before the bands of rows run in
  threads (:class:`cvsbench.reference.Step` returns None), and
  ``aux_rows(cur_rows, prev_rows, r0, r1, ctx)``, the aux bytes of rows
  ``[r0, r1)``: ``cur_rows`` is what ``frame_rows`` gives, ``prev_rows``
  the state before that step's update.

The program hands over, as host arrays (:class:`Outputs`): the state
after its first replay from the base frame (``start``), the state that
entered the window's last replay (``entry``), every step of that last
replay (``pos``, the per-unit ``counts`` and the shipped ``xs`` and
``vals`` of each stream, its blocks read in order by their counts; and
``side``, the side outputs the configuration's step hands back,
:func:`side_outputs`) and the state after it (``final``). The reference
works out again, from the raw frames and the base frame that the harness
made:

* ``start_state_bytes``: the state after the bank's T frames from the
  base frame, byte for byte;
* ``entry_state_bytes``: what the window's earlier replays leave, which
  the reference cannot follow step by step: every byte of ``entry`` must
  lie within the threshold of the last frame's (the step guarantees it)
  and equal a value that byte has held (the base frame or one of the
  bank's frames);
* ``frames_mismatched``: the camera frames of the last replay, from
  ``entry``, whose pos, counts, indices or deltas differ;
* ``final_state_bytes``: the state after the last replay;
* for each side output, ``aux_frames_mismatched`` or
  ``bits_frames_mismatched``: the camera frames of the last replay whose
  output differs in any byte; reported only where the configuration's
  step has that output (:func:`limits`).

Every comparison is exact: each limit is 0. ``frames_failed``, not
compared, counts the camera frames that differ in any output.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

from cvsbench.reference import absdiff, bands

DEFAULT_REFERENCE = "cvsbench.reference"
# the numbers of every configuration: the payload's and the states'
LIMITS = {"start_state_bytes": 0, "entry_state_bytes": 0,
          "frames_mismatched": 0, "final_state_bytes": 0}
BANDS_PER_STREAM = 8


def side_outputs(stream: Dict) -> Tuple[str, ...]:
    """The side outputs the configuration's step hands back, beside its
    payload: ``aux`` where ``visualizer`` is not 0, ``bits`` under
    ``emit_bitmask``."""
    return tuple(name for name, on in (
        ("aux", int(stream["visualizer"]) != 0),
        ("bits", bool(stream.get("emit_bitmask")))) if on)


def limits(stream: Dict) -> Dict[str, int]:
    """Every number compared for a configuration (its ``stream`` block),
    with its limit: :data:`LIMITS` and one for each side output."""
    return dict(LIMITS, **{f"{name}_frames_mismatched": 0
                           for name in side_outputs(stream)})


def reference_step(config: Dict, stream: Dict):
    """The reference step of a configuration, for its ``stream`` block
    (as run) and status text: ``Step`` of the module that the
    configuration's ``reference`` names. Refuses a module outside
    ``cvsbench`` and a Step that does not work out a side output the
    configuration's step hands back."""
    name = config.get("reference", DEFAULT_REFERENCE)
    if not name.startswith("cvsbench."):
        raise ValueError(f"reference {name!r}: the reference is a module "
                         "under cvsbench")
    step = importlib.import_module(name).Step(stream, config["text"])
    missing = [s for s in side_outputs(stream)
               if s != "bits" and s not in getattr(step, "outputs", ())]
    if missing:
        raise ValueError(f"{name}.Step does not work out {', '.join(missing)}"
                         f", which configuration {config.get('name')!r} "
                         "hands back: name a reference that does")
    return step


@dataclasses.dataclass
class Outputs:
    """One side's outputs as host arrays: states ``(B, n)`` uint8; ``pos``
    ``(T, B)``; ``counts[t][b]``, ``xs[t][b]`` (int64 or int32) and
    ``vals[t][b]`` (uint8) for step t of the last replay; ``side[name][t][b]``
    (uint8) for each side output: ``aux`` n bytes, ``bits`` the packed
    bits, LSB first, padded with zero bits."""
    start: np.ndarray
    entry: np.ndarray
    final: np.ndarray
    pos: np.ndarray
    counts: List[List[np.ndarray]]
    xs: List[List[np.ndarray]]
    vals: List[List[np.ndarray]]
    side: Dict[str, List[List[np.ndarray]]] = dataclasses.field(
        default_factory=dict)


def _bits(packed: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Bits ``[lo, hi)`` of an LSB-first bitmask, as bools (short where
    the bitmask is)."""
    first = lo // 8
    got = np.unpackbits(packed[first:-(-hi // 8)], bitorder="little")
    return got[lo - 8 * first:hi - 8 * first].astype(bool)


def _band(step, frames: np.ndarray, base: np.ndarray, out: Outputs,
          ctx: Dict, b: int, r0: int, r1: int) -> Dict:
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
    bad_side = {name: [] for name in out.side}
    for t, c in enumerate(cur):
        prev = state.copy() if "aux" in out.side else None
        xs, vals = step.update(state, c)
        pxs = out.xs[t][b]
        i0, i1 = np.searchsorted(pxs, [lo, hi])
        covered.append(int(i1 - i0))
        if not (np.array_equal(pxs[i0:i1] - lo, xs)
                and np.array_equal(out.vals[t][b][i0:i1], vals)):
            bad_steps.append(t)
        if "aux" in out.side and not np.array_equal(
                out.side["aux"][t][b][lo:hi],
                step.aux_rows(c, prev, r0, r1, ctx[t, b])):
            bad_side["aux"].append(t)
        if "bits" in out.side:
            mask = np.zeros(hi - lo, bool)
            mask[xs] = True
            if not np.array_equal(_bits(out.side["bits"][t][b], lo, hi),
                                  mask):
                bad_side["bits"].append(t)
    final_bad = int(np.count_nonzero(state != out.final[b, lo:hi]))
    return {"b": b, "start": start_bad, "entry": entry_bad,
            "final": final_bad, "bad_steps": bad_steps, "covered": covered,
            "bad_side": bad_side}


def _side_whole(name: str, arr: np.ndarray, n: int) -> bool:
    """What the bands cannot see: an aux frame of n bytes; no bit set past
    the frame's n bytes."""
    if name == "aux":
        return arr.size == n
    return not np.unpackbits(arr[n // 8:], bitorder="little")[n % 8:].any()


def compare(step, frames: np.ndarray, base: np.ndarray,
            out: Outputs, unit_bytes: int) -> Dict:
    """Every number of the module's docstring, ``{name: value}``, from the
    raw ``frames`` ``(T, B, n)`` and ``base`` ``(B, n)``, with one for each
    side output in ``out.side``, and ``frames_failed``. The Step's
    ``prepare`` and then the bands of rows run in threads, one a CPU (at
    most 8)."""
    T, B, n = frames.shape
    jobs = [(b, r0, r1) for b in range(B)
            for r0, r1 in bands(step.height, BANDS_PER_STREAM)]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        ctx = {}
        if "aux" in out.side:
            keys = [(t, b) for t in range(T) for b in range(B)]
            ctx = dict(zip(keys, pool.map(
                lambda k: step.prepare(frames[k]), keys)))
        parts = list(pool.map(
            lambda j: _band(step, frames, base, out, ctx, *j), jobs))
    bad = set()
    bad_side = {name: set() for name in out.side}
    covered = np.zeros((T, B), np.int64)
    for p in parts:
        bad.update((t, p["b"]) for t in p["bad_steps"])
        for name, steps in p["bad_side"].items():
            bad_side[name].update((t, p["b"]) for t in steps)
        covered[:, p["b"]] += p["covered"]
    for t in range(T):
        for b in range(B):
            for name in out.side:
                if not _side_whole(name, out.side[name][t][b], n):
                    bad_side[name].add((t, b))
            xs = out.xs[t][b]
            if xs.size and xs.min() < 0:
                bad.add((t, b))
                continue
            units = np.bincount(xs // unit_bytes,
                                minlength=out.counts[t][b].size)
            if (covered[t, b] != xs.size or out.pos[t, b] != xs.size
                    or not np.array_equal(units, out.counts[t][b])):
                bad.add((t, b))
    numbers = {"start_state_bytes": sum(p["start"] for p in parts),
               "entry_state_bytes": sum(p["entry"] for p in parts),
               "frames_mismatched": len(bad),
               "final_state_bytes": sum(p["final"] for p in parts)}
    for name, frames_bad in bad_side.items():
        numbers[f"{name}_frames_mismatched"] = len(frames_bad)
        bad |= frames_bad
    numbers["frames_failed"] = len(bad)
    return numbers


def verdict(numbers: Dict, stream: Dict) -> bool:
    """True where every number of the configuration is there and within
    its limit."""
    return all(numbers.get(k) is not None and numbers[k] <= v
               for k, v in limits(stream).items())


def lines(numbers: Dict, stream: Dict) -> List[str]:
    """One line a number, with its limit."""
    return [f"check {k}: {numbers.get(k)} (limit {v})"
            for k, v in limits(stream).items()]


def as_json(numbers: Dict, stream: Dict) -> Dict:
    return {k: {"value": numbers.get(k), "limit": v}
            for k, v in limits(stream).items()}


def simulate(step, frames: np.ndarray, base: np.ndarray, replays: int,
             unit_bytes: int, feedback: bool,
             sides: Sequence[str] = ()) -> Outputs:
    """The reference put in the program's place: ``replays`` replays of
    the bank from the base frame (at least 3: the first, the window's,
    the last), with ``feedback`` as given (False breaks the
    configuration's negative feedback: the control), working out each
    side output in ``sides`` (the configuration's, :func:`side_outputs`)
    in the last. Returns what the program would hand over."""
    T, B, n = frames.shape
    state = base.copy()
    start = entry = None
    pos = np.zeros((T, B), np.int64)
    xs_out = [[None] * B for _ in range(T)]
    vals_out = [[None] * B for _ in range(T)]
    counts = [[None] * B for _ in range(T)]
    side = {name: [[None] * B for _ in range(T)] for name in sides}
    units = -(-n // unit_bytes)
    for r in range(max(3, replays)):
        last = r == max(3, replays) - 1
        if last:
            entry = state.copy()
        for t in range(T):
            for b in range(B):
                cur = step.frame_rows(frames[t, b], 0, step.height)
                prev = state[b].copy() if last and "aux" in side else None
                xs, vals = step.update(state[b], cur, feedback=feedback)
                if not last:
                    continue
                pos[t, b] = xs.size
                xs_out[t][b], vals_out[t][b] = xs, vals
                counts[t][b] = np.bincount(xs // unit_bytes, minlength=units)
                if "aux" in side:
                    side["aux"][t][b] = step.aux_rows(
                        cur, prev, 0, step.height,
                        step.prepare(frames[t, b]))
                if "bits" in side:
                    mask = np.zeros(n, bool)
                    mask[xs] = True
                    side["bits"][t][b] = np.packbits(mask,
                                                     bitorder="little")
        if r == 0:
            start = state.copy()
    return Outputs(start=start, entry=entry, final=state, pos=pos,
                   counts=counts, xs=xs_out, vals=vals_out, side=side)
