"""What the per-layer metrics read: the device records of a traced slice
of graph replays, as ``torch.profiler`` gives them, and the counts of the
step that the harness holds.

A metric's reader (``metrics/<name>.py``) takes one :class:`Slice` and
returns a number, or None where the slice holds nothing for it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Tuple

MEMSET, MEMCPY = "Memset", "Memcpy"


@dataclasses.dataclass
class Record:
    name: str      # the profiler's name (a demangled kernel signature)
    start_us: float
    end_us: float

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us

    @property
    def op(self) -> str:
        return op_name(self.name)


@dataclasses.dataclass
class Slice:
    """A traced slice: its device records, sorted by start, the camera
    frames it stepped (steps x streams), the length of the slice and the
    step's sizes: ``frame_bytes`` n, ``pos_mean`` the changed bytes a
    camera frame (from the step's own output), ``stream`` the
    configuration's ``stream`` block."""
    records: List[Record]
    frames: int
    busy_s: float
    window_s: float
    frame_bytes: int
    pos_mean: float
    stream: Dict

    def seconds_per_frame(self, records: Iterable[Record]) -> float:
        return sum(r.dur_us for r in records) * 1e-6 / self.frames

    def of(self, names: Iterable[str]) -> List[Record]:
        """The records whose op (:func:`op_name`, before any ``[...]``)
        is one of ``names``."""
        names = set(names)
        return [r for r in self.records if r.op.split("[")[0] in names]


def op_name(name: str) -> str:
    """A profiler name made short: a kernel's base name, with the functor
    a generic PyTorch kernel runs (``void at::native::
    vectorized_elementwise_kernel<4, at::native::BitwiseAndFunctor<bool>,
    ...>(...)`` -> ``vectorized_elementwise_kernel[BitwiseAndFunctor]``);
    a memset or a copy by its kind (``Memcpy DtoD``)."""
    if name.startswith((MEMSET, MEMCPY)):
        return name.split(" (")[0]
    head = name.replace("(anonymous namespace)::", "")
    head = head[len("void "):] if head.startswith("void ") else head
    base = head.split("<")[0].split("(")[0].split("::")[-1].strip()
    for tail in ("Functor|functor", "_kernel_cuda|_kernel_impl"):
        inner = [w for w in re.findall(rf"(\w+(?:{tail}))\b", head)
                 if w != base]
        if inner:
            return f"{base}[{inner[0]}]"
    return base


def busy_us(records: List[Record]) -> float:
    """The union of the records' intervals, in microseconds."""
    total, end = 0.0, float("-inf")
    for r in sorted(records, key=lambda r: r.start_us):
        if r.end_us <= end:
            continue
        total += r.end_us - max(r.start_us, end)
        end = r.end_us
    return total


def span_us(records: List[Record]) -> float:
    """From the first record's start to the last one's end."""
    if not records:
        return 0.0
    return (max(r.end_us for r in records)
            - min(r.start_us for r in records))


def breakdown(records: List[Record], top: int = 10) -> Dict:
    """The device ops that took the most time and the longest idle gaps,
    each summed over the slice, in seconds: ``{"device_ops": [[op,
    s], ...], "idle_gaps": [["op -> op", s], ...]}``; a gap is named by
    the ops on either side of it."""
    ops: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    end, last = None, None
    for r in sorted(records, key=lambda r: r.start_us):
        ops[r.op] = ops.get(r.op, 0.0) + r.dur_us * 1e-6
        if end is not None and r.start_us > end:
            key = f"{last} -> {r.op}"
            gaps[key] = gaps.get(key, 0.0) + (r.start_us - end) * 1e-6
        if end is None or r.end_us > end:
            end, last = r.end_us, r.op
    return {"device_ops": _top(ops, top), "idle_gaps": _top(gaps, top)}


def _top(d: Dict[str, float], top: int) -> List[Tuple[str, float]]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
