"""Profiling and tracing helpers: parity with the reference's nvprof
wiring (``make prof`` -> ``sudo nvprof ./server``, server/Makefile:58-59,
and the awk extraction in ``tests/*/kernel_test.sh``), and the PyTorch
port of the JAX package's ``utils/profiling.py``.

``trace`` records a ``torch.profiler`` trace (CPU and CUDA activities on
the card) and writes it as a Chrome trace, viewable in Perfetto or
``chrome://tracing``. ``annotate`` is the port's one span API: the steps
of ``models/pipeline.py`` and ``models/batched.py`` wrap each layer of a
frame in a span named from :data:`STAGES`, inside one :data:`STEP` span.
A span costs one flag read while no profiler records. ``trace_stages``
runs a callable once under the profiler and puts each device record down
to the stage whose span was open on the host when its launch was made.
The amortized wall-clock harness is
:mod:`cudavideostream_tpu_torch.utils.timing`.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.json"

# The step's stages, in the order a step runs them:
#   cvs.upload      the frame onto the device (a host frame's copy up);
#                   on the batched per-stream path, each stream's views
#                   of the frames and the state;
#   cvs.filter      the noise filter, K8;
#   cvs.overlay     the text strip(s): one K14 launch (overlay_blit, or
#                   the batched step's overlay_blit_streams for every
#                   stream) and the upload of a new text's glyph ids;
#   cvs.visualizer  the aux frame: K9, K11-K13; on the batched
#                   per-stream path, the aux frames' torch.cat;
#   cvs.compact     K1 in any emission; under SORT the strip substituted
#                   into the frame, diff_mask, the state copy and the
#                   sort; under HOST K10; on the batched per-stream path,
#                   the payloads' torch.stack;
#   cvs.host_pack   the HOST backend's fetches to the host, its host
#                   overlay and the native packers.
STAGES = ("cvs.upload", "cvs.filter", "cvs.overlay", "cvs.visualizer",
          "cvs.compact", "cvs.host_pack")
# One step call; its args carry the pipeline's step sequence number and
# its stream count, which the step's stage spans share.
STEP = "cvs.step"
# The stage of a device record that no stage span encloses.
OUTSIDE = "outside"

HostSpan = Tuple[str, float, float, Optional[Dict]]
DeviceRecord = Tuple[str, float, float, str]

_OFF = contextlib.nullcontext()
# while trace_stages records: each span's (name, args), in entry order
_span_log: Optional[List[Tuple[str, Optional[Dict]]]] = None


class _Span:
    __slots__ = ("name", "args", "_rf")

    def __init__(self, name: str, args: Optional[Dict]):
        self.name, self.args = name, args
        self._rf = torch.profiler.record_function(
            name, None if args is None else json.dumps(args))

    def __enter__(self):
        if _span_log is not None:
            _span_log.append((self.name, self.args))
        return self._rf.__enter__()

    def __exit__(self, *exc):
        return self._rf.__exit__(*exc)


def annotate(name: str, args: Optional[Dict] = None):
    """A named span (``record_function``) with ``args``, while a profiler
    records; otherwise one flag read and a shared no-op context, so the
    served path's eager steps pay nothing for their spans."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)


@contextlib.contextmanager
def trace(logdir: str, device=None) -> Iterator[str]:
    """Record a ``torch.profiler`` trace around a code block and write it
    as ``logdir/trace.json`` (a Chrome trace).

    Usage::

        with profiling.trace("build/trace") as d:
            run_frames()
        # d/trace.json: open in Perfetto or chrome://tracing

    It records the CPU and the card's CUDA activity, and raises when
    there is no CUDA device, unless the caller asks for the CPU
    (``device="cpu"``: CPU activity only)."""
    from torch.profiler import ProfilerActivity, profile

    from cudavideostream_tpu_torch.models.pipeline import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def trace_stages(run: Callable[[], object], device=None
                 ) -> Tuple[List[DeviceRecord], List[HostSpan]]:
    """Run ``run()`` once under ``torch.profiler`` (CPU activity, and CUDA
    activity on the card) on one host thread, and return ``(records,
    spans)`` on the profiler's clock, in microseconds:

    * ``records``: the device's kernels, memsets and copies in start
      order, each ``(name, start_us, end_us, stage)``; ``stage`` is that
      of the innermost :data:`STAGES` span open when the record's launch
      was made (the runtime call the record correlates with), else
      :data:`OUTSIDE`;
    * ``spans``: the ``cvs.`` spans in start order, each ``(name,
      start_us, end_us, args)``.

    On the CPU it returns no device records."""
    from torch.profiler import ProfilerActivity, profile

    from cudavideostream_tpu_torch.models.pipeline import resolve_device

    global _span_log
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    log: List[Tuple[str, Optional[Dict]]] = []
    _span_log = log
    try:
        with profile(activities=activities) as prof:
            run()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    finally:
        _span_log = None
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in events if e.device_type == cpu
                    and e.name.startswith("cvs.")),
                   key=lambda s: (s[1], -s[2]))
    # the profiler drops a span's args: they come from the spans' own log
    if [s[0] for s in spans] == [name for name, _ in log]:
        spans = [(*s, args) for s, (_, args) in zip(spans, log)]
    else:
        spans = [(*s, None) for s in spans]
    launches = {e.id: e.time_range.start for e in events
                if e.device_type == cpu and e.name.startswith("cu")}
    device_events = sorted(
        (e for e in events if e.device_type != cpu
         and not e.name.startswith("cvs.")
         and not getattr(e, "is_user_annotation", False)),
        key=lambda e: e.time_range.start)
    records = attribute(
        [(e.name, e.time_range.start, e.time_range.end, e.id)
         for e in device_events], launches, spans)
    return records, spans


def attribute(device: List[Tuple[str, float, float, int]],
              launches: Dict[int, float],
              spans: List[HostSpan]) -> List[DeviceRecord]:
    """Each device record ``(name, start_us, end_us, correlation)`` with
    its stage: the innermost :data:`STAGES` span of ``spans`` open at the
    host time of its launch, ``launches[correlation]``; :data:`OUTSIDE`
    where no stage span was open or no launch correlates."""
    stages = sorted((s for s in spans if s[0] in STAGES),
                    key=lambda s: s[1])
    starts = [s[1] for s in stages]
    out = []
    for name, start, end, corr in device:
        stage = OUTSIDE
        t = launches.get(corr)
        if t is not None:
            # the innermost open span is the one that started last
            for s in reversed(stages[:bisect.bisect_right(starts, t)]):
                if s[2] >= t:
                    stage = s[0]
                    break
        out.append((name, start, end, stage))
    return out
