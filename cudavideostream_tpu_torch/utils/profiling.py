"""Profiling and tracing helpers: parity with the reference's nvprof
wiring (``make prof`` -> ``sudo nvprof ./server``, server/Makefile:58-59,
and the awk extraction in ``tests/*/kernel_test.sh``), and the PyTorch
port of the JAX package's ``utils/profiling.py``.

``trace`` records a ``torch.profiler`` trace (CPU and CUDA activities on
the card) and writes it as a Chrome trace, viewable in Perfetto or
``chrome://tracing``; ``annotate`` names a span in it. The amortized
wall-clock harness is :mod:`cudavideostream_tpu_torch.utils.timing`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

TRACE_FILE = "trace.json"


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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span visible in the trace (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


class FrameProfiler:
    """Rolling per-stage wall-clock stats for the streaming loop,
    printable in the same spirit as the reference's 1 Hz line."""

    def __init__(self, window: int = 120):
        self.window = window
        self.samples: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            buf = self.samples.setdefault(name, [])
            buf.append(time.perf_counter() - t0)
            if len(buf) > self.window:
                del buf[: len(buf) - self.window]

    def summary(self) -> str:
        parts = []
        for name, buf in sorted(self.samples.items()):
            if buf:
                mean = 1e3 * sum(buf) / len(buf)
                worst = 1e3 * max(buf)
                parts.append(f"{name}: {mean:.2f}ms (max {worst:.2f})")
        return " | ".join(parts)
