"""Pure-CPU execution mode (the counterpart of the JAX package's
``runtime/oracle_executor.py``): the rebuild of the reference's ``#ifdef
CPU`` fallback path (``server.cpp:55-135``).

The reference's CPU mode only ran grayscale, histogram and binarize, with
the diff loop commented out (``server.cpp:82-94``). This one runs the
whole step through the port's NumPy spec, ``reference_cpu.step_oracle``,
so the server works, slowly, with no device at all, and doubles as a live
cross-check of the device paths. It imports no torch.

Select with ``--backend oracle`` on the server's command line.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from cudavideostream_tpu_torch.config import PayloadOverflowError, StreamConfig
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.runtime.executor import ExecMetrics
from cudavideostream_tpu_torch.utils import fonts


class OracleExecutor:
    """The interface of ``StreamExecutor``; state and compute are NumPy."""

    def __init__(self, config: StreamConfig):
        self.cfg = config
        self.atlas = fonts.make_atlas(config.overlay_scale,
                                      config.overlay_font)
        self.conv_weights = ref.gaussian_kernel(config.conv_k)
        self._state: Optional[np.ndarray] = None
        self.metrics = ExecMetrics()

    def start(self, base_frame: np.ndarray) -> np.ndarray:
        base = np.asarray(base_frame, dtype=np.uint8).ravel()
        if base.size != self.cfg.frame_bytes:
            raise ValueError("base frame size mismatch")
        self._state = base.copy()
        return base

    def process(self, frame: np.ndarray, text: str = ""
                ) -> Tuple[int, np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """One frame: ``(pos, xs, vals, aux)``, host arrays exactly ``pos``
        long. Raises :class:`PayloadOverflowError` past the capacity, as
        the device executors do: the state has then taken the frame."""
        if self._state is None:
            raise RuntimeError("call start(base_frame) first")
        t0 = time.perf_counter()
        ids = fonts.encode_text(text) if text else []
        self._state, pos, xs, vals, aux = ref.step_oracle(
            self._state, frame, self.cfg,
            atlas=self.atlas if text else None, char_ids=ids,
            conv_weights=self.conv_weights)
        if pos > self.cfg.capacity:
            # truncation would desync clients for good
            raise PayloadOverflowError(
                f"frame changed {pos} bytes > payload_capacity "
                f"{self.cfg.capacity}")
        self.metrics.record(time.perf_counter() - t0, pos)
        return pos, xs, vals, aux

    def resync(self) -> np.ndarray:
        """The post-step frame for a wire-v3 raw recovery (the state is
        host NumPy, already past the overflowing frame)."""
        if self._state is None:
            raise RuntimeError("no state to resync from")
        return self._state

    def flush(self):
        return None
