"""Streaming executor: drives the pipeline and lands payloads on the host
(port of the JAX package's ``StreamExecutor`` for the flat path).

The reference's variable-length device-to-host copy is two
``cudaMemcpyAsync`` calls sized by ``pos`` after a sync
(``kernels.cu:507-524``). The same here: the executor reads the 4-byte
``pos`` once per frame — the frame's one host sync — and copies the
``pos``-long prefixes of ``xs`` and ``vals``. The JAX executor's tiered
static slices, link statistics and fetch rungs exist for XLA's static
shapes and a slow host link; eager PyTorch slices at any length.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from cudavideostream_tpu_torch.config import PayloadOverflowError, StreamConfig
from cudavideostream_tpu_torch.models.pipeline import DeltaStreamPipeline


class StreamExecutor:
    """Owns pipeline + device state; yields host payloads per frame."""

    def __init__(self, config: StreamConfig,
                 pipeline: Optional[DeltaStreamPipeline] = None, device=None):
        self.cfg = config
        self.pipe = pipeline or DeltaStreamPipeline(config, device=device)
        self._state = None
        self.metrics = ExecMetrics()

    def start(self, base_frame: np.ndarray) -> np.ndarray:
        """Initialize device state; returns the base frame bytes to ship."""
        base = np.asarray(base_frame, dtype=np.uint8).ravel()
        self._state = self.pipe.init_state(base)
        return base

    def process(
        self, frame, text: str = ""
    ) -> Tuple[int, np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Run one frame; returns host-side ``(pos, xs, vals, aux)``.

        Raises :class:`PayloadOverflowError` when the frame changed more
        bytes than the configured capacity; the device state has then
        already advanced past the frame.
        """
        if self._state is None:
            raise RuntimeError("call start(base_frame) first")
        t0 = time.perf_counter()
        out = self.pipe.step(self._state, frame, text=text)
        self._state = out[0]
        return self._land(t0, out[1:])

    def _land(self, t0: float, rest
              ) -> Tuple[int, np.ndarray, np.ndarray, Optional[np.ndarray]]:
        pos_d, xs_d, vals_d, _aux = rest
        pos = int(pos_d)  # the frame's one host sync
        if pos > self.cfg.capacity:
            # truncating would silently desync a v1 client: the dropped
            # deltas are already folded into the device state
            raise PayloadOverflowError(
                f"frame changed {pos} bytes > payload_capacity "
                f"{self.cfg.capacity}"
            )
        xs = xs_d[:pos].cpu().numpy()
        vals = vals_d[:pos].cpu().numpy()
        self.metrics.record(time.perf_counter() - t0, pos)
        return pos, xs, vals, None

    def resync(self) -> np.ndarray:
        """The post-step previous-frame bytes (the client's state)."""
        if self._state is None:
            raise RuntimeError("no state to resync from")
        return self._state.to("cpu", copy=True).numpy()

    def flush(self):
        """No pending work in the synchronous executor."""
        return None


class ExecMetrics:
    """1 Hz status line state (reference ``server.cpp:150-171``)."""

    def __init__(self):
        self.last_print = time.perf_counter()
        self.frame_time = 0.0
        self.read_time = 0.0
        self.pos = 0
        self.frames = 0
        self.total_frames = 0
        self.wire_bytes = 0
        # snapshot of the last completed 1 Hz window, taken by
        # status_line() BEFORE it resets the counters — overlay_text()
        # must read these, not the live counters (which are zero right
        # after the reset, exactly when callers render the overlay)
        self.win_fps = 0.0
        self.win_bw_ref = 0

    def record(self, frame_s: float, pos: int) -> None:
        self.frame_time = frame_s
        self.pos = pos
        self.frames += 1
        self.total_frames += 1
        self.wire_bytes += 4 + 5 * pos  # the v1 framing cost

    def status_line(self, read_s: float = 0.0) -> Optional[str]:
        """Returns the status string once per second, else None."""
        now = time.perf_counter()
        if now - self.last_print < 1.0:
            return None
        dt = now - self.last_print
        fps = self.frames / dt
        # reference BW estimate: each changed byte counted as 16 bits
        # ((pos<<4)*fps*1e-3 kbps, server.cpp:159) — kept for parity
        bw_ref = int((self.pos << 4) * fps * 1e-3)
        bw_true = int(8 * self.wire_bytes / dt * 1e-3)
        self.win_fps = fps
        self.win_bw_ref = bw_ref
        line = (
            f"FPS: {fps:5.0f}\tFOR: {1e3*self.frame_time:6.2f} ms\t"
            f"READ: {1e3*read_s:6.2f}\tPOS: {self.pos:7d}\t"
            f"BW: {bw_ref:6d} kbps (wire: {bw_true} kbps)"
        )
        self.last_print = now
        self.frames = 0
        self.wire_bytes = 0
        return line

    def overlay_text(self) -> str:
        """The string rendered into the video (``server.cpp:166-168``):
        the last completed 1 Hz window's fps/BW."""
        return f"FPS: {int(self.win_fps)} BW: {self.win_bw_ref} kbps"
