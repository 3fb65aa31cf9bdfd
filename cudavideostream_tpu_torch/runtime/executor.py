"""Streaming executor: drives the pipeline and lands payloads on the host
(port of the JAX package's ``StreamExecutor``, ``TiledLander`` and
``PipelinedExecutor``).

The reference's variable-length device-to-host copy is two
``cudaMemcpyAsync`` calls sized by ``pos`` after a sync
(``kernels.cu:507-524``). The same here: right behind each step the
executor queues the copy of the frame's sizes (``pos``, and the per-unit
``counts`` of a tiled payload) into pinned host memory and marks them
with an event; landing waits for that event only, then copies what the
sizes say on a side stream (the landing stream) and waits for that.

Waiting on the event and copying on the side stream is what lets
:class:`PipelinedExecutor` overlap: it lands frame N-1 after dispatching
frame N, and a blocking ``.cpu()`` on the step's stream would queue
behind frame N's kernels. The event of frame N-1 was recorded before
frame N's kernels, and the landing stream runs beside them.

The JAX executor's tiered static slices, fetch rungs, speculative windows
and link cache exist for XLA's static shapes and a ~30 ms host-to-TPU
round trip; eager PyTorch slices at any length, and the card's copies take
microseconds (``ROADMAP.md`` says where each of those mechanisms goes).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from cudavideostream_tpu_torch.config import PayloadOverflowError, StreamConfig
from cudavideostream_tpu_torch.models.pipeline import DeltaStreamPipeline
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.runtime import wire


class _Staged:
    """One dispatched frame: its step outputs past ``new_prev``, and host
    copies of its sizes queued behind the step and marked by an event."""

    def __init__(self, outs, n_sizes: int):
        self.outs = outs
        sizes = outs[:n_sizes]
        if sizes[0].is_cuda:
            # non-blocking device-to-host copies land in pinned memory
            self.sizes = [t.to("cpu", non_blocking=True) for t in sizes]
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.sizes, self.event = list(sizes), None

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.sizes]


class _Copier:
    """Device work of a landing, on the landing stream behind a frame's
    event, and its device-to-host copies (host arrays on return)."""

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def run(self, staged: _Staged, fn):
        """``fn()`` returns the device tensors to copy; returns them as
        host arrays once the copies are done."""
        if self.stream is None:
            return [t.numpy() for t in fn()]
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(staged.event)
            host = [t.to("cpu", non_blocking=True) for t in fn()]
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
        return [t.numpy() for t in host]


class TiledLander:
    """Landing of per-unit payload blocks, in one of three flavors:

    * ``tiles``: find the non-empty unit span ``[t_lo, t_hi)`` from the
      host counts, narrow that block range's ``xs`` to unit-local
      uint8/uint16 on the device, copy it with its ``vals``, and rebuild
      global indices on the host: a :class:`~.wire.TiledPayload`;
    * ``flat``: merge the blocks on the device (``logcompact.merge_tiles``,
      one K2 launch) and copy the ``pos``-long prefixes: flat ``(xs,
      vals)``;
    * ``auto``: per frame, the flavor the JAX byte model
      (``TiledLander.use_flat``) predicts to be faster, with two numbers
      measured here in place of the tunnel's link statistics: the rate
      of a whole ``tiles`` landing (copy and host rebuild) in bytes of
      span, and what a ``flat`` landing takes beyond its bytes at that
      rate (the merge). The first four landings take each flavor twice;
      the first of each pays first-use allocations and is not measured.

    The wire bytes are the same whichever flavor lands; ``fetch_counts``
    records the choices.
    """

    #: weight of the newest measurement in the rate and merge-time EMAs
    ALPHA = 0.3

    def __init__(self, mode: str = "auto"):
        if mode not in ("auto", "tiles", "flat"):
            raise ValueError(f"unknown landing flavor {mode!r}")
        self.mode = mode
        self.fetch_counts = {"tiles": 0, "flat": 0}
        self.copy_bytes_per_s: Optional[float] = None
        self.merge_s: Optional[float] = None

    @staticmethod
    def compact_dtype(unit_bytes: int):
        """Narrowest host dtype of a unit-local index (the JAX
        ``_compact_dtype``), or None where int32 stays."""
        if unit_bytes <= 256:
            return np.uint8
        if unit_bytes <= 65536:
            return np.uint16
        return None

    def use_flat(self, pos: int, t_lo: int, t_hi: int,
                 unit_bytes: int) -> bool:
        """The per-frame choice: ``tiles`` copies ``(1 + xs_bytes)`` bytes
        per slot of the span, ``flat`` pays the merge and 5 bytes per
        entry."""
        if self.mode != "auto":
            return self.mode == "flat"
        if self.fetch_counts["tiles"] < 2:
            return False
        if self.fetch_counts["flat"] < 2:
            return True
        narrow = self.compact_dtype(unit_bytes)
        xs_bytes = 4 if narrow is None else np.dtype(narrow).itemsize
        t_tiles = (1 + xs_bytes) * (t_hi - t_lo) * unit_bytes
        t_flat = 5 * pos
        return (self.merge_s + t_flat / self.copy_bytes_per_s
                < t_tiles / self.copy_bytes_per_s)

    def _ema(self, old: Optional[float], new: float) -> float:
        return new if old is None else old + self.ALPHA * (new - old)

    def land(self, pos: int, counts: np.ndarray, staged: _Staged,
             copier: _Copier):
        """Land one frame; returns a TiledPayload or flat ``(xs, vals)``."""
        _, counts_d, xs_t_d, vals_t_d = staged.outs[:4]
        unit_bytes = xs_t_d.shape[1]
        nz = np.flatnonzero(counts)
        t_lo, t_hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        flat = self.use_flat(pos, t_lo, t_hi, unit_bytes)
        self.fetch_counts["flat" if flat else "tiles"] += 1
        t0 = time.perf_counter()
        if flat:
            def merged():
                xs, vals = logcompact.merge_tiles(counts_d, xs_t_d, vals_t_d)
                return xs[:pos], vals[:pos]

            res = tuple(copier.run(staged, merged))
            if self.fetch_counts["flat"] > 1 and self.copy_bytes_per_s:
                # what the landing took beyond its bytes at that rate
                rest = (time.perf_counter() - t0
                        - 5 * pos / self.copy_bytes_per_s)
                self.merge_s = self._ema(self.merge_s, max(rest, 0.0))
        else:
            narrow = self.compact_dtype(unit_bytes)

            def window():
                xw = xs_t_d[t_lo:t_hi]
                if narrow is not None:
                    # unit-local index; the int16 bits are read back as
                    # uint16 on the host
                    xw = torch.remainder(xw, unit_bytes).to(
                        torch.uint8 if narrow is np.uint8 else torch.int16)
                return xw, vals_t_d[t_lo:t_hi]

            xw, vw = copier.run(staged, window)
            if narrow is np.uint16:
                xw = xw.view(np.uint16)
            res = wire.TiledPayload(
                pos, counts[t_lo:t_hi],
                self.rebuild_xs(xw, counts[t_lo:t_hi], t_lo, unit_bytes), vw,
            )
            if self.fetch_counts["tiles"] > 1 and vw.size:
                rate = ((xw.nbytes + vw.nbytes)
                        / max(time.perf_counter() - t0, 1e-9))
                self.copy_bytes_per_s = self._ema(self.copy_bytes_per_s,
                                                  rate)
        return res

    @staticmethod
    def rebuild_xs(xw: np.ndarray, counts_span: np.ndarray, t_lo: int,
                   unit_bytes: int) -> np.ndarray:
        """Global int32 indices of a unit-local window starting at unit
        ``t_lo`` (``unit * unit_bytes + local``), zero past each unit's
        count as on the device: the JAX ``_rebuild_xs``, computed over the
        counted entries only."""
        if xw.dtype == np.int32:
            return xw
        c = np.asarray(counts_span, dtype=np.int64)
        out = np.zeros(xw.shape, np.int32)
        slots = wire.prefix_slots(c, unit_bytes)
        base = np.repeat(
            np.arange(t_lo, t_lo + c.size, dtype=np.int64) * unit_bytes, c)
        out.reshape(-1)[slots] = xw.reshape(-1)[slots] + base
        return out


class StreamExecutor:
    """Owns pipeline + device state; yields host payloads per frame."""

    def __init__(self, config: StreamConfig,
                 pipeline: Optional[DeltaStreamPipeline] = None, device=None):
        self.cfg = config
        self.pipe = pipeline or DeltaStreamPipeline(config, device=device)
        self._state = None
        self._copier = _Copier(self.pipe.device)
        self.lander = (TiledLander(config.fetch_mode)
                       if config.tiled_payload else None)
        self.metrics = ExecMetrics()

    @property
    def fetch_counts(self) -> dict:
        """Landings per flavor (tiled payloads; empty otherwise)."""
        return self.lander.fetch_counts if self.lander else {}

    def start(self, base_frame: np.ndarray) -> np.ndarray:
        """Initialize device state; returns the base frame bytes to ship."""
        base = np.asarray(base_frame, dtype=np.uint8).ravel()
        self._state = self.pipe.init_state(base)
        return base

    def process(self, frame, text: str = ""):
        """Run one frame; returns host-side ``(pos, xs, vals, aux)``.

        With ``tiled_payload`` configured, a ``tiles`` landing returns a
        :class:`~cudavideostream_tpu_torch.runtime.wire.TiledPayload` as
        ``xs`` and None as ``vals`` (``.to_flat()`` gives the arrays); a
        ``flat`` landing returns the arrays.

        Raises :class:`PayloadOverflowError` when the frame changed more
        bytes than the configured capacity; the device state has then
        already advanced past the frame.
        """
        if self._state is None:
            raise RuntimeError("call start(base_frame) first")
        return self._land(*self._dispatch(frame, text))

    def _dispatch(self, frame, text: str):
        """Run the step, advance the state and stage the sizes' copies."""
        t0 = time.perf_counter()
        out = self.pipe.step(self._state, frame, text=text)
        self._state = out[0]
        return t0, _Staged(out[1:], 2 if self.cfg.tiled_payload else 1)

    def _land(self, t0: float, staged: _Staged):
        sizes = staged.wait()
        pos = int(sizes[0])  # the frame's one wait on the device
        if self.lander is not None:
            res = self.lander.land(pos, sizes[1], staged, self._copier)
            self.metrics.record(time.perf_counter() - t0, pos)
            if isinstance(res, wire.TiledPayload):
                return pos, res, None, None
            return (pos, *res, None)
        if pos > self.cfg.capacity:
            # truncating would silently desync a v1 client: the dropped
            # deltas are already folded into the device state
            raise PayloadOverflowError(
                f"frame changed {pos} bytes > payload_capacity "
                f"{self.cfg.capacity}"
            )
        xs_d, vals_d = staged.outs[1:3]
        xs, vals = self._copier.run(staged, lambda: (xs_d[:pos], vals_d[:pos]))
        self.metrics.record(time.perf_counter() - t0, pos)
        return pos, xs, vals, None

    def resync(self) -> np.ndarray:
        """The post-step previous-frame bytes (the client's state), for a
        wire-v3 raw recovery after a :class:`PayloadOverflowError`."""
        if self._state is None:
            raise RuntimeError("no state to resync from")
        return self._state.to("cpu", copy=True).numpy()

    def flush(self):
        """No pending work in the synchronous executor."""
        return None


class PipelinedExecutor(StreamExecutor):
    """One-frame-deep software pipeline: dispatch frame N, then land frame
    N-1's payload while N computes — the executor-level counterpart of the
    reference's capture/compute/send thread overlap
    (``threads.cpp:166-237``). The output stream lags one frame:
    :meth:`process` returns None for the first frame, and :meth:`flush`
    lands the last one."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending = None  # (t0, _Staged) of the frame not yet landed

    def process(self, frame, text: str = ""):
        if self._state is None:
            raise RuntimeError("call start(base_frame) first")
        prev, self._pending = self._pending, self._dispatch(frame, text)
        return None if prev is None else self._land(*prev)

    def flush(self):
        prev, self._pending = self._pending, None
        return None if prev is None else self._land(*prev)

    def resync(self) -> np.ndarray:
        # the pending payload's deltas are against a state the raw frame
        # replaces: a client that applied them afterwards would corrupt
        self._pending = None
        return super().resync()


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
