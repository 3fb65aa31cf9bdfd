"""Multi-client broadcast server (the port of the JAX package's
``runtime/broadcast.py``).

The reference serves exactly one client, once — a disconnect ends the
process (``threads.cpp:211-218``, ``server.cpp:16-18``). The delta stream
is broadcastable, though: payloads do not depend on the client, and the
server's state *is* every client's reconstruction. So:

* each frame's payload is computed once and its wire bytes are packed
  once, shared by every client's send queue;
* a client joining mid-stream is admitted at a frame boundary with the
  *current reconstruction* as its base frame — no restart, in step from
  its first delta;
* dead or slow clients are dropped without disturbing the stream.

The joiners' state follows each payload through the native library's C
scatter. Frames come from the synthetic scene, a file or a camera
(``--source file|v4l2 --path``).

Fan-out never blocks: each client owns a bounded send queue drained by its
own writer thread, so a slow-but-alive client (full TCP buffers, a
``sendall`` that would block) stalls neither the pipeline nor the other
clients. A client :attr:`ClientSender.MAX_QUEUE` frames behind is dropped
with a logged reason.

Run:  ``python -m cudavideostream_tpu_torch.runtime.broadcast --tiled``
      ``python -m cudavideostream_tpu_torch.runtime.broadcast --source file --path frames.npy``
"""

from __future__ import annotations

import argparse
import queue
import socket
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from cudavideostream_tpu_torch import native
from cudavideostream_tpu_torch.config import PayloadOverflowError, StreamConfig
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.executor import (
    BatchedLandExecutor,
    StreamExecutor,
)
from cudavideostream_tpu_torch.runtime.sources import FrameSource, make_source


class ClientSender:
    """One client's bounded send queue and writer thread.

    :meth:`offer` never blocks: a full queue means the client has fallen
    ``MAX_QUEUE`` frames behind while its writer is stuck in ``sendall``,
    the backlog drop condition. ``sent_bytes`` counts the bytes written to
    the socket, not those merely queued.
    """

    MAX_QUEUE = 32  # frames of backlog before the client is dropped

    def __init__(self, conn: socket.socket, name: str = ""):
        self.conn = conn
        self.name = name
        self.q: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=self.MAX_QUEUE)
        self.sent_bytes = 0
        self.dead = False
        self.drop_reason: Optional[str] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            buf = self.q.get()
            if buf is None or self.dead:
                # None: a graceful finish (the queue is drained); dead: abort
                return
            try:
                self.conn.sendall(buf)
                self.sent_bytes += len(buf)
            except OSError as e:
                self.dead = True
                if self.drop_reason is None:
                    self.drop_reason = f"send failed ({e.__class__.__name__})"
                return

    def offer(self, buf: bytes) -> bool:
        """Queue one frame's bytes; False once the client is dead."""
        if self.dead:
            return False
        try:
            self.q.put_nowait(buf)
            return True
        except queue.Full:
            self.dead = True
            self.drop_reason = f"backlog exceeded {self.MAX_QUEUE} frames"
            return False

    def finish(self) -> None:
        """Ask the writer to exit after sending everything queued (the
        sentinel rides the queue behind them). A queue too full to take
        the sentinel is a hopeless backlog: abort instead."""
        try:
            self.q.put_nowait(None)
        except queue.Full:
            self.dead = True

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def close(self) -> None:
        self.dead = True
        try:
            self.q.put_nowait(None)  # wake an idle writer
        except queue.Full:
            pass
        try:
            # closing the socket aborts a writer stuck in sendall
            self.conn.close()
        except OSError:
            pass


class BroadcastServer:
    def __init__(self, config: StreamConfig, source: FrameSource,
                 executor: Optional[StreamExecutor] = None,
                 verbose: bool = True, overlay_status: bool = True,
                 sndbuf: Optional[int] = None, device=None):
        self.cfg = config
        self.source = source
        self.executor = executor or StreamExecutor(config, device=device)
        self.verbose = verbose
        self.overlay_status = overlay_status
        # per-client kernel send-buffer bound (None: the OS default); a
        # small one makes a stalled client reach the backlog drop sooner
        self.sndbuf = sndbuf
        self._pending: "queue.Queue[socket.socket]" = queue.Queue()
        self._arrived = threading.Event()  # some client is pending
        self._clients: List[ClientSender] = []
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        # bytes sent to every client, the removed clients' totals retired
        # into _retired_sent
        self._retired_sent = 0
        self._sent_snapshot = 0
        self.drops: List[str] = []  # the logged reasons
        self._v3enc: Optional[wire.V3Encoder] = None

    def listen(self) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.cfg.host, self.cfg.port))
        srv.listen(32)
        self._sock = srv
        threading.Thread(target=self._accept_loop, daemon=True).start()
        if self.verbose:
            print(f"broadcast server on {self.cfg.host}:{self.port}",
                  flush=True)

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    @property
    def n_clients(self) -> int:
        return len(self._clients)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.sndbuf is not None:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                self.sndbuf)
            self._pending.put(conn)
            self._arrived.set()

    def _admit_pending(self, state: np.ndarray) -> None:
        """Admit joiners at a frame boundary, the current reconstruction
        as their base frame, sent through their own queue (a joiner that
        stalls on it cannot stall the stream)."""
        while True:
            try:
                conn = self._pending.get_nowait()
            except queue.Empty:
                return
            sender = ClientSender(conn)
            sender.offer(wire.MAGICS.get(self.cfg.wire_format, b"")
                         + state.tobytes())
            self._clients.append(sender)
            if self.verbose:
                print(f"\nclient joined ({len(self._clients)} total)",
                      flush=True)

    def _pack(self, pos: int, xs, vals) -> bytes:
        """One frame's wire bytes, shared by every client's queue."""
        if self._v3enc is not None:
            # encode() also applies the payload to its shadow, which is the
            # joiners' state (serve() aliases them): once
            return self._v3enc.encode(pos, xs, vals)
        pack = (wire.pack_payload_v2 if self.cfg.wire_format == "v2"
                else wire.pack_payload)
        return pack(pos, xs, vals)

    def _fanout(self, buf: bytes) -> None:
        for sender in self._clients:
            sender.offer(buf)
        self._reap()

    def _reap(self) -> None:
        for sender in [s for s in self._clients if s.dead]:
            self._clients.remove(sender)
            self._retired_sent += sender.sent_bytes
            sender.close()
            self.drops.append(sender.drop_reason or "unknown")
            if self.verbose:
                print(f"\nclient dropped: {sender.drop_reason} "
                      f"({len(self._clients)} left)", flush=True)

    def _record_wire_bytes(self, pos: int) -> None:
        """Replace the executor's per-frame v1 estimate (4 + 5 * pos, one
        client) with the bytes sent since the last frame, to every
        client."""
        sent = self._retired_sent + sum(s.sent_bytes for s in self._clients)
        self.executor.metrics.wire_bytes += (
            sent - self._sent_snapshot - (4 + 5 * pos))
        self._sent_snapshot = sent

    def serve(self, max_frames: Optional[int] = None,
              wait_first_client: bool = True) -> int:
        if self._sock is None:
            self.listen()
        base = self.executor.start(self.source.base_frame())
        # the joiners' state, updated in place per frame; under v3/v4 the
        # encoder's shadow is that buffer (encode() applies each payload)
        self._v3enc = (wire.V4Encoder(base) if self.cfg.wire_format == "v4"
                       else wire.V3Encoder(base)
                       if self.cfg.wire_format == "v3" else None)
        state = self._v3enc.frame if self._v3enc is not None else base.copy()
        if wait_first_client:
            while not self._arrived.wait(0.1) and not self._stop.is_set():
                pass
        try:
            n = self._serve_loop(state, max_frames)
        except BaseException:
            # a fatal overflow or a source error must still release the
            # clients, which would otherwise block in recv() forever
            self.close(drain=False)
            raise
        self.close(drain=True)
        return n

    def _ship(self, state: np.ndarray, result) -> None:
        """Send a result: None (nothing landed), one frame's, or a list."""
        for res in result if isinstance(result, list) else [result]:
            if res is None:
                continue
            pos, xs, vals, _ = res
            if self._v3enc is None:
                # v1/v2 send index streams: a mask or tiled landing goes
                # flat; the joiners' state follows each payload
                if isinstance(xs, (wire.TiledPayload, wire.MaskPayload)):
                    xs, vals = xs.to_flat()
                native.client_apply_np(state, np.asarray(xs)[:pos],
                                       np.asarray(vals)[:pos])
            self._fanout(self._pack(pos, xs, vals))
            self._record_wire_bytes(pos)

    def _resync(self) -> None:
        """After a capacity overflow: v3/v4 send one raw frame to every
        client (the encoder's shadow, the joiners' state, takes it in
        place); v1/v2 cannot resync a client, so the error propagates."""
        buf = self._v3enc.resync(self.executor.resync())
        self._fanout(buf)

    def _serve_loop(self, state: np.ndarray,
                    max_frames: Optional[int]) -> int:
        text = ""
        n = 0
        while max_frames is None or n < max_frames:
            self._admit_pending(state)
            try:
                frame = next(self.source)
            except StopIteration:
                break
            t0 = time.perf_counter()
            try:
                result = self.executor.process(frame, text=text)
            except PayloadOverflowError:
                if self._v3enc is None:
                    raise
                self._resync()
                n += 1
                self.executor.metrics.record(time.perf_counter() - t0, 0)
                self._record_wire_bytes(0)
                continue
            n += 1
            # a pipelined or batched executor lags: its frames ship later
            self._ship(state, result)
            line = self.executor.metrics.status_line(time.perf_counter() - t0)
            if line:
                if self.overlay_status:
                    text = self.executor.metrics.overlay_text()
                if self.verbose:
                    print("\r" + line + f"  CLIENTS: {len(self._clients)}",
                          end="", flush=True)
        # the batched executor's tail, with the same overflow recovery
        try:
            tail = self.executor.flush()
        except PayloadOverflowError:
            if self._v3enc is None:
                raise
            self._resync()
            tail = None
        self._ship(state, tail)
        return n

    def close(self, drain: bool = False) -> None:
        """Stop serving. ``drain``: let every writer send its queued frames
        before the sockets close (the end of the stream), within a shared
        5 s deadline; stalled writers are aborted after it."""
        self._stop.set()
        if self._sock:
            self._sock.close()
        if drain:
            for c in self._clients:
                c.finish()
            deadline = time.monotonic() + 5.0
            for c in self._clients:
                c.join(timeout=max(0.0, deadline - time.monotonic()))
        for c in self._clients:
            c.close()
        self._clients.clear()


def parse_args(argv=None) -> argparse.Namespace:
    """The command line: every option of the JAX broadcast server, with
    its defaults."""
    p = argparse.ArgumentParser(description="multi-client broadcast server")
    p.add_argument("--source", default="synthetic",
                   choices=["synthetic", "file", "v4l2"],
                   help="synthetic scene, a .npy or raw BGR24 file "
                        "(--path), or a V4L2 camera (--path, default "
                        "/dev/video0)")
    p.add_argument("--path", help="file source path / camera device")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2734)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--wire", default="v1", choices=["v1", "v2", "v3", "v4"])
    p.add_argument("--tiled", action="store_true",
                   help="per-unit payload blocks (wire bytes identical)")
    p.add_argument("--fetch", default="auto",
                   choices=["auto", "tiles", "flat", "mask"],
                   help="tiled-payload landing (see the server's --help)")
    p.add_argument("--land-batch", type=int, default=0, metavar="K",
                   help="dispatch K frames, then land them in order "
                        "(requires --tiled); every client lags up to K "
                        "frames")
    p.add_argument("--sndbuf", type=int, default=None,
                   help="per-client SO_SNDBUF bytes (a stalled client "
                        "reaches the backlog drop sooner)")
    p.add_argument("--capacity", type=int, default=None,
                   help="payload capacity bound in bytes (flat payloads): "
                        "overflow is fatal under v1/v2, one raw resync "
                        "frame to every client under v3/v4")
    p.add_argument("--link-cache", default=None, metavar="JSON",
                   help="load the lander's measured rates before serving and "
                        "write them back after (see the server's "
                        "--link-cache)")
    p.add_argument("--calibrate", type=int, default=2, metavar="N",
                   help="time N copies from the device before the first "
                        "frame (0 disables; see the server's --calibrate)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)
    if args.fetch != "auto" and not args.tiled:
        p.error("--fetch tiles/flat/mask applies to --tiled payloads")
    if args.land_batch and not args.tiled:
        p.error("--land-batch requires --tiled payloads")
    if args.capacity is not None and args.tiled:
        p.error("--capacity applies to flat payloads only (tiled is always "
                "worst-case)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    mask = args.fetch == "mask"
    cfg = StreamConfig(height=args.height, width=args.width, host=args.host,
                       port=args.port, wire_format=args.wire,
                       tiled_payload=args.tiled, fetch_mode=args.fetch,
                       emit_bitmask=mask,
                       mask_payload=args.wire == "v4" and mask,
                       payload_capacity=args.capacity)
    executor = (BatchedLandExecutor(cfg, device=args.device,
                                    depth=args.land_batch)
                if args.land_batch else StreamExecutor(cfg,
                                                       device=args.device))
    source = make_source(args.source, cfg, path=args.path)
    # the lander's warm start, as the server's (the JAX broadcast.py:436-446):
    # the executor starts on the source's base frame, so the stream's base
    # frame is the source's second one
    if args.link_cache or args.calibrate:
        if args.link_cache and executor.load_link_cache(args.link_cache):
            print(f"link cache loaded from {args.link_cache} (copy rate "
                  f"{executor.copy_rate} B/s)", file=sys.stderr)
        if args.calibrate:
            rate = executor.calibrate_link(rounds=args.calibrate)
            print(f"calibrated copy rate {rate} B/s ({args.calibrate} "
                  f"copies)", file=sys.stderr)
        executor.start(source.base_frame())
        n = executor.prewarm_fetch()
        print(f"prewarmed {n} fetch jits", file=sys.stderr)
    server = BroadcastServer(cfg, source, executor=executor,
                             sndbuf=args.sndbuf)
    try:
        n = server.serve(max_frames=args.frames)
    finally:
        close = getattr(source, "close", None)  # the camera handle
        if close is not None:
            close()
    if args.link_cache:
        executor.save_link_cache(args.link_cache)
        print(f"link cache saved to {args.link_cache}", file=sys.stderr)
    print(f"served {n} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
