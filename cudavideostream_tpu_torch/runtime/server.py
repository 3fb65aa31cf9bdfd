"""The streaming TCP server — the port's main entry point (counterpart of
the JAX package's ``runtime/server.py``, wire v1).

Wire-compatible rebuild of the reference server loop (``server.cpp:38-175``
+ ``th_show_hdl``, ``threads.cpp:181-237``): listen on one socket, accept
one client, ship the raw base frame, then per frame ship
``[u32 pos][i32 xs[pos]][u8 vals[pos]]`` — the reference OpenCV client
decodes this stream unmodified. The 1 Hz status line is printed and
rendered into the stream via the glyph overlay (``server.cpp:164-168``).

Run:  ``python -m cudavideostream_tpu_torch.runtime.server --source synthetic``
"""

from __future__ import annotations

import argparse
import socket
import sys
import time

from cudavideostream_tpu_torch.config import StreamConfig
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.executor import StreamExecutor
from cudavideostream_tpu_torch.runtime.sources import FrameSource, make_source


class DeltaStreamServer:
    def __init__(self, config: StreamConfig, source: FrameSource,
                 executor: StreamExecutor | None = None, verbose: bool = True,
                 overlay_status: bool = True, device=None):
        if config.wire_format != "v1":
            raise NotImplementedError(
                f"wire {config.wire_format} is not ported to "
                "cudavideostream_tpu_torch yet: see ROADMAP.md M7, M8, M18"
            )
        self.cfg = config
        self.source = source
        self.executor = executor or StreamExecutor(config, device=device)
        self.verbose = verbose
        # render the 1 Hz status into the video (server.cpp:166-168);
        # off => deterministic streams for tests
        self.overlay_status = overlay_status
        self._sock: socket.socket | None = None

    def listen(self) -> socket.socket:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.cfg.host, self.cfg.port))
        srv.listen(10)
        self._sock = srv
        if self.verbose:
            print(f"listening on {self.cfg.host}:{self.cfg.port}", flush=True)
        return srv

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def serve(self, max_frames: int | None = None) -> int:
        """Accept one client and stream to it; returns frames served."""
        if self._sock is None:
            self.listen()
        conn, addr = self._sock.accept()
        if self.verbose:
            print(f"client {addr} connected", flush=True)
        try:
            return self._stream_to(conn, max_frames)
        except (BrokenPipeError, ConnectionResetError):
            if self.verbose:
                print("client disconnected", flush=True)
            return 0
        finally:
            conn.close()

    def _stream_to(self, conn: socket.socket, max_frames: int | None) -> int:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        base = self.executor.start(self.source.base_frame())
        conn.sendall(base.tobytes())
        text = ""
        n = 0
        while max_frames is None or n < max_frames:
            t0 = time.perf_counter()
            try:
                frame = next(self.source)
            except StopIteration:
                break
            read_s = time.perf_counter() - t0
            # v1 cannot express a resync: a PayloadOverflowError propagates
            # rather than desync the client (config.PayloadOverflowError)
            pos, xs, vals, _aux = self.executor.process(frame, text=text)
            conn.sendall(wire.pack_payload(pos, xs, vals))
            n += 1
            line = self.executor.metrics.status_line(read_s)
            if line:
                if self.overlay_status:
                    text = self.executor.metrics.overlay_text()
                if self.verbose:
                    print("\r" + line, end="", flush=True)
        if self.verbose:
            print()
        return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="CUDA delta-stream server")
    p.add_argument("--source", default="synthetic", choices=["synthetic"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2734)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--threshold", type=int, default=20)
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (default: run forever)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--capacity", type=int, default=None,
                   help="payload capacity bound in bytes (default: worst "
                        "case = frame bytes, never overflows); a frame that "
                        "changes more bytes is fatal under wire v1")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)
    cfg = StreamConfig(
        height=args.height,
        width=args.width,
        threshold=args.threshold,
        host=args.host,
        port=args.port,
        payload_capacity=args.capacity,
    )
    source = make_source(args.source, cfg, seed=args.seed)
    server = DeltaStreamServer(cfg, source, device=args.device)
    try:
        served = server.serve(max_frames=args.frames)
    finally:
        server.close()
    print(f"served {served} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
