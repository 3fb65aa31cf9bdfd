"""The streaming TCP server — the port's main entry point (counterpart of
the JAX package's ``runtime/server.py``).

Wire-compatible rebuild of the reference server loop (``server.cpp:38-175``
+ ``th_show_hdl``, ``threads.cpp:181-237``): listen on one socket, accept
one client, ship the raw base frame, then one payload per frame — under
the default wire v1 ``[u32 pos][i32 xs[pos]][u8 vals[pos]]``, which the
reference OpenCV client decodes unmodified; under the opt-in v2/v3/v4
the magic first (``runtime.wire``). The 1 Hz status line is printed and
rendered into the stream via the glyph overlay (``server.cpp:164-168``).

With a visualizer (``--visualizer 1-5``) each landed frame also brings
its aux frame to the host; ``--aux-dir`` dumps every ``aux_every``-th one
(30 by default) as a PPM file, the headless counterpart of the
reference's ``SERVER_IMSHOW``. The wire bytes do not change.

Run:  ``python -m cudavideostream_tpu_torch.runtime.server --source synthetic``
      ``python -m cudavideostream_tpu_torch.runtime.server --visualizer 5 --aux-dir aux/``
      ``python -m cudavideostream_tpu_torch.runtime.server --tiled --pipelined --wire v3``
      ``python -m cudavideostream_tpu_torch.runtime.server --tiled --fetch mask --maskonly --wire v4 --land-batch 8``
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import time

from cudavideostream_tpu_torch.config import (
    PayloadOverflowError,
    StreamConfig,
    Visualizer,
)
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.client import write_ppm
from cudavideostream_tpu_torch.runtime.executor import (
    BatchedLandExecutor,
    PipelinedExecutor,
    StreamExecutor,
)
from cudavideostream_tpu_torch.runtime.sources import FrameSource, make_source


class DeltaStreamServer:
    def __init__(self, config: StreamConfig, source: FrameSource,
                 executor: StreamExecutor | None = None, verbose: bool = True,
                 overlay_status: bool = True, device=None,
                 aux_dir: str | None = None, aux_every: int = 30):
        self.cfg = config
        self.source = source
        self.executor = executor or StreamExecutor(config, device=device)
        self.verbose = verbose
        # render the 1 Hz status into the video (server.cpp:166-168);
        # off => deterministic streams for tests
        self.overlay_status = overlay_status
        # dump every aux_every-th landed frame's aux frame here as a PPM
        self.aux_dir = aux_dir
        self.aux_every = aux_every
        self._n_out = 0  # landed frames (lags frames served under batching)
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
        v3enc = None
        if self.cfg.wire_format == "v2":
            conn.sendall(wire.MAGIC_V2)
        elif self.cfg.wire_format == "v3":
            conn.sendall(wire.MAGIC_V3)
            v3enc = wire.V3Encoder(base)
        elif self.cfg.wire_format == "v4":
            conn.sendall(wire.MAGIC_V4)
            v3enc = wire.V4Encoder(base)
        conn.sendall(base.tobytes())
        text = ""
        n = 0
        self._n_out = 0
        while max_frames is None or n < max_frames:
            t0 = time.perf_counter()
            try:
                frame = next(self.source)
            except StopIteration:
                break
            read_s = time.perf_counter() - t0
            try:
                result = self.executor.process(frame, text=text)
            except PayloadOverflowError as e:
                self._resync(conn, v3enc, e)
                result = None
            # a pipelined executor lags a frame; a batched one returns
            # None until its batch fills, then a list (oldest first)
            self._send_all(conn, result, v3enc)
            n += 1
            line = self.executor.metrics.status_line(read_s)
            if line:
                if self.overlay_status:
                    text = self.executor.metrics.overlay_text()
                if self.verbose:
                    print("\r" + line, end="", flush=True)
        # the pipelined tail can overflow too (the last frame may be the
        # scene cut): the same recovery as in the loop
        try:
            tail = self.executor.flush()
        except PayloadOverflowError as e:
            self._resync(conn, v3enc, e)
            tail = None
        self._send_all(conn, tail, v3enc)
        if self.verbose:
            print()
        return n

    def _resync(self, conn: socket.socket, v3enc,
                err: PayloadOverflowError) -> None:
        """After a payload-capacity overflow: under v3 one raw frame
        replaces the client's state (the executor drops any pending
        pipelined payload, whose deltas it subsumes); v1 and v2 cannot
        express a resync, so the error propagates rather than desync the
        client (config.PayloadOverflowError)."""
        if v3enc is None:
            raise err
        buf = v3enc.resync(self.executor.resync())
        conn.sendall(buf)
        self.executor.metrics.wire_bytes += len(buf)

    def _send_all(self, conn: socket.socket, result, v3enc) -> None:
        """Send a result: None (nothing landed), one frame's, or a list."""
        for res in result if isinstance(result, list) else [result]:
            if res is not None:
                self._send(conn, res, v3enc)

    def _send(self, conn: socket.socket, result, v3enc) -> None:
        pos, xs, vals, aux = result
        if v3enc is not None:
            # v3 rebuilds a MaskPayload's indices; v4 forwards its bits
            buf = v3enc.encode(pos, xs, vals)
        else:
            if isinstance(xs, (wire.TiledPayload, wire.MaskPayload)):
                xs, vals = xs.to_flat()
            pack = (wire.pack_payload_v2 if self.cfg.wire_format == "v2"
                    else wire.pack_payload)
            buf = pack(pos, xs, vals)
        conn.sendall(buf)
        # the metrics count v1 framing; correct them to the bytes sent
        self.executor.metrics.wire_bytes += len(buf) - (4 + 5 * pos)
        k, self._n_out = self._n_out, self._n_out + 1
        if self.aux_dir and aux is not None and k % self.aux_every == 0:
            write_ppm(os.path.join(self.aux_dir, f"aux_{k:06d}.ppm"), aux,
                      self.cfg.height, self.cfg.width)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="CUDA delta-stream server")
    p.add_argument("--source", default="synthetic", choices=["synthetic"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2734)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--threshold", type=int, default=20)
    p.add_argument("--visualizer", type=int, default=0,
                   choices=[v.value for v in Visualizer],
                   help="0 none, 1 heatmap, 2 red-black, 3 red-overlap, "
                        "4 grayscale, 5 binarize")
    p.add_argument("--noise-filter", action="store_true",
                   help="Gaussian denoise (Q16 KxK convolution) of every "
                        "frame before the diff")
    p.add_argument("--conv-k", type=int, default=3,
                   help="noise-filter kernel size K (1-15)")
    p.add_argument("--aux-dir", default=None,
                   help="dump every 30th visualizer aux frame as a PPM here")
    p.add_argument("--aux-port", type=int, default=None, metavar="PORT",
                   help="serve the live aux frame on a side socket (not "
                        "ported yet: ROADMAP.md M18)")
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (default: run forever)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--wire", default="v1", choices=["v1", "v2", "v3", "v4"],
                   help="v1 = reference-compatible wire (default); v2 = "
                        "delta16 index gaps; v3 = adaptive delta16/bitmask/"
                        "raw, which also resyncs a client after a capacity "
                        "overflow; v4 = v3 plus the window bitmask, which "
                        "forwards a mask landing's bits (the client must "
                        "use --wire v2/v3/v4/auto)")
    p.add_argument("--tiled", action="store_true",
                   help="per-unit payload blocks straight from the kernel "
                        "(wire bytes identical)")
    p.add_argument("--fetch", default="auto",
                   choices=["auto", "tiles", "flat", "mask"],
                   help="tiled-payload landing: tiles = copy the non-empty "
                        "unit span; flat = device merge (K2) + pos-prefix "
                        "copy; mask = device vals merge + pos-prefix and "
                        "the span's packed bits (implies --bitmask); auto = "
                        "per frame, from the measured copy rate and each "
                        "flavor's extra time")
    p.add_argument("--subtile", type=int, default=None,
                   help="tiled compaction unit in 128-byte rows (0 = whole "
                        "tiles; default 1)")
    p.add_argument("--pipelined", action="store_true",
                   help="one-frame-deep software pipeline: land frame N-1 "
                        "while frame N computes")
    p.add_argument("--bitmask", action="store_true",
                   help="the kernel also writes the packed change bits, "
                        "which offers the mask landing (requires --tiled)")
    p.add_argument("--maskonly", action="store_true",
                   help="bitmask-only emission: vals blocks and bits, no "
                        "index blocks (requires --fetch mask)")
    p.add_argument("--land-batch", type=int, default=0, metavar="K",
                   help="dispatch K frames, then land them in order "
                        "(requires --tiled; exclusive with --pipelined); "
                        "0 = off")
    p.add_argument("--capacity", type=int, default=None,
                   help="payload capacity bound in bytes (default: worst "
                        "case = frame bytes, never overflows); a frame that "
                        "changes more bytes is fatal under wire v1/v2 and "
                        "resynced with one raw frame under v3 (flat "
                        "payloads only)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)
    if args.aux_port is not None:
        raise NotImplementedError(
            "--aux-port is not ported to cudavideostream_tpu_torch yet: see "
            "ROADMAP.md M18")
    if args.fetch != "auto" and not args.tiled:
        p.error("--fetch tiles/flat/mask applies to --tiled payloads")
    if args.bitmask and not args.tiled:
        p.error("--bitmask applies to --tiled payloads")
    if args.maskonly and args.fetch != "mask":
        p.error("--maskonly requires --fetch mask (no index blocks exist "
                "for the tiles/flat landings)")
    if args.capacity is not None and args.tiled:
        p.error("--capacity applies to flat payloads only (tiled payloads "
                "are always worst-case capacity)")
    if args.land_batch:
        if not args.tiled:
            p.error("--land-batch requires --tiled payloads")
        if args.pipelined:
            p.error("--land-batch is exclusive with --pipelined")
    mask_flavor = args.bitmask or args.fetch == "mask"
    cfg = StreamConfig(
        height=args.height,
        width=args.width,
        threshold=args.threshold,
        visualizer=Visualizer(args.visualizer),
        noise_filter=args.noise_filter,
        conv_k=args.conv_k,
        host=args.host,
        port=args.port,
        payload_capacity=args.capacity,
        tiled_payload=args.tiled,
        fetch_mode=args.fetch,
        emit_bitmask=mask_flavor,
        # v4 forwards a mask landing's bits window as it is
        mask_payload=args.wire == "v4" and mask_flavor,
        maskonly_payload=args.maskonly,
        wire_format=args.wire,
        **({"subtile_rows": args.subtile}
           if args.subtile is not None else {}),
    )
    source = make_source(args.source, cfg, seed=args.seed)
    if args.land_batch:
        executor = BatchedLandExecutor(cfg, device=args.device,
                                       depth=args.land_batch)
    elif args.pipelined:
        executor = PipelinedExecutor(cfg, device=args.device)
    else:
        executor = StreamExecutor(cfg, device=args.device)
    if args.aux_dir:
        os.makedirs(args.aux_dir, exist_ok=True)
    server = DeltaStreamServer(cfg, source, executor=executor,
                               aux_dir=args.aux_dir)
    try:
        served = server.serve(max_frames=args.frames)
    finally:
        server.close()
    print(f"served {served} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
