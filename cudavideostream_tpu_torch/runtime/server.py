"""The streaming TCP server — the port's main entry point (counterpart of
the JAX package's ``runtime/server.py``).

Wire-compatible rebuild of the reference server loop (``server.cpp:38-175``
+ ``th_show_hdl``, ``threads.cpp:181-237``): listen on one socket, accept
one client, ship the raw base frame, then one payload per frame — under
the default wire v1 ``[u32 pos][i32 xs[pos]][u8 vals[pos]]``, which the
reference OpenCV client decodes unmodified; under the opt-in v2/v3/v4
the magic first (``runtime.wire``). The 1 Hz status line is printed and
rendered into the stream via the glyph overlay (``server.cpp:164-168``).
Frames come from a camera (``--source v4l2``), a file (``--source file
--path F``) or the synthetic scene; ``--prefetch`` captures them on their
own thread. Wire v1 payloads go out with one ``writev`` each from the
native library (``native``), a tiled payload's units straight from their
blocks; v3 and v4 frames are encoded by its C encoder.

With a visualizer (``--visualizer 1-5``) each landed frame also brings
its aux frame to the host; ``--aux-dir`` dumps every ``aux_every``-th one
(30 by default) as a PPM file, the headless counterpart of the
reference's ``SERVER_IMSHOW``. The wire bytes do not change.

``--threshold-map FILE.npy`` replaces the scalar threshold with a per-byte
map (an ``(H, W)`` map is per pixel and repeats over the 3 channels):
a hair-trigger region inside an insensitive noisy scene. The wire bytes
and the client do not change.

Run:  ``python -m cudavideostream_tpu_torch.runtime.server --source synthetic``
      ``python -m cudavideostream_tpu_torch.runtime.server --source file --path frames.npy --prefetch``
      ``python -m cudavideostream_tpu_torch.runtime.server --source v4l2 --path /dev/video0``
      ``python -m cudavideostream_tpu_torch.runtime.server --visualizer 5 --aux-dir aux/``
      ``python -m cudavideostream_tpu_torch.runtime.server --tiled --pipelined --wire v3``
      ``python -m cudavideostream_tpu_torch.runtime.server --tiled --fetch mask --maskonly --wire v4 --land-batch 8``
      ``python -m cudavideostream_tpu_torch.runtime.server --threshold-map map.npy``
      ``python -m cudavideostream_tpu_torch.runtime.server --mesh 1,1 --pipelined``

``--mesh 1,S`` serves the stream from the sharded pipeline
(``parallel.sharded``): the frame's rows cut into S shards over S CUDA
devices, each compacting its rows with K1's ``index_offset`` mode, the
same wire bytes.

``--compaction sort`` compacts by one ``torch.sort`` on the card, and
``--compaction host`` packs on the host from an n/8-byte change bitmask
(``models.pipeline``); ``--backend oracle`` serves from the NumPy spec
with no device (``runtime.oracle_executor``). ``--aux-port`` serves the
live aux frame on a side socket (``runtime.auxstream``). ``--save-state``
writes the stream's state after serving and ``--resume`` serves from such
a file: its bytes are the base frame. ``--link-cache`` keeps the lander's
measured rates across sessions and ``--calibrate N`` (default 2) times N
copies from the card before the first frame.

      ``python -m cudavideostream_tpu_torch.runtime.server --compaction host``
      ``python -m cudavideostream_tpu_torch.runtime.server --visualizer 1 --aux-port 2735``
      ``python -m cudavideostream_tpu_torch.runtime.server --frames 300 --save-state s.npz``
      ``python -m cudavideostream_tpu_torch.runtime.server --resume s.npz --tiled --link-cache link.json``
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import time

import numpy as np

from cudavideostream_tpu_torch import native
from cudavideostream_tpu_torch.config import (
    CompactionBackend,
    PayloadOverflowError,
    StreamConfig,
    Visualizer,
)
from cudavideostream_tpu_torch.models import DeltaStreamPipeline
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.auxstream import AuxStreamSink
from cudavideostream_tpu_torch.runtime.client import write_ppm
from cudavideostream_tpu_torch.runtime.executor import (
    BatchedLandExecutor,
    PipelinedExecutor,
    StreamExecutor,
)
from cudavideostream_tpu_torch.runtime.oracle_executor import OracleExecutor
from cudavideostream_tpu_torch.runtime.sharded_executor import (
    PipelinedShardedExecutor,
    ShardedStreamExecutor,
    make_mesh,
)
from cudavideostream_tpu_torch.runtime.sources import (
    FrameSource,
    PrefetchSource,
    make_source,
)


class DeltaStreamServer:
    def __init__(self, config: StreamConfig, source: FrameSource,
                 executor: StreamExecutor | None = None, verbose: bool = True,
                 overlay_status: bool = True, device=None,
                 aux_dir: str | None = None, aux_every: int = 30,
                 resume: bool = False, aux_sink=None):
        self.cfg = config
        self.source = source
        self.executor = executor or StreamExecutor(config, device=device)
        self.verbose = verbose
        # resume: the executor already holds a state (load_state), and the
        # stream goes on from it: its bytes are the base frame, which a
        # client that kept its reconstruction already has
        self.resume = resume
        # the live aux relay (runtime.auxstream.AuxStreamSink): viewers
        # come and go, and a slow one never holds back the delta stream
        self.aux_sink = aux_sink
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
        if self.resume:
            base = self.executor.resync()
        else:
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
        if v3enc is not None or self.cfg.wire_format == "v2":
            if v3enc is not None:
                # v3 rebuilds a MaskPayload's indices; v4 forwards its bits
                buf = v3enc.encode(pos, xs, vals)
            else:
                if isinstance(xs, (wire.TiledPayload, wire.MaskPayload)):
                    xs, vals = xs.to_flat()
                buf = wire.pack_payload_v2(pos, xs, vals)
            conn.sendall(buf)
            # the metrics count v1 framing; correct them to the bytes sent
            self.executor.metrics.wire_bytes += len(buf) - (4 + 5 * pos)
        else:
            # v1 in C: a tiled payload's unit prefixes gathered into one
            # buffer, a flat payload's arrays in one writev
            if isinstance(xs, wire.MaskPayload):
                xs, vals = xs.to_flat()
            if isinstance(xs, wire.TiledPayload):
                rc = native.wire_send_segments_fd(conn.fileno(), pos,
                                                  xs.counts, xs.xs, xs.vals,
                                                  conn.gettimeout())
            else:
                rc = native.wire_send_payload_fd(conn.fileno(), pos, xs, vals,
                                                 conn.gettimeout())
            if rc < 0:
                raise BrokenPipeError(f"writev failed: {rc}")
        k, self._n_out = self._n_out, self._n_out + 1
        if self.aux_sink is not None and aux is not None:
            self.aux_sink.push(k, aux)
        if self.aux_dir and aux is not None and k % self.aux_every == 0:
            write_ppm(os.path.join(self.aux_dir, f"aux_{k:06d}.ppm"), aux,
                      self.cfg.height, self.cfg.width)


def load_threshold_map(path: str) -> np.ndarray:
    """The per-byte uint8 map of ``--threshold-map``: a 2-D ``(H, W)``
    array is per pixel and repeats over the 3 channels, anything else is
    per byte (the JAX server's ``server.py:452-456``)."""
    tm = np.load(path)
    if tm.ndim == 2:
        tm = np.repeat(tm.ravel(), 3)
    return np.asarray(tm, dtype=np.uint8).ravel()


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CUDA delta-stream server")
    p.add_argument("--source", default="synthetic",
                   choices=["synthetic", "file", "v4l2"],
                   help="synthetic scene, a .npy or raw BGR24 file "
                        "(--path), or a V4L2 camera (--path, default "
                        "/dev/video0)")
    p.add_argument("--path", help="file source path / camera device")
    p.add_argument("--prefetch", action="store_true",
                   help="capture on a dedicated thread, one frame ahead")
    p.add_argument("--compaction", default="pallas",
                   choices=[b.value for b in CompactionBackend],
                   help="pallas = the fused kernel (K1); sort = one "
                        "torch.sort over packed keys on the device; host = "
                        "the device ships the n/8-byte change bitmask and "
                        "the host packs")
    p.add_argument("--backend", default="device", choices=["device", "oracle"],
                   help="device = the PyTorch/CUDA pipeline; oracle = the "
                        "NumPy spec on the CPU (slow, no device)")
    p.add_argument("--mesh", default=None, metavar="D,S",
                   help="run the stream sharded over a (data=D, space=S) "
                        "device mesh (D*S CUDA devices, or every shard on "
                        "the CPU with --device cpu): image rows shard "
                        "across S, each shard compacting its own with K1; "
                        "D must be 1 (multiserve --mesh shards streams)")
    p.add_argument("--no-pair-lanes", action="store_true",
                   help="a TPU lane layout with identical outputs: no-op")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="serve on from a state checkpoint (.npz of "
                        "--save-state, either package's): its bytes are the "
                        "base frame, so a client that kept its "
                        "reconstruction stays byte-exact")
    p.add_argument("--save-state", default=None, metavar="CKPT",
                   help="write the stream's state checkpoint here after "
                        "serving")
    p.add_argument("--link-cache", default=None, metavar="JSON",
                   help="load the lander's measured copy rate and extra "
                        "times from this file before serving (if it "
                        "matches this configuration) and write them back "
                        "after; advisory, never a byte of the stream")
    p.add_argument("--calibrate", type=int, default=2, metavar="N",
                   help="time N copies of 512 KiB from the device into "
                        "pinned memory before the first frame and seed the "
                        "copy rate with them (0 disables; default 2; no-op "
                        "for --backend oracle/--mesh)")
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
                   help="also serve the live visualizer frame on this side "
                        "socket (client --aux, or the --http viewer's aux "
                        "panel); a slow viewer drops frames and never "
                        "stalls the delta stream (requires --visualizer)")
    p.add_argument("--threshold-map", default=None, metavar="FILE.npy",
                   help="per-byte uint8 threshold map (an (H, W) map is per "
                        "pixel) in place of --threshold")
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
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The command line. It takes every option of the JAX server, with its
    defaults; ``--no-pair-lanes`` is a no-op (a TPU lane layout with
    identical outputs). The refusals are the JAX server's own: those of
    flag combinations here, those that need the configuration in
    :func:`setup` and :func:`main`."""
    p = _parser()
    args = p.parse_args(argv)
    # the JAX server's refusals of --mesh (server.py:393-416)
    if args.mesh is not None:
        try:
            args.mesh = tuple(int(x) for x in args.mesh.split(","))
        except ValueError:
            args.mesh = ()
        if len(args.mesh) != 2 or min(args.mesh) < 1:
            p.error("--mesh takes D,S: two positive ints")
        if args.tiled or args.backend == "oracle":
            p.error("--mesh is exclusive with --tiled/--backend oracle")
        if args.compaction != CompactionBackend.PALLAS.value:
            p.error("--mesh supports --compaction pallas only")
        if args.capacity is not None:
            p.error("--capacity applies to flat single-chip payloads only")
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
        if args.pipelined or args.backend == "oracle":
            p.error("--land-batch is exclusive with --pipelined/--backend "
                    "oracle (the oracle executor lands per frame)")
    return args


def setup(argv=None):
    """Parse the command line (:func:`parse_args`); returns ``(config,
    executor, source, args)``, as :func:`main` serves them, in the JAX
    server's order (``server.py:506-534``): the executor on its pipeline
    (with the ``--threshold-map`` map, the ``--compaction`` backend), or
    the NumPy oracle; its state loaded under ``--resume``, its rates from
    ``--link-cache`` and ``--calibrate``; the source (``--source``,
    ``--path``, ``--seed``; behind a capture thread under ``--prefetch``).
    Under ``--link-cache`` or ``--calibrate`` (default 2), a device
    executor that is not resuming is started on the source's base frame
    before serving, as the JAX server starts its executor to compile its
    fetch jits (``server.py:526-533``). That takes the source's first
    frame: the stream's base frame is then the source's second one, as
    from the JAX server."""
    args = parse_args(argv)
    if args.aux_port is not None and not args.visualizer:
        _parser().error("--aux-port needs --visualizer (no aux frame exists)")
    cfg, executor = _executor(args)
    if args.resume or args.save_state:
        if not hasattr(executor, "load_state"):
            _parser().error("--resume/--save-state need a checkpointable "
                            "executor (not available under --mesh or "
                            "--backend oracle)")
    if args.resume:
        executor.load_state(args.resume)
    warmable = hasattr(executor, "load_link_cache")
    if args.link_cache and not warmable:
        _parser().error("--link-cache needs a device StreamExecutor (not "
                        "available under --mesh or --backend oracle)")
    if args.link_cache and executor.load_link_cache(args.link_cache):
        print(f"link cache loaded from {args.link_cache} (copy rate "
              f"{executor.copy_rate} B/s)", file=sys.stderr)
    if args.calibrate and warmable:
        rate = executor.calibrate_link(rounds=args.calibrate)
        print(f"calibrated copy rate {rate} B/s ({args.calibrate} copies)",
              file=sys.stderr)
    source = make_source(args.source, cfg, path=args.path, seed=args.seed)
    if args.prefetch:
        source = PrefetchSource(source)
    if warmable and (args.link_cache or args.calibrate):
        if not args.resume:
            executor.start(source.base_frame())
        n = executor.prewarm_fetch()
        print(f"prewarmed {n} fetch jits", file=sys.stderr)
    return cfg, executor, source, args


def _executor(args):
    """The configuration and the executor the command line asks for."""
    mask_flavor = args.bitmask or args.fetch == "mask"
    cfg = StreamConfig(
        height=args.height,
        width=args.width,
        threshold=args.threshold,
        visualizer=Visualizer(args.visualizer),
        noise_filter=args.noise_filter,
        conv_k=args.conv_k,
        compaction=CompactionBackend(args.compaction),
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
        pair_lanes=not args.no_pair_lanes,
        **({"subtile_rows": args.subtile}
           if args.subtile is not None else {}),
    )
    thr_map = (None if args.threshold_map is None
               else load_threshold_map(args.threshold_map))
    if args.mesh is not None:
        # --pipelined and --threshold-map compose with the mesh: the map
        # is cut along rows like the frame
        cls = (PipelinedShardedExecutor if args.pipelined
               else ShardedStreamExecutor)
        return cfg, cls(cfg, mesh=make_mesh(*args.mesh, device=args.device),
                        threshold_map=thr_map)
    if args.backend == "oracle":
        if thr_map is not None:
            _parser().error("--threshold-map is not supported by --backend "
                            "oracle")
        return cfg, OracleExecutor(cfg)
    pipe = DeltaStreamPipeline(cfg, device=args.device, threshold_map=thr_map)
    if args.land_batch:
        return cfg, BatchedLandExecutor(cfg, pipeline=pipe,
                                        depth=args.land_batch)
    if args.pipelined:
        return cfg, PipelinedExecutor(cfg, pipeline=pipe)
    return cfg, StreamExecutor(cfg, pipeline=pipe)


def main(argv=None) -> int:
    cfg, executor, source, args = setup(argv)
    if args.aux_dir:
        os.makedirs(args.aux_dir, exist_ok=True)
    aux_sink = None
    if args.aux_port is not None:
        aux_sink = AuxStreamSink(cfg.height, cfg.width, host=cfg.host,
                                 port=args.aux_port)
        print(f"aux stream on {cfg.host}:{aux_sink.port}", file=sys.stderr)
    server = DeltaStreamServer(cfg, source, executor=executor,
                               aux_dir=args.aux_dir, resume=bool(args.resume),
                               aux_sink=aux_sink)
    try:
        served = server.serve(max_frames=args.frames)
    finally:
        server.close()
        if aux_sink is not None:
            aux_sink.close()
        # the prefetch thread and the camera handle
        close = getattr(source, "close", None)
        if close is not None:
            close()
    if args.save_state:
        executor.save_state(args.save_state)
        print(f"state saved to {args.save_state}", file=sys.stderr)
    if args.link_cache:
        executor.save_link_cache(args.link_cache)
        print(f"link cache saved to {args.link_cache}", file=sys.stderr)
    print(f"served {served} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
