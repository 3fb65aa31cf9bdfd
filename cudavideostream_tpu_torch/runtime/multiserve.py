"""Multi-stream server: B cameras, B ports, one card (the port of the JAX
package's ``runtime/multiserve.py``).

The reference binds one capture device to one socket
(``threads.cpp:166-237``). This server drives a
:class:`~cudavideostream_tpu_torch.models.batched.BatchedDeltaPipeline`
over B independent sources, one compaction launch per batched frame, and
serves stream ``b`` on ``port + b``. Clients are per stream and may join
mid-stream: a joiner's base frame is the stream's *current*
reconstruction, kept on the host with in-place scatters of each payload,
so no stream restarts.

Streams come from the synthetic scene (stream ``b`` seeded ``b``) or
from one file (``--source file --path F``, shared by every stream). Each
payload is applied to its stream's mirror by the native library's C
scatter; wire v1 payloads go out with its ``writev`` sender, v3 frames
through its C encoder.

With ``--mesh D,S`` the streams shard over a ``(data=D, space=S)`` mesh
(``parallel.sharded``, the ``"sharded"`` payload layout): stream ``b``
runs on data row ``b // (B / D)``, each frame's rows cut into S shards
that compact their rows with K1 flat and its ``index_offset`` mode, and
each stream's payload lands as one tile per shard, copied from the
device that holds it (the ``shards`` landing).

Run:  ``python -m cudavideostream_tpu_torch.runtime.multiserve --streams 4``
      ``python -m cudavideostream_tpu_torch.runtime.multiserve --streams 4 --mesh 1,1``
      ``python -m cudavideostream_tpu_torch.runtime.multiserve --streams 4 --source file --path frames.npy``
"""

from __future__ import annotations

import argparse
import os
import queue
import socket
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from cudavideostream_tpu_torch import native
from cudavideostream_tpu_torch.config import (
    PayloadOverflowError,
    StreamConfig,
    Visualizer,
)
from cudavideostream_tpu_torch.models import BatchedDeltaPipeline
from cudavideostream_tpu_torch.parallel.sharded import (
    ShardedDeltaPipeline,
    gather,
)
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.client import write_ppm
from cudavideostream_tpu_torch.runtime.executor import (
    ExecMetrics,
    TiledLander,
    _Copier,
    _Staged,
)
from cudavideostream_tpu_torch.runtime.sharded_executor import make_mesh
from cudavideostream_tpu_torch.runtime.sources import FrameSource, make_source


class MultiStreamServer:
    """B streams on one card: one batched step per frame, each stream's
    payload landed and sent to that stream's client. With a ``(data,
    space)`` mesh (``parallel.make_mesh``): the sharded pipeline's step,
    B divisible by the data axis."""

    def __init__(self, config: StreamConfig, sources: List[FrameSource],
                 verbose: bool = True, overlay_status: bool = True,
                 aux_dir: Optional[str] = None, aux_every: int = 30,
                 device=None, mesh=None):
        # aux_dir: where every aux_every-th batched frame's aux frames go,
        # one aux_<b>_<n>.ppm per stream
        if config.fetch_mode == "mask":
            # the batched step emits no packed change bits
            raise ValueError(
                "fetch_mode 'mask' is not supported by the multi-stream "
                "server — use tiles/flat/auto (the mask flavor rides the "
                "solo StreamExecutor/BatchedLandExecutor landings)")
        self.cfg = config
        self.sources = sources
        self.B = len(sources)
        self._sharded = mesh is not None
        if self._sharded:
            if self.B % mesh.shape["data"]:
                raise ValueError(f"{self.B} streams not divisible by "
                                 f"data={mesh.shape['data']}")
            self.pipe = ShardedDeltaPipeline(config, mesh,
                                             payload_layout="sharded")
            first = mesh.device(0, 0)
        else:
            self.pipe = BatchedDeltaPipeline(config, self.B, device=device)
            first = self.pipe.device
        self.aux_dir = aux_dir
        self.aux_every = aux_every
        self.verbose = verbose
        self.overlay_status = overlay_status
        self._socks: List[socket.socket] = []
        self._pending: List["queue.Queue[socket.socket]"] = [
            queue.Queue() for _ in range(self.B)]
        self._arrived = threading.Event()  # some client is pending
        self._clients: List[Optional[socket.socket]] = [None] * self.B
        self._stop = threading.Event()
        # the sharded layout lands each shard's count-prefix from its own
        # device: a device merge would gather every shard to one device
        self._lander = TiledLander("shards" if self._sharded
                                   else config.fetch_mode)
        self._copier = _Copier(first)
        self.metrics = ExecMetrics()

    @property
    def fetch_counts(self) -> dict:
        """Landings per flavor, over every stream."""
        return self._lander.fetch_counts

    def listen(self) -> None:
        for b in range(self.B):
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((self.cfg.host,
                      self.cfg.port + b if self.cfg.port else 0))
            srv.listen(4)
            self._socks.append(srv)
            threading.Thread(target=self._accept_loop, args=(b,),
                             daemon=True).start()
        if self.verbose:
            print(f"multi-stream server: {self.B} streams on ports "
                  f"{self.ports}", flush=True)

    @property
    def ports(self) -> List[int]:
        return [s.getsockname()[1] for s in self._socks]

    def _accept_loop(self, b: int) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._socks[b].accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._pending[b].put(conn)
            self._arrived.set()

    def _admit(self, b: int, recon: np.ndarray) -> None:
        """Admit stream b's joiners at this frame boundary, the stream's
        reconstruction as their base frame; the latest client wins."""
        while True:
            try:
                conn = self._pending[b].get_nowait()
            except queue.Empty:
                return
            try:
                if self._clients[b] is not None:
                    self._clients[b].close()
                    # a failed handshake below must not leave the slot on
                    # this closed socket
                    self._clients[b] = None
                conn.sendall(wire.MAGICS.get(self.cfg.wire_format, b"")
                             + recon.tobytes())
                self._clients[b] = conn
                if self.verbose:
                    print(f"\nstream {b}: client joined", flush=True)
            except OSError:
                conn.close()

    def _send(self, b: int, buf: bytes) -> None:
        try:
            self._clients[b].sendall(buf)
        except OSError:
            self._drop(b)

    def _send_v1(self, b: int, p: int, xs, vals) -> None:
        """One wire v1 payload in one native ``writev``."""
        conn = self._clients[b]
        if native.wire_send_payload_fd(conn.fileno(), p, xs, vals,
                                       conn.gettimeout()) < 0:
            self._drop(b)

    def _drop(self, b: int) -> None:
        self._clients[b].close()
        self._clients[b] = None
        if self.verbose:
            print(f"\nstream {b}: client dropped", flush=True)

    def _land(self, outs):
        """One batched step's payloads on the host: per stream a
        TiledPayload or flat ``(xs, vals)``, or None where a flat payload
        overflowed the capacity; returns ``(pos (B,), payloads, aux)``."""
        if self._sharded:
            return self._land_sharded(outs)
        if self.cfg.tiled_payload:
            staged = _Staged(outs, 2)
            pos, counts = staged.wait()
            _, counts_d, xs_t_d, vals_t_d, _ = outs
            payloads = self._lander.land_many(
                [(int(pos[b]), counts[b].astype(np.int32), counts_d[b],
                  xs_t_d[b], vals_t_d[b]) for b in range(self.B)],
                staged, self._copier)
        else:
            staged = _Staged(outs, 1)
            (pos,) = staged.wait()
            _, xs_d, vals_d, _ = outs
            fits = [int(p) <= self.cfg.capacity for p in pos]
            host = iter(self._copier.run(staged, lambda: [
                t for b in range(self.B) if fits[b]
                for t in (xs_d[b, :int(pos[b])], vals_d[b, :int(pos[b])])]))
            payloads = [(next(host), next(host)) if fits[b] else None
                        for b in range(self.B)]
        return pos, payloads, self._copier.land_aux(staged)

    def _land_sharded(self, outs):
        """The sharded step's payloads: its ``(data, space)`` grids of
        per-shard counts ``(B/D, 1)`` and flat blocks ``(B/D, Ln)``; each
        stream's shards land as one TiledPayload (the ``shards``
        flavor)."""
        counts_g, xs_g, vals_g, aux_g = outs
        S, D = self.pipe.n_space, self.pipe.n_data

        def join(parts):  # the grid's per-shard arrays, listed row by row
            return gather([parts[d * S:(d + 1) * S] for d in range(D)])

        staged = _Staged((sum(counts_g, []),
                          None if aux_g is None else sum(aux_g, [])), 1,
                         aux_join=join)
        counts = join(staged.wait()[0]).astype(np.int32)  # (B, S)
        Bl = self.B // D
        payloads = self._lander.land_many(
            [(int(counts[b].sum()), counts[b], None,
              [x[b % Bl] for x in xs_g[b // Bl]],
              [v[b % Bl] for v in vals_g[b // Bl]]) for b in range(self.B)],
            staged, self._copier)
        return (counts.sum(axis=1, dtype=np.int64), payloads,
                self._copier.land_aux(staged))

    def serve(self, max_frames: Optional[int] = None,
              wait_first_client: bool = True,
              resume_from: Optional[str] = None,
              checkpoint_to: Optional[str] = None) -> int:
        """Serve until ``max_frames`` batched frames or a source ends.
        ``resume_from``: restart from a checkpoint's per-stream
        reconstructions (the ``.npz`` that ``checkpoint_to`` writes when
        serving ends, the JAX server's format: ``recon`` and
        ``geometry``)."""
        if not self._socks:
            self.listen()
        if resume_from:
            data = np.load(resume_from if resume_from.endswith(".npz")
                           else resume_from + ".npz")
            if tuple(data["geometry"]) != (self.B, self.cfg.height,
                                           self.cfg.width):
                raise ValueError("checkpoint geometry mismatch")
            bases = np.asarray(data["recon"], dtype=np.uint8)
        else:
            bases = np.stack([src.base_frame() for src in self.sources])
        state = self.pipe.init_state(bases)
        recon = bases.copy()  # per-stream host mirror for joiners
        if wait_first_client:
            while not self._arrived.wait(0.1) and not self._stop.is_set():
                pass
        texts = [""] * self.B
        nb = self.cfg.frame_bytes
        v34 = self.cfg.wire_format in ("v3", "v4")
        n = 0
        try:
            while max_frames is None or n < max_frames:
                for b in range(self.B):
                    self._admit(b, recon[b])
                try:
                    frames = np.stack([next(src) for src in self.sources])
                except StopIteration:
                    break
                t0 = time.perf_counter()
                state, *outs = self.pipe.step(state, frames, texts)
                pos, payloads, aux = self._land(outs)
                wire_total = 0
                for b in range(self.B):
                    p = int(pos[b])
                    pl = payloads[b]
                    if pl is None:
                        if not v34:
                            raise PayloadOverflowError(
                                f"stream {b} changed {p} bytes > "
                                f"payload_capacity {self.cfg.capacity}")
                        # per-stream raw recovery: stream b's client takes
                        # its post-step state; the others are unaffected
                        recon[b] = state[b * nb:(b + 1) * nb].cpu().numpy()
                        if self._clients[b] is not None:
                            buf = bytes([wire.MODE_RAW]) + recon[b].tobytes()
                            wire_total += len(buf)
                            self._send(b, buf)
                        continue
                    xs, vals = (pl.to_flat()
                                if isinstance(pl, wire.TiledPayload) else pl)
                    native.client_apply_np(recon[b], xs, vals)
                    if self._clients[b] is None:
                        continue
                    if self.cfg.wire_format == "v1":
                        # the mirror's scatter flattened a tiled payload
                        # already: its flat arrays go out as they are
                        wire_total += 4 + 5 * p
                        self._send_v1(b, p, xs, vals)
                        continue
                    if v34:
                        # recon[b] is the client's state after this payload
                        enc = (wire.encode_frame_v4
                               if self.cfg.wire_format == "v4"
                               else wire.encode_frame_v3)
                        buf = enc(p, xs, vals, recon[b])
                    else:
                        buf = wire.pack_payload_v2(p, xs, vals)
                    wire_total += len(buf)
                    self._send(b, buf)
                if (self.aux_dir and aux is not None
                        and n % self.aux_every == 0):
                    for b, frame in enumerate(aux.reshape(self.B, -1)):
                        write_ppm(os.path.join(self.aux_dir,
                                               f"aux_{b}_{n:06d}.ppm"),
                                  frame, self.cfg.height, self.cfg.width)
                n += 1
                self.metrics.record(time.perf_counter() - t0,
                                    int(pos.sum(dtype=np.int64)),
                                    wire_bytes=wire_total)
                line = self.metrics.status_line()
                if line:
                    if self.overlay_status:
                        texts = [self.metrics.overlay_text()] * self.B
                    if self.verbose:
                        print(f"\r{line}  STREAMS: {self.B}", end="",
                              flush=True)
        finally:
            # the checkpoint is written whatever ends the session: a
            # stop-and-resume must not depend on a clean --frames exit
            if checkpoint_to:
                np.savez(checkpoint_to, recon=recon,
                         geometry=np.array([self.B, self.cfg.height,
                                            self.cfg.width]))
            self.close()
        return n

    def close(self) -> None:
        self._stop.set()
        for s in self._socks:
            s.close()
        for b, c in enumerate(self._clients):
            if c is not None:
                c.close()
                self._clients[b] = None


def parse_args(argv=None) -> argparse.Namespace:
    """The command line: every option of the JAX multi-stream server."""
    p = argparse.ArgumentParser(description="multi-stream (B cameras) server")
    p.add_argument("--streams", type=int, default=2)
    p.add_argument("--source", default="synthetic",
                   choices=["synthetic", "file"],
                   help="synthetic scenes (stream b seeded b) or one file "
                        "(--path) for every stream")
    p.add_argument("--path", help="file source path (shared by streams)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2734,
                   help="stream b listens on port+b")
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--wire", default="v1", choices=["v1", "v2", "v3", "v4"])
    p.add_argument("--visualizer", type=int, default=0,
                   choices=[v.value for v in Visualizer],
                   help="0 none, 1 heatmap, 2 red-black, 3 red-overlap, "
                        "4 grayscale, 5 binarize (per stream)")
    p.add_argument("--noise-filter", action="store_true")
    p.add_argument("--conv-k", type=int, default=3)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--resume-from", default=None,
                   help="resume from a per-stream state checkpoint (.npz "
                        "written by --checkpoint-to)")
    p.add_argument("--checkpoint-to", default=None,
                   help="write the per-stream state when serving ends")
    p.add_argument("--mesh", default=None, metavar="D,S",
                   help="shard the B streams over a (data=D, space=S) "
                        "device mesh (B divisible by D; image rows shard "
                        "across S; every shard on the CPU with --device "
                        "cpu)")
    p.add_argument("--aux-dir", default=None,
                   help="dump per-stream visualizer aux frames here as "
                        "aux_<stream>_<frame>.ppm")
    p.add_argument("--capacity", type=int, default=None,
                   help="per-stream payload capacity bound in bytes: selects "
                        "the flat payload; overflow is fatal under v1/v2, a "
                        "per-stream raw resync under v3/v4")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)
    if args.mesh is not None:
        try:
            args.mesh = tuple(int(x) for x in args.mesh.split(","))
        except ValueError:
            args.mesh = ()
        if len(args.mesh) != 2 or min(args.mesh) < 1:
            p.error("--mesh takes D,S: two positive ints")
        if args.capacity is not None:
            p.error("--capacity applies to the single-chip batched path "
                    "only")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    # the tiled payload is the batched fast path (one launch for every
    # stream); a capacity bound needs the flat payload, and the mesh has
    # its own payload layout
    cfg = StreamConfig(height=args.height, width=args.width, host=args.host,
                       port=args.port, wire_format=args.wire,
                       visualizer=Visualizer(args.visualizer),
                       noise_filter=args.noise_filter, conv_k=args.conv_k,
                       tiled_payload=args.mesh is None
                       and args.capacity is None,
                       payload_capacity=args.capacity)
    sources = [make_source(args.source, cfg, path=args.path, seed=b)
               for b in range(args.streams)]
    if args.aux_dir:
        os.makedirs(args.aux_dir, exist_ok=True)
    mesh = None
    if args.mesh is not None:
        mesh = make_mesh(*args.mesh, device=args.device)
    server = MultiStreamServer(cfg, sources, aux_dir=args.aux_dir,
                               device=args.device, mesh=mesh)
    n = server.serve(max_frames=args.frames, resume_from=args.resume_from,
                     checkpoint_to=args.checkpoint_to)
    print(f"served {n} batched frames over {args.streams} streams",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
