"""Delta-stream recording and replay (a copy of the JAX package's
``runtime/replay.py``, host code only, over this package's ``wire``).

The wire stream is self-contained (base frame + ordered payloads), so a
byte-capture of it *is* a session journal. This module turns that into
an ops tool the reference lacks:

* recording: any capture of the raw bytes a server sends (``client
  --record session.cvs``, of this package or of the JAX one);
* :class:`ReplayServer` re-serves a recorded session to any number of
  sequential clients, byte-identically, with optional pacing — no
  accelerator needed (think: incident replay, client regression tests,
  demo reels).

File format: exactly the wire bytes (``[base][u32 pos][xs][vals]...``),
plus nothing — a recorded file can even be netcat'd at a client.
"""

from __future__ import annotations

import argparse
import os
import socket
import struct
import sys
import time


class ReplayServer:
    def __init__(self, path: str, frame_bytes: int, host: str = "127.0.0.1",
                 port: int = 2734, fps: float | None = None,
                 verbose: bool = True):
        self.path = path
        self.frame_bytes = frame_bytes
        self.host, self.port_arg = host, port
        self.fps = fps
        self.verbose = verbose
        self._sock: socket.socket | None = None
        self._file = None
        self._mm = None
        if path.endswith(".gz"):
            # gzipped sessions (the committed artifacts' format)
            # decompress into memory — no random access into a .gz
            import gzip

            with gzip.open(path, "rb") as f:
                self.data = f.read()
        else:
            # mmap, not read(): a raw-heavy v3 incident capture is
            # gigabytes (one scene cut = a full raw frame), and the
            # server only slices and sendall's — the page cache serves
            # it without holding the file resident
            import mmap

            self._file = open(path, "rb")
            size = os.fstat(self._file.fileno()).st_size
            if size:
                self._mm = mmap.mmap(
                    self._file.fileno(), 0, access=mmap.ACCESS_READ
                )
                self.data = self._mm
            else:
                self.data = b""
        from cudavideostream_tpu_torch.runtime import wire

        # v2/v3/v4 sessions start with their wire magic; frame framing
        # differs, but replay just forwards the captured bytes either
        # way. v4 shares v3's [mode][body] framing (one extra mode that
        # wire.v3_frame_extent measures), so it rides the v3 flag here.
        self.v2 = bytes(self.data[:len(wire.MAGIC_V2)]) == wire.MAGIC_V2
        self.v3 = bytes(self.data[:len(wire.MAGIC_V3)]) in (
            wire.MAGIC_V3, wire.MAGIC_V4,
        )
        hdr = len(wire.MAGIC_V2) if (self.v2 or self.v3) else 0
        if len(self.data) < hdr + frame_bytes:
            raise ValueError(f"{path}: shorter than one base frame")
        self.base_end = hdr + frame_bytes
        # pre-scan payload boundaries
        self.marks = []
        off = self.base_end
        min_hdr = 9 if self.v3 else (8 if self.v2 else 4)
        while off + min_hdr <= len(self.data):
            if self.v3:
                # size math shared with the live readers (wire.py is the
                # single place the v3 frame layout is measured)
                try:
                    end = wire.v3_frame_extent(
                        self.data, off, self.frame_bytes
                    )
                except ValueError as e:
                    if "truncated" in str(e):
                        break  # truncated tail: ignore
                    raise  # unknown mode = corrupt capture
            elif self.v2:
                pos, n_exc = struct.unpack_from("<II", self.data, off)
                end = off + 8 + 2 * pos + 4 * n_exc + pos
            else:
                (pos,) = struct.unpack_from("<I", self.data, off)
                end = off + 4 + pos * 5
            if end > len(self.data):
                break  # truncated tail: ignore
            self.marks.append((off, end))
            off = end

    def listen(self) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self.port_arg))
        srv.listen(5)
        self._sock = srv
        if self.verbose:
            print(
                f"replaying {self.path} ({len(self.marks)} frames) on "
                f"{self.host}:{self.port}",
                flush=True,
            )

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def serve(self, max_clients: int = 1) -> int:
        if self._sock is None:
            self.listen()
        served = 0
        for _ in range(max_clients):
            conn, _ = self._sock.accept()
            try:
                conn.sendall(self.data[: self.base_end])
                delay = 1.0 / self.fps if self.fps else 0.0
                for off, end in self.marks:
                    conn.sendall(self.data[off:end])
                    served += 1
                    if delay:
                        time.sleep(delay)
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                conn.close()
        return served

    def stats(self):
        """Per-frame wire analytics of the captured session.

        Returns a list of ``(pos, mode, wire_bytes)`` — ``mode`` is the
        v3 mode byte, "v2"/"v1" otherwise — plus nothing is sent
        anywhere: this is the offline inspection tool for recorded
        incidents (the reference's committed ``times*`` data files are
        the closest analogue). Totals via :func:`format_stats`.
        """
        from cudavideostream_tpu_torch.runtime import wire

        rows = []
        for off, end in self.marks:
            if self.v3:
                mode = self.data[off]
                if mode == wire.MODE_RAW:
                    pos = self.frame_bytes
                else:
                    (pos,) = struct.unpack_from("<I", self.data, off + 1)
            elif self.v2:
                (pos,) = struct.unpack_from("<I", self.data, off)
                mode = "v2"
            else:
                (pos,) = struct.unpack_from("<I", self.data, off)
                mode = "v1"
            rows.append((int(pos), mode, end - off))
        return rows

    def format_stats(self) -> str:
        """Human summary: frames, bytes by mode, density percentiles."""
        rows = self.stats()
        if not rows:
            return "empty session (base frame only)"
        import numpy as _np

        pos = _np.array([r[0] for r in rows])
        size = _np.array([r[2] for r in rows])
        dens = 100.0 * pos / self.frame_bytes
        by_mode = {}
        for _, m, b in rows:
            name = {0: "delta16", 1: "bitmask", 2: "raw",
                    3: "winmask"}.get(m, str(m))
            cnt, tot = by_mode.get(name, (0, 0))
            by_mode[name] = (cnt + 1, tot + b)
        lines = [
            f"frames: {len(rows)}  wire bytes: {int(size.sum())} "
            f"(+{self.frame_bytes} base)",
            f"changed bytes/frame: min {pos.min()}  p50 "
            f"{int(_np.percentile(pos, 50))}  max {pos.max()}  "
            f"(density p50 {_np.percentile(dens, 50):.2f}%)",
        ]
        for name, (cnt, tot) in sorted(by_mode.items()):
            lines.append(f"mode {name}: {cnt} frames, {tot} bytes")
        return "\n".join(lines)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        if self._mm is not None:
            self.data = b""
            self._mm.close()
            self._mm = None
        if self._file is not None:
            self._file.close()
            self._file = None


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="replay a recorded delta stream")
    p.add_argument("path")
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2734)
    p.add_argument("--fps", type=float, default=None, help="pace the replay")
    p.add_argument("--clients", type=int, default=1)
    p.add_argument("--stats", action="store_true",
                   help="print per-session wire analytics (frames, bytes "
                        "by mode, change density) and exit — offline "
                        "inspection of a recorded incident, no serving")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    server = ReplayServer(
        args.path, args.height * args.width * 3,
        host=args.host, port=args.port, fps=args.fps,
    )
    if args.stats:
        print(server.format_stats())
        server.close()
        return 0
    n = server.serve(max_clients=args.clients)
    print(f"replayed {n} payloads", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
