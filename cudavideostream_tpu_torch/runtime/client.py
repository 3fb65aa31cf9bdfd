"""The decoding client — peer of the reference ``client/opencv.cpp``
(port of the JAX package's ``runtime/client.py``, wire v1 to v4).

Connects, reads the raw base frame (after the v2/v3/v4 magic, which
``--wire auto`` sniffs), then loops reading one payload per frame and
applying the uint8 wrap-add scatter (``client/opencv.cpp:64-66``, in C:
``native.client_apply_np``); a v3 or v4 raw frame replaces the state
instead. No GUI dependency: ``--check``
prints a digest per second.

Run:  ``python -m cudavideostream_tpu_torch.runtime.client --check --frames 100``
"""

from __future__ import annotations

import argparse
import socket
import sys
import time

import numpy as np

from cudavideostream_tpu_torch import native
from cudavideostream_tpu_torch.runtime import wire


_MAGICS = {wire.MAGIC_V2: "v2", wire.MAGIC_V3: "v3", wire.MAGIC_V4: "v4"}


class DeltaStreamClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 2734,
                 height: int = 1080, width: int = 1920,
                 wire_format: str = "auto"):
        if wire_format not in ("auto", "v1", "v2", "v3", "v4"):
            raise ValueError(f"unknown wire_format {wire_format!r}")
        self.host, self.port = host, port
        self.n_bytes = height * width * 3
        # "auto" sniffs the 16-byte magic; the others pin the format
        self.wire_format = wire_format
        self.frame: np.ndarray | None = None
        self.sock: socket.socket | None = None

    def _read(self, n: int) -> bytes:
        return wire.read_exact(self.sock, n)

    def connect(self) -> None:
        self.sock = socket.create_connection((self.host, self.port))
        head = b""
        if self.wire_format in ("v2", "v3", "v4"):
            magic = {"v2": wire.MAGIC_V2, "v3": wire.MAGIC_V3,
                     "v4": wire.MAGIC_V4}[self.wire_format]
            if self._read(len(magic)) != magic:
                raise ValueError(
                    f"server did not send the {self.wire_format} wire magic")
        elif self.wire_format == "auto":
            # a v1 stream starts with the base frame: the 16 bytes read
            # here are then its first bytes
            head = self._read(len(wire.MAGIC_V2))
            self.wire_format = _MAGICS.get(head, "v1")
            if self.wire_format != "v1":
                head = b""
        rest = self._read(self.n_bytes - len(head))
        self.frame = np.frombuffer(head + rest, dtype=np.uint8).copy()

    def read_frame(self) -> tuple[int, np.ndarray]:
        """Read and apply one delta; returns (pos, reconstructed frame)."""
        if self.wire_format in ("v3", "v4"):
            # v4 is v3 plus mode 3, whose window bits read_frame_v3
            # rebuilds into indices
            pos, xs, vals, raw = wire.read_frame_v3(self._read, self.n_bytes)
            if raw is not None:
                self.frame = raw
                return self.n_bytes, self.frame
        elif self.wire_format == "v2":
            pos, xs, vals = wire.read_payload_v2(self._read)
        else:
            pos, xs, vals = wire.read_payload(self._read)
        if pos:
            # the native uint8 wrap-add scatter; repeated indices
            # accumulate, as in the reference client's loop. It raises
            # ValueError on an index outside the frame.
            native.client_apply_np(self.frame, xs, vals)
        return pos, self.frame

    def close(self) -> None:
        if self.sock:
            self.sock.close()
            self.sock = None


def write_ppm(path: str, frame: np.ndarray, height: int, width: int) -> None:
    """Dependency-free viewable dump: binary PPM (P6), BGR -> RGB."""
    img = frame.reshape(height, width, 3)[:, :, ::-1]
    with open(path, "wb") as f:
        f.write(f"P6\n{width} {height}\n255\n".encode())
        f.write(np.ascontiguousarray(img).tobytes())


def parse_args(argv=None) -> argparse.Namespace:
    """The command line. It takes every option of the JAX client; those of
    parts not ported yet (saving, PPM dumps, recording, the browser
    viewer, the aux stream) raise ``NotImplementedError`` naming their
    ``ROADMAP.md`` item."""
    p = argparse.ArgumentParser(description="CUDA delta-stream client")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2734)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--check", action="store_true",
                   help="print a digest per second")
    p.add_argument("--wire", default="auto",
                   choices=["auto", "v1", "v2", "v3", "v4"],
                   help="auto sniffs the v2/v3/v4 magic (default); v1 = "
                        "reference wire")
    for flag, kw in (("--save", {}), ("--ppm", {}),
                     ("--ppm-every", {"type": int}), ("--record", {}),
                     ("--http", {"type": int, "metavar": "PORT"}),
                     ("--aux", {"action": "store_true"}),
                     ("--aux-port", {"type": int, "metavar": "PORT"})):
        p.add_argument(flag, help="not ported yet: ROADMAP.md M18", **kw)
    args = p.parse_args(argv)
    given = [f for f in ("save", "ppm", "ppm_every", "record", "http",
                         "aux_port") if getattr(args, f) is not None]
    if given or args.aux:
        raise NotImplementedError(
            "the client's --save, --ppm, --ppm-every, --record, --http, "
            "--aux and --aux-port are not ported to cudavideostream_tpu_torch "
            "yet: see ROADMAP.md M18")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    cli = DeltaStreamClient(args.host, args.port, args.height, args.width,
                            wire_format=args.wire)
    cli.connect()
    print(f"base frame received ({cli.n_bytes} bytes)", flush=True)
    n = 0
    t0 = time.perf_counter()
    last = t0
    try:
        while args.frames is None or n < args.frames:
            pos, frame = cli.read_frame()
            n += 1
            now = time.perf_counter()
            if args.check and now - last >= 1.0:
                print(f"frame {n}: pos={pos} fps={n/(now-t0):.1f} "
                      f"digest={int(frame.sum())}", flush=True)
                last = now
    except (ConnectionError, KeyboardInterrupt):
        pass
    finally:
        cli.close()
    print(f"decoded {n} frames", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
