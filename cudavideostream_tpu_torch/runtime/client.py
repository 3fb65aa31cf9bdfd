"""The decoding client — peer of the reference ``client/opencv.cpp``
(port of the JAX package's ``runtime/client.py``, wire v1).

Connects, reads the raw base frame, then loops reading
``[u32 pos][i32 xs[pos]][u8 vals[pos]]`` and applying the uint8 wrap-add
scatter (``client/opencv.cpp:64-66``). No GUI dependency: ``--check``
prints a digest per second.

Run:  ``python -m cudavideostream_tpu_torch.runtime.client --check --frames 100``
"""

from __future__ import annotations

import argparse
import socket
import sys
import time

import numpy as np

from cudavideostream_tpu_torch.runtime import wire


class DeltaStreamClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 2734,
                 height: int = 1080, width: int = 1920):
        self.host, self.port = host, port
        self.n_bytes = height * width * 3
        self.frame: np.ndarray | None = None
        self.sock: socket.socket | None = None

    def connect(self) -> None:
        self.sock = socket.create_connection((self.host, self.port))
        self.frame = wire.read_base_frame(self.sock, self.n_bytes)

    def read_frame(self) -> tuple[int, np.ndarray]:
        """Read and apply one delta; returns (pos, reconstructed frame)."""
        pos, xs, vals = wire.read_payload(self.sock)
        if pos:
            if xs.min() < 0 or xs.max() >= self.n_bytes:
                raise ValueError("payload index out of range")
            # uint8 wrap-add scatter; add.at also accumulates repeated
            # indices, as the reference client's loop does
            np.add.at(self.frame, xs, vals)
        return pos, self.frame

    def close(self) -> None:
        if self.sock:
            self.sock.close()
            self.sock = None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="CUDA delta-stream client")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2734)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--check", action="store_true",
                   help="print a digest per second")
    args = p.parse_args(argv)

    cli = DeltaStreamClient(args.host, args.port, args.height, args.width)
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
