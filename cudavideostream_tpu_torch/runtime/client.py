"""The decoding client — peer of the reference ``client/opencv.cpp``
(port of the JAX package's ``runtime/client.py``, wire v1 to v4).

Connects, reads the raw base frame (after the v2/v3/v4 magic, which
``--wire auto`` sniffs), then loops reading one payload per frame and
applying the uint8 wrap-add scatter (``client/opencv.cpp:64-66``, in C:
``native.client_apply_np``); a v3 or v4 raw frame replaces the state
instead. No GUI dependency: ``--check`` prints a digest per second,
``--save`` keeps the rebuilt frames in a ``.npy``, ``--ppm`` dumps every
``--ppm-every``-th as a viewable image, and ``--record`` tees the raw wire
bytes to a session file that ``runtime.replay`` re-serves. ``--aux``
reads the server's aux side stream (``server --aux-port``) instead, and
``--http PORT`` relays the stream to a browser viewer
(``examples/viewer.html``) instead of decoding.

Run:  ``python -m cudavideostream_tpu_torch.runtime.client --check --frames 100``
      ``python -m cudavideostream_tpu_torch.runtime.client --record session.cvs --save frames.npy``
      ``python -m cudavideostream_tpu_torch.runtime.client --http 8080 --aux-port 2735``
"""

from __future__ import annotations

import argparse
import socket
import sys
import time
from pathlib import Path

import numpy as np

from cudavideostream_tpu_torch import native
from cudavideostream_tpu_torch.runtime import wire
from cudavideostream_tpu_torch.runtime.auxstream import AuxStreamClient


_MAGICS = {wire.MAGIC_V2: "v2", wire.MAGIC_V3: "v3", wire.MAGIC_V4: "v4"}


class DeltaStreamClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 2734,
                 height: int = 1080, width: int = 1920,
                 wire_format: str = "auto", record: str | None = None,
                 timeout: float | None = None):
        if wire_format not in ("auto", "v1", "v2", "v3", "v4"):
            raise ValueError(f"unknown wire_format {wire_format!r}")
        self.host, self.port = host, port
        self.n_bytes = height * width * 3
        # "auto" sniffs the 16-byte magic; the others pin the format
        self.wire_format = wire_format
        self.frame: np.ndarray | None = None
        self.sock: socket.socket | None = None
        # seconds a read may wait once connected (None: the socket's
        # default)
        self.timeout = timeout
        # every byte read is teed here: the wire stream is self-contained,
        # so the file is a session runtime.replay re-serves
        self._rec = open(record, "wb") if record else None

    def _read(self, n: int) -> bytes:
        data = wire.read_exact(self.sock, n)
        if self._rec:
            self._rec.write(data)
        return data

    def connect(self) -> None:
        self.sock = socket.create_connection((self.host, self.port))
        if self.timeout is not None:
            self.sock.settimeout(self.timeout)
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
        if self._rec:
            self._rec.close()
            self._rec = None


#: the browser viewer ``make_http_relay`` serves, read as a file
VIEWER = Path(__file__).resolve().parents[2] / "examples" / "viewer.html"


def make_http_relay(listen_port: int, server_host: str, server_port: int,
                    height: int, width: int, verbose: bool = False,
                    aux_port: int | None = None, timeout: float = 60.0,
                    listen_host: str = "0.0.0.0"):
    """A live browser bridge, the reference client's display loop
    (``client/opencv.cpp:68-69``) with no GUI dependency. Returns a
    ``ThreadingHTTPServer`` on ``listen_port`` (the caller runs
    ``serve_forever()``) serving:

    * ``/``: ``examples/viewer.html`` with its W/H defaults set to this
      stream's geometry (and its aux panel on with ``aux_port``);
    * ``/stream``: a new connection to the delta-stream server, its raw
      wire bytes piped through as a close-delimited HTTP/1.0 response,
      which the page decodes (the magic says the wire format);
    * ``/aux`` (with ``aux_port``): the same for the server's aux side
      stream (``server --aux-port``).

    Every socket waits at most ``timeout`` seconds: the browser's (the
    handler's ``timeout``) and each upstream one."""
    import http.server

    def pipe(handler, host, port, what):
        try:
            up = socket.create_connection((host, port), timeout=timeout)
        except OSError as e:
            handler.send_error(502, f"{what} unreachable: {e}")
            return
        handler.send_response(200)
        handler.send_header("Content-Type", "application/octet-stream")
        handler.send_header("Cache-Control", "no-store")
        handler.end_headers()
        try:
            while True:
                data = up.recv(1 << 16)
                if not data:
                    break
                handler.wfile.write(data)
        except OSError:
            pass  # the browser went away, or a stalled upstream timed out
        finally:
            up.close()

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # noqa: A002 - stdlib signature
            if verbose:
                sys.stderr.write("[http] " + fmt % a + "\n")

        def do_GET(self):
            path = self.path.split("?")[0]
            if path in ("/", "/index.html", "/viewer.html"):
                try:
                    html = VIEWER.read_bytes()
                except OSError:
                    self.send_error(404, "examples/viewer.html not found")
                    return
                html = html.replace(
                    b'id="w" value="480"', f'id="w" value="{width}"'.encode()
                ).replace(
                    b'id="h" value="270"', f'id="h" value="{height}"'.encode())
                if aux_port is not None:
                    html = html.replace(b"AUX_ENABLED = false",
                                        b"AUX_ENABLED = true")
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(html)))
                self.end_headers()
                self.wfile.write(html)
            elif path == "/aux" and aux_port is not None:
                pipe(self, server_host, aux_port, "aux stream")
            elif path == "/stream":
                pipe(self, server_host, server_port,
                     f"server {(server_host, server_port)}")
            else:
                self.send_error(404)

    Handler.timeout = timeout
    srv = http.server.ThreadingHTTPServer((listen_host, listen_port), Handler)
    srv.daemon_threads = True
    return srv


def write_ppm(path: str, frame: np.ndarray, height: int, width: int) -> None:
    """Dependency-free viewable dump: binary PPM (P6), BGR -> RGB."""
    img = frame.reshape(height, width, 3)[:, :, ::-1]
    with open(path, "wb") as f:
        f.write(f"P6\n{width} {height}\n255\n".encode())
        f.write(np.ascontiguousarray(img).tobytes())


def parse_args(argv=None) -> argparse.Namespace:
    """The command line: every option of the JAX client, with its
    defaults."""
    p = argparse.ArgumentParser(description="CUDA delta-stream client")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2734)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--check", action="store_true",
                   help="print a digest per second")
    p.add_argument("--save", help="save the rebuilt frames to this .npy")
    p.add_argument("--ppm", help="dump every --ppm-every-th frame as a "
                                 "viewable .ppm image with this path prefix")
    p.add_argument("--ppm-every", type=int, default=30)
    p.add_argument("--record", help="tee the raw wire stream to this file "
                                    "(replay it with runtime.replay)")
    p.add_argument("--wire", default="auto",
                   choices=["auto", "v1", "v2", "v3", "v4"],
                   help="auto sniffs the v2/v3/v4 magic (default); v1 = "
                        "reference wire")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="instead of decoding here, serve a live browser "
                        "viewer on this port: / is the page, /stream relays "
                        "the raw wire bytes of the server at --host/--port")
    p.add_argument("--aux", action="store_true",
                   help="read the server's aux (visualizer) side stream at "
                        "--port instead of the delta stream (server "
                        "--aux-port)")
    p.add_argument("--aux-port", type=int, default=None, metavar="PORT",
                   help="with --http: also relay the server's aux stream "
                        "from this port as /aux and show the viewer's aux "
                        "panel")
    return p.parse_args(argv)


def _serve_http(args) -> int:
    srv = make_http_relay(args.http, args.host, args.port, args.height,
                          args.width, verbose=args.check,
                          aux_port=args.aux_port)
    print(f"live viewer at http://localhost:{args.http}/ "
          f"(relaying {args.host}:{args.port})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


def _read_aux(args) -> int:
    aux = AuxStreamClient(args.host, args.port)
    aux.connect()
    print(f"aux stream: {aux.height}x{aux.width}", flush=True)
    n = 0
    t0 = last = time.perf_counter()
    try:
        while args.frames is None or n < args.frames:
            idx, frame = aux.read_frame()
            n += 1
            if args.ppm and (n - 1) % args.ppm_every == 0:
                write_ppm(f"{args.ppm}_{idx:06d}.ppm", frame, aux.height,
                          aux.width)
            now = time.perf_counter()
            if args.check and now - last >= 1.0:
                print(f"aux frame {idx}: fps={n/(now-t0):.1f} "
                      f"digest={int(frame.sum())}", flush=True)
                last = now
    except (ConnectionError, KeyboardInterrupt):
        pass
    finally:
        aux.close()
    print(f"received {n} aux frames", flush=True)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.http is not None:
        return _serve_http(args)
    if args.aux:
        return _read_aux(args)

    cli = DeltaStreamClient(args.host, args.port, args.height, args.width,
                            wire_format=args.wire, record=args.record)
    cli.connect()
    print(f"base frame received ({cli.n_bytes} bytes)", flush=True)
    saved = []
    n = 0
    t0 = time.perf_counter()
    last = t0
    try:
        while args.frames is None or n < args.frames:
            pos, frame = cli.read_frame()
            n += 1
            if args.save:
                saved.append(frame.copy())
            if args.ppm and (n - 1) % args.ppm_every == 0:
                write_ppm(f"{args.ppm}_{n:06d}.ppm", frame, args.height,
                          args.width)
            now = time.perf_counter()
            if args.check and now - last >= 1.0:
                print(f"frame {n}: pos={pos} fps={n/(now-t0):.1f} "
                      f"digest={int(frame.sum())}", flush=True)
                last = now
    except (ConnectionError, KeyboardInterrupt):
        pass
    finally:
        cli.close()
    if args.save and saved:
        np.save(args.save, np.stack(saved))
        print(f"saved {len(saved)} frames to {args.save}")
    print(f"decoded {n} frames", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
