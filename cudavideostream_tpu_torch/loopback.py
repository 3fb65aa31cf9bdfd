"""Full streaming-loop benchmark: capture -> diff -> compress -> socket ->
client decode, over a real localhost TCP connection (the port of the JAX
package's ``benchmarks/loopback.py``, BASELINE.json's "full streaming
loop"; the reference's end-to-end number is 26 fps, capture-bound,
``report.tex:914``).

The frames come from the NumPy ``SyntheticSource``, whose host time sets
the device rows' rate; ``loopback_sweep`` serves from a source on the
card. Also reports the pure-CPU oracle diff-encode rate (the reference's
CPU path: 7 fps / 140 ms, ``report.tex:308``). Each loop ends with the
client's reconstruction held against the server's state.

    python -m cudavideostream_tpu_torch.loopback [--height 1080 --width 1920]
        [--frames 10] [--out FILE] [--device cpu]

It runs on the card at 1080p and raises without one unless ``--device
cpu`` is given: then the plain PyTorch versions at 48x64, on the host
clock, which is no device metric.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np
import torch

SOCKET_TIMEOUT_S = 120.0  # any one accept, connect or read


def cpu_oracle_rate(height, width, frames=5):
    """ms a frame of the NumPy ``diff_encode`` at ~6% scattered change."""
    from cudavideostream_tpu_torch.ops import reference_cpu as ref

    n = height * width * 3
    rng = np.random.default_rng(0)
    prev = rng.integers(0, 255, n, endpoint=True, dtype=np.uint8)
    cur = np.where(
        rng.random(n) < 0.06, (prev.astype(np.int32) + 100) % 256, prev
    ).astype(np.uint8)
    t0 = time.perf_counter()
    for _ in range(frames):
        ref.diff_encode(cur, prev)
    return 1e3 * (time.perf_counter() - t0) / frames


def loopback_rate(height, width, frames, backend, wire="v1", tiled=False,
                  fetch="auto", device=None):
    """ms a frame the client reads, after two warm-up frames, from the
    port's server (``backend`` "oracle": the NumPy executor; "device":
    ``StreamExecutor`` on ``device``) serving ``SyntheticSource``. Raises
    when the client's last frame is not the server's state."""
    from cudavideostream_tpu_torch.config import StreamConfig
    from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
    from cudavideostream_tpu_torch.runtime.executor import StreamExecutor
    from cudavideostream_tpu_torch.runtime.oracle_executor import OracleExecutor
    from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    cfg = StreamConfig(height=height, width=width, port=0, wire_format=wire,
                       tiled_payload=tiled, fetch_mode=fetch)
    executor = (OracleExecutor(cfg) if backend == "oracle"
                else StreamExecutor(cfg, device=device))
    server = DeltaStreamServer(cfg, SyntheticSource(cfg, seed=0),
                               executor=executor, verbose=False)
    server.listen().settimeout(SOCKET_TIMEOUT_S)
    served, errors = [], []

    def serve():
        try:
            served.append(server.serve(max_frames=frames + 2))
        except Exception as e:  # re-raised on the caller's thread
            errors.append(e)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    cli = DeltaStreamClient("127.0.0.1", server.port, height, width,
                            timeout=SOCKET_TIMEOUT_S)
    try:
        cli.connect()
        cli.read_frame()  # warm-up (the kernels' first use)
        cli.read_frame()
        t0 = time.perf_counter()
        for _ in range(frames):
            cli.read_frame()
        ms = 1e3 * (time.perf_counter() - t0) / frames
        t.join(timeout=SOCKET_TIMEOUT_S)
        got = cli.frame
    finally:
        cli.close()
        server.close()
    if t.is_alive():
        raise RuntimeError("the server did not finish")
    if errors:
        raise errors[0]
    if served != [frames + 2] or not np.array_equal(got, executor.resync()):
        raise AssertionError(f"{backend} {wire} tiled={tiled} {fetch}: the "
                             "client's frame is not the server's state")
    return ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cudavideostream_tpu_torch.loopback",
        description="the full streaming loop's ms a frame over TCP "
                    "(the JAX package's benchmarks/loopback.py)")
    p.add_argument("--height", type=int, default=None,
                   help="default 1080 (48 with --device cpu)")
    p.add_argument("--width", type=int, default=None,
                   help="default 1920 (64 with --device cpu)")
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None,
                   help="cpu: the plain PyTorch versions on the host clock "
                        "(default: the card)")
    args = p.parse_args(argv)
    from cudavideostream_tpu_torch.bench import card_line
    from cudavideostream_tpu_torch.models.pipeline import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    height = args.height or (1080 if on_card else 48)
    width = args.width or (1920 if on_card else 64)
    where = (f"{torch.cuda.get_device_name(dev)} ({card_line()})" if on_card
             else "the CPU, the plain PyTorch versions; host clock, no "
                  "device metric")
    print(f"full loop {height}x{width} on {where}", flush=True)

    rows = []

    def report(name, ms, text, note=""):
        rows.append((name, ms))
        print(f"{text}: {ms:8.2f} ms/frame ({1e3 / ms:6.1f} fps){note}",
              flush=True)

    report("cpu_oracle_diff_encode", cpu_oracle_rate(height, width),
           "CPU oracle diff-encode", " [reference CPU: 140 ms / 7 fps]")
    report("loop_oracle_backend",
           loopback_rate(height, width, args.frames, "oracle"),
           "full loop (oracle backend, TCP loopback)")
    report("loop_device_backend",
           loopback_rate(height, width, args.frames, "device", device=dev),
           "full loop (device backend, TCP loopback)",
           " [reference: ~38 ms / 26 fps]")
    report("loop_device_backend_wire_v2",
           loopback_rate(height, width, args.frames, "device", wire="v2",
                         device=dev),
           "full loop (device backend, wire v2)")
    # the tiled payload's landing flavors; "auto" picks per frame from
    # the copy rate and each flavor's extra time it has measured
    for fetch in ("tiles", "flat", "auto"):
        report(f"loop_device_tiled_fetch_{fetch}",
               loopback_rate(height, width, args.frames, "device",
                             tiled=True, fetch=fetch, device=dev),
               f"full loop (tiled payload, fetch={fetch})")
    if args.out:
        with open(args.out, "w") as f:
            f.write(f"# leg\tms_per_frame ({height}x{width} on {where}; "
                    f"reference end-to-end: 38 ms / 26 fps, "
                    f"report.tex:914)\n")
            for name, ms in rows:
                f.write(f"{name}\t{ms:.2f}\n")
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
