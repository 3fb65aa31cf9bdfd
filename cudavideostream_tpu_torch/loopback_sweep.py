"""End-to-end 1080p serving sweep: the port of the JAX package's
``benchmarks/loopback_sweep.py``.

The real serving path — executor dispatch, payload landing, wire send
over a real TCP socket to a real decoding client — swept across {capture:
device-generated / host} x {density: clustered ~1%/3%/6%} x {fetch:
tiles/flat/auto/mask/maskonly} x {wire: v1-v4} x {solo, pipelined,
landing batches of K = 4/8/16} (and the HOST backend), with the time of
each leg per row:

* capture  — ``next(source)``: host synthesis for host rows (whose
  6.2 MB upload then falls in dispatch); for device rows the frame is
  made on the card (:class:`DeviceClusteredSource`) and capture is the
  launch of its torch ops;
* dispatch — ``executor._dispatch``: the step's launches and the queued
  copies of its sizes (the card works on behind them);
* land     — ``executor._land``: the wait for the sizes, then the
  payload's copies to the host and its host rebuild;
* send     — wire encode and socket write to the client.

Every row ends with a byte-exactness gate: the client's reconstruction
must equal the server's device state (``executor.resync()``).

The clustered scene: a contiguous band of ``density * n`` bytes flips
between +77 and +154 over the base frame each frame, drifting 4,096 B a
frame — ~``density * n + 4096`` changed bytes a frame, clustered like a
moving subject (the reference's measured scene is 5.93% changed,
``report.tex:2594``).

The client decodes on a thread of this process, as in the JAX harness:
its decode competes with the serving loop for the interpreter lock and
shows in the send leg. A ``pipelined`` row runs ``PipelinedExecutor``'s
dispatch and landing back to back, as the JAX harness does, so it times
the class on the solo schedule, not the one-frame overlap.

    python -m cudavideostream_tpu_torch.loopback_sweep [--frames 10]
        [--quick] [--rows A,B] [--repeat N] [--height H --width W]
        [--out FILE] [--device cpu]

It runs on the card at 1080p and raises without one unless ``--device
cpu`` is given: then the plain PyTorch versions at 48x64, timed on the
host clock, which is no device metric. A row that raises prints its
``FAILED`` line and one that fails its gate its ``MISMATCH`` line; the
process then exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import socket
import sys
import threading
import time
import traceback

import numpy as np
import torch

STRIDE = 4096
SOCKET_TIMEOUT_S = 120.0  # any one connect, accept, send or read

# (label, capture, density, fetch, wire, backend, pipelined): pipelined is
# True for PipelinedExecutor, an int K for BatchedLandExecutor(depth=K);
# the JAX sweep's rows under its labels (benchmarks/loopback_sweep.py)
MATRIX = [
    ("dev_d6_tiles_v1", "device", 0.06, "tiles", "v1", "pallas", False),
    ("dev_d6_tiles_v3", "device", 0.06, "tiles", "v3", "pallas", False),
    ("dev_d3_tiles_v1", "device", 0.03, "tiles", "v1", "pallas", False),
    ("dev_d3_tiles_v2", "device", 0.03, "tiles", "v2", "pallas", False),
    ("dev_d3_tiles_v3", "device", 0.03, "tiles", "v3", "pallas", False),
    ("dev_d3_flat_v3", "device", 0.03, "flat", "v3", "pallas", False),
    ("dev_d3_auto_v3", "device", 0.03, "auto", "v3", "pallas", False),
    ("dev_d1_tiles_v1", "device", 0.01, "tiles", "v1", "pallas", False),
    ("dev_d1_tiles_v3", "device", 0.01, "tiles", "v3", "pallas", False),
    ("dev_d1_tiles_v3_pipelined",
     "device", 0.01, "tiles", "v3", "pallas", True),
    # depth-K landing batch (--land-batch): legs are per-frame means
    ("dev_d1_tiles_v3_batch4", "device", 0.01, "tiles", "v3", "pallas", 4),
    ("dev_d1_tiles_v3_batch8", "device", 0.01, "tiles", "v3", "pallas", 8),
    ("dev_d3_tiles_v3_batch4", "device", 0.03, "tiles", "v3", "pallas", 4),
    ("dev_d1_flat_v3_batch8", "device", 0.01, "flat", "v3", "pallas", 8),
    ("dev_d1_flat_v3_batch16", "device", 0.01, "flat", "v3", "pallas", 16),
    ("dev_d3_flat_v3_batch8", "device", 0.03, "flat", "v3", "pallas", 8),
    # the mask flavor: the packed change-bits window and the merged vals
    ("dev_d1_mask_v3_batch8", "device", 0.01, "mask", "v3", "pallas", 8),
    ("dev_d1_mask_v3_batch16", "device", 0.01, "mask", "v3", "pallas", 16),
    ("dev_d3_mask_v3_batch8", "device", 0.03, "mask", "v3", "pallas", 8),
    ("dev_d6_mask_v3_batch8", "device", 0.06, "mask", "v3", "pallas", 8),
    # wire v4 forwards the bits window (mask_payload): no index stream
    ("dev_d1_mask_v4_batch16", "device", 0.01, "mask", "v4", "pallas", 16),
    ("dev_d3_mask_v4_batch8", "device", 0.03, "mask", "v4", "pallas", 8),
    ("dev_d6_mask_v4_batch8", "device", 0.06, "mask", "v4", "pallas", 8),
    # v4 from the index stream: the encoder's gain without the mask fetch
    ("dev_d3_flat_v4_batch8", "device", 0.03, "flat", "v4", "pallas", 8),
    # the bitmask-only emission (maskonly_payload): no index blocks
    ("dev_d1_maskonly_v4_batch8",
     "device", 0.01, "maskonly", "v4", "pallas", 8),
    ("dev_d1_maskonly_v4_batch16",
     "device", 0.01, "maskonly", "v4", "pallas", 16),
    ("dev_d1_maskonly_v3_batch8",
     "device", 0.01, "maskonly", "v3", "pallas", 8),
    ("dev_d3_maskonly_v4_batch8",
     "device", 0.03, "maskonly", "v4", "pallas", 8),
    # host capture (left out by --quick), and the HOST backend
    ("host_d3_tiles_v3", "host", 0.03, "tiles", "v3", "pallas", False),
    ("host_d1_tiles_v3", "host", 0.01, "tiles", "v3", "pallas", False),
    ("hostbk_d3_v3", "host", 0.03, "-", "v3", "host", False),
    ("hostbk_d1_v1", "host", 0.01, "-", "v1", "host", False),
]


class HostClusteredSource:
    """The clustered scene made on the host (deterministic in t)."""

    def __init__(self, cfg, density, seed=0):
        self.n = cfg.frame_bytes
        self.band = max(1, int(density * self.n))
        rng = np.random.default_rng(seed)
        self.base = rng.integers(0, 255, self.n, endpoint=True, dtype=np.uint8)
        self.t = 0

    def base_frame(self):
        return self.base

    def __iter__(self):
        return self

    def __next__(self):
        t = self.t
        self.t += 1
        start = (t * STRIDE) % max(1, self.n - self.band)
        delta = np.uint8(77 if t % 2 == 0 else 154)
        f = self.base.copy()
        f[start : start + self.band] += delta  # uint8 wrap
        return f


class DeviceClusteredSource:
    """The same scene made on the device: ``next`` returns a new flat
    uint8 tensor there (``pipeline.step`` takes it as it is). The base
    and an index vector go up once; a frame's band and delta come from
    Python ints, so making it waits on nothing. Each frame is a new
    tensor: a queued step may still read the one before."""

    def __init__(self, cfg, density, seed=0, device=None):
        from cudavideostream_tpu_torch.models.pipeline import resolve_device

        self.host = HostClusteredSource(cfg, density, seed)
        dev = resolve_device(device)
        self._base = torch.from_numpy(self.host.base.copy()).to(dev)
        self._idx = torch.arange(self.host.n, dtype=torch.int32, device=dev)
        self.t = 0

    def base_frame(self):
        return self.host.base

    def __iter__(self):
        return self

    def __next__(self):
        t = self.t
        self.t += 1
        n, band = self.host.n, self.host.band
        start = (t * STRIDE) % max(1, n - band)
        m = (self._idx >= start) & (self._idx < start + band)
        # uint8 + int stays uint8 and wraps, as NumPy's uint8 add does
        return torch.where(m, self._base + (77 if t % 2 == 0 else 154),
                           self._base)


def _client_thread(port, height, width, n_frames, out):
    """Read ``n_frames`` payloads and keep the client's last frame in
    ``out["frame"]``; a failure leaves it unset (the thread's exception
    hook prints it), and the row's gate fails."""
    from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient

    cli = DeltaStreamClient("127.0.0.1", port, height, width,
                            timeout=SOCKET_TIMEOUT_S)
    try:
        cli.connect()
        for _ in range(n_frames):
            cli.read_frame()
        out["frame"] = cli.frame.copy()
    finally:
        cli.close()


def run_row(cfg, source, executor, n_frames, warm=2, pipelined=False,
            batched=False):
    """One serving row; returns ``(legs, fps, pos_mean, ok, kb_pf)``:
    the legs' ms (medians; means over the window for batched rows, whose
    landings come every K-th frame), fps from the total leg, the mean
    ``pos`` of every frame sent, whether the client's reconstruction
    equals ``executor.resync()``, and the lander's fetched KB a timed
    frame (None without a lander or when it fetched nothing).
    ``pipelined`` is the JAX signature's: a pipelined executor's row runs
    on the solo schedule (the module's docstring says why)."""
    from cudavideostream_tpu_torch.runtime import wire
    from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer

    total = warm + n_frames
    result = {}
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    conn = None
    try:
        srv.settimeout(SOCKET_TIMEOUT_S)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        ct = threading.Thread(
            target=_client_thread,
            args=(srv.getsockname()[1], cfg.height, cfg.width, total, result),
            daemon=True)
        ct.start()
        conn, _ = srv.accept()
        conn.settimeout(SOCKET_TIMEOUT_S)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

        base = executor.start(source.base_frame())
        v3enc = None
        if cfg.wire_format == "v2":
            conn.sendall(wire.MAGIC_V2)
        elif cfg.wire_format == "v3":
            conn.sendall(wire.MAGIC_V3)
            v3enc = wire.V3Encoder(base)
        elif cfg.wire_format == "v4":
            conn.sendall(wire.MAGIC_V4)
            v3enc = wire.V4Encoder(base)
        conn.sendall(base.tobytes())

        legs = {"capture": [], "dispatch": [], "land": [], "send": [],
                "total": []}
        poss = []
        sent = 0
        lander = getattr(executor, "lander", None)
        fetched0 = 0
        for k in range(total):
            if k == warm and lander is not None:
                fetched0 = lander.fetched_bytes
            t0 = time.perf_counter()
            frame = next(source)
            t1 = time.perf_counter()
            if batched:
                # process() is dispatch and, every K-th frame, the batch's
                # landing: timed under land, which it is mostly
                t2 = t1
                out = executor.process(frame)
                t3 = time.perf_counter()
            else:
                staged = executor._dispatch(frame, "")
                t2 = time.perf_counter()
                out = [executor._land(*staged)]
                t3 = time.perf_counter()
            for res in out or []:
                DeltaStreamServer._send_payload(conn, res, cfg.wire_format,
                                                v3enc)
                poss.append(res[0])
                sent += 1
            t4 = time.perf_counter()
            if k >= warm:
                legs["capture"].append(1e3 * (t1 - t0))
                legs["dispatch"].append(1e3 * (t2 - t1))
                legs["land"].append(1e3 * (t3 - t2))
                legs["send"].append(1e3 * (t4 - t3))
                legs["total"].append(1e3 * (t4 - t0))
        tail = executor.flush()
        for res in (tail if isinstance(tail, list) else [tail]):
            if res is not None:
                DeltaStreamServer._send_payload(conn, res, cfg.wire_format,
                                                v3enc)
                sent += 1
        if sent != total:
            raise RuntimeError(f"sent {sent} frames of {total}")
        conn.close()  # the client reads what is on its way, then EOF
        ct.join(timeout=SOCKET_TIMEOUT_S)
    finally:
        if conn is not None:
            conn.close()
        srv.close()

    # the landings' fetched bytes a timed frame: fixed by the row's
    # configuration, where the land leg's time is not
    kb_pf = None
    if lander is not None and lander.fetched_bytes > fetched0:
        kb_pf = (lander.fetched_bytes - fetched0) / n_frames / 1024.0
    agg = np.mean if batched else np.median
    med = {k: float(agg(v)) for k, v in legs.items()}
    fps = 1e3 / med["total"]
    ok = "frame" in result and np.array_equal(result["frame"],
                                              executor.resync())
    return med, fps, float(np.mean(poss)), ok, kb_pf


def base_configs(device, height=None, width=None):
    """``(tiled, host)``: the rows' base configurations. 1080p on the
    card, 48x64 on the CPU (the glyph cells at scale 1 fit its rows),
    or ``height`` x ``width``."""
    from cudavideostream_tpu_torch.config import CompactionBackend, StreamConfig

    geo = ({} if torch.device(device).type == "cuda"
           else {"height": 48, "width": 64, "overlay_scale": 1})
    if height:
        geo = {"height": height, "width": width or height}
    return (StreamConfig(tiled_payload=True, **geo),
            StreamConfig(compaction=CompactionBackend("host"), **geo))


class Pipelines:
    """One pipeline per emission, shared by the rows (their executors are
    new each row): tiled, tiled with bits, bitmask-only; each built at
    its first row."""

    def __init__(self, base_cfg, device):
        self.base_cfg, self.device = base_cfg, device
        self._pipes = {}

    def get(self, fetch: str):
        from cudavideostream_tpu_torch.models import DeltaStreamPipeline

        key = fetch if fetch in ("mask", "maskonly") else "tiled"
        if key not in self._pipes:
            cfg = {"tiled": self.base_cfg,
                   "mask": dataclasses.replace(self.base_cfg,
                                               emit_bitmask=True),
                   "maskonly": dataclasses.replace(
                       self.base_cfg, fetch_mode="mask", emit_bitmask=True,
                       maskonly_payload=True)}[key]
            self._pipes[key] = DeltaStreamPipeline(cfg, device=self.device)
        return self._pipes[key]


def make_row(row, base_cfg, host_cfg, pipes, frames, device):
    """A row's ``(cfg, executor, source, run_row keywords)``: a new
    executor and source, and the batched rows' window rule — warm-up
    ``3 K`` frames, and whole batches, at least ``6 K`` frames."""
    from cudavideostream_tpu_torch.runtime.executor import (
        BatchedLandExecutor,
        PipelinedExecutor,
        StreamExecutor,
    )

    _, capture, density, fetch, wirefmt, backend, pipelined = row
    depth = pipelined if isinstance(pipelined, int) \
        and not isinstance(pipelined, bool) else 0
    if backend == "host":
        cfg = dataclasses.replace(host_cfg, wire_format=wirefmt)
        executor = StreamExecutor(cfg, device=device)
    else:
        maskish = fetch in ("mask", "maskonly")
        cfg = dataclasses.replace(
            base_cfg,
            fetch_mode=("mask" if maskish else fetch),
            wire_format=wirefmt,
            emit_bitmask=maskish,
            mask_payload=(maskish and wirefmt == "v4"),
            maskonly_payload=(fetch == "maskonly"),
        )
        pipe = pipes.get(fetch)
        if depth:
            executor = BatchedLandExecutor(cfg, pipeline=pipe, depth=depth)
        else:
            cls = PipelinedExecutor if pipelined else StreamExecutor
            executor = cls(cfg, pipeline=pipe)
    src = (DeviceClusteredSource(cfg, density, device=device)
           if capture == "device" else HostClusteredSource(cfg, density))
    n, warm = frames, 2
    if depth:
        warm = 3 * depth
        n = max(6 * depth, (n + depth - 1) // depth * depth)
    kw = {"n_frames": n, "warm": warm,
          "pipelined": bool(pipelined) and not depth, "batched": bool(depth)}
    return cfg, executor, src, kw


def row_line(label, med, fps, pos_mean, ok, kb_pf) -> str:
    """A row's result line, in the JAX sweep's columns."""
    return (f"{label:28s} {med['capture']:8.2f} {med['dispatch']:8.2f} "
            f"{med['land']:8.2f} {med['send']:8.2f} {med['total']:9.2f} "
            f"{fps:6.1f} {pos_mean:9.0f} {'OK' if ok else 'MISMATCH'}"
            f"{'' if kb_pf is None else f'  land_KBpf={kb_pf:8.1f}'}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cudavideostream_tpu_torch.loopback_sweep",
        description="per-leg times of the served path over a real TCP "
                    "client, each row gated byte-exact (the JAX package's "
                    "benchmarks/loopback_sweep.py)")
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--out", default=None, help="append results here")
    p.add_argument("--quick", action="store_true",
                   help="only the device-capture rows")
    p.add_argument("--height", type=int, default=None,
                   help="frame geometry (e.g. 2160 for 4K)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--rows", default=None,
                   help="comma-separated row labels to run (subset)")
    p.add_argument("--repeat", type=int, default=1,
                   help="run each selected row N times, interleaved (a new "
                        "executor each)")
    p.add_argument("--device", default=None,
                   help="cpu: the plain PyTorch versions at 48x64 on the "
                        "host clock (default: the card)")
    args = p.parse_args(argv)
    from cudavideostream_tpu_torch.bench import card_line
    from cudavideostream_tpu_torch.models.pipeline import resolve_device

    dev = resolve_device(args.device)
    base_cfg, host_cfg = base_configs(dev, args.height, args.width)
    where = (f"{torch.cuda.get_device_name(dev)} ({card_line()})"
             if dev.type == "cuda"
             else "the CPU, the plain PyTorch versions; host clock, no "
                  "device metric")
    print(f"sweep on {where} {base_cfg.height}x{base_cfg.width}",
          file=sys.stderr)
    pipes = Pipelines(base_cfg, dev)
    matrix = [m for m in MATRIX if not args.quick or m[1] == "device"]
    if args.rows:
        wanted = set(args.rows.split(","))
        matrix = [m for m in matrix if m[0] in wanted]
    if args.repeat > 1:
        # interleave the reps (A0 B0 C0 A1 B1 C1 ...): a drift over time
        # then spreads over every row
        matrix = [(f"{m[0]}_rep{r}", *m[1:])
                  for r in range(args.repeat) for m in matrix]
    lines = [
        f"# end-to-end {base_cfg.height}x{base_cfg.width} serving sweep on "
        f"{where}: real executor + real TCP client, per-leg medians (ms; "
        "batched rows: means).",
        "# capture=host pays the 6.2 MB host->device upload inside "
        "dispatch; capture=device makes frames on the card. land = the "
        "wait for the step's sizes, the payload's copies and its host "
        "rebuild. Each row gated: client reconstruction == device state.",
        "# row  capture_ms dispatch_ms land_ms send_ms total_ms fps "
        "pos_mean exact [land_KBpf = the landings' fetched KB a frame]",
    ]
    print("\n".join(lines), flush=True)
    failed = 0
    for row in matrix:
        label = row[0]
        try:
            cfg, executor, src, kw = make_row(row, base_cfg, host_cfg, pipes,
                                              args.frames, dev)
            med, fps, pos_mean, ok, kb_pf = run_row(cfg, src, executor, **kw)
        except Exception as e:  # a row's failure is reported; the rest run
            traceback.print_exc()
            line = f"{label:28s} FAILED: {type(e).__name__}: {e}"
            failed += 1
        else:
            line = row_line(label, med, fps, pos_mean, ok, kb_pf)
            failed += not ok
        print(line, flush=True)
        lines.append(line)

    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
        print(f"appended to {args.out}", file=sys.stderr)
    if failed:
        print(f"{failed} of {len(matrix)} rows failed", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
