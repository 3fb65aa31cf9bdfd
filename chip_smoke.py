#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``cudavideostream_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: the card's name and power limit, torch, CUDA, nvcc, triton;
2. build: every hand-written kernel of the serving path, from ``csrc/``;
3. each kernel against its plain PyTorch version at 1080p on the card,
   byte for byte, over densities, thresholds, negative feedback and the
   overlay region, plus one full pipeline step against the NumPy spec;
4. serving: the port's server in a thread and the port's client over
   127.0.0.1, 1080p synthetic frames with a changing overlay text; the
   client's reconstruction must equal the server's state every frame,
   and each kernel's launch count must show the path went through it;
5. times from CUDA events (medians over 100 iterations, device-resident
   frames at ~6% density): each kernel, its plain version,
   ``pipeline.step`` and the ``pos``-prefix landing; the source's host
   time per frame is printed apart.

It prints progress lines, then the card's ``nvidia-smi`` line, then one
JSON line of kernel records, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, and prints no result, without a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
ITERS = 100
CUR_COPIES = 8
SEED = 2734


def log(msg: str) -> None:
    print(msg, flush=True)


def frame_pair(rng, n, change_frac):
    """(prev, cur): ~change_frac of bytes jump by 30..200, the rest drift
    by at most 15 (below the default threshold)."""
    prev = rng.integers(0, 255, size=n, endpoint=True, dtype=np.uint8)
    noise = rng.integers(-15, 15, size=n, endpoint=True).astype(np.int32)
    big = rng.random(n) < change_frac
    jump = rng.integers(30, 200, size=n) * rng.choice([-1, 1], size=n)
    cur = ((prev.astype(np.int32) + np.where(big, jump, noise)) % 256)
    return prev, cur.astype(np.uint8)


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"[env] nvidia-smi: {smi}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    from cudavideostream_tpu_torch.kernels import build

    nvcc = build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], check=True,
                         capture_output=True, text=True).stdout
    log(f"[env] nvcc {nvcc}: {ver.strip().splitlines()[-1]}")
    try:
        import triton
        log(f"[env] triton {triton.__version__} imports")
    except ImportError as e:  # reported only: no kernel here uses triton
        log(f"[env] triton does not import: {e}")
    return smi


def phase_build():
    from cudavideostream_tpu_torch.ops import logcompact

    t0 = time.perf_counter()
    logcompact._kernel_lib()  # nvcc at first use
    log(f"[build] csrc/logcompact.cu built and bound in "
        f"{time.perf_counter() - t0:.2f} s")


def _equal_or_raise(name, got, want):
    """Byte-exact comparison of (pos, xs, vals, new_prev); returns the
    largest absolute difference (0 when exact)."""
    err = 0
    for label, a, b in zip(("pos", "xs", "vals", "new_prev"), got, want):
        if a.shape != b.shape:
            raise AssertionError(f"{name}: {label} shape {tuple(a.shape)} "
                                 f"!= {tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        e = int(d.max()) if d.numel() else 0
        if e:
            raise AssertionError(f"{name}: {label} differs (max |d| {e})")
        err = max(err, e)
    return err


def phase_kernel_vs_plain(cfg):
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.ops import reference_cpu

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED)
    region = torch.from_numpy(rng.integers(
        0, 255, 288_000, endpoint=True, dtype=np.uint8)).to(dev)

    def run_both(name, prev, cur, thr, negfeed, reg, capacity=None):
        p_k, p_p = prev.clone(), prev.clone()
        k = logcompact.fused_diff_compact(cur, p_k, thr, negfeed, reg,
                                          capacity)
        torch.cuda.synchronize()
        p = logcompact.fused_diff_compact_reference(cur, p_p, thr, negfeed,
                                                    reg, capacity)
        return _equal_or_raise(name, k, p), int(k[0])

    max_err, cases = 0, 0
    for density in (0.0, 0.06, 1.0):
        prev_np, cur_np = frame_pair(rng, n, density)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        for thr in (0, 20, 255):
            for negfeed in (True, False):
                for reg in (None, region):
                    name = (f"d={density} thr={thr} negfeed={negfeed} "
                            f"overlay={reg is not None}")
                    err, pos = run_both(name, prev, cur, thr, negfeed, reg)
                    max_err, cases = max(max_err, err), cases + 1
                    log(f"[check] {name}: pos={pos} exact")
    # ragged lengths (tails shorter than a 16-byte vector and a tile) and
    # a capacity below the count
    for m in (1000, 12_345):
        prev_np, cur_np = frame_pair(rng, m, 0.06)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        err, pos = run_both(f"n={m}", prev, cur, 20, True, region[:700])
        max_err, cases = max(max_err, err), cases + 1
        log(f"[check] n={m} overlay=700 B: pos={pos} exact")
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    prev, cur = (torch.from_numpy(prev_np).to(dev),
                 torch.from_numpy(cur_np).to(dev))
    err, pos = run_both("capacity", prev, cur, 20, True, region, 100_000)
    max_err, cases = max(max_err, err), cases + 1
    log(f"[check] capacity=100000 < pos={pos}: exact")

    # one full pipeline step on the card against the NumPy spec
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.utils import fonts

    pipe = DeltaStreamPipeline(cfg)
    text = "FPS: 30 BW: 1234 kbps"
    out = pipe.step(pipe.init_state(prev_np), cur_np, text=text)
    pos = int(out[1])
    e_prev, e_pos, e_xs, e_vals, _ = reference_cpu.step_oracle(
        prev_np, cur_np, cfg, atlas=pipe.atlas_np,
        char_ids=fonts.encode_text(text))
    if pos != e_pos:
        raise AssertionError(f"step vs step_oracle: pos {pos} != {e_pos}")
    xs, vals = out[2].cpu().numpy(), out[3].cpu().numpy()
    if not (np.array_equal(xs[:pos], e_xs) and np.array_equal(vals[:pos], e_vals)
            and not xs[pos:].any() and not vals[pos:].any()
            and np.array_equal(out[0].cpu().numpy(), e_prev)):
        raise AssertionError("pipeline.step on the card differs from "
                             "step_oracle")
    cases += 1
    log(f"[check] pipeline.step at 1080p == step_oracle (pos={pos})")
    return max_err, cases


class _RecordingExecutor:
    """The server's executor, plus a digest of the device state and the
    overlay text after every frame (the server calls start, process,
    metrics)."""

    def __init__(self, inner):
        self.inner = inner
        self.texts, self.digests, self.process_s = [], [], []

    @property
    def metrics(self):
        return self.inner.metrics

    def start(self, base):
        return self.inner.start(base)

    def process(self, frame, text=""):
        t0 = time.perf_counter()
        out = self.inner.process(frame, text=text)
        self.process_s.append(time.perf_counter() - t0)
        self.texts.append(text)
        self.digests.append(hashlib.sha256(self.inner.resync()).hexdigest())
        return out


class _UntilTextsChanged:
    """SyntheticSource, stopped after at least ``min_frames`` frames once
    the overlay text has taken ``min_texts`` values."""

    def __init__(self, inner, rec, min_frames=20, min_texts=3,
                 max_frames=400):
        self.inner, self.rec = inner, rec
        self.min_frames, self.min_texts = min_frames, min_texts
        self.max_frames = max_frames
        self.next_s = []

    def base_frame(self):
        return self.inner.base_frame()

    def __next__(self):
        served = len(self.rec.texts)
        if served >= self.max_frames or (
                served >= self.min_frames
                and len(set(self.rec.texts)) >= self.min_texts):
            raise StopIteration
        t0 = time.perf_counter()
        frame = next(self.inner)
        self.next_s.append(time.perf_counter() - t0)
        return frame


def phase_serving(cfg):
    import dataclasses

    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
    from cudavideostream_tpu_torch.runtime.executor import StreamExecutor
    from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    cfg = dataclasses.replace(cfg, port=0)
    rec = _RecordingExecutor(StreamExecutor(cfg))
    source = _UntilTextsChanged(SyntheticSource(cfg, seed=SEED), rec)
    server = DeltaStreamServer(cfg, source, executor=rec, verbose=False)
    server.listen()
    errors = []

    def serve():
        try:
            server.serve(max_frames=None)
        except BaseException as e:
            errors.append(e)

    logcompact.fused_diff_compact.launches = 0
    t0 = time.perf_counter()
    th = threading.Thread(target=serve, name="smoke-server", daemon=True)
    th.start()
    cli = DeltaStreamClient("127.0.0.1", server.port, cfg.height, cfg.width)
    cli.connect()
    digests, positions = [], []
    try:
        while True:
            pos, frame = cli.read_frame()
            positions.append(pos)
            digests.append(hashlib.sha256(frame).hexdigest())
    except ConnectionError:
        pass  # the server closes the stream after its last frame
    finally:
        cli.close()
    th.join(timeout=120)
    wall = time.perf_counter() - t0
    server.close()
    launches = logcompact.fused_diff_compact.launches
    if th.is_alive():
        raise RuntimeError("server thread did not finish")
    if errors:
        raise errors[0]
    frames = len(rec.texts)
    if frames < 20 or len(set(rec.texts)) < 3:
        raise AssertionError(f"served {frames} frames with "
                             f"{len(set(rec.texts))} overlay texts")
    if digests != rec.digests:
        bad = next(i for i, (a, b) in enumerate(zip(digests, rec.digests))
                   if a != b) if len(digests) == len(rec.digests) else None
        raise AssertionError(f"client reconstruction != server state "
                             f"(client {len(digests)} frames, server "
                             f"{frames}, first mismatch {bad})")
    if launches != frames:
        raise AssertionError(f"fused_diff_compact launched {launches} "
                             f"times for {frames} frames")
    log(f"[serve] {frames} frames at 1080p over TCP, byte-exact every frame; "
        f"overlay texts {sorted(set(rec.texts))}; mean pos "
        f"{statistics.mean(positions):.0f}; {frames / wall:.2f} fps wall "
        f"(includes the numpy source and the per-frame state digests)")
    per_frame = wall / frames
    src_ms = statistics.median(source.next_s) * 1e3
    proc_ms = statistics.median(rec.process_s) * 1e3
    log(f"[serve] per frame, medians on the host clock: source "
        f"{src_ms:.2f} ms, executor.process (upload, step, pos read, "
        f"prefix copy) {proc_ms:.2f} ms; the rest of the {per_frame * 1e3:.2f}"
        f" ms mean wall per frame is wire packing, the socket, the client's "
        f"scatter and both digests, all in this one process")
    log(f"[serve] kernel launches on the main path: fused_diff_compact="
        f"{launches}")
    return {"fused_diff_compact": launches}


def _event_median_ms(fn, iters, backlog=True):
    """Median device time of ``fn(i)`` over ``iters`` calls, from one
    CUDA event pair per call. With ``backlog`` the queue is held behind a
    sleep kernel first, so each pair times the device work alone and not
    the host's launch overhead."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    if backlog:
        torch.cuda._sleep(200_000_000)
    for i in range(iters):
        starts[i].record()
        fn(i)
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def phase_times(cfg):
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.ops import overlay as overlay_ops
    from cudavideostream_tpu_torch.runtime.executor import StreamExecutor
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED + 1)
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    cur = torch.from_numpy(cur_np).to(dev)
    prev0 = torch.from_numpy(prev_np).to(dev)
    # every call updates its prev in place: one fresh copy per iteration
    prevs = [prev0.clone() for _ in range(ITERS)]
    # and reads one of CUR_COPIES copies of cur in turn, last touched
    # several launches (hundreds of MB of traffic) back: cold in the 50 MB L2
    curs = [cur.clone() for _ in range(CUR_COPIES)]

    def refill():
        for p in prevs:
            p.copy_(prev0)

    pipe = DeltaStreamPipeline(cfg)
    text = "FPS: 30 BW: 1234 kbps"
    pipe.step(prev0.clone(), cur, text=text)  # warm-up
    cell_h = pipe.atlas.shape[1]
    region = overlay_ops.overlay_blit(
        cur[: cell_h * cfg.width * 3], pipe.atlas, pipe._char_ids(text),
        len(text), cell_h, cfg.width)
    r = region.numel()
    pos = int(logcompact.fused_diff_compact(cur, prev0.clone(), 20, True,
                                            region)[0])

    k_ms = _event_median_ms(
        lambda i: logcompact.fused_diff_compact(
            curs[i % CUR_COPIES], prevs[i], 20, True, region), ITERS)
    refill()
    plain_ms = _event_median_ms(
        lambda i: logcompact.fused_diff_compact_reference(
            curs[i % CUR_COPIES], prevs[i], 20, True, region), ITERS,
        backlog=False)
    refill()
    # the kernel's own passes, from a profiler trace of 20 launches
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(20):
            logcompact.fused_diff_compact(curs[i % CUR_COPIES], prevs[i], 20,
                                          True, region)
        torch.cuda.synchronize()
    passes = {name: e.device_time_total / e.count / 1e3
              for e in prof.key_averages()
              for name in ("count_kernel", "compact_kernel")
              if f"::{name}(" in e.key}
    for name, ms in passes.items():
        log(f"[trace] K1 pass {name}: {ms:.4f} ms per launch (profiler)")
    if len(passes) != 2:
        log("[trace] the profiler saw no device time for the two passes: "
            "not measured")
    refill()
    step_ms = _event_median_ms(
        lambda i: pipe.step(prevs[i], curs[i % CUR_COPIES], text=text),
        ITERS)

    ex = StreamExecutor(cfg, pipeline=pipe)
    out = pipe.step(prev0.clone(), cur, text=text)
    host_land = []

    def land(_):
        t = time.perf_counter()
        ex._land(t, out[1:])
        host_land.append(time.perf_counter() - t)

    land_ms = _event_median_ms(land, ITERS, backlog=False)
    src = SyntheticSource(cfg, seed=SEED)
    src_s = []
    for _ in range(10):
        t = time.perf_counter()
        next(src)
        src_s.append(time.perf_counter() - t)

    # least time over HBM bandwidth: each input byte read once (prev n, and
    # n of cur, of which the overlay region replaces the first r: the
    # kernel never loads cur[:r]), each output written once (new_prev n,
    # xs 4n, vals n, pos 4)
    bound_bytes = 2 * n + 6 * n + 4
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[time] 1080p, pos={pos} ({pos / n:.2%}), overlay region {r} B, "
        f"medians of {ITERS} (CUDA events)")
    log(f"[time] fused_diff_compact kernel: {k_ms:.4f} ms "
        f"(bound {bound_ms:.4f} ms = {bound_bytes} B at 3.35 TB/s; "
        f"{bound_ms / k_ms:.1%} of it)")
    log(f"[time] plain PyTorch version: {plain_ms:.4f} ms "
        f"(synchronizes in nonzero)")
    log(f"[time] pipeline.step (overlay blend + kernel): {step_ms:.4f} ms")
    log(f"[time] pos-prefix landing: {land_ms:.4f} ms device span, "
        f"{statistics.median(host_land) * 1e3:.4f} ms host")
    log(f"[time] SyntheticSource next() on the host: "
        f"{statistics.median(src_s) * 1e3:.2f} ms/frame (not a kernel time)")
    return {"ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "step_ms": step_ms, "land_ms": land_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from cudavideostream_tpu_torch.config import StreamConfig

    cfg = StreamConfig()  # the default: 1080p BGR24, threshold 20, negfeed
    smi = phase_environment()
    phase_build()
    max_err, cases = phase_kernel_vs_plain(cfg)
    launches = phase_serving(cfg)
    times = phase_times(cfg)
    kernels = [{
        "name": "fused_diff_compact",
        "route": "cuda",
        "source": "cudavideostream_tpu_torch/csrc/logcompact.cu",
        "replaces": "cudavideostream_tpu/ops/logcompact.py:297",
        "launches": launches["fused_diff_compact"],
        "max_abs_err": max_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "check": f"byte-exact in {cases} cases",
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
