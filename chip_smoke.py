#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``cudavideostream_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: the card's name, power limit and SM clock, torch, CUDA,
   nvcc, triton;
2. build: every hand-written kernel, from ``csrc/`` (eleven sources), one
   ``nvcc`` per source, all started together; no kernel of K9-K14 may
   keep a stack frame (``cuobjdump -res-usage``; K8's registers and stack
   a K are printed); K10's, K11's and K12's grids and tiles an SM at 1080p and
   at S = 4 are printed; no instance of K8's
   ``conv_kernel<K>`` may load a byte from shared memory (``cuobjdump
   -sass``: its window comes as ``LDS.64`` words); the card must hold at
   least one block of K9's cooperative kernel at once
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), whose plan at
   1080p for B = 1, 2, 4, 8 is printed; K7's SASS must keep its
   256 compares per value (``cuobjdump -sass``, ISETP counted), each
   instance of K1's tiled kernel and K4's kernel must load from global
   memory before its first shared-memory store, and K5's and K6's cluster
   launches must fit the card (cluster size, shared memory per CTA and
   ``cudaOccupancyMaxActiveClusters``, which must not be 0), as must K7's
   slices (the CTAs its plan puts on an SM); K7's SASS mix (ISETP, IADD3,
   VIADD, IMAD, SEL, P2R per value and bin) is printed;
3. each kernel against its plain PyTorch version at 1080p on the card,
   byte for byte: K1 flat, K1 tiled and K1's bitmask-only emission
   (``subtile_rows`` 1, 8 and 0) and K1 tiled with packed bits
   (``subtile_rows`` 1) over densities, thresholds, negative feedback and
   the overlay region, and again on every emission with a per-byte
   threshold map (and a map of 0s and 255s, and ragged lengths); K1
   flat's one-pass kernel at its edges (lengths 1, 15, 16, 17, a tile and
   a tile +- 1 byte, tile counts just under and over its persistent grid,
   each with and without a map, a region across the first tile, pos = 0
   and pos = n, cap just under and over pos) and in 20 launches back to
   back on one stream and on two streams at once; K2 on every tiled
   output and on raw pairs (the same edges at its tile, all valid, none
   valid, 20 launches back to back on one and on two streams; xs == 0 at
   valid pairs kept); K1 tiled's one launch at 1, just under and just
   over one wave of tiles (subtile 1 and 8, and bitmask-only) and in 20
   launches back to back mixed with K1 flat, bitmask-only and batched, on
   one stream and on two at once; K3 on every bitmask-only output, on raw
   streams and, one pass, at its edges (lengths 1, 15, 16, 17, a tile and
   a tile +- 1, tile counts around its grid, every byte nonzero and none,
   20 launches back to back mixed with K2 on one and on two streams); K4 on the gray values of a random frame, of the
   synthetic scene, of one value everywhere, of 255 everywhere and of
   0/255 only, on ragged lengths, at its launch plan's edges (lengths
   1-17, around one block's share and one full grid's, 1080p +- 1), on a
   shard's gray values at S = 4 and 8, and in 20 launches back to back on
   one stream and on two streams at once; K5 (segment) and K6 (register)
   against their plain versions, K5 == K6 == K1 tiled at
   ``subtile_rows=0`` bit for bit and all three schemes flat equal to K1's
   plain version, K5 with the region and a map, ragged lengths and units
   (1,024 B to 51,200 B), K5 and K6 with one CTA's band shipping every
   byte and the next none, on a unit longer than one round of a CTA (K5
   == K6 == K1 tiled at n = 134,230,073), and in 20 launches back to back
   on one and two streams (K5 solo, with a map and batched); K7 on the
   scene's gray grid, out-of-range values, ragged row counts, tiles of 8,
   360 and 480 rows, 15, 45, 135, 307 and 3,001 tiles, and in 20 launches
   back to back on one and two streams; K1 batched (B = 1, 3, 4, 8 streams,
   ``subtile_rows`` 1, 8, 0, three densities, no map or a shared door map,
   per-stream overlay strips, and the JAX package's ragged geometries)
   against its plain version and against solo K1 tiled launches on each
   stream, K5 batched likewise (B = 1, 3, 4, 8) and equal to K1 batched at
   ``subtile_rows=0``, and ``BatchedDeltaPipeline.step`` at B = 4 against
   each stream's NumPy spec; K8 (the noise filter, ``convolve_q16``) at
   1080p for K = 1, 2, 3, 5, 7, 9 and 15 with Gaussian, mean and signed
   unnormalized taps, at those K on ragged widths (5,751 B, 1,026 B and 3
   B a row, the last 8-byte strip of a row straddling its end) at B = 1,
   2 and 4 streams and on S = 4 halo shards against the solo frame, one
   launch a call; K9 (``binarize_pipeline``, one cooperative launch) at
   1080p, on the scene, a one-value frame, a tie in the histogram, ragged
   lengths and an unaligned view, a frame past its register budget, B =
   2, 4 and 8 streams with and without their strips, one launch a call or
   a batched frame, sharded at S = 4 (its two launches), and in 100
   launches back to back on one stream and on two at once (every scratch
   zero after), and with the overlay region read in place of the frame's
   prefix; K10 (the HOST step, ``diff_pack``) and K11-K13 (``heatmap``,
   ``red_visualizer`` modes 2 and 3, ``grayscale_average`` and
   ``_weighted``) at 1080p and on a ragged width, without a region, with
   the strip and with a strip ending inside a 16-byte vector, K10 and
   K12 with thresholds 20 and 0, a map and a map of 0s and 255s, K10 with
   and without negative feedback and the delta, on ragged lengths (the
   bits' zero padding) and unaligned views, K10-K13 at the edges of
   their warp tiles (a strip ending inside a tile and inside a vector,
   lengths of whole tiles +- 1-127 bytes or 1-47 pixels, unaligned
   frames, prev and maps), K11-K13 on B = 2 and 4 streams at strides that
   split a tile, K11 on
   sums 0..765 (the
   wrap), K11-K13 on B = 2 and 4 streams at a ragged stride against solo
   calls, all four on S = 4 shards against the solo frame and in 20
   launches back to back on one and on two streams, and a step of
   ``--visualizer 1-4`` with and without ``--noise-filter`` against the
   NumPy spec with one launch of its kernel; K14 (the status-text
   overlay) on the 1080p strip, the whole frame and 271x1917 on an
   unaligned view with 0, 18 and 28 characters in both fonts, on B = 4
   streams with a text each, in 20 launches back to back on one and on
   two streams, and one launch a solo and a batched step; K1's
   ``index_offset`` mode
   (flat and tiled at ``subtile_rows`` 1, 8, 0, two densities; tiled at
   1 and 8 with a per-byte map) on every shard of the frame cut
   into S = 2, 4 and 8 row shards at its shard base, and at the largest
   offset int32 admits, against its plain version and against the
   offset-free launch shifted on its valid entries only;
   ``ShardedDeltaPipeline.step_flat`` on S = 1, 2, 4, 8 shards laid on
   ``cuda:0``, both payload layouts, visualizers 0, 3 and 5, the noise
   filter and the door map, against the NumPy spec, K1 launched S times a
   step; plus one pipeline step of each
   configuration (flat, tiled, tiled with bits, bitmask-only, each also
   with a per-pixel "door" map), of each of the 8 named variants, and of
   binarize and red-overlap on each tiled emission, against the NumPy
   spec, the aux frame included;
4. serving: the port's server in a thread and the port's client over
   127.0.0.1, 1080p synthetic frames with a changing overlay text, on
   twelve paths (K11 once a frame under ``--visualizer 1``, K12 under
   ``--visualizer 3``) — flat (wire v1), ``--tiled --fetch flat``, ``--tiled
   --fetch tiles``, ``--tiled --pipelined --wire v3``, ``--tiled
   --bitmask --fetch mask --wire v4``, ``--tiled --fetch mask --maskonly
   --wire v4 --land-batch 8``, ``--tiled --bitmask --fetch auto``,
   ``--visualizer 5``, ``--noise-filter --visualizer 1 --tiled --fetch
   flat``, ``--tiled --fetch mask --maskonly --wire v4 --land-batch 8
   --visualizer 3``, and the last two built by the server's own command
   line with ``--threshold-map`` (a per-pixel door map saved as ``.npy``):
   flat wire v1, and ``--tiled --fetch mask --maskonly --wire v4
   --land-batch 8 --visualizer 3``; the client's reconstruction must equal
   the server's state every frame, every landed frame of a visualizer path
   must bring its aux frame, the first 5 equal to the NumPy spec's, on a
   map path the server's map must be the saved one and the first 5 states
   the NumPy spec's with it, and each kernel's launch count, set to 0 just before a path and read just
   after, must show the path went through it. Then the path of K5, K6 and
   K7, the JAX package's scheme cross-check and probe, through the public
   entry points on one synthetic 1080p frame, its launches counted the
   same way, now with K1 and K5 batched on two streams; then the
   multi-stream server (4 streams, a loopback client each) in four runs,
   wire v1, ``--wire v3``, ``--visualizer 5 --aux-dir`` and
   ``--visualizer 4 --aux-dir`` (K13 once a batched frame), every stream
   byte-exact every frame with one K1 batched launch per batched frame;
   the broadcast server (wire v3) with a client from the start and one
   joining late, and the session a raw reader recorded replayed
   byte-identical by ``ReplayServer``; then the sharded paths, each
   byte-exact every frame: ``server --mesh 1,1`` (wire v1, and
   ``--pipelined --wire v3``) built by ``server.setup``, an S = 4
   ``ShardedStreamExecutor`` with its shards on ``cuda:0`` (and again
   under ``--visualizer 2``, K12 once a shard), and
   ``multiserve --streams 4 --mesh 1,1``, with S K1 launches a frame (K2
   only for a (1, 1) mesh's ``flat`` landings); then the camera path: a
   16-frame ``.npy`` clip served by ``server --source file`` (flat wire
   v1, the same with ``--prefetch``, ``--tiled --fetch tiles`` through
   the segments sender and under ``--wire v3`` through the C encoder off
   the tiled blocks, each frame's native sender counted) to the Python
   and the C client, ``multiserve --streams 4 --source file``,
   ``device_synthetic_frames`` on the card against the CPU and chained
   into ``pipeline.step``, and ``v4l2_open`` on a missing path; then
   the last modules, on a 16-frame clip through ``server.main --source
   file``: the SORT and HOST backends (3 steps each against
   ``step_oracle``, the HOST fast path and its ``--noise-filter`` path;
   then 16 frames served each, SORT launching no kernel and HOST K10 once
   a frame, the fast path bringing n/8 bytes a frame from the card),
   ``--backend oracle`` (6 frames),
   ``--aux-port`` under ``--visualizer 1`` and ``5`` read by an
   ``AuxStreamClient`` (each frame it gets equal to the oracle's aux
   frame), ``--save-state`` then ``--resume`` (the joining client's base
   frame is the saved state), ``--link-cache`` written and reloaded (the
   second run's lander starts from the saved rate), ``--calibrate 2``,
   the client's ``--record`` (re-served by ``ReplayServer``), ``--save``,
   ``--ppm`` and ``--http`` (``/`` and ``/stream``), each byte-exact
   against ``step_oracle`` with its launches counted; ``median_filter``
   at k = 3, 5, 7 against ``reference_cpu``; the sort step against the
   pallas step, the host's pack time, the served runs' device idle share
   from a trace, and ``median_filter`` at k = 3 and 5 are timed; then the
   headline bench, ``python -m cudavideostream_tpu_torch.bench`` with
   ``--emit tiled`` and ``--emit flat`` (16 steps in one CUDA graph, 5
   replays) and ``--all-variants`` (8 steps, 3 replays, one process a
   variant), each gated byte-exact against ``step_oracle`` and printing
   its one JSON line; and in this process the tiled, flat, binarize and
   tiled ``--noise-bank 0`` runs, whose captured graph must hold T nodes
   of K1 (and of K9's cooperative kernel under binarize), whose every
   replay must equal the
   same steps launched eagerly (timed beside it), and whose fps times
   the bytes a step must move (the generator's plane read and frame
   write, K1's, the digest's) must stay under 3.35 TB/s; then the
   measurement utils on the card: ``bench_scan_chain`` over the tiled
   steps (within 2x of the tiled run's replays), ``bench_op``,
   ``bench_op_amortized`` and ``measure_rtt`` on the device generator,
   and a ``profiling.trace`` whose ``trace.json`` must hold K1's CUDA
   kernel record and the ``annotate``d span; then the per-kernel table:
   ``python -m cudavideostream_tpu_torch.bench --full`` (the headline's
   JSON line, then every row of the table and the ``prev_copy`` line
   with a finite time above 0), one step of each of its 22 rows at 1080p
   on the card against the same step through the plain versions on the
   CPU, byte for byte, and each row's CUDA graph captured in this
   process as the table captures it, the launch counts set to 0 first:
   it must hold one node a step of each kernel its row launches (K1 flat
   or tiled, two for K1's whole-tile chunk path; K5 and K2 on the
   segment row; K4 on ``histogram``, K9's fused kernel on
   ``binarize_pipeline``,
   K8 on ``gaussian_conv_k3/5/7/9``, K10 on ``host_offload_step``, K11 on
   ``heatmap_lut``, K12 on ``red_overlap``, K13 on ``grayscale_avg`` and
   ``grayscale_weighted``) and no
   other kernel of the port, and its carry after the table's replays
   must equal the same steps launched eagerly, byte for byte; then the
   served path from a source on the card (``loopback_sweep``): every row
   of its matrix at 1080p, ``DeviceClusteredSource`` on the 28 device
   rows (``tiles``, ``flat``, ``auto``, ``mask``, ``maskonly``; wire
   v1-v4; solo, pipelined and landing batches of 4, 8 and 16) and the
   host source on the 4 host rows (two on the HOST backend), each through
   the executor, a TCP socket and a decoding client, gated byte-exact
   (the client's frame == ``executor.resync()``), its legs, fps,
   ``pos_mean`` and fetched KB a frame printed with the card, its
   launches counted from 0 and held to one K1 a frame, one K2 a ``flat``
   or ``mask`` landing, one K3 a ``maskonly`` landing and K10 alone, once
   a frame, on the HOST backend; one row of each flavor served again
   under the profiler (the card's idle share) and five to a client that decodes nothing (the
   decoding client's share of the send leg); and ``loopback.main``'s
   rows at 1080p, each loop gated;
5. times from CUDA events (medians over 100 iterations, 30 for functions
   of tens of small launches; device-resident frames at ~6% density,
   inputs cold in L2), the empty-launch floor (``torch.cuda._sleep(0)``),
   and a profiler trace and a CUDA graph capture that must show one
   kernel launch per call, and no memset node, of K1 flat, K1 tiled,
   bitmask-only, batched and with ``index_offset``, K2, K3, K4, K5 (solo,
   with a map, batched), K6 and K7:
   each kernel, its plain
   version and its bound (and, for K3, ``torch.masked_select`` as its
   library yardstick), ``pipeline.step`` flat and tiled, the landings
   (``pos`` prefix; tiles, flat and mask flavors, the mask landing's host
   rebuild apart), ``TiledPayload.to_flat`` and the v3 and v4 encodes on
   the host, and the synchronous against the pipelined executor per frame;
   the source's host time per frame is printed apart; K4 against its
   plain version, ``torch.bincount`` and its bound, the ``--visualizer
   5`` step and the aux landing; K8 at
   K = 3, 5, 7, 9 and K9 on cold frames against their plain versions and
   bounds, each by CUDA events and kernel-only from a profiler trace
   (K8's bound the larger of its bytes and its K^2 int32 multiply-adds a
   byte, and ``F.conv2d`` fp32 as its library yardstick; K9 solo and on B
   = 4 streams, and the sharded path's two launches each alone), their
   kernels per call, and ``pipeline.step`` with
   ``--noise-filter`` and with ``--visualizer 5``, device and host wall
   time, kernels against the plain versions (and K9 against the chain
   of torch ops around K4 that it replaced) in turns; K10-K13 on cold
   frames against their plain versions and their bounds in bytes (K10
   also with the delta and with a map, K12 in modes 2 and 3 and with a
   map, K13 in both weightings), their kernels per call, and
   ``pipeline.step`` with ``--visualizer 1``, ``--visualizer 3`` and
   ``--compaction host``, the kernel against its plain version in turns;
   K1
   without and with a map on each emission, in turns; K5, K6 and K7
   against their plain versions and bounds (K7's in operations, at the
   card's SM clock and an SM's issue ceiling of 128 lanes per clock); K1
   batched at B = 4 against four solo K1 tiled launches, in turns, and
   against its bound, K5 batched against its bound, and the B = 4 batched
   step; the sharded step at S = 1, 2, 4, 8 on ``cuda:0`` against the solo
   tiled step, in turns, and the per-shard K1 tiled launch with its
   ``index_offset`` at S = 4 and 8 against its plain version and its bound
   on the shard's bytes (shards on one card run one after another: no
   interconnect, no scaling); and on the host the native wire senders and
   the C v3 encoder against the NumPy path on two 1080p tiled payloads,
   each native sender's bytes read back once.

It prints progress lines, then the card's ``nvidia-smi`` line, then one
JSON line of kernel records, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, and prints no result, without a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
# integer instructions an SM can issue per clock: 4 schedulers, one warp
# instruction (32 lanes) each. K7 runs faster than the 64 INT32 lanes per
# SM of the data sheet allow on its 45 SMs, so this is its peak rate.
K7_LANES_PER_SM = 4 * 32
ITERS = 100
PROFILE_PAD_S = 0.05  # host sleep at each end of a profiler trace
CUR_COPIES = 8
SEED = 2734
# the kernels redesigned as one-launch kernels, and the slice of the port
# that redesigned them (the earlier times stand in PERF.md, section 6)
REDESIGNED = {"fused_diff_compact": 8, "pair_compact": 8,
              "fused_diff_compact_tiled": 9, "fused_diff_compact_mask": 9,
              "fused_diff_compact_batched": 9, "vals_compact": 9,
              "fused_diff_compact index_offset": 9, "histogram": 10,
              "register_compact": 10, "segment_compact": 11,
              "vpu_probe": 11, "convolve_q16": 19, "binarize_pipeline": 19}
# the instructions counted in K7's SASS, and the (value, bin) pairs of its
# unrolled body: a thread's 4 values x 256 bins of compare-and-add
K7_SASS_OPS = ("ISETP", "IADD3", "VIADD", "IMAD", "SEL", "P2R")
K7_BODY_PAIRS = 4 * 256


def log(msg: str) -> None:
    print(msg, flush=True)


def frame_pair(rng, n, change_frac):
    """(prev, cur): ~change_frac of bytes jump by 30..200, the rest drift
    by at most 15 (below the default threshold)."""
    prev = rng.integers(0, 255, size=n, endpoint=True, dtype=np.uint8)
    return prev, drift(rng, prev, change_frac)


def drift(rng, frame, change_frac):
    """The next frame after ``frame``, as ``frame_pair`` makes ``cur``."""
    n = frame.size
    noise = rng.integers(-15, 15, size=n, endpoint=True).astype(np.int32)
    big = rng.random(n) < change_frac
    jump = rng.integers(30, 200, size=n) * rng.choice([-1, 1], size=n)
    cur = ((frame.astype(np.int32) + np.where(big, jump, noise)) % 256)
    return cur.astype(np.uint8)


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"[env] nvidia-smi: {smi}")
    clock_mhz = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0])
    log(f"[env] nvidia-smi clocks.max.sm: {clock_mhz} MHz")
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
    return smi, clock_mhz


def phase_build():
    """Build and bind the eleven sources; returns the counts of K7's SASS
    instructions by opcode (:data:`K7_SASS_OPS`): its ISETP (integer
    compare) count must keep its 256 compares per value (fails below 256:
    the compiler folded them). Prints, and fails on a card that cannot
    hold them, the launch plans of K5 and K6 (clusters) and of K7 (equal
    slices, all resident at once) and of K9's cooperative kernel (the
    blocks the card holds at once); prints K8's registers and stack a K;
    and fails if a kernel of K9-K14 keeps a stack frame (registers
    spilled to local memory) or an instance of K8 loads a byte from
    shared memory."""
    from cudavideostream_tpu_torch import native
    from cudavideostream_tpu_torch.kernels import build
    from cudavideostream_tpu_torch.ops import convolve
    from cudavideostream_tpu_torch.ops import diff
    from cudavideostream_tpu_torch.ops import filters
    from cudavideostream_tpu_torch.ops import hist
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.ops import overlay
    from cudavideostream_tpu_torch.ops import register_compact

    t0 = time.perf_counter()
    names = ("logcompact", "pair_compact", "histogram", "segment_compact",
             "register_compact", "probe", "convolve", "binarize",
             "diff_pack", "visualize", "overlay")
    # one nvcc per source, and the host library's cc, all at once
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        host_lib = pool.submit(native.build)
        list(pool.map(build.build, names))
        host_lib.result()
    log(f"[build] native/csrc/cvstpu.c ({native.compiler()} "
        f"{' '.join(native.CFLAGS)}) bound from "
        f"{os.path.relpath(native.load()._name)}")
    logcompact._kernel_lib()
    logcompact._pair_lib()
    logcompact._segment_lib()
    register_compact._register_lib()
    hist._hist_lib()
    hist._probe()
    convolve._conv_lib()
    filters._binarize()
    diff._diff_pack_lib()
    filters._visualize_lib()
    overlay._overlay_lib()
    log(f"[build] csrc/{'.cu, csrc/'.join(names)}.cu built and bound in "
        f"{time.perf_counter() - t0:.2f} s")
    cuobjdump = build.find_nvcc()[: -len("nvcc")] + "cuobjdump"
    usage = subprocess.run(
        [cuobjdump, "-res-usage", str(build.build("convolve"))], check=True,
        capture_output=True, text=True).stdout
    found = sorted((int(k), int(reg), int(stack)) for k, reg, stack in
                   re.findall(r"conv_kernelILi(\d+)E\S*:\s*REG:(\d+) "
                              r"STACK:(\d+)", usage))
    if len(found) != convolve.CONV_MAX_K:
        raise AssertionError(f"csrc/convolve.cu: {len(found)} instances in "
                             f"its usage, not {convolve.CONV_MAX_K}:\n{usage}")
    # K8's instances are reported, not held to no stack frame: the halo
    # rows' test leaves a few with 8-16 B of spills, and still beats the
    # instances without it (PERF.md, section 6)
    log("[build] csrc/convolve.cu (cuobjdump -res-usage): conv_kernel<K> "
        "registers / stack bytes: " + ", ".join(
            f"K={k} {reg}/{stack}" for k, reg, stack in found))
    for name in ("binarize", "diff_pack", "visualize", "overlay"):
        usage = subprocess.run(
            [cuobjdump, "-res-usage", str(build.build(name))], check=True,
            capture_output=True, text=True).stdout
        found = re.findall(r"Function ([^\s:]+):\s*REG:(\d+) STACK:(\d+)",
                           usage)
        if not found or any(int(stack) for _, _, stack in found):
            raise AssertionError(f"csrc/{name}.cu: a kernel spills to a "
                                 f"stack frame, or no usage was read:\n"
                                 f"{usage}")
        log(f"[build] csrc/{name}.cu (cuobjdump -res-usage): "
            + ", ".join(f"{_demangled_kernel(fn)} {reg} registers"
                        for fn, reg, _ in found) + ", no stack frame")
    warp_tile_plans()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log("[build] K14 overlay_kernel: a 16-byte vector a lane, blocks of "
        f"{overlay.OVERLAY_THREADS} threads, at most "
        f"{overlay.OVERLAY_BLOCKS_PER_SM} an SM; " + "; ".join(
            f"B={b}: grid {overlay.overlay_plan(b * 288_000, sms)}"
            for b in (1, 4, 16)) + " (1080p strips of 288,000 B)")
    sass = subprocess.run([cuobjdump, "-sass", str(build.build("probe"))],
                          check=True, capture_output=True,
                          text=True).stdout.splitlines()
    mix = {op: sum(f" {op}" in line for line in sass) for op in K7_SASS_OPS}
    isetp = mix["ISETP"]
    log(f"[build] csrc/probe.cu SASS (cuobjdump -sass): {isetp} ISETP "
        f"compares, {sum('IADD' in line for line in sass)} IADD, in "
        f"{len(sass)} lines; per value and bin of its unrolled body ("
        f"{K7_BODY_PAIRS} pairs): " + ", ".join(
            f"{op} {mix[op] / K7_BODY_PAIRS:.3f}" for op in K7_SASS_OPS))
    if isetp < 256:
        raise AssertionError("K7's SASS lost its 256 compares per value")
    loads_first(cuobjdump, "logcompact", "tiled_unit_kernel", 4)
    loads_first(cuobjdump, "histogram", "hist_kernel", 1)
    conv_shared_loads(cuobjdump)
    coresident = filters.fused_coresident(torch.device("cuda"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {b: filters.binarize_plan(1920 * 1080, b, coresident)
             for b in (1, 2, 4, 8)}
    log(f"[build] K9 binarize_fused_kernel: a cooperative launch of blocks "
        f"of {filters.BIN_HIST_THREADS} threads; "
        f"cudaOccupancyMaxActiveBlocksPerMultiprocessor "
        f"{coresident // sms} x {sms} SMs = {coresident} co-resident; at "
        f"1080p " + ", ".join(
            f"B={b}: grid {g} x {r} run(s) a thread"
            + (f" ({r - filters.BIN_REG_RUNS} past the register budget of "
               f"{filters.BIN_REG_RUNS}, through device memory)"
               if r > filters.BIN_REG_RUNS else "")
            for b, (g, _, r) in plans.items()))
    if coresident < 1:
        raise AssertionError("K9: the card holds no block of its fused "
                             "kernel")
    plan = register_compact.register_plan(torch.device("cuda"))
    log(f"[build] K6 register_compact: clusters of {plan['cluster']} CTAs "
        f"(one a tile) x {plan['threads']} threads, {plan['smem']} B of "
        f"dynamic shared memory per CTA; cudaOccupancyMaxActiveClusters "
        f"{plan['active_clusters']}")
    if plan["active_clusters"] < 1:
        raise AssertionError("K6: no cluster of its launch fits the card")
    plan = logcompact.segment_plan(torch.device("cuda"))
    log(f"[build] K5 segment_compact: clusters of {plan['cluster']} CTAs "
        f"(one a tile) x {plan['threads']} threads, {plan['smem']} B of "
        f"dynamic shared memory per CTA; cudaOccupancyMaxActiveClusters "
        f"{plan['active_clusters']}")
    if plan["active_clusters"] < 1:
        raise AssertionError("K5: no cluster of its launch fits the card")
    plan = hist.probe_plan(torch.device("cuda"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[build] K7 vpu_probe: no cluster; {hist.probe_slices(45, sms)} "
        f"equal slices at 1080p (45 tiles), {plan['per_sm']} CTAs of "
        f"{plan['threads']} threads an SM in whole waves; "
        f"cudaOccupancyMaxActiveBlocksPerMultiprocessor {plan['resident']}")
    if plan["resident"] < plan["per_sm"]:
        raise AssertionError("K7: an SM cannot hold the CTAs its plan "
                             "gives it")
    return mix


def warp_tile_plans():
    """Print K10's, K11's and K12's launch plans at 1080p and at an S = 4 shard
    (grid, tiles, tiles an SM with block ``b`` on SM ``b mod SMs``)."""
    from cudavideostream_tpu_torch.ops import diff
    from cudavideostream_tpu_torch.ops import filters

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels = {
        "K10 diff_pack_kernel": (diff.diff_pack_plan, diff.DP_TILE,
                                 diff.DP_WARPS, diff.DP_BLOCKS_PER_SM),
        "K12 red_kernel": (
            functools.partial(filters.tile_plan,
                              per_sm=filters.RED_BLOCKS_PER_SM),
            filters.VIS_TILE, filters.VIS_WARPS, filters.RED_BLOCKS_PER_SM),
        "K11 heat_kernel": (
            functools.partial(filters.tile_plan,
                              per_sm=filters.HEAT_BLOCKS_PER_SM),
            filters.VIS_TILE, filters.VIS_WARPS, filters.HEAT_BLOCKS_PER_SM)}
    n = 1920 * 1080 * 3
    for name, (plan, tile, warps, per_sm) in kernels.items():
        shares = []
        for label, m in (("1080p", n), ("S=4 shard", n // 4)):
            grid, tiles = plan(m, sms), -(-m // tile)
            per = np.bincount(np.arange(tiles) % (grid * warps) % grid % sms,
                              minlength=sms)
            shares.append(f"{label}: grid {grid}, {tiles} tiles, "
                          f"{per.min()}-{per.max()} an SM")
        log(f"[build] {name}: warp tiles of {tile} B, {per_sm} blocks of "
            f"256 threads an SM; " + "; ".join(shares))


def _demangled_kernel(mangled):
    """The kernel's name in an Itanium-mangled symbol (a length, then the
    name: ``...e83b887811heat_kernel...`` -> ``heat_kernel``), with its
    template arguments as ``<Op, Map>`` where it has them."""
    name = mangled
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for k in range(len(digits)):
            cand = mangled[m.end():m.end() + int(digits[k:])]
            if cand.endswith("_kernel") and len(cand) == int(digits[k:]):
                name = cand
    args = re.search(r"_kernelILi(\d+)ELb(\d)E", mangled)
    if args:
        name += f"<{args.group(1)}, {str(args.group(2) == '1').lower()}>"
    return name


def loads_first(cuobjdump, source, kernel, instances):
    """Fail unless each of the ``instances`` instances of ``kernel`` in the
    SASS of ``csrc/source.cu`` loads from global memory before its first
    shared-memory store: nothing (no zeroing of its staging or its bins)
    waits in front of its loads."""
    from cudavideostream_tpu_torch.kernels import build

    lib = build.build(source)
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    found = 0
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        if kernel not in name:
            continue
        ops = []
        for line in body.splitlines():
            toks = line.split("*/", 1)[1].split() if "*/" in line else []
            if toks and not toks[0].startswith("0x"):
                # the opcode, after a predicate such as @!P0
                ops.append(toks[1] if toks[0].startswith("@") else toks[0])
        ldg = next((i for i, o in enumerate(ops)
                    if o.startswith(("LDG", "LD.")) or o == "LD"), None)
        sts = next((i for i, o in enumerate(ops) if o.startswith("STS")), None)
        log(f"[build] csrc/{source}.cu SASS {name.strip()[:60]}...: first "
            f"LDG at instruction {ldg}, first STS at {sts}, of {len(ops)}")
        if ldg is None or (sts is not None and sts < ldg):
            raise AssertionError(f"{kernel}: a shared store comes before the "
                                 "first global load")
        found += 1
    if found != instances:
        raise AssertionError(f"{kernel}: {found} instances in the SASS, not "
                             f"{instances}")


def conv_shared_loads(cuobjdump):
    """Fail unless every instance of K8's ``conv_kernel<K>`` (K = 1..15)
    reads shared memory with no byte load (``LDS.U8``, ``LDS.S8``): its
    window comes as 8-byte words (``LDS.64``) and its bytes out of them by
    permutes. Prints the loads and the IMAD and PRMT of each K."""
    from cudavideostream_tpu_torch.kernels import build
    from cudavideostream_tpu_torch.ops import convolve

    sass = subprocess.run([cuobjdump, "-sass", str(build.build("convolve"))],
                          check=True, capture_output=True, text=True).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        m = re.search(r"conv_kernelILi(\d+)E", name)
        if not m:
            continue
        ops = []
        for line in body.splitlines():
            toks = line.split("*/", 1)[1].split() if "*/" in line else []
            if toks and not toks[0].startswith("0x"):
                ops.append(toks[1] if toks[0].startswith("@") else toks[0])
        found[int(m.group(1))] = {
            "LDS.U8": sum(o.startswith(("LDS.U8", "LDS.S8")) for o in ops),
            "LDS": sum(o.startswith("LDS") for o in ops),
            "LDS.64": sum(o.startswith("LDS.64") for o in ops),
            "IMAD": sum(o.startswith("IMAD") for o in ops),
            "PRMT": sum(o.startswith("PRMT") for o in ops)}
    if sorted(found) != list(range(1, convolve.CONV_MAX_K + 1)):
        raise AssertionError(f"K8: instances {sorted(found)} in the SASS, "
                             f"not K = 1..{convolve.CONV_MAX_K}")
    log("[build] csrc/convolve.cu SASS (cuobjdump -sass), conv_kernel<K> "
        "shared loads / LDS.64 / byte loads / IMAD / PRMT: " + "; ".join(
            f"K={k} {c['LDS']}/{c['LDS.64']}/{c['LDS.U8']}/{c['IMAD']}/"
            f"{c['PRMT']}" for k, c in sorted(found.items())))
    bad = [k for k, c in found.items() if c["LDS.U8"]]
    if bad:
        raise AssertionError(f"K8: conv_kernel<{bad}> loads bytes from "
                             f"shared memory")


def _equal_or_raise(name, got, want,
                    labels=("pos", "xs", "vals", "new_prev")):
    """Byte-exact comparison of tensors, dtype and shape included;
    returns the largest absolute difference (0 when exact)."""
    err = 0
    for label, a, b in zip(labels, got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {label} {a.dtype}{tuple(a.shape)} "
                                 f"!= {b.dtype}{tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        e = int(d.max()) if d.numel() else 0
        if e:
            raise AssertionError(f"{name}: {label} differs (max |d| {e})")
        err = max(err, e)
    return err


def _back_to_back(label, launch, plain, cases, streams, labels):
    """``launch(*case)`` for every case back to back, on the current stream
    or alternating over ``streams`` new streams that run at once, with no
    sync between the launches; then each result against ``plain(*case)``.
    A launch that left its scratch in a wrong state would fail the next
    launch on its stream; two streams that shared scratch would fail each
    other. Returns the number of launches."""
    main = torch.cuda.current_stream()
    ss = ([torch.cuda.Stream() for _ in range(streams)] if streams > 1
          else [main])
    for s in ss:
        s.wait_stream(main)
    outs = []
    for i, case in enumerate(cases):
        with torch.cuda.stream(ss[i % len(ss)]):
            outs.append(launch(*case))
    for s in ss:
        main.wait_stream(s)
    torch.cuda.synchronize()
    for i, (case, got) in enumerate(zip(cases, outs)):
        _equal_or_raise(f"{label}, launch {i}", got, plain(*case), labels)
    return len(cases)


def _onepass_grid(lib_name):
    """(tile, persistent grid) of the one-pass K1 flat (no map), K2 or
    K3; for K1 tiled, (its 4096-byte tile, the blocks one wave holds)."""
    from cudavideostream_tpu_torch.ops import logcompact as lc

    idx = torch.cuda.current_device()
    if lib_name in ("flat", "tiled"):
        lib = lc._kernel_lib()
        if lib_name == "tiled":
            return (lc.TILE_BYTES,
                    lc._persistent_blocks(lib, "cvs_tiled_wave", idx))
        return (lib.cvs_flat_tile_bytes(),
                lc._persistent_blocks(lib, "cvs_flat_blocks", idx, 0))
    lib = lc._pair_lib()
    if lib_name == "vals":
        return (lib.cvs_vals_tile(),
                lc._persistent_blocks(lib, "cvs_vals_blocks", idx))
    return (lib.cvs_pair_tile(),
            lc._persistent_blocks(lib, "cvs_pair_blocks", idx))


def _n_for_tiles(target, mask=False, over=False):
    """``(n, tiles)``: a frame length whose tiled (or bitmask-only)
    emission at subtile_rows=1 pads to ``target`` tiles of 4096 bytes, or
    where the geometry cannot (the mask geometry pads to pairs of tiles)
    to the nearest count below it (``over``: above it)."""
    from cudavideostream_tpu_torch.ops import logcompact as lc

    geometry = lc.tiled_geometry_mask if mask else lc.tiled_geometry
    m = target * 4096 - 1000
    while True:
        tiles = -(-geometry(m, 1)[0] // lc.TILE_BYTES)
        if (tiles >= target if over else tiles <= target) or m == 1:
            return m, tiles
        m = m + 1024 if over else max(m - 1024, 1)


def _stores_pair():
    """Two zeroed ``prev_stores`` counters on the card: the kernel's and
    its plain version's."""
    return tuple(torch.zeros(1, dtype=torch.int64, device="cuda")
                 for _ in range(2))


def _stored_pct(stores, n, streams=1):
    """The vectors K1 stored as a share of the 16-byte vectors of
    ``streams`` frames of ``n`` bytes, counted from each one's first
    byte."""
    return 100.0 * int(stores) / (streams * -(-n // 16))


def _stored(pcts):
    """A check line's stored share of prev's vectors, or its range."""
    lo, hi = min(pcts), max(pcts)
    return (f"stored {lo:.2f}% of prev's vectors" if lo == hi else
            f"stored {lo:.2f}..{hi:.2f}% of prev's vectors")


_K1_LABELS = ("pos", "counts", "blocks", "vals_t or bits", "new_prev",
              "prev_stores")


def _k1_any(kind, cur, prev, plain=False):
    """One K1 call of ``kind`` (tiled subtile 1 or 8, bitmask-only,
    batched over 4 streams, or flat) on a copy of ``prev``, or its plain
    version: the launches that share one stream's scratch words. Its
    outputs and, last, its ``prev_stores`` counter."""
    from cudavideostream_tpu_torch.ops import logcompact as lc

    p = prev.clone()
    st = torch.zeros(1, dtype=torch.int64, device=cur.device)
    if kind in ("tiled1", "tiled8"):
        fn = (lc.fused_diff_compact_tiled_reference if plain
              else lc.fused_diff_compact_tiled)
        return fn(cur, p, 20, True, None, int(kind[-1]), prev_stores=st) + (st,)
    if kind == "mask":
        fn = (lc.fused_diff_compact_mask_reference if plain
              else lc.fused_diff_compact_mask)
        return fn(cur, p, 20, True, None, 1, prev_stores=st) + (st,)
    if kind == "batched4":
        fn = (lc.fused_diff_compact_batched_reference if plain
              else lc.fused_diff_compact_batched)
        return fn(cur, p, 4, sub_rows=1, prev_stores=st) + (st,)
    fn = lc.fused_diff_compact_reference if plain else lc.fused_diff_compact
    return fn(cur, p, 20, True, prev_stores=st) + (st,)


def phase_kernel_vs_plain(cfg):
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.ops import reference_cpu

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED)
    region = torch.from_numpy(rng.integers(
        0, 255, 288_000, endpoint=True, dtype=np.uint8)).to(dev)

    def run_both(name, prev, cur, thr, negfeed, reg, capacity=None,
                 tm=None):
        p_k, p_p = prev.clone(), prev.clone()
        s_k, s_p = _stores_pair()
        k = logcompact.fused_diff_compact(cur, p_k, thr, negfeed, reg,
                                          capacity, threshold_map=tm,
                                          prev_stores=s_k)
        torch.cuda.synchronize()
        p = logcompact.fused_diff_compact_reference(cur, p_p, thr, negfeed,
                                                    reg, capacity,
                                                    threshold_map=tm,
                                                    prev_stores=s_p)
        err = _equal_or_raise(name, k + (s_k,), p + (s_p,),
                              ("pos", "xs", "vals", "new_prev",
                               "prev_stores"))
        return err, int(k[0]), _stored_pct(s_k, cur.numel())

    def pair(m, density):
        return [torch.from_numpy(a).to(dev)
                for a in frame_pair(rng, m, density)]

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
                    err, pos, pct = run_both(name, prev, cur, thr, negfeed,
                                             reg)
                    max_err, cases = max(max_err, err), cases + 1
                    log(f"[check] {name}: pos={pos} exact; {_stored([pct])}")
    # ragged lengths (tails shorter than a 16-byte vector and a tile) and
    # a capacity below the count
    for m in (1000, 12_345):
        prev_np, cur_np = frame_pair(rng, m, 0.06)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        err, pos, pct = run_both(f"n={m}", prev, cur, 20, True, region[:700])
        max_err, cases = max(max_err, err), cases + 1
        log(f"[check] n={m} overlay=700 B: pos={pos} exact; {_stored([pct])}")
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    prev, cur = (torch.from_numpy(prev_np).to(dev),
                 torch.from_numpy(cur_np).to(dev))
    err, pos, pct = run_both("capacity", prev, cur, 20, True, region,
                             100_000)
    max_err, cases = max(max_err, err), cases + 1
    log(f"[check] capacity=100000 < pos={pos}: exact; {_stored([pct])}")

    # the one-pass kernel's edges: lengths around a tile and around the
    # persistent grid's size in tiles, a region across the first tile's
    # end, the map, pos at 0 and at n, cap around pos
    tile, blocks = _onepass_grid("flat")
    edges = (1, 15, 16, 17, tile - 1, tile, tile + 1,
             (blocks - 1) * tile + 5, (blocks + 1) * tile - 3)
    for m in edges:
        prev, cur = pair(m, 0.06)
        reg = region[:min(m, tile + 700)]
        tm = torch.from_numpy(byte_map(rng, m)).to(dev)
        pcts = []
        for label, kw in (("", {}), (" with a per-byte map", {"tm": tm})):
            err, pos, pct = run_both(f"one-pass n={m}{label}", prev, cur, 20,
                                     True, reg, **kw)
            max_err, cases = max(max_err, err), cases + 1
            pcts.append(pct)
        log(f"[check] K1 flat one-pass n={m} ({-(-m // tile)} tiles of "
            f"{tile} B, grid {min(blocks, -(-m // tile))} of {blocks}), "
            f"overlay {reg.numel()} B, without and with a per-byte map: "
            f"pos={pos} exact; {_stored(pcts)}")
    prev, cur = pair(n, 0.06)
    err, pos, pct0 = run_both("pos=0", prev, prev.clone(), 20, True, None)
    max_err, cases = max(max_err, err), cases + 1
    prev, cur = pair(n, 1.0)
    err, pos_n, pct_n = run_both("pos=n", prev, cur, 0, True, None)
    max_err, cases = max(max_err, err), cases + 1
    if (pos, pos_n) != (0, n):
        raise AssertionError(f"pos {pos} and {pos_n}, not 0 and {n}")
    if (pct0, pct_n) != (0.0, 100.0):
        raise AssertionError(f"stored {pct0}% and {pct_n}% of prev's "
                             "vectors, not 0% and 100%")
    log(f"[check] K1 flat one-pass pos=0 (cur == prev) and pos=n={n} "
        f"(density 1.0, thr 0): exact; stored 0% and 100% of prev's vectors")
    prev, cur = pair(n, 0.06)
    pos = int(logcompact.fused_diff_compact_reference(
        cur, prev.clone(), 20, True, region)[0])
    for cap in (pos - 1, pos, pos + 1, pos + 17):
        err, _, pct = run_both(f"cap={cap}", prev, cur, 20, True, region, cap)
        max_err, cases = max(max_err, err), cases + 1
    log(f"[check] K1 flat one-pass cap = pos-1, pos, pos+1, pos+17 "
        f"(pos={pos}): exact; {_stored([pct])}")

    # twenty launches back to back: on one stream, then over two streams
    # at once; lengths and densities vary, so a launch that left the
    # ticket, a status word or the done count set would fail the next
    sizes = (n, 17, tile + 1, n // 3, 1, (blocks + 1) * tile - 3)
    for streams in (1, 2):
        flat = []
        for i in range(20):
            prev, cur = pair(sizes[i % len(sizes)], (0.0, 0.06, 1.0)[i % 3])
            reg = region[:min(cur.numel(), 288_000)] if i % 2 else None
            flat.append((cur, prev.clone(), prev.clone(), reg,
                         *_stores_pair()))
        torch.cuda.synchronize()
        cases += _back_to_back(
            f"K1 flat back to back, {streams} stream(s)",
            lambda c, pk, pp, r, sk, sp: logcompact.fused_diff_compact(
                c, pk, 20, True, r, prev_stores=sk) + (sk,),
            lambda c, pk, pp, r, sk, sp:
                logcompact.fused_diff_compact_reference(
                    c, pp, 20, True, r, prev_stores=sp) + (sp,),
            flat, streams, ("pos", "xs", "vals", "new_prev", "prev_stores"))
        log(f"[check] K1 flat one-pass: 20 launches back to back on "
            f"{'one stream' if streams == 1 else 'two streams at once, no sync between them'}"
            f" (n {', '.join(str(x) for x in sizes)}; densities 0/0.06/1): "
            f"each exact against its plain version, prev_stores too")

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


def phase_tiled_vs_plain(cfg):
    """K1 tiled against its plain version at 1080p for subtile_rows 1, 8
    and 0, K2 on every tiled output and on raw pairs, and one tiled
    pipeline step against the NumPy spec."""
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.runtime import wire
    from cudavideostream_tpu_torch.utils import fonts

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED + 2)
    region = torch.from_numpy(rng.integers(
        0, 255, 288_000, endpoint=True, dtype=np.uint8)).to(dev)
    cases = {"k1": 0, "k2": 0}

    def check_merge(name, counts, xs_t, vals_t):
        got = logcompact.merge_tiles(counts, xs_t, vals_t)
        torch.cuda.synchronize()
        want = logcompact.pair_compact_reference(xs_t.reshape(-1),
                                                 vals_t.reshape(-1))[1:]
        _equal_or_raise(name, got, want, ("xs", "vals"))
        cases["k2"] += 1

    def run_both(name, prev, cur, thr, negfeed, reg, sub):
        p_k, p_p = prev.clone(), prev.clone()
        s_k, s_p = _stores_pair()
        k = logcompact.fused_diff_compact_tiled(cur, p_k, thr, negfeed, reg,
                                                sub, prev_stores=s_k)
        torch.cuda.synchronize()
        p = logcompact.fused_diff_compact_tiled_reference(
            cur, p_p, thr, negfeed, reg, sub, prev_stores=s_p)
        _equal_or_raise(name, k + (s_k,), p + (s_p,),
                        ("pos", "counts", "xs_t", "vals_t", "new_prev",
                         "prev_stores"))
        cases["k1"] += 1
        check_merge(name + " merge_tiles", *k[1:4])
        pcts.append(_stored_pct(s_k, cur.numel()))
        return int(k[0]), tuple(k[2].shape), k[1].dtype

    pcts = []

    for density in (0.0, 0.06, 1.0):
        prev_np, cur_np = frame_pair(rng, n, density)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        for sub in (1, 8, 0):
            poss = []
            pcts.clear()
            for thr in (0, 20, 255):
                for negfeed in (True, False):
                    for reg in (None, region):
                        name = (f"tiled sub={sub} d={density} thr={thr} "
                                f"negfeed={negfeed} overlay={reg is not None}")
                        pos, shape, cdt = run_both(name, prev, cur, thr,
                                                   negfeed, reg, sub)
                        poss.append(pos)
            log(f"[check] K1 tiled subtile={sub} d={density}: 12 cases "
                f"(thresholds 0/20/255 x negfeed x overlay) exact, units "
                f"{shape[0]} x {shape[1]} B, counts {cdt}, pos "
                f"{min(poss)}..{max(poss)}, prev_stores == the plain "
                f"version's, {_stored(pcts)}; K2 merge_tiles of each exact")
    for m in (1000, 12_345):
        prev_np, cur_np = frame_pair(rng, m, 0.06)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        pcts.clear()
        for sub in (1, 8, 0):
            run_both(f"tiled n={m} sub={sub}", prev, cur, 20, True,
                     region[:700], sub)
        log(f"[check] K1 tiled n={m} overlay=700 B, subtile 1/8/0: exact, "
            f"{_stored(pcts)}; K2 merge_tiles exact")
    # K1 tiled's one launch at tile counts 1, just under and just over one
    # wave of resident blocks (1080p's are the 12-case lines above)
    _, wave = _onepass_grid("tiled")
    for target, over in ((1, False), (wave - 1, False), (wave + 1, True)):
        m, tiles = _n_for_tiles(target, over=over)
        prev_np, cur_np = frame_pair(rng, m, 0.06)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        pcts.clear()
        for sub in (1, 8):
            run_both(f"tiled {tiles} tiles sub={sub}", prev, cur, 20, True,
                     region[:min(700, m)], sub)
        log(f"[check] K1 tiled one launch on {tiles} tiles of 4096 B (n={m}; "
            f"one wave holds {wave} blocks), subtile 1/8: exact, "
            f"{_stored(pcts)}; K2 merge_tiles exact")
    # raw pairs: a third of the xs are 0 (a valid index), vals zero in
    # between; lengths around K2's tile and around its persistent grid in
    # tiles, then every pair valid and none
    tile, blocks = _onepass_grid("pair")

    def raw(m, density):
        xs = torch.from_numpy(rng.integers(0, 3, m).astype(np.int32)).to(dev)
        vals = torch.from_numpy(np.where(
            rng.random(m) < density, rng.integers(1, 255, m, endpoint=True),
            0).astype(np.uint8)).to(dev)
        return xs, vals

    for m in (48_608 * 128, 777, 4096 * 1024 + 5, 1, 15, 16, 17, tile - 1,
              tile, tile + 1, (blocks - 1) * tile + 5,
              (blocks + 1) * tile - 3):
        xs, vals = raw(m, 0.3)
        got = logcompact.pair_compact(xs, vals)
        torch.cuda.synchronize()
        _equal_or_raise(f"pair_compact n={m}", got,
                        logcompact.pair_compact_reference(xs, vals),
                        ("pos", "xs", "vals"))
        pos = int(got[0])
        if m >= 777 and not bool((got[1][:pos] == 0).any()):
            raise AssertionError("no kept pair with index 0 in the check")
        cases["k2"] += 1
        log(f"[check] K2 pair_compact on {m} raw pairs ({-(-m // tile)} "
            f"tiles of {tile}, grid {min(blocks, -(-m // tile))} of "
            f"{blocks}; pos={pos}"
            f"{', xs == 0 kept' if m >= 777 else ''}): exact")
    for density, want in ((1.0, "all"), (0.0, "none")):
        xs, vals = raw(48_608 * 128, density)
        got = logcompact.pair_compact(xs, vals)
        torch.cuda.synchronize()
        _equal_or_raise(f"pair_compact {want} valid", got,
                        logcompact.pair_compact_reference(xs, vals),
                        ("pos", "xs", "vals"))
        if int(got[0]) != (xs.numel() if density else 0):
            raise AssertionError(f"pair_compact {want} valid: pos {int(got[0])}")
        cases["k2"] += 1
        log(f"[check] K2 pair_compact on {xs.numel()} raw pairs, {want} "
            f"valid (pos={int(got[0])}): exact")
    # twenty launches back to back: on one stream, then over two streams
    # at once, lengths and densities varying
    sizes = (48_608 * 128, 17, tile + 1, 777, 1, (blocks + 1) * tile - 3)
    for streams in (1, 2):
        pairs = [raw(sizes[i % len(sizes)], (0.0, 0.3, 1.0)[i % 3])
                 for i in range(20)]
        torch.cuda.synchronize()
        cases["k2"] += _back_to_back(
            f"K2 back to back, {streams} stream(s)", logcompact.pair_compact,
            logcompact.pair_compact_reference, pairs, streams,
            ("pos", "xs", "vals"))
        log(f"[check] K2 pair_compact: 20 launches back to back on "
            f"{'one stream' if streams == 1 else 'two streams at once, no sync between them'}"
            f" (n {', '.join(str(x) for x in sizes)}; densities 0/0.3/1): "
            f"each exact against its plain version")

    # K1's tiled emission keeps its streams' pos words in the scratch of
    # its stream, beside K1 flat's look-back words: twenty launches of
    # each kind in turn, back to back on one stream and on two at once
    small = 12_345
    frames = {}
    for kind, m, d in (("tiled1", n, 0.06), ("tiled8", small, 0.3),
                       ("mask", n, 1.0), ("batched4", 4 * small, 0.06),
                       ("flat", small, 0.3)):
        frames[kind] = [torch.from_numpy(a).to(dev)
                        for a in reversed(frame_pair(rng, m, d))]
    kinds = list(frames)
    for streams in (1, 2):
        cases_bb = [(kinds[i % len(kinds)], *frames[kinds[i % len(kinds)]])
                    for i in range(20)]
        torch.cuda.synchronize()
        cases["k1"] += _back_to_back(
            f"K1 back to back, {streams} stream(s)", _k1_any,
            lambda *c: _k1_any(*c, plain=True), cases_bb, streams,
            _K1_LABELS)
        log(f"[check] K1 tiled subtile 1 and 8, bitmask-only, batched B=4 "
            f"and flat: 20 launches back to back on "
            f"{'one stream' if streams == 1 else 'two streams at once, no sync between them'}"
            f": each exact against its plain version, prev_stores too")

    tcfg = dataclasses.replace(cfg, tiled_payload=True)
    pipe = DeltaStreamPipeline(tcfg)
    text = "FPS: 30 BW: 1234 kbps"
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    out = pipe.step(pipe.init_state(prev_np), cur_np, text=text)
    e_prev, e_pos, e_xs, e_vals, _ = reference_cpu.step_oracle(
        prev_np, cur_np, tcfg, atlas=pipe.atlas_np,
        char_ids=fonts.encode_text(text))
    tp = wire.TiledPayload(int(out[1]), out[2].cpu().numpy(),
                           out[3].cpu().numpy(), out[4].cpu().numpy())
    xs, vals = tp.to_flat()
    if not (tp.pos == e_pos and np.array_equal(xs, e_xs)
            and np.array_equal(vals, e_vals)
            and np.array_equal(out[0].cpu().numpy(), e_prev)):
        raise AssertionError("tiled pipeline.step on the card differs from "
                             "step_oracle")
    cases["k1"] += 1
    log(f"[check] tiled pipeline.step at 1080p == step_oracle after to_flat "
        f"(pos={tp.pos})")
    return cases


def phase_mask_vs_plain(cfg):
    """K1's bitmask-only emission against its plain version at 1080p for
    subtile_rows 1, 8 and 0, K1 tiled with packed bits at subtile_rows 1,
    K3 on every bitmask-only output and on raw streams, and one step of
    each mask configuration against the NumPy spec."""
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.runtime import wire
    from cudavideostream_tpu_torch.runtime.executor import TiledLander
    from cudavideostream_tpu_torch.utils import fonts

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED + 4)
    region = torch.from_numpy(rng.integers(
        0, 255, 288_000, endpoint=True, dtype=np.uint8)).to(dev)
    cases = {"k1_mask": 0, "k1_bits": 0, "k3": 0}

    def check_vals(name, vals_flat):
        got = logcompact.vals_compact(vals_flat)
        torch.cuda.synchronize()
        _equal_or_raise(name, got,
                        logcompact.vals_compact_reference(vals_flat),
                        ("pos", "vals"))
        cases["k3"] += 1
        return int(got[0])

    pcts = []

    def run_mask(name, prev, cur, thr, negfeed, reg, sub):
        p_k, p_p = prev.clone(), prev.clone()
        s_k, s_p = _stores_pair()
        k = logcompact.fused_diff_compact_mask(cur, p_k, thr, negfeed, reg,
                                               sub, prev_stores=s_k)
        torch.cuda.synchronize()
        p = logcompact.fused_diff_compact_mask_reference(
            cur, p_p, thr, negfeed, reg, sub, prev_stores=s_p)
        _equal_or_raise(name, k + (s_k,), p + (s_p,),
                        ("pos", "counts", "vals_t", "bits", "new_prev",
                         "prev_stores"))
        pcts.append(_stored_pct(s_k, cur.numel()))
        cases["k1_mask"] += 1
        merged = logcompact.merge_vals(k[1], k[2])
        torch.cuda.synchronize()
        _equal_or_raise(name + " merge_vals", (merged,),
                        (logcompact.vals_compact_reference(
                            k[2].reshape(-1))[1],), ("vals",))
        cases["k3"] += 1
        return int(k[0]), tuple(k[2].shape), k[1].dtype

    def run_bits(name, prev, cur, thr, negfeed, reg, sub):
        p_k, p_p = prev.clone(), prev.clone()
        s_k, s_p = _stores_pair()
        k = logcompact.fused_diff_compact_tiled(cur, p_k, thr, negfeed, reg,
                                                sub, emit_bits=True,
                                                prev_stores=s_k)
        torch.cuda.synchronize()
        p = logcompact.fused_diff_compact_tiled_reference(
            cur, p_p, thr, negfeed, reg, sub, emit_bits=True,
            prev_stores=s_p)
        _equal_or_raise(name, k + (s_k,), p + (s_p,),
                        ("pos", "counts", "xs_t", "vals_t", "bits",
                         "new_prev", "prev_stores"))
        pcts.append(_stored_pct(s_k, cur.numel()))
        cases["k1_bits"] += 1
        return int(k[0])

    grid = [(thr, negfeed, reg) for thr in (0, 20, 255)
            for negfeed in (True, False) for reg in (None, region)]
    for density in (0.0, 0.06, 1.0):
        prev_np, cur_np = frame_pair(rng, n, density)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        for sub in (1, 8, 0):
            poss = []
            pcts.clear()
            for thr, negfeed, reg in grid:
                name = (f"mask sub={sub} d={density} thr={thr} "
                        f"negfeed={negfeed} overlay={reg is not None}")
                pos, shape, cdt = run_mask(name, prev, cur, thr, negfeed,
                                           reg, sub)
                poss.append(pos)
            log(f"[check] K1 mask subtile={sub} d={density}: 12 cases "
                f"(thresholds 0/20/255 x negfeed x overlay) exact (pos, "
                f"counts, vals_t, bits, new_prev, prev_stores), units "
                f"{shape[0]} x {shape[1]} B, counts {cdt}, pos "
                f"{min(poss)}..{max(poss)}, {_stored(pcts)}; K3 merge_vals "
                f"of each exact")
        pcts.clear()
        poss = [run_bits(f"tiled+bits d={density} thr={thr} negfeed="
                         f"{negfeed} overlay={reg is not None}", prev, cur,
                         thr, negfeed, reg, 1) for thr, negfeed, reg in grid]
        log(f"[check] K1 tiled+bits subtile=1 d={density}: 12 cases exact "
            f"(pos, counts, xs_t, vals_t, bits, new_prev, prev_stores), pos "
            f"{min(poss)}..{max(poss)}, {_stored(pcts)}")
    for m in (1000, 12_345):
        prev_np, cur_np = frame_pair(rng, m, 0.06)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        pcts.clear()
        for sub in (1, 8, 0):
            run_mask(f"mask n={m} sub={sub}", prev, cur, 20, True,
                     region[:700], sub)
            run_bits(f"tiled+bits n={m} sub={sub}", prev, cur, 20, True,
                     region[:700], sub)
        log(f"[check] K1 mask and K1 tiled+bits n={m} overlay=700 B, "
            f"subtile 1/8/0: exact, {_stored(pcts)}; K3 merge_vals exact")
    # raw streams: the mask geometry's length, a short one, one that
    # takes two tiles per block, and an all-zero stream
    for m, density in ((6_225_920, 0.3), (777, 0.3), (4096 * 1024 + 5, 0.3),
                       (6_225_920, 0.0)):
        vals = torch.from_numpy(np.where(
            rng.random(m) < density, rng.integers(1, 255, m, endpoint=True),
            0).astype(np.uint8)).to(dev)
        pos = check_vals(f"vals_compact n={m} d={density}", vals)
        log(f"[check] K3 vals_compact on a raw stream of {m} B "
            f"(pos={pos}): exact")
    # K3's one pass at its edges: lengths around its tile and its
    # persistent grid in tiles, every byte nonzero and none
    tile, blocks = _onepass_grid("vals")

    def raw_vals(m, density):
        return torch.from_numpy(np.where(
            rng.random(m) < density, rng.integers(1, 255, m, endpoint=True),
            0).astype(np.uint8)).to(dev)

    for m, density in ((1, 1.0), (15, 0.3), (16, 0.3), (17, 0.3),
                       (tile - 1, 0.3), (tile, 0.3), (tile + 1, 0.3),
                       ((blocks - 1) * tile + 5, 0.1),
                       ((blocks + 1) * tile - 3, 0.1), (6_225_920, 1.0),
                       (6_225_920, 0.0)):
        pos = check_vals(f"vals_compact one pass n={m} d={density}",
                         raw_vals(m, density))
        if density in (0.0, 1.0) and pos != (m if density else 0):
            raise AssertionError(f"vals_compact n={m}: pos {pos}")
        log(f"[check] K3 vals_compact one pass n={m} ({-(-m // tile)} tiles "
            f"of {tile} B, grid {min(blocks, -(-m // tile))} of {blocks}; "
            f"d={density}, pos={pos}): exact")
    # twenty launches back to back, K3 and K2 (whose look-back words share
    # the stream's scratch) in turn, on one stream and on two at once
    sizes = (6_225_920, 17, tile + 1, 777, 1, (blocks + 1) * tile - 3)
    for streams in (1, 2):
        bb = []
        for i in range(20):
            m, d = sizes[i % len(sizes)], (0.0, 0.3, 1.0)[i % 3]
            vals = raw_vals(m, d)
            bb.append((vals, torch.arange(m, dtype=torch.int32, device=dev)
                       if i % 4 == 3 else None))

        def launch(vals, xs):
            return (logcompact.vals_compact(vals) if xs is None
                    else logcompact.pair_compact(xs, vals))

        def plain(vals, xs):
            return (logcompact.vals_compact_reference(vals) if xs is None
                    else logcompact.pair_compact_reference(xs, vals))

        torch.cuda.synchronize()
        cases["k3"] += _back_to_back(
            f"K3 back to back, {streams} stream(s)", launch, plain, bb,
            streams, ("pos", "vals or xs", "vals"))
        log(f"[check] K3 vals_compact (and K2 every fourth launch): 20 "
            f"launches back to back on "
            f"{'one stream' if streams == 1 else 'two streams at once, no sync between them'}"
            f" (n {', '.join(str(x) for x in sizes)}; densities 0/0.3/1): "
            f"each exact against its plain version")
    # K1's bitmask-only emission at tile counts 1 and around one wave
    _, wave = _onepass_grid("tiled")
    for target, over in ((1, False), (wave - 1, False), (wave + 1, True)):
        m, tiles = _n_for_tiles(target, mask=True, over=over)
        prev_np, cur_np = frame_pair(rng, m, 0.06)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        pcts.clear()
        run_mask(f"mask {tiles} tiles", prev, cur, 20, True,
                 region[:min(700, m)], 1)
        log(f"[check] K1 mask one launch on {tiles} tiles of 4096 B "
            f"(n={m}; one wave holds {wave} blocks), subtile 1: exact, "
            f"{_stored(pcts)}; K3 merge_vals exact")

    text = "FPS: 30 BW: 1234 kbps"
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    for label, kw in (
            ("bitmask-only", dict(fetch_mode="mask", maskonly_payload=True)),
            ("tiled+bits", {})):
        mcfg = dataclasses.replace(cfg, tiled_payload=True,
                                   emit_bitmask=True, **kw)
        pipe = DeltaStreamPipeline(mcfg)
        out = pipe.step(pipe.init_state(prev_np), cur_np, text=text)
        pos, counts, bits = int(out[1]), out[2], out[-2]
        vals_t = out[3] if mcfg.maskonly_payload else out[4]
        e_prev, e_pos, e_xs, e_vals, _ = reference_cpu.step_oracle(
            prev_np, cur_np, mcfg, atlas=pipe.atlas_np,
            char_ids=fonts.encode_text(text))
        vals = logcompact.merge_vals(counts, vals_t)
        xs, v = wire.MaskPayload(pos, 0, bits.cpu().numpy(),
                                 vals.cpu().numpy()).to_flat()
        rebuilt = TiledLander.rebuild_mask_xs(bits.cpu().numpy(), pos, 0,
                                              vals_t.shape[1])
        ok = (pos == e_pos and np.array_equal(xs, e_xs)
              and np.array_equal(rebuilt, e_xs) and np.array_equal(v, e_vals)
              and np.array_equal(out[0].cpu().numpy(), e_prev))
        if not mcfg.maskonly_payload:
            txs, tvals = wire.TiledPayload(
                pos, counts.cpu().numpy(), out[3].cpu().numpy(),
                vals_t.cpu().numpy()).to_flat()
            ok = ok and np.array_equal(txs, e_xs) and np.array_equal(
                tvals, e_vals)
        if not ok:
            raise AssertionError(f"{label} pipeline.step on the card differs "
                                 "from step_oracle")
        cases["k1_mask" if mcfg.maskonly_payload else "k1_bits"] += 1
        log(f"[check] {label} pipeline.step at 1080p == step_oracle after "
            f"MaskPayload.to_flat and the bits rebuild (pos={pos})")
    return cases


def _payload_host(cfg, out):
    """Host ``(pos, xs, vals)`` of one step's outputs in any emission: the
    tiled ones through ``TiledPayload.to_flat``, the bitmask-only one
    through K3 and the host rebuild from the bits (which must also agree
    with the index blocks where both exist)."""
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.runtime import wire
    from cudavideostream_tpu_torch.runtime.executor import TiledLander

    pos = int(out[1])
    if cfg.maskonly_payload:
        counts, vals_t, bits = out[2:5]
        vals = logcompact.merge_vals(counts, vals_t)[:pos].cpu().numpy()
        xs = TiledLander.rebuild_mask_xs(bits.cpu().numpy(), pos, 0,
                                         vals_t.shape[1])
        return pos, xs, vals
    if cfg.tiled_payload:
        xs, vals = wire.TiledPayload(pos, out[2].cpu().numpy(),
                                     out[3].cpu().numpy(),
                                     out[4].cpu().numpy()).to_flat()
        if cfg.emit_bitmask and not np.array_equal(
                TiledLander.rebuild_mask_xs(out[5].cpu().numpy(), pos, 0,
                                            out[4].shape[1]), xs):
            raise AssertionError("the packed bits disagree with the index "
                                 "blocks")
        return pos, xs, vals
    xs, vals = out[2].cpu().numpy(), out[3].cpu().numpy()
    if xs[pos:].any() or vals[pos:].any():
        raise AssertionError("the flat payload is not zero past pos")
    return pos, xs[:pos], vals[:pos]


def _check_step(label, cfg, prev_np, cur_np, text, threshold_map=None):
    """One 1080p ``pipeline.step`` on the card against ``step_oracle``:
    the payload, the new state and the aux frame, byte for byte."""
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.utils import fonts

    pipe = DeltaStreamPipeline(cfg, threshold_map=threshold_map)
    out = pipe.step(pipe.init_state(prev_np), cur_np, text=text)
    aux = None if out[-1] is None else out[-1].cpu().numpy()
    pos, xs, vals = _payload_host(cfg, out)
    e_prev, e_pos, e_xs, e_vals, e_aux = reference_cpu.step_oracle(
        prev_np, cur_np, cfg, atlas=pipe.atlas_np,
        char_ids=fonts.encode_text(text), threshold_map=threshold_map)
    ok = (pos == e_pos and np.array_equal(xs, e_xs)
          and np.array_equal(vals, e_vals)
          and np.array_equal(out[0].cpu().numpy(), e_prev)
          and (aux is None if e_aux is None
               else aux is not None and np.array_equal(aux, e_aux)))
    if not ok:
        raise AssertionError(f"{label}: pipeline.step on the card differs "
                             "from step_oracle")
    log(f"[check] {label}: pipeline.step at 1080p == step_oracle (pos={pos}"
        f", aux {'none' if aux is None else 'equal'})")


def phase_filters_vs_plain(cfg):
    """K4 against its plain version at 1080p and on ragged lengths, and
    one 1080p step of each of the 8 named variants and of binarize and
    red-overlap on each tiled emission against the NumPy spec."""
    from cudavideostream_tpu_torch.config import Visualizer
    from cudavideostream_tpu_torch.models import variants
    from cudavideostream_tpu_torch.ops import filters
    from cudavideostream_tpu_torch.ops import hist
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    npx = n // 3
    rng = np.random.default_rng(SEED + 6)
    cases = {"k4": 0, "steps": 0}

    def check_hist(label, g, quiet=False):
        got = hist.histogram(g)
        torch.cuda.synchronize()
        _equal_or_raise(f"K4 {label}", (got,),
                        (hist.histogram_reference(g),), ("counts",))
        if int(got.sum()) != g.numel():
            raise AssertionError(f"K4 {label}: counts do not sum to n")
        cases["k4"] += 1
        if not quiet:
            log(f"[check] K4 histogram of {label} ({g.numel()} values, "
                f"{int((got > 0).sum())} bins used): exact")

    def random_gray(m):
        return torch.from_numpy(rng.integers(0, 256, m,
                                             dtype=np.uint8)).to(dev)

    src = SyntheticSource(cfg, seed=SEED)
    src.base_frame()
    for label, frame in (
            ("a random 1080p frame's gray values",
             rng.integers(0, 256, n, dtype=np.uint8)),
            ("the synthetic scene's gray values", next(src))):
        check_hist(label, filters.gray_pixels(torch.from_numpy(frame).to(dev)))
    check_hist("one value (137) at every pixel",
               torch.full((npx,), 137, dtype=torch.uint8, device=dev))
    check_hist("0/255 only", torch.from_numpy(np.where(
        rng.random(npx) < 0.5, 0, 255).astype(np.uint8)).to(dev))
    for m in (1_000_003, 12_345, 1):
        check_hist(f"a ragged length {m}", random_gray(m))
    check_hist("255 at every pixel",
               torch.full((npx,), 255, dtype=torch.uint8, device=dev))

    # the launch plan's edges: lengths 1-17 (block 0 alone, the ragged
    # tail), around one block's share of 16-byte vectors and one full
    # grid's (a block on every SM), 1080p +- 1, and a shard's gray values
    # at S = 4 and 8 (the sharded --visualizer 5 step runs K4 once a shard)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    block = hist.HIST_THREADS * 16
    for label, lengths in (
            ("n = 1..17", range(1, 18)),
            (f"around one block's share ({block} B)",
             (block - 1, block, block + 1)),
            (f"around one full grid's share ({sms} blocks x {block} B)",
             (sms * block - 1, sms * block, sms * block + 1,
              sms * block + 17)),
            ("1080p +- 1", (npx - 1, npx + 1))):
        for m in lengths:
            check_hist(f"n={m}", random_gray(m), quiet=True)
        log(f"[check] K4 histogram {label}: n = "
            f"{', '.join(str(m) for m in lengths)} (grids "
            f"{', '.join(str(hist.hist_plan(m, sms)) for m in lengths)} of "
            f"{sms}): each exact")
    scene = filters.gray_pixels(torch.from_numpy(next(src)).to(dev))
    for s_count in (4, 8):
        shard = scene[(s_count - 1) * npx // s_count:]
        check_hist(f"the last of {s_count} row shards of the scene's gray "
                   f"values", shard)
    for streams in (1, 2):
        grays = [(random_gray(m),) for m in
                 (npx, 17, 1, npx // 4, block + 1, sms * block + 17) * 3
                 + (npx - 1, 255)]
        torch.cuda.synchronize()
        cases["k4"] += _back_to_back(
            f"K4 back to back, {streams} stream(s)",
            lambda g: (hist.histogram(g),),
            lambda g: (hist.histogram_reference(g),), grays, streams,
            ("counts",))
        log(f"[check] K4 histogram: 20 launches back to back on "
            f"{'one stream' if streams == 1 else 'two streams at once, no sync between them'}"
            f" (lengths from 1 to {npx}): each exact against its plain "
            f"version (the per-stream scratch left zero by each)")

    text = "FPS: 30 BW: 1234 kbps"
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    for name in variants.available():
        _check_step(f"variant {name}", variants.get_config(name), prev_np,
                    cur_np, text)
        cases["steps"] += 1
    for vis in (Visualizer.BINARIZE, Visualizer.RED_OVERLAP):
        for label, kw in (
                ("tiled", dict(tiled_payload=True)),
                ("tiled+bits", dict(tiled_payload=True, emit_bitmask=True)),
                ("bitmask-only", dict(tiled_payload=True, emit_bitmask=True,
                                      fetch_mode="mask",
                                      maskonly_payload=True))):
            _check_step(f"{label} with --visualizer {vis.value}",
                        dataclasses.replace(cfg, visualizer=vis, **kw),
                        prev_np, cur_np, text)
            cases["steps"] += 1
    return cases


def phase_noise_binarize_vs_plain(cfg):
    """K8 (``convolve_q16``) and K9 (``binarize_pipeline``, one
    cooperative launch; the sharded path's ``gray_hist`` then
    ``binarize_apply``) against their plain versions on the card, byte for
    byte: K8 at 1080p for K = 1, 2, 3, 5, 7, 9 and 15 with Gaussian, mean
    and signed unnormalized taps (sums that wrap in int32), at those K on
    ragged widths (5,751 B a row, % 16 = 7; 1,026 B, a 2-byte second column
    tile; 3 B), where a thread's 8-byte strip straddles the row's end, at
    B = 1, 2 and 4 streams, and on S = 4 halo shards against the solo
    frame, one launch a call; K9 at 1080p, on the synthetic scene, a
    one-value frame, a frame whose histogram ties, ragged lengths and an
    unaligned view, one launch a call, a frame past the register budget
    (runs through device memory), B = 2, 4 and 8 streams at 1080p with and
    without their overlay strips (one ending inside a run) against each
    stream's plain version, one launch a batched frame, the sharded form
    at S = 4, and 100 launches back to back on one stream and on two at
    once, after which every per-stream scratch is zero."""
    from cudavideostream_tpu_torch.ops import convolve
    from cudavideostream_tpu_torch.ops import filters
    from cudavideostream_tpu_torch.ops import hist
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.parallel import halo_conv
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    dev = torch.device("cuda")
    h, w, n = cfg.height, cfg.width, cfg.frame_bytes
    rng = np.random.default_rng(SEED + 30)
    cases = {"k8": 0, "k9": 0}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def rand(m):
        return torch.from_numpy(rng.integers(0, 256, m,
                                             dtype=np.uint8)).to(dev)

    def taps(kind, k):
        if kind == "gaussian":
            return reference_cpu.quantize_kernel_q16(
                reference_cpu.gaussian_kernel(k))
        if kind == "mean":
            return reference_cpu.quantize_kernel_q16(
                reference_cpu.mean_kernel(k))
        # signed and unnormalized: sums far outside int32, which wrap
        return rng.integers(-3_000_000, 3_000_000, (k, k))

    def check8(label, call, want, launches=1):
        before = convolve.convolve_q16.launches
        got = call()
        torch.cuda.synchronize()
        if convolve.convolve_q16.launches - before != launches:
            raise AssertionError(f"K8 {label}: not {launches} launch(es)")
        _equal_or_raise(f"K8 {label}", (got,), (want,), ("out",))
        cases["k8"] += 1

    all_k = (1, 2, 3, 5, 7, 9, 15)
    frame = rand(n)
    for k in all_k:
        for kind in ("gaussian", "mean", "signed"):
            wq = taps(kind, k)
            check8(f"K={k} {kind}",
                   lambda: convolve.convolve_q16(frame, wq, h, w),
                   convolve.convolve_q16_reference(frame, wq, h, w))
        grid, tile_rows = convolve.conv_plan(h, w * 3, 1, sms)
        log(f"[check] K8 convolve_q16 K={k} at 1080p (grid {grid}, tiles of "
            f"{tile_rows} rows x {convolve.CONV_TILE_BYTES} B, a strip of "
            f"{convolve.CONV_STRIP_BYTES} B a thread): gaussian, mean and "
            f"signed unnormalized taps, each == convolve_q16_reference, "
            f"exact, one launch a call")
    # ragged widths: 5,751 B a row (% 16 = 7: no row but the first starts
    # 16-byte aligned; the last strip holds 7 bytes of its 8), 1,026 B (a
    # second column tile of 2 bytes), 3 B; streams at those strides
    for hr, wr, bs in ((271, 1917, (1, 2, 4)), (37, 342, (1, 4)),
                       (9, 1, (1, 2))):
        nr = hr * wr * 3
        for b in bs:
            frames = rand(b * nr)
            for k in all_k:
                wq = taps("signed" if k % 2 else "gaussian", k)
                check8(f"{hr}x{wr} B={b} K={k}",
                       lambda: convolve.convolve_q16(frames, wq, hr, wr,
                                                     streams=b),
                       torch.cat([convolve.convolve_q16_reference(
                           frames[s * nr:(s + 1) * nr], wq, hr, wr)
                           for s in range(b)]))
            grid, tile_rows = convolve.conv_plan(hr, wr * 3, b, sms)
            log(f"[check] K8 convolve_q16 on {hr}x{wr} ({wr * 3} B a row, "
                f"% 16 = {wr * 3 % 16}, the last strip "
                f"{(wr * 3 - 1) % convolve.CONV_STRIP_BYTES + 1} of "
                f"{convolve.CONV_STRIP_BYTES} B), B={b} stream(s) at a "
                f"stride of {nr} B, one launch (grid {grid}, tiles of "
                f"{tile_rows} rows), K = {', '.join(map(str, all_k))} "
                f"(signed taps at odd K): each == its plain version per "
                f"stream, exact")
    s_count = 4
    ln = n // s_count
    for k in all_k + (4,):
        wq = taps("signed" if k % 2 else "gaussian", k)
        check8(f"S={s_count} halo K={k}",
               lambda: torch.cat(halo_conv.sharded_convolve_q16(
                   [frame[i * ln:(i + 1) * ln] for i in range(s_count)], wq,
                   h // s_count, w)),
               convolve.convolve_q16_reference(frame, wq, h, w),
               launches=s_count)
    log(f"[check] K8 halo form on S={s_count} row shards of 1080p (uint8 "
        f"halo rows exchanged, one launch a shard), K = "
        f"{', '.join(map(str, all_k + (4,)))}: the shards' rows == the solo "
        f"frame's plain version, exact")

    def check9(label, fr, region=None, streams=1):
        before = filters.binarize_pipeline.launches
        got = filters.binarize_pipeline(fr, region=region, streams=streams)
        torch.cuda.synchronize()
        if filters.binarize_pipeline.launches - before != 1:
            raise AssertionError(f"K9 {label}: not one launch")
        m = fr.numel() // streams
        r = 0 if region is None else region.numel() // streams
        want = torch.cat([filters.binarize_pipeline_reference(
            fr[b * m:(b + 1) * m],
            region[b * r:(b + 1) * r] if r else None)
            for b in range(streams)])
        _equal_or_raise(f"K9 {label}", (got,), (want,), ("out",))
        cases["k9"] += 1
        return got

    npx = n // 3
    src = SyntheticSource(cfg, seed=SEED)
    src.base_frame()
    scene = torch.from_numpy(next(src)).to(dev)
    tie = torch.empty((npx, 3), dtype=torch.uint8, device=dev)
    tie[: npx // 2], tie[npx // 2:] = 90, 200  # gray 90 and 200, equal counts
    for label, fr in (("a random 1080p frame", frame),
                      ("the synthetic scene", scene),
                      ("one value (137) everywhere",
                       torch.full((n,), 137, dtype=torch.uint8, device=dev)),
                      ("a histogram tie (gray 90 and 200, npx/2 each)",
                       tie.reshape(-1))):
        gray, counts = filters.gray_hist(fr)
        _equal_or_raise(f"K9 gray_hist {label}", (gray, counts), (
            filters.gray_pixels(fr),
            hist.histogram_reference(filters.gray_pixels(fr))),
            ("gray", "hist"))
        out = check9(label, fr)
        log(f"[check] K9 binarize_pipeline on {label}: one launch, output "
            f"== the plain version, exact ({int(out.eq(255).sum()) // 3} "
            f"pixels 255); gray_hist's gray bytes and histogram "
            f"({int((counts > 0).sum())} bins used) == the plain version")
    lengths = (1, 15, 16, 17, 12_345, 1_000_003, npx - 1, npx + 1)
    for m in lengths:
        check9(f"{m} pixels", rand(3 * m))
    check9("an unaligned view", rand(3 * 10_007 + 3)[3:])
    log(f"[check] K9 binarize_pipeline on ragged lengths "
        f"{', '.join(str(m) for m in lengths)} pixels and on a view 3 B past "
        f"an aligned start (10,007 pixels): each == the plain version, "
        f"exact, one launch a call")
    # past the register budget: the least whole runs of a frame that give a
    # thread BIN_REG_RUNS + 1 runs on this card, and a ragged tail
    coresident = filters.fused_coresident(dev)
    big = coresident * filters.BIN_HIST_THREADS * filters.BIN_PIXELS * (
        filters.BIN_REG_RUNS + 1) - 5
    _, _, runs = filters.binarize_plan(big, 1, coresident)
    if runs <= filters.BIN_REG_RUNS:
        raise AssertionError("K9: the frame meant to pass the register "
                             "budget stays within it")
    strip = rand(9 * w * 3 + 6)
    check9(f"{big} pixels ({runs} runs a thread)", rand(3 * big))
    check9(f"{big} pixels with a strip", rand(3 * big), region=strip)
    log(f"[check] K9 binarize_pipeline past the register budget: {big} "
        f"pixels, {runs} runs of {filters.BIN_PIXELS} a thread of "
        f"{filters.BIN_REG_RUNS} kept in registers, the rest through device "
        f"memory; without and with a strip of {strip.numel()} B (its last "
        f"run straddling): == the plain version, exact, one launch")
    # B streams of 1080p at once, each with its own threshold: the scene,
    # a frame of one value and random frames; each stream's strip
    for b in (2, 4, 8):
        parts = [scene, torch.full((n,), 200, dtype=torch.uint8, device=dev)]
        parts += [rand(n) for _ in range(b - 2)]
        fr = torch.cat(parts)
        strips = rand(b * (9 * w * 3 + 6))
        _, _, runs = filters.binarize_plan(npx, b, coresident)
        check9(f"B={b}", fr, streams=b)
        check9(f"B={b} with strips", fr, region=strips, streams=b)
        log(f"[check] K9 binarize_pipeline on B={b} streams of 1080p in one "
            f"launch ({runs} runs a thread"
            + (", past the register budget" if runs > filters.BIN_REG_RUNS
               else "") + "), without and with each stream's strip of "
            f"{9 * w * 3 + 6} B (its last run straddling): every stream == "
            f"its plain version, exact")
    # the sharded form: each shard's gray and counts, the counts summed,
    # the sum applied on each shard
    shards = [frame[i * ln:(i + 1) * ln] for i in range(s_count)]
    parts = [filters.gray_hist(x) for x in shards]
    total = sum(c for _, c in parts)
    got = torch.cat([filters.binarize_apply(g, total) for g, _ in parts])
    torch.cuda.synchronize()
    _equal_or_raise("K9 sharded S=4", (got, total), (
        filters.binarize_pipeline_reference(frame),
        hist.histogram_reference(filters.gray_pixels(frame))),
        ("out", "hist"))
    cases["k9"] += 1
    log(f"[check] K9 sharded S={s_count}: gray_hist on each shard, the "
        f"histograms summed, binarize_apply of the sum on each shard == the "
        f"solo frame's plain version and histogram, exact")
    # 100 launches back to back on one stream, then on two at once, no sync
    # between them, mixing solo calls and B = 4 (each B its own scratch)
    for nstreams in (1, 2):
        main = torch.cuda.current_stream()
        ss = ([torch.cuda.Stream() for _ in range(nstreams)]
              if nstreams > 1 else [main])
        for st in ss:
            st.wait_stream(main)
        inputs = [(frame, 1) if i % 5 == 0 else
                  (rand(4 * 3 * 1000 * (i + 1)), 4) if i % 5 == 1 else
                  (rand(3 * int(rng.integers(1, 300_000))), 1)
                  for i in range(100)]
        outs = []
        for i, (fr, b) in enumerate(inputs):
            with torch.cuda.stream(ss[i % len(ss)]):
                outs.append(filters.binarize_pipeline(fr, streams=b))
        for st in ss:
            main.wait_stream(st)
        torch.cuda.synchronize()
        for i, ((fr, b), got) in enumerate(zip(inputs, outs)):
            m = fr.numel() // b
            _equal_or_raise(f"K9 back to back, call {i}", (got,), (
                torch.cat([filters.binarize_pipeline_reference(
                    fr[s * m:(s + 1) * m]) for s in range(b)]),), ("out",))
        dirty = [k for k, v in list(filters._fused_scratch.items())
                 + list(hist._scratch.items()) if v.any()]
        if dirty:
            raise AssertionError(f"K9: scratch not zero after the launches: "
                                 f"{dirty}")
        cases["k9"] += len(inputs)
        log(f"[check] K9 binarize_pipeline: 100 launches back to back on "
            f"{nstreams} stream(s){' at once' if nstreams > 1 else ''}, no "
            f"sync between them, solo and B=4: each call == the plain "
            f"version, exact, and every per-stream scratch "
            f"({len(filters._fused_scratch)} of the fused kernel, "
            f"{len(hist._scratch)} of gray_hist) is zero after them")
    return cases


def phase_visualize_vs_plain(cfg):
    """K10 (``diff_pack``, the HOST step) and K11-K13 (``heatmap``,
    ``red_visualizer``, ``grayscale_average`` / ``_weighted``) against
    their plain versions on the card, byte for byte: at 1080p and on a
    ragged width (5,751 B a row), without a region, with the overlay strip
    and with a strip whose end falls inside a 16-byte vector; K10 and
    K12 with thresholds 20 and 0, a per-byte map and a map of 0s and
    255s; K10 with and without negative feedback and the delta, on
    lengths 1-17, 127-129 and lengths not a multiple of 8, and on views
    that start unaligned; K10-K13 at their warp tiles' edges (whole
    tiles +- 1-127 B or 1-47 pixels, strips ending inside a tile and a
    vector, unaligned views, B = 2 and 4 streams whose stride splits a
    tile); K11 on a pair that reaches d = 510..765; K11-K13
    on B = 2 and 4 streams at a ragged stride against B solo calls; all
    four on S = 4 row shards against the solo frame; 20 launches of each
    back to back on one stream and on two at once; K9 with the overlay
    region; and a 1080p ``pipeline.step`` of ``--visualizer 1-4``, with
    and without ``--noise-filter``, against ``step_oracle`` with its
    launches (the HOST steps are checked in the backends phase)."""
    from cudavideostream_tpu_torch.config import Visualizer
    from cudavideostream_tpu_torch.ops import diff, filters, hist
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.utils import fonts

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 40)
    cases = {"k10": 0, "k11": 0, "k12": 0, "k13": 0, "k9_region": 0,
             "steps": 0}
    cell_h = fonts.make_atlas(cfg.overlay_scale, cfg.overlay_font).shape[1]

    def rand(m):
        return torch.from_numpy(rng.integers(0, 256, m,
                                             dtype=np.uint8)).to(dev)

    def maps(m):
        return {"20": 20, "0": 0, "a map": rand(m),
                "a map of 0s and 255s": torch.where(
                    rand(m) < 128, 0, 255).to(torch.uint8)}

    def k10(label, cur, prev, thr, nf, reg, wd):
        p1, p2 = prev.clone(), prev.clone()
        b1, d1 = diff.diff_pack(cur, p1, thr, nf, reg, wd)
        b2, d2 = diff.diff_pack_reference(cur, p2, thr, nf, reg, wd)
        torch.cuda.synchronize()
        _equal_or_raise(f"K10 {label}", (b1, p1) + ((d1,) if wd else ()),
                        (b2, p2) + ((d2,) if wd else ()),
                        ("bits", "new_prev", "delta"))
        cases["k10"] += 1
        return b1

    # (kernel entry, plain version, K number) of each visualizer op; each
    # takes (cur, prev, threshold, region, streams)
    vis_ops = {
        "heatmap": (
            lambda c, p, t, r, s: filters.heatmap(c, p, r, s),
            lambda c, p, t, r, s: filters.heatmap_reference(c, p, r, s),
            "k11"),
        "red black": (
            lambda c, p, t, r, s: filters.red_visualizer(c, p, t, False, r,
                                                         s),
            lambda c, p, t, r, s: filters.red_visualizer_reference(
                c, p, t, False, r, s), "k12"),
        "red overlap": (
            lambda c, p, t, r, s: filters.red_visualizer(c, p, t, True, r,
                                                         s),
            lambda c, p, t, r, s: filters.red_visualizer_reference(
                c, p, t, True, r, s), "k12"),
        "grayscale average": (
            lambda c, p, t, r, s: filters.grayscale_average(c, r, s),
            lambda c, p, t, r, s: filters.grayscale_average_reference(
                c, r, s), "k13"),
        "grayscale weighted": (
            lambda c, p, t, r, s: filters.grayscale_weighted(c, r, s),
            lambda c, p, t, r, s: filters.grayscale_weighted_reference(
                c, r, s), "k13"),
    }

    def vis(op, label, cur, prev, thr=20, reg=None, streams=1):
        launch, plain, k = vis_ops[op]
        got = launch(cur, prev, thr, reg, streams)
        torch.cuda.synchronize()
        _equal_or_raise(f"{k.upper()} {op} {label}", (got,),
                        (plain(cur, prev, thr, reg, streams),), ("out",))
        cases[k] += 1
        return got

    for h, w in ((cfg.height, cfg.width), (271, 1917)):
        n = h * w * 3
        strip = cell_h * w * 3
        regions = {"no region": None, f"the strip ({strip} B)": rand(strip),
                   f"a strip ending inside a vector ({strip + 6} B)":
                       rand(strip + 6)}
        cur, prev = (torch.from_numpy(f).to(dev)
                     for f in frame_pair(rng, n, 0.06)[::-1])
        thrs = maps(n)
        for rlabel, reg in regions.items():
            for tlabel, thr in thrs.items():
                for nf in (True, False):
                    for wd in (False, True):
                        k10(f"{h}x{w} {rlabel} {tlabel} nf={nf} delta={wd}",
                            cur, prev, thr, nf, reg, wd)
                for op in ("red black", "red overlap"):
                    vis(op, f"{h}x{w} {rlabel} {tlabel}", cur, prev, thr, reg)
            for op in ("heatmap", "grayscale average", "grayscale weighted"):
                vis(op, f"{h}x{w} {rlabel}", cur, prev, 20, reg)
        log(f"[check] K10 diff_pack, K11 heatmap, K12 red modes 2 and 3, K13 "
            f"grayscale average and weighted at {h}x{w} ({w * 3} B a row, "
            f"% 16 = {w * 3 % 16}), each {', '.join(regions)}; K10 and K12 "
            f"with threshold {', '.join(thrs)}; K10 with and without "
            f"negative feedback and the delta: each == its plain version, "
            f"exact")
    n = cfg.frame_bytes
    # K10 on ragged lengths (the last bits byte padded with zeros) and on
    # views that start 3 bytes past an aligned address
    lengths = (1, 7, 8, 9, 15, 16, 17, 127, 128, 129, 1_000_003, n + 5)
    for m in lengths:
        cur, prev = rand(m), rand(m)
        bits = k10(f"{m} B", cur, prev, 20, True, None, True)
        if m % 8 and int(bits[-1]) >> (m % 8):
            raise AssertionError(f"K10 {m} B: the padding bits are not zero")
        k10(f"{m} B views", rand(m + 3)[3:], rand(m + 3)[3:], 0, False,
            None, False)
    log(f"[check] K10 diff_pack on {', '.join(str(m) for m in lengths)} B "
        f"(the last bits byte's padding zero) and on views 3 B past an "
        f"aligned start: each == its plain version, exact")
    npx = n // 3
    for m in (1, 15, 16, 17, 12_345, npx - 1, npx + 1):
        cur, prev = rand(3 * m + 3)[3:], rand(3 * m)
        for op in vis_ops:
            vis(op, f"{m} pixels, cur 3 B past an aligned start", cur, prev,
                rand(3 * m) if op.startswith("red") else 20,
                rand(min(3 * m, 51)))
    log("[check] K11-K13 on 1, 15, 16, 17, 12,345 and 1080p +- 1 pixels, "
        "the frame 3 B past an aligned start, a 51-byte region, K12 with a "
        "map: each == its plain version, exact")
    # the warp tiles' edges: K10's tiles of DP_TILE bytes, K11-K13's of
    # VIS_TILE (512 pixels); strips that end inside a tile and inside a
    # 16-byte vector; frames, prev and maps that are not 16-byte aligned
    for k in (1, 3, 10):
        for d in (-127, -64, -17, -16, -15, -8, -1, 1, 8, 15, 16, 17, 127):
            m = k * diff.DP_TILE + d
            cur, prev, tmap = rand(m + 1)[1:], rand(m + 5)[5:], rand(m + 3)[3:]
            k10(f"{m} B, views", cur, prev, tmap, True,
                rand(min(m, diff.DP_TILE + 8)), True)
            k10(f"{m} B", rand(m), rand(m), 20, True,
                rand(min(m, (k - 1) * diff.DP_TILE + 24)), False)
    for k in (1, 2, 7):
        for d in (-47, -31, -16, -5, -1, 1, 5, 16, 31, 47):
            px = k * filters.VIS_TILE // 3 + d
            m = 3 * px
            for op in vis_ops:
                red = op.startswith("red")
                vis(op, f"{px} pixels, views", rand(m + 3)[3:],
                    rand(m + 1)[1:], rand(m + 7)[7:] if red else 20,
                    rand(min(m, filters.VIS_TILE + 6)))
                vis(op, f"{px} pixels", rand(m), rand(m), 20,
                    rand(min(m, (k - 1) * filters.VIS_TILE + 21)))
    for b, px in ((2, 3 * 1109), (4, 2 * 1109), (2, 512 * 4 + 1),
                  (4, 512 + 7)):
        sn = 3 * px
        for op in vis_ops:
            thrs = ((("20", 20), ("a map", rand(sn + 9)[9:]))
                    if op.startswith("red") else (("", 20),))
            for tlabel, thr in thrs:
                vis(op, f"B={b} streams of {sn} B{', ' if tlabel else ''}"
                    f"{tlabel}", rand(b * sn + 3)[3:], rand(b * sn + 5)[5:],
                    thr, rand(b * (sn // 2 + 7)), b)
    log(f"[check] K10 at whole warp tiles ({diff.DP_TILE} B) +- 1-127 B "
        f"and K11-K13 at whole tiles ({filters.VIS_TILE} B) +- 1-47 "
        f"pixels (k = 1, 2, 7 tiles), with strips ending inside a tile and "
        f"inside a vector, frames, prev and maps 1-7 B past an aligned "
        f"start; K11-K13 on B = 2 and 4 streams whose stride splits a "
        f"tile, K12 with the int threshold and a map (unaligned): each == "
        f"its plain version, exact")
    # K11 reaches the colormap's wrap: sums 0..765 over the frame
    d = torch.arange(npx, device=dev) % 766
    px = torch.stack([d.clamp(max=255), (d - 255).clamp(0, 255),
                      (d - 510).clamp(0, 255)], dim=1).to(torch.uint8)
    heat = vis("heatmap", "with d = 0..765 (the wrap past 510)",
               px.reshape(-1), torch.zeros(n, dtype=torch.uint8, device=dev))
    lut = torch.from_numpy(reference_cpu.heatmap_lut().copy()).to(dev)
    if not torch.equal(heat.view(-1, 3)[:766], lut):
        raise AssertionError("K11: d = 0..765 does not give the LUT")
    log("[check] K11 heatmap on a 1080p pair whose per-pixel sums run over "
        "0..765: == its plain version and the 766-entry LUT in order, "
        "exact (the wrap past d = 510 included)")
    # the super-frame: B streams at a ragged stride, one launch
    hr, wr = 271, 1917
    nr = hr * wr * 3
    for b in (2, 4):
        cur, prev = rand(b * nr + 3)[3:], rand(b * nr)
        strip = 17 * wr * 3 + 6
        strips, tmap = rand(b * strip), rand(nr)
        for op in vis_ops:
            thr = tmap if op.startswith("red") else 20
            got = vis(op, f"B={b}", cur, prev, thr, strips, b)
            for s in range(b):
                sl = slice(s * nr, (s + 1) * nr)
                one = vis_ops[op][0](cur[sl], prev[sl], thr,
                                     strips[s * strip:(s + 1) * strip], 1)
                torch.cuda.synchronize()
                _equal_or_raise(f"{op} B={b} stream {s}", (got[sl],), (one,),
                                ("out",))
        log(f"[check] K11-K13 on B={b} streams of {hr}x{wr} at a stride of "
            f"{nr} B (odd: stream 1 starts unaligned), each with its strip "
            f"of {strip} B, K12 with one stream's map, one launch: == the "
            f"plain version and == {b} solo launches, exact")
    # S = 4 row shards, each with its part of the strip and of the map
    s_count, ln = 4, n // 4
    cur, prev = (torch.from_numpy(f).to(dev)
                 for f in frame_pair(rng, n, 0.06)[::-1])
    region = rand((ln // (cfg.width * 3) + 3) * cfg.width * 3)
    tmap = rand(n)

    def shard_region(i):
        return region[i * ln:(i + 1) * ln] if i * ln < region.numel() else None

    for op in vis_ops:
        thr = tmap if op.startswith("red") else 20
        got = torch.cat([vis_ops[op][0](
            cur[i * ln:(i + 1) * ln], prev[i * ln:(i + 1) * ln],
            thr[i * ln:(i + 1) * ln] if op.startswith("red") else thr,
            shard_region(i), 1) for i in range(s_count)])
        vis(op, "the solo frame", cur, prev, thr, region)
        torch.cuda.synchronize()
        _equal_or_raise(f"{op} S={s_count}", (got,),
                        (vis_ops[op][1](cur, prev, thr, region, 1),),
                        ("out",))
    bits_s, prevs_s = [], []
    for i in range(s_count):
        p = prev[i * ln:(i + 1) * ln].clone()
        bits_s.append(diff.diff_pack(cur[i * ln:(i + 1) * ln], p,
                                     tmap[i * ln:(i + 1) * ln], True,
                                     shard_region(i))[0])
        prevs_s.append(p)
    p_solo = prev.clone()
    b_solo = diff.diff_pack_reference(cur, p_solo, tmap, True, region)[0]
    torch.cuda.synchronize()
    _equal_or_raise(f"K10 S={s_count}", (torch.cat(bits_s),
                                         torch.cat(prevs_s)),
                    (b_solo, p_solo), ("bits", "new_prev"))
    cases["k10"] += 1
    log(f"[check] K10-K13 on S={s_count} row shards of 1080p, each with its "
        f"part of a {region.numel()} B region (it spans two shards) and its "
        f"slice of a map, one launch a shard: the shards' outputs == the "
        f"solo frame's plain version, exact")
    # 20 launches of each back to back, on one stream and on two at once
    for streams in (1, 2):
        k10_cases = [(rand(m), rand(m), rand(m)) for m in (
            (n, 17, 1, 1_000_003, 12_345)[i % 5] for i in range(20))]
        cases["k10"] += _back_to_back(
            f"K10 back to back, {streams} stream(s)",
            lambda c, p, t: diff.diff_pack(c, p.clone(), t, True, None, True),
            lambda c, p, t: diff.diff_pack_reference(c, p.clone(), t, True,
                                                     None, True),
            k10_cases, streams, ("bits", "delta"))
        vis_cases = [(rand(m), rand(m), rand(m)) for m in (
            3 * (npx, 17, 1, 333_335, 4_115)[i % 5] for i in range(20))]
        for op, (launch, plain, k) in vis_ops.items():
            cases[k] += _back_to_back(
                f"{op} back to back, {streams} stream(s)",
                lambda c, p, t, _l=launch: (_l(c, p, t, None, 1),),
                lambda c, p, t, _l=plain: (_l(c, p, t, None, 1),),
                vis_cases, streams, ("out",))
        log(f"[check] K10-K13: 20 launches of each back to back on "
            f"{'one stream' if streams == 1 else 'two streams at once, no sync between them'}"
            f" (lengths from 1 B to 1080p; K12 with a map): each == its plain "
            f"version, exact")
    # K9 with the overlay region, read in place of the frame's prefix
    for h, w in ((cfg.height, cfg.width), (271, 1917)):
        m = h * w * 3
        frame = rand(m)
        for rlen in (cell_h * w * 3, cell_h * w * 3 + 6, 1001, 48, m):
            reg = rand(rlen)
            gray, counts = filters.gray_hist(frame, reg)
            got = filters.binarize_pipeline(frame, region=reg)
            torch.cuda.synchronize()
            over = diff.region_frame(frame, reg)
            _equal_or_raise(f"K9 region {h}x{w} {rlen} B", (
                gray, counts, got), (
                filters.gray_pixels(over),
                hist.histogram_reference(filters.gray_pixels(over)),
                filters.binarize_pipeline_reference(frame, reg)),
                ("gray", "hist", "out"))
            cases["k9_region"] += 1
    log(f"[check] K9 gray_hist and binarize_pipeline with the overlay region "
        f"at 1080p and 271x1917 (regions of the strip, the strip + 6 B, "
        f"1,001 B, one run and the whole frame): gray, histogram and output "
        f"== the plain version on the overlaid frame, exact")

    # the steps: --visualizer 1-4, with and without the noise filter
    text = "FPS: 30 BW: 1234 kbps"
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    want = {Visualizer.HEATMAP: "heatmap", Visualizer.RED_BLACK:
            "red_visualizer", Visualizer.RED_OVERLAP: "red_visualizer",
            Visualizer.GRAYSCALE: "grayscale_weighted"}
    for v, counter in want.items():
        for nf in (False, True):
            counters = _zero_launches()
            _check_step(f"--visualizer {v.value}"
                        + (" --noise-filter" if nf else ""),
                        dataclasses.replace(cfg, visualizer=v,
                                            noise_filter=nf),
                        prev_np, cur_np, text)
            got = {k: fn.launches for k, fn in counters.items() if fn.launches}
            expect = {"fused_diff_compact": 1, counter: 1,
                      **({"convolve_q16": 1} if nf else {})}
            if got != expect:
                raise AssertionError(f"--visualizer {v.value} step: "
                                     f"launches {got}, not {expect}")
            cases["steps"] += 1
    log(f"[check] --visualizer 1-4 steps, with and without --noise-filter: "
        f"one launch of K11, K12 (modes 2 and 3) or K13 a step beside K1 "
        f"(and K8 under the filter), no overlaid copy of the frame")
    return cases


def phase_overlay_vs_plain(cfg):
    """K14 (``overlay_blit``, ``overlay_blit_streams``) against its plain
    version on the card, byte for byte, after a synchronize: the 1080p
    strip at B = 1 with 0, 18 and 28 characters, in the stroke and bitmap
    fonts; the whole 1080p frame (rows below the cells); 271x1917 (5,751 B
    a row) on a view 3 B past an aligned start; B = 4 streams of 1080p
    and of 271x1917, each with its own text (18, none, 28, 1 characters),
    against the plain version of each stream; 20 launches back to back on
    one stream and on two at once; every call one launch. Then the
    pipelines' steps at 1080p: ``overlay_blit.launches`` must rise by
    exactly one a step, solo (``DeltaStreamPipeline``, tiled) and batched
    (``BatchedDeltaPipeline``, B = 4), and each step's payload and state
    equal ``step_oracle``'s."""
    from cudavideostream_tpu_torch.models import (
        BatchedDeltaPipeline,
        DeltaStreamPipeline,
    )
    from cudavideostream_tpu_torch.models.pipeline import MAX_OVERLAY_CHARS
    from cudavideostream_tpu_torch.ops import overlay
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.utils import fonts

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 50)
    status, long_ = "FPS: 30 BW: 5 kbps", "FPS: 30 BW: 1234567 kbps OK!"
    texts4 = [status, "", long_, "A"]
    cases = 0

    def rand(m):
        return torch.from_numpy(rng.integers(0, 256, m,
                                             dtype=np.uint8)).to(dev)

    def plain_streams(frames, atlas, texts, rows, w):
        sn = frames.numel() // len(texts)
        return torch.cat([overlay.overlay_blit_reference(
            frames[b * sn:b * sn + rows * w * 3], atlas,
            torch.tensor(fonts.encode_text(t, MAX_OVERLAY_CHARS),
                         dtype=torch.int32, device=dev),
            len(t), rows, w) for b, t in enumerate(texts)])

    def one_launch(label, fn):
        before = overlay.overlay_blit.launches
        got = fn()
        k = overlay.overlay_blit.launches - before
        if k != 1:
            raise AssertionError(f"{label}: {k} launches, not 1")
        return got

    for style in ("stroke", "bitmap"):
        atlas = torch.from_numpy(fonts.make_atlas(cfg.overlay_scale,
                                                  style)).to(dev)
        cell_h = atlas.shape[1]
        for h, w, rows, off in ((cfg.height, cfg.width, cell_h, 0),
                                (cfg.height, cfg.width, cfg.height, 0),
                                (271, 1917, cell_h, 3)):
            for n_chars in (0, 18, 28):
                text = (long_ * 2)[:n_chars]
                ids = torch.tensor(fonts.encode_text(text, MAX_OVERLAY_CHARS),
                                   dtype=torch.int32, device=dev)
                frame = rand(off + rows * w * 3)[off:]
                got = one_launch("K14", lambda: overlay.overlay_blit(
                    frame, atlas, ids, n_chars, rows, w))
                torch.cuda.synchronize()
                want = overlay.overlay_blit_reference(frame, atlas, ids,
                                                      n_chars, rows, w)
                _equal_or_raise(f"K14 {style} {h}x{w} rows {rows} view {off} "
                                f"n_chars {n_chars}", (got,), (want,), ("out",))
                cases += 1
            # B = 4 streams, a text each, in one launch
            sn = h * w * 3
            frames = rand(off + 4 * sn)[off:]
            ids4, n_fit4 = overlay.text_glyphs(
                texts4, MAX_OVERLAY_CHARS, w // atlas.shape[2], dev)
            got = one_launch("K14 B=4", lambda: overlay.overlay_blit_streams(
                frames, atlas, ids4, n_fit4, rows, w, 4))
            torch.cuda.synchronize()
            _equal_or_raise(f"K14 {style} B=4 {h}x{w} rows {rows} view {off}",
                            (got,), (plain_streams(frames, atlas, texts4,
                                                   rows, w),), ("out",))
            cases += 1
    log(f"[check] K14 overlay_blit on the 1080p strip, the whole 1080p frame "
        f"and 271x1917 (5,751 B a row) on a view 3 B past an aligned start, "
        f"with 0, 18 and 28 characters, in the stroke and bitmap fonts, and "
        f"overlay_blit_streams on B = 4 streams of each (18, 0, 28 and 1 "
        f"characters): == overlay_blit_reference, exact; one launch a call "
        f"({cases} cases)")

    atlas = torch.from_numpy(fonts.make_atlas(cfg.overlay_scale,
                                              cfg.overlay_font)).to(dev)
    cell_h = atlas.shape[1]
    strip = cell_h * cfg.width * 3
    for streams in (1, 2):
        calls = []
        for i in range(20):
            text = (texts4 * 2)[i % 8][:28]
            ids = torch.tensor(fonts.encode_text(text, MAX_OVERLAY_CHARS),
                               dtype=torch.int32, device=dev)
            calls.append((rand(strip), ids, len(text)))
        cases += _back_to_back(
            f"K14 back to back, {streams} stream(s)",
            lambda f, i, k: (overlay.overlay_blit(f, atlas, i, k, cell_h,
                                                  cfg.width),),
            lambda f, i, k: (overlay.overlay_blit_reference(
                f, atlas, i, k, cell_h, cfg.width),),
            calls, streams, ("out",))
    log("[check] K14: 20 launches back to back on one stream and on two at "
        "once (texts of 0-28 characters): each == its plain version, exact")

    tcfg = dataclasses.replace(cfg, tiled_payload=True)
    n = cfg.frame_bytes
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    pipe = DeltaStreamPipeline(tcfg)
    state = pipe.init_state(prev_np)
    before = overlay.overlay_blit.launches
    steps = 5
    for _ in range(steps):
        pipe.step(state, cur_np, text=status)
    torch.cuda.synchronize()
    solo = overlay.overlay_blit.launches - before
    _check_step("K14 in the tiled step", tcfg, prev_np, cur_np, status)
    b = 4
    prev4, cur4 = _streams(rng, b, n, 0.06)
    bpipe = BatchedDeltaPipeline(tcfg, b)
    state4 = prev4.clone()
    before = overlay.overlay_blit.launches
    for _ in range(steps):
        out = bpipe.step(state4, cur4, texts4)
    torch.cuda.synchronize()
    batched = overlay.overlay_blit.launches - before
    if (solo, batched) != (steps, steps):
        raise AssertionError(f"K14: {solo} solo and {batched} batched "
                             f"launches in {steps} steps each")
    # the batched step's last state against the oracle, stream by stream
    got_state = state4.cpu().numpy()
    p_np, c_np = prev4.cpu().numpy(), cur4.cpu().numpy()
    for s in range(b):
        e = p_np[s * n:(s + 1) * n]
        for _ in range(steps):
            e = reference_cpu.step_oracle(
                e, c_np[s * n:(s + 1) * n], tcfg, pipe.atlas_np,
                fonts.encode_text(texts4[s]))[0]
        if not np.array_equal(got_state[s * n:(s + 1) * n], e):
            raise AssertionError(f"K14 batched step: stream {s}'s state "
                                 f"after {steps} steps != step_oracle's")
    del out
    cases += 1
    log(f"[check] K14 in the pipelines at 1080p: overlay_blit.launches rose "
        f"by {solo} in {steps} solo steps and by {batched} in {steps} "
        f"batched steps of B = {b} (texts of 18, 0, 28 and 1 characters): "
        f"one launch a step; every stream's state == step_oracle's")
    return cases


def door_map(cfg, rng):
    """A per-pixel ``(H, W)`` threshold map of the kind ``--threshold-map``
    is for: 60 over the noisy scene, 4 in a "door" rectangle, and a few
    pixels at 0 (every change ships) and at 255 (nothing ships)."""
    h, w = cfg.height, cfg.width
    tm = np.full((h, w), 60, np.uint8)
    tm[h // 4: 3 * h // 4, w // 2: w // 2 + w // 6] = 4
    for v in (0, 255):
        tm[rng.integers(0, h, 200), rng.integers(0, w, 200)] = v
    return tm


def byte_map(rng, n):
    """A per-byte map: 0..60 (the frames' noise is up to 15, their jumps
    30..200), with 1% of the bytes at 0 and 1% at 255."""
    tm = rng.integers(0, 60, n, endpoint=True, dtype=np.uint8)
    tm[rng.random(n) < 0.01] = 0
    tm[rng.random(n) < 0.01] = 255
    return tm


def phase_map_vs_plain(cfg):
    """K1 with a per-byte threshold map on every emission against its
    plain version at 1080p and on ragged lengths (with and without the
    overlay region and negative feedback; a map of 0s and 255s only), and
    one 1080p step of each emission with a map against
    ``step_oracle(threshold_map=)``."""
    from cudavideostream_tpu_torch.config import Visualizer
    from cudavideostream_tpu_torch.ops import logcompact

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED + 8)
    region = torch.from_numpy(rng.integers(
        0, 255, 288_000, endpoint=True, dtype=np.uint8)).to(dev)
    flat = ("pos", "xs", "vals", "new_prev")
    tiled = ("pos", "counts", "xs_t", "vals_t", "new_prev")
    lc = logcompact
    emissions = {
        "flat": (lc.fused_diff_compact, lc.fused_diff_compact_reference,
                 {}, flat),
        **{f"tiled subtile={s}": (
            lc.fused_diff_compact_tiled, lc.fused_diff_compact_tiled_reference,
            dict(sub_rows=s), tiled) for s in (1, 8, 0)},
        "tiled+bits subtile=1": (
            lc.fused_diff_compact_tiled, lc.fused_diff_compact_tiled_reference,
            dict(sub_rows=1, emit_bits=True),
            ("pos", "counts", "xs_t", "vals_t", "bits", "new_prev")),
        **{f"mask subtile={s}": (
            lc.fused_diff_compact_mask, lc.fused_diff_compact_mask_reference,
            dict(sub_rows=s),
            ("pos", "counts", "vals_t", "bits", "new_prev"))
           for s in (1, 8, 0)},
    }
    cases = 0
    pcts = []

    def run(name, emission, prev, cur, tm, negfeed, reg):
        nonlocal cases
        fn, ref, kw, labels = emissions[emission]
        p_k, p_p = prev.clone(), prev.clone()
        s_k, s_p = _stores_pair()
        k = fn(cur, p_k, 20, negfeed, reg, threshold_map=tm, prev_stores=s_k,
               **kw)
        torch.cuda.synchronize()
        p = ref(cur, p_p, 20, negfeed, reg, threshold_map=tm,
                prev_stores=s_p, **kw)
        _equal_or_raise(f"{emission} {name}", k + (s_k,), p + (s_p,),
                        labels + ("prev_stores",))
        pcts.append(_stored_pct(s_k, cur.numel()))
        cases += 1
        return int(k[0])

    for density in (0.06, 1.0):
        prev_np, cur_np = frame_pair(rng, n, density)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        tm = torch.from_numpy(byte_map(rng, n)).to(dev)
        for emission in emissions:
            pcts.clear()
            poss = [run(f"map d={density} negfeed={negfeed} overlay="
                        f"{reg is not None}", emission, prev, cur, tm,
                        negfeed, reg)
                    for negfeed in (True, False) for reg in (None, region)]
            log(f"[check] K1 {emission} with a per-byte map, d={density}: "
                f"4 cases (negfeed x overlay) exact, pos "
                f"{min(poss)}..{max(poss)}, {_stored(pcts)}")
    tm = torch.from_numpy(np.where(rng.random(n) < 0.5, 0, 255).astype(
        np.uint8)).to(dev)
    pcts.clear()
    for emission in emissions:
        run("map of 0s and 255s", emission, prev, cur, tm, True, region)
    log(f"[check] K1 with a map of 0s and 255s only, d=1.0, overlay: exact "
        f"on all {len(emissions)} emissions, {_stored(pcts)}")
    for m in (1000, 12_345):
        prev_np, cur_np = frame_pair(rng, m, 0.06)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        tm = torch.from_numpy(byte_map(rng, m)).to(dev)
        pcts.clear()
        for emission in emissions:
            run(f"map n={m}", emission, prev, cur, tm, True, region[:700])
        log(f"[check] K1 with a map, n={m}, overlay=700 B: exact on all "
            f"{len(emissions)} emissions, {_stored(pcts)}")

    text = "FPS: 30 BW: 1234 kbps"
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    tm_np = np.repeat(door_map(cfg, rng).ravel(), 3)
    for label, kw in (
            ("flat", {}),
            ("tiled subtile=1", dict(tiled_payload=True)),
            ("tiled subtile=0", dict(tiled_payload=True, subtile_rows=0)),
            ("tiled+bits", dict(tiled_payload=True, emit_bitmask=True)),
            ("bitmask-only", dict(tiled_payload=True, emit_bitmask=True,
                                  fetch_mode="mask", maskonly_payload=True)),
            ("flat --visualizer 2", dict(visualizer=Visualizer.RED_BLACK)),
            ("bitmask-only --visualizer 3",
             dict(tiled_payload=True, emit_bitmask=True, fetch_mode="mask",
                  maskonly_payload=True,
                  visualizer=Visualizer.RED_OVERLAP))):
        _check_step(f"{label} with the door map", dataclasses.replace(
            cfg, **kw), prev_np, cur_np, text, threshold_map=tm_np)
        cases += 1
    return cases


def phase_schemes_vs_plain(cfg):
    """K5 and K6 against their plain versions at 1080p and on ragged
    lengths; the three schemes through the flat and tiled entry points,
    K5 == K6 == K1 tiled at ``subtile_rows=0`` bit for bit (three
    independent kernels) and flat equal to K1's plain version; K5 with the
    overlay region and a map; K7 on the synthetic scene's gray grid, on
    out-of-range values and on ragged row counts."""
    from cudavideostream_tpu_torch.ops import filters
    from cudavideostream_tpu_torch.ops import hist
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.ops import register_compact
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED + 9)
    region = torch.from_numpy(rng.integers(
        0, 255, 288_000, endpoint=True, dtype=np.uint8)).to(dev)
    cases = {"k5": 0, "k6": 0, "k7": 0}
    blocks = ("counts", "xs_t", "vals_t", "new_prev")
    tiled = ("pos", "counts", "xs_t", "vals_t", "new_prev")
    flat = ("pos", "xs", "vals", "new_prev")

    def against_plain(prev, cur, thr, negfeed, reg=None, tm=None):
        """Each scheme's blocks against its plain version, then the three
        schemes through the tiled and flat entry points."""
        a, b = prev.clone(), prev.clone()
        k = logcompact.segment_compact(cur, a, thr, negfeed, reg, tm)
        torch.cuda.synchronize()
        _equal_or_raise("K5", k, logcompact.segment_compact_reference(
            cur, b, thr, negfeed, reg, tm), blocks)
        cases["k5"] += 1
        schemes = ["element", "segment"]
        if reg is None and tm is None:
            a, b = prev.clone(), prev.clone()
            k = register_compact.register_compact(cur, a, thr, negfeed)
            torch.cuda.synchronize()
            _equal_or_raise("K6", k, register_compact.
                            register_compact_reference(cur, b, thr, negfeed),
                            blocks)
            cases["k6"] += 1
            schemes.append("register")
        outs = {s: logcompact.fused_diff_compact_tiled(
            cur, prev.clone(), thr, negfeed, reg, sub_rows=0,
            threshold_map=tm, scheme=s) for s in schemes}
        for s in schemes[1:]:
            _equal_or_raise(f"{s} == K1 tiled subtile=0", outs[s],
                            outs["element"], tiled)
        want = logcompact.fused_diff_compact_reference(
            cur, prev.clone(), thr, negfeed, reg, threshold_map=tm)
        for s in schemes:
            _equal_or_raise(f"{s} flat == K1's plain version",
                            logcompact.fused_diff_compact(
                                cur, prev.clone(), thr, negfeed, reg,
                                threshold_map=tm, scheme=s), want, flat)
        return int(want[0]), tuple(outs["segment"][2].shape)

    for density in (0.0, 0.06, 1.0):
        prev_np, cur_np = frame_pair(rng, n, density)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        poss = []
        for thr in (0, 20, 255):
            for negfeed in (True, False):
                pos, shape = against_plain(prev, cur, thr, negfeed)
                poss.append(pos)
        log(f"[check] K5 and K6 d={density}: 6 cases (thresholds 0/20/255 x "
            f"negfeed) exact against their plain versions; K5 == K6 == K1 "
            f"tiled subtile=0 bit for bit ({shape[0]} tiles of {shape[1]} "
            f"B); all three flat == K1's plain version; pos "
            f"{min(poss)}..{max(poss)}")
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    prev, cur = (torch.from_numpy(prev_np).to(dev),
                 torch.from_numpy(cur_np).to(dev))
    tm = torch.from_numpy(byte_map(rng, n)).to(dev)
    for negfeed in (True, False):
        for reg, t in ((region, None), (None, tm), (region, tm)):
            against_plain(prev, cur, 20, negfeed, reg, t)
    log("[check] K5 with the overlay region, a per-byte map and both, "
        "negfeed on and off: exact against its plain version; == K1 tiled "
        "subtile=0 and flat == K1's plain version")
    for m in (129, 9000, 12_345, 200_000):
        prev_np, cur_np = frame_pair(rng, m, 0.06)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        against_plain(prev, cur, 20, True)
        against_plain(prev, cur, 20, True, region[:min(m, 700)],
                      torch.from_numpy(byte_map(rng, m)).to(dev))
        n_pad, unit = logcompact.tiled_geometry(m, 0)
        log(f"[check] K5 and K6 n={m} ({n_pad // unit} tile(s) of {unit} B, "
            f"{unit // 128} rows): exact; K5 with overlay and map exact; the "
            f"schemes equal K1")

    # K6's cluster: one CTA's band shipping every byte and its neighbour's
    # none; a unit longer than one round of a CTA (two passes); 20
    # launches back to back
    c_size = register_compact.register_plan(dev)["cluster"]

    def k6(label, cur, prev, thr=20, negfeed=True):
        got = register_compact.register_compact(cur, prev.clone(), thr,
                                                negfeed)
        torch.cuda.synchronize()
        _equal_or_raise(f"K6 {label}", got, register_compact.
                        register_compact_reference(cur, prev.clone(), thr,
                                                   negfeed), blocks)
        cases["k6"] += 1
        return got

    n_pad, unit = logcompact.tiled_geometry(n, 0)
    band = unit // c_size
    prev = torch.from_numpy(frame_pair(rng, n, 0.0)[0]).to(dev)
    at = torch.arange(n, device=dev) % unit
    for label, ships in (("the first CTA's band ships every byte, the next "
                          "none", at < band),
                         ("the first band none, the second every byte",
                          (at >= band) & (at < 2 * band))):
        got = k6(label, torch.where(ships, prev + 128, prev), prev)
        log(f"[check] K6 {label} (clusters of {c_size} CTAs, bands of "
            f"{band} B of {unit}): exact, counts "
            f"{int(got[0].min())}..{int(got[0].max())}")
    # K5's cluster: the same edges, and its first tiles past 64 KB
    k5_size = logcompact.segment_plan(dev)["cluster"]
    n_pad, unit = logcompact.tiled_geometry(n, 0)
    band = unit // k5_size
    for label, ships in (("the first CTA's chunk ships every byte, the "
                          "next none", at < band),
                         ("the first chunk none, the second every byte",
                          (at >= band) & (at < 2 * band))):
        cur = torch.where(ships, prev + 128, prev)
        for tm in (None, torch.full((n,), 20, dtype=torch.uint8,
                                    device=dev)):
            got = logcompact.segment_compact(cur, prev.clone(), 20, True,
                                             None, tm)
            torch.cuda.synchronize()
            _equal_or_raise(f"K5 {label}", got, logcompact.
                            segment_compact_reference(cur, prev.clone(), 20,
                                                      True, None, tm),
                            blocks)
            cases["k5"] += 1
        log(f"[check] K5 {label} (clusters of {k5_size} CTAs, chunks of "
            f"{band} B of {unit}), without and with a map: exact, counts "
            f"{int(got[0].min())}..{int(got[0].max())}")
    m = (1 << 27) + 12_345
    n_pad, unit = logcompact.tiled_geometry(m, 0)
    prev_np, cur_np = frame_pair(rng, m, 0.06)
    cur, prev = (torch.from_numpy(cur_np).to(dev),
                 torch.from_numpy(prev_np).to(dev))
    want = k6(f"n={m}", cur, prev)
    log(f"[check] K6 n={m} ({n_pad // unit} tiles of {unit} B, a band of "
        f"{unit // c_size} B a CTA, longer than one round): exact")
    got = logcompact.segment_compact(cur, prev.clone())
    _equal_or_raise(f"K5 n={m} == K6", got, want, blocks)
    got = [logcompact.fused_diff_compact_tiled(cur, prev.clone(), sub_rows=0,
                                               scheme=s)
           for s in ("segment", "element")]
    _equal_or_raise(f"K5 n={m} == K1 tiled subtile=0", got[0], got[1],
                    tiled)
    cases["k5"] += 1
    log(f"[check] K5 n={m} ({n_pad // unit} tiles of {unit} B, a chunk of "
        f"{unit // k5_size} B a CTA, two rounds: its first tiles past 64 KB)"
        f": == K6 (held against its plain version above) == K1 tiled "
        f"subtile=0, bit for bit")
    del cur, prev, want, got
    torch.cuda.empty_cache()
    for streams in (1, 2):
        pairs = []
        for i in range(20):
            m = (n, 129, 9000, 12_345, 200_000)[i % 5]
            prev_np, cur_np = frame_pair(rng, m, (0.0, 0.06, 1.0)[i % 3])
            p = torch.from_numpy(prev_np).to(dev)
            pairs.append((torch.from_numpy(cur_np).to(dev), p, p.clone()))
        torch.cuda.synchronize()
        cases["k6"] += _back_to_back(
            f"K6 back to back, {streams} stream(s)",
            lambda c, pk, pp: register_compact.register_compact(c, pk),
            lambda c, pk, pp: register_compact.register_compact_reference(
                c, pp), pairs, streams, blocks)
        log(f"[check] K6 register_compact: 20 launches back to back on "
            f"{'one stream' if streams == 1 else 'two streams at once, no sync between them'}"
            f" (n 6220800, 129, 9000, 12345, 200000; densities 0/0.06/1): "
            f"each exact against its plain version")
    # K5 solo, with a map and batched (B = 4, streams not 16-byte aligned
    # at n = 9,233), back to back
    tm = torch.from_numpy(byte_map(rng, n)).to(dev)

    def k5_any(kind, cur, prev, plain=False):
        if kind.startswith("batched"):
            fn = (logcompact.fused_diff_compact_batched_reference if plain
                  else logcompact.fused_diff_compact_batched)
            return fn(cur, prev, 4, scheme="segment")
        fn = (logcompact.segment_compact_reference if plain
              else logcompact.segment_compact)
        return fn(cur, prev, 20, True, None,
                  tm[:cur.numel()].contiguous() if kind == "map" else None)

    for streams in (1, 2):
        cases_b = []
        for i in range(20):
            kind, m = (("solo", n), ("map", n), ("batched", n),
                       ("solo", 12_345), ("batched ragged", 9233))[i % 5]
            b = 4 if kind.startswith("batched") else 1
            prev_np, cur_np = frame_pair(rng, b * m, (0.0, 0.06, 1.0)[i % 3])
            p = torch.from_numpy(prev_np).to(dev)
            cases_b.append((kind, torch.from_numpy(cur_np).to(dev), p,
                            p.clone()))
        torch.cuda.synchronize()
        cases["k5"] += _back_to_back(
            f"K5 back to back, {streams} stream(s)",
            lambda kind, c, pk, pp: k5_any(kind, c, pk),
            lambda kind, c, pk, pp: k5_any(kind, c, pp, plain=True),
            cases_b, streams, tiled)
        log(f"[check] K5 segment_compact: 20 launches back to back on "
            f"{'one stream' if streams == 1 else 'two streams at once, no sync between them'}"
            f" (solo, with a map and batched B=4 at 1080p, solo n=12345, "
            f"batched B=4 n=9233; densities 0/0.06/1): each exact against "
            f"its plain version")

    def probe(label, g2, want=None):
        got = hist.vpu_probe(g2)
        torch.cuda.synchronize()
        _equal_or_raise(f"K7 {label}", (got,),
                        (hist.vpu_probe_reference(g2),), ("checksums",))
        if want is not None and not bool((got == want).all()):
            raise AssertionError(f"K7 {label}: a checksum is not {want}")
        cases["k7"] += 1
        log(f"[check] K7 vpu_probe on {label} ({g2.shape[0]} x 128, "
            f"{got.numel()} tiles of {hist.probe_tile(g2.shape[0])} rows): "
            f"exact, checksums {int(got.min())}..{int(got.max())}")

    src = SyntheticSource(cfg, seed=SEED)
    src.base_frame()
    g = filters.gray_pixels(torch.from_numpy(next(src)).to(dev))
    tile = hist.probe_tile(g.numel() // 128)
    probe("the synthetic scene's gray grid",
          g.to(torch.int32).view(-1, 128), tile * 128)
    probe("values in [-1000, 1000]", torch.from_numpy(rng.integers(
        -1000, 1000, (16_200, 128), endpoint=True).astype(np.int32)).to(dev))
    for rows in (1000, 1001):
        probe(f"{rows} rows of values in [-300, 600]", torch.from_numpy(
            rng.integers(-300, 600, (rows, 128)).astype(np.int32)).to(dev))
    # the plan's edges: one tile of 8, 360 and 480 rows (most of the 264
    # slices empty or a few vectors); 15, 45 and 135 tiles (720p, 1080p and
    # 4K gray: slices across tile ends); tiles of 8 rows, more than one
    # wave of slices holds (307 and 3,001 tiles: two and 12 waves)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows in (8, 360, 480, 7200, 16_200, 64_800, 8 * 307, 8 * 3001):
        g2 = torch.from_numpy(rng.integers(0, 256, (rows, 128)).astype(
            np.int32)).to(dev)
        tiles = rows // hist.probe_tile(rows)
        probe(f"{rows} gray rows, {hist.probe_slices(tiles, sms)} slices",
              g2, hist.probe_tile(rows) * 128)
    for streams in (1, 2):
        grids = [torch.from_numpy(rng.integers(
            -20, 300, ((8, 360, 7200, 16_200, 64_800)[i % 5], 128)).astype(
                np.int32)).to(dev) for i in range(20)]
        torch.cuda.synchronize()
        cases["k7"] += _back_to_back(
            f"K7 back to back, {streams} stream(s)",
            lambda g2: (hist.vpu_probe(g2),),
            lambda g2: (hist.vpu_probe_reference(g2),),
            [(g2,) for g2 in grids], streams, ("checksums",))
        log(f"[check] K7 vpu_probe: 20 launches back to back on "
            f"{'one stream' if streams == 1 else 'two streams at once, no sync between them'}"
            f" (rows 8, 360, 7200, 16200, 64800: the per-stream count of "
            f"finished slices): each exact against its plain version")
    return cases


BATCHED = ("pos", "counts", "xs_t", "vals_t", "new_prev")


def _streams(rng, b, n, density):
    """Flat ``(prev, cur)`` of ``b`` independent ``n``-byte streams on the
    card (``frame_pair`` each)."""
    pairs = [frame_pair(rng, n, density) for _ in range(b)]
    return tuple(torch.from_numpy(np.concatenate(x)).to("cuda")
                 for x in zip(*pairs))


def _check_batched(name, prev, cur, b, sub, tm=None, reg=None,
                   scheme="element", pcts=None):
    """One batched call on the card against its plain version and against
    ``b`` solo tiled calls of the same scheme on the streams' own
    (16-byte aligned) copies, byte for byte: pos, counts, the blocks with
    their zero fill, and new_prev; K1's ``prev_stores`` against its plain
    version's, its share appended to ``pcts``. Returns the per-stream
    pos."""
    from cudavideostream_tpu_torch.ops import logcompact as lc

    n = cur.numel() // b
    strip = 0 if reg is None else reg.numel() // b
    s_k, s_p = (_stores_pair() if scheme == "element" else (None, None))
    got = lc.fused_diff_compact_batched(cur, prev.clone(), b, 20, True,
                                        scheme, tm, sub_rows=sub,
                                        overlay_region=reg, prev_stores=s_k)
    torch.cuda.synchronize()
    want = lc.fused_diff_compact_batched_reference(
        cur, prev.clone(), b, 20, True, scheme, tm, sub_rows=sub,
        overlay_region=reg, prev_stores=s_p)
    if s_k is None:
        _equal_or_raise(name, got, want, BATCHED)
    else:
        _equal_or_raise(name, got + (s_k,), want + (s_p,),
                        BATCHED + ("prev_stores",))
        if pcts is not None:
            pcts.append(_stored_pct(s_k, n, b))
    for s in range(b):
        solo = lc.fused_diff_compact_tiled(
            cur[s * n:(s + 1) * n].clone(), prev[s * n:(s + 1) * n].clone(),
            20, True,
            None if reg is None else reg[s * strip:(s + 1) * strip].clone(),
            sub, threshold_map=tm, scheme=scheme)
        _equal_or_raise(f"{name} stream {s} vs solo", (
            got[0][s], got[1][s], got[2][s], got[3][s],
            got[4][s * n:(s + 1) * n]), solo, BATCHED)
    return [int(p) for p in got[0]]


def phase_batched_vs_plain(cfg):
    """K1 and K5 in their batched mode at 1080p (B = 1, 3, 4, 8) and on the
    JAX package's ragged geometries, against their plain versions and
    against solo launches on each stream; K5 batched == K1 batched at
    ``subtile_rows=0`` bit for bit; ``BatchedDeltaPipeline.step`` at 1080p,
    B = 4, against each stream's ``step_oracle``, aux included."""
    from cudavideostream_tpu_torch.config import Visualizer
    from cudavideostream_tpu_torch.models import BatchedDeltaPipeline
    from cudavideostream_tpu_torch.ops import logcompact as lc
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.runtime import wire
    from cudavideostream_tpu_torch.utils import fonts

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED + 12)
    door = torch.from_numpy(np.repeat(door_map(cfg, rng).ravel(), 3)).to(dev)
    cases = {"k1": 0, "k5": 0, "steps": 0}
    frames = {d: _streams(rng, 8, n, d) for d in (0.0, 0.06, 1.0)}
    strips = torch.from_numpy(rng.integers(
        0, 255, 8 * 288_000, endpoint=True, dtype=np.uint8)).to(dev)
    for b in (1, 3, 4, 8):
        for sub in (1, 8, 0):
            poss, pcts = [], []
            for d, (prev, cur) in frames.items():
                for tm in (None, door):
                    for reg in ((None, strips[:b * 288_000]) if d == 0.06
                                else (None,)):
                        poss += _check_batched(
                            f"K1 batched B={b} sub={sub} d={d} "
                            f"map={tm is not None} overlay={reg is not None}",
                            prev[:b * n], cur[:b * n], b, sub, tm, reg,
                            pcts=pcts)
                        cases["k1"] += 1
            log(f"[check] K1 batched B={b} subtile={sub}: 8 cases (density "
                f"0/0.06/1 x map none/door, and per-stream overlay strips at "
                f"0.06) exact against its plain version and against {b} solo "
                f"K1 tiled launches; pos per stream {min(poss)}..{max(poss)}; "
                f"prev_stores == the plain version's, {_stored(pcts)}")
    for b, m in ((2, 9233), (4, 9233), (2, 128 * 401), (4, 128 * 401),
                 (2, 1000), (4, 1000)):
        prev, cur = _streams(rng, b, m, 0.06)
        tm = torch.from_numpy(byte_map(rng, m)).to(dev)
        reg = torch.from_numpy(rng.integers(0, 255, b * 700, endpoint=True,
                                            dtype=np.uint8)).to(dev)
        pcts = []
        for sub in (1, 8, 0):
            for t, r in ((None, None), (tm, reg)):
                _check_batched(f"K1 batched B={b} n={m} sub={sub}", prev, cur,
                               b, sub, t, r, pcts=pcts)
                cases["k1"] += 1
        log(f"[check] K1 batched B={b} n={m} (a padded geometry"
            f"{'; streams not 16-byte aligned' if m % 16 else ''}), subtile "
            f"1/8/0, with and without a byte map and 700 B overlay strips: "
            f"exact against its plain version and solo launches; "
            f"prev_stores == the plain version's, {_stored(pcts)}")

    for b in (1, 3, 4, 8):
        for d in (0.06, 1.0):
            prev, cur = frames[d][0][:b * n], frames[d][1][:b * n]
            for tm, reg in ((None, None), (door, strips[:b * 288_000])):
                _check_batched(f"K5 batched B={b} d={d}", prev, cur, b, 0,
                               tm, reg, scheme="segment")
                _equal_or_raise(
                    f"K5 batched B={b} d={d} == K1 batched subtile=0",
                    lc.fused_diff_compact_batched(
                        cur, prev.clone(), b, scheme="segment",
                        threshold_map=tm, overlay_region=reg),
                    lc.fused_diff_compact_batched(
                        cur, prev.clone(), b, sub_rows=0, threshold_map=tm,
                        overlay_region=reg), BATCHED)
                cases["k5"] += 1
        log(f"[check] K5 batched B={b}: 4 cases (density 0.06/1 x none / "
            f"door map and overlay strips) exact against its plain version "
            f"and {b} solo K5 launches; == K1 batched subtile=0 bit for bit")
    prev, cur = _streams(rng, 2, 9233, 0.06)
    _check_batched("K5 batched B=2 n=9233", prev, cur, 2, 0, scheme="segment")
    cases["k5"] += 1
    log("[check] K5 batched B=2 n=9233 (ragged): exact")

    tcfg = dataclasses.replace(cfg, tiled_payload=True)
    texts = ["CAM 0 FPS: 30", "CAM 1 FPS: 29", "", "CAM 3 BW: 1234 kbps"]
    b = len(texts)
    for label, vcfg in (
            ("visualizer 0", tcfg),
            ("visualizer 3", dataclasses.replace(
                tcfg, visualizer=Visualizer.RED_OVERLAP)),
            ("visualizer 5", dataclasses.replace(
                tcfg, visualizer=Visualizer.BINARIZE)),
            ("--noise-filter", dataclasses.replace(tcfg, noise_filter=True))):
        pipe = BatchedDeltaPipeline(vcfg, b)
        states = [frame_pair(rng, n, 0.06)[0] for _ in range(b)]
        prev = pipe.init_state(np.stack(states))
        cur_np = states
        poss = []
        counters = _zero_launches()
        for _ in range(3):
            cur_np = [drift(rng, c, 0.06) for c in cur_np]
            out = pipe.step(prev, np.stack(cur_np), texts)
            prev = out[0]
            got_prev = prev.cpu().numpy().reshape(b, n)
            aux = None if out[-1] is None else out[-1].cpu().numpy()
            for s in range(b):
                e_prev, e_pos, e_xs, e_vals, e_aux = reference_cpu.step_oracle(
                    states[s], cur_np[s], vcfg, atlas=pipe.atlas_np,
                    char_ids=fonts.encode_text(texts[s]))
                xs, vals = wire.TiledPayload(
                    int(out[1][s]), out[2][s].cpu().numpy(),
                    out[3][s].cpu().numpy(), out[4][s].cpu().numpy()).to_flat()
                ok = (int(out[1][s]) == e_pos and np.array_equal(xs, e_xs)
                      and np.array_equal(vals, e_vals)
                      and np.array_equal(got_prev[s], e_prev)
                      and (aux is None if e_aux is None else aux is not None
                           and np.array_equal(aux[s * n:(s + 1) * n], e_aux)))
                if not ok:
                    raise AssertionError(f"batched step {label}: stream {s} "
                                         "differs from step_oracle")
                states[s] = e_prev
                poss.append(e_pos)
            cases["steps"] += 1
        # K8, K9 and K12 once a batched frame (every stream in one launch)
        want = {"convolve_q16": 3 if vcfg.noise_filter else 0,
                "binarize_pipeline":
                    3 if vcfg.visualizer == Visualizer.BINARIZE else 0,
                "gray_hist": 0, "binarize_apply": 0, "histogram": 0,
                "red_visualizer":
                    3 if vcfg.visualizer == Visualizer.RED_OVERLAP else 0}
        got = {name: counters[name].launches for name in want}
        if got != want:
            raise AssertionError(f"batched step {label}: launches {got}, "
                                 f"not {want}")
        log(f"[check] batched step {label}: BatchedDeltaPipeline.step at "
            f"1080p, B={b}, four overlay texts, 3 frames: every stream == its "
            f"step_oracle (aux {'equal' if aux is not None else 'none'}); pos "
            f"{min(poss)}..{max(poss)}; launches "
            + ", ".join(f"{k}={v}" for k, v in got.items()))
    return cases


def phase_crosscheck_path(cfg):
    """The path K5, K6 and K7 serve in the JAX package: its scheme
    cross-check (``tests/test_device_ops.py:284-360``,
    ``benchmarks/kernels.py``) and its probe
    (``benchmarks/binarize_pallas_ab``), through the public entry points at
    1080p on the synthetic scene. The three schemes must give the same
    bytes, flat and tiled, and the probe one checksum per tile equal to
    its element count. Returns this run's launches, counted from 0."""
    from cudavideostream_tpu_torch.ops import filters
    from cudavideostream_tpu_torch.ops import hist
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    dev = torch.device("cuda")
    src = SyntheticSource(cfg, seed=SEED)
    prev = torch.from_numpy(src.base_frame()).to(dev)
    cur = torch.from_numpy(next(src)).to(dev)
    g2 = filters.gray_pixels(cur).to(torch.int32).view(-1, 128)
    counters = _zero_launches()
    flat = {s: logcompact.fused_diff_compact(cur, prev.clone(), scheme=s)
            for s in logcompact.SCHEMES}
    tiled = {s: logcompact.fused_diff_compact_tiled(cur, prev.clone(),
                                                    scheme=s)
             for s in logcompact.SCHEMES}
    # the batched mode on two streams: this frame, and the next one
    # against it
    cur_b = torch.cat([cur, torch.from_numpy(next(src)).to(dev)])
    prev_b = torch.cat([prev, cur])
    seg0 = logcompact.segment_compact.launches
    batched = {s: logcompact.fused_diff_compact_batched(cur_b, prev_b.clone(),
                                                        2, scheme=s)
               for s in ("element", "segment")}
    k5_batched = logcompact.segment_compact.launches - seg0
    sums = hist.vpu_probe(g2)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for s in ("segment", "register"):
        _equal_or_raise(f"cross-check {s} flat", flat[s], flat["element"])
        _equal_or_raise(f"cross-check {s} tiled", tiled[s], tiled["element"],
                        BATCHED)
    _equal_or_raise("cross-check segment batched", batched["segment"],
                    batched["element"], BATCHED)
    _equal_or_raise("cross-check batched stream 0 == solo", [
        t[0] for t in batched["element"][:4]] + [
        batched["element"][4][:cur.numel()]], tiled["element"], BATCHED)
    tile = hist.probe_tile(g2.shape[0])
    if not bool((sums == tile * 128).all()):
        raise AssertionError("K7: a checksum differs from its tile's count")
    log(f"[serve] cross-check path: the element, segment and register "
        f"schemes give the same bytes flat and tiled on a 1080p synthetic "
        f"frame (pos={int(flat['element'][0])}), and element and segment "
        f"batched on two streams; K7 {sums.numel()} "
        f"checksums of {tile * 128}; kernel launches: "
        + ", ".join(f"{k}={v}" for k, v in launches.items()))
    return {"frames": 1, "launches": launches,
            "k5_batched_launches": k5_batched}


def _host_state(state):
    """A copy of an executor's device state on the host: one tensor, or
    the sharded pipeline's shards (a list over ``space``, or its ``(data,
    space)`` grid), in the global layout."""
    if isinstance(state, torch.Tensor):
        return state.to("cpu", copy=True).numpy()
    from cudavideostream_tpu_torch.parallel.sharded import gather

    return gather(state)


class _RecordingExecutor:
    """The server's executor, plus a digest of the device state and the
    overlay text after every frame (the server calls start, process,
    flush, resync and metrics), and each landed frame's aux frame: the
    first ``n_aux`` kept with the inputs that made them. A pipelined
    executor's payloads lag a frame, but the client decodes them in order,
    so its k-th state is still the k-th digest here."""

    def __init__(self, inner, n_aux=5):
        self.inner = inner
        self.texts, self.digests, self.process_s = [], [], []
        self.n_aux = n_aux
        self.inputs, self.auxes = [], []  # (state before, frame, text)
        self.landed = self.aux_landed = 0

    @property
    def metrics(self):
        return self.inner.metrics

    def start(self, base):
        return self.inner.start(base)

    def process(self, frame, text=""):
        if len(self.inputs) < self.n_aux:
            state = _host_state(self.inner._state)
            self.inputs.append((state, np.array(frame, copy=True), text))
        t0 = time.perf_counter()
        out = self.inner.process(frame, text=text)
        self.process_s.append(time.perf_counter() - t0)
        self.texts.append(text)
        state = _host_state(self.inner._state)
        self.digests.append(hashlib.sha256(state).hexdigest())
        self._keep(out)
        return out

    def _keep(self, out):
        for res in out if isinstance(out, list) else [out]:
            if res is None:
                continue
            self.landed += 1
            if res[3] is not None:
                self.aux_landed += 1
                if len(self.auxes) < self.n_aux:
                    self.auxes.append(res[3])

    def flush(self):
        out = self.inner.flush()
        self._keep(out)
        return out

    def resync(self):
        return self.inner.resync()


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


def _launch_counters():
    from cudavideostream_tpu_torch.ops import convolve
    from cudavideostream_tpu_torch.ops import diff
    from cudavideostream_tpu_torch.ops import filters
    from cudavideostream_tpu_torch.ops import hist
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.ops import register_compact

    return {"fused_diff_compact": logcompact.fused_diff_compact,
            "fused_diff_compact_tiled": logcompact.fused_diff_compact_tiled,
            "fused_diff_compact_mask": logcompact.fused_diff_compact_mask,
            "fused_diff_compact_batched":
                logcompact.fused_diff_compact_batched,
            "pair_compact": logcompact.pair_compact,
            "vals_compact": logcompact.vals_compact,
            "histogram": hist.histogram,
            "segment_compact": logcompact.segment_compact,
            "register_compact": register_compact.register_compact,
            "vpu_probe": hist.vpu_probe,
            "convolve_q16": convolve.convolve_q16,
            "binarize_pipeline": filters.binarize_pipeline,
            "gray_hist": filters.gray_hist,
            "binarize_apply": filters.binarize_apply,
            "diff_pack": diff.diff_pack,
            "heatmap": filters.heatmap,
            "red_visualizer": filters.red_visualizer,
            "grayscale_average": filters.grayscale_average,
            "grayscale_weighted": filters.grayscale_weighted}


def _zero_launches():
    """Set every kernel's launch count to 0; returns the counters."""
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def phase_serving(cfg, label, pipelined=False, land_batch=0, inner=None):
    """Serve 1080p frames over TCP on one path; returns the frames served,
    the frames that changed some byte, every kernel's launches in that
    run and the landing flavors. On a visualizer path every landed frame
    must bring its aux frame, the first 5 equal to the NumPy spec's (with
    the pipeline's threshold map, if any). ``inner``: the executor, as the
    server's command line built it; by default one is built here."""
    from cudavideostream_tpu_torch.config import Visualizer
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
    from cudavideostream_tpu_torch.runtime.executor import (
        BatchedLandExecutor,
        PipelinedExecutor,
        StreamExecutor,
    )
    from cudavideostream_tpu_torch.runtime.server import DeltaStreamServer
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource
    from cudavideostream_tpu_torch.utils import fonts

    cfg = dataclasses.replace(cfg, port=0)
    if inner is None and land_batch:
        inner = BatchedLandExecutor(cfg, depth=land_batch)
    elif inner is None:
        inner = (PipelinedExecutor if pipelined else StreamExecutor)(cfg)
    rec = _RecordingExecutor(inner)
    source = _UntilTextsChanged(SyntheticSource(cfg, seed=SEED), rec)
    server = DeltaStreamServer(cfg, source, executor=rec, verbose=False)
    server.listen()
    errors = []

    def serve():
        try:
            server.serve(max_frames=None)
        except BaseException as e:
            errors.append(e)

    counters = _zero_launches()  # counts of this path's run only
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
    launches = {name: fn.launches for name, fn in counters.items()}
    if th.is_alive():
        raise RuntimeError(f"{label}: server thread did not finish")
    if errors:
        raise errors[0]
    frames = len(rec.texts)
    if frames < source.min_frames or len(set(rec.texts)) < 3:
        raise AssertionError(f"{label}: served {frames} frames with "
                             f"{len(set(rec.texts))} overlay texts")
    if cli.wire_format != cfg.wire_format:
        raise AssertionError(f"{label}: client decoded wire "
                             f"{cli.wire_format}, server sent "
                             f"{cfg.wire_format}")
    if digests != rec.digests:
        bad = next(i for i, (a, b) in enumerate(zip(digests, rec.digests))
                   if a != b) if len(digests) == len(rec.digests) else None
        raise AssertionError(f"{label}: client reconstruction != server "
                             f"state (client {len(digests)} frames, server "
                             f"{frames}, first mismatch {bad})")
    if rec.landed != frames:
        raise AssertionError(f"{label}: {rec.landed} results landed for "
                             f"{frames} frames")
    if cfg.visualizer == Visualizer.NONE:
        if rec.aux_landed:
            raise AssertionError(f"{label}: an aux frame without a "
                                 "visualizer")
    else:
        if rec.aux_landed != frames:
            raise AssertionError(f"{label}: {rec.aux_landed} aux frames "
                                 f"landed for {frames} frames")
        atlas = inner.pipe.atlas_np
        for k, ((prev_np, frame_np, text), aux) in enumerate(
                zip(rec.inputs, rec.auxes)):
            want = reference_cpu.step_oracle(
                prev_np, frame_np, cfg, atlas=atlas,
                char_ids=fonts.encode_text(text),
                threshold_map=inner.pipe.threshold_map_np)[4]
            if not (aux.dtype == np.uint8 and np.array_equal(aux, want)):
                raise AssertionError(f"{label}: landed aux frame {k} "
                                     "differs from step_oracle's")
        log(f"[serve] {label}: an aux frame landed with each of the "
            f"{frames} frames; the first {len(rec.auxes)} equal "
            f"step_oracle's, byte for byte")
    tmap = inner.pipe.threshold_map_np
    if tmap is not None:
        # the served states follow the map: the first frames' states equal
        # the NumPy spec's with it, and some differ from the scalar's
        moved = 0
        for k, (prev_np, frame_np, text) in enumerate(rec.inputs):
            kw = dict(atlas=inner.pipe.atlas_np,
                      char_ids=fonts.encode_text(text))
            want = reference_cpu.step_oracle(prev_np, frame_np, cfg,
                                             threshold_map=tmap, **kw)[0]
            if hashlib.sha256(want).hexdigest() != rec.digests[k]:
                raise AssertionError(f"{label}: served state {k} differs "
                                     "from step_oracle's with the map")
            scalar = reference_cpu.step_oracle(prev_np, frame_np, cfg,
                                               **kw)[0]
            moved += not np.array_equal(want, scalar)
        if not moved:
            raise AssertionError(f"{label}: the map changed none of the "
                                 f"first {len(rec.inputs)} states")
        log(f"[serve] {label}: the first {len(rec.inputs)} served states "
            f"equal step_oracle(threshold_map=)'s, byte for byte; {moved} "
            f"of them differ from the scalar threshold's")
    log(f"[serve] {label}: {frames} frames at 1080p over TCP, byte-exact "
        f"every frame; overlay texts {len(set(rec.texts))}; mean pos "
        f"{statistics.mean(positions):.0f}; {frames / wall:.2f} fps wall "
        f"(includes the numpy source and the per-frame state digests)")
    per_frame = wall / frames
    src_ms = statistics.median(source.next_s) * 1e3
    proc_ms = statistics.median(rec.process_s) * 1e3
    log(f"[serve] {label}: per frame, medians on the host clock: source "
        f"{src_ms:.2f} ms, executor.process {proc_ms:.2f} ms; the rest of "
        f"the {per_frame * 1e3:.2f} ms mean wall per frame is wire packing, "
        f"the socket, the client's scatter and both digests, all in this "
        f"one process")
    log(f"[serve] {label}: kernel launches: "
        + ", ".join(f"{k}={v}" for k, v in launches.items())
        + (f"; landings {inner.fetch_counts}" if inner.fetch_counts else ""))
    return {"frames": frames, "launches": launches,
            "nonempty": sum(p > 0 for p in positions),
            "fetch_counts": dict(inner.fetch_counts), "fps": frames / wall}


class _RecordingBatchedPipe:
    """The multi-stream server's pipeline, plus a digest of each stream's
    state and its overlay text at every step, and the first step's
    inputs."""

    def __init__(self, inner):
        self.inner = inner
        self.digests, self.texts, self.first = [], [], None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self, prev, frames, texts):
        b_count = len(frames)
        if self.first is None:
            self.first = (_host_state(prev).reshape(b_count, -1),
                          np.array(frames), list(texts))
        out = self.inner.step(prev, frames, texts)
        self.texts.append(list(texts))
        state = _host_state(out[0]).reshape(b_count, -1)
        self.digests.append([hashlib.sha256(x).hexdigest() for x in state])
        return out


def _wait_until(cond, what, timeout=60.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise RuntimeError(f"timed out waiting for {what}")
        threading.Event().wait(0.005)


def _digest_reader(cli, digests, after=None, n_after=0):
    """Decode frames until the server closes, one digest per frame; set
    ``after`` once ``n_after`` frames are in."""
    try:
        while True:
            digests.append(hashlib.sha256(cli.read_frame()[1]).hexdigest())
            if after is not None and len(digests) == n_after:
                after.set()
    except ConnectionError:
        pass
    finally:
        cli.close()


def _ppm_bgr(path, height, width):
    """The BGR bytes of a PPM that ``write_ppm`` wrote."""
    with open(path, "rb") as f:
        data = f.read()
    rgb = np.frombuffer(data[-height * width * 3:], np.uint8)
    return rgb.reshape(height, width, 3)[:, :, ::-1].ravel()


def phase_multiserve(cfg, label, n_frames=16, aux=False, mesh=None):
    """The multi-stream server at 1080p, 4 streams, each with a loopback
    client admitted at the first frame: every stream's reconstruction must
    equal its server state every frame, and the batched kernel must run
    once per batched frame. With ``aux``, frame 0's aux frames, dumped to
    ``--aux-dir`` as PPMs, must equal each stream's ``step_oracle``
    aux. With ``mesh``, the sharded pipeline serves (``--mesh``)."""
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
    from cudavideostream_tpu_torch.runtime.multiserve import MultiStreamServer
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource
    from cudavideostream_tpu_torch.utils import fonts

    b_count = 4
    cfg = dataclasses.replace(cfg, port=0)
    with tempfile.TemporaryDirectory() as tmp:
        server = MultiStreamServer(
            cfg, [SyntheticSource(cfg, seed=SEED + b) for b in range(b_count)],
            verbose=False, aux_dir=tmp if aux else None, mesh=mesh)
        rec = server.pipe = _RecordingBatchedPipe(server.pipe)
        server.listen()
        digests = [[] for _ in range(b_count)]
        readers = []
        for b, port in enumerate(server.ports):
            cli = DeltaStreamClient("127.0.0.1", port, cfg.height, cfg.width)
            readers.append(threading.Thread(
                target=lambda c=cli, d=digests[b]: (c.connect(),
                                                   _digest_reader(c, d)),
                daemon=True))
            readers[-1].start()
        # every stream's client is queued before the first frame
        _wait_until(lambda: all(q.qsize() for q in server._pending),
                    f"{label}: the clients to connect")
        errors = []

        def serve():
            try:
                server.serve(max_frames=n_frames)
            except BaseException as e:
                errors.append(e)

        counters = _zero_launches()  # counts of this path's run only
        t0 = time.perf_counter()
        th = threading.Thread(target=serve, name="smoke-multiserve",
                              daemon=True)
        th.start()
        th.join(timeout=300)
        for r in readers:
            r.join(timeout=60)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        if th.is_alive() or any(r.is_alive() for r in readers):
            raise RuntimeError(f"{label}: the server or a client did not "
                               "finish")
        if errors:
            raise errors[0]
        for b in range(b_count):
            if digests[b] != [d[b] for d in rec.digests]:
                raise AssertionError(f"{label}: stream {b}'s client "
                                     "reconstruction != its server state")
        if aux:
            states, frames, texts = rec.first
            n = cfg.frame_bytes
            for b in range(b_count):
                want = reference_cpu.step_oracle(
                    states[b], frames[b], cfg, atlas=rec.atlas_np,
                    char_ids=fonts.encode_text(texts[b]))[4]
                got = _ppm_bgr(os.path.join(tmp, f"aux_{b}_000000.ppm"),
                               cfg.height, cfg.width)
                if got.size != n or not np.array_equal(got, want):
                    raise AssertionError(f"{label}: stream {b}'s dumped aux "
                                         "frame differs from step_oracle's")
            log(f"[serve] multiserve {label}: frame 0's aux frames, dumped as "
                f"aux_<b>_000000.ppm, equal step_oracle's for all "
                f"{b_count} streams")
    frames = len(rec.digests)
    if frames != n_frames:
        raise AssertionError(f"{label}: served {frames} of {n_frames} frames")
    for b in range(b_count):
        log(f"[serve] multiserve {label} stream {b}: {frames} frames at 1080p "
            f"over TCP, byte-exact every frame")
    log(f"[serve] multiserve {label}: {b_count} x {frames} frames in "
        f"{wall:.2f} s wall, {frames / wall:.2f} batched frames/s "
        f"({b_count * frames / wall:.2f} stream frames/s; includes the numpy "
        f"sources, the clients and the per-frame state digests in this one "
        f"process); landings {server.fetch_counts}; kernel launches: "
        + ", ".join(f"{k}={v}" for k, v in launches.items()))
    return {"frames": frames, "launches": launches,
            "fetch_counts": dict(server.fetch_counts), "fps": frames / wall}


class _GatedSource:
    """SyntheticSource for ``n_frames`` frames, waiting before frame
    ``gate_at`` until ``gate`` is set."""

    def __init__(self, inner, n_frames, gate_at, gate):
        self.inner, self.n_frames = inner, n_frames
        self.gate_at, self.gate = gate_at, gate
        self.served = 0

    def base_frame(self):
        return self.inner.base_frame()

    def __next__(self):
        if self.served >= self.n_frames:
            raise StopIteration
        if self.served == self.gate_at and not self.gate.wait(60):
            raise RuntimeError("the late client never arrived")
        self.served += 1
        return next(self.inner)


def phase_broadcast_replay(cfg, n_frames=24):
    """The broadcast server at 1080p, wire v3: a client and a raw recorder
    from the first frame, a second client joining late; both clients must
    equal the server's state every frame they see. Then the recorded
    session is replayed (``ReplayServer``) to a raw reader, which must get
    the recorded bytes, and to a client, which must decode every state."""
    from cudavideostream_tpu_torch.runtime.broadcast import BroadcastServer
    from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient
    from cudavideostream_tpu_torch.runtime.executor import StreamExecutor
    from cudavideostream_tpu_torch.runtime.replay import ReplayServer
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    cfg = dataclasses.replace(cfg, port=0, wire_format="v3")
    rec = _RecordingExecutor(StreamExecutor(cfg))
    gate = threading.Event()
    server = BroadcastServer(cfg, _GatedSource(
        SyntheticSource(cfg, seed=SEED), n_frames, n_frames // 2, gate),
        executor=rec, verbose=False)
    server.listen()
    early, late, raw = [], [], bytearray()
    five = threading.Event()

    def record():
        with socket.create_connection(("127.0.0.1", server.port)) as sock:
            sock.settimeout(120)
            while True:
                chunk = sock.recv(1 << 20)
                if not chunk:
                    return
                raw.extend(chunk)

    cli = DeltaStreamClient("127.0.0.1", server.port, cfg.height, cfg.width)
    threads = [threading.Thread(target=record, daemon=True),
               threading.Thread(target=lambda: (cli.connect(), _digest_reader(
                   cli, early, five, 5)), daemon=True)]
    for t in threads:
        t.start()
    _wait_until(lambda: server._pending.qsize() == 2,
                "broadcast: the first clients to connect")
    errors = []

    def serve():
        try:
            server.serve(max_frames=n_frames)
        except BaseException as e:
            errors.append(e)

    counters = _zero_launches()
    th = threading.Thread(target=serve, name="smoke-broadcast", daemon=True)
    th.start()
    if not five.wait(120):
        raise RuntimeError("broadcast: the first client got no 5 frames")
    cli2 = DeltaStreamClient("127.0.0.1", server.port, cfg.height, cfg.width)
    base2 = []

    def late_reader():
        cli2.connect()
        base2.append(hashlib.sha256(cli2.frame).hexdigest())
        _digest_reader(cli2, late)

    threads.append(threading.Thread(target=late_reader, daemon=True))
    threads[-1].start()
    _wait_until(lambda: server._pending.qsize() == 1 or server.n_clients == 3,
                "broadcast: the late client to connect")
    gate.set()
    th.join(timeout=300)
    for t in threads:
        t.join(timeout=60)
    launches = {name: fn.launches for name, fn in counters.items()}
    if th.is_alive() or any(t.is_alive() for t in threads):
        raise RuntimeError("broadcast: the server or a client did not finish")
    if errors:
        raise errors[0]
    want = rec.digests
    if len(want) != n_frames or early != want:
        raise AssertionError("broadcast: the first client's reconstruction "
                             "!= the server state")
    j = want.index(base2[0]) + 1 if base2 and base2[0] in want else None
    if j is None or j < 5 or late != want[j:]:
        raise AssertionError(f"broadcast: the late client (joined before "
                             f"frame {j}) != the server state")
    log(f"[serve] broadcast --wire v3: {n_frames} frames at 1080p; the first "
        f"client byte-exact every frame, the late one joined before frame "
        f"{j} with the current state and byte-exact every frame after; "
        f"{len(raw)} B recorded by a raw reader; kernel launches: "
        + ", ".join(f"{k}={v}" for k, v in launches.items()))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session.cvs")
        with open(path, "wb") as f:
            f.write(raw)
        replay = ReplayServer(path, cfg.frame_bytes, port=0, verbose=False)
        replay.listen()
        got, decoded = bytearray(), []
        th = threading.Thread(target=replay.serve, kwargs={"max_clients": 2},
                              daemon=True)
        th.start()
        with socket.create_connection(("127.0.0.1", replay.port)) as sock:
            sock.settimeout(120)
            while chunk := sock.recv(1 << 20):
                got.extend(chunk)
        cli3 = DeltaStreamClient("127.0.0.1", replay.port, cfg.height,
                                 cfg.width)
        cli3.connect()
        _digest_reader(cli3, decoded)
        th.join(timeout=60)
        n_marks = len(replay.marks)
        replay.close()
    if bytes(got) != bytes(raw) or decoded != want or n_marks != n_frames:
        raise AssertionError("replay: the replayed session differs from the "
                             "recorded one")
    log(f"[serve] replay: the recorded broadcast session ({n_marks} v3 "
        f"frames, {len(raw)} B) replayed byte-identical to a raw reader, and "
        f"decoded by a client to the server's {n_frames} states")
    return {"frames": n_frames, "launches": launches}


def _expect_launches(run, label, want):
    """Fail unless each kernel launched as often as ``want`` says."""
    for name, n in want.items():
        if run["launches"][name] != n:
            raise AssertionError(
                f"{label}: {name} launched {run['launches'][name]} times, "
                f"expected {n} for {run['frames']} frames")


def _event_median_ms(fn, iters, backlog=True):
    """Median device time of ``fn(i)`` over ``iters`` calls, from one
    CUDA event pair per call. With ``backlog`` the queue is held behind a
    sleep kernel first, so each pair times the device work alone and not
    the host's launch overhead, as long as the sleep outlasts the host's
    enqueueing of all ``iters`` calls and the launch queue holds them: a
    function of tens of small launches is timed over fewer calls."""
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


def _profile_ms(fn, names, label, per_call=False, kernels_per_call=1,
                kernel_ms=None):
    """Device time per launch of each named kernel (a template's
    instantiations included) over 20 calls of ``fn(i)``, from a
    torch.profiler trace, logged and, where ``kernel_ms`` is a dict, put
    in it by name. With ``per_call``, also the kernels launched per call,
    all names counted (copies and memsets apart), which is returned.

    The profiler on the card now and then loses launch records: one of
    20, or a whole trace, and now and then several traces in a row. So the
    trace's window is padded on the host on both sides (the card's
    timestamps stray a few ms from the host's), a trace that holds fewer
    records than ``kernels_per_call`` a call and no kernel but the named
    ones is taken again, at
    most five times in all, and one with more is never retaken. The count
    per call also comes from a CUDA graph capture of three calls
    (:func:`_graph_per_call`), which sees every kernel the call enqueues
    and loses none: a trace that holds every call's records must agree
    with it, and when every trace lost records the capture's count is the
    one returned."""
    from torch.profiler import ProfilerActivity, profile

    def ours(key):
        return any(f"::{n}(" in key or f"::{n}<" in key for n in names)

    for attempt in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for i in range(20):
                fn(i)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = prof.key_averages()
        kernels = {e.key: e.count for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith(("Memcpy", "Memset"))}
        recorded = sum(kernels.values())
        if (not per_call or recorded >= 20 * kernels_per_call or attempt == 4
                or not all(ours(k) for k in kernels)):
            break
        log(f"[trace] {label}: the profiler recorded {recorded} kernel "
            f"launch(es) of 20 calls: traced again")
    passes = {name: e.device_time_total / e.count / 1e3
              for e in events for name in names
              if f"::{name}(" in e.key or f"::{name}<" in e.key}
    for name, ms in passes.items():
        log(f"[trace] {label} {name}: {ms:.4f} ms per launch (profiler)")
    if kernel_ms is not None:
        kernel_ms.update(passes)
    if len(passes) != len(names):
        log(f"[trace] {label}: the profiler saw no device time for "
            f"{sorted(set(names) - set(passes))}: not measured")
    if not per_call:
        return None
    graph = _graph_per_call(fn, names, label)
    if recorded < 20 * kernels_per_call and all(ours(k) for k in kernels):
        log(f"[trace] {label}: the profiler kept {recorded} of 20 calls' "
            f"records in {attempt + 1} traces: the graph capture's "
            f"{graph:g} kernel(s) per call stands")
        return graph
    per = recorded / 20
    log(f"[trace] {label}: {per:g} kernel launch(es) per call over 20 calls "
        f"(profiler: " + "; ".join(f"{_kernel_name(k)} x{c}"
                                  for k, c in kernels.items()) + ")")
    if per != graph:
        raise AssertionError(f"{label}: the profiler counts {per:g} kernels "
                             f"a call, the graph capture {graph:g}")
    return per


def _graph_per_call(fn, names, label, calls=3):
    """Kernels enqueued per call of ``fn(i)``: the kernel nodes of a CUDA
    graph captured over ``calls`` calls on a side stream (after one call
    there, so the stream's scratch exists), read with the driver's
    ``cuGraphGetNodes``; the graph is never launched. Each kernel node's
    name is read where the driver can (``cuFuncGetName`` or
    ``cuKernelGetName``) and must then hold one of ``names``. A memset
    node fails the call: a one-launch kernel zeroes nothing apart."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        for i in range(calls):
            fn(i)
    kinds, kernel_names = _graph_nodes(graph)
    graph.reset()
    total = sum(kinds.values())
    kernels = kinds.get(0, 0)
    per = kernels / calls
    known = [k for k in kernel_names if k is not None]
    memsets = kinds.get(2, 0)  # CU_GRAPH_NODE_TYPE_MEMSET
    log(f"[trace] {label}: {per:g} kernel(s) per call in a graph capture "
        f"of {calls} calls ({total} nodes: {kernels} kernel, "
        f"{memsets} memset, {total - kernels - memsets} other; names "
        + (", ".join(sorted(set(_demangled_tail(k, names) for k in known)))
           if known else "not read") + ")")
    if memsets:
        raise AssertionError(f"{label}: the graph capture holds {memsets} "
                             f"memset node(s)")
    strays = [k for k in known if not any(n in k for n in names)]
    if strays:
        raise AssertionError(f"{label}: the graph capture holds kernels "
                             f"other than {names}: {sorted(set(strays))}")
    return per


def _graph_nodes(graph):
    """The nodes of a kept CUDA graph (``keep_graph=True``), read with
    the CUDA driver API's ``cuGraphGetNodes``: their count by node type
    (``CUgraphNodeType``: 0 kernel, 2 memset) and each kernel node's
    mangled name, None where the CUDA driver cannot say."""
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _cu_ok(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _cu_ok(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)),
           "cuGraphGetNodes")
    kinds, kernel_names = {}, []
    for node in nodes:
        kind = ctypes.c_int()
        _cu_ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)), "cuGraphNodeGetType")
        kinds[kind.value] = kinds.get(kind.value, 0) + 1
        if kind.value == 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            kernel_names.append(_kernel_node_name(cu, node))
    return kinds, kernel_names


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (CUDA 12): func, grid and block
    dims, shared bytes, params, extra, kern, ctx."""
    _fields_ = [("func", ctypes.c_void_p),
                ("dims", ctypes.c_uint * 7),
                ("params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


def _kernel_node_name(cu, node):
    """The mangled name of a kernel node's function, or None where this
    driver cannot say."""
    get = getattr(cu, "cuGraphKernelNodeGetParams_v2", None)
    if get is None:
        return None
    params = _KernelNodeParams()
    if get(ctypes.c_void_p(node), ctypes.byref(params)) != 0:
        return None
    name = ctypes.c_char_p()
    if params.func and hasattr(cu, "cuFuncGetName"):
        rc = cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func))
    elif params.kern and hasattr(cu, "cuKernelGetName"):
        rc = cu.cuKernelGetName(ctypes.byref(name),
                                ctypes.c_void_p(params.kern))
    else:
        return None
    return name.value.decode() if rc == 0 and name.value else None


def _demangled_tail(mangled, names):
    """The first of ``names`` a mangled kernel name holds, or the name."""
    return next((n for n in names if n in mangled), mangled)


def _cu_ok(rc, fn):
    if rc != 0:
        raise RuntimeError(f"{fn} returned CUresult {rc}")


def _one_per_call(per_call):
    """Fail unless each redesigned kernel launched one kernel a call."""
    for label, per in per_call.items():
        if per != 1:
            raise AssertionError(f"{label}: {per} launches a call in the "
                                 f"trace, not 1")


def _kernel_name(key):
    """A profiler key's kernel name, without namespace, return type or
    arguments: ``void (anonymous namespace)::k<true, false>(int*)`` ->
    ``k<true, false>``."""
    head = key.replace("(anonymous namespace)::", "").split("(")[0].strip()
    if head.startswith("void "):
        head = head[len("void "):]
    return head.split("::")[-1] or key


def phase_times(cfg):
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.ops import overlay as overlay_ops
    from cudavideostream_tpu_torch.runtime.executor import (
        StreamExecutor,
        _Staged,
    )
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
    # the floor under every short kernel's time: one empty kernel launch
    # (a kernel that spins for 0 clocks), timed as the kernels are
    floor_ms = _event_median_ms(lambda i: torch.cuda._sleep(0), ITERS)
    refill()
    plain_ms = _event_median_ms(
        lambda i: logcompact.fused_diff_compact_reference(
            curs[i % CUR_COPIES], prevs[i], 20, True, region), ITERS,
        backlog=False)
    refill()
    # the kernel, from a profiler trace of 20 calls: one launch a call
    k_per_call = _profile_ms(lambda i: logcompact.fused_diff_compact(
        curs[i % CUR_COPIES], prevs[i], 20, True, region),
        ("flat_lookback_kernel",), "K1 flat", per_call=True)
    refill()
    step_ms = _event_median_ms(
        lambda i: pipe.step(prevs[i], curs[i % CUR_COPIES], text=text),
        ITERS)

    ex = StreamExecutor(cfg, pipeline=pipe)
    staged = _Staged(pipe.step(prev0.clone(), cur, text=text)[1:], 1)
    host_land = []

    def land(_):
        t = time.perf_counter()
        ex._land(t, staged)
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
    log(f"[time] empty kernel launch (torch.cuda._sleep(0)): {floor_ms:.4f} "
        f"ms, the CUDA-event pair median of {ITERS} behind the backlog: the "
        f"floor under every short kernel's time")
    log(f"[time] pipeline.step (overlay blend + kernel): {step_ms:.4f} ms")
    log(f"[time] pos-prefix landing: {land_ms:.4f} ms device span, "
        f"{statistics.median(host_land) * 1e3:.4f} ms host")
    log(f"[time] SyntheticSource next() on the host: "
        f"{statistics.median(src_s) * 1e3:.2f} ms/frame (not a kernel time)")
    _one_per_call({"K1 flat": k_per_call})
    return {"ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "step_ms": step_ms, "land_ms": land_ms,
            "per_call": k_per_call, "floor_ms": floor_ms}


def _busy_and_overlap(prof):
    """From a profiler trace: the device's busy time (the union of its
    kernel and copy intervals over all streams) and the time at least two
    streams were busy at once, in ms; None when the trace holds no device
    activity."""
    per_stream = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_stream.setdefault(e.device_resource_id, []).append(
                (e.time_range.start, e.time_range.end))
    if not per_stream:
        return None
    edges = []
    for ivals in per_stream.values():
        ivals.sort()
        cur = list(ivals[0])
        for a, b in ivals[1:] + [(float("inf"), float("inf"))]:
            if a > cur[1]:  # one stream's busy intervals, merged
                edges += [(cur[0], 1), (cur[1], -1)]
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
    edges.sort()
    busy = both = 0.0
    depth, last = 0, edges[0][0]
    for t, d in edges:
        if depth >= 1:
            busy += t - last
        if depth >= 2:
            both += t - last
        depth, last = depth + d, t
    return busy / 1e3, both / 1e3


def phase_tiled_times(cfg):
    """K1 tiled and K2 against their plain versions and bounds, the tiled
    step, both landing flavors, the host's to_flat and v3 encode, and the
    synchronous against the pipelined executor."""
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.ops import overlay as overlay_ops
    from cudavideostream_tpu_torch.runtime import wire
    from cudavideostream_tpu_torch.runtime.executor import (
        PipelinedExecutor,
        StreamExecutor,
        _Staged,
    )
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    tcfg = dataclasses.replace(cfg, tiled_payload=True)
    rng = np.random.default_rng(SEED + 3)
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    cur = torch.from_numpy(cur_np).to(dev)
    prev0 = torch.from_numpy(prev_np).to(dev)
    prevs = [prev0.clone() for _ in range(ITERS)]
    curs = [cur.clone() for _ in range(CUR_COPIES)]

    def refill():
        for p in prevs:
            p.copy_(prev0)

    pipe = DeltaStreamPipeline(tcfg)
    text = "FPS: 30 BW: 1234 kbps"
    pipe.step(prev0.clone(), cur, text=text)  # warm-up
    cell_h = pipe.atlas.shape[1]
    region = overlay_ops.overlay_blit(
        cur[: cell_h * cfg.width * 3], pipe.atlas, pipe._char_ids(text),
        len(text), cell_h, cfg.width)
    out = logcompact.fused_diff_compact_tiled(cur, prev0.clone(), 20, True,
                                              region, 1)
    pos = int(out[0])
    n_pad, unit_bytes = logcompact.tiled_geometry(n, 1)
    n_units = n_pad // unit_bytes

    k1 = {}
    for sub in (1, 8, 0):
        refill()
        k1[sub] = _event_median_ms(
            lambda i: logcompact.fused_diff_compact_tiled(
                curs[i % CUR_COPIES], prevs[i], 20, True, region, sub), ITERS)
    refill()
    k1_plain = _event_median_ms(
        lambda i: logcompact.fused_diff_compact_tiled_reference(
            curs[i % CUR_COPIES], prevs[i], 20, True, region, 1), ITERS,
        backlog=False)
    refill()
    k1_per_call = _profile_ms(lambda i: logcompact.fused_diff_compact_tiled(
        curs[i % CUR_COPIES], prevs[i], 20, True, region, 1),
        ("tiled_unit_kernel",), "K1 tiled subtile=1", per_call=True)
    # K2 on K1's blocks; 4 copies (31 MB each) rotate, so each launch
    # reads blocks last touched ~90 MB of traffic back: cold in the L2
    blocks = [(out[1], out[2].clone(), out[3].clone()) for _ in range(4)]
    k2 = _event_median_ms(lambda i: logcompact.merge_tiles(*blocks[i % 4]),
                          ITERS)
    k2_plain = _event_median_ms(
        lambda i: logcompact.pair_compact_reference(
            blocks[i % 4][1].reshape(-1), blocks[i % 4][2].reshape(-1)),
        ITERS, backlog=False)
    k2_per_call = _profile_ms(lambda i: logcompact.merge_tiles(*blocks[i % 4]),
                              ("pair_lookback_kernel",), "K2", per_call=True)
    refill()
    step_ms = _event_median_ms(
        lambda i: pipe.step(prevs[i], curs[i % CUR_COPIES], text=text),
        ITERS)

    # the landing flavors on one step's outputs
    staged = _Staged(pipe.step(prev0.clone(), cur, text=text)[1:], 2)
    land = {}
    for mode in ("tiles", "flat"):
        ex = StreamExecutor(dataclasses.replace(tcfg, fetch_mode=mode),
                            pipeline=pipe)
        host = []

        def land_once(_):
            t = time.perf_counter()
            land[mode + "_res"] = ex._land(t, staged)
            host.append(time.perf_counter() - t)

        land[mode] = (_event_median_ms(land_once, ITERS, backlog=False),
                      statistics.median(host) * 1e3)
    tp = land["tiles_res"][1]
    to_flat_s, v3_s = [], []
    enc = wire.V3Encoder(prev_np)
    for _ in range(20):
        t = time.perf_counter()
        tp.to_flat()
        to_flat_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        enc.encode(tp.pos, tp, None)
        v3_s.append(time.perf_counter() - t)

    # synchronous against pipelined, device-resident frames, per frame on
    # the host clock; in turns (sync, pipelined, pipelined, sync)
    src = SyntheticSource(cfg, seed=SEED)
    base = src.base_frame()
    frames = [torch.from_numpy(next(src)).to(dev) for _ in range(30)]
    per_frame = {}
    for mode in ("tiles", "flat"):
        for cls in (StreamExecutor, PipelinedExecutor, PipelinedExecutor,
                    StreamExecutor):
            ex = cls(dataclasses.replace(tcfg, fetch_mode=mode),
                     pipeline=pipe)
            ex.start(base)
            ex.process(frames[0], text=text)  # warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            for f in frames[1:]:
                ex.process(f, text=text)
            ex.flush()
            torch.cuda.synchronize()
            per_frame.setdefault((mode, cls.__name__), []).append(
                (time.perf_counter() - t) / (len(frames) - 1) * 1e3)

    # a profiler trace of the same loops: the device's busy share of the
    # wall time, and how long the landing stream ran beside the step's
    from torch.profiler import ProfilerActivity, profile

    traced = {}
    for mode in ("tiles", "flat"):
        for cls in (StreamExecutor, PipelinedExecutor):
            ex = cls(dataclasses.replace(tcfg, fetch_mode=mode),
                     pipeline=pipe)
            ex.start(base)
            ex.process(frames[0], text=text)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for f in frames[1:11]:
                    ex.process(f, text=text)
                ex.flush()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
            traced[(mode, cls.__name__)] = (wall, _busy_and_overlap(prof))

    # bounds: each input read once, each output written once
    k1_bytes = 2 * n + n + 4 * n_pad + n_pad + n_units * 1 + 4
    # K2 reads vals whole and xs only where a pair is valid (4 pos), and
    # writes both outputs whole: the floor this kernel is held to
    k2_bytes = n_pad + 4 * pos + 5 * n_pad + 4
    k2_full = 5 * n_pad + 5 * n_pad + 4  # every xs read
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    k2_bound = k2_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[time] tiled, 1080p, pos={pos} ({pos / n:.2%}), overlay region "
        f"{region.numel()} B, {n_units} units of {unit_bytes} B, medians of "
        f"{ITERS} (CUDA events)")
    log(f"[time] fused_diff_compact_tiled kernel: subtile=1 {k1[1]:.4f} ms "
        f"(bound {k1_bound:.4f} ms = {k1_bytes} B at 3.35 TB/s; "
        f"{k1_bound / k1[1]:.1%} of it), subtile=8 {k1[8]:.4f} ms, "
        f"subtile=0 {k1[0]:.4f} ms")
    log(f"[time] its plain PyTorch version (subtile=1): {k1_plain:.4f} ms")
    log(f"[time] pair_compact kernel (merge_tiles of those blocks): "
        f"{k2:.4f} ms (bound {k2_bound:.4f} ms = {k2_bytes} B, xs read "
        f"at valid pairs only; {k2_bound / k2:.1%} of it; with every xs "
        f"read {k2_full / HBM_BYTES_PER_S * 1e3:.4f} ms = {k2_full} B)")
    log(f"[time] its plain PyTorch version: {k2_plain:.4f} ms "
        f"(synchronizes in masked_select)")
    log(f"[time] tiled pipeline.step (overlay blend + kernel): "
        f"{step_ms:.4f} ms")
    for mode in ("tiles", "flat"):
        log(f"[time] {mode} landing: {land[mode][0]:.4f} ms device span, "
            f"{land[mode][1]:.4f} ms host")
    log(f"[time] TiledPayload.to_flat on the host: "
        f"{statistics.median(to_flat_s) * 1e3:.4f} ms; V3Encoder.encode "
        f"(to_flat + shadow apply + mode pick + packing): "
        f"{statistics.median(v3_s) * 1e3:.4f} ms")
    for (mode, name), v in per_frame.items():
        log(f"[time] {name} --fetch {mode}, device-resident frames: "
            f"{' / '.join(f'{x:.4f}' for x in v)} ms per frame (host clock, "
            f"runs in turn)")
    for (mode, name), (wall, got) in traced.items():
        if got is None:
            log(f"[trace] {name} --fetch {mode}: the profiler saw no device "
                f"activity: busy share and overlap not measured")
            continue
        busy, both = got
        log(f"[trace] {name} --fetch {mode}, 10 device-resident frames: "
            f"{wall / 10:.4f} ms per frame under the profiler, device busy "
            f"{busy / 10:.4f} ms per frame (idle {1 - busy / wall:.1%}), "
            f"two streams busy at once {both / 10:.4f} ms per frame")
    _one_per_call({"K1 tiled": k1_per_call, "K2": k2_per_call})
    return {"k1_ms": k1[1], "k1_plain_ms": k1_plain, "k1_bound_ms": k1_bound,
            "k1_per_call": k1_per_call, "k2_ms": k2,
            "k2_plain_ms": k2_plain, "k2_bound_ms": k2_bound,
            "k2_per_call": k2_per_call, "flat_land_ms": land["flat"][0]}


def phase_mask_times(cfg):
    """K1's bitmask-only emission and K3 against their plain versions and
    bounds (and K3 against ``torch.masked_select``), K1 tiled with bits
    against K1 tiled, the mask landing with its host rebuild apart, and
    the v4 encode of a MaskPayload on the host."""
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.ops import overlay as overlay_ops
    from cudavideostream_tpu_torch.runtime import wire
    from cudavideostream_tpu_torch.runtime.executor import (
        StreamExecutor,
        TiledLander,
        _Staged,
    )
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    mcfg = dataclasses.replace(cfg, tiled_payload=True, emit_bitmask=True,
                               fetch_mode="mask", maskonly_payload=True)
    rng = np.random.default_rng(SEED + 5)
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    cur = torch.from_numpy(cur_np).to(dev)
    prev0 = torch.from_numpy(prev_np).to(dev)
    prevs = [prev0.clone() for _ in range(ITERS)]
    curs = [cur.clone() for _ in range(CUR_COPIES)]

    def refill():
        for p in prevs:
            p.copy_(prev0)

    pipe = DeltaStreamPipeline(mcfg)
    text = "FPS: 30 BW: 1234 kbps"
    pipe.step(prev0.clone(), cur, text=text)  # warm-up
    cell_h = pipe.atlas.shape[1]
    region = overlay_ops.overlay_blit(
        cur[: cell_h * cfg.width * 3], pipe.atlas, pipe._char_ids(text),
        len(text), cell_h, cfg.width)
    out = logcompact.fused_diff_compact_mask(cur, prev0.clone(), 20, True,
                                             region, 1)
    pos = int(out[0])
    n_pad, unit_bytes = logcompact.tiled_geometry_mask(n, 1)
    n_units = n_pad // unit_bytes

    refill()
    k1 = _event_median_ms(
        lambda i: logcompact.fused_diff_compact_mask(
            curs[i % CUR_COPIES], prevs[i], 20, True, region, 1), ITERS)
    refill()
    k1_plain = _event_median_ms(
        lambda i: logcompact.fused_diff_compact_mask_reference(
            curs[i % CUR_COPIES], prevs[i], 20, True, region, 1), ITERS,
        backlog=False)
    refill()
    k1_per_call = _profile_ms(lambda i: logcompact.fused_diff_compact_mask(
        curs[i % CUR_COPIES], prevs[i], 20, True, region, 1),
        ("tiled_unit_kernel",), "K1 mask subtile=1", per_call=True)
    # K1 tiled without and with bits, in turns (plain, bits, bits, plain)
    tiled_ms = {False: [], True: []}
    for bits in (False, True, True, False):
        refill()
        tiled_ms[bits].append(_event_median_ms(
            lambda i: logcompact.fused_diff_compact_tiled(
                curs[i % CUR_COPIES], prevs[i], 20, True, region, 1,
                emit_bits=bits), ITERS))

    # K3 on the emission's vals blocks; 16 copies (6.2 MB each) rotate, so
    # each launch reads blocks last touched ~90 MB of traffic back
    blocks = [(out[1], out[2].clone()) for _ in range(16)]
    k3 = _event_median_ms(lambda i: logcompact.merge_vals(*blocks[i % 16]),
                          ITERS)
    k3_plain = _event_median_ms(
        lambda i: logcompact.vals_compact_reference(
            blocks[i % 16][1].reshape(-1)), ITERS, backlog=False)
    flat_vals = [b[1].reshape(-1) for b in blocks]
    k3_lib = _event_median_ms(
        lambda i: torch.masked_select(flat_vals[i % 16],
                                      flat_vals[i % 16] != 0),
        ITERS, backlog=False)
    k3_per_call = _profile_ms(
        lambda i: logcompact.merge_vals(*blocks[i % 16]),
        ("vals_lookback_kernel",), "K3", per_call=True)

    # the mask landing on one step's outputs, as a MaskPayload (wire v4)
    # and as arrays rebuilt from the bits; the rebuild and the v4 encode
    # on the host apart
    staged = _Staged(pipe.step(prev0.clone(), cur, text=text)[1:], 2)
    land = {}
    for v4 in (True, False):
        ex = StreamExecutor(dataclasses.replace(mcfg, mask_payload=v4),
                            pipeline=pipe)
        host = []

        def land_once(_):
            t = time.perf_counter()
            land[(v4, "res")] = ex._land(t, staged)
            host.append(time.perf_counter() - t)

        land[v4] = (_event_median_ms(land_once, ITERS, backlog=False),
                    statistics.median(host) * 1e3)
    mp = land[(True, "res")][1]
    rebuild_s, v4_s = [], []
    for _ in range(20):
        t = time.perf_counter()
        TiledLander.rebuild_mask_xs(mp.bits, mp.pos,
                                    mp.start_byte // unit_bytes, unit_bytes)
        rebuild_s.append(time.perf_counter() - t)
        enc = wire.V4Encoder(prev_np)
        t = time.perf_counter()
        buf = enc.encode(mp.pos, mp, None)
        v4_s.append(time.perf_counter() - t)

    # the v4 encode of served frames: the synthetic source through the
    # bitmask-only step and the mask landing, as --maskonly --wire v4
    # serves it; which mode wins decides whether the bits are forwarded
    src = SyntheticSource(cfg, seed=SEED)
    base = src.base_frame()
    ex = StreamExecutor(dataclasses.replace(mcfg, mask_payload=True),
                        pipeline=pipe)
    ex.start(base)
    served_enc = wire.V4Encoder(base)
    served_s, modes = [], {}
    for _ in range(20):
        pos_k, mp_k, _, _ = ex.process(next(src), text=text)
        t = time.perf_counter()
        served_enc.encode(pos_k, mp_k, None)
        served_s.append(time.perf_counter() - t)
        modes[served_enc.last_mode] = modes.get(served_enc.last_mode, 0) + 1

    # bounds: each input read once (prev n, and n of cur of which the
    # overlay region replaces the first r bytes), each output written once
    k1_bytes = 2 * n + n + n_pad + n_pad // 8 + n_units * 1 + 4
    k3_bytes = n_pad + n_pad + 4
    t_pad, t_unit = logcompact.tiled_geometry(n, 1)
    tiled_bytes = 2 * n + n + 5 * t_pad + t_pad // t_unit + 4
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    k3_bound = k3_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[time] bitmask-only, 1080p, pos={pos} ({pos / n:.2%}), overlay "
        f"region {region.numel()} B, {n_units} units of {unit_bytes} B, "
        f"medians of {ITERS} (CUDA events)")
    log(f"[time] fused_diff_compact_mask kernel: {k1:.4f} ms (bound "
        f"{k1_bound:.4f} ms = {k1_bytes} B at 3.35 TB/s; "
        f"{k1_bound / k1:.1%} of it); its plain PyTorch version "
        f"{k1_plain:.4f} ms")
    log(f"[time] fused_diff_compact_tiled subtile=1 without / with bits, in "
        f"turns: {' / '.join(f'{x:.4f}' for x in tiled_ms[False])} ms / "
        f"{' / '.join(f'{x:.4f}' for x in tiled_ms[True])} ms (bound without "
        f"{tiled_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, with "
        f"{(tiled_bytes + t_pad // 8) / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    log(f"[time] vals_compact kernel (merge_vals of those blocks): {k3:.4f} "
        f"ms (bound {k3_bound:.4f} ms = {k3_bytes} B; {k3_bound / k3:.1%} "
        f"of it); its plain PyTorch version {k3_plain:.4f} ms; "
        f"torch.masked_select(v, v != 0) {k3_lib:.4f} ms (the kept bytes "
        f"only, no zero tail, and it synchronizes to size its output)")
    for v4 in (True, False):
        log(f"[time] mask landing ({'MaskPayload' if v4 else 'arrays rebuilt from the bits'}): "
            f"{land[v4][0]:.4f} ms device span, {land[v4][1]:.4f} ms host")
    log(f"[time] host rebuild of the indices from the bits window: "
        f"{statistics.median(rebuild_s) * 1e3:.4f} ms; V4Encoder.encode of "
        f"the MaskPayload (mode {buf[0]}, {len(buf)} B): "
        f"{statistics.median(v4_s) * 1e3:.4f} ms")
    log(f"[time] V4Encoder.encode of 20 served synthetic frames after the "
        f"mask landing: {statistics.median(served_s) * 1e3:.4f} ms median "
        f"on the host; modes {dict(sorted(modes.items()))} (0 delta16, 1 "
        f"bitmask, 2 raw, 3 winmask: only 3 forwards the bits)")
    _one_per_call({"K1 mask": k1_per_call, "K3": k3_per_call})
    return {"k1_ms": k1, "k1_plain_ms": k1_plain, "k1_bound_ms": k1_bound,
            "k1_per_call": k1_per_call, "k3_ms": k3,
            "k3_plain_ms": k3_plain, "k3_bound_ms": k3_bound,
            "k3_library_ms": k3_lib, "k3_per_call": k3_per_call,
            "land_ms": land[True][0]}


def phase_filter_times(cfg):
    """K4 against its plain version, ``torch.bincount`` and its bound; the
    ``--visualizer 5`` step against the plain step; the aux landing. (K8
    and K9 have their own phase, :func:`phase_noise_binarize_times`, and
    K10-K13 theirs, :func:`phase_visualize_times`.)"""
    from cudavideostream_tpu_torch.config import Visualizer
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import filters
    from cudavideostream_tpu_torch.ops import hist
    from cudavideostream_tpu_torch.runtime.executor import (
        StreamExecutor,
        _Staged,
    )
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED + 7)
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    cur = torch.from_numpy(cur_np).to(dev)
    prev0 = torch.from_numpy(prev_np).to(dev)
    prevs = [prev0.clone() for _ in range(ITERS)]
    curs = [cur.clone() for _ in range(CUR_COPIES)]

    # K4 on the synthetic scene's gray values, which the step has just
    # written (hot in L2, as the binarize chain leaves them), and on the
    # one-value frame (every add on one bin)
    src = SyntheticSource(cfg, seed=SEED)
    src.base_frame()
    g = filters.gray_pixels(torch.from_numpy(next(src)).to(dev))
    one = torch.full_like(g, 137)
    hist.histogram(g)  # warm-up
    k4 = _event_median_ms(lambda i: hist.histogram(g), ITERS)
    k4_one = _event_median_ms(lambda i: hist.histogram(one), ITERS)
    k4_plain = _event_median_ms(lambda i: hist.histogram_reference(g),
                                ITERS, backlog=False)
    k4_lib = _event_median_ms(lambda i: torch.bincount(g, minlength=256),
                              ITERS, backlog=False)
    k4_per_call = _profile_ms(lambda i: hist.histogram(g), ("hist_kernel",),
                              "K4", per_call=True)
    _one_per_call({"K4": k4_per_call})
    # bound: each gray byte read once, the 256 int32 bins written once
    k4_bytes = g.numel() + 4 * 256
    k4_bound = k4_bytes / HBM_BYTES_PER_S * 1e3

    # a step enqueues up to ~50 small launches: 30 calls fit the launch
    # queue behind the sleep (100 did not)
    few = 30
    text = "FPS: 30 BW: 1234 kbps"
    step_ms = {}
    for vis in (Visualizer.NONE, Visualizer.BINARIZE, Visualizer.BINARIZE,
                Visualizer.NONE):
        pipe = DeltaStreamPipeline(dataclasses.replace(cfg, visualizer=vis))
        pipe.step(prev0.clone(), cur, text=text)  # warm-up
        for p in prevs:
            p.copy_(prev0)
        step_ms.setdefault(vis, []).append(_event_median_ms(
            lambda i: pipe.step(prevs[i], curs[i % CUR_COPIES], text=text),
            few))
    # the aux landing: the executor's copier on one --visualizer 5 step's
    # outputs, a fresh staging per call
    vcfg = dataclasses.replace(cfg, visualizer=Visualizer.BINARIZE)
    ex = StreamExecutor(vcfg)
    outs = ex.pipe.step(prev0.clone(), cur, text=text)[1:]
    host = []

    def land_aux(_):
        staged = _Staged(outs, 1)
        t = time.perf_counter()
        ex._copier.land_aux(staged)
        host.append(time.perf_counter() - t)

    aux_ms = _event_median_ms(land_aux, ITERS, backlog=False)
    aux_host_ms = statistics.median(host) * 1e3

    log(f"[time] K4 histogram of the synthetic scene's {g.numel()} gray "
        f"values: {k4:.4f} ms (bound {k4_bound:.6f} ms = {k4_bytes} B at "
        f"3.35 TB/s; {k4_bound / k4:.1%} of it); one value everywhere "
        f"{k4_one:.4f} ms; its plain PyTorch version {k4_plain:.4f} ms; "
        f"torch.bincount(g, minlength=256) {k4_lib:.4f} ms (it reads the "
        f"maximum back to size its output)")
    log(f"[time] pipeline.step without / with --visualizer 5, in turns, "
        f"medians of {few}: "
        f"{' / '.join(f'{x:.4f}' for x in step_ms[Visualizer.NONE])} ms / "
        f"{' / '.join(f'{x:.4f}' for x in step_ms[Visualizer.BINARIZE])} ms")
    log(f"[time] aux landing ({n} B device to host, pinned): {aux_ms:.4f} ms "
        f"event span, {aux_host_ms:.4f} ms host")
    return {"k4_ms": k4, "k4_plain_ms": k4_plain, "k4_bound_ms": k4_bound,
            "k4_library_ms": k4_lib, "k4_one_ms": k4_one,
            "k4_per_call": k4_per_call}


# int32 multiply-adds an SM issues per clock (the data sheet's 64 INT32
# lanes): K8's bound in operations is K^2 of them a byte
INT32_LANES_PER_SM = 64
K8_TIMED = (3, 5, 7, 9)
COLD_COPIES = 16  # 16 frames of 6.2 MB: twice the 50 MB L2


def _ms_or_not(ms):
    """A profiler time as ``0.0123 ms``, or ``not measured`` where the
    profiler saw none."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _share(bound, ms):
    """``bound / ms`` as a share, or ``not measured``."""
    return "not measured" if ms is None else f"{bound / ms:.1%}"


def _pair4(values):
    return " / ".join(f"{v:.4f}" for v in values)


def _wall_ms(fn, iters):
    """Median host wall time of ``fn(i)`` followed by a synchronize."""
    out = []
    for i in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return statistics.median(out) * 1e3


def phase_noise_binarize_times(cfg, clock_mhz, smi):
    """K8 at K = 3, 5, 7, 9 and K9 at 1080p on cold frames (16 copies in
    turn), CUDA-event medians with the queue held behind a sleep, against
    their plain versions, their bounds and, for K8, ``F.conv2d`` in fp32
    (TF32 off, ``groups=3``, on a channel-planar float copy: a time only,
    no path of the port calls it); their kernels per call from a trace and
    a graph capture; and ``pipeline.step`` with ``--noise-filter`` and with
    ``--visualizer 5``, device and host wall time, the kernels against the
    plain versions (and K9 against the chain of torch ops around K4 that
    it replaced) in turns."""
    import torch.nn.functional as F

    from cudavideostream_tpu_torch.config import Visualizer
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import convolve
    from cudavideostream_tpu_torch.ops import diff
    from cudavideostream_tpu_torch.ops import filters
    from cudavideostream_tpu_torch.ops import reference_cpu

    dev = torch.device("cuda")
    h, w, n = cfg.height, cfg.width, cfg.frame_bytes
    rng = np.random.default_rng(SEED + 31)
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    cold = [torch.from_numpy(drift(rng, cur_np, 0.06)).to(dev)
            for _ in range(COLD_COPIES)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    io_bound = 2 * n / HBM_BYTES_PER_S * 1e3
    out = {"k8": {}, "k9": {}}
    for k in K8_TIMED:
        wq = reference_cpu.quantize_kernel_q16(reference_cpu.gaussian_kernel(k))
        convolve.convolve_q16(cold[0], wq, h, w)  # warm-up
        ms = _event_median_ms(
            lambda i: convolve.convolve_q16(cold[i % COLD_COPIES], wq, h, w),
            ITERS)
        plain = _event_median_ms(
            lambda i: convolve.convolve_q16_reference(cold[i % COLD_COPIES],
                                                      wq, h, w),
            10, backlog=False)
        ops_bound = (k * k * n / (INT32_LANES_PER_SM * sms * clock_mhz * 1e6)
                     * 1e3)
        # the library yardstick: fp32 conv2d, channel-planar, exact for these
        # non-negative normalized taps (every partial sum an integer < 2^24)
        planar = [c.view(h, w, 3).permute(2, 0, 1).float().unsqueeze(0)
                  .contiguous() for c in cold]
        wt = torch.from_numpy(wq.astype(np.float32)).to(dev).expand(
            3, 1, k, k).contiguous()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib_out = F.conv2d(planar[0], wt, padding=k // 2, groups=3)
            lib = _event_median_ms(
                lambda i: F.conv2d(planar[i % COLD_COPIES], wt,
                                   padding=k // 2, groups=3), ITERS)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        lib_bytes = torch.div(lib_out, 65536, rounding_mode="floor").clamp(
            0, 255).to(torch.uint8)[0].permute(1, 2, 0).reshape(-1)
        lib_same = bool(torch.equal(lib_bytes,
                                    convolve.convolve_q16(cold[0], wq, h, w)))
        del planar
        bound = max(io_bound, ops_bound)
        kernel_only = {}
        per_call = _profile_ms(
            lambda i: convolve.convolve_q16(cold[i % COLD_COPIES], wq, h, w),
            ("conv_kernel",), f"K8 K={k}", per_call=True,
            kernel_ms=kernel_only)
        _one_per_call({f"K8 K={k}": per_call})
        out["k8"][k] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                        "bound_by": "bytes" if io_bound >= ops_bound
                        else "operations", "library_ms": lib,
                        "bytes_bound_ms": io_bound, "ops_bound_ms": ops_bound,
                        "kernel_ms": kernel_only.get("conv_kernel"),
                        "per_call": per_call}
        log(f"[time] K8 convolve_q16 K={k} at 1080p, cold frames: {ms:.4f} ms "
            f"event, {_ms_or_not(kernel_only.get('conv_kernel'))} kernel-only "
            f"(profiler) "
            f"(bound {bound:.5f} ms by {out['k8'][k]['bound_by']}: "
            f"{2 * n} B at 3.35 TB/s {io_bound:.5f} ms, {k * k} int32 "
            f"multiply-adds a byte at {INT32_LANES_PER_SM} a clock an SM x "
            f"{sms} SMs x {clock_mhz} MHz {ops_bound:.5f} ms; {bound / ms:.1%} "
            f"of it by the event, {_share(bound, kernel_only.get('conv_kernel'))}"
            f" by the kernel-only time); its plain version {plain:.4f} ms; "
            f"F.conv2d fp32 "
            f"(TF32 off, groups=3, channel-planar) {lib:.4f} ms, its bytes "
            f"after >> 16 {'equal' if lib_same else 'differ from'} K8's "
            f"({smi})")
    out["k8_per_call"] = out["k8"][3]["per_call"]

    # K9: the fused kernel solo and on B = 4 streams of the frame, the
    # sharded path's two launches each alone, and the plain version; the
    # torch chain it replaced (torch ops around K4) is timed in the step
    # below
    def torch_chain(frame):
        gv = filters.gray_pixels(frame)
        return filters.binarize_pixels(
            gv, filters.binarize_threshold(filters.value_histogram(gv)))

    filters.binarize_pipeline(cold[0])  # warm-up
    quads = [torch.cat([cold[(4 * j + q) % COLD_COPIES] for q in range(4)])
             for j in range(4)]
    filters.binarize_pipeline(quads[0], streams=4)
    gray, counts = filters.gray_hist(cold[0])
    solo_k, quad_k = {}, {}
    k9 = {
        "ms": _event_median_ms(lambda i: filters.binarize_pipeline(
            cold[i % COLD_COPIES]), ITERS),
        "b4_ms": _event_median_ms(lambda i: filters.binarize_pipeline(
            quads[i % 4], streams=4), ITERS),
        "gray_hist_ms": _event_median_ms(lambda i: filters.gray_hist(
            cold[i % COLD_COPIES]), ITERS),
        "apply_ms": _event_median_ms(
            lambda i: filters.binarize_apply(gray, counts), ITERS),
        "plain_ms": _event_median_ms(
            lambda i: filters.binarize_pipeline_reference(
                cold[i % COLD_COPIES]), 10, backlog=False),
        "bound_ms": io_bound,
        "b4_bound_ms": 4 * io_bound,
        "per_call": _profile_ms(
            lambda i: filters.binarize_pipeline(cold[i % COLD_COPIES]),
            ("binarize_fused_kernel",), "K9", per_call=True,
            kernel_ms=solo_k),
        "b4_per_call": _profile_ms(
            lambda i: filters.binarize_pipeline(quads[i % 4], streams=4),
            ("binarize_fused_kernel",), "K9 B=4", per_call=True,
            kernel_ms=quad_k)}
    k9["kernel_ms"] = solo_k.get("binarize_fused_kernel")
    k9["b4_kernel_ms"] = quad_k.get("binarize_fused_kernel")
    if k9["per_call"] != 1 or k9["b4_per_call"] != 1:
        raise AssertionError(f"K9: {k9['per_call']:g} launches a call, "
                             f"{k9['b4_per_call']:g} at B=4, not 1")
    out["k9"] = k9
    log(f"[time] K9 binarize_pipeline at 1080p, cold frames: {k9['ms']:.4f} "
        f"ms event, {_ms_or_not(k9['kernel_ms'])} kernel-only (profiler), "
        f"one cooperative launch of binarize_fused_kernel (bound "
        f"{io_bound:.5f} ms = {2 * n} B at 3.35 TB/s, {io_bound / k9['ms']:.1%}"
        f" of it by the event, {_share(io_bound, k9['kernel_ms'])} by the "
        f"kernel-only time); B=4 streams in one launch {k9['b4_ms']:.4f} ms "
        f"event, {_ms_or_not(k9['b4_kernel_ms'])} kernel-only (bound "
        f"{4 * io_bound:.5f} ms, {4 * io_bound / k9['b4_ms']:.1%}); the "
        f"sharded path's binarize_gray_kernel alone {k9['gray_hist_ms']:.4f} "
        f"ms, binarize_apply_kernel alone on hot gray bytes "
        f"{k9['apply_ms']:.4f} ms; its plain version {k9['plain_ms']:.4f} ms "
        f"({smi})")
    del quads

    # pipeline.step, the kernels against the plain versions in turns
    text = "FPS: 30 BW: 1234 kbps"
    prev0 = torch.from_numpy(prev_np).to(dev)
    prevs = [prev0.clone() for _ in range(ITERS)]

    def plain_conv(frame, wq, height, width, streams=1):
        return convolve.convolve_q16_reference(frame, wq, height, width)

    routes = {
        "--noise-filter": (dataclasses.replace(cfg, noise_filter=True),
                           {"K8": None, "plain": (convolve, "convolve_q16",
                                                  plain_conv)}),
        "--visualizer 5": (dataclasses.replace(
            cfg, visualizer=Visualizer.BINARIZE),
            {"K9": None,
             "plain": (filters, "binarize_pipeline",
                       lambda f, out=None, region=None:
                           filters.binarize_pipeline_reference(f, region)),
             "torch chain": (filters, "binarize_pipeline",
                             lambda f, out=None, region=None: torch_chain(
                                 diff.region_frame(f, region)))})}
    steps = {}
    calls = 8  # steps a reading: a plain step takes ~4 ms
    for label, (vcfg, kinds) in routes.items():
        pipe = DeltaStreamPipeline(vcfg)
        order = list(kinds) + list(reversed(kinds))
        res = {kind: {"device_ms": [], "wall_ms": []} for kind in kinds}
        for kind in order:
            patch = kinds[kind]
            ctx = (_patched(*patch) if patch is not None
                   else contextlib.nullcontext())
            with ctx:
                pipe.step(prev0.clone(), cold[0], text=text)  # warm-up
                for p in prevs:
                    p.copy_(prev0)
                res[kind]["device_ms"].append(_event_median_ms(
                    lambda i: pipe.step(prevs[i], cold[i % COLD_COPIES],
                                        text=text), calls))
                for p in prevs:
                    p.copy_(prev0)
                res[kind]["wall_ms"].append(_wall_ms(
                    lambda i: pipe.step(prevs[i], cold[i % COLD_COPIES],
                                        text=text), calls))
        steps[label] = res
        log(f"[time] pipeline.step {label} at 1080p, in turns "
            f"({', '.join(order)}), medians of {calls}: " + "; ".join(
                f"{kind} device {_pair4(r['device_ms'])} ms, host wall "
                f"{_pair4(r['wall_ms'])} ms" for kind, r in res.items())
            + f" ({smi})")
    out["steps"] = steps
    return out


def phase_visualize_times(cfg, smi):
    """K10-K13 at 1080p on cold frames (16 copies in turn), CUDA-event
    medians with the queue held behind a sleep, against their plain
    versions and their bounds (the bytes each must move: K10 reads cur
    and prev and writes prev and the n/8 bits, the map's or the delta's n
    more where used; K11 and K12 read cur and prev and write the output,
    the map's n more; K13 reads cur and writes the output); no single
    PyTorch call computes any of them, so there is no library time. Their
    kernels per call from a trace and a graph capture. Then
    ``pipeline.step`` with ``--visualizer 1``, ``--visualizer 3`` and
    ``--compaction host``, device and host wall time, the kernel against
    its plain version (the chain of torch ops it replaced) in turns."""
    from cudavideostream_tpu_torch.config import CompactionBackend, Visualizer
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import diff, filters

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED + 41)
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    cold = [torch.from_numpy(drift(rng, cur_np, 0.06)).to(dev)
            for _ in range(COLD_COPIES)]
    prevs = [torch.from_numpy(prev_np).to(dev) for _ in range(COLD_COPIES)]
    tmaps = [torch.full((n,), cfg.threshold, dtype=torch.uint8, device=dev)
             for _ in range(COLD_COPIES)]

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    c, p, m = (lambda i: cold[i % COLD_COPIES]), (
        lambda i: prevs[i % COLD_COPIES]), (lambda i: tmaps[i % COLD_COPIES])
    bits = (n + 7) // 8
    # (label, kernel call, plain call, bytes, kernel names, launches)
    timed = {
        "K10 diff_pack": (
            lambda i: diff.diff_pack(c(i), p(i), cfg.threshold),
            lambda i: diff.diff_pack_reference(c(i), p(i), cfg.threshold),
            3 * n + bits, ("diff_pack_kernel",)),
        "K10 diff_pack with the delta": (
            lambda i: diff.diff_pack(c(i), p(i), cfg.threshold,
                                     want_delta=True),
            lambda i: diff.diff_pack_reference(c(i), p(i), cfg.threshold,
                                               want_delta=True),
            4 * n + bits, ("diff_pack_kernel",)),
        "K10 diff_pack with a map": (
            lambda i: diff.diff_pack(c(i), p(i), m(i)),
            lambda i: diff.diff_pack_reference(c(i), p(i), m(i)),
            4 * n + bits, ("diff_pack_kernel",)),
        "K11 heatmap": (
            lambda i: filters.heatmap(c(i), p(i)),
            lambda i: filters.heatmap_reference(c(i), p(i)),
            3 * n, ("heat_kernel",)),
        "K12 red_visualizer mode 3": (
            lambda i: filters.red_visualizer(c(i), p(i), cfg.threshold, True),
            lambda i: filters.red_visualizer_reference(c(i), p(i),
                                                       cfg.threshold, True),
            3 * n, ("red_kernel",)),
        "K12 red_visualizer mode 3 with a map": (
            lambda i: filters.red_visualizer(c(i), p(i), m(i), True),
            lambda i: filters.red_visualizer_reference(c(i), p(i), m(i),
                                                       True),
            4 * n, ("red_kernel",)),
        "K12 red_visualizer mode 2": (
            lambda i: filters.red_visualizer(c(i), p(i), cfg.threshold,
                                             False),
            lambda i: filters.red_visualizer_reference(c(i), p(i),
                                                       cfg.threshold, False),
            3 * n, ("red_kernel",)),
        "K13 grayscale_weighted": (
            lambda i: filters.grayscale_weighted(c(i)),
            lambda i: filters.grayscale_weighted_reference(c(i)),
            2 * n, ("vis_kernel",)),
        "K13 grayscale_average": (
            lambda i: filters.grayscale_average(c(i)),
            lambda i: filters.grayscale_average_reference(c(i)),
            2 * n, ("vis_kernel",)),
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {"K10": f"grid {diff.diff_pack_plan(n, sms)} (tiles of "
                    f"{diff.DP_TILE} B)",
             **{k: f"grid {filters.tile_plan(n, sms, per_sm)} (warp tiles "
                   f"of {filters.VIS_TILE} B, {-(-n // filters.VIS_TILE)} "
                   f"of them)"
                for k, per_sm in (("K11", filters.HEAT_BLOCKS_PER_SM),
                                  ("K12", filters.RED_BLOCKS_PER_SM))},
             "K13": f"grid {filters.vis_plan(n // 3, sms)} (runs of "
                    f"{filters.VIS_PIXELS} pixels a thread)"}
    out = {}
    for label, (fn, plain, nbytes, names) in timed.items():
        fn(0)  # warm-up
        ms = _event_median_ms(fn, ITERS)
        plain_ms = _event_median_ms(plain, 10, backlog=False)
        kernel_only = {}
        per_call = _profile_ms(fn, names, label, per_call=True,
                               kernel_ms=kernel_only)
        _one_per_call({label: per_call})
        b = bound(nbytes)
        kms = kernel_only.get(names[0])
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                      "bytes": nbytes, "per_call": per_call,
                      "kernel_ms": kms}
        log(f"[time] {label} at 1080p, cold frames: {ms:.4f} ms event, "
            f"{_ms_or_not(kms)} kernel-only (profiler) (bound {b:.5f} ms = "
            f"{nbytes} B at 3.35 TB/s, {_share(b, ms)} of it by the event, "
            f"{_share(b, kms)} kernel-only); {plans[label[:3]]}; its plain "
            f"version {plain_ms:.4f} ms; no single PyTorch call computes it; "
            f"{per_call:g} kernel a call ({smi})")

    # pipeline.step, the kernel against its plain version in turns
    text = "FPS: 30 BW: 1234 kbps"
    prev0 = torch.from_numpy(prev_np).to(dev)
    step_prevs = [prev0.clone() for _ in range(ITERS)]
    routes = {
        "--visualizer 1": (dataclasses.replace(
            cfg, visualizer=Visualizer.HEATMAP), (
            filters, "heatmap",
            lambda cur, prev, region=None, streams=1:
                filters.heatmap_reference(cur, prev, region, streams))),
        "--visualizer 3": (dataclasses.replace(
            cfg, visualizer=Visualizer.RED_OVERLAP), (
            filters, "red_visualizer",
            lambda cur, prev, thr, overlap, region=None, streams=1:
                filters.red_visualizer_reference(cur, prev, thr, overlap,
                                                 region, streams))),
        "--compaction host": (dataclasses.replace(
            cfg, compaction=CompactionBackend.HOST), (
            diff, "diff_pack", diff.diff_pack_reference)),
    }
    steps = {}
    calls = 8
    for label, (vcfg, plain_patch) in routes.items():
        pipe = DeltaStreamPipeline(vcfg)
        host = vcfg.compaction is CompactionBackend.HOST
        kinds = {"kernel": None, "plain": plain_patch}
        order = ["kernel", "plain", "plain", "kernel"]
        res = {kind: {"device_ms": [], "wall_ms": []} for kind in kinds}
        for kind in order:
            patch = kinds[kind]
            ctx = (_patched(*patch) if patch is not None
                   else contextlib.nullcontext())
            with ctx:
                # HOST: one state and its host shadow, stepped in order
                state = pipe.init_state(prev_np)
                pipe.step(prev0.clone() if not host else state, cold[0],
                          text=text)  # warm-up
                for q in step_prevs:
                    q.copy_(prev0)

                def step(i):
                    pipe.step(state if host else step_prevs[i],
                              cold[i % COLD_COPIES], text=text)

                # the HOST step waits for its bits, so no queue is held
                # and its event span holds the host's pack too
                res[kind]["device_ms"].append(_event_median_ms(
                    step, calls, backlog=not host))
                for q in step_prevs:
                    q.copy_(prev0)
                res[kind]["wall_ms"].append(_wall_ms(step, calls))
        steps[label] = res
        span = "event span (the host's pack inside)" if host else "device"
        log(f"[time] pipeline.step {label} at 1080p, in turns "
            f"({', '.join(order)}), medians of {calls}: " + "; ".join(
                f"{kind} {span} {_pair4(r['device_ms'])} ms, host wall "
                f"{_pair4(r['wall_ms'])} ms" for kind, r in res.items())
            + f" ({smi})")
    return {"kernels": out, "steps": steps}


def phase_map_scheme_times(cfg, clock_mhz):
    """K1 without and with a map on each emission, in turns (a map of 20s
    everywhere, so both ship the same bytes and the difference is the
    map's read); K5 without and with the map, K6 and K7 against their
    plain versions and bounds."""
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import filters
    from cudavideostream_tpu_torch.ops import hist
    from cudavideostream_tpu_torch.ops import logcompact
    from cudavideostream_tpu_torch.ops import overlay as overlay_ops
    from cudavideostream_tpu_torch.ops import register_compact
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED + 11)
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    cur = torch.from_numpy(cur_np).to(dev)
    prev0 = torch.from_numpy(prev_np).to(dev)
    prevs = [prev0.clone() for _ in range(ITERS)]
    curs = [cur.clone() for _ in range(CUR_COPIES)]
    tm = torch.full((n,), cfg.threshold, dtype=torch.uint8, device=dev)

    def refill():
        for p in prevs:
            p.copy_(prev0)

    pipe = DeltaStreamPipeline(cfg)
    text = "FPS: 30 BW: 1234 kbps"
    cell_h = pipe.atlas.shape[1]
    region = overlay_ops.overlay_blit(
        cur[: cell_h * cfg.width * 3], pipe.atlas, pipe._char_ids(text),
        len(text), cell_h, cfg.width)
    lc = logcompact
    k1 = {"flat": lambda i, m: lc.fused_diff_compact(
              curs[i % CUR_COPIES], prevs[i], 20, True, region,
              threshold_map=m),
          "tiled": lambda i, m: lc.fused_diff_compact_tiled(
              curs[i % CUR_COPIES], prevs[i], 20, True, region, 1,
              threshold_map=m),
          "mask": lambda i, m: lc.fused_diff_compact_mask(
              curs[i % CUR_COPIES], prevs[i], 20, True, region, 1,
              threshold_map=m)}
    k1_ms = {}
    for name, fn in k1.items():
        for m in (None, tm, tm, None):
            refill()
            k1_ms.setdefault((name, m is not None), []).append(
                _event_median_ms(lambda i: fn(i, m), ITERS))
    pos = int(lc.fused_diff_compact(cur, prev0.clone(), 20, True, region,
                                    threshold_map=tm)[0])

    k5_ms = {}
    for m in (None, tm, tm, None):
        refill()
        k5_ms.setdefault(m is not None, []).append(_event_median_ms(
            lambda i: lc.segment_compact(curs[i % CUR_COPIES], prevs[i], 20,
                                         True, region, m), ITERS))
    k5_per_call = {}
    for m, label in ((None, "K5"), (tm, "K5 with the map")):
        refill()
        k5_per_call[label] = _profile_ms(
            lambda i: lc.segment_compact(curs[i % CUR_COPIES], prevs[i], 20,
                                         True, region, m),
            ("segment_kernel",), label, per_call=True)
    _one_per_call(k5_per_call)
    refill()
    k5_plain = _event_median_ms(
        lambda i: lc.segment_compact_reference(
            curs[i % CUR_COPIES], prevs[i], 20, True, region), 10,
        backlog=False)
    refill()
    k6 = _event_median_ms(lambda i: register_compact.register_compact(
        curs[i % CUR_COPIES], prevs[i]), ITERS)
    refill()
    k6_per_call = _profile_ms(lambda i: register_compact.register_compact(
        curs[i % CUR_COPIES], prevs[i]), ("register_kernel",), "K6",
        per_call=True)
    _one_per_call({"K6": k6_per_call})
    refill()
    k6_plain = _event_median_ms(
        lambda i: register_compact.register_compact_reference(
            curs[i % CUR_COPIES], prevs[i]), 5, backlog=False)

    src = SyntheticSource(cfg, seed=SEED)
    src.base_frame()
    g2 = filters.gray_pixels(torch.from_numpy(next(src)).to(dev)).to(
        torch.int32).view(-1, 128)
    hist.vpu_probe(g2)  # warm-up
    k7 = _event_median_ms(lambda i: hist.vpu_probe(g2), ITERS)
    k7_per_call = _profile_ms(lambda i: hist.vpu_probe(g2),
                              ("probe_kernel",), "K7", per_call=True)
    _one_per_call({"K7": k7_per_call})
    k7_plain = _event_median_ms(lambda i: hist.vpu_probe_reference(g2), 10,
                                backlog=False)

    # bounds: each input read once, each output written once; a map adds
    # its n bytes read
    t_pad, t_unit = lc.tiled_geometry(n, 1)
    m_pad, m_unit = lc.tiled_geometry_mask(n, 1)
    w_pad, w_unit = lc.tiled_geometry(n, 0)
    k1_bytes = {"flat": 8 * n + 4,
                "tiled": 3 * n + 5 * t_pad + t_pad // t_unit + 4,
                "mask": 3 * n + m_pad + m_pad // 8 + m_pad // m_unit + 4}
    k5_bytes = 3 * n + 5 * w_pad + 4 * (w_pad // w_unit)
    npx = g2.numel()
    # a compare and an add per value and bin (one ISETP and one IADD each
    # in the SASS), over the SM's issue ceiling: 4 schedulers x 32 lanes
    # per clock, whichever pipe runs the instruction
    k7_ops = 2 * hist.NBINS * npx
    k7_ops_ms = k7_ops / (132 * K7_LANES_PER_SM * clock_mhz * 1e6) * 1e3
    k7_bytes_ms = (4 * npx + 4 * (npx // 128 // hist.probe_tile(
        npx // 128))) / HBM_BYTES_PER_S * 1e3

    def ms(b):
        return b / HBM_BYTES_PER_S * 1e3

    log(f"[time] per-byte map, 1080p, pos={pos} ({pos / n:.2%}) with a map "
        f"of {cfg.threshold}s (the scalar run's bytes), overlay region "
        f"{region.numel()} B, medians of {ITERS} (CUDA events), in turns "
        f"without / with the map")
    for name in k1:
        off_, on_ = k1_ms[(name, False)], k1_ms[(name, True)]
        log(f"[time] K1 {name}{' subtile=1' if name != 'flat' else ''}: "
            f"{' / '.join(f'{x:.4f}' for x in off_)} ms without, "
            f"{' / '.join(f'{x:.4f}' for x in on_)} ms with the map (bound "
            f"{ms(k1_bytes[name]):.5f} / {ms(k1_bytes[name] + n):.5f} ms = "
            f"{k1_bytes[name]} / {k1_bytes[name] + n} B at 3.35 TB/s)")
    log(f"[time] K5 segment_compact ({w_pad // w_unit} tiles of {w_unit} "
        f"B): {' / '.join(f'{x:.4f}' for x in k5_ms[False])} ms, with the "
        f"map {' / '.join(f'{x:.4f}' for x in k5_ms[True])} ms (bound "
        f"{ms(k5_bytes):.5f} / {ms(k5_bytes + n):.5f} ms = {k5_bytes} / "
        f"{k5_bytes + n} B; {ms(k5_bytes) / statistics.median(k5_ms[False]):.1%}"
        f" of it); its plain PyTorch version {k5_plain:.4f} ms")
    log(f"[time] K6 register_compact: {k6:.4f} ms (bound {ms(k5_bytes):.5f} "
        f"ms = {k5_bytes} B; {ms(k5_bytes) / k6:.1%} of it); its plain "
        f"PyTorch version {k6_plain:.4f} ms (a 496-row loop)")
    log(f"[time] K7 vpu_probe on the scene's {npx} gray values "
        f"({npx // 128} x 128 int32): {k7:.4f} ms (bound {k7_ops_ms:.5f} ms "
        f"= {k7_ops} int32 operations over 132 SMs x {K7_LANES_PER_SM} "
        f"lanes at "
        f"{clock_mhz} MHz; its bytes {k7_bytes_ms:.5f} ms; "
        f"{k7_ops_ms / k7:.1%} of it); its plain PyTorch version "
        f"{k7_plain:.4f} ms")
    med = {key: statistics.median(v) for key, v in k1_ms.items()}
    return {"k1_map_ms": {name: med[(name, True)] for name in k1},
            "k1_map_bound_ms": {name: ms(k1_bytes[name] + n) for name in k1},
            "k5_ms": statistics.median(k5_ms[False]),
            "k5_map_ms": statistics.median(k5_ms[True]),
            "k5_plain_ms": k5_plain, "k5_bound_ms": ms(k5_bytes),
            "k5_map_bound_ms": ms(k5_bytes + n),
            "k6_ms": k6, "k6_plain_ms": k6_plain, "k6_bound_ms": ms(k5_bytes),
            "k6_per_call": k6_per_call,
            "k5_per_call": k5_per_call["K5"],
            "k5_map_per_call": k5_per_call["K5 with the map"],
            "k7_per_call": k7_per_call,
            "k7_ms": k7, "k7_plain_ms": k7_plain,
            "k7_bound_ms": max(k7_ops_ms, k7_bytes_ms)}


def phase_batched_times(cfg):
    """K1 batched at B = 4 (subtile_rows 1) against four solo K1 tiled
    launches on the same streams, in turns, and against its bound; K5
    batched at B = 4 against its bound; their plain versions; the B = 4
    batched step's device time."""
    from cudavideostream_tpu_torch.models import BatchedDeltaPipeline
    from cudavideostream_tpu_torch.ops import logcompact as lc

    b_count, n = 4, cfg.frame_bytes
    rng = np.random.default_rng(SEED + 13)
    prev0, cur = _streams(rng, b_count, n, 0.06)
    strip = 288_000
    reg = torch.from_numpy(rng.integers(0, 255, b_count * strip,
                                        endpoint=True, dtype=np.uint8)).cuda()
    # fresh state per call, inputs rotated: cold in the 50 MB L2
    prevs = [prev0.clone() for _ in range(ITERS)]
    curs = [cur.clone() for _ in range(CUR_COPIES)]

    def refill():
        for p in prevs:
            p.copy_(prev0)

    def batched(i, scheme="element"):
        lc.fused_diff_compact_batched(curs[i % CUR_COPIES], prevs[i],
                                      b_count, scheme=scheme, sub_rows=1,
                                      overlay_region=reg)

    def solo(i):
        c, p = curs[i % CUR_COPIES], prevs[i]
        for s in range(b_count):
            lc.fused_diff_compact_tiled(c[s * n:(s + 1) * n],
                                        p[s * n:(s + 1) * n], 20, True,
                                        reg[s * strip:(s + 1) * strip], 1)

    pos = lc.fused_diff_compact_batched(cur, prev0.clone(), b_count,
                                        sub_rows=1, overlay_region=reg)[0]
    turns = {}
    for name, fn in (("batched", batched), ("solo", solo), ("solo", solo),
                     ("batched", batched)):
        refill()
        turns.setdefault(name, []).append(_event_median_ms(fn, ITERS))
    refill()
    k1_per_call = _profile_ms(batched, ("tiled_unit_kernel",),
                              "K1 batched B=4 subtile=1", per_call=True)
    _one_per_call({"K1 batched": k1_per_call})
    refill()
    k1_plain = _event_median_ms(
        lambda i: lc.fused_diff_compact_batched_reference(
            curs[i % CUR_COPIES], prevs[i], b_count, sub_rows=1,
            overlay_region=reg), 10, backlog=False)
    refill()
    k5 = _event_median_ms(lambda i: batched(i, "segment"), ITERS)
    refill()
    # the kernel's batched launch (the entry point adds PyTorch's sum of
    # each stream's counts for pos: one reduce kernel)
    k5_per_call = _profile_ms(lambda i: lc._launch_segment(
        curs[i % CUR_COPIES], prevs[i], 20, True, reg, None, b_count),
        ("segment_kernel",), "K5 batched B=4 (_launch_segment)",
        per_call=True)
    _one_per_call({"K5 batched": k5_per_call})
    refill()
    k5_plain = _event_median_ms(
        lambda i: lc.fused_diff_compact_batched_reference(
            curs[i % CUR_COPIES], prevs[i], b_count, scheme="segment",
            overlay_region=reg), 3, backlog=False)

    tcfg = dataclasses.replace(cfg, tiled_payload=True)
    pipe = BatchedDeltaPipeline(tcfg, b_count)
    texts = ["CAM 0 FPS: 30", "CAM 1 FPS: 29", "", "CAM 3 BW: 1234 kbps"]
    pipe.step(prev0.clone(), cur, texts)  # warm-up
    refill()
    step_ms = _event_median_ms(
        lambda i: pipe.step(prevs[i], curs[i % CUR_COPIES], texts), ITERS)

    # bounds: each input read once, each output written once, per stream
    t_pad, t_unit = lc.tiled_geometry(n, 1)
    w_pad, w_unit = lc.tiled_geometry(n, 0)
    k1_bytes = b_count * (3 * n + 5 * t_pad + t_pad // t_unit + 4)
    k5_bytes = b_count * (3 * n + 5 * w_pad + 4 * (w_pad // w_unit))
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    k5_bound = k5_bytes / HBM_BYTES_PER_S * 1e3
    k1 = statistics.median(turns["batched"])
    log(f"[time] batched, 1080p, B={b_count}, pos per stream "
        f"{[int(p) for p in pos]} (~{int(pos.sum()) / (b_count * n):.2%}), "
        f"per-stream overlay strips of {strip} B, medians of {ITERS} (CUDA "
        f"events), in turns")
    log(f"[time] K1 batched subtile=1: "
        f"{' / '.join(f'{x:.4f}' for x in turns['batched'])} ms; four solo "
        f"K1 tiled launches {' / '.join(f'{x:.4f}' for x in turns['solo'])} "
        f"ms (bound {k1_bound:.4f} ms = {k1_bytes} B at 3.35 TB/s; batched "
        f"{k1_bound / k1:.1%} of it); its plain PyTorch version "
        f"{k1_plain:.4f} ms")
    log(f"[time] K5 batched: {k5:.4f} ms (bound {k5_bound:.4f} ms = "
        f"{k5_bytes} B; {k5_bound / k5:.1%} of it); its plain PyTorch "
        f"version {k5_plain:.4f} ms")
    log(f"[time] BatchedDeltaPipeline.step, B={b_count}, four overlay texts "
        f"(blends, strips, one K1 batched launch): {step_ms:.4f} ms device")
    return {"k1_ms": k1, "k1_solo4_ms": statistics.median(turns["solo"]),
            "k1_per_call": k1_per_call,
            "k1_plain_ms": k1_plain, "k1_bound_ms": k1_bound, "k5_ms": k5,
            "k5_per_call": k5_per_call,
            "k5_plain_ms": k5_plain, "k5_bound_ms": k5_bound,
            "step_ms": step_ms}


# -- the sharded slice: K1 index_offset and the sharded pipeline -------------

def _sharded_mesh(s):
    """A ``(1, s)`` mesh with every shard on ``cuda:0``: the one card
    holds S shards, which run one after another on its stream."""
    from cudavideostream_tpu_torch.parallel import make_mesh

    return make_mesh(s, devices=["cuda:0"] * s)


def _offset_k1(emit, sub, cur, prev, off, region, plain=False, tm=None,
               stores=None):
    """One K1 call in ``emit`` (flat, or tiled at ``sub``) with
    ``index_offset=off`` (and the per-byte map ``tm``, the counter
    ``stores``) on a copy of ``prev``; its outputs."""
    from cudavideostream_tpu_torch.ops import logcompact as lc

    kw = dict(overlay_region=region, index_offset=off, threshold_map=tm,
              prev_stores=stores)
    if emit == "flat":
        fn = lc.fused_diff_compact_reference if plain else lc.fused_diff_compact
        return fn(cur, prev.clone(), 20, True, **kw)
    fn = (lc.fused_diff_compact_tiled_reference if plain
          else lc.fused_diff_compact_tiled)
    return fn(cur, prev.clone(), 20, True, sub_rows=sub, **kw)


def phase_offset_vs_plain(cfg):
    """K1's ``index_offset`` mode at 1080p: flat and tiled (subtile 1, 8,
    0) on every shard of the frame cut into S = 2, 4 and 8 row shards, at
    two densities, the first shard with the overlay region, and at the
    largest offset int32 admits; every launch exact against its plain
    version and equal to the offset-free launch with the offset added to
    its valid entries only."""
    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED + 20)
    cases = 0
    emissions = (("flat", 0), ("tiled", 1), ("tiled", 8), ("tiled", 0))
    frames = {d: [torch.from_numpy(a).to(dev) for a in frame_pair(rng, n, d)]
              for d in (0.06, 0.5)}
    region_np = rng.integers(0, 256, 288_000, dtype=np.uint8)

    pcts = []

    def check(label, emit, sub, cur, prev, off, region, tm=None):
        s_k, s_p = _stores_pair()
        got = _offset_k1(emit, sub, cur, prev, off, region, tm=tm,
                         stores=s_k)
        labels = (("pos", "xs", "vals", "new_prev") if emit == "flat" else
                  ("pos", "counts", "xs_t", "vals_t", "new_prev"))
        _equal_or_raise(label, got + (s_k,),
                        _offset_k1(emit, sub, cur, prev, off, region,
                                   plain=True, tm=tm, stores=s_p) + (s_p,),
                        labels + ("prev_stores",))
        pcts.append(_stored_pct(s_k, cur.numel()))
        base = _offset_k1(emit, sub, cur, prev, 0, region, tm=tm)
        i = 1 if emit == "flat" else 2
        valid = got[i + 1] != 0
        shifted = torch.where(valid, base[i] + off, 0).to(torch.int32)
        if not torch.equal(got[i], shifted) or int(valid.sum()) != int(got[0]):
            raise AssertionError(f"{label}: not the offset-free launch "
                                 "shifted on its valid entries")

    for s_count in (2, 4, 8):
        ln = n // s_count
        for emit, sub in emissions:
            for d, (prev_full, cur_full) in frames.items():
                pcts.clear()
                for s in range(s_count):
                    cur = cur_full[s * ln:(s + 1) * ln].clone()
                    prev = prev_full[s * ln:(s + 1) * ln].clone()
                    region = (torch.from_numpy(region_np[:ln]).to(dev)
                              if s == 0 else None)
                    check(f"K1 index_offset S={s_count} shard {s}", emit, sub,
                          cur, prev, s * ln, region)
                    cases += 1
                log(f"[check] K1 index_offset {emit}"
                    f"{'' if emit == 'flat' else f' subtile={sub}'} "
                    f"S={s_count} d={d}: every shard base 0..{(s_count - 1) * ln}"
                    f" (Ln={ln}), shard 0 with the overlay region: exact "
                    f"against its plain version and equal to the offset-free "
                    f"launch shifted on valid entries only; {_stored(pcts)}")
    # the tiled emission's one launch with a per-byte map, every shard
    # base of S = 2, 4, 8, subtile 1 and 8
    prev_full, cur_full = frames[0.06]
    tm_full = torch.from_numpy(byte_map(rng, n)).to(dev)
    for s_count in (2, 4, 8):
        ln = n // s_count
        for sub in (1, 8):
            pcts.clear()
            for s in range(s_count):
                sl = slice(s * ln, (s + 1) * ln)
                check(f"K1 index_offset map S={s_count} shard {s}", "tiled",
                      sub, cur_full[sl].clone(), prev_full[sl].clone(),
                      s * ln, None, tm=tm_full[sl].clone())
                cases += 1
            log(f"[check] K1 index_offset tiled subtile={sub} S={s_count} "
                f"with a per-byte map: every shard base 0..{(s_count - 1) * ln}"
                f" (Ln={ln}): exact against its plain version and equal to "
                f"the offset-free launch shifted on valid entries only; "
                f"{_stored(pcts)}")
    from cudavideostream_tpu_torch.ops import logcompact as lc

    for emit, sub in emissions:
        big = (1 << 31) - lc.tiled_geometry(n, sub)[0] - 1
        pcts.clear()
        check("K1 index_offset large", emit, sub, cur_full, prev_full, big,
              None)
        cases += 1
        log(f"[check] K1 index_offset {emit}"
            f"{'' if emit == 'flat' else f' subtile={sub}'} at 1080p, offset "
            f"{big} (the largest int32 admits): exact, shifted on valid "
            f"entries only; {_stored(pcts)}")
    return cases


def phase_stores_on_scene():
    """K1's ``prev_stores`` on the benchmark's scene (``cvsbench/scene.py``
    with the ``cam1`` and ``cam4`` traffic, 4 frames a stream, chained):
    flat, tiled and bitmask-only at ``subtile_rows=1`` and batched over
    B = 4, each step exact against its plain version, the counter equal to
    the plain version's and the stored share of prev's vectors within
    5.5-6.5% (a band of 5.937% of the bytes changes a frame). Returns the
    cases."""
    from cudavideostream_tpu_torch.ops import logcompact as lc
    from cvsbench import scene

    cases = 0
    for traffic_name, emissions in (("cam1", ("flat", "tiled", "mask")),
                                    ("cam4", ("batched",))):
        with open(os.path.join("cvsbench", "traffic",
                               f"{traffic_name}.json")) as f:
            traffic = dict(json.load(f), bank_frames=4)
        b = int(traffic["streams"])
        bank, base = scene.make_bank(traffic, 1080, 1920, 2900029001, "cuda")
        n = base.shape[1]
        for emission in emissions:
            k1, plain = {
                "flat": (lc.fused_diff_compact,
                         lc.fused_diff_compact_reference),
                "tiled": (lc.fused_diff_compact_tiled,
                          lc.fused_diff_compact_tiled_reference),
                "mask": (lc.fused_diff_compact_mask,
                         lc.fused_diff_compact_mask_reference),
                "batched": (lc.fused_diff_compact_batched,
                            lc.fused_diff_compact_batched_reference),
            }[emission]
            args = (b, 20, True) if emission == "batched" else (20, True)
            kw = {} if emission == "flat" else dict(sub_rows=1)
            labels = ((("pos", "xs", "vals") if emission == "flat" else
                       ("pos", "counts", "blocks", "blocks"))
                      + ("new_prev", "prev_stores"))
            p_k, p_p = base.reshape(-1).clone(), base.reshape(-1).clone()
            stored = []
            for t in range(bank.shape[0]):
                cur = bank[t].reshape(-1)
                s_k, s_p = _stores_pair()
                got = k1(cur, p_k, *args, prev_stores=s_k, **kw)
                torch.cuda.synchronize()
                want = plain(cur, p_p, *args, prev_stores=s_p, **kw)
                _equal_or_raise(f"K1 {emission} on the {traffic_name} scene, "
                                f"frame {t}", got + (s_k,), want + (s_p,),
                                labels)
                stored.append(int(s_k))
                cases += 1
            pcts = [_stored_pct(v, n, b) for v in stored]
            if not 5.5 <= min(pcts) <= max(pcts) <= 6.5:
                raise AssertionError(f"K1 {emission} on the {traffic_name} "
                                     f"scene stored {pcts}% of prev's "
                                     "vectors, not 5.5-6.5%")
            log(f"[check] K1 {emission}"
                f"{'' if emission == 'flat' else ' subtile=1'}"
                f"{f' B={b}' if b > 1 else ''} on the benchmark scene "
                f"(cvsbench/scene.py, {traffic_name} traffic, seed "
                f"2900029001, {bank.shape[0]} frames chained): exact against "
                f"its plain version, prev_stores equal to the plain "
                f"version's; {_stored(pcts)} ({min(stored):,}..{max(stored):,}"
                f" of {b * -(-n // 16):,} a frame)")
    return cases


def _sharded_payload(pipe, out):
    """Host ``(pos, xs, vals)`` of one ``step_flat``'s outputs."""
    from cudavideostream_tpu_torch.parallel.sharded import gather
    from cudavideostream_tpu_torch.runtime import wire

    if pipe.payload_layout == "sharded":
        counts = gather(out[1])
        tp = wire.TiledPayload(int(counts.sum(dtype=np.int64)), counts,
                               gather(out[2]), gather(out[3]))
        return (tp.pos, *tp.to_flat())
    pos = int(out[1])
    xs, vals = out[2].cpu().numpy(), out[3].cpu().numpy()
    if xs[pos:].any() or vals[pos:].any():
        raise AssertionError("the replicated payload is not zero past pos")
    return pos, xs[:pos], vals[:pos]


def phase_sharded_steps(cfg):
    """``ShardedDeltaPipeline.step_flat`` at 1080p on S = 1, 2, 4, 8 shards
    laid on ``cuda:0``, both payload layouts, with visualizers 0, 3 and 5,
    the noise filter and the door map, each against ``step_oracle``: the
    state, the payload and the aux frame; K1 launched S times a step."""
    from cudavideostream_tpu_torch.ops import logcompact as lc
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.config import Visualizer
    from cudavideostream_tpu_torch.parallel import ShardedDeltaPipeline
    from cudavideostream_tpu_torch.parallel.sharded import gather
    from cudavideostream_tpu_torch.utils import fonts

    rng = np.random.default_rng(SEED + 21)
    n = cfg.frame_bytes
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    door = np.repeat(door_map(cfg, rng).ravel(), 3)
    text = "FPS: 30 BW: 1234 kbps"
    variants = (("visualizer 0", {}, None),
                ("visualizer 3", {"visualizer": Visualizer.RED_OVERLAP}, None),
                ("visualizer 5", {"visualizer": Visualizer.BINARIZE}, None),
                ("noise filter", {"noise_filter": True}, None),
                ("door map", {}, door))
    steps = 0
    for s in (1, 2, 4, 8):
        for layout in ("sharded", "replicated"):
            for label, kw, tm in variants:
                c = dataclasses.replace(cfg, **kw)
                pipe = ShardedDeltaPipeline(c, _sharded_mesh(s),
                                            payload_layout=layout,
                                            threshold_map=tm)
                st = pipe.init_state_flat(prev_np)
                counters = _zero_launches()
                out = pipe.step_flat(st, cur_np, text=text)
                torch.cuda.synchronize()
                k1 = (lc.fused_diff_compact_tiled if layout == "sharded"
                      else lc.fused_diff_compact)
                got = {name: counters[name].launches for name in (
                    "histogram", "binarize_pipeline", "gray_hist",
                    "binarize_apply", "convolve_q16", "red_visualizer")}
                # K9's two launches a shard: the histogram is summed
                # between them
                k9 = s if c.visualizer == Visualizer.BINARIZE else 0
                want = {"histogram": 0, "binarize_pipeline": 0,
                        "gray_hist": k9, "binarize_apply": k9,
                        "convolve_q16": s if c.noise_filter else 0,
                        "red_visualizer":
                            s if c.visualizer == Visualizer.RED_OVERLAP
                            else 0}
                if k1.launches != s or got != want:
                    raise AssertionError(f"sharded step S={s}: K1 launched "
                                         f"{k1.launches} times, {got}")
                pos, xs, vals = _sharded_payload(pipe, out)
                e_prev, e_pos, e_xs, e_vals, e_aux = reference_cpu.step_oracle(
                    prev_np, cur_np, c, atlas=pipe.atlas_np,
                    char_ids=fonts.encode_text(text), threshold_map=tm)
                aux = None if out[4] is None else gather(out[4])
                if not (pos == e_pos and np.array_equal(xs, e_xs)
                        and np.array_equal(vals, e_vals)
                        and np.array_equal(gather(out[0]), e_prev)
                        and (aux is None if e_aux is None
                             else np.array_equal(aux, e_aux))):
                    raise AssertionError(f"sharded step S={s} {layout} "
                                         f"{label}: differs from step_oracle")
                steps += 1
                log(f"[check] sharded step S={s} on cuda:0, {layout} layout, "
                    f"{label}: step_flat at 1080p == step_oracle (pos={pos}, "
                    f"aux {'none' if aux is None else 'equal'}; K1 "
                    f"{k1.__name__} launched {s}x"
                    + "".join(f", {name} {v}x" for name, v in got.items() if v)
                    + ")")
    return steps


def phase_sharded_times(cfg):
    """The sharded step (``"sharded"`` layout, the ``server --mesh`` step)
    at S = 1, 2, 4, 8 on ``cuda:0`` against the solo tiled
    ``pipeline.step``, in turns; the per-shard K1 tiled launch with
    ``index_offset`` (subtile 1) at S = 4 and 8 against its plain version
    and its bound on ``Ln`` bytes. Shards on one card run one after
    another on its stream: these times show no interconnect and no
    scaling."""
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import logcompact as lc
    from cudavideostream_tpu_torch.parallel import ShardedDeltaPipeline

    dev = torch.device("cuda")
    n = cfg.frame_bytes
    rng = np.random.default_rng(SEED + 22)
    prev_np, cur_np = frame_pair(rng, n, 0.06)
    cur = torch.from_numpy(cur_np).to(dev)
    curs = [cur.clone() for _ in range(CUR_COPIES)]
    text = "FPS: 30 BW: 1234 kbps"
    tcfg = dataclasses.replace(cfg, tiled_payload=True)
    solo = DeltaStreamPipeline(tcfg)
    solo_prev0 = solo.init_state(prev_np)
    pipes = {s: ShardedDeltaPipeline(cfg, _sharded_mesh(s),
                                     payload_layout="sharded")
             for s in (1, 2, 4, 8)}
    states = {s: [p.init_state_flat(prev_np) for _ in range(30)]
              for s, p in pipes.items()}
    solo_prevs = [solo_prev0.clone() for _ in range(30)]
    prev_t = torch.from_numpy(prev_np).to(dev)

    def refill():
        for p in solo_prevs:
            p.copy_(solo_prev0)
        for s, sts in states.items():
            ln = n // s
            for st in sts:
                for k, t in enumerate(st):
                    t.copy_(prev_t[k * ln:(k + 1) * ln])

    solo.step(solo_prev0.clone(), cur, text=text)  # warm-up
    for p in pipes.values():
        p.step_flat(p.init_state_flat(prev_np), cur, text=text)
    turns = {}
    order = ["solo", 1, 2, 4, 8]
    for key in order + order[::-1]:
        refill()
        if key == "solo":
            fn = lambda i: solo.step(solo_prevs[i], curs[i % CUR_COPIES],
                                     text=text)
        else:
            fn = (lambda i, k=key: pipes[k].step_flat(
                states[k][i], curs[i % CUR_COPIES], text=text))
        turns.setdefault(key, []).append(_event_median_ms(fn, 30))
    k1 = {}
    for s in (4, 8):
        ln = n // s
        shard = s - 1  # the last shard: the largest offset of the mesh
        c0 = cur[shard * ln:(shard + 1) * ln].clone()
        cs = [c0.clone() for _ in range(CUR_COPIES)]
        p0 = prev_t[shard * ln:(shard + 1) * ln].clone()
        ps = [p0.clone() for _ in range(ITERS)]
        ms = _event_median_ms(lambda i: lc.fused_diff_compact_tiled(
            cs[i % CUR_COPIES], ps[i], 20, True, None, 1,
            index_offset=shard * ln), ITERS)
        plain = _event_median_ms(lambda i: lc.fused_diff_compact_tiled_reference(
            cs[i % CUR_COPIES], p0.clone(), 20, True, None, 1,
            index_offset=shard * ln), 10, backlog=False)
        per_call = _profile_ms(lambda i: lc.fused_diff_compact_tiled(
            cs[i % CUR_COPIES], ps[i], 20, True, None, 1,
            index_offset=shard * ln), ("tiled_unit_kernel",),
            f"K1 tiled index_offset S={s}", per_call=True)
        _one_per_call({f"K1 tiled index_offset S={s}": per_call})
        t_pad, t_unit = lc.tiled_geometry(ln, 1)
        nbytes = 3 * ln + 5 * t_pad + t_pad // t_unit + 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        k1[s] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                 "per_call": per_call}
        log(f"[time] K1 tiled subtile=1 with index_offset={shard * ln} (S={s}, "
            f"shard {shard}, Ln={ln}): {ms:.4f} ms (bound {bound:.5f} ms = "
            f"{nbytes} B at 3.35 TB/s; {bound / ms:.1%} of it); its plain "
            f"PyTorch version {plain:.4f} ms")
    med = {k: statistics.median(v) for k, v in turns.items()}
    log(f"[time] the served step at 1080p, overlay text, medians of 30 (CUDA "
        f"events), in turns: solo tiled pipeline.step "
        f"{' / '.join(f'{x:.4f}' for x in turns['solo'])} ms; sharded "
        f"step_flat on cuda:0: " + "; ".join(
            f"S={s} {' / '.join(f'{x:.4f}' for x in turns[s])} ms"
            for s in (1, 2, 4, 8))
        + " (shards on one card run one after another: no interconnect, no "
          "scaling)")
    return {"k1": k1, "step_ms": med}


# -- the camera path: file, prefetch and device sources, the native library --

CAMERA_FILE_FRAMES = 16  # frames in the served .npy clip
CAMERA_SERVED = 20  # frames each run serves: the clip loops


@contextlib.contextmanager
def _patched(obj, name, value):
    """``obj.name = value`` for the duration of the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class _TimedSource:
    """A source, each frame it gives timed on the host clock."""

    def __init__(self, inner):
        self.inner, self.next_s = inner, []

    def __iter__(self):
        return self

    def base_frame(self):
        return self.inner.base_frame()

    def __next__(self):
        t0 = time.perf_counter()
        frame = next(self.inner)
        self.next_s.append(time.perf_counter() - t0)
        return frame

    def close(self):
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()


def _state_sum(state):
    """The C client's digest of one state: the sum of its bytes."""
    return int(state.sum(dtype=np.uint64))


def _frames_before_serving(argv):
    """The frames ``server.main(argv)`` takes from its source before it
    serves: one where it starts a device executor on the source's base
    frame, as the JAX server does (``server.py:526-533``): under
    ``--link-cache`` or ``--calibrate`` (default 2), unless ``--resume``,
    ``--mesh`` or ``--backend oracle``; else none."""
    def value(flag, default):
        return argv[argv.index(flag) + 1] if flag in argv else default

    warmable = "--mesh" not in argv and value("--backend", "") != "oracle"
    asked = "--link-cache" in argv or int(value("--calibrate", 2))
    return int(warmable and bool(asked) and "--resume" not in argv)


class _ClipOracle:
    """``step_oracle``'s states for a looping file clip served from its
    frame ``first`` (the base frame), per sequence of overlay texts (one a
    served frame): each state's sha256 and byte sum, and the last
    state."""

    def __init__(self, cfg, frames, atlas):
        self.cfg, self.frames, self.atlas = cfg, frames, atlas
        self._memo = {}

    def states(self, texts, first=0):
        from cudavideostream_tpu_torch.ops import reference_cpu
        from cudavideostream_tpu_torch.utils import fonts

        key = (first, tuple(texts))
        if key not in self._memo:
            prev = self.frames[first]
            digests = [hashlib.sha256(prev).hexdigest()]
            sums, positions = [_state_sum(prev)], []
            for k, text in enumerate(texts, start=first + 1):
                prev, pos = reference_cpu.step_oracle(
                    prev, self.frames[k % len(self.frames)], self.cfg,
                    atlas=self.atlas, char_ids=fonts.encode_text(text))[:2]
                digests.append(hashlib.sha256(prev).hexdigest())
                sums.append(_state_sum(prev))
                positions.append(pos)
            self._memo[key] = {"digests": digests, "sums": sums,
                               "positions": positions, "last": prev}
        return self._memo[key]


def _py_client(port, cfg):
    """The port's Python client: the base frame's and every state's
    sha256 until the server closes, and the wire it decoded."""
    from cudavideostream_tpu_torch.runtime.client import DeltaStreamClient

    t0 = time.perf_counter()
    cli = DeltaStreamClient("127.0.0.1", port, cfg.height, cfg.width)
    cli.connect()
    cli.sock.settimeout(120)
    base = hashlib.sha256(cli.frame).hexdigest()
    digests = []
    _digest_reader(cli, digests)
    return {"kind": "python", "base": base, "states": digests,
            "wire": cli.wire_format, "s": time.perf_counter() - t0}


def _c_client(port, cfg):
    """The native C client (the reference client's v1 read loop):
    frames decoded, the last state and the sum of every state's bytes."""
    from cudavideostream_tpu_torch import native

    t0 = time.perf_counter()
    frames, last, digest = native.client_decode_np(
        "127.0.0.1", port, cfg.frame_bytes, 10**6, timeout=120)
    return {"kind": "C", "frames": frames, "last": last, "digest": digest,
            "s": time.perf_counter() - t0}


def _check_client(label, got, want, n_served):
    """A client's states against the oracle's: from the state it joined
    at (its base frame) to the last, every one."""
    if got["kind"] == "python":
        if got["base"] not in want["digests"]:
            raise AssertionError(f"{label}: the Python client's base frame "
                                 "is no oracle state")
        k = want["digests"].index(got["base"])
        if got["states"] != want["digests"][k + 1:]:
            raise AssertionError(f"{label}: the Python client's states != "
                                 "step_oracle's")
        return n_served - k
    frames = got["frames"]
    k = n_served - frames
    if (frames < 1 or not np.array_equal(got["last"], want["last"])
            or got["digest"] != sum(want["sums"][k + 1:])):
        raise AssertionError(f"{label}: the C client's reconstruction != "
                             f"step_oracle's ({frames} frames)")
    return frames


@contextlib.contextmanager
def _counted_sends():
    """Count, for the duration of the block, the frames each native wire
    path sends: ``payload`` (``wire_send_payload_fd``), ``segments``
    (``wire_send_segments_fd``), and the v3 encodes off ``TiledPayload``
    blocks (``v3_tiled``) or off flat arrays (``v3_flat``)."""
    from cudavideostream_tpu_torch import native
    from cudavideostream_tpu_torch.runtime import wire

    sends = {"payload": 0, "segments": 0, "v3_tiled": 0, "v3_flat": 0}

    def counted(key, fn):
        def call(*a, **kw):
            sends[key] += 1
            return fn(*a, **kw)
        return call

    def v3(pos, xs, *a, **kw):
        sends["v3_tiled" if isinstance(xs, wire.TiledPayload)
              else "v3_flat"] += 1
        return real_v3(pos, xs, *a, **kw)

    real_v3 = wire._native_v3
    with _patched(native, "wire_send_payload_fd",
                  counted("payload", native.wire_send_payload_fd)), \
            _patched(native, "wire_send_segments_fd",
                     counted("segments", native.wire_send_segments_fd)), \
            _patched(wire, "_native_v3", v3):
        yield sends


def _serve_file_main(argv, client, cfg):
    """``server.main(argv)`` in a thread, its executor wrapped in a
    ``_RecordingExecutor`` and its source timed, with ``client(port, cfg)``
    once it listens. Returns what the run recorded."""
    from cudavideostream_tpu_torch.runtime import server as server_mod

    made, errors = {}, []
    listening = threading.Event()
    real_setup, real_make = server_mod.setup, server_mod.make_source

    def setup(a=None):
        cfg_, ex, source, args = real_setup(a)
        made["inner"], made["rec"] = ex, _RecordingExecutor(ex)
        return cfg_, made["rec"], source, args

    def make_source(*a, **kw):
        made["source"] = _TimedSource(real_make(*a, **kw))
        return made["source"]

    class Server(server_mod.DeltaStreamServer):
        def listen(self):
            sock = super().listen()
            made["port"] = self.port
            listening.set()
            return sock

    def run():
        try:
            server_mod.main(argv)
        except BaseException as e:
            errors.append(e)
            listening.set()

    with _patched(server_mod, "setup", setup), \
            _patched(server_mod, "make_source", make_source), \
            _patched(server_mod, "DeltaStreamServer", Server):
        counters = _zero_launches()  # counts of this run only
        t0 = time.perf_counter()
        th = threading.Thread(target=run, name="smoke-file", daemon=True)
        th.start()
        if not listening.wait(120) or errors:
            raise errors[0] if errors else RuntimeError("no listen")
        got = client(made["port"], cfg)
        th.join(timeout=120)
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    if th.is_alive():
        raise RuntimeError(f"{argv}: the server did not finish")
    if errors:
        raise errors[0]
    return dict(made, got=got, wall=wall, launches=launches)


def _serve_multi_file(path, cfg, n_frames, streams=4, device="cuda"):
    """``multiserve.main --streams 4 --source file --path``: the port's
    Python client on streams 0 and 1, the C client on 2 and 3; each
    stream's server states recorded."""
    from cudavideostream_tpu_torch.runtime import multiserve

    made, errors = {}, []
    listening = threading.Event()

    class Server(multiserve.MultiStreamServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.pipe = _RecordingBatchedPipe(self.pipe)
            made["server"] = self

        def listen(self):
            super().listen()
            made["ports"] = self.ports
            listening.set()

    def run():
        try:
            multiserve.main(["--streams", str(streams), "--source", "file",
                             "--path", path, "--frames", str(n_frames),
                             "--port", "0", "--device", device, "--height",
                             str(cfg.height), "--width", str(cfg.width)])
        except BaseException as e:
            errors.append(e)
            listening.set()

    with _patched(multiserve, "MultiStreamServer", Server):
        counters = _zero_launches()
        t0 = time.perf_counter()
        th = threading.Thread(target=run, name="smoke-multifile",
                              daemon=True)
        th.start()
        if not listening.wait(120) or errors:
            raise errors[0] if errors else RuntimeError("no listen")
        got = [None] * streams
        readers = [threading.Thread(
            target=lambda b=b: got.__setitem__(b, (
                _py_client if b < 2 else _c_client)(made["ports"][b], cfg)),
            daemon=True) for b in range(streams)]
        for r in readers:
            r.start()
        th.join(timeout=300)
        for r in readers:
            r.join(timeout=60)
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    if th.is_alive() or any(r.is_alive() for r in readers):
        raise RuntimeError("multiserve --source file: the server or a "
                           "client did not finish")
    if errors:
        raise errors[0]
    return dict(made, got=got, wall=wall, launches=launches)


def _send_ms(send, iters=15):
    """Median host time of ``send(sock)`` on one end of a socketpair
    whose other end a thread drains (1 MiB reads)."""
    a, b = socket.socketpair()
    for s in (a, b):
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 << 20)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    b.settimeout(120)

    def drain():
        buf = bytearray(1 << 20)
        while b.recv_into(buf):
            pass

    th = threading.Thread(target=drain, daemon=True)
    th.start()
    times = []
    with a, b:
        for _ in range(iters):
            t0 = time.perf_counter()
            send(a)
            times.append(time.perf_counter() - t0)
        a.shutdown(socket.SHUT_WR)
        th.join(timeout=60)
    return statistics.median(times) * 1e3


def _sent_bytes(send):
    """The bytes ``send(sock)`` writes on one end of a socketpair, read
    whole on the other by a thread."""
    a, b = socket.socketpair()
    b.settimeout(120)
    got = bytearray()

    def read():
        while chunk := b.recv(1 << 20):
            got.extend(chunk)

    th = threading.Thread(target=read, daemon=True)
    th.start()
    with a, b:
        send(a)
        a.shutdown(socket.SHUT_WR)
        th.join(timeout=60)
        if th.is_alive():
            raise RuntimeError("the socketpair's reader did not finish")
    return bytes(got)


def _host_ms(fn, iters=15):
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_wire_host_times(cfg, smi, device="cuda"):
    """The native senders and encoder against the NumPy path the port
    used before them, on K1 tiled (``subtile_rows=1``) payloads of two
    1080p frame pairs, the synthetic scene and ~6% scattered changes, in
    turns (native, NumPy, NumPy, native), host-clock medians of 15: the
    v1 send of the tiled blocks (``wire_send_segments_fd`` against
    ``to_flat`` + ``pack_payload`` + ``sendall``), of the flat payload
    (``wire_send_payload_fd`` against ``pack_payload`` + ``sendall``), and
    the v3 encode (``V3Encoder.encode`` in C off the blocks against
    ``to_flat``, the shadow apply and ``encode_frame_v3_numpy``). Each
    native sender's bytes are read back once and held against the NumPy
    packers'."""
    from cudavideostream_tpu_torch import native
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.runtime import wire
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    tcfg = dataclasses.replace(cfg, tiled_payload=True, subtile_rows=1)
    pipe = DeltaStreamPipeline(tcfg, device=device)
    scene = SyntheticSource(cfg, seed=SEED)
    pairs = {"scene": (scene.base_frame(), next(scene)),
             "6% scattered": frame_pair(np.random.default_rng(SEED + 12),
                                        cfg.frame_bytes, 0.06)}
    out = {}
    for label, (prev_np, cur_np) in pairs.items():
        _, pos, counts, xs_t, vals_t, _ = pipe.step(pipe.init_state(prev_np),
                                                   cur_np)
        tp = wire.TiledPayload(int(pos), counts.cpu().numpy(),
                               xs_t.cpu().numpy(), vals_t.cpu().numpy())
        xs, vals = tp.to_flat()
        nonempty = int(np.count_nonzero(tp.counts))
        after = prev_np.copy()
        after[xs] += vals
        if (wire.V3Encoder(prev_np).encode(tp.pos, tp, None)
                != wire.encode_frame_v3_numpy(tp.pos, xs, vals, after)):
            raise AssertionError(f"{label}: the C v3 encode differs from "
                                 "the NumPy spec")

        def segments(sock, tp=tp):
            if native.wire_send_segments_fd(sock.fileno(), tp.pos, tp.counts,
                                            tp.xs, tp.vals):
                raise BrokenPipeError("writev")

        def tiled_sendall(sock, tp=tp):
            sock.sendall(tp.to_wire_bytes())

        def flat_writev(sock, tp=tp, xs=xs, vals=vals):
            if native.wire_send_payload_fd(sock.fileno(), tp.pos, xs, vals):
                raise BrokenPipeError("writev")

        def flat_sendall(sock, tp=tp, xs=xs, vals=vals):
            sock.sendall(wire.pack_payload(tp.pos, xs, vals))

        # what the timed native senders put on the socket, once
        if _sent_bytes(segments) != tp.to_wire_bytes():
            raise AssertionError(f"{label}: wire_send_segments_fd's bytes "
                                 "differ from to_wire_bytes()")
        if _sent_bytes(flat_writev) != wire.pack_payload(tp.pos, xs, vals):
            raise AssertionError(f"{label}: wire_send_payload_fd's bytes "
                                 "differ from pack_payload")

        enc = wire.V3Encoder(prev_np)
        shadow = prev_np.copy()

        def v3_numpy(tp=tp, shadow=shadow):
            fx, fv = tp.to_flat()
            shadow[fx] += fv
            wire.encode_frame_v3_numpy(tp.pos, fx, fv, shadow)

        turns = {"segments": [], "tiled_sendall": [], "flat_writev": [],
                 "flat_sendall": [], "v3_c": [], "v3_numpy": []}
        for native_first in (True, False):
            for name, fn in (("segments", segments),
                             ("tiled_sendall", tiled_sendall),
                             ("flat_writev", flat_writev),
                             ("flat_sendall", flat_sendall))[
                                 ::1 if native_first else -1]:
                turns[name].append(_send_ms(fn))
            for name, fn in (("v3_c", lambda: enc.encode(tp.pos, tp, None)),
                             ("v3_numpy", v3_numpy))[
                                 ::1 if native_first else -1]:
                turns[name].append(_host_ms(fn))
        out[label] = dict(turns, pos=tp.pos, nonempty_units=nonempty)
        log(f"[time] wire on the host, {label} (pos {tp.pos}, "
            f"{tp.counts.size} units of 128 B, {nonempty} not empty): v1 "
            f"tiled wire_send_segments_fd {_pair(turns['segments'])} ms "
            f"against "
            f"to_flat + pack_payload + sendall "
            f"{_pair(turns['tiled_sendall'])}; v1 flat wire_send_payload_fd "
            f"{_pair(turns['flat_writev'])} against pack_payload + sendall "
            f"{_pair(turns['flat_sendall'])}; v3 C encode off the blocks "
            f"{_pair(turns['v3_c'])} against to_flat + NumPy "
            f"{_pair(turns['v3_numpy'])} (socketpair, a thread draining; "
            f"host-clock medians of 15, in turns; {smi}); both native "
            "senders' bytes read back equal to the NumPy packers'")
    return out


def _pair(values):
    return " / ".join(f"{v:.3f}" for v in values)


def phase_camera_path(cfg, smi, device="cuda"):
    """The camera path at 1080p: a 16-frame ``.npy`` clip of the
    synthetic scene served by ``server.main --source file`` (flat wire v1,
    the same with ``--prefetch``, ``--tiled --fetch tiles`` through the
    segments sender, and the same under ``--wire v3`` through the C
    encoder off the tiled blocks), each v1 run decoded once by the port's
    Python client and once by the native C client, every state equal to
    ``step_oracle``'s, K1 launched once a served frame and every frame
    sent by the native function its label names; ``multiserve
    --streams 4 --source file`` (Python clients on two streams, C clients
    on two); the device generator on the card against the same function
    on the CPU, and chained into ``pipeline.step``; and the native
    library's ``v4l2_open`` on a path that does not exist (a camera, if
    the machine has one, grabs 4 frames)."""
    from cudavideostream_tpu_torch import native
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.runtime.sources import (
        SyntheticSource,
        V4L2Source,
        device_synthetic_frames,
    )

    n = CAMERA_SERVED
    scene = SyntheticSource(cfg, seed=SEED)
    frames = np.stack([next(scene) for _ in range(CAMERA_FILE_FRAMES)])
    oracle = _ClipOracle(cfg, frames, DeltaStreamPipeline(
        cfg, device="cpu").atlas_np)
    runs = {}
    none = dict.fromkeys(_launch_counters(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.npy")
        np.save(path, frames.reshape(-1, cfg.height, cfg.width, 3))
        base = ["--source", "file", "--path", path, "--frames", str(n),
                "--port", "0", "--device", device, "--height",
                str(cfg.height), "--width", str(cfg.width)]
        v1, pf = ("file_v1", []), ("file_v1_prefetch", ["--prefetch"])
        tiled = ["--tiled", "--fetch", "tiles"]
        # with and without --prefetch in turns, each by both clients
        for (key, flags), client in (
                (v1, _py_client), (pf, _py_client), (pf, _c_client),
                (v1, _c_client), (pf, _py_client), (v1, _py_client),
                (("file_tiled_tiles_v1", tiled), _py_client),
                (("file_tiled_tiles_v1", tiled), _c_client),
                (("file_tiled_tiles_v3", tiled + ["--wire", "v3"]),
                 _py_client)):
            label = "server --source file " + " ".join(flags or ["(v1)"])
            with _counted_sends() as sends:
                run = _serve_file_main(base + flags, client, cfg)
            rec = run["rec"]
            if len(rec.texts) != n:
                raise AssertionError(f"{label}: served {len(rec.texts)} "
                                     f"of {n} frames")
            # the base frame is the clip's frame 1: the server started its
            # executor on frame 0, as the JAX server does
            want = oracle.states(rec.texts,
                                 first=_frames_before_serving(base + flags))
            if rec.digests != want["digests"][1:]:
                raise AssertionError(f"{label}: the server's states != "
                                     "step_oracle's")
            _check_client(label, run["got"], want, n)
            is_tiled = "--tiled" in flags
            _expect_launches(run | {"frames": n}, label, {
                **none,
                "fused_diff_compact_tiled" if is_tiled
                else "fused_diff_compact": n})
            # every frame lands as tiles and leaves by the named sender
            want_sends = dict.fromkeys(sends, 0)
            want_sends[("v3_tiled" if "v3" in flags else "segments")
                       if is_tiled else "payload"] = n
            if sends != want_sends:
                raise AssertionError(f"{label}: sent by {sends}, not "
                                     f"{want_sends}")
            if is_tiled and run["inner"].fetch_counts != {
                    "tiles": n, "flat": 0, "mask": 0}:
                raise AssertionError(f"{label}: landings "
                                     f"{run['inner'].fetch_counts}")
            fps = n / run["got"]["s"]
            src_ms = statistics.median(run["source"].next_s) * 1e3
            proc_ms = statistics.median(rec.process_s) * 1e3
            log(f"[serve] {label}: {n} frames at 1080p from a "
                f"{CAMERA_FILE_FRAMES}-frame .npy, looped, decoded by "
                f"the {run['got']['kind']} client, byte-exact every frame "
                f"against step_oracle; {fps:.2f} fps from the client's "
                f"connect to the stream's end ({1e3 / fps:.2f} ms a "
                f"frame, the per-frame state digests included; "
                f"{n / run['wall']:.2f} fps with the server's start); "
                f"source {src_ms:.4f} ms, executor.process "
                f"{proc_ms:.2f} ms (host-clock medians; {smi}); sent by "
                + ", ".join(f"{k}={v}" for k, v in sends.items() if v)
                + "; kernel launches: "
                + ", ".join(f"{k}={v}" for k, v in run["launches"].items()
                            if v))
            if run["got"]["kind"] == "python" and run["got"]["wire"] != (
                    "v3" if "v3" in flags else "v1"):
                raise AssertionError(f"{label}: decoded the wrong wire")
            runs.setdefault(key, []).append(
                {"client": f"{run['got']['kind']} client", "fps": fps,
                 "source_ms": src_ms, "process_ms": proc_ms,
                 "frames": n, "launches": run["launches"],
                 "sends": dict(sends)})
        log("[serve] the C client reads wire v1 only (the reference "
            "client's loop): the v3 run is decoded by the Python client; "
            "with and without --prefetch were served in turns")

        n_multi = 16
        run = _serve_multi_file(path, cfg, n_multi, device=device)
        server = run["server"]
        rec = server.pipe
        for b, got in enumerate(run["got"]):
            texts = [t[b] for t in rec.texts]
            want = oracle.states(texts)
            if [d[b] for d in rec.digests] != want["digests"][1:]:
                raise AssertionError(f"multiserve --source file: stream {b}'s "
                                     "server states != step_oracle's")
            seen = _check_client(f"multiserve stream {b}", got, want, n_multi)
            log(f"[serve] multiserve --streams 4 --source file stream {b}: "
                f"{seen} of {n_multi} frames at 1080p through the "
                f"{got['kind']} client, byte-exact against step_oracle")
        _expect_launches(run | {"frames": n_multi}, "multiserve --source file",
                         {**none, "fused_diff_compact_batched": n_multi,
                          "pair_compact": server.fetch_counts["flat"]})
        log(f"[serve] multiserve --streams 4 --source file: "
            f"{n_multi / run['wall']:.2f} batched frames/s wall ({4 * n_multi / run['wall']:.2f} stream "
            f"frames/s; {smi}); landings {server.fetch_counts}; kernel "
            "launches: " + ", ".join(f"{k}={v}" for k, v in
                                     run["launches"].items() if v))
        runs["multiserve_file"] = [{"client": "python and C clients",
                                    "fps": n_multi / run["wall"],
                                    "frames": n_multi,
                                    "launches": run["launches"]}]

    # the device generator: the card's frames against the CPU's
    gen = {}
    pipe = DeltaStreamPipeline(cfg, device=device)
    for bank in (0, 8):
        init_c, next_c = device_synthetic_frames(cfg, seed=0, noise_bank=bank,
                                                 device=device)
        init_h, next_h = device_synthetic_frames(cfg, seed=0, noise_bank=bank,
                                                 device="cpu")
        if not torch.equal(init_c.cpu(), init_h):
            raise AssertionError(f"device_synthetic_frames bank {bank}: the "
                                 "background differs on the card")
        for t in range(8):
            if not torch.equal(next_c((SEED, t), t).cpu(),
                               next_h((SEED, t), t)):
                raise AssertionError(f"device_synthetic_frames bank {bank}: "
                                     f"frame {t} differs on the card")
        prev_np = next_h((SEED, 7), 7).numpy()
        frame = next_c((SEED, 8), 8)
        out = pipe.step(pipe.init_state(prev_np), frame)
        e_prev, e_pos, e_xs, e_vals = reference_cpu.step_oracle(
            prev_np, frame.cpu().numpy(), cfg)[:4]
        pos, xs, vals = _payload_host(cfg, out)
        if not (pos == e_pos and np.array_equal(xs, e_xs)
                and np.array_equal(vals, e_vals)
                and np.array_equal(out[0].cpu().numpy(), e_prev)):
            raise AssertionError(f"device_synthetic_frames bank {bank}: the "
                                 "chained step differs from step_oracle")
        gen_ms = _event_median_ms(lambda i: next_c((SEED, i), i), 30)
        state = pipe.init_state(prev_np)
        step_ms = _event_median_ms(
            lambda i: pipe.step(state, next_c((SEED, i), i)), 30)
        gen[bank] = {"ms": gen_ms, "with_step_ms": step_ms}
        log(f"[check] device_synthetic_frames noise_bank={bank} at 1080p: "
            f"the first 8 frames on cuda == on the CPU, byte for byte; "
            f"frame 8 chained into pipeline.step == step_oracle (pos={pos})")
        log(f"[time] device_synthetic_frames noise_bank={bank}: "
            f"{gen_ms:.4f} ms a frame; with pipeline.step {step_ms:.4f} ms "
            f"(CUDA events, medians of 30; {smi})")

    # the camera: the real library on a path that is not there
    lib = native.load()
    missing = os.path.join(tempfile.gettempdir(), "cvstpu-no-such-video")
    rc = lib.v4l2_open(missing.encode(), cfg.width, cfg.height)
    if rc != -2:  # -ENOENT
        raise AssertionError(f"v4l2_open on a missing path gave {rc}, "
                             "not -ENOENT")
    log(f"[v4l2] v4l2_open({missing}) = {rc} (-ENOENT), as expected")
    if os.path.exists("/dev/video0"):
        with V4L2Source(cfg) as cam:
            grabbed = [next(cam) for _ in range(4)]
        if any(f.shape != (cfg.frame_bytes,) for f in grabbed):
            raise AssertionError("v4l2: a grabbed frame has the wrong size")
        log("[v4l2] /dev/video0: 4 frames grabbed at 1080p")
    else:
        log("[v4l2] no camera on this machine")
    return {"runs": runs, "generator": gen}


BACKEND_SERVED = 16  # frames each run of the backends phase serves
ORACLE_SERVED = 6  # frames the NumPy oracle backend serves at 1080p


class _TextsExecutor:
    """The executor the server's command line built, recording each
    frame's overlay text, ``process`` time and (under HOST) the bytes its
    pipeline brought from the card; every other attribute is the
    executor's own, so the command line still sees ``load_state``,
    ``save_link_cache`` and the rest."""

    def __init__(self, inner):
        self.inner = inner
        self.texts, self.process_s, self.fetched = [], [], []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def process(self, frame, text=""):
        self.texts.append(text)
        t0 = time.perf_counter()
        out = self.inner.process(frame, text=text)
        self.process_s.append(time.perf_counter() - t0)
        pipe = getattr(self.inner, "pipe", None)
        self.fetched.append(getattr(pipe, "last_fetch_bytes", None))
        return out


def _serve_main(argv, client, trace=False):
    """``server.main(argv)`` in a thread, its executor recorded
    (``_TextsExecutor``) and its aux sink kept, with ``client(port,
    made)`` once it listens; with ``trace``, the stream runs under the
    profiler and the card's busy time is returned. Returns what the run
    recorded."""
    from cudavideostream_tpu_torch.runtime import server as server_mod

    made, errors = {}, []
    listening = threading.Event()
    real_setup, real_sink = server_mod.setup, server_mod.AuxStreamSink

    def setup(a=None):
        cfg_, ex, source, args = real_setup(a)
        made["inner"], made["rec"] = ex, _TextsExecutor(ex)
        return cfg_, made["rec"], source, args

    def sink(*a, **kw):
        made["sink"] = real_sink(*a, **kw)
        return made["sink"]

    class Server(server_mod.DeltaStreamServer):
        def listen(self):
            sock = super().listen()
            made["port"] = self.port
            listening.set()
            return sock

    def run():
        try:
            server_mod.main(argv)
        except BaseException as e:
            errors.append(e)
            listening.set()

    with _patched(server_mod, "setup", setup), \
            _patched(server_mod, "AuxStreamSink", sink), \
            _patched(server_mod, "DeltaStreamServer", Server):
        counters = _zero_launches()  # counts of this run only
        th = threading.Thread(target=run, name="smoke-backends", daemon=True)
        th.start()
        if not listening.wait(300) or errors:
            raise errors[0] if errors else RuntimeError(f"{argv}: no listen")
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if trace
            else contextlib.nullcontext())
        with prof:
            t0 = time.perf_counter()  # the profiler's start-up left out
            got = client(made["port"], made)
            th.join(timeout=300)
            wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    if th.is_alive():
        raise RuntimeError(f"{argv}: the server did not finish")
    if errors:
        raise errors[0]
    busy = _busy_and_overlap(prof) if trace else None
    return dict(made, got=got, wall=wall, launches=launches,
                busy_ms=None if busy is None else busy[0])


def _chain_digests(cfg, base, frames, start, texts, atlas, aux=False):
    """``step_oracle`` from ``base`` over ``frames[(start + k) % len]``
    with the k-th text: the sha256 of the base and of every state (and of
    every aux frame with ``aux``)."""
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.utils import fonts

    prev = base
    states, auxes = [hashlib.sha256(prev).hexdigest()], []
    for k, text in enumerate(texts):
        prev, _, _, _, a = reference_cpu.step_oracle(
            prev, frames[(start + k) % len(frames)], cfg, atlas=atlas,
            char_ids=fonts.encode_text(text))
        states.append(hashlib.sha256(prev).hexdigest())
        if aux:
            auxes.append(hashlib.sha256(a).hexdigest())
    return states, auxes


def _check_states(label, got, want):
    """The Python client's base frame and every state against the
    oracle's digests, from the base on."""
    if got["base"] != want[0] or got["states"] != want[1:]:
        raise AssertionError(f"{label}: the client's states != step_oracle's "
                             f"({len(got['states'])} of {len(want) - 1})")


def _replayed(path, cfg):
    """``ReplayServer`` re-serving a recorded session to the Python client
    (the base frame's and every state's sha256)."""
    from cudavideostream_tpu_torch.runtime.replay import ReplayServer

    replay = ReplayServer(path, cfg.frame_bytes, port=0, verbose=False)
    replay.listen()
    th = threading.Thread(target=replay.serve, name="smoke-replay",
                          daemon=True)
    th.start()
    got = _py_client(replay.port, cfg)
    th.join(timeout=120)
    replay.close()
    if th.is_alive():
        raise RuntimeError("the replay server did not finish")
    return got


def _idle(run, device_work=True):
    """The card's idle share over a traced run, and its log text. A run
    with no device work (the NumPy oracle) is idle throughout; elsewhere a
    trace without device records is not a measurement."""
    busy = run["busy_ms"]
    if busy is None:
        if not device_work:
            return 1.0, "no device activity in the trace, idle 100%"
        return None, "the profiler saw no device activity: idle not measured"
    share = 1 - busy / (run["wall"] * 1e3)
    return share, f"device busy {busy:.3f} ms in all, idle {share:.1%}"


def phase_backends_and_extras(cfg, smi, device="cuda"):
    """The slice of the last modules at 1080p, on a 16-frame ``.npy``
    clip of the synthetic scene served by ``server.main --source file``:
    the SORT and HOST backends (a step each against ``step_oracle``, then
    served, the HOST fast path and its noise-filter path, with no
    kernel launched and n/8 bytes from the card a frame on the fast
    path), the NumPy oracle backend, the live aux stream under
    ``--visualizer 1`` and ``5``, ``--save-state`` then ``--resume``,
    ``--link-cache`` written and reloaded, ``--calibrate 2``, the client's
    ``--record`` (re-served by ``ReplayServer``), ``--save``, ``--ppm`` and
    ``--http``, and ``median_filter`` at k = 3, 5, 7 against
    ``reference_cpu``. Every served state is checked against
    ``step_oracle``, every kernel's launches counted."""
    import urllib.request

    from cudavideostream_tpu_torch import native
    from cudavideostream_tpu_torch.config import (
        CompactionBackend,
        Visualizer,
    )
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import convolve, diff, reference_cpu
    from cudavideostream_tpu_torch.runtime import auxstream
    from cudavideostream_tpu_torch.runtime import client as client_mod
    from cudavideostream_tpu_torch.runtime import server as server_mod
    from cudavideostream_tpu_torch.runtime.executor import StreamExecutor
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource
    from cudavideostream_tpu_torch.utils import fonts

    n = BACKEND_SERVED
    scene = SyntheticSource(cfg, seed=SEED + 20)
    frames = np.stack([next(scene) for _ in range(CAMERA_FILE_FRAMES)])
    atlas = fonts.make_atlas(cfg.overlay_scale, cfg.overlay_font)
    none = dict.fromkeys(_launch_counters(), 0)
    out = {"runs": {}}

    # -- the SORT and HOST steps against step_oracle, and their times ----
    nf_cfg = dataclasses.replace(cfg, noise_filter=True)
    for label, c in (
            ("sort", dataclasses.replace(
                cfg, compaction=CompactionBackend.SORT)),
            ("host", dataclasses.replace(
                cfg, compaction=CompactionBackend.HOST)),
            ("host --noise-filter", dataclasses.replace(
                nf_cfg, compaction=CompactionBackend.HOST))):
        pipe = DeltaStreamPipeline(c, device=device)
        prev, oprev = pipe.init_state(frames[0]), frames[0]
        counters = _zero_launches()
        for k, text in enumerate(["", "FPS: 30", "FPS: 31"], start=1):
            o = pipe.step(prev, frames[k], text=text)
            oprev, opos, oxs, ovals = reference_cpu.step_oracle(
                oprev, frames[k], c, atlas=atlas,
                char_ids=fonts.encode_text(text))[:4]
            pos = int(o[1])
            xs = o[2] if isinstance(o[2], np.ndarray) else o[2].cpu().numpy()
            vals = (o[3] if isinstance(o[3], np.ndarray)
                    else o[3].cpu().numpy())
            if not (pos == opos and np.array_equal(xs[:pos], oxs)
                    and np.array_equal(vals[:pos], ovals)
                    and np.array_equal(prev.cpu().numpy(), oprev)):
                raise AssertionError(f"{label} step {k} != step_oracle")
            if label == "sort" and (xs[pos:].any() or vals[pos:].any()):
                raise AssertionError("the sort payload is not zero past pos")
        # the noise filter runs K8 on the card under every backend, and
        # HOST its device step, K10, once a step
        want = {"convolve_q16": 3 if c.noise_filter else 0,
                "diff_pack": 3 if label.startswith("host") else 0}
        got = {name: fn.launches for name, fn in counters.items()
               if fn.launches}
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{label}: the steps launched {got}")
        log(f"[check] {label} pipeline.step at 1080p: 3 steps with overlay "
            f"texts == step_oracle (pos, xs, vals, new_prev); kernel "
            f"launches: " + (", ".join(f"{k}={v}" for k, v in got.items())
                             or "none"))
    # the host's pack at the clip's density, and what it brings over
    cur, prev_h = frames[2], frames[1].copy()
    mask, delta, _ = diff.diff_mask(torch.from_numpy(cur),
                                    torch.from_numpy(prev_h), cfg.threshold)
    bits = diff.pack_bitmask(mask).numpy()
    delta = delta.numpy()
    pack = {"update": _host_ms(lambda: native.compact_update_np(
                cur, prev_h, bits)),
            "bitmask": _host_ms(lambda: native.compact_bitmask_np(
                delta, bits))}
    out["host_pack_ms"] = pack
    out["host_pos"] = int(mask.sum())
    log(f"[time] HOST pack on the host at 1080p, pos={out['host_pos']} "
        f"({out['host_pos'] / cfg.frame_bytes:.2%}): compact_update_np (fast "
        f"path) {pack['update']:.3f} ms, compact_bitmask_np (noise-filter "
        f"path) {pack['bitmask']:.3f} ms (host-clock medians of 15; {smi}); "
        f"from the card per frame {bits.nbytes} B of bits (fast), "
        f"{bits.nbytes + delta.nbytes} B with the delta")
    dev_frames = [torch.from_numpy(f).to(device) for f in frames[:2]]
    steps = {"pallas": [], "sort": []}
    pipes = {label: DeltaStreamPipeline(
        dataclasses.replace(cfg, compaction=comp), device=device)
        for label, comp in (("pallas", CompactionBackend.PALLAS),
                            ("sort", CompactionBackend.SORT))}
    for _ in range(2):
        for label, pipe in pipes.items():
            state = pipe.init_state(frames[0])
            steps[label].append(_event_median_ms(
                lambda i: pipe.step(state, dev_frames[i % 2]), 30))
    out["sort_step_ms"], out["pallas_step_ms"] = steps["sort"], steps["pallas"]
    log(f"[time] pipeline.step at 1080p on the clip's first two frames, "
        f"by turns (pallas, then sort, twice): sort "
        f"{_pair(steps['sort'])} ms, pallas {_pair(steps['pallas'])} ms "
        f"(CUDA events, medians of 30; {smi})")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.npy")
        np.save(path, frames.reshape(-1, cfg.height, cfg.width, 3))
        base = ["--source", "file", "--path", path, "--frames", str(n),
                "--port", "0", "--device", device, "--height",
                str(cfg.height), "--width", str(cfg.width)]
        py = lambda port, made: _py_client(port, cfg)  # noqa: E731

        def served(key, label, argv, c=cfg, frames_n=n, trace=False,
                   client=py, want=None):
            """One run of ``server.main``, every state byte-exact against
            the oracle's; its launches, fps and (traced) idle share."""
            run = _serve_main(argv, client, trace=trace)
            rec = run["rec"]
            if len(rec.texts) != frames_n:
                raise AssertionError(f"{label}: served {len(rec.texts)} of "
                                     f"{frames_n} frames")
            first = _frames_before_serving(argv)
            states = _chain_digests(c, frames[first], frames, first + 1,
                                    rec.texts, atlas)[0]
            if run["got"] is not None and "states" in run["got"]:
                _check_states(label, run["got"], states)
            if want is not None:
                _expect_launches(run | {"frames": frames_n}, label,
                                 {**none, **want})
            fps = frames_n / run["wall"]
            share, idle = (_idle(run, "--backend" not in argv) if trace
                           else (None, "not traced"))
            log(f"[serve] {label}: {frames_n} frames at 1080p from the "
                f"clip, byte-exact every frame against step_oracle; "
                f"{fps:.2f} fps from the client's connect to the stream's "
                f"end; executor.process "
                f"{statistics.median(rec.process_s) * 1e3:.2f} ms "
                f"(host-clock median); {idle} ({smi}); kernel launches: "
                + (", ".join(f"{k}={v}" for k, v in run["launches"].items()
                             if v) or "none"))
            out["runs"][key] = {"frames": frames_n, "fps": fps,
                                "idle": share, "launches": run["launches"],
                                "process_ms": statistics.median(
                                    rec.process_s) * 1e3}
            return run, states

        # -- the backends, served ----------------------------------------
        served("sort", "server --compaction sort",
               base + ["--compaction", "sort"], trace=True, want={})
        run, _ = served("host", "server --compaction host",
                        base + ["--compaction", "host"], trace=True,
                        want={"diff_pack": n})
        if set(run["rec"].fetched) != {(cfg.frame_bytes + 7) // 8}:
            raise AssertionError("HOST fast path: the card sent "
                                 f"{set(run['rec'].fetched)} B a frame, not "
                                 f"{(cfg.frame_bytes + 7) // 8}")
        log(f"[check] server --compaction host: every frame brought "
            f"{(cfg.frame_bytes + 7) // 8} B (n/8, the bitmask) from the "
            f"card and nothing else")
        run, _ = served("host_noise_filter",
                        "server --compaction host --noise-filter",
                        base + ["--compaction", "host", "--noise-filter"],
                        c=nf_cfg, trace=True,
                        want={"convolve_q16": n, "diff_pack": n})
        if set(run["rec"].fetched) != {cfg.frame_bytes
                                       + (cfg.frame_bytes + 7) // 8}:
            raise AssertionError("HOST noise-filter path: the card sent "
                                 f"{set(run['rec'].fetched)} B a frame")
        served("oracle", "server --backend oracle",
               base[:4] + ["--frames", str(ORACLE_SERVED)] + base[6:]
               + ["--backend", "oracle"], frames_n=ORACLE_SERVED,
               trace=True, want={})

        # -- the live aux stream ------------------------------------------
        for vis in (1, 5):
            vcfg = dataclasses.replace(cfg, visualizer=Visualizer(vis))
            received = []

            def aux_client(port, made, received=received):
                aux = auxstream.AuxStreamClient("127.0.0.1",
                                                made["sink"].port)
                aux.connect()
                if (aux.height, aux.width) != (cfg.height, cfg.width):
                    raise AssertionError("aux stream: wrong geometry")

                def read():
                    try:
                        while True:
                            idx, f = aux.read_frame()
                            received.append(
                                (idx, hashlib.sha256(f).hexdigest()))
                    except (ConnectionError, OSError):
                        pass
                    finally:
                        aux.close()

                th = threading.Thread(target=read, daemon=True)
                th.start()
                _wait_until(lambda: made["sink"].n_clients == 1,
                            "the aux viewer")
                got = _py_client(port, cfg)
                th.join(timeout=120)
                if th.is_alive():
                    raise RuntimeError("the aux reader did not finish")
                return got

            label = f"server --visualizer {vis} --aux-port 0"
            run, _ = served(f"aux_vis{vis}", label, base + [
                "--visualizer", str(vis), "--aux-port", "0"], c=vcfg,
                client=aux_client, want={
                    "fused_diff_compact": n,
                    "heatmap": n if vis == 1 else 0,
                    "binarize_pipeline": n if vis == 5 else 0})
            first = _frames_before_serving(base)
            auxes = _chain_digests(vcfg, frames[first], frames, first + 1,
                                   run["rec"].texts, atlas, aux=True)[1]
            if not received or any(d != auxes[i] for i, d in received):
                raise AssertionError(f"{label}: the aux stream's frames != "
                                     "step_oracle's aux frames")
            if [i for i, _ in received] != sorted({i for i, _ in received}):
                raise AssertionError(f"{label}: aux frames out of order")
            out["runs"][f"aux_vis{vis}"]["aux_received"] = len(received)
            log(f"[check] {label}: an AuxStreamClient received "
                f"{len(received)} of {n} aux frames (latest-wins), each "
                f"equal to step_oracle's aux frame of its index")

        # -- --save-state, then --resume ----------------------------------
        ckpt = os.path.join(tmp, "state.npz")
        served("save_state", "server --save-state", base + [
            "--save-state", ckpt], want={"fused_diff_compact": n})
        saved = np.load(ckpt)["prev"]
        run = _serve_main(base + ["--resume", ckpt], py)
        want = _chain_digests(cfg, saved, frames, 0, run["rec"].texts,
                              atlas)[0]
        _check_states("server --resume", run["got"], want)
        _expect_launches(run | {"frames": n}, "server --resume",
                         {**none, "fused_diff_compact": n})
        out["runs"]["resume"] = {"frames": n, "fps": n / run["wall"],
                                 "launches": run["launches"]}
        log(f"[check] server --resume: the joining client's base frame is "
            f"the saved state ({hashlib.sha256(saved).hexdigest()[:12]}), "
            f"and its {n} states equal step_oracle's from it, byte for byte")

        # -- --link-cache, written and reloaded; --calibrate --------------
        cache = os.path.join(tmp, "link.json")
        loads = []
        real_load = StreamExecutor.load_link_cache

        def load(self, p):
            ok = real_load(self, p)
            loads.append((ok, self.copy_rate))
            return ok

        with _patched(StreamExecutor, "load_link_cache", load):
            for i, extra in enumerate(([], ["--calibrate", "0"])):
                run, _ = served(f"link_cache_{i + 1}",
                                f"server --tiled --link-cache (run {i + 1})",
                                base + ["--tiled", "--link-cache", cache]
                                + extra)
                fc = run["inner"].fetch_counts
                _expect_launches(run | {"frames": n}, "--link-cache", {
                    **none, "fused_diff_compact_tiled": n,
                    "pair_compact": fc["flat"]})
                with open(cache) as f:
                    data = json.load(f)
                if i == 0:
                    first = data
        if not (loads[0][0] is False and loads[1] == (True, first["bps"])):
            raise AssertionError(f"--link-cache: loads {loads}, saved "
                                 f"{first['bps']}")
        out["link_cache"] = {"saved_bps": first["bps"],
                             "extra_s": first["lander"]["extra_s"]}
        log(f"[check] --link-cache: run 1 saved copy rate {first['bps']:.0f} "
            f"B/s and extra times {first['lander']['extra_s']}; run 2 "
            f"(--calibrate 0) loaded it and its lander started from that "
            f"rate; both runs byte-exact")
        _, ex, _, _ = server_mod.setup(["--port", "0", "--calibrate", "2",
                                        "--device", device])
        out["calibrated_bps"] = ex.copy_rate
        if not ex.copy_rate or ex.copy_rate <= 0:
            raise AssertionError("--calibrate 2 measured no copy rate")
        log(f"[time] --calibrate 2: 2 pinned copies of 512 KiB from the "
            f"card on the landing stream, copy rate {ex.copy_rate:.0f} B/s "
            f"({ex.copy_rate / 1e9:.2f} GB/s; {smi})")

        # -- the client's --record, --save, --ppm and --http --------------
        rec_path = os.path.join(tmp, "session.cvs")
        save_path = os.path.join(tmp, "frames.npy")
        ppm = os.path.join(tmp, "f")

        def client_main(port, made):
            rc = client_mod.main(["--port", str(port), "--height",
                                  str(cfg.height), "--width", str(cfg.width),
                                  "--record", rec_path, "--save", save_path,
                                  "--ppm", ppm, "--ppm-every", "5"])
            if rc != 0:
                raise AssertionError(f"client.main returned {rc}")

        run, states = served("client_extras",
                             "client --record --save --ppm --ppm-every 5",
                             base, client=client_main,
                             want={"fused_diff_compact": n})
        replay = _replayed(rec_path, cfg)
        _check_states("ReplayServer of client --record", replay, states)
        saved_frames = np.load(save_path)
        if [hashlib.sha256(f).hexdigest() for f in saved_frames] != states[1:]:
            raise AssertionError("client --save: the frames != the states")
        ppms = sorted(x for x in os.listdir(tmp) if x.endswith(".ppm"))
        want_ppm = [f"f_{k:06d}.ppm" for k in range(1, n + 1, 5)]
        if ppms != want_ppm or not np.array_equal(_ppm_bgr(
                os.path.join(tmp, ppms[0]), cfg.height, cfg.width),
                saved_frames[0]):
            raise AssertionError(f"client --ppm: wrote {ppms}")
        log(f"[check] client --record: ReplayServer re-served the "
            f"{os.path.getsize(rec_path)} B session byte-exact ({n} states "
            f"== step_oracle's); --save wrote the {n} states; --ppm "
            f"--ppm-every 5 wrote {len(ppms)} viewable P6 images, the first "
            f"equal to state 1")
        relayed = os.path.join(tmp, "relayed.cvs")

        def http_client(port, made):
            """``client --http``'s relay in front of the server: its page,
            then ``/stream`` read to the end and kept."""
            relay = client_mod.make_http_relay(
                0, "127.0.0.1", port, cfg.height, cfg.width, timeout=120,
                listen_host="127.0.0.1")
            url = f"http://127.0.0.1:{relay.server_address[1]}"
            rth = threading.Thread(target=relay.serve_forever, daemon=True)
            rth.start()
            try:
                with urllib.request.urlopen(url + "/", timeout=120) as r:
                    html = r.read()
                with urllib.request.urlopen(url + "/stream",
                                            timeout=120) as r, \
                        open(relayed, "wb") as f:
                    f.write(r.read())
            finally:
                relay.shutdown()
                relay.server_close()
                rth.join(timeout=30)
            if (f'id="w" value="{cfg.width}"'.encode() not in html
                    or f'id="h" value="{cfg.height}"'.encode() not in html):
                raise AssertionError("client --http: / is not the viewer at "
                                     "this geometry")
            return {"html": len(html)}

        run, states = served("http_relay", "client --http (/, /stream)",
                             base, client=http_client,
                             want={"fused_diff_compact": n})
        html = run["got"]["html"]
        _check_states("client --http /stream", _replayed(relayed, cfg),
                      states)
        log(f"[check] client --http: / served examples/viewer.html at "
            f"{cfg.width}x{cfg.height} ({html} B); /stream relayed the "
            f"server's wire bytes, which decode to step_oracle's {n} states")

    # -- median_filter -----------------------------------------------------
    frame_d = torch.from_numpy(frames[3]).to(device)
    med = {}
    for k in (3, 5, 7):
        got = convolve.median_filter(frame_d, k, cfg.height, cfg.width)
        want = reference_cpu.median_filter(frames[3], k, cfg.height,
                                           cfg.width)
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError(f"median_filter k={k} != reference_cpu")
        if k < 7:
            med[k] = [_event_median_ms(lambda i: convolve.median_filter(
                frame_d, k, cfg.height, cfg.width), 10, backlog=False)
                for _ in range(2)]
    out["median_ms"] = med
    log(f"[check] median_filter k=3, 5, 7 at 1080p on the card == "
        f"reference_cpu.median_filter, byte for byte")
    log(f"[time] median_filter at 1080p: k=3 {_pair(med[3])} ms, k=5 "
        f"{_pair(med[5])} ms (CUDA events, medians of 10, twice; {smi})")
    return out


BENCH_FRAMES, BENCH_ITERS = 16, 5  # the headline runs: T steps, replays
VARIANT_FRAMES, VARIANT_ITERS = 8, 3  # the --all-variants run
BENCH_JSON_KEYS = {"metric", "value", "unit", "vs_baseline"}
BENCH_STDERR_KEYS = ("bench: card", "byte-exact vs oracle", "fps samples",
                     "peak device memory", "FAILED", "wrote")


def _bench_cli(argv, timeout):
    """``python -m cudavideostream_tpu_torch.bench ARGV`` from the root of
    the checkout: it must exit 0, pass its gate and print exactly one
    JSON line with the JAX bench's keys. Logs its stderr's result lines;
    returns the line's record."""
    cmd = [sys.executable, "-m", "cudavideostream_tpu_torch.bench", *argv]
    shown = "python -m cudavideostream_tpu_torch.bench " + " ".join(argv)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if any(k in line for k in BENCH_STDERR_KEYS):
            log(f"[bench]   {line}")
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"{shown}: rc {proc.returncode}, {len(lines)} "
                             f"stdout lines:\n{proc.stdout}\n{proc.stderr}")
    if "[headline] byte-exact vs oracle: OK" not in proc.stderr:
        raise AssertionError(f"{shown}: its gate did not pass")
    rec = json.loads(lines[0])
    if (set(rec) != BENCH_JSON_KEYS
            or rec["metric"] != "1080p_fps_per_chip_diff_encode_compact"
            or not rec["value"] > 0):
        raise AssertionError(f"{shown}: bad result line {lines[0]}")
    log(f"[bench] {shown}: exit 0 in {secs:.1f} s, gate byte-exact against "
        f"step_oracle; {lines[0]}")
    return rec


def _bench_bytes(vcfg):
    """The bytes one bench step must move at ``vcfg``, from one step's
    outputs: the generator's plane read and frame write (2n), K1's read
    of cur and prev and its writes (new_prev, pos, counts, the payload
    blocks, the bits) and the digest's reads of the payload (and of the
    aux frame)."""
    from cudavideostream_tpu_torch import bench

    chain = bench.BenchChain(vcfg, bench.TEXT, 1)
    out = chain.pipe.step(chain.init.clone(), chain.frame(0), bench.TEXT)
    _, _, xs, vals, aux = bench.payload_parts(vcfg, out)
    n = vcfg.frame_bytes
    outputs = out[1:-1]  # pos, counts, the blocks, the bits (not aux)
    k1 = 3 * n + sum(t.nbytes for t in outputs)
    digest = xs.nbytes + vals.nbytes + (0 if aux is None else aux.nbytes)
    return {"generator": 2 * n, "k1": k1, "digest": digest,
            "total": 2 * n + k1 + digest}


def _op_name(key):
    """A profiler key's kernel name, with the functor a generic PyTorch
    kernel runs: ``void at::native::vectorized_elementwise_kernel<4,
    at::native::BitwiseAndFunctor<bool>, ...>(...)`` ->
    ``vectorized_elementwise_kernel[BitwiseAndFunctor]``."""
    head = key.replace("(anonymous namespace)::", "")
    head = head[len("void "):] if head.startswith("void ") else head
    base = head.split("<")[0].split("(")[0].split("::")[-1].strip()
    for tail in ("Functor|functor", "_kernel_cuda|_kernel_impl"):
        inner = [w for w in re.findall(rf"(\w+(?:{tail}))\b", head)
                 if w != base]
        if inner:
            return f"{base}[{inner[0]}]"
    return base


def _replay_breakdown(g, label, step_ms, replays=3):
    """Device time per step of each kernel of a bench graph, from a
    profiler trace of ``replays`` replays (the profiler may lose
    records: the line says how many it kept), against the step's
    CUDA-event time ``step_ms``: the rest is the gaps between the
    graph's nodes. Returns ``{kernel: ms a step}``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(replays):
            g.replay()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    steps = replays * g.k
    by_name, kept = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = _op_name(e.key)
            ms, count = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + e.device_time_total / 1e3 / steps,
                             count + e.count)
            kept += e.count
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    busy = sum(ms for ms, _ in by_name.values())
    log(f"[bench] {label}: where a replayed step's {step_ms:.4f} ms go "
        f"(profiler over {replays} replays, {kept} device records kept): "
        f"kernels and copies {busy:.4f} ms, gaps {step_ms - busy:.4f} ms; "
        + "; ".join(f"{name} {ms:.4f} ms x{c / steps:g}"
                    for name, (ms, c) in rows[:12]))
    return {name: ms for name, (ms, _) in rows}


def phase_bench(cfg, smi):
    """The headline bench: ``python -m cudavideostream_tpu_torch.bench``
    with ``--emit tiled`` and ``flat`` and ``--all-variants`` (one
    process per variant), each gated byte-exact against step_oracle;
    then, in this process with the launch counts set to 0 before each
    run, the tiled, flat, binarize and tiled bank-0 runs whose captured
    CUDA graph must hold T K1 nodes (and T K4 nodes under binarize),
    whose replays must equal the eager steps (under bank 0 each replay
    reads the key words refilled before it), and whose fps times the
    bytes a step must move must stay under the card's 3.35 TB/s; then
    the measurement utils (:func:`_bench_utils`)."""
    from cudavideostream_tpu_torch import bench
    from cudavideostream_tpu_torch.config import Visualizer

    log(f"[bench] {smi}")
    cli = {}
    for emit in ("tiled", "flat"):
        cli[emit] = _bench_cli(["--frames", str(BENCH_FRAMES), "--iters",
                                str(BENCH_ITERS), "--emit", emit], 600)
    cli["all_variants"] = _bench_cli(
        ["--all-variants", "--frames", str(VARIANT_FRAMES), "--iters",
         str(VARIANT_ITERS)], 600)
    with open(bench.VARIANTS_JSON) as f:
        table = json.load(f)
    from cudavideostream_tpu_torch.models import variants

    if sorted(table) != variants.available() or not all(
            v > 0 for v in table.values()):
        raise AssertionError(f"--all-variants table {table}")
    log(f"[bench] --all-variants --frames {VARIANT_FRAMES} --iters "
        f"{VARIANT_ITERS}: every variant's process passed its gate; fps "
        + ", ".join(f"{k} {v}" for k, v in table.items()) + f" ({smi})")

    tcfg = dataclasses.replace(cfg, tiled_payload=True)
    runs, out = {}, {"cli": cli, "variants": table}
    k1_tiled = {"fused_diff_compact_tiled": "tiled_unit_kernel"}
    for label, vcfg, frames, iters, bank, want in (
            ("tiled", tcfg, BENCH_FRAMES, BENCH_ITERS, 8, k1_tiled),
            ("flat", cfg, BENCH_FRAMES, BENCH_ITERS, 8,
             {"fused_diff_compact": "flat_lookback_kernel"}),
            ("binarize", dataclasses.replace(
                tcfg, visualizer=Visualizer.BINARIZE),
             VARIANT_FRAMES, VARIANT_ITERS, 8,
             {**k1_tiled, "binarize_pipeline": "binarize_fused_kernel"}),
            ("tiled bank 0", tcfg, VARIANT_FRAMES, VARIANT_ITERS, 0,
             k1_tiled)):
        nbytes = _bench_bytes(vcfg)
        census = {}

        def on_capture(g):
            kinds, names = _graph_nodes(g.graph)
            census.update(kinds=kinds, names=names, graph=g)

        counters = _zero_launches()
        res = bench.run_config(vcfg, bench.TEXT, frames, iters,
                               label=f"bench {label}", noise_bank=bank,
                               on_capture=on_capture)
        launches = {k: fn.launches for k, fn in counters.items()}
        # the gate, two warm-up passes, the capture, and the iters + 1
        # eager passes that check the replays: each a wrapper call that
        # launches (a replay calls no wrapper)
        calls = 1 + 3 * frames + (iters + 1) * frames
        _expect_launches({"launches": launches, "frames": frames},
                         f"bench {label}",
                         {**dict.fromkeys(counters, 0),
                          **dict.fromkeys(want, calls)})
        names = census["names"]
        if any(n is None for n in names):
            raise AssertionError(f"bench {label}: the CUDA driver did not "
                                 f"name every kernel node of the graph")
        nodes = {k: sum(kern in n for n in names)
                 for k, kern in want.items()}
        for k, got in nodes.items():
            if got != frames:
                raise AssertionError(f"bench {label}: the graph of {frames} "
                                     f"steps holds {got} {want[k]} nodes")
        tbps = res["fps"] * nbytes["total"] / 1e12
        log(f"[bench] {label}: the CUDA graph of {frames} steps holds "
            f"{sum(census['kinds'].values())} nodes ({census['kinds'].get(0, 0)} "
            f"kernel, {census['kinds'].get(2, 0)} memset), among them "
            + ", ".join(f"{want[k]} x{v}" for k, v in nodes.items())
            + f"; {res['fps']:.2f} fps replayed (CUDA events, median of "
            f"{iters} replays: "
            + ", ".join(f"{x:.2f}" for x in res["samples"])
            + f") against {res['eager_fps']:.2f} fps launched eagerly ("
            + ", ".join(f"{x:.2f}" for x in res["eager_samples"])
            + f"; every replay == the eager steps); peak "
            f"{res['peak_bytes']} B of device memory; {smi}")
        log(f"[bench] {label}: a step must move {nbytes['total']} B "
            f"(generator {nbytes['generator']}, K1 {nbytes['k1']}, digest "
            f"{nbytes['digest']}): {res['fps']:.2f} fps x {nbytes['total']} "
            f"B = {tbps:.4f} TB/s, {tbps / (HBM_BYTES_PER_S / 1e12):.1%} of "
            f"3.35 TB/s")
        if tbps * 1e12 > HBM_BYTES_PER_S:
            raise AssertionError(f"bench {label}: {tbps:.3f} TB/s is more "
                                 f"than the card moves: work was skipped")
        g = census.pop("graph")
        breakdown = _replay_breakdown(g, label, 1e3 / res["fps"])
        # every replay of the graph: its upload, the timed ones, one
        # before each eager pass and the profiler's
        runs[f"bench {label}"] = {"launches": launches, "frames": frames,
                                  "graph_nodes": nodes,
                                  "replays": g.replays}
        out[label] = {"fps": res["fps"], "eager_fps": res["eager_fps"],
                      "samples": res["samples"],
                      "eager_samples": res["eager_samples"],
                      "peak_bytes": res["peak_bytes"], "bytes": nbytes,
                      "tbps": tbps, "kernels_ms_per_step": breakdown}
    out["utils"] = _bench_utils(tcfg, out["tiled"]["fps"], smi, runs)
    out["runs"] = runs
    return out


def _bench_utils(tcfg, fps, smi, runs):
    """The port's measurement utils on the card, over the bench's tiled
    steps, with the launch counts set to 0 first: ``bench_scan_chain``
    (its ms a step within 2x of ``1e3 / fps``, the tiled run's replays
    of the same steps), one eager step inside ``profiling.trace`` and
    ``annotate`` (its ``trace.json`` must hold K1's CUDA kernel record
    and the span), and ``bench_op``, ``bench_op_amortized`` and
    ``measure_rtt`` on the device generator (which launches no kernel of
    the port). Adds the run to ``runs``; returns the times."""
    from cudavideostream_tpu_torch import bench
    from cudavideostream_tpu_torch.utils import profiling, timing

    counters = _zero_launches()
    chain = bench.BenchChain(tcfg, bench.TEXT, BENCH_FRAMES)
    ticks = iter(range(1 << 30))

    def one(prev):
        # frames 0 .. T-1 in turn: the capture follows whole warm-up
        # passes, so the graph holds t = 0 .. T-1 as the bench's does
        return chain.step(prev, next(ticks) % BENCH_FRAMES)

    carry = chain.init.clone()
    ms = timing.bench_scan_chain(one, carry, k=BENCH_FRAMES,
                                 iters=BENCH_ITERS)
    ratio = ms * fps / 1e3
    if not 0.5 < ratio < 2.0:
        raise AssertionError(f"bench_scan_chain: {ms:.4f} ms a step, "
                             f"{ratio:.2f}x the tiled run's replays")
    # the profiler on the card now and then loses a trace's records: a
    # trace without K1's record or the span is taken again, five at most
    for traced in range(1, 6):
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp):
                time.sleep(PROFILE_PAD_S)
                with profiling.annotate("bench step"):
                    chain.step(carry, 0)
                torch.cuda.synchronize()
                time.sleep(PROFILE_PAD_S)
            with open(os.path.join(tmp, profiling.TRACE_FILE)) as f:
                events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        if (any("tiled_unit_kernel" in k for k in kernels)
                and any(e.get("name") == "bench step" for e in events)):
            break
        log(f"[bench] profiling.trace on the card: no K1 kernel record or "
            f"no span among {len(events)} events ({len(kernels)} kernel "
            f"records) in trace {traced}" + (": traced again"
                                             if traced < 5 else ""))
    else:
        raise AssertionError("profiling.trace on the card: no K1 kernel "
                             "record or no span in 5 traces")
    launches = {k: fn.launches for k, fn in counters.items()}
    _expect_launches(
        {"launches": launches, "frames": BENCH_FRAMES}, "bench scan_chain",
        {**dict.fromkeys(counters, 0), "fused_diff_compact_tiled":
         (timing.ChainGraph.WARMUP_PASSES + 1) * BENCH_FRAMES + traced})
    runs["bench scan_chain"] = {"launches": launches,
                                "frames": BENCH_FRAMES, "graph_nodes": {}}
    op_ms = timing.bench_op(chain.frame, 0)
    amortized_ms = timing.bench_op_amortized(chain.frame, 0)
    rtt_s = timing.measure_rtt(chain.init)
    if not (op_ms > 0 and amortized_ms >= 0 and rtt_s > 0):
        raise AssertionError(f"bench_op {op_ms}, bench_op_amortized "
                             f"{amortized_ms}, measure_rtt {rtt_s}")
    log(f"[bench] utils on the card: bench_scan_chain {ms:.4f} ms a tiled "
        f"step ({BENCH_FRAMES} steps a graph, {BENCH_ITERS} replays; "
        f"{ratio:.3f}x the tiled run's); profiling.trace (trace {traced}) holds "
        f"{len(kernels)} CUDA kernel records, K1's and the annotated span "
        f"among them; the device generator: bench_op {op_ms:.4f} ms, "
        f"bench_op_amortized {amortized_ms:.4f} ms; measure_rtt "
        f"{rtt_s * 1e6:.1f} us ({smi})")
    return {"scan_chain_ms": ms, "scan_chain_ratio": ratio,
            "trace_kernel_records": len(kernels), "bench_op_ms": op_ms,
            "bench_op_amortized_ms": amortized_ms, "measure_rtt_s": rtt_s}


# the port's kernels each row of the kernel table launches a step: its
# launch counter and, per counter, the graph's kernel nodes of one step
# (K1's whole-tile chunk path, subtile_rows=0, is two kernels)
_K1_CHUNKS = ("tiled_chunk_count_kernel", "tiled_chunk_compact_kernel")
_K1_UNIT, _K1_FLAT = ("tiled_unit_kernel",), ("flat_lookback_kernel",)
_K4 = {"histogram": ("hist_kernel",)}
_K8 = {"convolve_q16": ("conv_kernel",)}
_K9 = {"binarize_pipeline": ("binarize_fused_kernel",)}
# K13's two weightings are instances of one template, vis_kernel<Op>
_VIS = ("vis_kernel",)
TABLE_KERNELS = {
    "diff+compact_tiled": {"fused_diff_compact_tiled": _K1_CHUNKS},
    "diff+compact_subtiled1": {"fused_diff_compact_tiled": _K1_UNIT},
    "diff+compact_subtiled1_clustered": {"fused_diff_compact_tiled": _K1_UNIT},
    "diff+compact_subtiled8": {"fused_diff_compact_tiled": _K1_UNIT},
    "diff+compact_subtiled8_clustered": {"fused_diff_compact_tiled": _K1_UNIT},
    "diff+compact_tiled_clustered": {"fused_diff_compact_tiled": _K1_CHUNKS},
    "diff+compact_pallas": {"fused_diff_compact": _K1_FLAT},
    "diff+compact_segment": {"segment_compact": ("segment_kernel",),
                             "pair_compact": ("pair_lookback_kernel",)},
    "histogram": _K4,
    "binarize_pipeline": _K9,
    **{f"gaussian_conv_k{k}": _K8 for k in (3, 5, 7, 9)},
    "host_offload_step": {"diff_pack": ("diff_pack_kernel",)},
    "heatmap_lut": {"heatmap": ("heat_kernel",)},
    "red_overlap": {"red_visualizer": ("red_kernel",)},
    "grayscale_avg": {"grayscale_average": _VIS},
    "grayscale_weighted": {"grayscale_weighted": _VIS},
}
PORT_KERNELS = ("flat_lookback_kernel", "tiled_unit_kernel",
                "tiled_chunk_count_kernel", "tiled_chunk_compact_kernel",
                "pair_lookback_kernel", "vals_lookback_kernel", "hist_kernel",
                "segment_kernel", "register_kernel", "probe_kernel",
                "conv_kernel", "binarize_fused_kernel",
                "binarize_gray_kernel", "binarize_apply_kernel",
                "diff_pack_kernel", "heat_kernel", "vis_kernel",
                "red_kernel")
TABLE_CLI_TIMEOUT_S = 600
# the kernel table's rows that K10-K13 serve
TABLE_K10_K13 = {"host_offload_step": "K10", "heatmap_lut": "K11",
                 "red_overlap": "K12", "grayscale_avg": "K13",
                 "grayscale_weighted": "K13"}
# the kernel line's records that sum the launches of several wrappers
COUNTERS = {"binarize_pipeline": ("binarize_pipeline", "gray_hist",
                                  "binarize_apply"),
            "grayscale": ("grayscale_average", "grayscale_weighted")}


def _leaves_np(carry):
    """The host copies of a carry's tensors."""
    leaves = carry if isinstance(carry, tuple) else (carry,)
    return [t.cpu().numpy() for t in leaves]


def _table_lines(text, names, label):
    """The rows a kernel table printed after its ``kernel table:`` line:
    ``{name: ms}`` in order; each name must be one of ``names``, in their
    order, every time finite and above 0, and ``histogram_mxu``'s
    not-ported line must stand after ``histogram``."""
    lines = text.splitlines()
    start = next((i for i, line in enumerate(lines)
                  if line.startswith("kernel table:")), None)
    if start is None:
        raise AssertionError(f"{label}: no kernel table in its output")
    rows = lines[start + 1:start + 2 + len(names)]
    mxu = [i for i, line in enumerate(rows)
           if line.startswith("histogram_mxu: no row")]
    if mxu != [names.index("histogram") + 1]:
        raise AssertionError(f"{label}: the histogram_mxu line is missing "
                             "or misplaced")
    del rows[mxu[0]]
    got = {}
    for line in rows:
        name, ms = line.split()[:2]
        got[name] = float(ms)
    if list(got) != names or not all(
            np.isfinite(ms) and ms > 0 for ms in got.values()):
        raise AssertionError(f"{label}: rows {got}, not a finite time above "
                             f"0 for each of {names}")
    return got


def phase_kernel_table(smi):
    """The per-kernel table at 1080p (``kernel_table.py``, ``bench
    --full``): the CLI, ``python -m cudavideostream_tpu_torch.bench
    --full``, must exit 0 with the headline's one JSON line, every row
    and the ``prev_copy`` line with a finite time above 0; then in this
    process one step of each row on the card must equal the same step
    through the plain versions on the CPU, byte for byte. Then each row's
    graph of ``kernel_table.K`` steps is captured here as the table
    captures it (``ChainGraph``), the launch counts set to 0 just before:
    it must hold, per step, K1's kernel(s), K4's or K5's and K2's where
    its row launches them, and no other kernel of the port; replayed
    ``1 + kernel_table.ITERS`` times, as the table replays it, its carry
    must equal the same row's steps launched eagerly from a fresh carry
    on the card, byte for byte. The CLI's times are the row's; nothing is
    timed here. Returns the times and the captures' counts."""
    from cudavideostream_tpu_torch import kernel_table
    from cudavideostream_tpu_torch.config import StreamConfig
    from cudavideostream_tpu_torch.utils.timing import ChainGraph

    cmd = [sys.executable, "-m", "cudavideostream_tpu_torch.bench", "--full"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=TABLE_CLI_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    out = proc.stdout.splitlines()
    if proc.returncode != 0 or len(out) != 1 or set(
            json.loads(out[0])) != BENCH_JSON_KEYS:
        raise AssertionError(f"bench --full: rc {proc.returncode}, stdout "
                             f"{proc.stdout!r}\n{proc.stderr}")
    if "[headline] byte-exact vs oracle: OK" not in proc.stderr:
        raise AssertionError("bench --full: its gate did not pass")
    cfg = StreamConfig()
    card_rows = kernel_table.rows(cfg, "cuda")
    names = [r.name for r in card_rows]
    cli = _table_lines(proc.stderr, names, "bench --full")
    copy = [line.split() for line in proc.stderr.splitlines()
            if line.startswith(kernel_table.COPY_NAME + " ")]
    if len(copy) != 1 or not (np.isfinite(float(copy[0][1]))
                              and float(copy[0][1]) > 0):
        raise AssertionError(f"bench --full: the {kernel_table.COPY_NAME} "
                             f"line is missing or not a time above 0")
    copy_ms = float(copy[0][1])
    for line in proc.stderr.splitlines():
        if line.startswith(("kernel table:", "histogram_mxu",
                            kernel_table.COPY_NAME + " ")):
            log(f"[table]   {line}")
    log(f"[table] python -m cudavideostream_tpu_torch.bench --full: exit 0 "
        f"in {secs:.1f} s, {out[0]}; after the headline {len(cli)} rows and "
        f"{kernel_table.COPY_NAME}, each a finite time above 0")

    for card, plain in zip(card_rows, kernel_table.rows(cfg, "cpu")):
        got = _leaves_np(card.chain(card.init))
        want = _leaves_np(plain.chain(plain.init))
        if len(got) != len(want) or not all(
                g.dtype == w.dtype and np.array_equal(g, w)
                for g, w in zip(got, want)):
            raise AssertionError(f"kernel table {card.name}: a step on the "
                                 "card != the plain step on the CPU")
    torch.cuda.synchronize()
    log(f"[check] kernel table: one step of each of the {len(names)} rows at "
        f"1080p on the card == the plain versions' step on the CPU, byte for "
        f"byte (every carry leaf: state, next frame, digest)")

    k, replays = kernel_table.K, 1 + kernel_table.ITERS
    steps = (ChainGraph.WARMUP_PASSES + replays) * k
    launches, graphs = None, []
    for row, fresh in zip(card_rows, kernel_table.rows(cfg, "cuda")):
        counters = _zero_launches()
        g = ChainGraph(lambda c, _i, chain=row.chain: chain(c), row.init, k)
        got = {name: fn.launches for name, fn in counters.items()}
        launches = got if launches is None else {
            name: launches[name] + n for name, n in got.items()}
        kinds, kernel_names = _graph_nodes(g.graph)
        if any(n is None for n in kernel_names):
            raise AssertionError(f"kernel table {row.name}: the CUDA driver "
                                 "did not name every kernel node")
        want = TABLE_KERNELS.get(row.name, {})
        nodes = {kern: sum(kern in n for n in kernel_names)
                 for kern in PORT_KERNELS}
        expect = {kern: k if kern in sum(want.values(), ()) else 0
                  for kern in PORT_KERNELS}
        if nodes != expect:
            raise AssertionError(f"kernel table {row.name}: the graph of {k} "
                                 f"steps holds {nodes}, not {expect}")
        for _ in range(replays):
            g.replay()
        torch.cuda.synchronize()
        replayed = _leaves_np(g.carry)
        del g
        c = fresh.init
        for _ in range(steps):
            c = fresh.chain(c)
        eager = _leaves_np(c)
        if len(replayed) != len(eager) or not all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(replayed, eager)):
            raise AssertionError(f"kernel table {row.name}: the graph's "
                                 f"carry after {replays} replays != {steps} "
                                 f"eager steps on the card")
        graphs.append({"row": row.name, "kinds": kinds,
                       "nodes": {n: v for n, v in nodes.items() if v}})
        log(f"[table] {row.name}: the CUDA graph of {k} steps holds "
            f"{sum(kinds.values())} nodes ({kinds.get(0, 0)} kernel, "
            f"{kinds.get(2, 0)} memset)"
            + "".join(f", {n} x{v}" for n, v in graphs[-1]["nodes"].items())
            + f"; its carry after {replays} replays == {steps} eager steps, "
            f"byte for byte")
    # each graph: its two warm-up passes and its capture, each step one
    # wrapper call of every kernel its row launches (a replay calls none)
    want = dict.fromkeys(launches, 0)
    for gr in graphs:
        for counter in TABLE_KERNELS.get(gr["row"], {}):
            want[counter] += (ChainGraph.WARMUP_PASSES + 1) * k
    _expect_launches({"launches": launches, "frames": len(graphs)},
                     "kernel table", want)
    diff_rows = [n for n in names if n.startswith("diff+compact")]
    for name in names:
        ref = next(r.jetson_ms for r in card_rows if r.name == name)
        log(f"[table] {name}: {cli[name]:.4f} ms a step through bench --full"
            + (f", {copy_ms:.4f} ms of it the copy of prev "
               f"({kernel_table.COPY_NAME}, timed alone)"
               if name in diff_rows else "")
            + f" (jetson, the reference's Jetson Nano: {ref}; {smi})")
    graph_nodes = {}
    for gr in graphs:
        for counter, kerns in TABLE_KERNELS.get(gr["row"], {}).items():
            graph_nodes.setdefault(counter, {})[f"{gr['row']} k={k}"] = \
                sum(gr["nodes"][n] for n in kerns)
    return {"cli_ms": cli, "prev_copy_ms": copy_ms,
            "jetson_ms": {r.name: r.jetson_ms for r in card_rows},
            "cli_s": secs,
            "run": {"launches": launches, "frames": len(graphs),
                    "graph_nodes": graph_nodes}}


LOOPBACK_FRAMES = 10  # timed frames a solo row (the sweep's --frames)
# one row of each landing flavor, of host capture and of the HOST backend,
# served again under the profiler for the card's idle share
LOOPBACK_TRACED = ("dev_d3_tiles_v3", "dev_d3_flat_v3", "dev_d3_auto_v3",
                   "dev_d3_mask_v4_batch8", "dev_d3_maskonly_v4_batch8",
                   "host_d3_tiles_v3", "hostbk_d3_v3")
# rows served again to a client that decodes nothing: the send leg's
# share that the decoding client's thread holds (it shares the
# interpreter lock with the serving loop)
LOOPBACK_SINK = ("dev_d6_tiles_v1", "dev_d3_tiles_v3", "dev_d3_flat_v3",
                 "dev_d3_mask_v4_batch8", "hostbk_d3_v3")


def _loopback_want(row, frames, fetch_counts):
    """The launches a sweep row must make over ``frames`` frames: one K1
    a frame (bitmask-only on the maskonly rows), one K2 a flat or mask
    landing with index blocks, one K3 a maskonly landing, and on the HOST
    backend K10 alone, once a frame. Every clustered frame changes the
    band, so every landing is non-empty."""
    label, _, _, fetch, _, backend, _ = row
    want = dict.fromkeys(_launch_counters(), 0)
    if backend == "host":
        want["diff_pack"] = frames
        return want
    flavor = {"tiles": "tiles", "flat": "flat", "mask": "mask",
              "maskonly": "mask"}.get(fetch)
    if flavor and fetch_counts[flavor] != frames:
        raise AssertionError(f"{label}: landings {fetch_counts}, not "
                             f"{frames} of --fetch {fetch}")
    if sum(fetch_counts.values()) != frames:
        raise AssertionError(f"{label}: landings {fetch_counts} for "
                             f"{frames} frames")
    if fetch == "maskonly":
        want.update(fused_diff_compact_mask=frames, vals_compact=frames)
    else:
        want.update(fused_diff_compact_tiled=frames,
                    pair_compact=fetch_counts["flat"] + fetch_counts["mask"])
    return want


def _sink_client(port, height, width, n_frames, out):
    """In place of the sweep's decoding client: read the stream into one
    buffer until the server closes, decoding nothing; ``out["bytes"]``
    counts what it read."""
    from cudavideostream_tpu_torch import loopback_sweep as sweep

    with socket.create_connection(("127.0.0.1", port),
                                  timeout=sweep.SOCKET_TIMEOUT_S) as sock:
        buf, n = bytearray(1 << 20), 0
        while k := sock.recv_into(buf):
            n += k
    out["bytes"] = n


def _loopback_row(sweep, row, base_cfg, host_cfg, pipes, smi, mode,
                  device):
    """One row of ``loopback_sweep``'s matrix, its launches counted from
    0: ``mode`` "gated" must pass the row's gate; "traced" runs it again
    under the profiler (and gated) for the card's idle share; "sink"
    serves it to a client that reads and decodes nothing (no gate: the
    client keeps no frame), whose send leg, beside the gated row's, is
    the decoding client's share of it. Returns the row's numbers."""
    label = row[0]
    cfg, ex, src, kw = sweep.make_row(row, base_cfg, host_cfg, pipes,
                                      LOOPBACK_FRAMES, device)
    counters = _zero_launches()
    prof = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if mode == "traced"
        else contextlib.nullcontext())
    client = (_patched(sweep, "_client_thread", _sink_client)
              if mode == "sink" else contextlib.nullcontext())
    with prof, client:
        t0 = time.perf_counter()
        # the gate's resync waits for the card
        med, fps, pos_mean, ok, kb_pf = sweep.run_row(cfg, src, ex, **kw)
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    line = sweep.row_line(label, med, fps, pos_mean, ok, kb_pf)
    if not ok and mode != "sink":
        raise AssertionError(f"[loopback] {line}: the client's frame is not "
                             f"the device state")
    frames = kw["warm"] + kw["n_frames"]
    _expect_launches({"launches": launches, "frames": frames}, label,
                     _loopback_want(row, frames, ex.fetch_counts))
    fired = ", ".join(f"{k}={v}" for k, v in launches.items() if v) or "none"
    out = {"legs_ms": med, "fps": fps, "pos_mean": pos_mean,
           "land_KBpf": kb_pf, "frames": frames, "launches": launches,
           "fetch_counts": dict(ex.fetch_counts)}
    if mode == "traced":
        busy = _busy_and_overlap(prof)
        share, text = _idle({"busy_ms": None if busy is None else busy[0],
                             "wall": wall},
                            device_work=row[5] != "host")
        out.update(idle=share, wall_s=wall)
        log(f"[loopback] {label} (traced, {frames} frames in {wall:.3f} s "
            f"under the profiler): {text}; total "
            f"{med['total']:.2f} ms a frame; kernel launches: {fired}")
    elif mode == "sink":
        log(f"[loopback] {label} to a client that reads and does not "
            f"decode: capture {med['capture']:.2f} dispatch "
            f"{med['dispatch']:.2f} land {med['land']:.2f} send "
            f"{med['send']:.2f} total {med['total']:.2f} ms, {fps:.1f} fps; "
            f"kernel launches: {fired}; {smi}")
    else:
        log(f"[loopback] {line} exact; {frames} frames, kernel launches: "
            f"{fired}; landings {dict(ex.fetch_counts)}; {smi}")
    return out


def phase_loopback(smi, device="cuda"):
    """The served path from a source on the card (``loopback_sweep``):
    every row of its matrix at 1080p — ``DeviceClusteredSource`` on the
    28 device rows (every landing flavor, wire v1-v4, solo, pipelined and
    batched), the host source on the 4 host rows (two of them the HOST
    backend) — through the executor, a TCP socket and a decoding client,
    each row gated byte-exact (client == ``executor.resync()``), its legs,
    fps, ``pos_mean`` and fetched KB a frame printed with the card, its
    launches counted from 0 and held to what the row must launch; the
    rows of ``LOOPBACK_TRACED`` served again under the profiler for the
    card's idle share. Then ``loopback.main``'s rows at 1080p (the NumPy
    source), each gated, their launches counted. Returns both runs."""
    from cudavideostream_tpu_torch import loopback
    from cudavideostream_tpu_torch import loopback_sweep as sweep
    from cudavideostream_tpu_torch.runtime import executor as executor_mod

    base_cfg, host_cfg = sweep.base_configs(device)
    pipes = sweep.Pipelines(base_cfg, device)
    log(f"[loopback] loopback_sweep at {base_cfg.height}x{base_cfg.width}, "
        f"{len(sweep.MATRIX)} rows: row, capture dispatch land send total "
        f"(ms; medians, batched rows means), fps, pos_mean, gate, fetched "
        f"KB a frame")
    t0 = time.perf_counter()
    rows, total = {}, dict.fromkeys(_launch_counters(), 0)
    frames = 0
    for row in sweep.MATRIX:
        modes = (("gated",) + ("traced",) * (row[0] in LOOPBACK_TRACED)
                 + ("sink",) * (row[0] in LOOPBACK_SINK))
        for mode in modes:
            out = _loopback_row(sweep, row, base_cfg, host_cfg, pipes, smi,
                                mode, device)
            key = row[0] + ("" if mode == "gated" else f" {mode}")
            rows[key] = out
            frames += out["frames"]
            for name, n in out["launches"].items():
                total[name] += n
    sweep_s = time.perf_counter() - t0
    log(f"[loopback] every row exact: {len(rows)} runs, {frames} frames in "
        f"{sweep_s:.1f} s; kernel launches: "
        + ", ".join(f"{k}={v}" for k, v in total.items() if v))

    # loopback.py's rows: the NumPy source, the oracle and the device
    # backends; its executors kept to read their landings
    made = []
    real = executor_mod.StreamExecutor

    def recording(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    counters = _zero_launches()
    t0 = time.perf_counter()
    with _patched(executor_mod, "StreamExecutor", recording):
        rc = loopback.main(["--frames", str(LOOPBACK_FRAMES), "--device",
                            device])
    loop_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    if rc != 0 or len(made) != 5:
        raise AssertionError(f"loopback.main: rc {rc}, {len(made)} device "
                             "executors (5 expected)")
    served = LOOPBACK_FRAMES + 2
    flat_landings = sum(ex.fetch_counts.get("flat", 0) for ex in made)
    _expect_launches({"launches": launches, "frames": 5 * served},
                     "loopback.main", {
                         **dict.fromkeys(_launch_counters(), 0),
                         "fused_diff_compact": 2 * served,
                         "fused_diff_compact_tiled": 3 * served,
                         "pair_compact": flat_landings})
    log(f"[loopback] python -m cudavideostream_tpu_torch.loopback: "
        f"exit 0 in {loop_s:.1f} s, every loop's client == the server's "
        f"state; kernel launches: "
        + ", ".join(f"{k}={v}" for k, v in launches.items() if v)
        + f" (the tiled executors' landings "
        f"{[dict(ex.fetch_counts) for ex in made[2:]]}); {smi}")
    log("[loopback] summary " + json.dumps(
        {"card": smi, "rows": {k: {x: v for x, v in r.items()
                                   if x != "launches"}
                               for k, r in rows.items()}}))
    return {"sweep": {"launches": total, "frames": frames},
            "loopback": {"launches": launches, "frames": 5 * served}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from cudavideostream_tpu_torch.config import StreamConfig, Visualizer
    from cudavideostream_tpu_torch.ops import diff, filters

    cfg = StreamConfig()  # the default: 1080p BGR24, threshold 20, negfeed
    tcfg = dataclasses.replace(cfg, tiled_payload=True)
    smi, clock_mhz = phase_environment()
    k7_sass = phase_build()
    max_err, cases = phase_kernel_vs_plain(cfg)
    tiled_cases = phase_tiled_vs_plain(cfg)
    mask_cases = phase_mask_vs_plain(cfg)
    filter_cases = phase_filters_vs_plain(cfg)
    k8k9_cases = phase_noise_binarize_vs_plain(cfg)
    vis_cases = phase_visualize_vs_plain(cfg)
    overlay_cases = phase_overlay_vs_plain(cfg)
    map_cases = phase_map_vs_plain(cfg)
    scheme_cases = phase_schemes_vs_plain(cfg)
    batched_cases = phase_batched_vs_plain(cfg)
    offset_cases = phase_offset_vs_plain(cfg)
    phase_stores_on_scene()
    sharded_steps = phase_sharded_steps(cfg)
    mcfg = dataclasses.replace(tcfg, emit_bitmask=True, fetch_mode="mask",
                               mask_payload=True, wire_format="v4")
    runs = {
        "flat": phase_serving(cfg, "flat, wire v1"),
        "tiled_flat": phase_serving(
            dataclasses.replace(tcfg, fetch_mode="flat"),
            "--tiled --fetch flat"),
        "tiled_tiles": phase_serving(
            dataclasses.replace(tcfg, fetch_mode="tiles"),
            "--tiled --fetch tiles"),
        "tiled_pipelined_v3": phase_serving(
            dataclasses.replace(tcfg, wire_format="v3"),
            "--tiled --pipelined --wire v3", pipelined=True),
        "bitmask_mask_v4": phase_serving(
            mcfg, "--tiled --bitmask --fetch mask --wire v4"),
        "maskonly_v4_batch8": phase_serving(
            dataclasses.replace(mcfg, maskonly_payload=True),
            "--tiled --fetch mask --maskonly --wire v4 --land-batch 8",
            land_batch=8),
        "bitmask_auto_v1": phase_serving(
            dataclasses.replace(tcfg, emit_bitmask=True),
            "--tiled --bitmask --fetch auto --wire v1"),
        "binarize_v1": phase_serving(
            dataclasses.replace(cfg, visualizer=Visualizer.BINARIZE),
            "--visualizer 5, wire v1"),
        "denoised_heatmap_tiled_flat": phase_serving(
            dataclasses.replace(tcfg, fetch_mode="flat", noise_filter=True,
                                visualizer=Visualizer.HEATMAP),
            "--noise-filter --visualizer 1 --tiled --fetch flat"),
        "red_overlap_maskonly_batch8": phase_serving(
            dataclasses.replace(mcfg, maskonly_payload=True,
                                visualizer=Visualizer.RED_OVERLAP),
            "--tiled --fetch mask --maskonly --wire v4 --land-batch 8 "
            "--visualizer 3", land_batch=8),
    }
    # the two --threshold-map paths, built by the server's own command
    # line from a per-pixel map on disk
    from cudavideostream_tpu_torch.runtime import server as server_mod

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "door.npy")
        door = door_map(cfg, np.random.default_rng(SEED + 10))
        np.save(path, door)
        for key, flags in (
                ("map_flat_v1", []),
                ("map_red_overlap_maskonly_batch8",
                 ["--tiled", "--fetch", "mask", "--maskonly", "--wire", "v4",
                  "--land-batch", "8", "--visualizer", "3"])):
            argv = flags + ["--threshold-map", path]
            mapcfg, inner, _, _ = server_mod.setup(["--port", "0"] + argv)
            if not np.array_equal(inner.pipe.threshold_map_np,
                                  np.repeat(door.ravel(), 3)):
                raise AssertionError(f"{key}: the server's map is not the "
                                     "saved per-pixel map, x3 per byte")
            label = " ".join(["flat, wire v1"] if not flags else flags)
            runs[key] = phase_serving(mapcfg, label + " --threshold-map",
                                      inner=inner)
    runs["crosscheck"] = phase_crosscheck_path(cfg)
    # the multi-stream server's default is the tiled payload (its batched
    # fast path)
    for key, label, kw in (
            ("multiserve_v1", "--streams 4 (wire v1, --fetch auto)", {}),
            ("multiserve_v3", "--streams 4 --wire v3", {"wire_format": "v3"}),
            ("multiserve_binarize_aux",
             "--streams 4 --visualizer 5 --aux-dir",
             {"visualizer": Visualizer.BINARIZE}),
            ("multiserve_grayscale_aux",
             "--streams 4 --visualizer 4 --aux-dir",
             {"visualizer": Visualizer.GRAYSCALE})):
        runs[key] = phase_multiserve(dataclasses.replace(tcfg, **kw), label,
                                     aux="visualizer" in kw)
    runs["broadcast"] = phase_broadcast_replay(cfg)
    # the sharded paths: server --mesh as its command line builds it, an
    # S = 4 executor with its shards on cuda:0 (the library's devices=;
    # the server takes D*S cards), and multiserve --mesh 1,1
    from cudavideostream_tpu_torch.runtime.sharded_executor import (
        ShardedStreamExecutor,
    )

    for key, flags in (("mesh11_v1", []),
                       ("mesh11_pipelined_v3", ["--pipelined", "--wire",
                                                "v3"])):
        mcfg11, inner, _, _ = server_mod.setup(
            ["--port", "0", "--mesh", "1,1"] + flags)
        runs[key] = phase_serving(
            mcfg11, " ".join(["--mesh 1,1"] + (flags or ["wire v1"])),
            inner=inner)
    runs["mesh14_cuda0"] = phase_serving(
        cfg, "ShardedStreamExecutor S=4 on cuda:0, wire v1",
        inner=ShardedStreamExecutor(cfg, mesh=_sharded_mesh(4)))
    # --visualizer 2 on the sharded path: K12 once a shard
    red_black = dataclasses.replace(cfg, visualizer=Visualizer.RED_BLACK)
    runs["mesh14_cuda0_red_black"] = phase_serving(
        red_black, "ShardedStreamExecutor S=4 on cuda:0 --visualizer 2, "
        "wire v1", inner=ShardedStreamExecutor(red_black,
                                               mesh=_sharded_mesh(4)))
    runs["multiserve_mesh11"] = phase_multiserve(
        cfg, "--streams 4 --mesh 1,1", mesh=_sharded_mesh(1))
    camera = phase_camera_path(cfg, smi)
    for key, by_client in camera["runs"].items():
        for i, run in enumerate(by_client, start=1):
            runs[f"camera {key} run {i} ({run['client']})"] = run
    extras = phase_backends_and_extras(cfg, smi)
    for key, run in extras["runs"].items():
        runs[f"backends {key}"] = run
    bench_out = phase_bench(cfg, smi)
    runs.update(bench_out["runs"])
    log("[bench] summary " + json.dumps(
        {k: v for k, v in bench_out.items() if k != "runs"}))
    table = phase_kernel_table(smi)
    runs["kernel table"] = table["run"]
    log("[table] the rows K10-K13 now serve, through bench --full: "
        + "; ".join(f"{row} {table['cli_ms'][row]:.4f} ms ({kern})"
                    for row, kern in TABLE_K10_K13.items()) + f" ({smi})")
    log("[table] summary " + json.dumps(
        {k: v for k, v in table.items() if k != "run"}))
    served = phase_loopback(smi)
    runs["loopback_sweep"] = served["sweep"]
    runs["loopback"] = served["loopback"]
    none = dict.fromkeys(_launch_counters(), 0)
    for key, s_count in (("mesh11_v1", 1), ("mesh11_pipelined_v3", 1),
                         ("mesh14_cuda0", 4), ("mesh14_cuda0_red_black", 4)):
        run = runs[key]
        # S K1 tiled launches a frame; K2 only for the flat landings of
        # a (1, 1) mesh under auto, none at S > 1 (tiles pinned); K12 once
        # a shard under --visualizer 2
        _expect_launches(run, key, {
            **none, "fused_diff_compact_tiled": s_count * run["frames"],
            "pair_compact": run["fetch_counts"]["flat"],
            "red_visualizer":
                s_count * run["frames"] if "red_black" in key else 0})
        if s_count > 1 and run["fetch_counts"]["tiles"] != run["frames"]:
            raise AssertionError(f"{key}: S > 1 must land through tiles")
    run = runs["multiserve_mesh11"]
    _expect_launches(run, "multiserve_mesh11", {
        **none, "fused_diff_compact": 4 * run["frames"]})
    for key in ("multiserve_v1", "multiserve_v3", "multiserve_binarize_aux",
                "multiserve_grayscale_aux"):
        run = runs[key]
        # one batched launch per batched frame (not one per stream), K9's
        # and K13's too under --visualizer 5 and 4; one K2 merge per flat
        # landing (auto lands an empty stream as tiles)
        _expect_launches(run, key, {
            **none, "fused_diff_compact_batched": run["frames"],
            "pair_compact": run["fetch_counts"]["flat"],
            "binarize_pipeline": run["frames"] if "binarize" in key else 0,
            "grayscale_weighted":
                run["frames"] if "grayscale" in key else 0})
    _expect_launches(runs["broadcast"], "broadcast", {
        **none, "fused_diff_compact": runs["broadcast"]["frames"]})
    _expect_launches(runs["map_flat_v1"], "map_flat_v1", {
        **none, "fused_diff_compact": runs["map_flat_v1"]["frames"]})
    _expect_launches(runs["crosscheck"], "crosscheck", {
        **none, "fused_diff_compact": 1, "fused_diff_compact_tiled": 1,
        "fused_diff_compact_batched": 1, "segment_compact": 3,
        "register_compact": 2, "pair_compact": 2, "vpu_probe": 1})
    _expect_launches(runs["flat"], "flat", {
        **none, "fused_diff_compact": runs["flat"]["frames"]})
    run = runs["binarize_v1"]
    # K9's one launch a frame, and no K4: the torch chain is gone
    _expect_launches(run, "binarize_v1", {
        **none, "fused_diff_compact": run["frames"],
        "binarize_pipeline": run["frames"]})
    for key in ("tiled_flat", "tiled_tiles", "tiled_pipelined_v3",
                "bitmask_mask_v4", "bitmask_auto_v1",
                "denoised_heatmap_tiled_flat"):
        run = runs[key]
        fc = run["fetch_counts"]
        # one K2 merge per non-empty flat landing, and per non-empty mask
        # landing where index blocks exist; none for a tiles landing
        # (under auto an empty frame lands as tiles)
        merges = {"tiled_flat": run["nonempty"], "tiled_tiles": 0,
                  "bitmask_mask_v4": run["nonempty"],
                  "denoised_heatmap_tiled_flat": run["nonempty"]}.get(
                      key, fc["flat"] + fc["mask"])
        # K8 and K11 once a frame under --noise-filter --visualizer 1
        _expect_launches(run, key, {
            **none, "fused_diff_compact_tiled": run["frames"],
            "pair_compact": merges,
            **dict.fromkeys(("convolve_q16", "heatmap"),
                            run["frames"] if "denoised" in key else 0)})
    for key in ("maskonly_v4_batch8", "red_overlap_maskonly_batch8",
                "map_red_overlap_maskonly_batch8"):
        run = runs[key]
        # K12 once a frame under --visualizer 3
        _expect_launches(run, key, {
            **none, "fused_diff_compact_mask": run["frames"],
            "vals_compact": run["nonempty"],
            "red_visualizer": run["frames"] if "red" in key else 0})
    for key, mode in (("tiled_flat", "flat"), ("tiled_tiles", "tiles"),
                      ("bitmask_mask_v4", "mask"),
                      ("maskonly_v4_batch8", "mask"),
                      ("denoised_heatmap_tiled_flat", "flat"),
                      ("red_overlap_maskonly_batch8", "mask"),
                      ("map_red_overlap_maskonly_batch8", "mask")):
        if runs[key]["fetch_counts"][mode] != runs[key]["frames"]:
            raise AssertionError(f"{key}: the landing flavors did not follow "
                                 f"--fetch {mode}")
    log(f"[serve] --tiled --bitmask --fetch auto: landings "
        f"{runs['bitmask_auto_v1']['fetch_counts']}, K2 launches "
        f"{runs['bitmask_auto_v1']['launches']['pair_compact']} = its flat "
        f"and mask landings")
    times = phase_times(cfg)
    ttimes = phase_tiled_times(cfg)
    mtimes = phase_mask_times(cfg)
    ftimes = phase_filter_times(cfg)
    nbtimes = phase_noise_binarize_times(cfg, clock_mhz, smi)
    vtimes = phase_visualize_times(cfg, smi)
    xtimes = phase_map_scheme_times(cfg, clock_mhz)
    btimes = phase_batched_times(cfg)
    stimes = phase_sharded_times(cfg)
    phase_wire_host_times(cfg, smi)

    def launches(name):
        by_path = {k: r["launches"][name] for k, r in runs.items()}
        return sum(by_path.values()), by_path

    vk = vtimes["kernels"]
    lc = "cudavideostream_tpu/ops/logcompact.py"
    with_map = f"; with a per-byte map byte-exact in {map_cases} cases"
    records = [
        ("fused_diff_compact", "logcompact.cu", f"{lc}:297", max_err,
         times["ms"], times["plain_ms"], times["bound_ms"], None,
         f"byte-exact in {cases} cases" + with_map),
        ("fused_diff_compact_tiled", "logcompact.cu", f"{lc}:297", 0,
         ttimes["k1_ms"], ttimes["k1_plain_ms"], ttimes["k1_bound_ms"], None,
         f"byte-exact in {tiled_cases['k1']} cases, and with bits in "
         f"{mask_cases['k1_bits']}" + with_map),
        ("fused_diff_compact_mask", "logcompact.cu", f"{lc}:297", 0,
         mtimes["k1_ms"], mtimes["k1_plain_ms"], mtimes["k1_bound_ms"], None,
         f"byte-exact in {mask_cases['k1_mask']} cases" + with_map),
        ("pair_compact", "pair_compact.cu", f"{lc}:1120", 0,
         ttimes["k2_ms"], ttimes["k2_plain_ms"], ttimes["k2_bound_ms"], None,
         f"byte-exact in {tiled_cases['k2']} cases"),
        ("vals_compact", "pair_compact.cu", f"{lc}:1298", 0,
         mtimes["k3_ms"], mtimes["k3_plain_ms"], mtimes["k3_bound_ms"],
         mtimes["k3_library_ms"], f"byte-exact in {mask_cases['k3']} cases"),
        ("histogram", "histogram.cu",
         "cudavideostream_tpu/ops/hist_pallas.py:54", 0,
         ftimes["k4_ms"], ftimes["k4_plain_ms"], ftimes["k4_bound_ms"],
         ftimes["k4_library_ms"],
         f"byte-exact in {filter_cases['k4']} cases; the 8 variants and 6 "
         f"tiled visualizer steps equal step_oracle"),
        ("fused_diff_compact_batched", "logcompact.cu", f"{lc}:297", 0,
         btimes["k1_ms"], btimes["k1_plain_ms"], btimes["k1_bound_ms"], None,
         f"byte-exact in {batched_cases['k1']} cases against its plain "
         f"version and solo launches; B=4 subtile=1; four solo K1 tiled "
         f"launches {btimes['k1_solo4_ms']:.4f} ms; {batched_cases['steps']} "
         f"batched steps equal step_oracle; the B=4 step "
         f"{btimes['step_ms']:.4f} ms"),
        ("segment_compact", "segment_compact.cu", f"{lc}:537", 0,
         xtimes["k5_ms"], xtimes["k5_plain_ms"], xtimes["k5_bound_ms"], None,
         f"byte-exact in {scheme_cases['k5']} cases; == K1 tiled "
         f"subtile=0; with the map {xtimes['k5_map_ms']:.4f} ms against "
         f"{xtimes['k5_map_bound_ms']:.5f}; batched byte-exact in "
         f"{batched_cases['k5']} cases, == K1 batched subtile=0"),
        ("register_compact", "register_compact.cu",
         "cudavideostream_tpu/ops/pallas_compact.py:68", 0,
         xtimes["k6_ms"], xtimes["k6_plain_ms"], xtimes["k6_bound_ms"], None,
         f"byte-exact in {scheme_cases['k6']} cases; == K1 tiled "
         f"subtile=0"),
        ("vpu_probe", "probe.cu",
         "cudavideostream_tpu/ops/hist_pallas.py:98", 0,
         xtimes["k7_ms"], xtimes["k7_plain_ms"], xtimes["k7_bound_ms"], None,
         f"byte-exact in {scheme_cases['k7']} cases; "
         f"{k7_sass['ISETP']} ISETP in its SASS; bound at {clock_mhz} MHz "
         f"x {K7_LANES_PER_SM} lanes per SM"),
        ("fused_diff_compact index_offset", "logcompact.cu", f"{lc}:297", 0,
         stimes["k1"][4]["ms"], stimes["k1"][4]["plain_ms"],
         stimes["k1"][4]["bound_ms"], None,
         f"byte-exact in {offset_cases} cases (flat and tiled at subtile 1, "
         f"8, 0, every shard base of S = 2, 4, 8, a large offset); timed as "
         f"K1 tiled subtile=1 on the last shard of S=4; "
         f"{sharded_steps} sharded steps equal step_oracle"),
        # K8 and K9 replace no TPU kernel: the XLA-level ops they stand for
        ("convolve_q16", "convolve.cu",
         "cudavideostream_tpu/ops/convolve.py:25", 0,
         nbtimes["k8"][3]["ms"], nbtimes["k8"][3]["plain_ms"],
         nbtimes["k8"][3]["bound_ms"], nbtimes["k8"][3]["library_ms"],
         f"byte-exact in {k8k9_cases['k8']} cases (K = 1-15 with gaussian, "
         f"mean and signed taps, ragged widths at B = 1, 2, 4, S = 4 halo "
         f"shards); timed at K=3, the served default; library_ms is "
         f"F.conv2d fp32, TF32 off, groups=3; conv_kernel<K>, a strip of 8 "
         f"B a thread, K partial rows in registers, no shared byte load"),
        ("binarize_pipeline", "binarize.cu",
         "cudavideostream_tpu/ops/filters.py:293", 0,
         nbtimes["k9"]["ms"], nbtimes["k9"]["plain_ms"],
         nbtimes["k9"]["bound_ms"], None,
         f"byte-exact in {k8k9_cases['k9']} cases (1080p, the scene, one "
         f"value, a tie, ragged lengths, an unaligned view, past the "
         f"register budget, B = 2, 4, 8 with and without strips, S = 4 "
         f"shards, 100 launches on one stream and on two); one cooperative "
         f"launch a call, binarize_fused_kernel (the sharded path: "
         f"binarize_gray_kernel and binarize_apply_kernel); with the overlay "
         f"region in {vis_cases['k9_region']} more"),
        # K10-K13 replace no TPU kernel either
        ("diff_pack", "diff_pack.cu", "cudavideostream_tpu/ops/diff.py:30",
         0, vk["K10 diff_pack"]["ms"], vk["K10 diff_pack"]["plain_ms"],
         vk["K10 diff_pack"]["bound_ms"], None,
         f"byte-exact in {vis_cases['k10']} cases (1080p and 271x1917, "
         f"regions, thresholds 20 and 0, maps, feedback on and off, with "
         f"and without the delta, ragged lengths, unaligned views, S = 4 "
         f"shards, warp tile edges, 40 launches back to back); diff_mask "
         f"and pack_bitmask (cudavideostream_tpu/ops/diff.py:30, :74) in "
         f"one launch, warp tiles of {diff.DP_TILE} B"),
        ("heatmap", "visualize.cu",
         "cudavideostream_tpu/ops/filters.py:379", 0,
         vk["K11 heatmap"]["ms"], vk["K11 heatmap"]["plain_ms"],
         vk["K11 heatmap"]["bound_ms"], None,
         f"byte-exact in {vis_cases['k11']} cases (d = 0..765, regions, "
         f"ragged widths and lengths, warp tile edges, unaligned views, "
         f"B = 2, 4 streams, S = 4 shards, 40 launches back to back); "
         f"heat_kernel, warp tiles of {filters.VIS_TILE} B staged through "
         f"shared memory, the LUT by value"),
        ("red_visualizer", "visualize.cu",
         "cudavideostream_tpu/ops/filters.py:435", 0,
         vk["K12 red_visualizer mode 3"]["ms"],
         vk["K12 red_visualizer mode 3"]["plain_ms"],
         vk["K12 red_visualizer mode 3"]["bound_ms"], None,
         f"byte-exact in {vis_cases['k12']} cases (modes 2 and 3, "
         f"thresholds 20 and 0, maps, regions, streams, shards, warp tile "
         f"edges, unaligned views); timed as mode 3 (red_overlap, :435; "
         f"mode 2 is red_black, :424); red_kernel<Overlap, Map>, warp "
         f"tiles of {filters.VIS_TILE} B"),
        ("grayscale", "visualize.cu",
         "cudavideostream_tpu/ops/filters.py:121", 0,
         vk["K13 grayscale_weighted"]["ms"],
         vk["K13 grayscale_weighted"]["plain_ms"],
         vk["K13 grayscale_weighted"]["bound_ms"], None,
         f"byte-exact in {vis_cases['k13']} cases (average and weighted, "
         f"regions, warp tile edges, unaligned views, streams, shards); "
         f"timed as grayscale_weighted (:121, --visualizer 4; "
         f"grayscale_average is :110); vis_kernel<3|4>, runs of "
         f"{filters.VIS_PIXELS} pixels a thread (on K11's warp tiles it "
         f"tied or lost by up to 2%)"),
    ]
    kernels = []
    mesh_paths = ("mesh11_v1", "mesh11_pipelined_v3", "mesh14_cuda0",
                  "mesh14_cuda0_red_black", "multiserve_mesh11")
    for name, src, replaces, err, ms, plain, bound, lib_ms, check in records:
        if name.endswith("index_offset"):
            # the launches of the sharded paths, every one with its shard
            # base as index_offset (tiled on server --mesh, flat on
            # multiserve --mesh)
            by_path = {k: runs[k]["launches"]["fused_diff_compact_tiled"]
                       + runs[k]["launches"]["fused_diff_compact"]
                       for k in mesh_paths}
            total = sum(by_path.values())
        elif name in ("binarize_pipeline", "grayscale"):
            # K9's two launches, or K13's two weightings, each counted by
            # its own wrapper
            by_path = {k: sum(r["launches"][c] for c in COUNTERS[name])
                       for k, r in runs.items()}
            total = sum(by_path.values())
        else:
            total, by_path = launches(name)
        extra = {}
        if name == "segment_compact":
            # K5's batched mode, B = 4, and its launches (the cross-check
            # path's batched call)
            extra = {"batched_ms": btimes["k5_ms"],
                     "batched_plain_ms": btimes["k5_plain_ms"],
                     "batched_bound_ms": btimes["k5_bound_ms"],
                     "batched_launches":
                         runs["crosscheck"]["k5_batched_launches"],
                     "map_launches_per_call": xtimes["k5_map_per_call"],
                     "batched_launches_per_call": btimes["k5_per_call"]}
        elif name == "vpu_probe":
            # K7's SASS by opcode, per (value, bin) of its unrolled body
            extra = {"sass_per_value_and_bin": {
                op: k7_sass[op] / K7_BODY_PAIRS for op in K7_SASS_OPS}}
        elif name == "vals_compact":
            extra = {"mask_land_ms": mtimes["land_ms"]}
        elif name == "histogram":
            extra = {"one_value_ms": ftimes["k4_one_ms"]}
        elif name == "convolve_q16":
            extra = {"k": 3,
                     "kernel_ms": nbtimes["k8"][3]["kernel_ms"],
                     "by_k": {k: v for k, v in nbtimes["k8"].items()
                              if k != 3},
                     "launches_per_call": nbtimes["k8_per_call"],
                     "step_ms": nbtimes["steps"]["--noise-filter"]}
        elif name == "binarize_pipeline":
            k9 = nbtimes["k9"]
            extra = {"kernel_ms": k9["kernel_ms"],
                     "b4_ms": k9["b4_ms"], "b4_kernel_ms": k9["b4_kernel_ms"],
                     "b4_bound_ms": k9["b4_bound_ms"],
                     "b4_launches_per_call": k9["b4_per_call"],
                     "fused_launches": launches("binarize_pipeline")[0],
                     "gray_hist_launches": launches("gray_hist")[0],
                     "binarize_apply_launches": launches("binarize_apply")[0],
                     "gray_hist_ms": k9["gray_hist_ms"],
                     "apply_ms": k9["apply_ms"],
                     "launches_per_call": k9["per_call"],
                     "step_ms": nbtimes["steps"]["--visualizer 5"]}
        elif name == "diff_pack":
            extra = {"delta_ms": vk["K10 diff_pack with the delta"]["ms"],
                     "delta_bound_ms":
                         vk["K10 diff_pack with the delta"]["bound_ms"],
                     "map_ms": vk["K10 diff_pack with a map"]["ms"],
                     "map_bound_ms":
                         vk["K10 diff_pack with a map"]["bound_ms"],
                     "launches_per_call": vk["K10 diff_pack"]["per_call"],
                     "kernel_ms": vk["K10 diff_pack"]["kernel_ms"],
                     "delta_kernel_ms":
                         vk["K10 diff_pack with the delta"]["kernel_ms"],
                     "map_kernel_ms":
                         vk["K10 diff_pack with a map"]["kernel_ms"],
                     "step_ms": vtimes["steps"]["--compaction host"]}
        elif name == "heatmap":
            extra = {"launches_per_call": vk["K11 heatmap"]["per_call"],
                     "kernel_ms": vk["K11 heatmap"]["kernel_ms"],
                     "step_ms": vtimes["steps"]["--visualizer 1"]}
        elif name == "red_visualizer":
            m2 = vk["K12 red_visualizer mode 2"]
            mp = vk["K12 red_visualizer mode 3 with a map"]
            extra = {"mode2_ms": m2["ms"], "mode2_plain_ms": m2["plain_ms"],
                     "map_ms": mp["ms"], "map_bound_ms": mp["bound_ms"],
                     "kernel_ms":
                         vk["K12 red_visualizer mode 3"]["kernel_ms"],
                     "mode2_kernel_ms": m2["kernel_ms"],
                     "map_kernel_ms": mp["kernel_ms"],
                     "launches_per_call":
                         vk["K12 red_visualizer mode 3"]["per_call"],
                     "step_ms": vtimes["steps"]["--visualizer 3"]}
        elif name == "grayscale":
            avg = vk["K13 grayscale_average"]
            extra = {"average_ms": avg["ms"],
                     "kernel_ms": vk["K13 grayscale_weighted"]["kernel_ms"],
                     "average_plain_ms": avg["plain_ms"],
                     "grayscale_average_launches":
                         launches("grayscale_average")[0],
                     "grayscale_weighted_launches":
                         launches("grayscale_weighted")[0],
                     "launches_per_call":
                         vk["K13 grayscale_weighted"]["per_call"]}
        elif name.endswith("index_offset"):
            extra = {"s8_ms": stimes["k1"][8]["ms"],
                     "s8_plain_ms": stimes["k1"][8]["plain_ms"],
                     "s8_bound_ms": stimes["k1"][8]["bound_ms"],
                     "sharded_step_ms": stimes["step_ms"],
                     "served_fps": {k: runs[k].get("fps") for k in mesh_paths}}
        elif name in ("fused_diff_compact", "fused_diff_compact_tiled",
                      "fused_diff_compact_mask"):
            emission = {"fused_diff_compact": "flat",
                        "fused_diff_compact_tiled": "tiled",
                        "fused_diff_compact_mask": "mask"}[name]
            extra = {"map_ms": xtimes["k1_map_ms"][emission],
                     "map_bound_ms": xtimes["k1_map_bound_ms"][emission]}
        # the bench path's CUDA graphs: this kernel's nodes in each, and
        # the replays that launched them (the wrapper counts its calls,
        # the capture's included, never a replay)
        counters = COUNTERS.get(name, (name,))
        graphs = {f"{k} {c}" if len(counters) > 1 else k: {
                      "nodes": r["graph_nodes"][c], "replays": r["replays"]}
                  for k, r in bench_out["runs"].items() for c in counters
                  if c in r["graph_nodes"]}
        if graphs:
            extra["bench_graphs"] = graphs
        # the kernel table's graphs: this kernel's nodes in each
        table_graphs = {c: table["run"]["graph_nodes"][c] for c in counters
                        if c in table["run"]["graph_nodes"]}
        if table_graphs:
            extra["kernel_table_graphs"] = (
                table_graphs if len(counters) > 1 else table_graphs[name])
        if name in REDESIGNED:
            # one launch a call now, as this run's trace counts them
            extra.update(redesigned=REDESIGNED[name], launches_per_call={
                "fused_diff_compact": times["per_call"],
                "pair_compact": ttimes["k2_per_call"],
                "fused_diff_compact_tiled": ttimes["k1_per_call"],
                "fused_diff_compact_mask": mtimes["k1_per_call"],
                "fused_diff_compact_batched": btimes["k1_per_call"],
                "vals_compact": mtimes["k3_per_call"],
                "histogram": ftimes["k4_per_call"],
                "register_compact": xtimes["k6_per_call"],
                "segment_compact": xtimes["k5_per_call"],
                "vpu_probe": xtimes["k7_per_call"],
                "fused_diff_compact index_offset":
                    stimes["k1"][4]["per_call"],
                "convolve_q16": nbtimes["k8_per_call"],
                "binarize_pipeline": nbtimes["k9"]["per_call"]}[name])
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"cudavideostream_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": total,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bound,
            "bound_by": ("operations" if name == "vpu_probe"
                         else nbtimes["k8"][3]["bound_by"]
                         if name == "convolve_q16" else "bytes"),
            "library_ms": lib_ms,
            "floor_ms": times["floor_ms"],
            "check": check,
            "launches_by_path": by_path,
            **extra,
        })
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
