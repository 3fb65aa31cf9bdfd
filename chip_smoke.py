#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``cudavideostream_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: the card's name and power limit, torch, CUDA, nvcc, triton;
2. build: every hand-written kernel of the serving paths, from ``csrc/``,
   one ``nvcc`` per source, all started together;
3. each kernel against its plain PyTorch version at 1080p on the card,
   byte for byte: K1 flat, K1 tiled and K1's bitmask-only emission
   (``subtile_rows`` 1, 8 and 0) and K1 tiled with packed bits
   (``subtile_rows`` 1) over densities, thresholds, negative feedback and
   the overlay region; K2 on every tiled output and on raw pairs; K3 on
   every bitmask-only output and on raw streams; K4 on the gray values of
   a random frame, of the synthetic scene, of one value everywhere and of
   0/255 only, and on ragged lengths; plus one pipeline step of each
   configuration (flat, tiled, tiled with bits, bitmask-only), of each of
   the 8 named variants, and of binarize and red-overlap on each tiled
   emission, against the NumPy spec, the aux frame included;
4. serving: the port's server in a thread and the port's client over
   127.0.0.1, 1080p synthetic frames with a changing overlay text, on ten
   paths — flat (wire v1), ``--tiled --fetch flat``, ``--tiled --fetch
   tiles``, ``--tiled --pipelined --wire v3``, ``--tiled --bitmask
   --fetch mask --wire v4``, ``--tiled --fetch mask --maskonly --wire v4
   --land-batch 8``, ``--tiled --bitmask --fetch auto``, ``--visualizer
   5``, ``--noise-filter --visualizer 1 --tiled --fetch flat`` and
   ``--tiled --fetch mask --maskonly --wire v4 --land-batch 8
   --visualizer 3``; the client's reconstruction must equal the server's
   state every frame, every landed frame of a visualizer path must bring
   its aux frame, the first 5 equal to the NumPy spec's, and each
   kernel's launch count, set to 0 just before a path and read just
   after, must show the path went through it;
5. times from CUDA events (medians over 100 iterations, 30 for functions
   of tens of small launches; device-resident frames at ~6% density,
   inputs cold in L2): each kernel, its plain
   version and its bound (and, for K3, ``torch.masked_select`` as its
   library yardstick), ``pipeline.step`` flat and tiled, the landings
   (``pos`` prefix; tiles, flat and mask flavors, the mask landing's host
   rebuild apart), ``TiledPayload.to_flat`` and the v3 and v4 encodes on
   the host, and the synchronous against the pipelined executor per frame;
   the source's host time per frame is printed apart; K4 against its
   plain version, ``torch.bincount`` and its bound, the filters and the
   noise filter, the ``--visualizer 5`` step and the aux landing.

It prints progress lines, then the card's ``nvidia-smi`` line, then one
JSON line of kernel records, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, and prints no result, without a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
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
    from cudavideostream_tpu_torch.kernels import build
    from cudavideostream_tpu_torch.ops import hist
    from cudavideostream_tpu_torch.ops import logcompact

    t0 = time.perf_counter()
    names = ("logcompact", "pair_compact", "histogram")
    # one nvcc per source, all at once
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.build, names))
    logcompact._kernel_lib()
    logcompact._pair_lib()
    hist._hist_lib()
    log(f"[build] csrc/{'.cu, csrc/'.join(names)}.cu built and bound in "
        f"{time.perf_counter() - t0:.2f} s")


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
        k = logcompact.fused_diff_compact_tiled(cur, p_k, thr, negfeed, reg,
                                                sub)
        torch.cuda.synchronize()
        p = logcompact.fused_diff_compact_tiled_reference(cur, p_p, thr,
                                                          negfeed, reg, sub)
        _equal_or_raise(name, k, p,
                        ("pos", "counts", "xs_t", "vals_t", "new_prev"))
        cases["k1"] += 1
        check_merge(name + " merge_tiles", *k[1:4])
        return int(k[0]), tuple(k[2].shape), k[1].dtype

    for density in (0.0, 0.06, 1.0):
        prev_np, cur_np = frame_pair(rng, n, density)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        for sub in (1, 8, 0):
            poss = []
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
                f"{min(poss)}..{max(poss)}; K2 merge_tiles of each exact")
    for m in (1000, 12_345):
        prev_np, cur_np = frame_pair(rng, m, 0.06)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        for sub in (1, 8, 0):
            run_both(f"tiled n={m} sub={sub}", prev, cur, 20, True,
                     region[:700], sub)
        log(f"[check] K1 tiled n={m} overlay=700 B, subtile 1/8/0: exact; "
            f"K2 merge_tiles exact")
    # raw pairs: a third of the xs are 0 (a valid index), vals zero in
    # between; the last length takes two tiles per block
    for m in (48_608 * 128, 777, 4096 * 1024 + 5):
        xs = torch.from_numpy(rng.integers(0, 3, m).astype(np.int32)).to(dev)
        vals = torch.from_numpy(np.where(
            rng.random(m) < 0.3, rng.integers(1, 255, m, endpoint=True), 0
        ).astype(np.uint8)).to(dev)
        got = logcompact.pair_compact(xs, vals)
        torch.cuda.synchronize()
        _equal_or_raise(f"pair_compact n={m}", got,
                        logcompact.pair_compact_reference(xs, vals),
                        ("pos", "xs", "vals"))
        pos = int(got[0])
        if not bool((got[1][:pos] == 0).any()):
            raise AssertionError("no kept pair with index 0 in the check")
        cases["k2"] += 1
        log(f"[check] K2 pair_compact on {m} raw pairs (pos={pos}, xs == 0 "
            f"kept): exact")

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

    def run_mask(name, prev, cur, thr, negfeed, reg, sub):
        p_k, p_p = prev.clone(), prev.clone()
        k = logcompact.fused_diff_compact_mask(cur, p_k, thr, negfeed, reg,
                                               sub)
        torch.cuda.synchronize()
        p = logcompact.fused_diff_compact_mask_reference(cur, p_p, thr,
                                                         negfeed, reg, sub)
        _equal_or_raise(name, k, p,
                        ("pos", "counts", "vals_t", "bits", "new_prev"))
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
        k = logcompact.fused_diff_compact_tiled(cur, p_k, thr, negfeed, reg,
                                                sub, emit_bits=True)
        torch.cuda.synchronize()
        p = logcompact.fused_diff_compact_tiled_reference(
            cur, p_p, thr, negfeed, reg, sub, emit_bits=True)
        _equal_or_raise(name, k, p, ("pos", "counts", "xs_t", "vals_t",
                                     "bits", "new_prev"))
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
            for thr, negfeed, reg in grid:
                name = (f"mask sub={sub} d={density} thr={thr} "
                        f"negfeed={negfeed} overlay={reg is not None}")
                pos, shape, cdt = run_mask(name, prev, cur, thr, negfeed,
                                           reg, sub)
                poss.append(pos)
            log(f"[check] K1 mask subtile={sub} d={density}: 12 cases "
                f"(thresholds 0/20/255 x negfeed x overlay) exact (pos, "
                f"counts, vals_t, bits, new_prev), units {shape[0]} x "
                f"{shape[1]} B, counts {cdt}, pos {min(poss)}..{max(poss)}; "
                f"K3 merge_vals of each exact")
        poss = [run_bits(f"tiled+bits d={density} thr={thr} negfeed="
                         f"{negfeed} overlay={reg is not None}", prev, cur,
                         thr, negfeed, reg, 1) for thr, negfeed, reg in grid]
        log(f"[check] K1 tiled+bits subtile=1 d={density}: 12 cases exact "
            f"(pos, counts, xs_t, vals_t, bits, new_prev), pos "
            f"{min(poss)}..{max(poss)}")
    for m in (1000, 12_345):
        prev_np, cur_np = frame_pair(rng, m, 0.06)
        prev, cur = (torch.from_numpy(prev_np).to(dev),
                     torch.from_numpy(cur_np).to(dev))
        for sub in (1, 8, 0):
            run_mask(f"mask n={m} sub={sub}", prev, cur, 20, True,
                     region[:700], sub)
            run_bits(f"tiled+bits n={m} sub={sub}", prev, cur, 20, True,
                     region[:700], sub)
        log(f"[check] K1 mask and K1 tiled+bits n={m} overlay=700 B, "
            f"subtile 1/8/0: exact; K3 merge_vals exact")
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


def _check_step(label, cfg, prev_np, cur_np, text):
    """One 1080p ``pipeline.step`` on the card against ``step_oracle``:
    the payload, the new state and the aux frame, byte for byte."""
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import reference_cpu
    from cudavideostream_tpu_torch.utils import fonts

    pipe = DeltaStreamPipeline(cfg)
    out = pipe.step(pipe.init_state(prev_np), cur_np, text=text)
    aux = None if out[-1] is None else out[-1].cpu().numpy()
    pos, xs, vals = _payload_host(cfg, out)
    e_prev, e_pos, e_xs, e_vals, e_aux = reference_cpu.step_oracle(
        prev_np, cur_np, cfg, atlas=pipe.atlas_np,
        char_ids=fonts.encode_text(text))
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

    def check_hist(label, g):
        got = hist.histogram(g)
        torch.cuda.synchronize()
        _equal_or_raise(f"K4 {label}", (got,),
                        (hist.histogram_reference(g),), ("counts",))
        if int(got.sum()) != g.numel():
            raise AssertionError(f"K4 {label}: counts do not sum to n")
        cases["k4"] += 1
        log(f"[check] K4 histogram of {label} ({g.numel()} values, "
            f"{int((got > 0).sum())} bins used): exact")

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
        check_hist(f"a ragged length {m}", torch.from_numpy(
            rng.integers(0, 256, m, dtype=np.uint8)).to(dev))

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
            state = self.inner._state.to("cpu", copy=True).numpy()
            self.inputs.append((state, np.array(frame, copy=True), text))
        t0 = time.perf_counter()
        out = self.inner.process(frame, text=text)
        self.process_s.append(time.perf_counter() - t0)
        self.texts.append(text)
        state = self.inner._state.cpu().numpy()
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
    from cudavideostream_tpu_torch.ops import hist
    from cudavideostream_tpu_torch.ops import logcompact

    return {"fused_diff_compact": logcompact.fused_diff_compact,
            "fused_diff_compact_tiled": logcompact.fused_diff_compact_tiled,
            "fused_diff_compact_mask": logcompact.fused_diff_compact_mask,
            "pair_compact": logcompact.pair_compact,
            "vals_compact": logcompact.vals_compact,
            "histogram": hist.histogram}


def phase_serving(cfg, label, pipelined=False, land_batch=0):
    """Serve 1080p frames over TCP on one path; returns the frames served,
    the frames that changed some byte, every kernel's launches in that
    run and the landing flavors. On a visualizer path every landed frame
    must bring its aux frame, the first 5 equal to the NumPy spec's."""
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
    if land_batch:
        inner = BatchedLandExecutor(cfg, depth=land_batch)
    else:
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

    counters = _launch_counters()
    for fn in counters.values():  # counts of this path's run only
        fn.launches = 0
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
                char_ids=fonts.encode_text(text))[4]
            if not (aux.dtype == np.uint8 and np.array_equal(aux, want)):
                raise AssertionError(f"{label}: landed aux frame {k} "
                                     "differs from step_oracle's")
        log(f"[serve] {label}: an aux frame landed with each of the "
            f"{frames} frames; the first {len(rec.auxes)} equal "
            f"step_oracle's, byte for byte")
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
            "fetch_counts": dict(inner.fetch_counts)}


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


def _profile_ms(fn, names, label):
    """Device time per launch of each named kernel (a template's
    instantiations included) over 20 calls of ``fn(i)``, from a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(20):
            fn(i)
        torch.cuda.synchronize()
    passes = {name: e.device_time_total / e.count / 1e3
              for e in prof.key_averages() for name in names
              if f"::{name}(" in e.key or f"::{name}<" in e.key}
    for name, ms in passes.items():
        log(f"[trace] {label} {name}: {ms:.4f} ms per launch (profiler)")
    if len(passes) != len(names):
        log(f"[trace] {label}: the profiler saw no device time for "
            f"{sorted(set(names) - set(passes))}: not measured")


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
    refill()
    plain_ms = _event_median_ms(
        lambda i: logcompact.fused_diff_compact_reference(
            curs[i % CUR_COPIES], prevs[i], 20, True, region), ITERS,
        backlog=False)
    refill()
    # the kernel's own passes, from a profiler trace of 20 launches
    _profile_ms(lambda i: logcompact.fused_diff_compact(
        curs[i % CUR_COPIES], prevs[i], 20, True, region),
        ("count_kernel", "compact_kernel"), "K1 flat")
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
    log(f"[time] pipeline.step (overlay blend + kernel): {step_ms:.4f} ms")
    log(f"[time] pos-prefix landing: {land_ms:.4f} ms device span, "
        f"{statistics.median(host_land) * 1e3:.4f} ms host")
    log(f"[time] SyntheticSource next() on the host: "
        f"{statistics.median(src_s) * 1e3:.2f} ms/frame (not a kernel time)")
    return {"ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "step_ms": step_ms, "land_ms": land_ms}


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
    _profile_ms(lambda i: logcompact.fused_diff_compact_tiled(
        curs[i % CUR_COPIES], prevs[i], 20, True, region, 1),
        ("tiled_unit_kernel", "sum_kernel"), "K1 tiled subtile=1")
    # K2 on K1's blocks; 4 copies (31 MB each) rotate, so each launch
    # reads blocks last touched ~90 MB of traffic back: cold in the L2
    blocks = [(out[1], out[2].clone(), out[3].clone()) for _ in range(4)]
    k2 = _event_median_ms(lambda i: logcompact.merge_tiles(*blocks[i % 4]),
                          ITERS)
    k2_plain = _event_median_ms(
        lambda i: logcompact.pair_compact_reference(
            blocks[i % 4][1].reshape(-1), blocks[i % 4][2].reshape(-1)),
        ITERS, backlog=False)
    _profile_ms(lambda i: logcompact.merge_tiles(*blocks[i % 4]),
                ("count_kernel", "compact_kernel"), "K2")
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
    return {"k1_ms": k1[1], "k1_plain_ms": k1_plain, "k1_bound_ms": k1_bound,
            "k2_ms": k2, "k2_plain_ms": k2_plain, "k2_bound_ms": k2_bound}


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
    _profile_ms(lambda i: logcompact.fused_diff_compact_mask(
        curs[i % CUR_COPIES], prevs[i], 20, True, region, 1),
        ("tiled_unit_kernel", "sum_kernel"), "K1 mask subtile=1")
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
    _profile_ms(lambda i: logcompact.merge_vals(*blocks[i % 16]),
                ("count_kernel", "vals_compact_kernel"), "K3")

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
    return {"k1_ms": k1, "k1_plain_ms": k1_plain, "k1_bound_ms": k1_bound,
            "k3_ms": k3, "k3_plain_ms": k3_plain, "k3_bound_ms": k3_bound,
            "k3_library_ms": k3_lib}


def phase_filter_times(cfg):
    """K4 against its plain version, ``torch.bincount`` and its bound; the
    filters and the noise filter at 1080p; the ``--visualizer 5`` step
    against the plain step; the aux landing."""
    from cudavideostream_tpu_torch.config import Visualizer
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.ops import convolve
    from cudavideostream_tpu_torch.ops import diff as diff_ops
    from cudavideostream_tpu_torch.ops import filters
    from cudavideostream_tpu_torch.ops import hist
    from cudavideostream_tpu_torch.ops import reference_cpu
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
    _profile_ms(lambda i: hist.histogram(g), ("hist_kernel",), "K4")
    # bound: each gray byte read once, the 256 int32 bins written once
    k4_bytes = g.numel() + 4 * 256
    k4_bound = k4_bytes / HBM_BYTES_PER_S * 1e3

    mask = diff_ops.diff_mask(cur, prev0, cfg.threshold)[0]
    wq3 = reference_cpu.quantize_kernel_q16(reference_cpu.gaussian_kernel(3))
    # these enqueue up to ~50 small launches a call: 30 calls fit the
    # launch queue behind the sleep (100 did not)
    few = 30
    ops = {
        "grayscale_weighted":
            lambda i: filters.grayscale_weighted(curs[i % CUR_COPIES]),
        "heatmap": lambda i: filters.heatmap(curs[i % CUR_COPIES], prev0),
        "red_overlap": lambda i: filters.red_overlap(prev0, mask),
        "binarize_pipeline":
            lambda i: filters.binarize_pipeline(curs[i % CUR_COPIES]),
        "convolve_q16 K=3": lambda i: convolve.convolve_q16(
            curs[i % CUR_COPIES], wq3, cfg.height, cfg.width),
    }
    ops_ms = {name: (_event_median_ms(fn, few),
                     _event_median_ms(fn, few, backlog=False))
              for name, fn in ops.items()}

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
    for name, (ms, wall) in ops_ms.items():
        log(f"[time] {name} at 1080p: {ms:.4f} ms device, {wall:.4f} ms "
            f"with the host's launches (queue not held), medians of {few}")
    log(f"[time] pipeline.step without / with --visualizer 5, in turns, "
        f"medians of {few}: "
        f"{' / '.join(f'{x:.4f}' for x in step_ms[Visualizer.NONE])} ms / "
        f"{' / '.join(f'{x:.4f}' for x in step_ms[Visualizer.BINARIZE])} ms")
    log(f"[time] aux landing ({n} B device to host, pinned): {aux_ms:.4f} ms "
        f"event span, {aux_host_ms:.4f} ms host")
    return {"k4_ms": k4, "k4_plain_ms": k4_plain, "k4_bound_ms": k4_bound,
            "k4_library_ms": k4_lib}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from cudavideostream_tpu_torch.config import StreamConfig, Visualizer

    cfg = StreamConfig()  # the default: 1080p BGR24, threshold 20, negfeed
    tcfg = dataclasses.replace(cfg, tiled_payload=True)
    smi = phase_environment()
    phase_build()
    max_err, cases = phase_kernel_vs_plain(cfg)
    tiled_cases = phase_tiled_vs_plain(cfg)
    mask_cases = phase_mask_vs_plain(cfg)
    filter_cases = phase_filters_vs_plain(cfg)
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
    none = dict.fromkeys(_launch_counters(), 0)
    _expect_launches(runs["flat"], "flat", {
        **none, "fused_diff_compact": runs["flat"]["frames"]})
    run = runs["binarize_v1"]
    _expect_launches(run, "binarize_v1", {
        **none, "fused_diff_compact": run["frames"],
        "histogram": run["frames"]})
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
        _expect_launches(run, key, {
            **none, "fused_diff_compact_tiled": run["frames"],
            "pair_compact": merges})
    for key in ("maskonly_v4_batch8", "red_overlap_maskonly_batch8"):
        run = runs[key]
        _expect_launches(run, key, {
            **none, "fused_diff_compact_mask": run["frames"],
            "vals_compact": run["nonempty"]})
    for key, mode in (("tiled_flat", "flat"), ("tiled_tiles", "tiles"),
                      ("bitmask_mask_v4", "mask"),
                      ("maskonly_v4_batch8", "mask"),
                      ("denoised_heatmap_tiled_flat", "flat"),
                      ("red_overlap_maskonly_batch8", "mask")):
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

    def launches(name):
        by_path = {k: r["launches"][name] for k, r in runs.items()}
        return sum(by_path.values()), by_path

    lc = "cudavideostream_tpu/ops/logcompact.py"
    records = [
        ("fused_diff_compact", "logcompact.cu", f"{lc}:297", max_err,
         times["ms"], times["plain_ms"], times["bound_ms"], None,
         f"byte-exact in {cases} cases"),
        ("fused_diff_compact_tiled", "logcompact.cu", f"{lc}:297", 0,
         ttimes["k1_ms"], ttimes["k1_plain_ms"], ttimes["k1_bound_ms"], None,
         f"byte-exact in {tiled_cases['k1']} cases, and with bits in "
         f"{mask_cases['k1_bits']}"),
        ("fused_diff_compact_mask", "logcompact.cu", f"{lc}:297", 0,
         mtimes["k1_ms"], mtimes["k1_plain_ms"], mtimes["k1_bound_ms"], None,
         f"byte-exact in {mask_cases['k1_mask']} cases"),
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
    ]
    kernels = []
    for name, src, replaces, err, ms, plain, bound, lib_ms, check in records:
        total, by_path = launches(name)
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
            "bound_by": "bytes",
            "library_ms": lib_ms,
            "check": check,
            "launches_by_path": by_path,
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
