"""Headline benchmark of the port: 1080p frames a second on one card for
diff-encode + compact (the port of the JAX package's root ``bench.py``,
with its options, defaults and stdout contract).

The timed loop runs on the card alone: frames are made on the device by
``runtime/sources.py:device_synthetic_frames``, and T pipeline steps
(frame, overlay, the fused diff+compact kernel, a digest that reads the
whole payload) are captured in one CUDA graph and replayed, the
counterpart of the JAX package's ``jit(lax.scan)``
(``utils/timing.py:ChainGraph``). One step is checked byte for byte
against the NumPy spec (``ops/reference_cpu.step_oracle``) before any
timing; a mismatch raises and the process exits non-zero.

Prints ONE json line to stdout::

  {"metric": "1080p_fps_per_chip_diff_encode_compact", "value": fps,
   "unit": "fps", "vs_baseline": fps / 26}

(26 fps: the reference's best end-to-end rate on its own hardware; the
JAX bench's keys, exactly). The value is the median over ``--iters``
replays of T / the replay's CUDA-event time; every sample, the eager
loop of the same steps and the peak device memory go to stderr, with
the card's name and power limit.

    python -m cudavideostream_tpu_torch.bench [--emit tiled|flat]
        [--frames 48] [--iters 9] [--subtile N] [--noise-bank 8]
        [--all-variants] [--full] [--skip-check] [--device cpu]

It runs on the card and raises without one, unless ``--device cpu`` is
given: then it runs 48x64 frames eagerly through the plain PyTorch
versions and prints no device metric (``value`` null). ``--all-variants``
runs every named variant in a process of its own (the table on stderr
and in ``build/bench/variants.json``); a variant that fails makes the
run exit 1. ``--full`` also prints the per-kernel table on stderr,
after the headline (:mod:`cudavideostream_tpu_torch.kernel_table`; at
48x64 on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BASELINE_FPS = 26.0
METRIC = "1080p_fps_per_chip_diff_encode_compact"
TEXT = "FPS: 240 BW: 14000 kbps"
# the seed of the generator that draws the frames' key words under
# --noise-bank 0 (the JAX bench's PRNGKey(7))
KEY_SEED = 7
CPU_HEIGHT, CPU_WIDTH = 48, 64
REPO = Path(__file__).resolve().parents[1]
VARIANTS_JSON = REPO / "build" / "bench" / "variants.json"
VARIANT_TIMEOUT_S = 900


def payload_parts(cfg, out):
    """``(new_prev, pos, xs, vals, aux)`` of a step's outputs, as the JAX
    bench reads them: ``xs`` the flat indices, the tiled index blocks,
    or the packed bits of the bitmask-only emission; ``vals`` the flat
    values or their blocks; ``aux`` None without a visualizer."""
    aux = out[-1] if cfg.visualizer.value != 0 else None
    if cfg.maskonly_payload:
        pos, _counts, vals, xs = out[1:5]
    elif cfg.tiled_payload:
        pos, _counts, xs, vals = out[1:5]
    else:
        pos, xs, vals = out[1:4]
    return out[0], pos, xs, vals, aux


def step_digest(cfg, out) -> torch.Tensor:
    """A 0-d int32 device tensor that reads the whole payload (and the
    aux frame), so that nothing can skip writing it: ``sum(xs) +
    sum(vals)`` (+ ``sum(aux)``), wrapping in int32 as the JAX bench's
    digest does, so the two are equal. The int32 index blocks are summed
    as they are, with no wider copy of them."""
    _, _, xs, vals, aux = payload_parts(cfg, out)
    d = xs.sum(dtype=torch.int32) + vals.sum(dtype=torch.int32)
    if aux is not None:
        d = d + aux.sum(dtype=torch.int32)
    return d


class BenchChain:
    """The benchmark's steps over one configuration: a pipeline on
    ``device``, the device frame generator, and static tensors that a
    CUDA graph of the steps reads and writes.

    :meth:`step` ``(prev, t)`` makes frame ``t``, runs
    ``pipeline.step(prev, frame, text)`` (``prev`` updated in place and
    returned) and writes the step's ``pos`` and digest into
    :attr:`pos` and :attr:`digests` at ``t``. The frame's key words are
    :attr:`keys` ``[t]`` (read on the device: a graph replay takes what
    :meth:`refill_keys` last wrote there); with a noise bank the
    generator ignores them. ``background``: the generator's background
    (default ``default_rng(0)``), e.g. the JAX generator's ``init``."""

    def __init__(self, cfg, text: str, frames: int, noise_bank: int = 8,
                 device=None, background=None):
        from cudavideostream_tpu_torch.models import DeltaStreamPipeline
        from cudavideostream_tpu_torch.runtime.sources import (
            device_synthetic_frames,
        )

        if frames < 1:
            raise ValueError("the chain has at least one frame")
        self.cfg = cfg
        self.text = text
        self.frames = frames
        self.noise_bank = noise_bank
        self.pipe = DeltaStreamPipeline(cfg, device=device)
        dev = self.device = self.pipe.device
        self.init, self.next_frame = device_synthetic_frames(
            cfg, seed=0, noise_bank=noise_bank, device=dev,
            background=background)
        self.keys = torch.zeros((frames, 2), dtype=torch.int64, device=dev)
        self.pos = torch.zeros(frames, dtype=torch.int32, device=dev)
        self.digests = torch.zeros(frames, dtype=torch.int32, device=dev)

    def refill_keys(self, gen: torch.Generator) -> None:
        """Draw new key words for the T frames from ``gen`` (under a
        noise bank the frames do not read them: nothing is drawn)."""
        if not self.noise_bank:
            words = torch.randint(0, 1 << 32, (self.frames, 2),
                                  generator=gen, dtype=torch.int64)
            self.keys.copy_(words)

    def frame(self, t: int) -> torch.Tensor:
        return self.next_frame(self.keys[t], t)

    def step(self, prev: torch.Tensor, t: int) -> torch.Tensor:
        out = self.pipe.step(prev, self.frame(t), text=self.text)
        self.pos[t].copy_(out[1])
        self.digests[t].copy_(step_digest(self.cfg, out))
        return out[0]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _blocks(counts, blocks) -> np.ndarray:
    """The per-unit blocks concatenated by their counts."""
    return np.concatenate([blocks[u, :c] for u, c in enumerate(counts)])


def _expect_equal(label, what, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"[{label}] {what}: shape {got.shape}, "
                             f"step_oracle {want.shape}")
    if not np.array_equal(got, want):
        raise AssertionError(f"[{label}] {what}: "
                             f"{np.count_nonzero(got != want)} entries "
                             f"differ from step_oracle")


def gate(chain: BenchChain, label: str = "") -> int:
    """One step of the chain's first frame from its background, byte for
    byte against ``step_oracle``: ``pos``, the payload (flat: ``xs[:pos]``
    and ``vals[:pos]``; tiled: the blocks concatenated by their counts;
    bitmask-only: the indices of the set bits, LSB first, and the vals
    blocks by their counts), ``new_prev`` and the aux frame. Raises
    ``AssertionError`` on any difference; returns ``pos``."""
    from cudavideostream_tpu_torch.ops import reference_cpu as ref
    from cudavideostream_tpu_torch.utils import fonts

    cfg, pipe = chain.cfg, chain.pipe
    frame = chain.frame(0)
    out = pipe.step(chain.init.clone(), frame, text=chain.text)
    new_prev, pos, xs, vals, aux = payload_parts(cfg, out)
    pos = int(pos)
    if cfg.maskonly_payload:
        counts = _host(out[2])
        vals = _blocks(counts, _host(vals))
        xs = np.flatnonzero(np.unpackbits(_host(xs), bitorder="little"))
        if xs.size != pos:
            raise AssertionError(f"[{label}] {xs.size} bits set, pos {pos}")
    elif cfg.tiled_payload:
        counts = _host(out[2])
        xs = _blocks(counts, _host(xs))
        vals = _blocks(counts, _host(vals))
    else:
        xs, vals = _host(xs)[:pos], _host(vals)[:pos]
    exp_prev, exp_pos, exp_xs, exp_vals, exp_aux = ref.step_oracle(
        _host(chain.init), _host(frame), cfg, atlas=pipe.atlas_np,
        char_ids=fonts.encode_text(chain.text))
    if pos != exp_pos:
        raise AssertionError(f"[{label}] pos {pos}, step_oracle {exp_pos}")
    _expect_equal(label, "xs", xs, exp_xs)
    _expect_equal(label, "vals", vals, exp_vals)
    _expect_equal(label, "new_prev", _host(new_prev), exp_prev)
    if (aux is None) != (exp_aux is None):
        raise AssertionError(f"[{label}] aux frame present in one of the "
                             f"step and step_oracle only")
    if aux is not None:
        _expect_equal(label, "aux", _host(aux), exp_aux)
    print(f"[{label}] byte-exact vs oracle: OK (pos={pos})", file=sys.stderr)
    return pos


def run_config(cfg, text: str, frames: int, iters: int,
               skip_check: bool = False, label: str = "",
               noise_bank: int = 8, device=None, on_capture=None) -> dict:
    """fps of the step under ``cfg``, T = ``frames`` steps chained in one
    CUDA graph and replayed ``iters`` times, gated by :func:`gate`.

    Returns a dict: ``fps`` (median over the replays of T / the replay's
    CUDA-event time; they follow one untimed replay, the graph's upload,
    as the JAX bench times its scans after a first one), ``samples``
    (every replay's fps, ascending), ``eager_fps`` and ``eager_samples``
    (the same T steps launched eagerly, each pass from the state one more
    replay starts from, which must give the same ``pos``, digests and
    state), ``peak_bytes``
    (``torch.cuda.max_memory_allocated`` from the capture's warm-up to
    the end), ``pos`` and ``digests`` of the last replay, the gate's
    ``gate_pos`` and ``device``. ``on_capture(chain_graph)``, if given,
    sees the graph before its first replay.

    On the CPU (``device="cpu"``) the same steps run eagerly: two passes
    as the warm-up, then ``iters`` timed by the host clock
    (``host_ms_per_step``); ``fps`` is None, since no device was
    timed."""
    from cudavideostream_tpu_torch.utils.timing import ChainGraph

    chain = BenchChain(cfg, text, frames, noise_bank, device)
    dev = chain.device
    gen = torch.Generator().manual_seed(KEY_SEED)
    chain.refill_keys(gen)
    gate_pos = None if skip_check else gate(chain, label)
    carry = chain.init.clone()  # the state; the background stays as it is
    result = {"device": "cpu", "gate_pos": gate_pos}
    if dev.type == "cpu":
        for _ in range(ChainGraph.WARMUP_PASSES):
            for t in range(frames):
                carry = chain.step(carry, t)
        t0 = time.perf_counter()
        for _ in range(iters):
            chain.refill_keys(gen)
            for t in range(frames):
                carry = chain.step(carry, t)
        ms = 1e3 * (time.perf_counter() - t0) / (iters * frames)
        print(f"[{label}] CPU, plain PyTorch versions: {ms:.3f} ms a step "
              f"on the host clock (not a device metric); pos="
              f"{chain.pos.tolist()[:4]}...", file=sys.stderr)
        return {**result, "fps": None, "host_ms_per_step": ms,
                "pos": chain.pos.tolist(), "digests": chain.digests.tolist()}

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    g = ChainGraph(chain.step, carry, frames)
    torch.cuda.synchronize(dev)
    print(f"[{label}] warm-up (2 x {frames} steps) and capture of "
          f"{frames} steps in one CUDA graph: "
          f"{time.perf_counter() - t0:.2f}s  pos={chain.pos.tolist()[:4]}...",
          file=sys.stderr)
    if on_capture is not None:
        on_capture(g)
    g.replay()  # the graph's upload; the timed replays go on from it
    with torch.cuda.stream(g.stream):
        pairs = []
        for _ in range(iters):
            chain.refill_keys(gen)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            pairs.append((start, end))
    torch.cuda.synchronize(dev)
    samples = sorted(frames / (s.elapsed_time(e) / 1e3) for s, e in pairs)
    eager = _eager_against_graph(chain, g, iters, gen, label)
    peak = torch.cuda.max_memory_allocated(dev)
    fps = statistics.median(samples)
    print(f"[{label}] per-replay fps samples (CUDA events, {frames} steps a "
          f"replay): " + " ".join(f"{f:.2f}" for f in samples),
          file=sys.stderr)
    print(f"[{label}] eager loop of the same {frames} steps, fps samples: "
          + " ".join(f"{f:.2f}" for f in eager), file=sys.stderr)
    print(f"[{label}] peak device memory {peak} B "
          f"(torch.cuda.max_memory_allocated, warm-up to the end)",
          file=sys.stderr)
    return {**result, "device": torch.cuda.get_device_name(dev), "fps": fps,
            "samples": samples, "eager_fps": statistics.median(eager),
            "eager_samples": eager, "peak_bytes": peak,
            "pos": chain.pos.tolist(), "digests": chain.digests.tolist()}


def _eager_against_graph(chain, g, iters, gen, label):
    """fps of the chain's T steps launched eagerly (CUDA events), each
    pass from the state a replay starts from, on the graph's stream; the
    replay and the eager pass must agree on every step's ``pos`` and
    digest and on the state. The first of ``iters + 1`` passes is not
    timed (it grows the allocator's pool outside the graph's). Returns
    the eager fps samples, ascending."""
    samples = []
    with torch.cuda.stream(g.stream):
        for i in range(iters + 1):
            chain.refill_keys(gen)
            start_state = g.carry.clone()
            g.replay()
            want = (chain.pos.clone(), chain.digests.clone(),
                    g.carry.clone())
            g.carry.copy_(start_state)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            carry = g.carry
            for t in range(chain.frames):
                carry = chain.step(carry, t)
            end.record()
            end.synchronize()
            for what, a, b in zip(("pos", "digests", "state"), want,
                                  (chain.pos, chain.digests, carry)):
                if not torch.equal(a, b):
                    raise AssertionError(f"[{label}] the graph replay and "
                                         f"the eager steps differ in {what}")
            if i:
                samples.append(chain.frames
                               / (start.elapsed_time(end) / 1e3))
    return sorted(samples)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({e})"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cudavideostream_tpu_torch.bench",
        description="1080p fps of the fused step, CUDA-graph-chained on "
                    "the card, gated byte-exact against the spec")
    p.add_argument("--frames", type=int, default=48,
                   help="steps in the CUDA graph")
    p.add_argument("--iters", type=int, default=9, help="graph replays")
    p.add_argument("--full", action="store_true",
                   help="also print the per-kernel table on stderr "
                        "(kernel_table.py)")
    p.add_argument("--skip-check", action="store_true")
    p.add_argument("--emit", default="tiled", choices=["tiled", "flat"],
                   help="payload layout for the headline (tiled = the "
                        "product wire path; flat = the library API)")
    p.add_argument("--subtile", type=int, default=None,
                   help="override config.subtile_rows for the headline")
    p.add_argument("--noise-bank", type=int, default=8,
                   help="pre-generated noise planes for the device source "
                        "(0 = hash 6.2M bytes a frame from the key words "
                        "of each step)")
    p.add_argument("--all-variants", action="store_true",
                   help="also bench every named pipeline variant, each in "
                        "its own process; writes build/bench/variants.json")
    p.add_argument("--one-variant", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None,
                   help="cpu: the plain PyTorch versions at 48x64, no "
                        "device metric (default: the card)")
    return p


def _config(args, cfg):
    """``cfg`` at the bench's size: 1080p on the card, 48x64 on the CPU
    (the JAX bench's size on a CPU backend)."""
    from cudavideostream_tpu_torch.models.pipeline import resolve_device

    if resolve_device(args.device).type == "cpu":
        cfg = dataclasses.replace(cfg, height=CPU_HEIGHT, width=CPU_WIDTH)
    return cfg


def _line(metric: str, fps) -> str:
    return json.dumps({
        "metric": metric,
        "value": None if fps is None else round(fps, 2),
        "unit": "fps",
        "vs_baseline": None if fps is None else round(fps / BASELINE_FPS, 2),
    })


def main(argv=None) -> int:
    from cudavideostream_tpu_torch.config import StreamConfig
    from cudavideostream_tpu_torch.models.pipeline import resolve_device

    p = _parser()
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"bench: card {card_line()} (nvidia-smi name, power.limit)",
              file=sys.stderr)
    if args.one_variant:
        return _one_variant(args)
    cfg = _config(args, StreamConfig(tiled_payload=(args.emit == "tiled")))
    if args.subtile is not None:
        cfg = dataclasses.replace(cfg, subtile_rows=args.subtile)
    print(f"bench: {cfg.height}x{cfg.width} on {device} (emit={args.emit})",
          file=sys.stderr)
    res = run_config(cfg, TEXT, args.frames, args.iters, args.skip_check,
                     label="headline", noise_bank=args.noise_bank,
                     device=device)
    if args.full:
        from cudavideostream_tpu_torch import kernel_table

        kernel_table.run(device=device, file=sys.stderr)
    failed = _all_variants(args) if args.all_variants else []
    print(_line(METRIC, res["fps"]), flush=True)
    return 1 if failed else 0


def _all_variants(args) -> list:
    """Bench every named variant, each in a process of its own (one
    1080p pipeline per process, as the JAX bench does). Prints the table
    on stderr and writes it to :data:`VARIANTS_JSON` when none failed;
    returns the names that failed."""
    from cudavideostream_tpu_torch.models import variants as variants_mod

    results, failed = {}, []
    for name in variants_mod.available():
        cmd = [sys.executable, "-m", "cudavideostream_tpu_torch.bench",
               "--one-variant", name, "--emit", args.emit,
               "--frames", str(args.frames), "--iters", str(args.iters),
               "--noise-bank", str(args.noise_bank)]
        if args.skip_check:
            cmd.append("--skip-check")
        if args.device is not None:
            cmd += ["--device", args.device]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  cwd=REPO, timeout=VARIANT_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            failed.append(name)
            print(f"[{name}] FAILED: no end in {e.timeout} s",
                  file=sys.stderr)
            continue
        rec = None
        for line in proc.stdout.splitlines():
            try:
                got = json.loads(line)
            except ValueError:
                continue
            if isinstance(got, dict) and got.get(
                    "metric") == f"variant_fps:{name}":
                rec = got
        if proc.returncode != 0 or rec is None:
            # a child whose byte-exact gate raised fails the whole run
            failed.append(name)
            print(f"[{name}] FAILED (rc={proc.returncode}):\n{proc.stdout}\n"
                  f"{proc.stderr}", file=sys.stderr)
            continue
        results[name] = rec["value"]
        shown = ("no device metric" if rec["value"] is None else
                 f"{rec['value']:9.2f} fps  "
                 f"({rec['value'] / BASELINE_FPS:.1f}x baseline)")
        print(f"[{name}] {shown}", file=sys.stderr)
    if failed:
        print(f"NOT writing {VARIANTS_JSON}: failed variants {failed}",
              file=sys.stderr)
    else:
        os.makedirs(VARIANTS_JSON.parent, exist_ok=True)
        with open(VARIANTS_JSON, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {VARIANTS_JSON}", file=sys.stderr)
    return failed


def _one_variant(args) -> int:
    """Bench ONE named variant in this process; its one stdout line is
    ``{"metric": "variant_fps:<name>", ...}``, which the
    ``--all-variants`` parent reads."""
    from cudavideostream_tpu_torch.models import variants as variants_mod

    vcfg = variants_mod.get_config(args.one_variant)
    if not vcfg.maskonly_payload:
        # the bitmask-only emission is tiled; every other variant runs
        # under the requested emit
        vcfg = dataclasses.replace(vcfg,
                                   tiled_payload=(args.emit == "tiled"))
    vcfg = _config(args, vcfg)
    res = run_config(vcfg, TEXT, args.frames, args.iters, args.skip_check,
                     label=args.one_variant, noise_bank=args.noise_bank,
                     device=args.device)
    print(_line(f"variant_fps:{args.one_variant}", res["fps"]),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
