"""One run of one cell: set-up, the measured window or the traced slice,
and the comparison with the plain reference.

The cell's configuration (``configs/<name>.json``) and traffic mix
(``traffic/<name>.json``) are found by the names that ``BENCHMARK.json``
gives; each per-layer metric by its name (``metrics/<name>.py``).

What the window drives is the port's own step, one of:

* one camera: ``models/pipeline.py`` ``DeltaStreamPipeline.step(prev,
  frame, text)``;
* B cameras: ``models/batched.py`` ``BatchedDeltaPipeline.step(prev,
  frames, texts)``, every stream with the same status text.

T steps, one a frame of the bank that set-up made on the card, are
captured into one CUDA graph (:class:`Chain`, a copy of the method of the
port's ``utils/timing.ChainGraph``: two eager passes on the capture
stream, then the capture) and replayed back to back. Each step's payload
blocks and side outputs (the visualizer's aux frame, the change bits)
stay alive in the graph's pool, as an executor holds a frame's until it
lands; the state is updated in place. The window syncs only to
keep at most ``QUEUE_DEPTH`` replays queued.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cvsbench import check, scene, trace

ROOT = Path(__file__).resolve().parents[1]
# The CPU mode's frame: the smallest in which the status text's 50-row
# glyph cells are drawn, as at 1080p.
CPU_HEIGHT, CPU_WIDTH = 64, 96
QUEUE_DEPTH = 3
PROFILE_PAD_S = 0.05    # host sleep at each end of a traced slice
TRACE_ATTEMPTS = 3      # the profiler now and then loses records
# CUgraphNodeType: kernel, memcpy, memset
DEVICE_NODE_TYPES = (0, 1, 2)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _for_cell(metrics: List[Dict], name: str) -> List[Dict]:
    return [m for m in metrics if name in m.get("workloads", [name])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its
    configuration and traffic files and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "cvsbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


def stream_config(stream: Dict):
    """The port's ``StreamConfig`` from a configuration's ``stream``
    block (``visualizer`` by number, ``compaction`` by value)."""
    from cudavideostream_tpu_torch.config import (
        CompactionBackend,
        StreamConfig,
        Visualizer,
    )

    kw = dict(stream)
    kw["visualizer"] = Visualizer(kw["visualizer"])
    kw["compaction"] = CompactionBackend(kw["compaction"])
    return StreamConfig(**kw)


class Program:
    """The system under test: the port's pipeline for B streams. Its
    :meth:`step` takes the flat state and the frames ``(B, n)`` and
    returns ``(pos (B,), counts (B, U), xs_t (B, U, unit), vals_t (B, U,
    unit), side)``, the tiled payload blocks and the side outputs the
    configuration asks for (``check.side_outputs``): ``side["aux"]`` ``(B,
    n)`` where ``visualizer`` is not 0, ``side["bits"]`` ``(B, n_pad /
    8)`` under ``emit_bitmask``. The state is updated in place."""

    def __init__(self, stream: Dict, streams: int, text: str, device):
        from cudavideostream_tpu_torch.models import (
            BatchedDeltaPipeline,
            DeltaStreamPipeline,
        )

        cfg = stream_config(stream)
        if not cfg.tiled_payload:
            raise ValueError("the benchmark reads the tiled payload")
        if cfg.maskonly_payload:
            raise ValueError("the benchmark does not check the mask-only "
                             "payload (maskonly_payload): it has no index "
                             "blocks")
        if cfg.emit_bitmask and streams > 1:
            raise ValueError("the batched step hands back no change bits: "
                             "emit_bitmask runs one stream")
        self.sides = check.side_outputs(stream)
        self.streams = streams
        self.text = text
        if streams == 1:
            self.pipe = DeltaStreamPipeline(cfg, device=device)
        else:
            self.pipe = BatchedDeltaPipeline(cfg, streams, device=device)
            self.texts = [text] * streams

    def step(self, state: torch.Tensor, frames: torch.Tensor):
        # the port's forms: (new_prev, pos, counts, xs_t, vals_t, aux),
        # with the bits before aux under emit_bitmask (one stream only)
        if self.streams == 1:
            out = self.pipe.step(state, frames[0], text=self.text)
            pos, counts, xs_t, vals_t = (out[1].view(1), out[2].view(1, -1),
                                         out[3].unsqueeze(0),
                                         out[4].unsqueeze(0))
        else:
            out = self.pipe.step(state, frames, self.texts)
            pos, counts, xs_t, vals_t = out[1:5]
        side = {}
        if "aux" in self.sides:
            side["aux"] = out[-1].view(self.streams, -1)
        if "bits" in self.sides:
            side["bits"] = out[5].view(self.streams, -1)
        return pos, counts, xs_t, vals_t, side


class Chain:
    """The T steps of the bank, ``program.step(state, bank[t])``,
    captured into one CUDA graph on a side stream and replayed there, or,
    on the CPU, run eagerly. :attr:`outs` holds each step's outputs, which
    every replay rewrites."""

    WARMUP_PASSES = 2

    def __init__(self, program: Program, bank: torch.Tensor,
                 state: torch.Tensor):
        self.program, self.bank, self.state = program, bank, state
        self.outs: List[Tuple[torch.Tensor, ...]] = [None] * bank.shape[0]
        self.cuda = state.device.type == "cuda"
        self.graph = None
        if not self.cuda:
            return
        self.stream = torch.cuda.Stream(state.device)
        self.stream.wait_stream(torch.cuda.current_stream(state.device))
        with torch.cuda.stream(self.stream):
            for _ in range(self.WARMUP_PASSES):
                self._steps()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            self._steps()
        self.graph.instantiate()

    def _steps(self) -> None:
        for t in range(self.bank.shape[0]):
            self.outs[t] = self.program.step(self.state, self.bank[t])

    def replay(self) -> None:
        if self.graph is None:
            self._steps()
            return
        with torch.cuda.stream(self.stream):
            self.graph.replay()

    def copy_state(self, dst: torch.Tensor,
                   src: Optional[torch.Tensor] = None) -> None:
        """``dst <- src`` (default: the state), in order with the steps."""
        src = self.state if src is None else src
        if self.graph is None:
            dst.copy_(src)
            return
        with torch.cuda.stream(self.stream):
            dst.copy_(src)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.state.device)

    def device_nodes(self) -> Optional[int]:
        """The graph's kernel, memcpy and memset nodes, read with the CUDA
        driver's ``cuGraphGetNodes``; None where it cannot say."""
        try:
            cu = ctypes.CDLL("libcuda.so.1")
            handle = ctypes.c_void_p(self.graph.raw_cuda_graph())
            count = ctypes.c_size_t(0)
            if cu.cuGraphGetNodes(handle, None, ctypes.byref(count)):
                return None
            nodes = (ctypes.c_void_p * count.value)()
            if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)):
                return None
            kinds = []
            for node in nodes:
                kind = ctypes.c_int()
                if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                         ctypes.byref(kind)):
                    return None
                kinds.append(kind.value)
            return sum(k in DEVICE_NODE_TYPES for k in kinds)
        except (OSError, AttributeError, RuntimeError):
            return None


def window(chain: Chain, seconds: float, entry: torch.Tensor):
    """Replays back to back until ``seconds`` have passed, then the state
    into ``entry`` and one last replay (the one the check reads), and a
    synchronise. Returns ``(replays, wall seconds, start time, note)``:
    the wall time runs from before the first replay to the end of the
    last; the note gives the device's time in and between the replays,
    from a pair of CUDA events around each."""
    marks = []
    chain.sync()
    t_start = time.perf_counter()
    replays = 0
    while True:
        marks.append(_event(chain))
        chain.replay()
        marks.append(_event(chain))
        replays += 1
        if chain.cuda and replays > QUEUE_DEPTH:
            marks[-2 * QUEUE_DEPTH - 1].synchronize()
        if time.perf_counter() - t_start >= seconds:
            break
    chain.copy_state(entry)
    chain.replay()
    chain.sync()
    wall = time.perf_counter() - t_start
    note = ""
    if chain.cuda:
        inside = sorted(a.elapsed_time(b) for a, b in zip(marks[::2],
                                                         marks[1::2]))
        between = sum(b.elapsed_time(a) for a, b in zip(marks[2::2],
                                                        marks[1:-1:2]))
        note = (f"; replays on the device {inside[0]:.4f} / "
                f"{inside[len(inside) // 2]:.4f} / {inside[-1]:.4f} ms "
                f"(least / median / most), {between:.3f} ms idle between "
                f"them")
    return replays + 1, wall, t_start, note


def _event(chain: Chain):
    if not chain.cuda:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(chain.stream)
    return ev


def traced_slice(chain: Chain, replays: int) -> Tuple[List[trace.Record],
                                                      int, Optional[int]]:
    """``replays`` replays under ``torch.profiler``, taken again (at most
    ``TRACE_ATTEMPTS`` times) while it holds another number of device
    records than the graph's device nodes times ``replays``. Returns the
    fullest trace's records, the attempts and the nodes a replay."""
    from torch.profiler import ProfilerActivity, profile

    if not chain.cuda:  # no device, nothing to trace
        for _ in range(replays):
            chain.replay()
        return [], 0, None
    nodes = chain.device_nodes()
    best: List[trace.Record] = []
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        chain.sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(replays):
                chain.replay()
            chain.sync()
            time.sleep(PROFILE_PAD_S)
        recs = [trace.Record(e.name, float(e.time_range.start),
                             float(e.time_range.end))
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(recs) > len(best):
            best = recs
        if nodes is None or len(recs) == nodes * replays:
            best = recs
            break
    best.sort(key=lambda r: r.start_us)
    return best, attempt, nodes


def host_outputs(chain: Chain, start: torch.Tensor, entry: torch.Tensor,
                 streams: int) -> check.Outputs:
    """The program's outputs as host arrays: the three states and each
    step of the last replay, its blocks read in order by their counts,
    with its side outputs."""
    n = chain.state.numel() // streams
    pos, counts, xs, vals = [], [], [], []
    side = {name: [] for name in chain.outs[0][4]}
    for p, c, x, v, s in chain.outs:
        keep = (torch.arange(x.shape[-1], device=x.device)
                < c.to(torch.int64)[..., None])
        pos.append(p.to(torch.int64).cpu().numpy())
        counts.append([c[b].to(torch.int64).cpu().numpy()
                       for b in range(streams)])
        xs.append([x[b][keep[b]].cpu().numpy() for b in range(streams)])
        vals.append([v[b][keep[b]].cpu().numpy() for b in range(streams)])
        for name, a in s.items():
            side[name].append(list(a.cpu().numpy()))

    def host(t):
        return t.cpu().numpy().reshape(streams, n)

    return check.Outputs(start=host(start), entry=host(entry),
                         final=host(chain.state), pos=np.stack(pos),
                         counts=counts, xs=xs, vals=vals, side=side)


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t0: Optional[float] = None):
    """One run; returns ``(result, check lines)``: the result line's
    object (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last)
    and one line a compared number. ``t0``: the process's first
    perf_counter reading, from which set-up is timed."""
    t0 = time.perf_counter() if t0 is None else t0
    gpu = device == "cuda"
    dev = torch.device("cuda", 0) if gpu else torch.device(device)
    traffic, config = cell.traffic, cell.config
    streams, frames_n = int(traffic["streams"]), int(traffic["bank_frames"])
    stream = dict(config["stream"])
    if not gpu:
        stream.update(height=CPU_HEIGHT, width=CPU_WIDTH)
    h, w = stream["height"], stream["width"]
    text = config["text"]
    if gpu:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    marks = [("imports and CUDA start", time.perf_counter())]
    bank, base = scene.make_bank(traffic, h, w, seed, dev)
    if gpu:
        torch.cuda.synchronize(dev)
    marks.append(("bank", time.perf_counter()))
    program = Program(stream, streams, text, dev)
    state = base.reshape(-1).clone()
    marks.append(("pipeline", time.perf_counter()))
    chain = Chain(program, bank, state)
    marks.append(("warm-up and capture", time.perf_counter()))
    start, entry = torch.empty_like(state), torch.empty_like(state)
    # the graph's first replay runs from the base frame; the check follows
    # it from there
    chain.copy_state(state, base.reshape(-1))
    chain.replay()
    chain.copy_state(start)
    for _ in range(int(traffic["warm_replays"])):
        chain.replay()
    chain.sync()
    marks.append(("first replays", time.perf_counter()))
    notes = ["setup: " + ", ".join(
        f"{name} {t - t_prev:.3f} s" for (name, t), t_prev in
        zip(marks, [t0] + [t for _, t in marks]))]

    per_frame = frames_n * streams
    metrics: Dict = {}
    device_info: Dict = {"platform": "gpu" if gpu else "cpu",
                         "kind": (torch.cuda.get_device_name(dev) if gpu
                                  else "cpu"),
                         "count": cell.chips if gpu else 0,
                         "memory_peak_bytes": 0}
    if traced:
        records, attempts, nodes = traced_slice(
            chain, int(traffic["trace_replays"]))
        slice_frames = int(traffic["trace_replays"]) * per_frame
        chain.sync()
        chain.copy_state(entry)
        chain.replay()
        chain.sync()
        attempted = (int(traffic["trace_replays"]) + 1) * per_frame
    else:
        replays, wall_s, t_start, note = window(chain, seconds, entry)
        attempted = replays * per_frame
        values = {"fps": attempted / wall_s, "setup_s": t_start - t0}
        notes.append(f"window: {replays} replays in {wall_s:.3f} s{note}")
    if gpu:
        device_info["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(dev))

    t_check = time.perf_counter()
    out = host_outputs(chain, start, entry, streams)
    unit_bytes = int(chain.outs[0][2].shape[-1])
    frames_host = bank.cpu().numpy()
    base_host = base.cpu().numpy()
    del chain, program, bank, base, state, start, entry
    if gpu:
        torch.cuda.empty_cache()
    numbers = check.compare(check.reference_step(config, stream),
                            frames_host, base_host, out, unit_bytes)
    ok = check.verdict(numbers, stream)

    result = {"correct": ok, "attempted": attempted,
              "failed": numbers["frames_failed"]}
    notes.append(f"check: {time.perf_counter() - t_check:.3f} s")
    if traced:
        sl = trace.Slice(
            records=records, frames=slice_frames,
            busy_s=trace.busy_us(records) * 1e-6,
            window_s=trace.span_us(records) * 1e-6,
            frame_bytes=h * w * 3, pos_mean=float(out.pos.mean()),
            stream=stream)
        # a trace that lost records would read every metric wrong: it
        # gives none
        whole = gpu and nodes is not None and len(records) == nodes * int(
            traffic["trace_replays"])
        for m in cell.per_layer:
            reader = importlib.import_module(f"cvsbench.metrics.{m['name']}")
            v = reader.read(sl) if whole else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if whole:
            device_info.update(busy_s=sl.busy_s, window_s=sl.window_s)
            result_breakdown = trace.breakdown(records)
        notes.append(f"trace: {len(records)} device records over "
                     f"{slice_frames} camera frames, {attempts} attempt(s), "
                     f"{nodes} device nodes a replay")
        if gpu and not whole:
            notes.append("trace: not the graph's device nodes times the "
                         "replays, so no per-layer metric is reported")
    elif gpu:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    result["metrics"] = metrics
    result["device"] = device_info
    if traced and whole:
        result["breakdown"] = result_breakdown
    result["checks"] = check.as_json(numbers, stream)
    return result, notes + check.lines(numbers, stream)
