"""Streaming executor: drives the pipeline and lands payloads on the host
(port of the JAX package's ``StreamExecutor``, ``TiledLander``,
``PipelinedExecutor`` and ``BatchedLandExecutor``).

The reference's variable-length device-to-host copy is two
``cudaMemcpyAsync`` calls sized by ``pos`` after a sync
(``kernels.cu:507-524``). The same here: right behind each step the
executor queues the copy of the frame's sizes (``pos``, and the per-unit
``counts`` of a tiled payload) into pinned host memory and marks them
with an event; landing waits for that event only, then copies what the
sizes say on a side stream (the landing stream) and waits for that.

Waiting on the event and copying on the side stream is what lets
:class:`PipelinedExecutor` overlap: it lands frame N-1 after dispatching
frame N, and a blocking ``.cpu()`` on the step's stream would queue
behind frame N's kernels. The event of frame N-1 was recorded before
frame N's kernels, and the landing stream runs beside them.

The JAX executor's tiered static slices, fetch rungs, speculative windows,
host-authored overlay landings and link cache exist for XLA's static
shapes and a ~30 ms host-to-TPU round trip; eager PyTorch slices at any
length, and the card's copies take microseconds (``ROADMAP.md`` says where
each of those mechanisms goes).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from cudavideostream_tpu_torch.config import PayloadOverflowError, StreamConfig
from cudavideostream_tpu_torch.models.pipeline import DeltaStreamPipeline
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.runtime import wire

# per-byte-value popcount / set-bit-position tables for the bitmask
# rebuild (LSB-first: bit k of byte j is frame byte 8*j + k)
_POPCOUNT = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1, bitorder="little"
).sum(axis=1).astype(np.intp)
_BITPOS = np.zeros((256, 8), np.uint8)
for _v in range(256):
    _idx = np.flatnonzero(np.unpackbits(np.uint8([_v]), bitorder="little"))
    _BITPOS[_v, : _idx.size] = _idx
del _v, _idx


def _tensors(x) -> list:
    """The tensors of a step output: one tensor, or a list of them (one
    per shard of a sharded step)."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


class _Staged:
    """One dispatched frame: its step outputs past ``new_prev`` (the
    visualizer's aux frame last, or None), and host copies of its sizes
    queued behind the step and marked by an event on each device they
    come from. A size, and the aux, may be a list of per-shard tensors
    (``parallel.sharded``): it lands as a list of arrays, and the aux
    frame as the shards' frames joined by ``aux_join``."""

    def __init__(self, outs, n_sizes: int, aux_join=np.concatenate):
        self.outs = outs
        self.aux = outs[-1]
        self.aux_join = aux_join
        self.aux_host = None  # the landed aux, once a copy has run
        self.events = {}      # device -> the event after the step's work
        self.sizes = []
        for x in outs[:n_sizes]:
            # non-blocking device-to-host copies land in pinned memory
            host = [t.to("cpu", non_blocking=True) if t.is_cuda else t
                    for t in _tensors(x)]
            self.sizes.append(host if isinstance(x, (list, tuple))
                              else host[0])
            for t in _tensors(x):
                if t.is_cuda and t.device not in self.events:
                    ev = self.events[t.device] = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(t.device))

    def wait(self):
        for ev in self.events.values():
            ev.synchronize()
        return [[t.numpy() for t in x] if isinstance(x, list) else x.numpy()
                for x in self.sizes]


class _Copier:
    """Device work of a landing, on the landing stream behind a frame's
    event, and its device-to-host copies (host arrays on return). The
    frame's aux frame rides along with the first copy of the frame, so
    landing it adds no wait on the device."""

    def __init__(self, device: torch.device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # the key under which a frame's tensors record their events
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._streams = {}  # the landing stream of each CUDA device

    def _stream(self, dev: torch.device) -> torch.cuda.Stream:
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        return stream

    def _aux(self, staged: _Staged) -> list:
        """The aux tensors still to copy with this landing."""
        if staged.aux is None or staged.aux_host is not None:
            return []
        return _tensors(staged.aux)

    def _set_aux(self, staged: _Staged, aux: list, host: list) -> list:
        if aux:
            parts = host[len(host) - len(aux):]
            del host[len(host) - len(aux):]
            staged.aux_host = (staged.aux_join(parts)
                               if isinstance(staged.aux, list) else parts[0])
        return host

    def run(self, staged: _Staged, fn):
        """``fn()`` returns the device tensors to copy, all on this
        copier's device (``fn`` may launch work there, on the landing
        stream); returns them as host arrays once the copies are done,
        and sets ``staged.aux_host``."""
        aux = self._aux(staged)
        if self.device.type != "cuda":
            return self._set_aux(staged, aux,
                                 [t.numpy() for t in [*fn(), *aux]])
        stream = self._stream(self.device)
        with torch.cuda.stream(stream):
            stream.wait_event(staged.events[self.device])
            host = [t.to("cpu", non_blocking=True) for t in [*fn(), *aux]]
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
        return self._set_aux(staged, aux, [t.numpy() for t in host])

    def run_views(self, staged: _Staged, views):
        """Copy ``views`` (device tensors from any of the frame's devices,
        with no work left to run on them: slices of the step's outputs)
        to the host, each on its own device's landing stream behind that
        device's event; one wait for them all. Returns host arrays and
        sets ``staged.aux_host``, as :meth:`run` does."""
        aux = self._aux(staged)
        host, used = [], {}
        for t in [*views, *aux]:
            if not t.is_cuda:
                host.append(t)
                continue
            stream = self._stream(t.device)
            with torch.cuda.stream(stream):
                if t.device not in used:
                    stream.wait_event(staged.events[t.device])
                    used[t.device] = stream
                host.append(t.to("cpu", non_blocking=True))
        dones = []
        for stream in used.values():
            ev = torch.cuda.Event()
            ev.record(stream)
            dones.append(ev)
        for ev in dones:
            ev.synchronize()
        return self._set_aux(staged, aux, [t.numpy() for t in host])

    def land_aux(self, staged: _Staged):
        """The frame's aux frame as a host array (None without one),
        copied now unless a landing copy already brought it."""
        if staged.aux is not None and staged.aux_host is None:
            self.run_views(staged, [])
        return staged.aux_host


class TiledLander:
    """Landing of per-unit payload blocks, in one of four flavors:

    * ``tiles``: find the non-empty unit span ``[t_lo, t_hi)`` from the
      host counts, narrow that block range's ``xs`` to unit-local
      uint8/uint16 on the device, copy it with its ``vals``, and rebuild
      global indices on the host: a :class:`~.wire.TiledPayload`;
    * ``flat``: merge the blocks on the device (``logcompact.merge_tiles``,
      one K2 launch) and copy the ``pos``-long prefixes: flat ``(xs,
      vals)``;
    * ``mask`` (payloads with packed bits): merge the vals on the device
      (``merge_vals``, one K3 launch, for the bitmask-only emission; the
      vals half of ``merge_tiles`` when index blocks exist) and copy the
      ``pos``-long vals prefix and the span's bits. The result is a
      :class:`~.wire.MaskPayload` under ``return_mask`` (wire v4 forwards
      the bits), else flat ``(xs, vals)`` rebuilt from the bits on the
      host (:meth:`rebuild_mask_xs`). The only flavor that can land a
      bitmask-only payload;
    * ``auto``: per frame, the flavor the JAX byte model
      (``TiledLander._pick_kind``) predicts to be fastest, with numbers
      measured here in place of the tunnel's link statistics: the rate
      of a whole ``tiles`` landing (copy and host rebuild) in bytes of
      span, and what each other flavor's landing takes beyond its bytes
      at that rate (its merge and host work). A flavor is measured after
      its second non-empty landing (the first pays first-use allocations
      and is not timed); until every offered flavor is measured, ``auto``
      takes the first unmeasured one, ``tiles`` first.

    A frame that changed nothing (no non-empty unit) lands as an empty
    result of the fixed flavor, or of ``tiles`` under ``auto``, with no
    device work, and teaches ``auto`` nothing. The wire bytes are the
    same whichever flavor lands; ``fetch_counts`` records the choices.

    Two landings serve the sharded pipeline (``parallel.sharded``), whose
    shards' blocks may lie on several devices and hold global indices
    (K1's ``index_offset``): :meth:`land_shard_spans`, the ``tiles``
    flavor over every shard's units, and the ``shards`` flavor of
    :meth:`land_many` (``multiserve --mesh``), each shard one tile. Both
    copy the blocks from the device that holds each shard, int32 as they
    are: a shard pads to whole units, so unit ``t`` of the concatenated
    shards does not start at byte ``t * unit_bytes`` and the unit-local
    narrowing of ``tiles`` would not rebuild its indices.
    """

    #: weight of the newest measurement in the rate and extra-time EMAs
    ALPHA = 0.3

    def __init__(self, mode: str = "auto", return_mask: bool = False):
        if mode not in ("auto", "tiles", "flat", "mask", "shards"):
            raise ValueError(f"unknown landing flavor {mode!r}")
        self.mode = mode
        self.return_mask = return_mask
        self.fetch_counts = {"tiles": 0, "flat": 0, "mask": 0}
        # non-empty landings per flavor (the first of each is not timed)
        self._landed = {"tiles": 0, "flat": 0, "mask": 0}
        self.copy_bytes_per_s: Optional[float] = None
        # per flavor: what a landing takes beyond its bytes at that rate
        self.extra_s = {"flat": None, "mask": None}

    @staticmethod
    def compact_dtype(unit_bytes: int):
        """Narrowest host dtype of a unit-local index (the JAX
        ``_compact_dtype``), or None where int32 stays."""
        if unit_bytes <= 256:
            return np.uint8
        if unit_bytes <= 65536:
            return np.uint16
        return None

    def _measured(self, kind: str) -> bool:
        if kind == "tiles":
            return self.copy_bytes_per_s is not None
        return self.extra_s[kind] is not None

    def pick(self, pos: int, t_lo: int, t_hi: int, unit_bytes: int,
             has_bits: bool) -> str:
        """The per-frame flavor. Under ``auto``: the bytes each flavor
        copies — ``tiles`` ``(1 + xs_bytes)`` per slot of the span,
        ``flat`` 5 per entry, ``mask`` the span's bits (one per 8 slots)
        and one per entry — at the measured rate, plus each flavor's
        measured extra time; ties go to ``tiles``, then ``flat``."""
        if self.mode != "auto":
            return self.mode
        if t_hi == 0:
            return "tiles"
        offered = ("tiles", "flat", "mask") if has_bits else ("tiles", "flat")
        for kind in offered:
            if not self._measured(kind):
                return kind
        narrow = self.compact_dtype(unit_bytes)
        xs_bytes = 4 if narrow is None else np.dtype(narrow).itemsize
        span = (t_hi - t_lo) * unit_bytes
        rate = self.copy_bytes_per_s
        cost = {"tiles": (1 + xs_bytes) * span / rate,
                "flat": self.extra_s["flat"] + 5 * pos / rate}
        if has_bits:
            cost["mask"] = self.extra_s["mask"] + (span // 8 + pos) / rate
        return min(cost, key=cost.get)

    def _ema(self, old: Optional[float], new: float) -> float:
        return new if old is None else old + self.ALPHA * (new - old)

    def _plan(self, pos: int, counts: np.ndarray, unit_bytes: int,
              has_bits: bool):
        """``(t_lo, t_hi, kind)``: the span of non-empty units (``(0, 0)``
        when none) and the flavor that lands it, counted."""
        nz = np.flatnonzero(counts)
        t_lo, t_hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        kind = self.pick(pos, t_lo, t_hi, unit_bytes, has_bits)
        self.fetch_counts[kind] += 1
        return t_lo, t_hi, kind

    def land(self, pos: int, counts: np.ndarray, blocks, staged: _Staged,
             copier: _Copier):
        """Land one frame; ``blocks`` are its device ``(counts, xs_t or
        None, vals_t, bits or None)``. Returns a TiledPayload, a
        MaskPayload or flat ``(xs, vals)``."""
        if self.mode == "shards":
            raise ValueError("the shards flavor lands per-shard blocks "
                             "through land_many")
        counts_d, xs_t_d, vals_t_d, bits_d = blocks
        if xs_t_d is None and self.mode != "mask":
            raise ValueError("bitmask-only payloads land through fetch "
                             "mode 'mask' (no index blocks exist)")
        if self.mode == "mask" and bits_d is None:
            raise ValueError("fetch mode 'mask' needs the pipeline's packed "
                             "bits (config.emit_bitmask)")
        unit_bytes = vals_t_d.shape[1]
        t_lo, t_hi, kind = self._plan(pos, counts, unit_bytes,
                                      bits_d is not None)
        if t_hi == 0:
            return self._empty(kind, counts, unit_bytes)
        t0 = time.perf_counter()
        if kind == "flat":
            def merged():
                xs, vals = logcompact.merge_tiles(counts_d, xs_t_d, vals_t_d)
                return xs[:pos], vals[:pos]

            res = tuple(copier.run(staged, merged))
            nbytes = 5 * pos
        elif kind == "mask":
            def window():
                vals = (logcompact.merge_vals(counts_d, vals_t_d)
                        if xs_t_d is None else
                        logcompact.merge_tiles(counts_d, xs_t_d, vals_t_d)[1])
                return (bits_d[t_lo * unit_bytes // 8: t_hi * unit_bytes // 8],
                        vals[:pos])

            bw, vw = copier.run(staged, window)
            if self.return_mask:
                res = wire.MaskPayload(pos, t_lo * unit_bytes, bw, vw)
            else:
                res = (self.rebuild_mask_xs(bw, pos, t_lo, unit_bytes), vw)
            nbytes = bw.nbytes + vw.nbytes
        else:
            res, nbytes = self._land_tiles(pos, counts, xs_t_d, vals_t_d,
                                           t_lo, t_hi, staged, copier)
        self._learn(kind, nbytes, time.perf_counter() - t0)
        return res

    def _land_tiles(self, pos, counts, xs_t_d, vals_t_d, t_lo, t_hi, staged,
                    copier):
        xw, vw = copier.run(
            staged, lambda: self._tiles_window(xs_t_d, vals_t_d, t_lo, t_hi))
        return self._tiles_payload(pos, counts, xw, vw, t_lo)

    def _tiles_window(self, xs_t_d, vals_t_d, t_lo: int, t_hi: int):
        """The device blocks of units ``[t_lo, t_hi)`` that a ``tiles``
        landing copies, the indices narrowed to unit-local."""
        unit_bytes = xs_t_d.shape[1]
        narrow = self.compact_dtype(unit_bytes)
        xw = xs_t_d[t_lo:t_hi]
        if narrow is not None:
            # unit-local index; the int16 bits are read back as uint16 on
            # the host
            xw = torch.remainder(xw, unit_bytes).to(
                torch.uint8 if narrow is np.uint8 else torch.int16)
        return xw, vals_t_d[t_lo:t_hi]

    def _tiles_payload(self, pos: int, counts: np.ndarray, xw: np.ndarray,
                       vw: np.ndarray, t_lo: int):
        """The TiledPayload of a landed ``tiles`` window, and its bytes."""
        unit_bytes = vw.shape[1]
        t_hi = t_lo + vw.shape[0]
        if self.compact_dtype(unit_bytes) is np.uint16:
            xw = xw.view(np.uint16)
        res = wire.TiledPayload(
            pos, counts[t_lo:t_hi],
            self.rebuild_xs(xw, counts[t_lo:t_hi], t_lo, unit_bytes), vw,
        )
        return res, xw.nbytes + vw.nbytes

    def land_shard_spans(self, pos: int, shards, staged: _Staged,
                         copier: _Copier):
        """The ``tiles`` landing of one frame whose units lie in several
        shards: each item of ``shards`` is one shard's ``(counts_host,
        xs_t_d, vals_t_d)``, its blocks holding global indices. Copies
        every shard's non-empty unit span, int32 as it is, from its own
        device (one wait for all) and returns one TiledPayload of the
        spans in shard order, which is ascending index order."""
        views, spans = [], []
        for counts, xs_t_d, vals_t_d in shards:
            nz = np.flatnonzero(counts)
            if nz.size:
                t_lo, t_hi = int(nz[0]), int(nz[-1]) + 1
                views += [xs_t_d[t_lo:t_hi], vals_t_d[t_lo:t_hi]]
                spans.append(counts[t_lo:t_hi])
        self.fetch_counts["tiles"] += 1
        unit_bytes = shards[0][2].shape[1]
        if not spans:
            return self._empty("tiles", shards[0][0], unit_bytes)
        host = copier.run_views(staged, views)
        return wire.TiledPayload(pos, np.concatenate(spans),
                                 np.concatenate(host[0::2]),
                                 np.concatenate(host[1::2]))

    def _land_shards(self, items, staged: _Staged, copier: _Copier):
        """The ``shards`` flavor of :meth:`land_many`: each item's
        ``xs_t_d`` and ``vals_t_d`` are lists of per-shard ``(Ln,)`` flat
        blocks (global indices, zero past each count), and each shard
        lands as one tile of its count-prefix, copied from its own device
        (every item's copies queued, one wait). A tile's slot count is the
        item's largest count, since only prefixes are read."""
        views = []
        for _, counts, _, xs_d, vals_d in items:
            for c, x, v in zip(counts, xs_d, vals_d):
                if c:
                    views += [x[:int(c)], v[:int(c)]]
        host = iter(copier.run_views(staged, views))
        out = []
        for pos, counts, *_ in items:
            width = max(1, int(np.max(counts)))
            xs_b = np.zeros((len(counts), width), np.int32)
            vals_b = np.zeros((len(counts), width), np.uint8)
            for s, c in enumerate(counts):
                if c:
                    xs_b[s, :c] = next(host)
                    vals_b[s, :c] = next(host)
            self.fetch_counts["tiles"] += 1
            out.append(wire.TiledPayload(pos, counts, xs_b, vals_b))
        return out

    def land_many(self, items, staged: _Staged, copier: _Copier):
        """Land the tiled payloads of several streams from one batched
        step (the JAX ``land_many``). Each item is ``(pos, counts_host,
        counts_d, xs_t_d, vals_t_d)``; returns a same-length list of
        TiledPayload or flat ``(xs, vals)``. In the ``shards`` flavor the
        blocks are per-shard lists (:meth:`_land_shards`).

        Each item takes its own flavor (:meth:`pick`), but every ``flat``
        item's K2 merge is dispatched, and every item's copy queued, before
        the one wait: B landings wait on the device once. The wall time of
        the batch is shared out to the items by their bytes to teach
        ``auto``."""
        if self.mode == "mask":
            raise ValueError("fetch mode 'mask' needs the packed bits, which "
                             "a batched step does not emit")
        if self.mode == "shards":
            return self._land_shards(items, staged, copier)
        plans = []
        for pos, counts, counts_d, xs_t_d, vals_t_d in items:
            plans.append((pos, counts,
                          *self._plan(pos, counts, xs_t_d.shape[1], False),
                          counts_d, xs_t_d, vals_t_d))

        def windows():
            out = []
            for pos, _, t_lo, t_hi, kind, counts_d, xs_t_d, vals_t_d in plans:
                if t_hi == 0:
                    continue
                if kind == "flat":
                    xs, vals = logcompact.merge_tiles(counts_d, xs_t_d,
                                                      vals_t_d)
                    out += [xs[:pos], vals[:pos]]
                else:
                    out += self._tiles_window(xs_t_d, vals_t_d, t_lo, t_hi)
            return out

        t0 = time.perf_counter()
        host = iter(copier.run(staged, windows))
        seconds = time.perf_counter() - t0
        results, landed = [], []
        for pos, counts, t_lo, t_hi, kind, _, xs_t_d, _ in plans:
            if t_hi == 0:
                results.append(self._empty(kind, counts, xs_t_d.shape[1]))
                continue
            a, b = next(host), next(host)
            if kind == "flat":
                res, nbytes = (a, b), a.nbytes + b.nbytes
            else:
                res, nbytes = self._tiles_payload(pos, counts, a, b, t_lo)
            results.append(res)
            landed.append((kind, nbytes))
        total = sum(nbytes for _, nbytes in landed)
        for kind, nbytes in landed:
            self._learn(kind, nbytes, seconds * nbytes / total)
        return results

    def _learn(self, kind: str, nbytes: int, seconds: float) -> None:
        """Fold one timed non-empty landing into the measurements."""
        self._landed[kind] += 1
        if self._landed[kind] < 2:
            return  # the first landing of a flavor pays first-use costs
        if kind == "tiles":
            self.copy_bytes_per_s = self._ema(self.copy_bytes_per_s,
                                              nbytes / max(seconds, 1e-9))
        elif self.copy_bytes_per_s is not None:
            rest = seconds - nbytes / self.copy_bytes_per_s
            self.extra_s[kind] = self._ema(self.extra_s[kind], max(rest, 0.0))

    def _empty(self, kind: str, counts: np.ndarray, unit_bytes: int):
        """The landing of a frame that changed nothing, in ``kind``."""
        if kind == "tiles":
            return wire.TiledPayload(0, counts[:0],
                                     np.empty((0, unit_bytes), np.int32),
                                     np.empty((0, unit_bytes), np.uint8))
        if kind == "mask" and self.return_mask:
            return wire.MaskPayload(0, 0, np.empty(0, np.uint8),
                                    np.empty(0, np.uint8))
        return np.empty(0, np.int32), np.empty(0, np.uint8)

    @staticmethod
    def rebuild_xs(xw: np.ndarray, counts_span: np.ndarray, t_lo: int,
                   unit_bytes: int) -> np.ndarray:
        """Global int32 indices of a unit-local window starting at unit
        ``t_lo`` (``unit * unit_bytes + local``), zero past each unit's
        count as on the device: the JAX ``_rebuild_xs``, computed over the
        counted entries only."""
        if xw.dtype == np.int32:
            return xw
        c = np.asarray(counts_span, dtype=np.int64)
        out = np.zeros(xw.shape, np.int32)
        slots = wire.prefix_slots(c, unit_bytes)
        base = np.repeat(
            np.arange(t_lo, t_lo + c.size, dtype=np.int64) * unit_bytes, c)
        out.reshape(-1)[slots] = xw.reshape(-1)[slots] + base
        return out

    @staticmethod
    def rebuild_mask_xs(bits_w: np.ndarray, pos: int, start_unit: int,
                        unit_bytes: int) -> np.ndarray:
        """Global ascending int32 indices from a packed bits window that
        starts at unit ``start_unit`` and covers every non-empty unit (the
        JAX ``_rebuild_mask_xs``): the window's nonzero bytes, each
        expanded to its set-bit positions from a (256, 8) table.
        LSB-first order is ascending byte order. Raises when the bits
        count other than ``pos`` entries; never truncates."""
        b = np.asarray(bits_w)
        nzb = np.flatnonzero(b)
        vals = b[nzb]
        cnts = _POPCOUNT[vals]
        total = int(cnts.sum())
        if total != pos:
            raise RuntimeError(
                f"bitmask window rebuilt {total} indices, device counted "
                f"pos={pos} (the window missed changed units)")
        base = np.repeat(nzb * 8, cnts)
        sel = _BITPOS[vals]
        keep = np.arange(8, dtype=np.uint8) < cnts[:, None]
        xs = (base + sel[keep]).astype(np.int32)
        return xs + np.int32(start_unit * unit_bytes)


class StreamExecutor:
    """Owns pipeline + device state; yields host payloads per frame."""

    def __init__(self, config: StreamConfig,
                 pipeline: Optional[DeltaStreamPipeline] = None, device=None):
        self.cfg = config
        self.pipe = pipeline or DeltaStreamPipeline(config, device=device)
        self._state = None
        self._copier = _Copier(self.pipe.device)
        self.lander = (TiledLander(config.fetch_mode,
                                   return_mask=config.mask_payload)
                       if config.tiled_payload else None)
        self.metrics = ExecMetrics()

    @property
    def fetch_counts(self) -> dict:
        """Landings per flavor (tiled payloads; empty otherwise)."""
        return self.lander.fetch_counts if self.lander else {}

    def start(self, base_frame: np.ndarray) -> np.ndarray:
        """Initialize device state; returns the base frame bytes to ship."""
        base = np.asarray(base_frame, dtype=np.uint8).ravel()
        self._state = self.pipe.init_state(base)
        return base

    def process(self, frame, text: str = ""):
        """Run one frame; returns host-side ``(pos, xs, vals, aux)``,
        ``aux`` the visualizer's frame as a uint8 array (None without a
        visualizer).

        With ``tiled_payload`` configured, a ``tiles`` landing returns a
        :class:`~cudavideostream_tpu_torch.runtime.wire.TiledPayload` as
        ``xs`` and None as ``vals`` (``.to_flat()`` gives the arrays), and
        so does a ``mask`` landing under ``mask_payload``, with a
        :class:`~cudavideostream_tpu_torch.runtime.wire.MaskPayload`; the
        other landings return the arrays.

        Raises :class:`PayloadOverflowError` when the frame changed more
        bytes than the configured capacity; the device state has then
        already advanced past the frame.
        """
        if self._state is None:
            raise RuntimeError("call start(base_frame) first")
        return self._land(*self._dispatch(frame, text))

    def _dispatch(self, frame, text: str):
        """Run the step, advance the state and stage the sizes' copies."""
        t0 = time.perf_counter()
        out = self.pipe.step(self._state, frame, text=text)
        self._state = out[0]
        return t0, _Staged(out[1:], 2 if self.cfg.tiled_payload else 1)

    def _land(self, t0: float, staged: _Staged):
        sizes = staged.wait()
        pos = int(sizes[0])  # the frame's one wait on the device
        if self.lander is not None:
            outs = staged.outs
            if self.cfg.maskonly_payload:
                # (pos, counts, vals_t, bits, aux): no index blocks
                blocks = (outs[1], None, outs[2], outs[3])
            else:
                # (pos, counts, xs_t, vals_t[, bits], aux)
                blocks = (*outs[1:4],
                          outs[4] if self.cfg.emit_bitmask else None)
            res = self.lander.land(pos, sizes[1], blocks, staged,
                                   self._copier)
            aux = self._copier.land_aux(staged)
            self.metrics.record(time.perf_counter() - t0, pos)
            if isinstance(res, (wire.TiledPayload, wire.MaskPayload)):
                return pos, res, None, aux
            return (pos, *res, aux)
        if pos > self.cfg.capacity:
            # truncating would silently desync a v1 client: the dropped
            # deltas are already folded into the device state (and the
            # frame's aux frame is dropped with them)
            raise PayloadOverflowError(
                f"frame changed {pos} bytes > payload_capacity "
                f"{self.cfg.capacity}"
            )
        xs_d, vals_d = staged.outs[1:3]
        xs, vals = self._copier.run(staged, lambda: (xs_d[:pos], vals_d[:pos]))
        self.metrics.record(time.perf_counter() - t0, pos)
        return pos, xs, vals, staged.aux_host

    def resync(self) -> np.ndarray:
        """The post-step previous-frame bytes (the client's state), for a
        wire-v3 raw recovery after a :class:`PayloadOverflowError`."""
        if self._state is None:
            raise RuntimeError("no state to resync from")
        return self._state.to("cpu", copy=True).numpy()

    def flush(self):
        """No pending work in the synchronous executor."""
        return None


class PipelinedExecutor(StreamExecutor):
    """One-frame-deep software pipeline: dispatch frame N, then land frame
    N-1's payload while N computes — the executor-level counterpart of the
    reference's capture/compute/send thread overlap
    (``threads.cpp:166-237``). The output stream lags one frame:
    :meth:`process` returns None for the first frame, and :meth:`flush`
    lands the last one."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending = None  # (t0, _Staged) of the frame not yet landed

    def process(self, frame, text: str = ""):
        if self._state is None:
            raise RuntimeError("call start(base_frame) first")
        prev, self._pending = self._pending, self._dispatch(frame, text)
        return None if prev is None else self._land(*prev)

    def flush(self):
        prev, self._pending = self._pending, None
        return None if prev is None else self._land(*prev)

    def resync(self) -> np.ndarray:
        # the pending payload's deltas are against a state the raw frame
        # replaces: a client that applied them afterwards would corrupt
        self._pending = None
        return super().resync()


class BatchedLandExecutor(StreamExecutor):
    """Depth-K landing batch: dispatch K frames' steps, then land the K
    payloads in order. The JAX executor batches to share one host-to-TPU
    round trip between K frames; here the card runs K steps ahead of the
    host's landings, at K frames of output latency. :meth:`process`
    returns None until the batch fills, then a list of per-frame results
    (oldest first); :meth:`flush` returns the sub-depth tail as a list
    (None when nothing is queued)."""

    def __init__(self, config: StreamConfig,
                 pipeline: Optional[DeltaStreamPipeline] = None,
                 device=None, depth: int = 4):
        super().__init__(config, pipeline=pipeline, device=device)
        if not config.tiled_payload:
            raise ValueError("BatchedLandExecutor requires tiled_payload=True "
                             "(the landing speaks the per-unit block layout)")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.depth = depth
        self._queue: list = []  # (t0, _Staged) of the frames not yet landed

    def process(self, frame, text: str = ""):
        if self._state is None:
            raise RuntimeError("call start(base_frame) first")
        self._queue.append(self._dispatch(frame, text))
        if len(self._queue) < self.depth:
            return None
        return self._land_queue()

    def _land_queue(self):
        q, self._queue = self._queue, []
        return [self._land(*item) for item in q]

    def flush(self):
        """Land whatever is queued (the sub-depth tail); a list."""
        return self._land_queue() if self._queue else None

    def resync(self) -> np.ndarray:
        # the queued payloads' deltas are against states the raw frame
        # replaces
        self._queue = []
        return super().resync()


class ExecMetrics:
    """1 Hz status line state (reference ``server.cpp:150-171``)."""

    def __init__(self):
        self.last_print = time.perf_counter()
        self.frame_time = 0.0
        self.read_time = 0.0
        self.pos = 0
        self.frames = 0
        self.total_frames = 0
        self.wire_bytes = 0
        # snapshot of the last completed 1 Hz window, taken by
        # status_line() BEFORE it resets the counters — overlay_text()
        # must read these, not the live counters (which are zero right
        # after the reset, exactly when callers render the overlay)
        self.win_fps = 0.0
        self.win_bw_ref = 0

    def record(self, frame_s: float, pos: int,
               wire_bytes: Optional[int] = None) -> None:
        self.frame_time = frame_s
        self.pos = pos
        self.frames += 1
        self.total_frames += 1
        # the v1 framing cost, unless the sender counted its bytes
        self.wire_bytes += 4 + 5 * pos if wire_bytes is None else wire_bytes

    def status_line(self, read_s: float = 0.0) -> Optional[str]:
        """Returns the status string once per second, else None."""
        now = time.perf_counter()
        if now - self.last_print < 1.0:
            return None
        dt = now - self.last_print
        fps = self.frames / dt
        # reference BW estimate: each changed byte counted as 16 bits
        # ((pos<<4)*fps*1e-3 kbps, server.cpp:159) — kept for parity
        bw_ref = int((self.pos << 4) * fps * 1e-3)
        bw_true = int(8 * self.wire_bytes / dt * 1e-3)
        self.win_fps = fps
        self.win_bw_ref = bw_ref
        line = (
            f"FPS: {fps:5.0f}\tFOR: {1e3*self.frame_time:6.2f} ms\t"
            f"READ: {1e3*read_s:6.2f}\tPOS: {self.pos:7d}\t"
            f"BW: {bw_ref:6d} kbps (wire: {bw_true} kbps)"
        )
        self.last_print = now
        self.frames = 0
        self.wire_bytes = 0
        return line

    def overlay_text(self) -> str:
        """The string rendered into the video (``server.cpp:166-168``):
        the last completed 1 Hz window's fps/BW."""
        return f"FPS: {int(self.win_fps)} BW: {self.win_bw_ref} kbps"
