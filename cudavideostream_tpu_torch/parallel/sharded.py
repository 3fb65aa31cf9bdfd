"""The sharded pipeline: the per-frame step over a ``(data, space)`` mesh
(the counterpart of the JAX package's ``parallel/sharded.py``).

Layout, as in the JAX package:

* ``data``: independent video streams (the batch of :meth:`step`);
* ``space``: frame rows, contiguous blocks per shard, ``Ln`` bytes each.

One process drives every shard. Each shard's tensors live on the device
the mesh gives it, the step launches each shard's work there, and the
JAX package's three collectives become explicit tensor moves between
devices (``t.to(dev)``, a no-op where the devices are one):

* ``ppermute`` of the conv halo rows: a copy of each boundary strip
  (``parallel.halo_conv``);
* ``psum`` of the binarize histograms and of the replicated payload's
  disjoint blocks: a sum of the shards' tensors on the first device;
* ``all_gather`` of the shard counts: a stack.

Every shard compacts its rows with K1 and its ``index_offset`` mode
(``s * Ln``), so its blocks hold GLOBAL frame indices and no pass
globalizes them afterwards: per-shard tiled blocks for the ``"sharded"``
payload layout of :meth:`step_flat` (``server --mesh``), per-shard flat
blocks otherwise. Outputs stay where they were computed: a tensor per
shard (a list over ``space``), or for :meth:`step` a grid of them (a list
over ``data`` of lists over ``space``); :func:`gather` brings either to
the host in the JAX package's global shapes. Shards on one device run
one after another on its stream.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from cudavideostream_tpu_torch.config import (
    CompactionBackend,
    StreamConfig,
    Visualizer,
)
from cudavideostream_tpu_torch.ops import compact as compact_ops
from cudavideostream_tpu_torch.ops import filters as filter_ops
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.ops import overlay as overlay_ops
from cudavideostream_tpu_torch.ops import reference_cpu
from cudavideostream_tpu_torch.parallel.halo_conv import sharded_convolve_q16
from cudavideostream_tpu_torch.parallel.mesh import Mesh
from cudavideostream_tpu_torch.utils import fonts


def gather(parts) -> np.ndarray:
    """Sharded outputs on the host, in the JAX package's global shapes: a
    tensor (or host array) as it is, a list over ``space`` (or over ``data``) concatenated
    along axis 0, a ``(data, space)`` grid row by row along axis 1, then
    the rows along axis 0."""
    if isinstance(parts, np.ndarray):
        return parts
    if isinstance(parts, torch.Tensor):
        return parts.cpu().numpy()
    if isinstance(parts[0], (list, tuple)):
        return np.concatenate([np.concatenate([gather(t) for t in row],
                                              axis=1) for row in parts])
    return np.concatenate([gather(t) for t in parts])


def _to_device(x, dev: torch.device) -> torch.Tensor:
    """A contiguous uint8 host array or tensor on ``dev`` (host arrays go
    up through pinned memory without blocking)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.uint8).contiguous()
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


class ShardedDeltaPipeline:
    """The configured pipeline over a ``(data, space)`` mesh. Frames are
    ``(B, frame_bytes)`` uint8 for :meth:`step`, B divisible by the data
    axis, or flat ``(frame_bytes,)`` for :meth:`step_flat`; the image
    rows must divide by the space axis."""

    def __init__(self, config: StreamConfig, mesh: Mesh,
                 conv_weights: Optional[np.ndarray] = None,
                 payload_layout: str = "replicated",
                 threshold_map: Optional[np.ndarray] = None,
                 conv_weights_q16: Optional[np.ndarray] = None):
        """``payload_layout``:

        * ``"replicated"``: the payload is assembled from the shards on the
          mesh's first device of each data row (the counts stacked, each
          shard's block placed at its offset in a zeroed buffer), as flat
          ``(pos, xs, vals)``;
        * ``"sharded"``: no payload moves at all; each shard keeps its
          compacted blocks with their counts where it computed them, and
          the host assembles the wire bytes from them.

        ``conv_weights`` as for ``DeltaStreamPipeline``, or the Q16 taps
        themselves in ``conv_weights_q16`` (a handover from the JAX
        pipeline, ``models.pipeline.from_jax_sharded``). ``threshold_map``:
        a per-byte map of the frame's length, cut along rows like the
        frame, so each shard reads its own slice."""
        if config.compaction is not CompactionBackend.PALLAS:
            # every shard compacts with K1, as in the JAX package, whose
            # server refuses the other backends under --mesh
            raise ValueError("the sharded pipeline compacts with the pallas "
                             f"backend only, not {config.compaction.value}")
        if payload_layout not in ("replicated", "sharded"):
            raise ValueError(f"unknown payload_layout {payload_layout!r}")
        self.payload_layout = payload_layout
        self.cfg = config
        self.mesh = mesh
        self.n_space = mesh.shape["space"]
        self.n_data = mesh.shape["data"]
        if config.height % self.n_space:
            raise ValueError(
                f"height {config.height} not divisible by space={self.n_space}")
        self.local_rows = config.height // self.n_space
        self.local_bytes = config.frame_bytes // self.n_space
        if config.noise_filter and config.conv_k // 2 > self.local_rows:
            # the halo exchange reaches one neighbour only
            raise ValueError(
                f"conv halo of {config.conv_k // 2} rows exceeds the "
                f"{self.local_rows}-row shard; use fewer space shards or a "
                f"smaller conv_k")
        if self.local_bytes >= 1 << 31:
            # the JAX package compacts such shards with compact_sort, which
            # refuses them (the packed keys stop at 8,388,607 bytes): ask
            # it, on meta tensors that hold no bytes
            meta = torch.empty(self.local_bytes, dtype=torch.bool,
                               device="meta")
            compact_ops.compact_sort(meta, meta.to(torch.uint8),
                                     self.local_bytes)
        if conv_weights_q16 is None:
            if conv_weights is None:
                conv_weights = reference_cpu.gaussian_kernel(config.conv_k)
            conv_weights_q16 = reference_cpu.quantize_kernel_q16(
                np.asarray(conv_weights, dtype=np.float64))
        self.conv_q16 = np.array(conv_weights_q16, dtype=np.int64)
        self.atlas_np = fonts.make_atlas(config.overlay_scale,
                                         config.overlay_font)
        self.capacity = config.frame_bytes
        self._bands: dict = {}   # (device, shard) -> its rows of the atlas
        self._glyph_ids: dict = {}  # device -> its overlay_ops.Glyphs
        self.threshold_map_np = None
        self._maps = None        # [d][s]: shard s's map slice on its device
        if threshold_map is not None:
            tm = np.asarray(threshold_map, dtype=np.uint8).ravel()
            if tm.size != config.frame_bytes:
                raise ValueError(f"threshold_map has {tm.size} bytes, frame "
                                 f"has {config.frame_bytes}")
            self.threshold_map_np = tm
            Ln = self.local_bytes
            self._maps = [[torch.from_numpy(tm[s * Ln:(s + 1) * Ln].copy())
                           .to(dev) for s, dev in enumerate(row)]
                          for row in mesh.devices]

    # -- one stream over the space shards of one data row -------------------

    def _overlay_band(self, cur: torch.Tensor, text: str,
                      sidx: int) -> Optional[torch.Tensor]:
        """Shard ``sidx``'s rows of the glyph band blended over its frame
        ``cur``: a new tensor of its first ``h = min(Lr, cell_h - g0)``
        rows, or None when the shard holds no row of the band. Shard ``s``
        owns global rows ``[s*Lr, (s+1)*Lr)`` and takes the glyph rows
        ``[g0, g0 + h)`` of each cell, ``g0 = s*Lr``: the band may span
        several shards. K14 blends them (``overlay_blit``, one launch on
        the card) from the atlas's rows of the shard and the glyph ids of
        the text on the shard's device."""
        cfg = self.cfg
        dev = cur.device
        cell_h, cell_w = self.atlas_np.shape[1:3]
        g0 = sidx * self.local_rows
        if g0 >= cell_h:
            return None
        h = min(self.local_rows, cell_h - g0)
        band = self._bands.get((dev, sidx))
        if band is None:
            band = self._bands[(dev, sidx)] = torch.from_numpy(
                np.ascontiguousarray(self.atlas_np[:, g0:g0 + h])).to(dev)
        glyphs = self._glyph_ids.get(dev)
        if glyphs is None:
            glyphs = self._glyph_ids[dev] = overlay_ops.Glyphs(
                dev, cfg.width // cell_w)
        ids, _ = glyphs((text,))
        return overlay_ops.overlay_blit(cur[:h * cfg.width * 3], band, ids[0],
                                        len(text), h, cfg.width)

    def _aux(self, d: int, curs, regions, prevs):
        """Each shard's aux frame (None without a visualizer), from the
        overlaid frame and ``prev`` as it is before the step: K1 writes
        the new ``prev`` in place, so this runs first."""
        vis = self.cfg.visualizer
        if vis == Visualizer.NONE:
            return None
        # one launch a shard, each reading its region in place of the
        # shard's first bytes
        if vis == Visualizer.HEATMAP:
            return [filter_ops.heatmap(c, p, r)
                    for c, r, p in zip(curs, regions, prevs)]
        if vis == Visualizer.GRAYSCALE:
            return [filter_ops.grayscale_weighted(c, r)
                    for c, r in zip(curs, regions)]
        if vis == Visualizer.BINARIZE:
            # one histogram for the whole frame: each shard's gray values
            # and counts from K9's first launch, the counts summed on the
            # row's first device (the JAX psum), exact int32, and K9's
            # second launch on each shard with the sum
            grays = [filter_ops.gray_hist(c, r)
                     for c, r in zip(curs, regions)]
            dev0 = self.mesh.device(d, 0)
            hist = None
            for _, h in grays:
                h = h.to(dev0)
                hist = h if hist is None else hist + h
            return [filter_ops.binarize_apply(g, hist.to(g.device))
                    for g, _ in grays]
        # the red modes: |df| > threshold (or the shard's map) on the
        # overlaid frame — the JAX new_prev != prev wherever it takes it
        return [filter_ops.red_visualizer(
            c, p, (self.cfg.threshold if self._maps is None
                   else self._maps[d][s]),
            vis == Visualizer.RED_OVERLAP, r)
            for s, (c, r, p) in enumerate(zip(curs, regions, prevs))]

    def _stream(self, d: int, prevs, frames, text: str, emit_tiled: bool):
        """One stream's step over the S space shards of data row ``d``:
        ``prevs`` and ``frames`` are each shard's ``(Ln,)`` tensor on its
        device, ``prevs`` updated in place. Returns each shard's K1 outputs
        (``(pos, counts, xs_t, vals_t)`` tiled, ``(pos, xs, vals)`` flat;
        global indices) and each shard's aux frame (or None)."""
        cfg = self.cfg
        curs = list(frames)
        if cfg.noise_filter:
            curs = sharded_convolve_q16(curs, self.conv_q16, self.local_rows,
                                        cfg.width)
        regions = [None] * self.n_space
        cell_h = self.atlas_np.shape[1]
        if text and cell_h <= cfg.height:
            # a row prefix per shard, which K1 and the visualizer's kernel
            # substitute for the shard's first bytes (no pass over the
            # frame)
            regions = [self._overlay_band(c, text, s)
                       for s, c in enumerate(curs)]
        aux = self._aux(d, curs, regions, prevs)
        outs = []
        for s in range(self.n_space):
            kw = dict(threshold=cfg.threshold,
                      negative_feedback=cfg.negative_feedback,
                      overlay_region=regions[s],
                      threshold_map=(None if self._maps is None
                                     else self._maps[d][s]),
                      index_offset=s * self.local_bytes)
            if emit_tiled:
                out = logcompact.fused_diff_compact_tiled(
                    curs[s], prevs[s], sub_rows=cfg.subtile_rows, **kw)
            else:
                out = logcompact.fused_diff_compact(curs[s], prevs[s], **kw)
            outs.append(out[:-1])
        return outs, aux

    def _assemble(self, parts, dev: torch.device):
        """The replicated payload of one stream from its shards' flat
        ``(pos, xs, vals)``: the counts stacked (the JAX ``all_gather``),
        each block added at its offset into a zeroed buffer on ``dev`` (the
        JAX ``psum`` of disjoint blocks: the zeros past each count add
        nothing). Returns ``(pos, xs (cap,), vals (cap,))``."""
        Ln = self.local_bytes
        lpos = torch.stack([p.to(dev) for p, _, _ in parts])
        before = (torch.cumsum(lpos, 0) - lpos).to(torch.int64)
        cap = self.capacity
        xs = torch.zeros(cap + Ln, dtype=torch.int32, device=dev)
        vals = torch.zeros(cap + Ln, dtype=torch.int32, device=dev)
        lane = torch.arange(Ln, dtype=torch.int64, device=dev)
        for s, (_, xs_s, vals_s) in enumerate(parts):
            idx = before[s] + lane
            xs.index_add_(0, idx, xs_s.to(dev))
            vals.index_add_(0, idx, vals_s.to(dev).to(torch.int32))
        return (lpos.sum(dtype=torch.int32), xs[:cap],
                vals[:cap].to(torch.uint8))

    # -- host API -------------------------------------------------------------

    def init_state(self, base_frames) -> List[List[torch.Tensor]]:
        """``(B, frame_bytes)`` uint8 -> the state of :meth:`step`: a
        ``(data, space)`` grid of ``(B / D, Ln)`` tensors, each on its
        device."""
        base = np.asarray(base_frames, dtype=np.uint8)
        if base.ndim == 1:
            base = base[None]
        if base.shape[0] % self.n_data:
            raise ValueError(f"{base.shape[0]} streams not divisible by "
                             f"data={self.n_data}")
        Bl, Ln = base.shape[0] // self.n_data, self.local_bytes
        return [[torch.from_numpy(base[d * Bl:(d + 1) * Bl,
                                       s * Ln:(s + 1) * Ln].copy()).to(dev)
                 for s, dev in enumerate(row)]
                for d, row in enumerate(self.mesh.devices)]

    def init_state_flat(self, base_frame) -> List[torch.Tensor]:
        """A flat ``(frame_bytes,)`` frame -> the state of
        :meth:`step_flat`: each shard's ``(Ln,)`` rows on its device (data
        row 0)."""
        base = np.asarray(base_frame, dtype=np.uint8).ravel()
        if base.size != self.cfg.frame_bytes:
            raise ValueError("base frame size mismatch")
        Ln = self.local_bytes
        return [torch.from_numpy(base[s * Ln:(s + 1) * Ln].copy()).to(dev)
                for s, dev in enumerate(self.mesh.devices[0])]

    def _shard_frame(self, frame, devs) -> List[torch.Tensor]:
        Ln = self.local_bytes
        if isinstance(frame, torch.Tensor):
            frame = frame.reshape(-1)
        else:
            frame = np.asarray(frame, dtype=np.uint8).reshape(-1)
        if frame.shape[0] != self.cfg.frame_bytes:
            raise ValueError("frame size mismatch")
        return [_to_device(frame[s * Ln:(s + 1) * Ln], dev)
                for s, dev in enumerate(devs)]

    def step_flat(self, prev: List[torch.Tensor], frame, text: str = ""):
        """One stream's step on the flat state of :meth:`init_state_flat`
        (the ``server --mesh`` path); ``prev`` is updated in place.

        Returns, for the ``"sharded"`` layout, ``(new_prev, counts, xs,
        vals, aux)``, each a list over the shards: shard ``s``'s K1 tiled
        emission at ``subtile_rows`` with ``index_offset = s * Ln``
        (``counts (U,)`` narrowed, blocks ``(U, unit_bytes)``, global
        indices, zero past each count), so concatenating the shards' units
        gives the JAX package's ``(n_space * U, unit_bytes)`` blocks in
        ascending global order. For ``"replicated"``: ``(new_prev, pos,
        xs (cap,), vals (cap,), aux)``, the payload on the mesh's first
        device. ``aux`` is a list of each shard's aux frame, or None
        without a visualizer."""
        frames = self._shard_frame(frame, self.mesh.devices[0])
        sharded = self.payload_layout == "sharded"
        outs, aux = self._stream(0, prev, frames, text, emit_tiled=sharded)
        if sharded:
            return (prev, [o[1] for o in outs], [o[2] for o in outs],
                    [o[3] for o in outs], aux)
        return (prev, *self._assemble(outs, self.mesh.device(0, 0)), aux)

    def step(self, prev: List[List[torch.Tensor]], frames, text=""):
        """B streams on the state of :meth:`init_state`, streams ``[d *
        B/D, (d + 1) * B/D)`` on data row ``d``, each shard compacting
        each of its streams with K1 flat and ``index_offset``; ``prev`` is
        updated in place.

        Returns ``(new_prev, counts, xs, vals, aux)`` for the
        ``"sharded"`` layout, each a ``(data, space)`` grid: per shard
        ``counts (B/D, 1)`` int32 and ``xs`` / ``vals`` ``(B/D, Ln)``
        (see :meth:`payload_tiles`); or ``(new_prev, pos, xs, vals, aux)``
        for ``"replicated"``, each of the last three a list over ``data``
        of ``(B/D,)`` and ``(B/D, cap)`` on the row's first device. ``aux``
        is a grid of ``(B/D, Ln)``, or None without a visualizer.

        ``text``: one string for every stream, or a sequence of B
        per-stream strings (each stream renders its own status line)."""
        if not isinstance(frames, torch.Tensor):
            frames = np.asarray(frames, dtype=np.uint8)
        if frames.ndim == 1:
            frames = frames[None]
        B = frames.shape[0]
        if B % self.n_data:
            raise ValueError(f"{B} streams not divisible by "
                             f"data={self.n_data}")
        texts = [text] * B if isinstance(text, str) else list(text)
        if len(texts) != B:
            raise ValueError(f"need {B} texts, got {len(texts)}")
        Bl = B // self.n_data
        sharded = self.payload_layout == "sharded"
        sizes, xs, vals, aux = [], [], [], []
        for d, devs in enumerate(self.mesh.devices):
            per_stream = []
            for bl in range(Bl):
                b = d * Bl + bl
                frames_b = self._shard_frame(frames[b], devs)
                per_stream.append(self._stream(
                    d, [prev[d][s][bl] for s in range(self.n_space)],
                    frames_b, texts[b], emit_tiled=False))
            if per_stream[0][1] is not None:
                aux.append([torch.stack([a[s] for _, a in per_stream])
                            for s in range(self.n_space)])
            if sharded:
                sizes.append([torch.stack([o[s][0] for o, _ in per_stream])
                              .reshape(Bl, 1) for s in range(self.n_space)])
                xs.append([torch.stack([o[s][1] for o, _ in per_stream])
                           for s in range(self.n_space)])
                vals.append([torch.stack([o[s][2] for o, _ in per_stream])
                             for s in range(self.n_space)])
            else:
                dev0 = devs[0]
                assembled = [self._assemble(o, dev0) for o, _ in per_stream]
                sizes.append(torch.stack([a[0] for a in assembled]))
                xs.append(torch.stack([a[1] for a in assembled]))
                vals.append(torch.stack([a[2] for a in assembled]))
        return prev, sizes, xs, vals, (aux or None)

    def payload_tiles(self, counts, xs, vals, b: int):
        """Stream ``b``'s wire payload from :meth:`step`'s ``"sharded"``
        grids: the shard axis is the tile axis of a
        :class:`~cudavideostream_tpu_torch.runtime.wire.TiledPayload`
        (shard order is ascending row order), each tile a whole shard of
        ``Ln`` slots."""
        from cudavideostream_tpu_torch.runtime import wire

        Bl = counts[0][0].shape[0]
        d, bl = divmod(b, Bl)
        c = np.array([int(counts[d][s][bl, 0]) for s in range(self.n_space)],
                     np.int32)
        xs_t = np.stack([t[bl].cpu().numpy() for t in xs[d]])
        vals_t = np.stack([t[bl].cpu().numpy() for t in vals[d]])
        return wire.TiledPayload(int(c.sum()), c, xs_t, vals_t)
