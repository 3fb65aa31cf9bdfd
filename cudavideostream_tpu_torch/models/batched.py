"""Multi-stream batched pipeline: B independent cameras on one card (the
PyTorch port of the JAX package's ``models/batched.py``).

One step runs B delta streams — per-stream state, per-stream overlay text,
per-stream payloads — with ONE compaction launch for the B frames, so the
launch overhead is paid once per batch, not per stream. Stream ``b``'s
outputs equal a solo :class:`~cudavideostream_tpu_torch.models.pipeline.DeltaStreamPipeline`
step on the same inputs.

State is carried FLAT, ``(B * frame_bytes,)``, as in the JAX API: stream
``b`` is bytes ``[b * n, (b + 1) * n)``. (The JAX package keeps it flat
because a ``(B, n)`` uint8 array pads its sublanes on a TPU; the card has
no such layout, but the flat buffers keep the two APIs one.)

The fast path (tiled payloads and an overlay cell that fits the frame, as
in the JAX package, ``batched.py:93-97``) follows ``_fast_impl``:

1. the noise filter per stream (its 2-D borders are per frame);
2. each stream's overlay strip, blended over its first ``cell_h`` rows;
   the B strips go to the kernel as its per-stream region (the JAX package
   substitutes them into the super-frame with one pass instead, because
   Mosaic cannot pipeline a per-stream region input);
3. the visualizer's aux frame, before the kernel, because the kernel
   updates ``prev`` in place and every visualizer reads the old ``prev``:
   heatmap, grayscale and the red modes over the whole super-frame (each
   is per pixel), binarize per stream (its histogram is per frame: one K4
   launch per stream);
4. one batched K1 launch (``fused_diff_compact_batched``).

Any other configuration (the flat payload, with or without
``--capacity``, the SORT backend, an overlay cell taller than the frame)
runs the solo step per stream on views of the flat state and stacks the
results, as ``_vmap_impl`` does. The HOST backend is refused, as in the
JAX package: its host shadow serves one stream. The JAX
package's chunking of the batch into several kernel calls
(``_chunk_streams``) exists for a Mosaic SMEM bound and is not ported: one
CUDA grid takes every stream's tiles.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from cudavideostream_tpu_torch.config import (
    CompactionBackend,
    StreamConfig,
    Visualizer,
)
from cudavideostream_tpu_torch.models.pipeline import (
    MAX_OVERLAY_CHARS,
    DeltaStreamPipeline,
    from_jax_state,
)
from cudavideostream_tpu_torch.ops import convolve as conv_ops
from cudavideostream_tpu_torch.ops import diff as diff_ops
from cudavideostream_tpu_torch.ops import filters as filter_ops
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.ops import overlay as overlay_ops
from cudavideostream_tpu_torch.utils import fonts


class BatchedDeltaPipeline:
    """B-stream batched pipeline over one flat device state.

    Usage::

        pipe = BatchedDeltaPipeline(config, n_streams=4)   # on the card
        prev = pipe.init_state(bases)                      # (B * n,)
        # tiled_payload (the fast path) returns six:
        prev, pos, counts, xs_t, vals_t, aux = pipe.step(prev, frames, texts)
        # the flat payload:
        prev, pos, xs, vals, aux = pipe.step(prev, frames, texts)
    """

    def __init__(self, config: StreamConfig, n_streams: int, device=None,
                 conv_weights_q16: Optional[np.ndarray] = None,
                 threshold_map=None, atlas: Optional[torch.Tensor] = None):
        """``conv_weights_q16``, ``threshold_map`` (one map shared by every
        stream, of one frame's length) and ``atlas`` as for
        :class:`DeltaStreamPipeline`, which validates them."""
        if n_streams < 1:
            raise ValueError("need at least one stream")
        self.config = config
        self.n_streams = n_streams
        self._solo = DeltaStreamPipeline(
            config, device=device, atlas=atlas, threshold_map=threshold_map,
            conv_weights_q16=conv_weights_q16)
        self.device = self._solo.device
        if config.compaction is CompactionBackend.HOST:
            raise ValueError(
                "HOST compaction packs per stream on the host — run solo "
                "pipelines instead of a batched one")
        cell_h = self._solo.atlas.shape[1]
        self._fast = config.tiled_payload and cell_h <= config.height
        # the shared map, repeated per stream, for the red modes' mask over
        # the super-frame
        tm = self._solo.threshold_map
        self._thr_map_b = None if tm is None else tm.repeat(n_streams)
        self._ids: dict = {}  # overlay text -> device glyph indices

    @property
    def atlas_np(self) -> np.ndarray:
        return self._solo.atlas_np

    def init_state(self, base_frames: np.ndarray) -> torch.Tensor:
        """``(B, frame_bytes)`` uint8 -> the flat ``(B * frame_bytes,)``
        device state."""
        bases = np.asarray(base_frames, dtype=np.uint8).reshape(
            self.n_streams, -1)
        if bases.shape[1] != self.config.frame_bytes:
            raise ValueError("base frame size mismatch")
        return torch.from_numpy(bases.reshape(-1).copy()).to(self.device)

    def _frames(self, frames) -> torch.Tensor:
        """The B frames as one flat uint8 tensor on the device."""
        if isinstance(frames, torch.Tensor):
            t = frames.to(self.device, torch.uint8).reshape(-1).contiguous()
        else:
            t = torch.from_numpy(
                np.ascontiguousarray(frames, dtype=np.uint8).reshape(-1))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
        if t.numel() != self.n_streams * self.config.frame_bytes:
            raise ValueError("frames size mismatch")
        return t

    def _char_ids(self, text: str) -> torch.Tensor:
        ids = self._ids.get(text)
        if ids is None:
            if len(self._ids) >= 4 * self.n_streams:
                self._ids.clear()  # the texts of a status line move on
            ids = torch.tensor(fonts.encode_text(text, MAX_OVERLAY_CHARS),
                               dtype=torch.int64).to(self.device)
            self._ids[text] = ids
        return ids

    def _strips(self, cur: torch.Tensor, texts) -> Optional[torch.Tensor]:
        """The B blended overlay strips, flat ``(B * strip,)``, or None
        when no stream has text."""
        if not any(texts):
            return None
        cfg = self.config
        n = cfg.frame_bytes
        cell_h = self._solo.atlas.shape[1]
        strip = cell_h * cfg.width * 3
        return torch.cat([
            overlay_ops.overlay_blit(
                cur[b * n:b * n + strip], self._solo.atlas,
                self._char_ids(t), min(len(t), MAX_OVERLAY_CHARS), cell_h,
                cfg.width)
            for b, t in enumerate(texts)])

    def _aux(self, cur: torch.Tensor, strips: Optional[torch.Tensor],
             prev: torch.Tensor) -> Optional[torch.Tensor]:
        """The flat ``(B * n,)`` aux frame of every stream, a new tensor,
        from the overlaid frames and ``prev`` before the step."""
        cfg = self.config
        vis = cfg.visualizer
        if vis == Visualizer.NONE:
            return None
        B, n = self.n_streams, cfg.frame_bytes
        if strips is not None:
            # the overlaid super-frame, for the visualizer alone: the
            # kernel reads the strips as its region
            cur = cur.clone()
            cur.view(B, n)[:, :strips.numel() // B] = strips.view(B, -1)
        if vis == Visualizer.HEATMAP:
            return filter_ops.heatmap(cur, prev)
        if vis == Visualizer.GRAYSCALE:
            return filter_ops.grayscale_weighted(cur)
        if vis == Visualizer.BINARIZE:
            return torch.cat([
                filter_ops.binarize_pipeline(cur[b * n:(b + 1) * n])
                for b in range(B)])
        thr = cfg.threshold if self._thr_map_b is None else self._thr_map_b
        mask = diff_ops.diff_mask(cur, prev, thr)[0]
        if vis == Visualizer.RED_BLACK:
            return filter_ops.red_black(mask)
        return filter_ops.red_overlap(prev, mask)

    def step(self, prev: torch.Tensor, frames,
             texts: Optional[Sequence[str]] = None):
        """One step over every stream. ``prev`` is the flat state from
        :meth:`init_state` (or a prior step), updated in place; ``frames``
        ``(B, frame_bytes)`` or flat, numpy or a tensor, is never written.

        Returns, as the JAX pipeline does: with ``tiled_payload`` (the fast
        path) ``(new_prev, pos (B,), counts (B, U), xs_t (B, U,
        unit_bytes), vals_t (B, U, unit_bytes), aux)``; else ``(new_prev,
        pos (B,), xs (B, capacity), vals (B, capacity), aux)``. ``aux`` is
        None without a visualizer, else the flat ``(B * frame_bytes,)``
        uint8 aux frames. The step does not wait for the device.
        """
        B = self.n_streams
        texts = list(texts or [""] * B)
        if len(texts) != B:
            raise ValueError(f"need {B} texts, got {len(texts)}")
        if prev.numel() != B * self.config.frame_bytes:
            raise ValueError("state size mismatch")
        cur = self._frames(frames)
        if not self._fast:
            return self._per_stream(prev, cur, texts)
        cfg = self.config
        n = cfg.frame_bytes
        if cfg.noise_filter:
            cur = torch.cat([
                conv_ops.convolve_q16(cur[b * n:(b + 1) * n],
                                      self._solo.conv_weights_q16,
                                      cfg.height, cfg.width)
                for b in range(B)])
        strips = self._strips(cur, texts)
        aux = self._aux(cur, strips, prev)
        # pair_lanes and skip_static are TPU layouts with identical outputs
        pos, counts, xs_t, vals_t, new_prev = (
            logcompact.fused_diff_compact_batched(
                cur, prev, B, threshold=cfg.threshold,
                negative_feedback=cfg.negative_feedback,
                threshold_map=self._solo.threshold_map,
                sub_rows=cfg.subtile_rows, overlay_region=strips))
        return new_prev, pos, counts, xs_t, vals_t, aux

    def _per_stream(self, prev, cur, texts):
        """The solo step on each stream's views, the outputs stacked (the
        aux frames concatenated flat)."""
        n = self.config.frame_bytes
        outs = [self._solo.step(prev[b * n:(b + 1) * n],
                                cur[b * n:(b + 1) * n], text=t)
                for b, t in enumerate(texts)]
        parts = [torch.stack(p) for p in zip(*(o[1:-1] for o in outs))]
        aux = None if outs[0][-1] is None else torch.cat([o[-1] for o in outs])
        return (prev, *parts, aux)


def from_jax_batched(config: StreamConfig, n_streams: int,
                     state_np: np.ndarray,
                     atlas_np: Optional[np.ndarray] = None,
                     conv_weights_q16: Optional[np.ndarray] = None,
                     threshold_map: Optional[np.ndarray] = None,
                     device=None):
    """Take over B streams mid-way from the JAX ``BatchedDeltaPipeline``:
    its flat state (``np.asarray(jax_prev)``), glyph atlas, Q16
    noise-filter taps and shared threshold map. Returns ``(pipeline,
    prev)``; ``prev`` is a copy."""
    prev, atlas = from_jax_state(state_np, atlas_np, device=device)
    pipe = BatchedDeltaPipeline(config, n_streams, device=device,
                                conv_weights_q16=conv_weights_q16,
                                threshold_map=threshold_map, atlas=atlas)
    if prev.numel() != n_streams * config.frame_bytes:
        raise ValueError("state size mismatch")
    return pipe, prev
