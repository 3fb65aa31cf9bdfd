"""The flagship model: the fused delta-stream pipeline step (PyTorch port
of the JAX package's ``models/pipeline.py``).

The reference's per-frame GPU schedule (``exec_core``,
``server/src/kernels.cu:430-525``) runs the noise filter, draws the text
overlay, runs the visualizer and then the thresholded diff with negative
feedback and the compaction. Here one step is, in that order:

1. the noise filter (``noise_filter``): the Q16 convolution of the whole
   frame into a new tensor, which the rest of the step reads;
2. the overlay strip, blended over the frame's first ``cell_h`` image rows
   (a few hundred KB); the blended prefix is handed to the fused
   diff+compact kernel as its region input, so the overlay costs no pass
   over the whole frame;
3. the visualizer's aux frame, from the overlaid frame (assembled for it
   alone) and the previous frame: heatmap, grayscale or binarize, or the
   red modes from the changed-byte mask;
4. the fused diff+compact kernel, which writes the new previous frame into
   the state buffer in place — the counterpart of the JAX pipeline's
   donated ``prev`` and of the reference's ``swap(d_current, d_previous)``
   (``kernels.cu:451``). The aux frame is computed before it, on the same
   stream, because every visualizer reads the previous frame as it was.

The PALLAS backend (the default) runs the fused kernel with flat emission,
tiled emission (``tiled_payload``, per-unit blocks at ``subtile_rows``),
tiled emission with the packed change bits (``emit_bitmask``) or the
bitmask-only emission (``maskonly_payload``: vals blocks and bits, no
index blocks); every visualizer and the noise filter on each; the scalar
threshold or a per-byte threshold map (``threshold_map``), which every
emission's kernel reads and the red visualizers' mask too.

The two other backends run no kernel of their own, as in the JAX package,
where their device work is XLA ops; they blend the overlay into the whole
frame and take the dense diff (``ops.diff.diff_mask``):

* SORT compacts on the device by one ``torch.sort`` over packed keys
  (``ops.compact.compact_sort``);
* HOST packs on the host with the native library. Without the noise
  filter only the packed change bits (n/8 bytes) leave the device: the
  host takes the values from its own copy of the frame against a shadow
  of the previous frame (``native.compact_update_np``), which makes the
  pipeline stateful (one stream per pipeline; ``init_state`` first). With
  the noise filter the dense delta is fetched too and packed by
  ``native.compact_bitmask_np``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cudavideostream_tpu_torch import native
from cudavideostream_tpu_torch.config import (
    CompactionBackend,
    PayloadOverflowError,
    StreamConfig,
    Visualizer,
)
from cudavideostream_tpu_torch.ops import compact as compact_ops
from cudavideostream_tpu_torch.ops import convolve as conv_ops
from cudavideostream_tpu_torch.ops import diff as diff_ops
from cudavideostream_tpu_torch.ops import filters as filter_ops
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.ops import overlay as overlay_ops
from cudavideostream_tpu_torch.ops import reference_cpu
from cudavideostream_tpu_torch.utils import fonts

MAX_OVERLAY_CHARS = 28


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. Raises when CUDA is asked for and there is none — the
    port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cudavideostream_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def from_jax_state(prev_np: np.ndarray, atlas_np: Optional[np.ndarray] = None,
                   device=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Turn the JAX pipeline's state — its previous-frame buffer and its
    glyph atlas as numpy arrays (``np.asarray(jax_prev)``,
    ``pipe.atlas_np``) — into this package's tensors ``(prev, atlas)``.
    Both are copies: the port updates ``prev`` in place."""
    dev = resolve_device(device)
    prev = torch.from_numpy(np.array(prev_np, dtype=np.uint8).ravel()).to(dev)
    atlas = None
    if atlas_np is not None:
        atlas = torch.from_numpy(np.array(atlas_np, dtype=np.uint8)).to(dev)
    return prev, atlas


def from_jax_pipeline(config: StreamConfig, prev_np: np.ndarray,
                      atlas_np: Optional[np.ndarray] = None,
                      conv_weights_q16: Optional[np.ndarray] = None,
                      device=None,
                      threshold_map: Optional[np.ndarray] = None):
    """Take over a stream mid-way from the JAX pipeline: its state (as in
    :func:`from_jax_state`), its exact Q16 noise-filter taps
    (``jpipe.conv_weights_q16``) and its per-byte threshold map
    (``jpipe.threshold_map_np``, None without one). Returns ``(pipeline,
    prev)``."""
    prev, atlas = from_jax_state(prev_np, atlas_np, device=device)
    pipe = DeltaStreamPipeline(config, device=device, atlas=atlas,
                               threshold_map=threshold_map,
                               conv_weights_q16=conv_weights_q16)
    return pipe, prev


def from_jax_sharded(config: StreamConfig, mesh, state_np: np.ndarray,
                     conv_weights_q16: Optional[np.ndarray] = None,
                     threshold_map: Optional[np.ndarray] = None,
                     payload_layout: str = "replicated"):
    """Take over the JAX sharded pipeline's stream(s) on a mesh of this
    package (``parallel.make_mesh``): its state as numpy
    (``np.asarray(jax_state)``: flat ``(frame_bytes,)`` for ``step_flat``,
    ``(B, frame_bytes)`` for ``step``), its exact Q16 noise-filter taps
    (``jpipe.conv_q16``) and its per-byte threshold map
    (``jpipe.threshold_map_np``, None without one). Returns ``(pipeline,
    state)``, the state laid out over the mesh as its ``init_state_flat``
    or ``init_state`` lays it."""
    from cudavideostream_tpu_torch.parallel.sharded import (
        ShardedDeltaPipeline,
    )

    pipe = ShardedDeltaPipeline(config, mesh, payload_layout=payload_layout,
                                threshold_map=threshold_map,
                                conv_weights_q16=conv_weights_q16)
    state_np = np.asarray(state_np, dtype=np.uint8)
    state = (pipe.init_state_flat(state_np) if state_np.ndim == 1
             else pipe.init_state(state_np))
    return pipe, state


class DeltaStreamPipeline:
    """Configured pipeline over device-resident state.

    Usage::

        pipe = DeltaStreamPipeline(config)          # on the card
        prev = pipe.init_state(base_frame)          # device uint8 buffer
        prev, pos, xs, vals, aux = pipe.step(prev, frame, text="FPS: 30")
    """

    def __init__(self, config: StreamConfig, device=None,
                 atlas: Optional[torch.Tensor] = None, threshold_map=None,
                 conv_weights: Optional[np.ndarray] = None,
                 conv_weights_q16: Optional[np.ndarray] = None):
        """``conv_weights``: the noise filter's float KxK taps (default
        ``gaussian_kernel(conv_k)``), quantized to Q16 as the JAX pipeline
        does; ``conv_weights_q16`` gives the Q16 taps themselves and wins
        (a handover from the JAX pipeline, :func:`from_jax_pipeline`).

        ``threshold_map``: an optional per-byte sensitivity map, any array
        of the frame's length read as flat uint8 as the JAX pipeline reads
        it (``pipeline.py:76-83``), or a uint8 tensor; another length
        raises ``ValueError``. Byte ``i`` ships iff ``|df_i| >
        threshold_map[i]``, which overrides ``config.threshold``. It is
        kept on the device (``threshold_map``) and as numpy
        (``threshold_map_np``, as in the JAX pipeline)."""
        self.config = config
        self.device = resolve_device(device)
        self.threshold_map_np = None
        self.threshold_map: Optional[torch.Tensor] = None
        if threshold_map is not None:
            if isinstance(threshold_map, torch.Tensor):
                if threshold_map.dtype != torch.uint8:
                    raise ValueError("threshold_map must be a uint8 tensor")
                threshold_map = threshold_map.cpu().numpy()
            tm = np.array(threshold_map, dtype=np.uint8).ravel()
            if tm.size != config.frame_bytes:
                raise ValueError(f"threshold_map has {tm.size} bytes, frame "
                                 f"has {config.frame_bytes}")
            self.threshold_map_np = tm
            self.threshold_map = torch.from_numpy(tm.copy()).to(self.device)
        if conv_weights_q16 is None:
            if conv_weights is None:
                conv_weights = reference_cpu.gaussian_kernel(config.conv_k)
            conv_weights_q16 = reference_cpu.quantize_kernel_q16(
                np.asarray(conv_weights, dtype=np.float64))
        wq = np.array(conv_weights_q16, dtype=np.int64)
        if wq.ndim != 2 or wq.shape[0] != wq.shape[1]:
            raise ValueError("conv weights must be a square KxK array")
        self.conv_weights_q16 = wq
        self.atlas_np = fonts.make_atlas(config.overlay_scale,
                                         config.overlay_font)
        if atlas is None:
            self.atlas = torch.from_numpy(self.atlas_np).to(self.device)
        else:
            if tuple(atlas.shape) != self.atlas_np.shape:
                raise ValueError("atlas shape does not match the config's font")
            self.atlas = atlas.to(self.device, torch.uint8)
        if config.compaction is CompactionBackend.HOST:
            # the host blends the overlay into its own copy of the frame
            self._host_atlas = self.atlas.cpu().numpy()
        # the last overlay text and its device glyph indices
        self._ids: Tuple[str, Optional[torch.Tensor]] = (None, None)
        # the HOST backend's fast path: the host takes the payload values
        # from its own copy of the frame against this shadow of the
        # device's prev (negative feedback included); the noise filter
        # runs on the device, where the host copy would not follow it
        self._host_fast = (config.compaction is CompactionBackend.HOST
                           and not config.noise_filter)
        self._host_prev: Optional[np.ndarray] = None
        self.last_fetch_bytes = 0

    # -- state ------------------------------------------------------------
    def init_state(self, base_frame: np.ndarray) -> torch.Tensor:
        """Upload the base frame as the initial reconstruction state
        (the reference seeds ``d_current`` with it, kernels.cu:406, and
        ships it raw to the client, threads.cpp:224)."""
        base = np.asarray(base_frame, dtype=np.uint8).ravel()
        if base.size != self.config.frame_bytes:
            raise ValueError("base frame size mismatch")
        if self._host_fast:
            # (re)sync the host shadow; load_state comes through here too
            self._host_prev = base.copy()
        return torch.from_numpy(base.copy()).to(self.device)

    # -- the fused step ---------------------------------------------------
    def _frame(self, frame) -> torch.Tensor:
        """The frame as a flat uint8 tensor on the pipeline's device. A
        tensor already there is used as it is (no host round trip); a
        host frame goes up through pinned memory without blocking."""
        if isinstance(frame, torch.Tensor):
            t = frame.to(self.device, torch.uint8).reshape(-1).contiguous()
        else:
            t = torch.from_numpy(
                np.ascontiguousarray(frame, dtype=np.uint8).reshape(-1)
            )
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
        if t.numel() != self.config.frame_bytes:
            raise ValueError("frame size mismatch")
        return t

    def _char_ids(self, text: str) -> torch.Tensor:
        if self._ids[0] != text:
            ids = torch.tensor(fonts.encode_text(text, MAX_OVERLAY_CHARS),
                               dtype=torch.int64)
            if self.device.type == "cuda":
                ids = ids.pin_memory().to(self.device, non_blocking=True)
            self._ids = (text, ids)
        return self._ids[1]

    def _aux(self, cur: torch.Tensor, region: Optional[torch.Tensor],
             prev: torch.Tensor) -> Optional[torch.Tensor]:
        """The visualizer's aux frame, a new tensor (it never aliases the
        state), from the overlaid frame and ``prev`` as it is before the
        step: the kernel that follows overwrites ``prev``."""
        cfg = self.config
        vis = cfg.visualizer
        if vis == Visualizer.NONE:
            return None
        # the overlaid frame, for the visualizer alone: the kernel keeps
        # reading the strip from the region
        cur = logcompact.region_frame(cur, region)
        if vis == Visualizer.HEATMAP:
            return filter_ops.heatmap(cur, prev)
        if vis == Visualizer.GRAYSCALE:
            return filter_ops.grayscale_weighted(cur)
        if vis == Visualizer.BINARIZE:
            return filter_ops.binarize_pipeline(cur)
        # the red modes: |df| > threshold (or the map) on the overlaid
        # frame, which is the JAX pipeline's new_prev != prev wherever it
        # takes that
        thr = (cfg.threshold if self.threshold_map is None
               else self.threshold_map)
        mask = diff_ops.diff_mask(cur, prev, thr)[0]
        if vis == Visualizer.RED_BLACK:
            return filter_ops.red_black(mask)
        return filter_ops.red_overlap(prev, mask)

    def step(self, prev: torch.Tensor, frame, text: str = ""):
        """Run one frame. ``frame`` may be a numpy array or a tensor; it
        is never written.

        Returns ``(new_prev, pos, xs, vals, aux)``: ``new_prev`` is
        ``prev`` updated in place; ``pos`` a 0-d int32 device tensor;
        ``xs`` int32 and ``vals`` uint8 of ``capacity`` entries, zero past
        ``pos``; ``aux`` the visualizer's flat uint8 frame on the device,
        or None without a visualizer. As the JAX pipeline does (always
        worst-case capacity), it returns instead:

        * with ``tiled_payload``: ``(new_prev, pos, counts, xs_t, vals_t,
          aux)``, the per-unit blocks of
          :func:`~cudavideostream_tpu_torch.ops.logcompact.fused_diff_compact_tiled`;
        * with ``emit_bitmask`` too: ``(new_prev, pos, counts, xs_t,
          vals_t, bits, aux)``, the packed change bits written by the same
          launch;
        * with ``maskonly_payload``: ``(new_prev, pos, counts, vals_t,
          bits, aux)``, the bitmask-only emission
          (:func:`~cudavideostream_tpu_torch.ops.logcompact.fused_diff_compact_mask`);
        * under the HOST backend: ``pos`` an int and ``xs``/``vals`` host
          numpy arrays exactly ``pos`` long, packed by the native library
          (see :meth:`_step_dense`), after the step has waited for the
          device. A frame that changes more than ``payload_capacity``
          bytes raises :class:`PayloadOverflowError` with the advanced
          state as ``state``.

        The step does not wait for the device: callers read the sizes and
        copy what they need (see ``runtime.executor``).
        """
        cfg = self.config
        cur = self._frame(frame)
        if cfg.noise_filter:
            cur = conv_ops.convolve_q16(cur, self.conv_weights_q16,
                                        cfg.height, cfg.width)
        n_chars = min(len(text), MAX_OVERLAY_CHARS)
        cell_h = self.atlas.shape[1]
        region = None
        if n_chars and cell_h <= cfg.height:
            # blend the strip over the first cell_h image rows only; the
            # kernel substitutes it for the frame's bytes there
            strip_bytes = cell_h * cfg.width * 3
            region = overlay_ops.overlay_blit(
                cur[:strip_bytes], self.atlas, self._char_ids(text), n_chars,
                cell_h, cfg.width,
            )
        aux = self._aux(cur, region, prev)
        if cfg.compaction is not CompactionBackend.PALLAS:
            return self._step_dense(prev, frame, cur, region, text, n_chars,
                                    aux)
        # pair_lanes is a TPU lane layout with identical outputs
        if cfg.maskonly_payload:
            pos, counts, vals_t, bits, new_prev = (
                logcompact.fused_diff_compact_mask(
                    cur, prev, threshold=cfg.threshold,
                    negative_feedback=cfg.negative_feedback,
                    overlay_region=region, sub_rows=cfg.subtile_rows,
                    threshold_map=self.threshold_map,
                )
            )
            return new_prev, pos, counts, vals_t, bits, aux
        if cfg.tiled_payload:
            # (pos, counts, xs_t, vals_t[, bits], new_prev)
            *payload, new_prev = logcompact.fused_diff_compact_tiled(
                cur, prev, threshold=cfg.threshold,
                negative_feedback=cfg.negative_feedback,
                overlay_region=region, sub_rows=cfg.subtile_rows,
                emit_bits=cfg.emit_bitmask, threshold_map=self.threshold_map,
            )
            return (new_prev, *payload, aux)
        pos, xs, vals, new_prev = logcompact.fused_diff_compact(
            cur, prev, threshold=cfg.threshold,
            negative_feedback=cfg.negative_feedback, overlay_region=region,
            capacity=cfg.capacity, threshold_map=self.threshold_map,
        )
        return new_prev, pos, xs, vals, aux

    def _step_dense(self, prev: torch.Tensor, frame, cur: torch.Tensor,
                    region: Optional[torch.Tensor], text: str, n_chars: int,
                    aux: Optional[torch.Tensor]):
        """The SORT and HOST backends (the JAX ``pipeline.py:251-278,
        335-381``): the overlay blended into the whole frame, the dense
        diff with negative feedback into ``prev`` in place, then the sort
        on the device or the native packers on the host.
        ``last_fetch_bytes`` keeps what the HOST backend brought from the
        device for the frame: the n/8-byte bitmask on the fast path, the
        dense delta as well under the noise filter."""
        cfg = self.config
        host = cfg.compaction is CompactionBackend.HOST
        if host and self._host_fast and self._host_prev is None:
            raise RuntimeError(
                "HOST backend: call init_state(base_frame) before step() - "
                "the host packer derives payload values from its "
                "previous-frame shadow")
        cur = logcompact.region_frame(cur, region)
        thr = (cfg.threshold if self.threshold_map is None
               else self.threshold_map)
        mask, delta, new_prev = diff_ops.diff_mask(cur, prev, thr,
                                                   cfg.negative_feedback)
        prev.copy_(new_prev)  # the state is updated in place, as by K1
        if not host:
            pos, xs, vals = compact_ops.compact(mask, delta, cfg.capacity,
                                                "sort")
            return prev, pos, xs, vals, aux
        bits = diff_ops.pack_bitmask(mask).cpu().numpy()
        if self._host_fast:
            # the host's own frame bytes: a device frame comes down once,
            # as the JAX step's np.asarray brings it
            if isinstance(frame, torch.Tensor):
                cur_host = frame.to("cpu", torch.uint8).reshape(-1).numpy()
            else:
                cur_host = np.ascontiguousarray(frame,
                                                dtype=np.uint8).reshape(-1)
            if n_chars:
                cur_host = reference_cpu.overlay_blit(
                    cur_host, self._host_atlas,
                    fonts.encode_text(text, MAX_OVERLAY_CHARS)[:n_chars],
                    cfg.height, cfg.width)
            xs, vals = native.compact_update_np(cur_host, self._host_prev,
                                                bits)
            if not cfg.negative_feedback:
                # new_prev = cur everywhere, not just at the set bits
                np.copyto(self._host_prev, cur_host)
            self.last_fetch_bytes = bits.nbytes
        else:
            delta = delta.cpu().numpy()
            xs, vals = native.compact_bitmask_np(delta, bits)
            self.last_fetch_bytes = bits.nbytes + delta.nbytes
        pos = xs.size
        if pos > cfg.capacity:
            # state= keeps the executor in step: the host shadow has
            # already taken this frame
            raise PayloadOverflowError(
                f"frame changed {pos} bytes > payload_capacity "
                f"{cfg.capacity}", state=prev)
        return prev, pos, xs, vals, aux
