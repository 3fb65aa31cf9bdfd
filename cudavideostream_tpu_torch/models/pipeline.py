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

The port runs PALLAS compaction with flat emission (the default), tiled
emission (``tiled_payload``, per-unit blocks at ``subtile_rows``), tiled
emission with the packed change bits (``emit_bitmask``) or the
bitmask-only emission (``maskonly_payload``: vals blocks and bits, no
index blocks); every visualizer and the noise filter on each; a scalar
threshold; and wire v1 to v4. Other configurations raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cudavideostream_tpu_torch.config import (
    CompactionBackend,
    StreamConfig,
    Visualizer,
)
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


def check_slice(config: StreamConfig, threshold_map=None) -> None:
    """Refuse configurations this port does not run yet."""
    refusals = [
        (config.compaction is not CompactionBackend.PALLAS,
         f"compaction={config.compaction.value}", "M12"),
        (threshold_map is not None, "per-byte threshold maps", "M17"),
    ]
    for refused, what, item in refusals:
        if refused:
            raise NotImplementedError(
                f"{what} is not ported to cudavideostream_tpu_torch yet: "
                f"see ROADMAP.md {item}"
            )


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
                      device=None):
    """Take over a stream mid-way from the JAX pipeline: its state (as in
    :func:`from_jax_state`) and its exact Q16 noise-filter taps
    (``jpipe.conv_weights_q16``). Returns ``(pipeline, prev)``."""
    prev, atlas = from_jax_state(prev_np, atlas_np, device=device)
    pipe = DeltaStreamPipeline(config, device=device, atlas=atlas,
                               conv_weights_q16=conv_weights_q16)
    return pipe, prev


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
        (a handover from the JAX pipeline, :func:`from_jax_pipeline`)."""
        check_slice(config, threshold_map)
        self.config = config
        self.device = resolve_device(device)
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
        # the last overlay text and its device glyph indices
        self._ids: Tuple[str, Optional[torch.Tensor]] = (None, None)

    # -- state ------------------------------------------------------------
    def init_state(self, base_frame: np.ndarray) -> torch.Tensor:
        """Upload the base frame as the initial reconstruction state
        (the reference seeds ``d_current`` with it, kernels.cu:406, and
        ships it raw to the client, threads.cpp:224)."""
        base = np.asarray(base_frame, dtype=np.uint8).ravel()
        if base.size != self.config.frame_bytes:
            raise ValueError("base frame size mismatch")
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
        # the red modes: |df| > threshold on the overlaid frame, which is
        # the JAX pipeline's new_prev != prev wherever it takes that
        mask = diff_ops.diff_mask(cur, prev, cfg.threshold)[0]
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
          (:func:`~cudavideostream_tpu_torch.ops.logcompact.fused_diff_compact_mask`).

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
        # pair_lanes is a TPU lane layout with identical outputs
        if cfg.maskonly_payload:
            pos, counts, vals_t, bits, new_prev = (
                logcompact.fused_diff_compact_mask(
                    cur, prev, threshold=cfg.threshold,
                    negative_feedback=cfg.negative_feedback,
                    overlay_region=region, sub_rows=cfg.subtile_rows,
                )
            )
            return new_prev, pos, counts, vals_t, bits, aux
        if cfg.tiled_payload:
            # (pos, counts, xs_t, vals_t[, bits], new_prev)
            *payload, new_prev = logcompact.fused_diff_compact_tiled(
                cur, prev, threshold=cfg.threshold,
                negative_feedback=cfg.negative_feedback,
                overlay_region=region, sub_rows=cfg.subtile_rows,
                emit_bits=cfg.emit_bitmask,
            )
            return (new_prev, *payload, aux)
        pos, xs, vals, new_prev = logcompact.fused_diff_compact(
            cur, prev, threshold=cfg.threshold,
            negative_feedback=cfg.negative_feedback, overlay_region=region,
            capacity=cfg.capacity,
        )
        return new_prev, pos, xs, vals, aux
