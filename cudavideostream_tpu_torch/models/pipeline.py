"""The flagship model: the fused delta-stream pipeline step (PyTorch port
of the JAX package's ``models/pipeline.py``).

The reference's per-frame GPU schedule (``exec_core``,
``server/src/kernels.cu:430-525``) draws the text overlay and then runs
the thresholded diff with negative feedback and the compaction. Here one
step is: the overlay strip is blended over the frame's first ``cell_h``
image rows (a few hundred KB), and the blended prefix is handed to the
fused diff+compact kernel as its region input, so the overlay costs no
pass over the whole frame. The kernel writes the new previous frame into
the state buffer in place — the counterpart of the JAX pipeline's donated
``prev`` and of the reference's ``swap(d_current, d_previous)``
(``kernels.cu:451``).

The port runs PALLAS compaction with flat emission (the default), tiled
emission (``tiled_payload``, per-unit blocks at ``subtile_rows``), tiled
emission with the packed change bits (``emit_bitmask``) or the
bitmask-only emission (``maskonly_payload``: vals blocks and bits, no
index blocks); no noise filter, no visualizer, a scalar threshold, and
wire v1 to v4. Other configurations raise ``NotImplementedError`` naming
the ``ROADMAP.md`` item that ports them.
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
from cudavideostream_tpu_torch.ops import logcompact
from cudavideostream_tpu_torch.ops import overlay as overlay_ops
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
        (config.visualizer != Visualizer.NONE,
         "visualizers (the filter bank)", "M10"),
        (config.noise_filter, "the noise filter", "M11"),
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


class DeltaStreamPipeline:
    """Configured pipeline over device-resident state.

    Usage::

        pipe = DeltaStreamPipeline(config)          # on the card
        prev = pipe.init_state(base_frame)          # device uint8 buffer
        prev, pos, xs, vals, aux = pipe.step(prev, frame, text="FPS: 30")
    """

    def __init__(self, config: StreamConfig, device=None,
                 atlas: Optional[torch.Tensor] = None, threshold_map=None):
        check_slice(config, threshold_map)
        self.config = config
        self.device = resolve_device(device)
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

    def step(self, prev: torch.Tensor, frame, text: str = ""):
        """Run one frame. ``frame`` may be a numpy array or a tensor.

        Returns ``(new_prev, pos, xs, vals, aux)``: ``new_prev`` is
        ``prev`` updated in place; ``pos`` a 0-d int32 device tensor;
        ``xs`` int32 and ``vals`` uint8 of ``capacity`` entries, zero past
        ``pos``; ``aux`` None (no visualizer is ported). As the JAX
        pipeline does (always worst-case capacity), it returns instead:

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
        # pair_lanes is a TPU lane layout with identical outputs
        if cfg.maskonly_payload:
            pos, counts, vals_t, bits, new_prev = (
                logcompact.fused_diff_compact_mask(
                    cur, prev, threshold=cfg.threshold,
                    negative_feedback=cfg.negative_feedback,
                    overlay_region=region, sub_rows=cfg.subtile_rows,
                )
            )
            return new_prev, pos, counts, vals_t, bits, None
        if cfg.tiled_payload:
            # (pos, counts, xs_t, vals_t[, bits], new_prev)
            *payload, new_prev = logcompact.fused_diff_compact_tiled(
                cur, prev, threshold=cfg.threshold,
                negative_feedback=cfg.negative_feedback,
                overlay_region=region, sub_rows=cfg.subtile_rows,
                emit_bits=cfg.emit_bitmask,
            )
            return (new_prev, *payload, None)
        pos, xs, vals, new_prev = logcompact.fused_diff_compact(
            cur, prev, threshold=cfg.threshold,
            negative_feedback=cfg.negative_feedback, overlay_region=region,
            capacity=cfg.capacity,
        )
        return new_prev, pos, xs, vals, None
