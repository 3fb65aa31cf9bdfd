"""Golden CPU reference (pure NumPy) for the operators of the flat slice.

A copy of the subset of the JAX package's ``ops/reference_cpu.py`` that
the default serving path runs: ``diff_encode``, ``client_apply``,
``overlay_blit`` and ``step_oracle`` restricted to that path (no noise
filter, no visualizer, scalar threshold). It is the byte-exact spec the
port's device path is held to, and it lets ``chip_smoke.py`` check the
card's output at 1080p without the JAX package.

Frames are flat ``uint8`` arrays of ``H*W*3`` bytes in BGR byte order,
exactly the ``cv::Mat::data`` layout the reference operates on.

Payload order is ascending byte index. The reference's ``atomicInc``
compaction (``kernels.cu:313-315``) is nondeterministic; the client is a
pure scatter-add (``client/opencv.cpp:64-66``) and therefore
order-insensitive, so this is wire-compatible.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def diff_encode(
    current: np.ndarray,
    previous: np.ndarray,
    threshold=20,
    negative_feedback: bool = True,
) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Threshold delta encoding of ``current`` against ``previous``.

    Returns ``(pos, xs, vals, new_previous)``:

    * ``pos`` — number of changed bytes (``|cur - prev| > threshold``).
    * ``xs`` — int32 ascending byte indices of changed bytes.
    * ``vals`` — uint8 deltas ``(cur - prev) mod 256``; the client's
      wrap-add reproduces ``cur`` exactly.
    * ``new_previous`` — the reconstruction the client now holds: changed
      bytes take the new value; unchanged bytes keep the previous value
      (negative feedback, ``kernels.cu:318-323``).
    """
    cur = np.asarray(current, dtype=np.uint8).ravel()
    prev = np.asarray(previous, dtype=np.uint8).ravel()
    if cur.shape != prev.shape:
        raise ValueError("frame shape mismatch")
    df = cur.astype(np.int32) - prev.astype(np.int32)
    mask = np.abs(df) > threshold
    xs = np.nonzero(mask)[0].astype(np.int32)
    vals = df[mask].astype(np.uint8)  # mod-256 wrap of the signed delta
    if negative_feedback:
        new_prev = np.where(mask, cur, prev).astype(np.uint8)
    else:
        new_prev = cur.copy()
    return int(xs.size), xs, vals, new_prev


def client_apply(frame: np.ndarray, xs: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Client-side reconstruction: uint8 wrap-add scatter
    (``client/opencv.cpp:64-66``)."""
    out = np.asarray(frame, dtype=np.uint8).ravel().copy()
    out[np.asarray(xs, dtype=np.int64)] += np.asarray(vals, dtype=np.uint8)
    return out


def overlay_blit(
    frame: np.ndarray,
    atlas: np.ndarray,
    char_ids: List[int],
    height: int,
    width: int,
) -> np.ndarray:
    """Blit glyph cells onto the frame's top-left corner.

    ``atlas`` is ``(n_chars, cell_h, cell_w, 3)`` uint8. Character ``j`` of
    the string lands with its top-left at pixel ``(0, j*cell_w)`` and
    *overwrites* all three channels including the glyph's black background,
    exactly like the reference's full-cell copy (kernels.cu:358-372 with
    x offset ``charsSz.width*3`` per char, exec_core kernels.cu:466-476).
    """
    out = np.asarray(frame, dtype=np.uint8).reshape(height, width, 3).copy()
    cell_h, cell_w = atlas.shape[1], atlas.shape[2]
    for j, cid in enumerate(char_ids):
        x0 = j * cell_w
        if x0 + cell_w > width or cell_h > height:
            break
        out[0:cell_h, x0 : x0 + cell_w] = atlas[cid]
    return out.ravel()


def step_oracle(
    prev_recon: np.ndarray,
    frame: np.ndarray,
    config,
    atlas: np.ndarray | None = None,
    char_ids: List[int] | None = None,
):
    """Golden full pipeline step of the flat slice. Returns
    ``(new_prev, pos, xs, vals, None)`` in exec_core order: overlay ->
    diff. The noise filter and the visualizers are not part of this
    slice and are refused."""
    from cudavideostream_tpu_torch.config import Visualizer

    if config.noise_filter or config.visualizer != Visualizer.NONE:
        raise NotImplementedError(
            "step_oracle of the port covers the flat slice only (no noise "
            "filter, no visualizer): see ROADMAP.md M10/M11"
        )
    h, w = config.height, config.width
    cur = np.asarray(frame, dtype=np.uint8).ravel()
    if atlas is not None and char_ids:
        cur = overlay_blit(cur, atlas, char_ids, h, w)
    pos, xs, vals, new_prev = diff_encode(
        cur, prev_recon, config.threshold, config.negative_feedback
    )
    return new_prev, pos, xs, vals, None
