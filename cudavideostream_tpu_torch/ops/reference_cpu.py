"""Golden CPU reference (pure NumPy) for the operators of the ported slices.

A copy of the subset of the JAX package's ``ops/reference_cpu.py`` that
the port's serving paths run: ``diff_encode``, ``client_apply``, the
filter bank (grayscale, the binarize stack, the heatmap LUT, the red
visualizers), the Q16 convolution of the noise filter, ``overlay_blit``
and ``step_oracle`` (with the per-byte threshold map). It is the
byte-exact spec the port's device path is held to, and it lets
``chip_smoke.py`` check the card's output at 1080p without the JAX
package. ``median_filter`` waits for its device twin (ROADMAP M11).

Frames are flat ``uint8`` arrays of ``H*W*3`` bytes in BGR byte order,
exactly the ``cv::Mat::data`` layout the reference operates on.

Documented divergences from the CUDA reference (each a spec decision of
the JAX package, copied so that both packages produce the same bytes):

* Payload order is ascending byte index. The reference's ``atomicInc``
  compaction (``kernels.cu:313-315``) is nondeterministic; the client is a
  pure scatter-add (``client/opencv.cpp:64-66``) and therefore
  order-insensitive, so this is wire-compatible.
* Weighted grayscale uses exact integer arithmetic
  ``(299*R + 587*G + 114*B) // 1000`` instead of float32 truncation
  (``kernels.cu:67-95``).
* The motion heatmap is a 766-entry integer LUT precomputed in float64
  (``heatmap_lut``) rather than per-pixel fast-math ``__sinf``
  (``kernels.cu:243-270``).
* Convolution uses Q16 fixed-point weights with truncation instead of
  float32 accumulation (``kernels.cu:97-136``).
* The red visualizer marks *all* changed pixels; the reference launch
  geometry drops the last ``pos % 1024`` entries (``kernels.cu:514,517``).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def diff_encode(
    current: np.ndarray,
    previous: np.ndarray,
    threshold=20,
    negative_feedback: bool = True,
) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Threshold delta encoding of ``current`` against ``previous``.

    ``threshold`` is an int or a per-byte array of the frame's length
    (compared with ``|df|`` in int32, whatever its dtype).

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


# ---------------------------------------------------------------------------
# Grayscale (kernels.cu:31-95)
# ---------------------------------------------------------------------------


def grayscale_average(frame: np.ndarray) -> np.ndarray:
    """Per-pixel ``(B+G+R)//3`` written to all three channels
    (``grayscale_kernel``, kernels.cu:31-43)."""
    px = np.asarray(frame, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
    g = px.sum(axis=1) // 3
    return np.repeat(g, 3).astype(np.uint8)


def grayscale_weighted(frame: np.ndarray) -> np.ndarray:
    """ITU-weighted grayscale in exact integer arithmetic.

    BGR layout: channel 0 is B (weight .114), 1 is G (.587), 2 is R (.299)
    — ``grayscale_kernel_v3``, kernels.cu:67-95 (see module docstring for
    the fixed-point divergence).
    """
    px = np.asarray(frame, dtype=np.uint8).reshape(-1, 3).astype(np.int64)
    g = (114 * px[:, 0] + 587 * px[:, 1] + 299 * px[:, 2]) // 1000
    return np.repeat(g, 3).astype(np.uint8)


# ---------------------------------------------------------------------------
# Binarization stack (kernels.cu:138-241, CPU path server.cpp:96-135)
# ---------------------------------------------------------------------------


def gray_histogram(gray_frame: np.ndarray) -> np.ndarray:
    """256-bin histogram of the per-pixel gray value.

    The reference samples every third byte of the 3-channel grayscale
    buffer (``generate_histogram``, kernels.cu:147-149) — all three
    channels are equal, so this is the per-pixel histogram.
    """
    g = np.asarray(gray_frame, dtype=np.uint8).ravel()[0::3]
    return np.bincount(g, minlength=256).astype(np.int32)


def top2_scan(histogram: np.ndarray) -> Tuple[int, int]:
    """Exact emulation of the CPU top-2 scan (``server.cpp:108-120``).

    Ties on the max go to the *later* index (``>=``); the runner-up slot
    inherits the previous max index on every max update. Returns
    ``(index_max, index_sec_max)`` (the latter may be -1).
    """
    h = np.asarray(histogram, dtype=np.int64)
    mx, sec = -1, -1
    imax, isec = -1, -1
    for i in range(256):
        hi = int(h[i])
        if hi >= mx:
            isec = imax
            imax = i
            mx = hi
            sec = mx
        elif sec < hi < mx:
            sec = hi
            isec = i
    return imax, isec


def binarize_threshold(histogram: np.ndarray) -> int:
    """Threshold = trunc((imax + isec) / 2) clamped to [50, 200]
    (``server.cpp:121-127``; GPU twin ``compute_max`` kernels.cu:197-205).

    C integer division truncates toward zero, which matters only for the
    degenerate single-bin histogram where ``isec == -1``.
    """
    imax, isec = top2_scan(histogram)
    t = int(math.trunc((imax + isec) / 2))
    return max(50, min(200, t))


def binarize(gray_frame: np.ndarray, threshold: int) -> np.ndarray:
    """``gray > threshold -> 255 else 0`` over all bytes
    (``binarize_kernel_v2``, kernels.cu:222-241)."""
    g = np.asarray(gray_frame, dtype=np.uint8)
    return np.where(g > threshold, 255, 0).astype(np.uint8)


def binarize_pipeline(frame: np.ndarray) -> np.ndarray:
    """Full visualizer-5 chain: weighted grayscale -> histogram ->
    threshold -> binarize (``kernels.cu:491-499``)."""
    g = grayscale_weighted(frame)
    t = binarize_threshold(gray_histogram(g))
    return binarize(g, t)


# ---------------------------------------------------------------------------
# Motion heatmap (kernels.cu:243-270; derivation REPORT/report.tex:1293-1372)
# ---------------------------------------------------------------------------

_HEATMAP_LUT: np.ndarray | None = None


def heatmap_lut() -> np.ndarray:
    """(766, 3) uint8 LUT in BGR order for the sine colormap.

    Index is ``sum(|cur-prev|)`` over the three channels (0..765 — note
    the reference normalizes by 510, so ``d = idx/510`` runs past 1.0 and
    the sine colormap *wraps* for extreme motion; that quirk is part of
    the spec). ``r = clamp(sin(pi*d - pi/2)*255)``,
    ``g = clamp(sin(pi*d)*255)``, ``b = clamp(sin(pi*d + pi/2)*255)``,
    truncated to int — computed once in float64 (see module docstring).
    """
    global _HEATMAP_LUT
    if _HEATMAP_LUT is None:
        d = np.arange(766, dtype=np.float64) / 510.0
        r = np.clip(np.sin(np.pi * d - np.pi / 2) * 255.0, 0.0, 255.0)
        g = np.clip(np.sin(np.pi * d) * 255.0, 0.0, 255.0)
        b = np.clip(np.sin(np.pi * d + np.pi / 2) * 255.0, 0.0, 255.0)
        _HEATMAP_LUT = np.stack(
            [b.astype(np.int32), g.astype(np.int32), r.astype(np.int32)], axis=1
        ).astype(np.uint8)
    return _HEATMAP_LUT


def heatmap(current: np.ndarray, previous: np.ndarray) -> np.ndarray:
    """Per-pixel motion heatmap frame (``heat_map``, kernels.cu:243-270)."""
    cur = np.asarray(current, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
    prev = np.asarray(previous, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
    d = np.abs(cur - prev).sum(axis=1)  # 0..765 (3 channels x 255)
    return heatmap_lut()[d].ravel()


# ---------------------------------------------------------------------------
# Red-noise visualizers (kernels.cu:273-281, exec_core kernels.cu:511-519)
# ---------------------------------------------------------------------------


def red_black(xs: np.ndarray, n_bytes: int) -> np.ndarray:
    """Mode 2: black frame with R=255 on every changed pixel."""
    out = np.zeros(n_bytes, dtype=np.uint8)
    xs = np.asarray(xs, dtype=np.int64)
    out[(xs // 3) * 3 + 2] = 255  # xs + (2 - xs % 3) == R byte of the pixel
    return out


def red_overlap(previous: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Mode 3: previous frame with R=255 on every changed pixel."""
    out = np.asarray(previous, dtype=np.uint8).ravel().copy()
    xs = np.asarray(xs, dtype=np.int64)
    out[(xs // 3) * 3 + 2] = 255
    return out


# ---------------------------------------------------------------------------
# Noise (convolution) filter (kernels.cu:97-136; weights server.cpp:20-36)
# ---------------------------------------------------------------------------


def gaussian_kernel(k: int, sigma: float | None = None) -> np.ndarray:
    """Normalized KxK Gaussian, sigma defaulting to ``k*k/6``
    (``computeGaussianKernel``, server.cpp:20-36, called server.cpp:43)."""
    if sigma is None:
        sigma = (k * k) / 6.0
    i = np.arange(k, dtype=np.float64) - (k - 1) / 2.0
    xx, yy = np.meshgrid(i, i, indexing="ij")
    w = np.exp(-(xx * xx + yy * yy) / (2.0 * sigma * sigma))
    w /= w.sum()
    return w


def mean_kernel(k: int) -> np.ndarray:
    return np.full((k, k), 1.0 / (k * k), dtype=np.float64)


def quantize_kernel_q16(weights: np.ndarray) -> np.ndarray:
    """Round KxK float weights to Q16 fixed point (the spec's exact form)."""
    return np.rint(np.asarray(weights, dtype=np.float64) * 65536.0).astype(np.int64)


def convolve(frame: np.ndarray, weights: np.ndarray, height: int, width: int) -> np.ndarray:
    """Zero-padded KxK convolution per channel in Q16 fixed point.

    Matches ``convolution_kernel`` (kernels.cu:97-136): zero padding at the
    borders, per-channel accumulation, truncation to uint8 (clamped at 0).
    """
    k = weights.shape[0]
    wq = quantize_kernel_q16(weights)
    img = np.asarray(frame, dtype=np.uint8).reshape(height, width, 3).astype(np.int64)
    pad = k // 2
    padded = np.zeros((height + 2 * pad, width + 2 * pad, 3), dtype=np.int64)
    padded[pad : pad + height, pad : pad + width] = img
    acc = np.zeros_like(img)
    for i in range(k):
        for j in range(k):
            acc += wq[i, j] * padded[i : i + height, j : j + width]
    out = np.clip(acc >> 16, 0, 255).astype(np.uint8)
    return out.ravel()


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
    conv_weights: np.ndarray | None = None,
    threshold_map: np.ndarray | None = None,
):
    """Golden full pipeline step. Returns
    ``(new_prev, pos, xs, vals, aux or None)`` in exec_core order:
    conv -> overlay -> visualizer -> diff -> red modes. ``threshold_map``
    (per-byte uint8) overrides ``config.threshold`` when given."""
    from cudavideostream_tpu_torch.config import Visualizer

    h, w = config.height, config.width
    cur = np.asarray(frame, dtype=np.uint8).ravel()
    if config.noise_filter:
        if conv_weights is None:
            conv_weights = gaussian_kernel(config.conv_k)
        cur = convolve(cur, conv_weights, h, w)
    if atlas is not None and char_ids:
        cur = overlay_blit(cur, atlas, char_ids, h, w)

    aux = None
    if config.visualizer == Visualizer.HEATMAP:
        aux = heatmap(cur, prev_recon)
    elif config.visualizer == Visualizer.GRAYSCALE:
        aux = grayscale_weighted(cur)
    elif config.visualizer == Visualizer.BINARIZE:
        aux = binarize_pipeline(cur)

    thr = config.threshold if threshold_map is None else threshold_map
    pos, xs, vals, new_prev = diff_encode(
        cur, prev_recon, thr, config.negative_feedback
    )

    if config.visualizer == Visualizer.RED_BLACK:
        aux = red_black(xs, cur.size)
    elif config.visualizer == Visualizer.RED_OVERLAP:
        aux = red_overlap(prev_recon, xs)
    return new_prev, pos, xs, vals, aux
