"""The filter bank of the visualizers: grayscale, binarization, motion
heatmap and the red visualizers (the counterpart of the JAX package's
``ops/filters.py``), byte-exact against :mod:`reference_cpu`.

Frames are flat interleaved BGR ``uint8`` tensors. Every function works
on the ``(npx, 3)`` pixel view in integer arithmetic. The JAX package
instead views a frame as ``(M, 384)`` rows and extracts and replicates
channels with f32 matmuls against 0/1 matrices, because a minor
dimension of 3 costs a TPU relayout; it pins them to
``Precision.HIGHEST`` because bf16 products drift by 1 on weight 587.
On the card the same matmuls would meet TF32, the same trap, and a
strided pixel view costs nothing, so there is no matmul here, and no
branch on ``frame_bytes % 384`` (the JAX ``_layout_ok``): every layout
takes the one path.

* grayscale, average and weighted (``kernels.cu:31-95``), the weighted
  one as ``(114*B + 587*G + 299*R) // 1000`` in int32;
* the binarize chain (``kernels.cu:138-241``, CPU scan
  ``server.cpp:96-135``): per-pixel gray values, their 256-bin histogram
  through K4 (:func:`cudavideostream_tpu_torch.ops.hist.histogram`), the
  CPU scan's top-2 rule as an exclusive running max, and the clamped
  threshold, all on the device with no host wait;
* the motion heatmap (``kernels.cu:243-270``) through the 766-entry LUT,
  wrap past ``d = 510`` included. The JAX package's sine path gives the
  same bytes and exists for TPU speed; it is not ported;
* the red visualizers (``kernels.cu:273-281``) as selects on the
  changed-pixel mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cudavideostream_tpu_torch.ops import hist
from cudavideostream_tpu_torch.ops import reference_cpu

_LUTS: dict = {}


def _pixels(frame: torch.Tensor) -> torch.Tensor:
    """The ``(npx, 3)`` int32 pixel view of a flat BGR frame."""
    return frame.reshape(-1, 3).to(torch.int32)


def _replicate(g: torch.Tensor) -> torch.Tensor:
    """Per-pixel ``uint8`` values written to all three channels."""
    return g.to(torch.uint8)[:, None].expand(-1, 3).reshape(-1)


def grayscale_average(frame: torch.Tensor) -> torch.Tensor:
    """``(B+G+R)//3`` broadcast to all three channels; flat uint8 in/out."""
    return _replicate(_pixels(frame).sum(dim=1) // 3)


def gray_pixels(frame: torch.Tensor) -> torch.Tensor:
    """Per-pixel weighted gray values, ``(114*B + 587*G + 299*R) //
    1000``, as ``(npx,)`` uint8 (each at most 255 by construction)."""
    px = _pixels(frame)
    g = (114 * px[:, 0] + 587 * px[:, 1] + 299 * px[:, 2]) // 1000
    return g.to(torch.uint8)


def grayscale_weighted(frame: torch.Tensor) -> torch.Tensor:
    """Weighted gray broadcast to all three channels; flat uint8 in/out."""
    return _replicate(gray_pixels(frame))


def value_histogram(g: torch.Tensor) -> torch.Tensor:
    """``(256,)`` int32 histogram of uint8 gray values: K4 on the card,
    its plain version on the CPU."""
    return hist.histogram(g.reshape(-1).contiguous())


def gray_histogram(gray_frame: torch.Tensor) -> torch.Tensor:
    """256-bin per-pixel histogram of a 3-channel gray frame (channel 0
    of each pixel, like ``generate_histogram``, ``kernels.cu:147-149``)."""
    return value_histogram(gray_frame.reshape(-1, 3)[:, 0])


def top2_prefix_max(histogram: torch.Tensor) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The CPU top-2 scan (``server.cpp:108-120``) without a loop.

    The scan's ``elif`` never fires (``sec == max`` after every update),
    so the result is the last two indices ``i`` with ``h[i] >=
    max(h[:i])`` (an empty max is -1): ``(imax, isec)`` as 0-d int32
    tensors, ``isec`` -1 when only one such index exists."""
    h = histogram.to(torch.int32)
    run = torch.cummax(h, dim=0).values
    excl = torch.cat([h.new_full((1,), -1), run[:-1]])
    idx = torch.arange(h.numel(), dtype=torch.int32, device=h.device)
    upd = torch.where(h >= excl, idx, -1)
    imax = upd.max()
    isec = torch.where(upd == imax, -1, upd).max()
    return imax, isec


def binarize_threshold(histogram: torch.Tensor) -> torch.Tensor:
    """``trunc((imax + isec) / 2)`` clamped to [50, 200]
    (``server.cpp:121-127``), a 0-d int32 tensor on the histogram's
    device. C truncates toward zero; the only negative sum, -1 (``imax =
    0, isec = -1``), truncates to 0, which the clamp lifts to 50."""
    imax, isec = top2_prefix_max(histogram)
    s = imax + isec
    t = torch.where(s >= 0, s // 2, 0)
    return t.clamp(50, 200)


def binarize(gray_frame: torch.Tensor,
             threshold: torch.Tensor) -> torch.Tensor:
    """``gray > threshold -> 255 else 0`` over all bytes."""
    b = gray_frame.to(torch.int32) > threshold
    return torch.where(b, 255, 0).to(torch.uint8)


def binarize_pixels(gray_px: torch.Tensor,
                    threshold: torch.Tensor) -> torch.Tensor:
    """Per-pixel ``gray > threshold -> 255 else 0`` written to all three
    channels: the bytes of :func:`binarize` on the replicated gray
    frame."""
    return _replicate(binarize(gray_px, threshold))


def binarize_pipeline(frame: torch.Tensor) -> torch.Tensor:
    """Visualizer 5: gray -> histogram (K4) -> top-2 threshold -> 255/0,
    the per-pixel gray computed once and read by both the histogram and
    the output (the JAX ``binarize_pipeline(fused=True)``)."""
    gv = gray_pixels(frame)
    t = binarize_threshold(value_histogram(gv))
    return binarize_pixels(gv, t)


def _heatmap_lut(device: torch.device) -> torch.Tensor:
    """The ``(766, 3)`` uint8 BGR LUT of :func:`reference_cpu.heatmap_lut`
    on ``device``, uploaded once per device."""
    lut = _LUTS.get(device)
    if lut is None:
        lut = torch.from_numpy(reference_cpu.heatmap_lut().copy()).to(device)
        _LUTS[device] = lut
    return lut


def heatmap(current: torch.Tensor, previous: torch.Tensor) -> torch.Tensor:
    """Visualizer 1: per-pixel ``sum |cur - prev|`` over the three
    channels (0..765) through the sine-colormap LUT; flat uint8 BGR."""
    d = (_pixels(current) - _pixels(previous)).abs().sum(dim=1)
    return _heatmap_lut(current.device)[d].reshape(-1)


def changed_pixels(mask: torch.Tensor) -> torch.Tensor:
    """``(npx,)`` bool: any of the pixel's three bytes shipped."""
    return mask.reshape(-1, 3).any(dim=1)


def red_black(mask: torch.Tensor) -> torch.Tensor:
    """Visualizer 2: a black frame with R = 255 on changed pixels; flat
    uint8."""
    ch = changed_pixels(mask)
    out = torch.zeros((ch.numel(), 3), dtype=torch.uint8, device=mask.device)
    out[:, 2] = torch.where(ch, 255, 0).to(torch.uint8)
    return out.reshape(-1)


def red_overlap(previous: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Visualizer 3: a copy of ``previous`` with R = 255 on changed
    pixels; flat uint8."""
    out = previous.reshape(-1, 3).clone()
    out[:, 2] = torch.where(changed_pixels(mask), 255, out[:, 2])
    return out.reshape(-1)
