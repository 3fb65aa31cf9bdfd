"""The noise filter: a zero-padded KxK convolution per channel in Q16
fixed point (the counterpart of the JAX package's ``ops/convolve.py``
``convolve_q16`` and ``accumulate_q16``), byte-exact against
:func:`reference_cpu.convolve`.

The reference's tiled shared-memory convolution (``kernels.cu:97-136``)
is K^2 shifted integer adds here, over a zero-padded ``(H, W*3)`` byte
view in which a pixel's horizontal neighbour lies 3 bytes away. The sum
stays in int32: the Q16 taps of a normalized kernel add up to about
65,536, so it stays below 255 * 65,536 * (1 + rounding) for any K up to
15. There is no ``F.conv2d``: cuDNN would sum in float (TF32 by default
on the card), and a float sum in another order does not give these
bytes. ``median_filter`` has no caller on a serving path and is not
ported yet (ROADMAP M11).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def convolve_q16(frame: torch.Tensor, weights_q16: np.ndarray, height: int,
                 width: int) -> torch.Tensor:
    """Zero-padded KxK convolution per channel; flat uint8 in/out.

    ``weights_q16`` is a (k, k) integer numpy array of Q16 taps
    (:func:`reference_cpu.quantize_kernel_q16`); ``frame`` is not
    modified."""
    pad = weights_q16.shape[0] // 2
    img = frame.reshape(height, width * 3).to(torch.int32)
    padded = F.pad(img, (3 * pad, 3 * pad, pad, pad))
    return accumulate_q16(padded, weights_q16, height, width)


def accumulate_q16(padded: torch.Tensor, weights_q16: np.ndarray, rows: int,
                   width: int) -> torch.Tensor:
    """The Q16 stencil over a padded byte-space image: ``padded`` is
    ``(rows + 2*pad, width*3 + 6*pad)`` int32; returns flat uint8
    ``(rows * width * 3,)``, ``clip(sum >> 16, 0, 255)``."""
    k = weights_q16.shape[0]
    acc = torch.zeros((rows, width * 3), dtype=torch.int32,
                      device=padded.device)
    for i in range(k):
        for j in range(k):
            w = int(weights_q16[i, j])
            if w:
                acc += w * padded[i:i + rows, 3 * j:3 * j + width * 3]
    return (acc >> 16).clamp(0, 255).to(torch.uint8).reshape(-1)
