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
bytes.

:func:`median_filter` is the reference's benchmarked-and-rejected median
variant (``tests/noise_filter_benchmark/v3.cu``), byte-exact against
:func:`reference_cpu.median_filter`. No serving path calls it; it is
reached by the API only, as in the JAX package.
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


def _oddeven_merge_network(n: int):
    """Batcher odd-even mergesort compare-exchange pairs for n inputs."""
    pairs = []

    def merge(lo, length, r):
        step = r * 2
        if step < length:
            merge(lo, length, step)
            merge(lo + r, length, step)
            for i in range(lo + r, lo + length - r, step):
                if i + r < lo + length:
                    pairs.append((i, i + r))
        elif lo + r < lo + length:
            pairs.append((lo, lo + r))

    def sort(lo, length):
        if length > 1:
            m = length // 2
            sort(lo, m)
            sort(lo + m, length - m)
            merge(lo, length, 1)

    # Batcher needs a power-of-two width; indices >= n are virtual +inf
    # sentinels and their exchanges are dropped
    p = 1
    while p < n:
        p *= 2
    sort(0, p)
    return [(a, b) for a, b in pairs if a < n and b < n]


def median_filter(frame: torch.Tensor, k: int, height: int,
                  width: int) -> torch.Tensor:
    """Zero-padded KxK per-channel median; flat uint8 in and out.

    The k² shifted views of the padded byte-space image go through a
    Batcher odd-even compare-exchange network of ``torch.minimum`` and
    ``torch.maximum`` (the structure of the reference's unrolled bubble
    sort, ``v3.cu:32-47``), and the middle one is the median. The
    network's virtual sentinels are +inf, so its dropped exchanges leave
    the real elements in place. ``frame`` is not modified."""
    pad = k // 2
    img = frame.reshape(height, width * 3)
    padded = F.pad(img, (3 * pad, 3 * pad, pad, pad))
    win = [padded[i:i + height, 3 * j:3 * j + width * 3]
           for i in range(k) for j in range(k)]
    for a, b in _oddeven_merge_network(len(win)):
        win[a], win[b] = (torch.minimum(win[a], win[b]),
                          torch.maximum(win[a], win[b]))
    return win[(k * k) // 2].contiguous().reshape(-1)
