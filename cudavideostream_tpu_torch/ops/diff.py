"""The elementwise delta operator: thresholded per-byte diff with
negative feedback (the counterpart of the JAX package's ``ops/diff.py``).

It is the elementwise half of the plain version of the fused kernel
(:func:`cudavideostream_tpu_torch.ops.logcompact.fused_diff_compact_reference`).

Byte-exact contract (vs :func:`reference_cpu.diff_encode`):

* ``df = int(cur) - int(prev)`` (true signed difference, no uint8 wrap);
* a byte ships iff ``|df| > threshold`` (strictly greater);
* shipped value is ``df mod 256`` (client wrap-add reproduces ``cur``);
* non-shipped bytes of the new previous-frame buffer keep the *previous*
  value under negative feedback (``kernels.cu:318-323``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def diff_mask(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: int,
    negative_feedback: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Elementwise diff stage over flat ``uint8`` frames of equal length.

    Returns ``(mask, vals, new_previous)`` — ``mask`` bool, ``vals`` uint8
    wrap deltas (defined everywhere; only masked entries are meaningful),
    ``new_previous`` uint8 (a new tensor; the inputs are not modified).
    """
    df = current.to(torch.int16) - previous.to(torch.int16)
    mask = df.abs() > threshold
    vals = (df & 255).to(torch.uint8)  # mod-256 wrap
    if negative_feedback:
        new_prev = torch.where(mask, current, previous)
    else:
        new_prev = current.clone()
    return mask, vals, new_prev
