"""The elementwise delta operator: thresholded per-byte diff with
negative feedback, and the LSB-first change bitmask (the counterpart of
the JAX package's ``ops/diff.py``).

They are the elementwise half of the plain versions of the fused kernel
(:func:`cudavideostream_tpu_torch.ops.logcompact.fused_diff_compact_reference`
and its tiled and bitmask-only siblings).

Byte-exact contract (vs :func:`reference_cpu.diff_encode`):

* ``df = int(cur) - int(prev)`` (true signed difference, no uint8 wrap);
* a byte ships iff ``|df| > threshold`` (strictly greater), the threshold
  being one int or a per-byte ``uint8`` map read at the byte's own index;
* shipped value is ``df mod 256`` (client wrap-add reproduces ``cur``);
* non-shipped bytes of the new previous-frame buffer keep the *previous*
  value under negative feedback (``kernels.cu:318-323``).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch


def diff_mask(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: Union[int, torch.Tensor],
    negative_feedback: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Elementwise diff stage over flat ``uint8`` frames of equal length.

    ``threshold``: an int, or a ``uint8`` tensor of the frames' length
    (the per-byte map), compared with ``|df|`` in int16 like the int.

    Returns ``(mask, vals, new_previous)`` — ``mask`` bool, ``vals`` uint8
    wrap deltas (defined everywhere; only masked entries are meaningful),
    ``new_previous`` uint8 (a new tensor; the inputs are not modified).
    """
    df = current.to(torch.int16) - previous.to(torch.int16)
    if isinstance(threshold, torch.Tensor):
        threshold = threshold.to(torch.int16)  # never compared in uint8
    mask = df.abs() > threshold
    vals = (df & 255).to(torch.uint8)  # mod-256 wrap
    if negative_feedback:
        new_prev = torch.where(mask, current, previous)
    else:
        new_prev = current.clone()
    return mask, vals, new_prev


def pack_bitmask(mask: torch.Tensor) -> torch.Tensor:
    """Pack a bool mask into LSB-first bitmask bytes: bit ``i % 8`` of
    byte ``i // 8`` is ``mask[i]``; a length that is not a multiple of 8
    pads with zero bits. The contract of the JAX ``pack_bitmask``
    (``ops/diff.py:74-104``), without its MXU layout."""
    m = mask.reshape(-1).to(torch.uint8)
    pad = (-m.numel()) % 8
    if pad:
        m = torch.cat([m, m.new_zeros(pad)])
    # the bit weights made on the mask's device: no upload from the host,
    # so the function can be captured in a CUDA graph
    shifts = torch.arange(8, dtype=torch.int32, device=m.device)
    return (m.view(-1, 8).to(torch.int32) << shifts).sum(dim=1).to(
        torch.uint8)
