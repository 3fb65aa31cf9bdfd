"""Deterministic stream compaction by sort: ``(mask, vals) -> (pos, xs,
vals)`` (the counterpart of the JAX package's ``ops/compact.py``).

The reference compacts with a global ``atomicInc`` append
(``kernels.cu:313-315``), whose payload order is not deterministic. Here,
as in the JAX package, the output is in ascending byte index, which the
client (a pure scatter-add, ``client/opencv.cpp:64-66``) does not mind.

These are the SORT backend (``CompactionBackend.SORT``) and the sharded
pipeline's route for a shard past int32. They are XLA ops in the JAX
package, with no Pallas kernel, and torch ops here:

* :func:`compact_sort` — one ``torch.sort`` over packed int32 keys
  ``idx*256 + val``;
* :func:`compact_padded` — a per-row compaction into a padded ``(rows,
  row_len)`` layout plus row counts, by a per-row sort on a key unique
  within the row (the result does not depend on the sort's stability);
  :func:`flatten_padded` gathers it into the flat payload.

Outputs have ``capacity`` entries, the first ``pos`` of which are valid;
entries past ``pos`` are zero.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Packed-key limit: idx*256 + val must stay below the int32 PAD.
_PAD = 2**31 - 1
_MAX_PACKED_ELEMS = (2**31 - 1 - 255) // 256  # 8_388_607; 1080p is 6_220_800


def compact_sort(mask: torch.Tensor, vals: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based compaction.

    Packs ``(byte_index, value)`` into one int32 key (``idx*256 + val``),
    sorts the masked keys to the front and unpacks the first ``capacity``.

    Returns ``(pos, xs, vals_out)``: ``pos`` a 0-d int32 tensor (the true
    count, which may exceed ``capacity``: the caller checks for
    overflow), ``xs`` int32 and ``vals_out`` uint8, ``min(capacity, n)``
    entries each. A mask of more than ``_MAX_PACKED_ELEMS`` bytes raises
    ``ValueError`` before any work (a tensor on the ``meta`` device is
    enough to ask)."""
    n = mask.shape[0]
    if n > _MAX_PACKED_ELEMS:
        raise ValueError(
            f"frame of {n} bytes exceeds packed-key compaction limit "
            f"{_MAX_PACKED_ELEMS}; use compact_padded")
    pos = mask.sum(dtype=torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    key = torch.where(mask, idx * 256 + vals.to(torch.int32),
                      torch.full_like(idx, _PAD))
    skey = torch.sort(key).values[:capacity]
    valid = skey != _PAD
    xs = torch.where(valid, skey >> 8, 0).to(torch.int32)
    vals_out = torch.where(valid, skey & 255, 0).to(torch.uint8)
    return pos, xs, vals_out


def compact_padded(mask: torch.Tensor, vals: torch.Tensor,
                   row_len: int = 1024):
    """Row-wise compaction into a padded layout.

    Views the flat frame as ``(rows, row_len)`` and compacts each row on
    its own: element ``i`` with ``mask[i]`` lands at slot
    ``cumsum(mask)[i]-1`` of its row. Returns ``(pos, xs_pad, vals_pad,
    row_counts)``: ``xs_pad`` int32 and ``vals_pad`` uint8 ``(rows,
    row_len)``, each row's first ``row_counts[row]`` slots holding global
    byte indices and values in ascending order, the rest zero."""
    n = mask.shape[0]
    if n % row_len:
        raise ValueError(f"frame bytes {n} not divisible by row_len {row_len}")
    rows = n // row_len
    m = mask.reshape(rows, row_len)
    v = vals.reshape(rows, row_len).to(torch.int32)
    col = torch.arange(row_len, dtype=torch.int32, device=mask.device)
    gidx = (torch.arange(rows, dtype=torch.int32, device=mask.device)[:, None]
            * row_len + col)
    incl = torch.cumsum(m.to(torch.int32), dim=1, dtype=torch.int32)
    row_counts = incl[:, -1]
    pos = row_counts.sum(dtype=torch.int32)
    # a masked element keys to its slot, an unmasked one past row_len:
    # unique within the row, so any sort puts the masked elements first
    # in slot order
    key = torch.where(m, incl - 1, row_len + col)
    order = torch.sort(key, dim=1).indices
    xs_pad = torch.gather(gidx.expand(rows, row_len), 1, order)
    vals_pad = torch.gather(v, 1, order)
    valid = col[None, :] < row_counts[:, None]
    xs_pad = torch.where(valid, xs_pad, 0).to(torch.int32)
    vals_pad = torch.where(valid, vals_pad, 0).to(torch.uint8)
    return pos, xs_pad, vals_pad, row_counts


def flatten_padded(xs_pad: torch.Tensor, vals_pad: torch.Tensor,
                   row_counts: torch.Tensor, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the padded rows into flat ``(capacity,)`` payload arrays:
    output slot ``p`` finds its row by a search over the row offsets,
    then its slot within the row; slots past ``pos`` are zero."""
    rows, row_len = xs_pad.shape
    dev = xs_pad.device
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(row_counts.to(torch.int64), dim=0)])
    p = torch.arange(capacity, dtype=torch.int64, device=dev)
    row = (torch.searchsorted(offsets, p, right=True) - 1).clamp(0, rows - 1)
    slot = p - offsets[row]
    valid = p < offsets[-1]
    flat_idx = row * row_len + slot.clamp(0, row_len - 1)
    xs = torch.where(valid, xs_pad.reshape(-1)[flat_idx], 0).to(torch.int32)
    vals = torch.where(valid, vals_pad.reshape(-1)[flat_idx],
                       0).to(torch.uint8)
    return xs, vals


def compact(mask: torch.Tensor, vals: torch.Tensor, capacity: int,
            backend: str = "sort", row_len: int = 1024):
    """Dispatch over the compaction backends; ``(pos, xs, vals)`` out."""
    if backend == "sort":
        return compact_sort(mask, vals, capacity)
    if backend == "padded":
        pos, xs_pad, vals_pad, row_counts = compact_padded(mask, vals, row_len)
        xs, v = flatten_padded(xs_pad, vals_pad, row_counts, capacity)
        return pos, xs, v
    raise ValueError(f"unknown compaction backend {backend!r}")
