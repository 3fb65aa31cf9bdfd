"""Fused diff + negative feedback + stream compaction (K1), flat emission.

The counterpart of the JAX package's ``ops/logcompact.fused_diff_compact``
with ``emit="flat"`` (``_kernel_v2`` plus the tile merge). On a CUDA
tensor :func:`fused_diff_compact` launches the hand-written Hopper kernel
``csrc/logcompact.cu``; on a CPU tensor it runs the plain PyTorch version
:func:`fused_diff_compact_reference`. There is no other route: a CUDA
tensor either reaches the kernel or the call raises.

Contract (``logcompact.py:829-831`` of the JAX package): for every byte
``i`` with ``c = overlay_region[i] if i < len(overlay_region) else
current[i]``, byte ``i`` ships iff ``|c - previous[i]| > threshold``;
``xs`` holds the shipped indices ascending, ``vals`` the deltas
``(c - prev) & 255``, both zero past ``pos``; ``new_prev = shipped ? c :
prev`` under negative feedback, else ``c``.

Unlike the JAX function, which returns a new array, ``new_prev`` is
written into ``previous`` IN PLACE (the counterpart of the JAX pipeline's
buffer donation) and returned: callers that still need the old bytes pass
a copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cudavideostream_tpu_torch.kernels import build
from cudavideostream_tpu_torch.ops import diff as diff_ops

TILE_BYTES = 4096  # one tile of the kernel: 256 threads x 16 bytes
MAX_GRID = 1024    # blocks per launch; larger frames take more tiles per block

_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/logcompact.cu``."""
    global _lib
    if _lib is None:
        lib = build.load("logcompact")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.cvs_fused_diff_compact.argtypes = [
            i, p, p, p, ll, ll, i, i, i, i, p, p, p, ll, p, p,
        ]
        lib.cvs_fused_diff_compact.restype = i
        lib.cvs_error_string.argtypes = [i]
        lib.cvs_error_string.restype = ctypes.c_char_p
        lib.cvs_tile_bytes.argtypes = []
        lib.cvs_tile_bytes.restype = i
        if lib.cvs_tile_bytes() != TILE_BYTES:
            raise RuntimeError("csrc/logcompact.cu tile size disagrees with "
                               "ops/logcompact.py TILE_BYTES")
        _lib = lib
    return _lib


def tile_plan(n: int) -> Tuple[int, int]:
    """``(tiles_per_block, grid)`` of a launch over an ``n``-byte frame."""
    n_tiles = -(-n // TILE_BYTES)
    per_block = max(1, -(-n_tiles // MAX_GRID))
    return per_block, -(-n_tiles // per_block)


def _check_args(current, previous, threshold, overlay_region):
    for name, t in (("current", current), ("previous", previous)):
        if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D uint8 tensor")
    if current.device != previous.device:
        raise ValueError("current and previous must be on one device")
    n = current.numel()
    if previous.numel() != n or n == 0:
        raise ValueError("current and previous must have one nonzero length")
    if n >= 1 << 31:
        raise ValueError("frame byte indices exceed int32")
    if not 0 <= int(threshold) <= 255:
        raise ValueError("threshold must be in [0, 255]")
    if overlay_region is not None:
        if (overlay_region.dtype != torch.uint8 or overlay_region.dim() != 1
                or not overlay_region.is_contiguous()):
            raise ValueError("overlay_region must be a contiguous 1-D uint8 "
                             "tensor")
        if overlay_region.device != current.device:
            raise ValueError("overlay_region must be on the frame's device")
        if overlay_region.numel() > n:
            raise ValueError("overlay_region is longer than the frame")


def fused_diff_compact(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: int = 20,
    negative_feedback: bool = True,
    overlay_region: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
):
    """Flat-emit diff+compact; returns ``(pos, xs, vals, new_prev)``.

    ``pos`` is a 0-d int32 tensor (the true count, which may exceed
    ``capacity``); ``xs`` int32 and ``vals`` uint8 have
    ``min(capacity, n)`` entries (``n`` when ``capacity`` is None), zero
    past ``pos``; ``new_prev`` is ``previous``, updated in place.

    ``overlay_region``: a prefix of the frame with the text strip already
    blended; it replaces ``current`` on its bytes, so diff, negative
    feedback and payload all see the overlaid frame.

    CUDA tensors launch the kernel (and count one in
    ``fused_diff_compact.launches``); CPU tensors run
    :func:`fused_diff_compact_reference`.
    """
    _check_args(current, previous, threshold, overlay_region)
    dev = current.device
    if dev.type == "cpu":
        return fused_diff_compact_reference(
            current, previous, threshold, negative_feedback, overlay_region,
            capacity,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_diff_compact runs on cuda or cpu, not {dev}")
    if current.data_ptr() == previous.data_ptr():
        raise ValueError("current and previous must not share storage")
    region_len = 0 if overlay_region is None else overlay_region.numel()
    region_ptr = overlay_region.data_ptr() if region_len else None
    for t in (current, previous) + ((overlay_region,) if region_len else ()):
        if t.data_ptr() % 16:
            raise ValueError("the kernel reads 16-byte vectors: frame "
                             "buffers must be 16-byte aligned")
    lib = _kernel_lib()
    n = current.numel()
    cap = n if capacity is None else min(int(capacity), n)
    per_block, grid = tile_plan(n)
    xs = torch.empty(cap, dtype=torch.int32, device=dev)
    vals = torch.empty(cap, dtype=torch.uint8, device=dev)
    counts = torch.empty(grid, dtype=torch.int32, device=dev)
    pos = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.cvs_fused_diff_compact(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        current.data_ptr(), previous.data_ptr(), region_ptr, region_len, n,
        int(threshold), int(bool(negative_feedback)), per_block, grid,
        counts.data_ptr(), xs.data_ptr(), vals.data_ptr(), cap,
        pos.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(
            "fused_diff_compact kernel launch failed: "
            f"{lib.cvs_error_string(rc).decode()} ({rc})"
        )
    fused_diff_compact.launches += 1
    return pos, xs, vals, previous


fused_diff_compact.launches = 0


def fused_diff_compact_reference(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: int = 20,
    negative_feedback: bool = True,
    overlay_region: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
):
    """The plain PyTorch version of :func:`fused_diff_compact`: the same
    outputs from ``diff_mask``, ``nonzero`` and ``masked_select``, with
    ``new_prev`` written into ``previous`` in place. ``nonzero`` makes it
    synchronize with the device on CUDA tensors."""
    cur = current
    if overlay_region is not None and overlay_region.numel() > 0:
        r = overlay_region.numel()
        cur = torch.cat([overlay_region, current[r:]])
    mask, dvals, new_prev = diff_ops.diff_mask(
        cur, previous, threshold, negative_feedback
    )
    idx = torch.nonzero(mask).flatten()  # ascending
    shipped = torch.masked_select(dvals, mask)
    n = current.numel()
    cap = n if capacity is None else min(int(capacity), n)
    k = min(idx.numel(), cap)
    xs = torch.zeros(cap, dtype=torch.int32, device=current.device)
    vals = torch.zeros(cap, dtype=torch.uint8, device=current.device)
    xs[:k] = idx[:k].to(torch.int32)
    vals[:k] = shipped[:k]
    previous.copy_(new_prev)  # in place, as the kernel does
    pos = torch.tensor(idx.numel(), dtype=torch.int32, device=current.device)
    return pos, xs, vals, previous
