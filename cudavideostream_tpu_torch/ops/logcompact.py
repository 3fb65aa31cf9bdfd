"""Fused diff + negative feedback + stream compaction (K1), and the
compactions that merge its per-unit blocks: pairs (K2) and vals alone (K3).

The counterpart of the JAX package's ``ops/logcompact.py``:

* :func:`fused_diff_compact` — ``fused_diff_compact(emit="flat")``
  (``_kernel_v2`` plus the tile merge);
* :func:`fused_diff_compact_tiled` — ``fused_diff_compact(emit="tiled")``,
  the per-unit blocks of ``_kernel_v2`` with ``sub_rows``, at the JAX
  package's own unit geometry (:func:`tiled_geometry`) and narrowed
  counts, so the wire bytes and every output shape are the same; with
  ``emit_bits`` it also writes the packed change bits of the
  ``--bitmask`` emission;
* :func:`fused_diff_compact_mask` — ``fused_diff_compact(emit="mask")``,
  the bitmask-only emission: per-unit vals blocks and the packed bits at
  the mask geometry (:func:`tiled_geometry_mask`), no index blocks;
* :func:`pair_compact` — ``_kernel_pair``: a stable compaction of
  ``(xs, vals)`` pairs by ``vals != 0``, emitted flat;
* :func:`merge_tiles` — ``merge_tiles``, through :func:`pair_compact`;
* :func:`vals_compact` — ``_kernel_vals``: the same compaction of a
  ``vals`` stream alone, emitted flat;
* :func:`merge_vals` — ``merge_vals``, through :func:`vals_compact`.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/logcompact.cu``, ``csrc/pair_compact.cu``) and adds one to its
``launches`` count; on a CPU tensor it runs its plain PyTorch version
(``*_reference``). There is no other route: a CUDA tensor either reaches
the kernel or the call raises.

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

# The JAX package's tile geometry (``logcompact.py:73-128``), copied: the
# tiled emission's unit count and unit size follow from it, and they
# must be the JAX package's for the tiled outputs to be the same arrays.
LANES = 128
GEOMETRY_MAX_GRID = 2000

_libs: dict = {}


def _bind_common(lib: ctypes.CDLL, name: str) -> None:
    lib.cvs_error_string.argtypes = [ctypes.c_int]
    lib.cvs_error_string.restype = ctypes.c_char_p
    lib.cvs_tile_bytes.argtypes = []
    lib.cvs_tile_bytes.restype = ctypes.c_int
    if lib.cvs_tile_bytes() != TILE_BYTES:
        raise RuntimeError(f"csrc/{name}.cu tile size disagrees with "
                           "ops/logcompact.py TILE_BYTES")


def _kernel_lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/logcompact.cu`` (K1)."""
    lib = _libs.get("logcompact")
    if lib is None:
        lib = build.load("logcompact")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.cvs_fused_diff_compact.argtypes = [
            i, p, p, p, ll, ll, i, i, i, i, p, p, p, ll, p, p,
        ]
        lib.cvs_fused_diff_compact.restype = i
        lib.cvs_tiled_grid.argtypes = [ll, i]
        lib.cvs_tiled_grid.restype = i
        lib.cvs_fused_diff_compact_tiled.argtypes = [
            i, p, p, p, ll, ll, ll, i, i, i, i, p, p, i, p, p, p, p, p,
        ]
        lib.cvs_fused_diff_compact_tiled.restype = i
        _bind_common(lib, "logcompact")
        _libs["logcompact"] = lib
    return lib


def _pair_lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/pair_compact.cu`` (K2, K3)."""
    lib = _libs.get("pair_compact")
    if lib is None:
        lib = build.load("pair_compact")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.cvs_pair_compact.argtypes = [i, p, p, ll, i, i, p, p, p, p, p]
        lib.cvs_pair_compact.restype = i
        lib.cvs_vals_compact.argtypes = [i, p, ll, i, i, p, p, p, p]
        lib.cvs_vals_compact.restype = i
        _bind_common(lib, "pair_compact")
        _libs["pair_compact"] = lib
    return lib


def _raise_on(rc: int, lib: ctypes.CDLL, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.cvs_error_string(rc).decode()} ({rc})")


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def tile_plan(n: int) -> Tuple[int, int]:
    """``(tiles_per_block, grid)`` of a launch over an ``n``-byte frame."""
    n_tiles = -(-n // TILE_BYTES)
    per_block = max(1, -(-n_tiles // MAX_GRID))
    return per_block, -(-n_tiles // per_block)


# -- the JAX package's tile geometry -------------------------------------

def _pick_tile_rows(rows: int, target: int = 512) -> int:
    """Largest divisor of ``rows`` <= target that is a multiple of 8."""
    best = None
    for d in range(8, target + 1, 8):
        if rows % d == 0:
            best = d
    return best if best is not None else rows


def _pad_rows(rows: int) -> int:
    """Smallest padded row count >= ``rows`` that is a multiple of 8 and
    admits a tile divisor of at least min(rows, 400) rows."""
    pr = (rows + 7) // 8 * 8
    while _pick_tile_rows(pr) < min(pr, 400):
        pr += 8
    return pr


def _tile_geometry(rows: int) -> Tuple[int, int]:
    """``(padded_rows, tile_rows)``: the 400-512-row tiles, grown past
    ``GEOMETRY_MAX_GRID`` tiles for frames beyond ~131 MB."""
    pr = _pad_rows(rows)
    t = _pick_tile_rows(pr)
    if pr // t > GEOMETRY_MAX_GRID:
        t = (-(-rows // GEOMETRY_MAX_GRID) + 7) // 8 * 8
        pr = -(-rows // t) * t
    return pr, t


def _tile_geometry_mask(rows: int) -> Tuple[int, int]:
    """``(padded_rows, tile_rows)`` of the bitmask-only emission: tiles
    of a multiple of 64 rows (a TPU block-shape rule, kept so that the
    outputs have the JAX package's shapes; ``logcompact.py:131-155``)."""
    pr = -(-rows // 64) * 64
    if pr <= 512:
        return pr, pr
    while True:
        best = None
        for d in range(64, 513, 64):
            if pr % d == 0:
                best = d
        if best is not None and best >= 384:
            break
        pr += 64
    if pr // best > GEOMETRY_MAX_GRID:
        t = (-(-rows // GEOMETRY_MAX_GRID) + 63) // 64 * 64
        pr = -(-rows // t) * t
        return pr, t
    return pr, best


def _unit_geometry(rows: int, tile_rows: int,
                   sub_rows: int) -> Tuple[int, int]:
    """``(n_pad, unit_bytes)`` of ``rows`` padded rows cut into units of
    ``sub_rows`` rows, or whole tiles when ``sub_rows`` is 0, does not
    divide the tile, or the tile is taller than 512 rows (the JAX
    package falls back silently in those cases, ``logcompact.py:894-903``,
    and so does this)."""
    if sub_rows and (tile_rows % sub_rows or tile_rows > 512):
        sub_rows = 0
    n_pad = rows * LANES
    if n_pad >= 1 << 31:
        raise ValueError("frame byte indices exceed int32")
    return n_pad, (sub_rows or tile_rows) * LANES


def tiled_geometry(n: int, sub_rows: int) -> Tuple[int, int]:
    """``(n_pad, unit_bytes)`` of the tiled emission of an ``n``-byte
    frame: units of ``sub_rows`` rows of 128 bytes (see
    :func:`_unit_geometry`). The frame pads to ``n_pad`` bytes with
    ``cur == prev`` bytes, which never ship."""
    return _unit_geometry(*_tile_geometry(-(-n // LANES)), sub_rows)


def tiled_geometry_mask(n: int, sub_rows: int) -> Tuple[int, int]:
    """``(n_pad, unit_bytes)`` of the bitmask-only emission: as
    :func:`tiled_geometry` on the mask tiles (``_tile_geometry_mask``);
    at 1080p 48,640 rows of 512-row tiles, ``n_pad`` = 6,225,920."""
    return _unit_geometry(*_tile_geometry_mask(-(-n // LANES)), sub_rows)


def counts_dtype(unit_bytes: int) -> torch.dtype:
    """The narrowest dtype that holds a full unit's count
    (``_narrow_counts``, ``logcompact.py:1218-1230``)."""
    if unit_bytes < 256:
        return torch.uint8
    if unit_bytes < 32768:
        return torch.int16
    return torch.int32


# -- K1 -------------------------------------------------------------------

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


def _check_kernel_args(name, current, previous, overlay_region):
    """The device checks of a K1 launch; returns the region's length."""
    dev = current.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if current.data_ptr() == previous.data_ptr():
        raise ValueError("current and previous must not share storage")
    region_len = 0 if overlay_region is None else overlay_region.numel()
    for t in (current, previous) + ((overlay_region,) if region_len else ()):
        if t.data_ptr() % 16:
            raise ValueError("the kernel reads 16-byte vectors: frame "
                             "buffers must be 16-byte aligned")
    return region_len


def region_frame(current, overlay_region):
    """``current`` with the overlay region substituted for its prefix."""
    if overlay_region is None or overlay_region.numel() == 0:
        return current
    return torch.cat([overlay_region, current[overlay_region.numel():]])


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
    region_len = _check_kernel_args("fused_diff_compact", current, previous,
                                    overlay_region)
    region_ptr = overlay_region.data_ptr() if region_len else None
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
        _device_index(dev),
        current.data_ptr(), previous.data_ptr(), region_ptr, region_len, n,
        int(threshold), int(bool(negative_feedback)), per_block, grid,
        counts.data_ptr(), xs.data_ptr(), vals.data_ptr(), cap,
        pos.data_ptr(), stream,
    )
    _raise_on(rc, lib, "fused_diff_compact")
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
    cur = region_frame(current, overlay_region)
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


def _launch_tiled(name, current, previous, threshold, negative_feedback,
                  overlay_region, n_pad, unit_bytes, emit_xs, emit_bits):
    """One launch of the tiled K1 entry point; returns ``(pos, counts,
    xs_t or None, vals_t, bits or None)``."""
    region_len = _check_kernel_args(name, current, previous, overlay_region)
    region_ptr = overlay_region.data_ptr() if region_len else None
    lib = _kernel_lib()
    dev = current.device
    n_units = n_pad // unit_bytes
    xs_t = (torch.empty((n_units, unit_bytes), dtype=torch.int32, device=dev)
            if emit_xs else None)
    vals_t = torch.empty((n_units, unit_bytes), dtype=torch.uint8, device=dev)
    bits = (torch.empty(n_pad // 8, dtype=torch.uint8, device=dev)
            if emit_bits else None)
    counts = torch.empty(n_units, dtype=counts_dtype(unit_bytes), device=dev)
    scratch = torch.empty(lib.cvs_tiled_grid(n_pad, unit_bytes),
                          dtype=torch.int32, device=dev)
    pos = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.cvs_fused_diff_compact_tiled(
        _device_index(dev),
        current.data_ptr(), previous.data_ptr(), region_ptr, region_len,
        current.numel(), n_pad, int(threshold), int(bool(negative_feedback)),
        unit_bytes, counts.element_size(), scratch.data_ptr(),
        counts.data_ptr(), int(emit_xs),
        None if xs_t is None else xs_t.data_ptr(), vals_t.data_ptr(),
        None if bits is None else bits.data_ptr(), pos.data_ptr(), stream,
    )
    _raise_on(rc, lib, name)
    return pos, counts, xs_t, vals_t, bits


def _tiled_plain(current, previous, threshold, negative_feedback,
                 overlay_region, n_pad, unit_bytes, emit_xs, emit_bits):
    """The plain PyTorch version of :func:`_launch_tiled`: the mask from
    ``diff_mask``, each entry's rank in its unit from a per-unit
    ``cumsum``, one scatter into zeroed blocks, and ``pack_bitmask``;
    ``new_prev`` is written into ``previous`` in place."""
    dev = current.device
    n = current.numel()
    n_units = n_pad // unit_bytes
    cur = region_frame(current, overlay_region)
    mask, dvals, new_prev = diff_ops.diff_mask(
        cur, previous, threshold, negative_feedback
    )
    m = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    m[:n] = mask
    m2 = m.view(n_units, unit_bytes)
    counts = m2.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(m2, dim=1, dtype=torch.int32) - 1
    slot = (torch.arange(n_units, dtype=torch.int64, device=dev)[:, None]
            * unit_bytes + rank)[m2]
    xs_t = None
    if emit_xs:
        xs_t = torch.zeros(n_pad, dtype=torch.int32, device=dev)
        xs_t[slot] = torch.nonzero(m).flatten().to(torch.int32)
        xs_t = xs_t.view(n_units, unit_bytes)
    vals_t = torch.zeros(n_pad, dtype=torch.uint8, device=dev)
    vals_t[slot] = dvals[mask]
    bits = diff_ops.pack_bitmask(m) if emit_bits else None
    previous.copy_(new_prev)  # in place, as the kernel does
    pos = counts.sum(dtype=torch.int32)
    return (pos, counts.to(counts_dtype(unit_bytes)), xs_t,
            vals_t.view(n_units, unit_bytes), bits)


def fused_diff_compact_tiled(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: int = 20,
    negative_feedback: bool = True,
    overlay_region: Optional[torch.Tensor] = None,
    sub_rows: int = 0,
    emit_bits: bool = False,
):
    """Tiled-emit diff+compact; returns ``(pos, counts, xs_t, vals_t,
    new_prev)`` as JAX ``fused_diff_compact(emit="tiled")`` does, and
    ``(pos, counts, xs_t, vals_t, bits, new_prev)`` with ``emit_bits``.

    The frame is cut into ``n_units`` units of ``unit_bytes``
    (:func:`tiled_geometry`). Unit ``u`` holds its ``counts[u]`` shipped
    entries, ascending, at ``xs_t[u, :counts[u]]`` (GLOBAL byte indices,
    int32) and ``vals_t[u, :counts[u]]`` (uint8 deltas), and zeros after
    them. ``counts`` has the narrowest dtype that holds ``unit_bytes``
    (:func:`counts_dtype`); ``pos`` is their int32 total, a 0-d tensor;
    ``new_prev`` is ``previous``, updated in place. Concatenating the
    units' prefixes gives the flat emission's ``(xs, vals)``.

    ``emit_bits``: also return the LSB-first bitmask of the shipped bytes
    over the ``n_pad`` bytes (``n_pad / 8`` uint8, padding bits 0), which
    the JAX pipeline packs after its kernel for ``emit_bitmask``
    (``pipeline.py:208-227``). Here the same launch writes it, from the
    mask it already holds: ``prev`` is updated in place, so the JAX
    pipeline's ``new_prev != prev`` no longer exists after the launch.

    CUDA tensors launch the kernel (and count one in
    ``fused_diff_compact_tiled.launches``); CPU tensors run
    :func:`fused_diff_compact_tiled_reference`.
    """
    _check_args(current, previous, threshold, overlay_region)
    if current.device.type == "cpu":
        return fused_diff_compact_tiled_reference(
            current, previous, threshold, negative_feedback, overlay_region,
            sub_rows, emit_bits,
        )
    n_pad, unit_bytes = tiled_geometry(current.numel(), sub_rows)
    out = _launch_tiled("fused_diff_compact_tiled", current, previous,
                        threshold, negative_feedback, overlay_region, n_pad,
                        unit_bytes, True, emit_bits)
    fused_diff_compact_tiled.launches += 1
    return _tiled_result(out, previous, emit_bits)


fused_diff_compact_tiled.launches = 0


def _tiled_result(out, previous, emit_bits):
    pos, counts, xs_t, vals_t, bits = out
    if emit_bits:
        return pos, counts, xs_t, vals_t, bits, previous
    return pos, counts, xs_t, vals_t, previous


def fused_diff_compact_tiled_reference(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: int = 20,
    negative_feedback: bool = True,
    overlay_region: Optional[torch.Tensor] = None,
    sub_rows: int = 0,
    emit_bits: bool = False,
):
    """The plain PyTorch version of :func:`fused_diff_compact_tiled`: the
    mask from ``diff_mask``, each entry's rank in its unit from a
    per-unit ``cumsum``, one scatter into zeroed blocks."""
    n_pad, unit_bytes = tiled_geometry(current.numel(), sub_rows)
    out = _tiled_plain(current, previous, threshold, negative_feedback,
                       overlay_region, n_pad, unit_bytes, True, emit_bits)
    return _tiled_result(out, previous, emit_bits)


def fused_diff_compact_mask(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: int = 20,
    negative_feedback: bool = True,
    overlay_region: Optional[torch.Tensor] = None,
    sub_rows: int = 0,
):
    """Bitmask-only diff+compact; returns ``(pos, counts, vals_t, bits,
    new_prev)`` as JAX ``fused_diff_compact(emit="mask")`` does.

    The units are those of :func:`tiled_geometry_mask` (at 1080p 48,640
    units of 128 B at ``sub_rows=1``). ``vals_t`` ``(n_units,
    unit_bytes)`` holds each unit's shipped deltas, ascending, and zeros
    past ``counts[u]``; ``counts`` is narrowed (:func:`counts_dtype`);
    ``bits`` is the flat LSB-first ``n_pad / 8`` bitmask of the shipped
    bytes (the ``pack_bitmask`` layout; ascending bit order is the
    payload's index order). No index blocks exist. ``new_prev`` is
    ``previous``, updated in place.

    CUDA tensors launch the kernel (and count one in
    ``fused_diff_compact_mask.launches``); CPU tensors run
    :func:`fused_diff_compact_mask_reference`.
    """
    _check_args(current, previous, threshold, overlay_region)
    if current.device.type == "cpu":
        return fused_diff_compact_mask_reference(
            current, previous, threshold, negative_feedback, overlay_region,
            sub_rows,
        )
    n_pad, unit_bytes = tiled_geometry_mask(current.numel(), sub_rows)
    pos, counts, _, vals_t, bits = _launch_tiled(
        "fused_diff_compact_mask", current, previous, threshold,
        negative_feedback, overlay_region, n_pad, unit_bytes, False, True)
    fused_diff_compact_mask.launches += 1
    return pos, counts, vals_t, bits, previous


fused_diff_compact_mask.launches = 0


def fused_diff_compact_mask_reference(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: int = 20,
    negative_feedback: bool = True,
    overlay_region: Optional[torch.Tensor] = None,
    sub_rows: int = 0,
):
    """The plain PyTorch version of :func:`fused_diff_compact_mask`."""
    n_pad, unit_bytes = tiled_geometry_mask(current.numel(), sub_rows)
    pos, counts, _, vals_t, bits = _tiled_plain(
        current, previous, threshold, negative_feedback, overlay_region,
        n_pad, unit_bytes, False, True)
    return pos, counts, vals_t, bits, previous


# -- K2 -------------------------------------------------------------------

def pair_compact(xs_flat: torch.Tensor, vals_flat: torch.Tensor):
    """Stable compaction of ``(xs, vals)`` pairs by ``vals != 0``; returns
    ``(pos, xs, vals)``, ``pos`` a 0-d int32 tensor and ``xs`` int32 /
    ``vals`` uint8 of the input length, the kept pairs first in input
    order and zeros after them.

    The port of ``_kernel_pair`` (through ``_pair_compact``), emitted flat:
    its outputs equal the concatenated prefixes of the JAX function's
    per-tile blocks. An ``xs`` value of 0 is an ordinary index: validity
    follows ``vals`` alone.

    CUDA tensors launch the kernel (and count one in
    ``pair_compact.launches``); CPU tensors run
    :func:`pair_compact_reference`.
    """
    if (xs_flat.dtype != torch.int32 or vals_flat.dtype != torch.uint8
            or xs_flat.dim() != 1 or vals_flat.dim() != 1
            or not xs_flat.is_contiguous() or not vals_flat.is_contiguous()):
        raise ValueError("pair_compact takes contiguous 1-D int32 xs and "
                         "uint8 vals")
    n = xs_flat.numel()
    if vals_flat.numel() != n or n == 0:
        raise ValueError("xs and vals must have one nonzero length")
    if n >= 1 << 31:
        raise ValueError("pair indices exceed int32")
    dev = xs_flat.device
    if vals_flat.device != dev:
        raise ValueError("xs and vals must be on one device")
    if dev.type == "cpu":
        return pair_compact_reference(xs_flat, vals_flat)
    if dev.type != "cuda":
        raise ValueError(f"pair_compact runs on cuda or cpu, not {dev}")
    if xs_flat.data_ptr() % 16 or vals_flat.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte vectors: xs and vals "
                         "must be 16-byte aligned")
    lib = _pair_lib()
    per_block, grid = tile_plan(n)
    xs = torch.empty(n, dtype=torch.int32, device=dev)
    vals = torch.empty(n, dtype=torch.uint8, device=dev)
    counts = torch.empty(grid, dtype=torch.int32, device=dev)
    pos = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.cvs_pair_compact(
        _device_index(dev), xs_flat.data_ptr(), vals_flat.data_ptr(), n,
        per_block, grid, counts.data_ptr(), xs.data_ptr(), vals.data_ptr(),
        pos.data_ptr(), stream,
    )
    _raise_on(rc, lib, "pair_compact")
    pair_compact.launches += 1
    return pos, xs, vals


pair_compact.launches = 0


def pair_compact_reference(xs_flat: torch.Tensor, vals_flat: torch.Tensor):
    """The plain PyTorch version of :func:`pair_compact` (``nonzero`` and
    ``masked_select``; it synchronizes with the device on CUDA tensors)."""
    keep = vals_flat != 0
    kx = torch.masked_select(xs_flat, keep)
    xs = torch.zeros_like(xs_flat)
    vals = torch.zeros_like(vals_flat)
    xs[:kx.numel()] = kx
    vals[:kx.numel()] = torch.masked_select(vals_flat, keep)
    return (torch.tensor(kx.numel(), dtype=torch.int32, device=xs.device),
            xs, vals)


def merge_tiles(counts: torch.Tensor, xs_t: torch.Tensor,
                vals_t: torch.Tensor):
    """Concatenate the units' compacted prefixes into flat ``(xs, vals)``
    of ``n_units * unit_bytes`` entries, zero past ``pos`` — JAX
    ``merge_tiles`` on its ``[:pos]`` prefix, with a zero tail.

    The blocks are zero past each unit's count, so the merge is a pair
    compaction of the flattened blocks (:func:`pair_compact`, one K2
    launch at any unit count: the JAX package's serial branch for at most
    256 units, ``MERGE_SERIAL_MAX_UNITS``, needs no separate port).
    ``counts`` is checked for shape only."""
    if xs_t.dim() != 2 or xs_t.shape != vals_t.shape:
        raise ValueError("xs_t and vals_t must be (n_units, unit_bytes)")
    if counts.shape != xs_t.shape[:1]:
        raise ValueError("counts must have one entry per unit")
    _, xs, vals = pair_compact(xs_t.reshape(-1), vals_t.reshape(-1))
    return xs, vals


# -- K3 -------------------------------------------------------------------

def vals_compact(vals_flat: torch.Tensor):
    """Stable compaction of a uint8 stream by ``vals != 0``; returns
    ``(pos, vals)``, ``pos`` a 0-d int32 tensor and ``vals`` uint8 of the
    input length, the nonzero bytes first in input order and zeros after
    them.

    The port of ``_kernel_vals`` (through ``_vals_compact``), emitted
    flat: its output equals the concatenated prefixes of the JAX
    function's per-tile blocks.

    CUDA tensors launch the kernel (and count one in
    ``vals_compact.launches``); CPU tensors run
    :func:`vals_compact_reference`.
    """
    if (vals_flat.dtype != torch.uint8 or vals_flat.dim() != 1
            or not vals_flat.is_contiguous()):
        raise ValueError("vals_compact takes a contiguous 1-D uint8 tensor")
    n = vals_flat.numel()
    if n == 0:
        raise ValueError("vals_compact takes a nonzero length")
    if n >= 1 << 31:
        raise ValueError("stream indices exceed int32")
    dev = vals_flat.device
    if dev.type == "cpu":
        return vals_compact_reference(vals_flat)
    if dev.type != "cuda":
        raise ValueError(f"vals_compact runs on cuda or cpu, not {dev}")
    if vals_flat.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte vectors: vals must be "
                         "16-byte aligned")
    lib = _pair_lib()
    per_block, grid = tile_plan(n)
    vals = torch.empty(n, dtype=torch.uint8, device=dev)
    counts = torch.empty(grid, dtype=torch.int32, device=dev)
    pos = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.cvs_vals_compact(
        _device_index(dev), vals_flat.data_ptr(), n, per_block, grid,
        counts.data_ptr(), vals.data_ptr(), pos.data_ptr(), stream,
    )
    _raise_on(rc, lib, "vals_compact")
    vals_compact.launches += 1
    return pos, vals


vals_compact.launches = 0


def vals_compact_reference(vals_flat: torch.Tensor):
    """The plain PyTorch version of :func:`vals_compact`
    (``masked_select`` into zeros; it synchronizes with the device on
    CUDA tensors)."""
    kept = torch.masked_select(vals_flat, vals_flat != 0)
    vals = torch.zeros_like(vals_flat)
    vals[:kept.numel()] = kept
    return (torch.tensor(kept.numel(), dtype=torch.int32,
                         device=vals.device), vals)


def merge_vals(counts: torch.Tensor, vals_t: torch.Tensor) -> torch.Tensor:
    """Concatenate the units' vals prefixes into one flat uint8 stream of
    ``n_units * unit_bytes`` entries, zero past ``pos`` — JAX
    ``merge_vals`` on its ``[:pos]`` prefix, with a zero tail.

    The merge of the bitmask-only emission, whose indices the landing
    rebuilds from the bits: no index stream is read or written. The blocks
    are zero past each unit's count, so the merge is a compaction of the
    flattened blocks by ``vals != 0`` (:func:`vals_compact`, one K3 launch
    at any unit count: both JAX branches, serial and two-stage). ``counts``
    is checked for shape only."""
    if vals_t.dim() != 2:
        raise ValueError("vals_t must be (n_units, unit_bytes)")
    if counts.shape != vals_t.shape[:1]:
        raise ValueError("counts must have one entry per unit")
    return vals_compact(vals_t.reshape(-1))[1]
