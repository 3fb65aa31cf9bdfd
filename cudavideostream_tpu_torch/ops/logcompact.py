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
* :func:`fused_diff_compact_batched` — ``fused_diff_compact_batched``,
  the tiled emission of B independent streams in one launch (the TPU
  kernel's ``stream_tiles`` super-frame mode), element (K1) or segment
  (K5) scheme;
* :func:`pair_compact` — ``_kernel_pair``: a stable compaction of
  ``(xs, vals)`` pairs by ``vals != 0``, emitted flat;
* :func:`merge_tiles` — ``merge_tiles``, through :func:`pair_compact`;
* :func:`vals_compact` — ``_kernel_vals``: the same compaction of a
  ``vals`` stream alone, emitted flat;
* :func:`merge_vals` — ``merge_vals``, through :func:`vals_compact`;
* :func:`segment_compact` — ``_kernel`` (K5), the "segment" scheme: the
  same bytes as K1 at whole-tile units, an independent derivation that
  ``scheme="segment"`` selects in the flat and tiled entry points
  (``scheme="register"`` selects K6, ``ops.register_compact``).

Every K1 entry point and K5 take ``threshold_map``, a per-byte uint8 map
that replaces the scalar threshold (the JAX ``thr_is_map``). The flat and
the solo tiled K1 entry points take ``index_offset`` (the JAX
``has_offset``), an int added to every valid emitted index, which lets a
launch on one row shard of a frame emit global frame indices
(``parallel.sharded``).

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/logcompact.cu``, ``csrc/pair_compact.cu``,
``csrc/segment_compact.cu``) and adds one to its
``launches`` count; on a CPU tensor it runs its plain PyTorch version
(``*_reference``). There is no other route: a CUDA tensor either reaches
the kernel or the call raises.

Contract (``logcompact.py:829-831`` of the JAX package): for every byte
``i`` with ``c = overlay_region[i] if i < len(overlay_region) else
current[i]``, byte ``i`` ships iff ``|c - previous[i]| > threshold``
(``> threshold_map[i]`` with a map);
``xs`` holds the shipped indices ascending, ``vals`` the deltas
``(c - prev) & 255``, both zero past ``pos``; ``new_prev = shipped ? c :
prev`` under negative feedback, else ``c``.

Unlike the JAX function, which returns a new array, ``new_prev`` is
written into ``previous`` IN PLACE (the counterpart of the JAX pipeline's
buffer donation) and returned: callers that still need the old bytes pass
a copy. The kernels store a 16-byte vector of it only where its bytes
change (``csrc/logcompact.cu``, PREV STORES); every K1 entry point and
its plain version take ``prev_stores``, a one-element int64 tensor on the
frame's device to which the call adds the vectors stored
(:func:`add_prev_stores`). No caller on a served or timed path passes
it: without it the kernels count nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cudavideostream_tpu_torch.kernels import launch
from cudavideostream_tpu_torch.kernels.launch import I, LL, OUT, P
from cudavideostream_tpu_torch.ops import diff as diff_ops

# One tile of the tiled, mask and batched K1 kernels: 256 threads x 16
# bytes. K1's flat emission, K2 and K3 take larger tiles (their libraries
# say how large: ``cvs_flat_tile_bytes``, ``cvs_pair_tile``,
# ``cvs_vals_tile``).
TILE_BYTES = 4096

# The JAX package's tile geometry (``logcompact.py:73-128``), copied: the
# tiled emission's unit count and unit size follow from it, and they
# must be the JAX package's for the tiled outputs to be the same arrays.
LANES = 128
GEOMETRY_MAX_GRID = 2000

SOURCE = launch.Source("logcompact", {
    "cvs_fused_diff_compact": [I, P, P, P, LL, LL, I, P, I, I, I, P, P, P, LL,
                               P, P, P],
    "cvs_flat_blocks": [I, I, OUT],
    "cvs_flat_tile_bytes": [],
    "cvs_tiled_wave": [I, OUT],
    "cvs_tiled_chunks": [LL, I],
    "cvs_fused_diff_compact_tiled": [I, P, P, P, LL, LL, LL, I, I, P, I, I,
                                     I, I, P, P, P, I, P, P, P, P, P, P],
}, {"cvs_tile_bytes": TILE_BYTES})
PAIR_SOURCE = launch.Source("pair_compact", {
    "cvs_pair_compact": [I, P, P, LL, I, P, P, P, P, P],
    "cvs_pair_blocks": [I, OUT],
    "cvs_pair_tile": [],
    "cvs_vals_compact": [I, P, LL, I, P, P, P, P],
    "cvs_vals_blocks": [I, OUT],
    "cvs_vals_tile": [],
}, {"cvs_tile_bytes": TILE_BYTES})
SEGMENT_SOURCE = launch.Source("segment_compact", {
    "cvs_segment_compact": [I, P, P, P, LL, LL, I, P, I, I, I, I, P, P, P, P],
    "cvs_segment_plan": [I, OUT, OUT, OUT, OUT],
})


# -- the one-pass compactions (K1 flat, K2, K3): launch plan and scratch ---

class FlatPlan(NamedTuple):
    """The launch of a one-pass compaction (``csrc/lookback.cuh``) over
    ``n`` entries in tiles of ``tile`` entries."""
    tiles: int          # tile t holds entries [t * tile, (t + 1) * tile) of [0, n)
    grid: int           # blocks launched: the persistent grid, at most one a tile
    scratch_words: int  # 8-byte words: the ticket, the count done, a status a tile


def flat_plan(n: int, cap: int, blocks: int, tile: int) -> FlatPlan:
    """The plan of a one-pass compaction of ``n`` entries into ``cap``
    output slots, on a card whose persistent grid is ``blocks`` blocks
    (occupancy x SMs). Blocks take tiles while there are any; each tile
    writes its entries and its band of the zero tail
    (``csrc/lookback.cuh:tail_band``), so no more blocks than tiles are
    launched."""
    if n < 1 or not 0 <= cap <= n or blocks < 1 or tile < 1:
        raise ValueError(f"no plan for n={n}, cap={cap}, blocks={blocks}, "
                         f"tile={tile}")
    tiles = -(-n // tile)
    return FlatPlan(tiles, min(blocks, tiles), 2 + tiles)


def flat_scratch(device: torch.device, stream: int,
                 words: int) -> torch.Tensor:
    """The scratch (``launch.scratch``) of the one-pass compactions
    launched on ``stream`` of ``device``, and of K1's tiled emission (its
    streams' ``pos`` words, ``csrc/logcompact.cu:add_stream_total``): at
    least ``words`` int64 words, and at least 1024, so K1's launches and
    K2's or K3's on one stream share it without growing it. Launches that
    can overlap (K1 on the compute stream, K2 or K3 on a landing stream)
    run on different streams and never share it."""
    return launch.scratch("lookback", device, stream, max(words, 1024),
                          torch.int64)


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

def _check_args(current, previous, threshold, overlay_region,
                threshold_map=None):
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
    if threshold_map is not None:
        if (not isinstance(threshold_map, torch.Tensor)
                or threshold_map.dtype != torch.uint8
                or threshold_map.dim() != 1
                or not threshold_map.is_contiguous()):
            raise ValueError("threshold_map must be a contiguous 1-D uint8 "
                             "tensor")
        if threshold_map.numel() != n:
            raise ValueError("threshold_map length must equal the frame's")
        if threshold_map.device != current.device:
            raise ValueError("threshold_map must be on the frame's device")


def _check_kernel_args(name, current, previous, overlay_region,
                       threshold_map=None):
    """The device checks of a launch that reads the frame (K1, K5);
    returns the region's length."""
    dev = current.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if current.data_ptr() == previous.data_ptr():
        raise ValueError("current and previous must not share storage")
    region_len = 0 if overlay_region is None else overlay_region.numel()
    for t in ((current, previous)
              + ((overlay_region,) if region_len else ())
              + ((threshold_map,) if threshold_map is not None else ())):
        if t.data_ptr() % 16:
            raise ValueError("the kernel reads 16-byte vectors: frame "
                             "buffers must be 16-byte aligned")
    return region_len


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _thr(threshold, threshold_map):
    """The threshold a plain version compares with: the map or the int."""
    return threshold if threshold_map is None else threshold_map


SCHEMES = ("element", "segment", "register")


def _check_scheme(scheme, overlay_region, threshold_map, emit_bits=False):
    """The JAX package's refusals (``logcompact.py:660-675``)."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}: one of {SCHEMES}")
    if scheme != "element" and emit_bits:
        raise ValueError("emit_xs=False / emit_bits: element scheme only")
    if scheme == "register" and (
            threshold_map is not None
            or (overlay_region is not None and overlay_region.numel())):
        raise ValueError("overlay fusion / threshold maps / batching: "
                         "element/segment schemes only")


def _check_offset(index_offset, scheme, n_pad) -> int:
    """The index offset as an int; refuses another scheme than
    ``"element"`` as the JAX package does (``logcompact.py:696-697``), and
    an offset that would carry an index past int32 (where the JAX package
    would wrap)."""
    off = int(index_offset)
    if off and scheme != "element":
        raise ValueError("index_offset: element scheme only")
    if off < 0:
        raise ValueError("index_offset must be >= 0")
    if off + n_pad >= 1 << 31:
        raise ValueError(f"index_offset {off} + {n_pad} padded frame bytes "
                         "exceed int32")
    return off


def _check_stores(prev_stores, current, scheme="element"):
    """Refuses a ``prev_stores`` that is not None or a one-element int64
    tensor on the frame's device, and one given to another scheme than
    ``"element"`` (K5 and K6 store every vector and count nothing)."""
    if prev_stores is None:
        return
    if (not isinstance(prev_stores, torch.Tensor)
            or prev_stores.dtype != torch.int64 or prev_stores.numel() != 1):
        raise ValueError("prev_stores must be a one-element int64 tensor")
    if prev_stores.device != current.device:
        raise ValueError("prev_stores must be on the frame's device")
    if scheme != "element":
        raise ValueError("prev_stores: element scheme only")


def add_prev_stores(prev_stores, previous, new_prev) -> None:
    """Adds to ``prev_stores`` (when not None) the 16-byte vectors of one
    stream's ``previous``, counted from its first byte (a ragged end's
    partial vector is one), in which ``new_prev`` differs: the vectors the
    kernel stores. The plain versions call it before they write
    ``new_prev``."""
    if prev_stores is None:
        return
    changed = new_prev != previous
    pad = -changed.numel() % 16
    if pad:
        changed = torch.cat([changed, changed.new_zeros(pad)])
    prev_stores += changed.view(-1, 16).any(dim=1).sum()


def _whole_tile_blocks(scheme, current, previous, threshold,
                       negative_feedback, overlay_region, threshold_map):
    """``(counts int32, xs_t, vals_t)`` of the segment (K5) or register
    (K6) scheme, whose units are whole tiles; ``previous`` is updated in
    place."""
    if scheme == "segment":
        return segment_compact(current, previous, threshold,
                               negative_feedback, overlay_region,
                               threshold_map)[:3]
    from cudavideostream_tpu_torch.ops import register_compact as reg_ops

    return reg_ops.register_compact(current, previous, threshold,
                                    negative_feedback)[:3]


def fused_diff_compact(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: int = 20,
    negative_feedback: bool = True,
    overlay_region: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
    threshold_map: Optional[torch.Tensor] = None,
    scheme: str = "element",
    index_offset: int = 0,
    prev_stores: Optional[torch.Tensor] = None,
):
    """Flat-emit diff+compact; returns ``(pos, xs, vals, new_prev)``.

    ``pos`` is a 0-d int32 tensor (the true count, which may exceed
    ``capacity``); ``xs`` int32 and ``vals`` uint8 have
    ``min(capacity, n)`` entries (``n`` when ``capacity`` is None), zero
    past ``pos``; ``new_prev`` is ``previous``, updated in place.

    ``overlay_region``: a prefix of the frame with the text strip already
    blended; it replaces ``current`` on its bytes, so diff, negative
    feedback and payload all see the overlaid frame.

    ``threshold_map``: a per-byte uint8 map of the frame's length; byte
    ``i`` ships iff ``|df_i| > threshold_map[i]``. It overrides
    ``threshold``.

    ``scheme``: ``"element"`` (K1, the default), or one of the two
    independently derived cross-checks at whole-tile units, ``"segment"``
    (K5, :func:`segment_compact`; takes the region and the map) and
    ``"register"`` (K6, ``ops.register_compact``; neither), whose blocks
    :func:`merge_tiles` (K2) concatenates. All three give the same bytes.

    ``index_offset``: added to every valid index (``xs[:pos]``; the zeros
    past ``pos`` stay 0), so that a launch on row shard ``s`` of a frame,
    given ``s * shard_bytes``, emits global frame indices. Element scheme
    only; ``index_offset + n_pad`` must stay below 2**31, ``n_pad`` the
    frame padded to whole tiles (:func:`tiled_geometry`).

    ``prev_stores``: None, or a one-element int64 tensor on the frame's
    device to which the call adds the 16-byte vectors of ``previous`` it
    stored, those whose bytes change (:func:`add_prev_stores`). Element
    scheme only.

    CUDA tensors launch the kernel (and count one in
    ``fused_diff_compact.launches``); CPU tensors run
    :func:`fused_diff_compact_reference`.
    """
    _check_args(current, previous, threshold, overlay_region, threshold_map)
    _check_scheme(scheme, overlay_region, threshold_map)
    _check_stores(prev_stores, current, scheme)
    n = current.numel()
    off = _check_offset(index_offset, scheme, tiled_geometry(n, 0)[0])
    cap = n if capacity is None else min(int(capacity), n)
    if scheme != "element":
        counts, xs_t, vals_t = _whole_tile_blocks(
            scheme, current, previous, threshold, negative_feedback,
            overlay_region, threshold_map)
        xs, vals = merge_tiles(counts, xs_t, vals_t)
        return counts.sum(dtype=torch.int32), xs[:cap], vals[:cap], previous
    dev = current.device
    if dev.type == "cpu":
        return fused_diff_compact_reference(
            current, previous, threshold, negative_feedback, overlay_region,
            capacity, threshold_map, off, prev_stores,
        )
    region_len = _check_kernel_args("fused_diff_compact", current, previous,
                                    overlay_region, threshold_map)
    region_ptr = overlay_region.data_ptr() if region_len else None
    lib = launch.library(SOURCE)
    idx = launch.device_index(dev)
    (blocks,) = launch.query(lib, "cvs_flat_blocks", idx, 1,
                             int(threshold_map is not None))
    plan = flat_plan(n, cap, blocks, lib.cvs_flat_tile_bytes())
    xs = torch.empty(cap, dtype=torch.int32, device=dev)
    vals = torch.empty(cap, dtype=torch.uint8, device=dev)
    pos = torch.empty((), dtype=torch.int32, device=dev)
    stream = launch.stream_handle(dev)
    scratch = flat_scratch(dev, stream, plan.scratch_words)
    rc = lib.cvs_fused_diff_compact(
        idx,
        current.data_ptr(), previous.data_ptr(), region_ptr, region_len, n,
        int(threshold), _ptr(threshold_map), int(bool(negative_feedback)),
        off, plan.grid, scratch.data_ptr(), xs.data_ptr(), vals.data_ptr(),
        cap, pos.data_ptr(), _ptr(prev_stores), stream,
    )
    launch.raise_on(rc, lib, "fused_diff_compact")
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
    threshold_map: Optional[torch.Tensor] = None,
    index_offset: int = 0,
    prev_stores: Optional[torch.Tensor] = None,
):
    """The plain PyTorch version of :func:`fused_diff_compact`: the same
    outputs from ``diff_mask``, ``nonzero`` and ``masked_select``, with
    ``new_prev`` written into ``previous`` in place. ``nonzero`` makes it
    synchronize with the device on CUDA tensors."""
    _check_args(current, previous, threshold, overlay_region, threshold_map)
    _check_stores(prev_stores, current)
    n = current.numel()
    off = _check_offset(index_offset, "element", tiled_geometry(n, 0)[0])
    cur = diff_ops.region_frame(current, overlay_region)
    mask, dvals, new_prev = diff_ops.diff_mask(
        cur, previous, _thr(threshold, threshold_map), negative_feedback
    )
    idx = torch.nonzero(mask).flatten()  # ascending
    shipped = torch.masked_select(dvals, mask)
    cap = n if capacity is None else min(int(capacity), n)
    k = min(idx.numel(), cap)
    xs = torch.zeros(cap, dtype=torch.int32, device=current.device)
    vals = torch.zeros(cap, dtype=torch.uint8, device=current.device)
    xs[:k] = (idx[:k] + off).to(torch.int32)
    vals[:k] = shipped[:k]
    add_prev_stores(prev_stores, previous, new_prev)
    previous.copy_(new_prev)  # in place, as the kernel does
    pos = torch.tensor(idx.numel(), dtype=torch.int32, device=current.device)
    return pos, xs, vals, previous


def _launch_tiled(name, current, previous, threshold, negative_feedback,
                  overlay_region, threshold_map, n_pad, unit_bytes, emit_xs,
                  emit_bits, n_streams=None, index_offset=0,
                  prev_stores=None):
    """One launch of the tiled K1 entry point; returns ``(pos, counts,
    xs_t or None, vals_t, bits or None)``. ``index_offset``: a checked int
    (:func:`_check_offset`), 0 in the batched mode. ``prev_stores``: a
    checked counter (:func:`_check_stores`) or None. ``n_streams``: None
    for one frame (``pos`` 0-d), else the batched mode over that many
    frames of ``current.numel() / n_streams`` bytes (``pos`` one int32 per
    stream, the blocks of stream ``b`` from unit ``b * n_pad /
    unit_bytes``, ``overlay_region`` one strip per stream)."""
    region_len = _check_kernel_args(name, current, previous, overlay_region,
                                    threshold_map)
    b = n_streams or 1
    region_len //= b
    region_ptr = overlay_region.data_ptr() if region_len else None
    lib = launch.library(SOURCE)
    dev = current.device
    n_units = b * n_pad // unit_bytes
    xs_t = (torch.empty((n_units, unit_bytes), dtype=torch.int32, device=dev)
            if emit_xs else None)
    vals_t = torch.empty((n_units, unit_bytes), dtype=torch.uint8, device=dev)
    bits = (torch.empty(b * n_pad // 8, dtype=torch.uint8, device=dev)
            if emit_bits else None)
    counts = torch.empty(n_units, dtype=counts_dtype(unit_bytes), device=dev)
    # chunk counts: only units larger than a tile (the two-kernel path)
    chunks = lib.cvs_tiled_chunks(n_pad, unit_bytes)
    chunk_counts = (torch.empty(b * chunks, dtype=torch.int32, device=dev)
                    if chunks else None)
    pos = torch.empty(() if n_streams is None else (b,), dtype=torch.int32,
                      device=dev)
    stream = launch.stream_handle(dev)
    sums = flat_scratch(dev, stream, b)  # one pos word per stream
    rc = lib.cvs_fused_diff_compact_tiled(
        launch.device_index(dev),
        current.data_ptr(), previous.data_ptr(), region_ptr, region_len,
        current.numel() // b, n_pad, b, int(threshold), _ptr(threshold_map),
        int(bool(negative_feedback)), index_offset,
        unit_bytes, counts.element_size(), sums.data_ptr(),
        _ptr(chunk_counts), counts.data_ptr(), int(emit_xs),
        None if xs_t is None else xs_t.data_ptr(), vals_t.data_ptr(),
        None if bits is None else bits.data_ptr(), pos.data_ptr(),
        _ptr(prev_stores), stream,
    )
    launch.raise_on(rc, lib, name)
    return pos, counts, xs_t, vals_t, bits


def _tiled_plain(current, previous, threshold, negative_feedback,
                 overlay_region, threshold_map, n_pad, unit_bytes, emit_xs,
                 emit_bits, index_offset=0, prev_stores=None):
    """The plain PyTorch version of :func:`_launch_tiled` on one stream:
    the mask from ``diff_mask``, each entry's rank in its unit from a
    per-unit ``cumsum``, one scatter into zeroed blocks, and
    ``pack_bitmask``; ``new_prev`` is written into ``previous`` in place,
    its changed vectors counted into ``prev_stores``."""
    dev = current.device
    n = current.numel()
    n_units = n_pad // unit_bytes
    cur = diff_ops.region_frame(current, overlay_region)
    mask, dvals, new_prev = diff_ops.diff_mask(
        cur, previous, _thr(threshold, threshold_map), negative_feedback
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
        xs_t[slot] = (torch.nonzero(m).flatten() + index_offset).to(
            torch.int32)
        xs_t = xs_t.view(n_units, unit_bytes)
    vals_t = torch.zeros(n_pad, dtype=torch.uint8, device=dev)
    vals_t[slot] = dvals[mask]
    bits = diff_ops.pack_bitmask(m) if emit_bits else None
    add_prev_stores(prev_stores, previous, new_prev)
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
    threshold_map: Optional[torch.Tensor] = None,
    scheme: str = "element",
    index_offset: int = 0,
    prev_stores: Optional[torch.Tensor] = None,
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

    ``threshold_map`` and ``scheme`` as for :func:`fused_diff_compact`. A
    ``"segment"`` or ``"register"`` scheme compacts whole tiles whatever
    ``sub_rows`` says (the JAX package zeroes it for them,
    ``logcompact.py:894-903``): its outputs are those of ``sub_rows=0``.

    ``index_offset`` as for :func:`fused_diff_compact`: added to every
    valid index of ``xs_t``, the zero fill left 0. ``prev_stores`` as for
    :func:`fused_diff_compact`.

    CUDA tensors launch the kernel (and count one in
    ``fused_diff_compact_tiled.launches``); CPU tensors run
    :func:`fused_diff_compact_tiled_reference`.
    """
    _check_args(current, previous, threshold, overlay_region, threshold_map)
    _check_scheme(scheme, overlay_region, threshold_map, emit_bits)
    _check_stores(prev_stores, current, scheme)
    n_pad, unit_bytes = tiled_geometry(current.numel(), sub_rows)
    off = _check_offset(index_offset, scheme, n_pad)
    if scheme != "element":
        counts, xs_t, vals_t = _whole_tile_blocks(
            scheme, current, previous, threshold, negative_feedback,
            overlay_region, threshold_map)
        return (counts.sum(dtype=torch.int32),
                counts.to(counts_dtype(xs_t.shape[1])), xs_t, vals_t,
                previous)
    if current.device.type == "cpu":
        return fused_diff_compact_tiled_reference(
            current, previous, threshold, negative_feedback, overlay_region,
            sub_rows, emit_bits, threshold_map, off, prev_stores,
        )
    out = _launch_tiled("fused_diff_compact_tiled", current, previous,
                        threshold, negative_feedback, overlay_region,
                        threshold_map, n_pad, unit_bytes, True, emit_bits,
                        index_offset=off, prev_stores=prev_stores)
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
    threshold_map: Optional[torch.Tensor] = None,
    index_offset: int = 0,
    prev_stores: Optional[torch.Tensor] = None,
):
    """The plain PyTorch version of :func:`fused_diff_compact_tiled`: the
    mask from ``diff_mask``, each entry's rank in its unit from a
    per-unit ``cumsum``, one scatter into zeroed blocks."""
    _check_args(current, previous, threshold, overlay_region, threshold_map)
    _check_stores(prev_stores, current)
    n_pad, unit_bytes = tiled_geometry(current.numel(), sub_rows)
    off = _check_offset(index_offset, "element", n_pad)
    out = _tiled_plain(current, previous, threshold, negative_feedback,
                       overlay_region, threshold_map, n_pad, unit_bytes,
                       True, emit_bits, off, prev_stores)
    return _tiled_result(out, previous, emit_bits)


def fused_diff_compact_mask(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: int = 20,
    negative_feedback: bool = True,
    overlay_region: Optional[torch.Tensor] = None,
    sub_rows: int = 0,
    threshold_map: Optional[torch.Tensor] = None,
    scheme: str = "element",
    prev_stores: Optional[torch.Tensor] = None,
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
    ``previous``, updated in place. ``threshold_map`` as for
    :func:`fused_diff_compact`; the emission exists for the element
    scheme only, and another ``scheme`` raises as in the JAX package.
    ``prev_stores`` as for :func:`fused_diff_compact`.

    CUDA tensors launch the kernel (and count one in
    ``fused_diff_compact_mask.launches``); CPU tensors run
    :func:`fused_diff_compact_mask_reference`.
    """
    _check_args(current, previous, threshold, overlay_region, threshold_map)
    _check_scheme(scheme, overlay_region, threshold_map, emit_bits=True)
    _check_stores(prev_stores, current)
    if current.device.type == "cpu":
        return fused_diff_compact_mask_reference(
            current, previous, threshold, negative_feedback, overlay_region,
            sub_rows, threshold_map, prev_stores,
        )
    n_pad, unit_bytes = tiled_geometry_mask(current.numel(), sub_rows)
    pos, counts, _, vals_t, bits = _launch_tiled(
        "fused_diff_compact_mask", current, previous, threshold,
        negative_feedback, overlay_region, threshold_map, n_pad, unit_bytes,
        False, True, prev_stores=prev_stores)
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
    threshold_map: Optional[torch.Tensor] = None,
    prev_stores: Optional[torch.Tensor] = None,
):
    """The plain PyTorch version of :func:`fused_diff_compact_mask`."""
    _check_args(current, previous, threshold, overlay_region, threshold_map)
    _check_stores(prev_stores, current)
    n_pad, unit_bytes = tiled_geometry_mask(current.numel(), sub_rows)
    pos, counts, _, vals_t, bits = _tiled_plain(
        current, previous, threshold, negative_feedback, overlay_region,
        threshold_map, n_pad, unit_bytes, False, True,
        prev_stores=prev_stores)
    return pos, counts, vals_t, bits, previous


# -- K1 and K5, batched ----------------------------------------------------

def _check_batched_args(current, previous, n_streams, threshold, scheme,
                        overlay_region, threshold_map):
    """The checks of a batched call, in the JAX package's order
    (``logcompact.py:1035-1046, 1075-1078``); returns ``n``, the bytes of
    one stream's frame."""
    if int(n_streams) < 1:
        raise ValueError("need at least one stream")
    for name, t in (("current", current), ("previous", previous)):
        if t.dim() != 1 or t.numel() % n_streams:
            raise ValueError("expect flat (B*n,) frames")
        if t.dtype != torch.uint8 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D uint8 tensor")
    if current.device != previous.device:
        raise ValueError("current and previous must be on one device")
    if previous.numel() != current.numel() or current.numel() == 0:
        raise ValueError("current and previous must have one nonzero length")
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}: one of {SCHEMES}")
    if scheme == "register":
        raise ValueError("overlay fusion / threshold maps / batching: "
                         "element/segment schemes only")
    n = current.numel() // n_streams
    if not 0 <= int(threshold) <= 255:
        raise ValueError("threshold must be in [0, 255]")
    if threshold_map is not None:
        if (not isinstance(threshold_map, torch.Tensor)
                or threshold_map.dtype != torch.uint8
                or threshold_map.dim() != 1
                or not threshold_map.is_contiguous()):
            raise ValueError("threshold_map must be a contiguous 1-D uint8 "
                             "tensor")
        if threshold_map.numel() != n:
            raise ValueError("threshold_map length must equal the frame's")
        if threshold_map.device != current.device:
            raise ValueError("threshold_map must be on the frame's device")
    if overlay_region is not None:
        if (overlay_region.dtype != torch.uint8 or overlay_region.dim() != 1
                or not overlay_region.is_contiguous()
                or overlay_region.numel() % n_streams):
            raise ValueError("overlay_region must be a contiguous 1-D uint8 "
                             "tensor of one strip per stream")
        if overlay_region.device != current.device:
            raise ValueError("overlay_region must be on the frame's device")
        if overlay_region.numel() // n_streams > n:
            raise ValueError("overlay_region is longer than the frame")
    return n


def batched_geometry(n: int, scheme: str = "element",
                     sub_rows: int = 0) -> Tuple[int, int]:
    """``(n_pad, unit_bytes)`` of each stream of a batched call on
    ``n``-byte frames: the solo tiled geometry, whole tiles for a scheme
    other than ``"element"`` (``logcompact.py:1039-1046``)."""
    return tiled_geometry(n, sub_rows if scheme == "element" else 0)


def fused_diff_compact_batched(
    current: torch.Tensor,
    previous: torch.Tensor,
    n_streams: int,
    threshold: int = 20,
    negative_feedback: bool = True,
    scheme: str = "element",
    threshold_map: Optional[torch.Tensor] = None,
    skip_static: bool = True,
    sub_rows: int = 0,
    pair: bool = False,
    overlay_region: Optional[torch.Tensor] = None,
    prev_stores: Optional[torch.Tensor] = None,
):
    """Tiled diff+compact of ``n_streams`` independent streams in one
    launch; returns ``(pos (B,), counts (B, U), xs_t (B, U, unit_bytes),
    vals_t (B, U, unit_bytes), new_prev (B*n,))`` as the JAX
    ``fused_diff_compact_batched`` does.

    ``current`` and ``previous`` are flat ``(B * n,)`` uint8, stream ``b``
    at ``[b * n, (b + 1) * n)``. Stream ``b``'s outputs equal a solo
    :func:`fused_diff_compact_tiled` of its frame (same ``sub_rows``, same
    map): ``pos[b]`` int32, ``counts[b]`` narrowed (:func:`counts_dtype`),
    indices stream-local, blocks zero past each count. ``new_prev`` is
    ``previous``, updated in place.

    ``threshold_map``: one ``(n,)`` map shared by every stream.
    ``scheme``: ``"element"`` (K1) or ``"segment"`` (K5, whole-tile units
    whatever ``sub_rows`` says); ``"register"`` refuses batching, as in the
    JAX package. ``skip_static`` and ``pair`` are TPU fast paths and lane
    layouts with identical outputs: accepted and ignored.

    ``overlay_region``: an optional flat ``(B * L,)`` tensor of one
    ``L``-byte strip per stream, which replaces the first ``L`` bytes of
    that stream's ``current``. The JAX function has no region (a Mosaic
    DMA limit; its caller substitutes the strips with one pass over the
    super-frame); here the kernel reads strip ``b`` for stream ``b``, which
    saves that pass.

    ``prev_stores`` as for :func:`fused_diff_compact`, summed over the
    streams, each stream's vectors counted from its own first byte.
    Element scheme only.

    CUDA tensors launch the kernel once for every stream (and count one in
    ``fused_diff_compact_batched.launches``, or in
    ``segment_compact.launches`` for the segment scheme); CPU tensors run
    :func:`fused_diff_compact_batched_reference`.
    """
    n = _check_batched_args(current, previous, n_streams, threshold, scheme,
                            overlay_region, threshold_map)
    _check_stores(prev_stores, current, scheme)
    if current.device.type == "cpu":
        return fused_diff_compact_batched_reference(
            current, previous, n_streams, threshold, negative_feedback,
            scheme, threshold_map, skip_static, sub_rows, pair,
            overlay_region, prev_stores)
    n_pad, unit_bytes = batched_geometry(n, scheme, sub_rows)
    b = int(n_streams)
    ups = n_pad // unit_bytes
    if scheme == "segment":
        counts, xs_t, vals_t, _ = _launch_segment(
            current, previous, threshold, negative_feedback, overlay_region,
            threshold_map, b)
        counts = counts.view(b, ups)
        pos = counts.sum(dim=1, dtype=torch.int32)
        counts = counts.to(counts_dtype(unit_bytes))
    else:
        pos, counts, xs_t, vals_t, _ = _launch_tiled(
            "fused_diff_compact_batched", current, previous, threshold,
            negative_feedback, overlay_region, threshold_map, n_pad,
            unit_bytes, True, False, n_streams=b, prev_stores=prev_stores)
        fused_diff_compact_batched.launches += 1
    return (pos, counts.view(b, ups), xs_t.view(b, ups, unit_bytes),
            vals_t.view(b, ups, unit_bytes), previous)


fused_diff_compact_batched.launches = 0


def fused_diff_compact_batched_reference(
    current: torch.Tensor,
    previous: torch.Tensor,
    n_streams: int,
    threshold: int = 20,
    negative_feedback: bool = True,
    scheme: str = "element",
    threshold_map: Optional[torch.Tensor] = None,
    skip_static: bool = True,
    sub_rows: int = 0,
    pair: bool = False,
    overlay_region: Optional[torch.Tensor] = None,
    prev_stores: Optional[torch.Tensor] = None,
):
    """The plain PyTorch version of :func:`fused_diff_compact_batched`:
    each stream through the plain version of its solo scheme, on views of
    the flat buffers (``new_prev`` lands in ``previous`` in place, its
    changed vectors counted stream by stream), the outputs stacked."""
    n = _check_batched_args(current, previous, n_streams, threshold, scheme,
                            overlay_region, threshold_map)
    _check_stores(prev_stores, current, scheme)
    n_pad, unit_bytes = batched_geometry(n, scheme, sub_rows)
    b_count = int(n_streams)
    strip = 0 if overlay_region is None else overlay_region.numel() // b_count
    outs = []
    for b in range(b_count):
        cur_b = current[b * n:(b + 1) * n]
        prev_b = previous[b * n:(b + 1) * n]
        reg_b = (None if overlay_region is None
                 else overlay_region[b * strip:(b + 1) * strip])
        if scheme == "segment":
            counts, xs_t, vals_t, _ = segment_compact_reference(
                cur_b, prev_b, threshold, negative_feedback, reg_b,
                threshold_map)
            outs.append((counts.sum(dtype=torch.int32),
                         counts.to(counts_dtype(unit_bytes)), xs_t, vals_t))
        else:
            outs.append(_tiled_plain(
                cur_b, prev_b, threshold, negative_feedback, reg_b,
                threshold_map, n_pad, unit_bytes, True, False,
                prev_stores=prev_stores)[:4])
    return tuple(torch.stack(parts) for parts in zip(*outs)) + (previous,)


# -- K5 -------------------------------------------------------------------

def cluster_plan(lib, fn: str, device: torch.device) -> dict:
    """The shape of a cluster launch (K5's, K6's) on ``device`` (a CUDA
    device), from ``lib``'s ``fn``: CTAs per cluster (one cluster a tile),
    threads per CTA, dynamic shared memory per CTA in bytes, and
    ``active_clusters``, the clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``; 0 would mean no launch could
    run). Asked once per device (``launch.query``); raises where the card
    refuses the question."""
    return dict(zip(("cluster", "threads", "smem", "active_clusters"),
                    launch.query(lib, fn, launch.device_index(device), 4)))


def segment_plan(device: torch.device) -> dict:
    """K5's launch shape on ``device`` (:func:`cluster_plan`)."""
    return cluster_plan(launch.library(SEGMENT_SOURCE), "cvs_segment_plan",
                        device)


def segment_compact(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: int = 20,
    negative_feedback: bool = True,
    overlay_region: Optional[torch.Tensor] = None,
    threshold_map: Optional[torch.Tensor] = None,
):
    """The segment scheme (K5): the diff of K1 compacted at whole-tile
    units by segment merging; returns ``(counts, xs_t, vals_t,
    new_prev)``, ``counts`` one int32 per tile and the blocks ``(n_units,
    unit_bytes)`` at :func:`tiled_geometry` with ``sub_rows=0`` (98 tiles
    of 63,488 B at 1080p), zero past each count; ``new_prev`` is
    ``previous``, updated in place.

    The port of ``_kernel`` (``logcompact.py:537``), an independent
    derivation that shares no code with K1 or K6: one thread-block
    cluster a tile, each CTA a band of its leaves (:func:`segment_plan`
    gives the launch's shape). CUDA tensors launch
    ``csrc/segment_compact.cu`` (and count one in
    ``segment_compact.launches``); CPU tensors run
    :func:`segment_compact_reference`.
    """
    _check_args(current, previous, threshold, overlay_region, threshold_map)
    dev = current.device
    if dev.type == "cpu":
        return segment_compact_reference(current, previous, threshold,
                                         negative_feedback, overlay_region,
                                         threshold_map)
    return _launch_segment(current, previous, threshold, negative_feedback,
                           overlay_region, threshold_map, 1)


def _launch_segment(current, previous, threshold, negative_feedback,
                    overlay_region, threshold_map, n_streams):
    """One K5 launch over ``n_streams`` frames of ``current.numel() /
    n_streams`` bytes (the batched mode past 1, ``overlay_region`` one
    strip per stream); returns ``(counts int32, xs_t, vals_t, previous)``,
    the tiles of stream ``b`` from ``b * units_per_stream``. Counts one in
    ``segment_compact.launches``."""
    dev = current.device
    region_len = _check_kernel_args("segment_compact", current, previous,
                                    overlay_region, threshold_map)
    region_len //= n_streams
    lib = launch.library(SEGMENT_SOURCE)
    n = current.numel() // n_streams
    n_pad, unit_bytes = tiled_geometry(n, 0)
    ups = n_pad // unit_bytes
    n_units = n_streams * ups
    counts = torch.empty(n_units, dtype=torch.int32, device=dev)
    xs_t = torch.empty((n_units, unit_bytes), dtype=torch.int32, device=dev)
    vals_t = torch.empty((n_units, unit_bytes), dtype=torch.uint8,
                         device=dev)
    rc = lib.cvs_segment_compact(
        launch.device_index(dev), current.data_ptr(), previous.data_ptr(),
        overlay_region.data_ptr() if region_len else None, region_len,
        n, int(threshold), _ptr(threshold_map),
        int(bool(negative_feedback)), unit_bytes, ups, n_streams,
        counts.data_ptr(), xs_t.data_ptr(), vals_t.data_ptr(),
        launch.stream_handle(dev),
    )
    launch.raise_on(rc, lib, "segment_compact")
    segment_compact.launches += 1
    return counts, xs_t, vals_t, previous


segment_compact.launches = 0


def segment_compact_reference(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: int = 20,
    negative_feedback: bool = True,
    overlay_region: Optional[torch.Tensor] = None,
    threshold_map: Optional[torch.Tensor] = None,
):
    """The plain PyTorch version of :func:`segment_compact`, by the TPU
    kernel's own scheme: every byte starts as a segment of width 1; at
    each level ``W = 1, 2, 4, ...`` two sibling segments merge, the right
    one's compacted prefix sliding left by ``W - c_L`` over the left one's
    holes (a gather), vectorized over the tiles. Each entry is packed as
    ``index * 256 + delta``, never 0 (a shipped delta is not 0), so the
    empty slots are the zeros."""
    _check_args(current, previous, threshold, overlay_region, threshold_map)
    dev = current.device
    n = current.numel()
    n_pad, unit_bytes = tiled_geometry(n, 0)
    n_units = n_pad // unit_bytes
    cur = diff_ops.region_frame(current, overlay_region)
    mask, dvals, new_prev = diff_ops.diff_mask(
        cur, previous, _thr(threshold, threshold_map), negative_feedback)
    width = 1 << (unit_bytes - 1).bit_length()  # tiles padded to 2^k slots
    packed = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    packed[:n] = torch.where(
        mask, torch.arange(n, dtype=torch.int64, device=dev) * 256
        + dvals.to(torch.int64), 0)
    x = torch.zeros((n_units, width), dtype=torch.int64, device=dev)
    x[:, :unit_bytes] = packed.view(n_units, unit_bytes)
    c = (x != 0).to(torch.int64)  # each segment's count
    w = 1
    while w < width:
        seg = x.view(n_units, width // (2 * w), 2, w)
        cs = c.view(n_units, width // (2 * w), 2)
        c_l = cs[:, :, :1]
        src = torch.arange(2 * w, device=dev) - c_l  # slot p takes right[p - c_L]
        ok = (src >= 0) & (src < w)
        merged = torch.gather(seg[:, :, 1], 2, src.clamp(0, w - 1)) * ok
        merged[:, :, :w] += seg[:, :, 0]  # the left is zero past c_L
        x = merged.reshape(n_units, width)
        c = cs.sum(dim=2)
        w *= 2
    x = x[:, :unit_bytes]
    previous.copy_(new_prev)  # in place, as the kernel does
    return (c.view(n_units).to(torch.int32), (x >> 8).to(torch.int32),
            (x & 255).to(torch.uint8), previous)


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
    lib = launch.library(PAIR_SOURCE)
    idx = launch.device_index(dev)
    (blocks,) = launch.query(lib, "cvs_pair_blocks", idx, 1)
    plan = flat_plan(n, n, blocks, lib.cvs_pair_tile())
    xs = torch.empty(n, dtype=torch.int32, device=dev)
    vals = torch.empty(n, dtype=torch.uint8, device=dev)
    pos = torch.empty((), dtype=torch.int32, device=dev)
    stream = launch.stream_handle(dev)
    scratch = flat_scratch(dev, stream, plan.scratch_words)
    rc = lib.cvs_pair_compact(
        idx, xs_flat.data_ptr(), vals_flat.data_ptr(), n, plan.grid,
        scratch.data_ptr(), xs.data_ptr(), vals.data_ptr(), pos.data_ptr(),
        stream,
    )
    launch.raise_on(rc, lib, "pair_compact")
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
    lib = launch.library(PAIR_SOURCE)
    idx = launch.device_index(dev)
    (blocks,) = launch.query(lib, "cvs_vals_blocks", idx, 1)
    plan = flat_plan(n, n, blocks, lib.cvs_vals_tile())
    vals = torch.empty(n, dtype=torch.uint8, device=dev)
    pos = torch.empty((), dtype=torch.int32, device=dev)
    stream = launch.stream_handle(dev)
    scratch = flat_scratch(dev, stream, plan.scratch_words)
    rc = lib.cvs_vals_compact(
        idx, vals_flat.data_ptr(), n, plan.grid, scratch.data_ptr(),
        vals.data_ptr(), pos.data_ptr(), stream,
    )
    launch.raise_on(rc, lib, "vals_compact")
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
