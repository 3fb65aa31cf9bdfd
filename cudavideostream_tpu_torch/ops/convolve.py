"""The noise filter: a zero-padded KxK convolution per channel in Q16
fixed point (the counterpart of the JAX package's ``ops/convolve.py``
``convolve_q16`` and ``accumulate_q16``), byte-exact against
:func:`reference_cpu.convolve`.

* :func:`convolve_q16` — the wrapper of K8, the hand-written Hopper
  stencil of ``csrc/convolve.cu``: on a CUDA tensor one launch a call
  (``streams=B`` frames at a stride included), which adds one to
  ``convolve_q16.launches``; on a CPU tensor it runs
  :func:`convolve_q16_reference`. There is no other route: a CUDA tensor
  either reaches the kernel or the call raises.
* :func:`convolve_q16_halo` — the same kernel on a row shard whose
  ``K//2`` halo rows above and below are already in place (uint8, from
  ``parallel.halo_conv``); on a CPU tensor the plain version.
* :func:`convolve_q16_reference` and :func:`accumulate_q16_reference` —
  the plain PyTorch versions: K^2 shifted integer adds over a
  zero-padded int32 ``(H, W*3)`` byte view.

On the card K8 sums in int32 with no ``conv2d`` and no matmul: it reads
the uint8 frame, stages bands of a tile's rows and their halo in shared
memory (``cp.async``, the next band in flight while one is summed), and
each thread makes a strip of :data:`CONV_STRIP_BYTES` output bytes down
the tile's rows with a partial sum of each row in flight in registers,
so it reads each staged word once (:func:`conv_plan` sizes the tiles);
it writes the uint8 result, with no int32 image and no accumulator in
device memory (the reference's tiled shared-memory convolution,
``kernels.cu:97-136``). A pixel's horizontal neighbour lies 3 bytes away
in the byte view. The sum is int32 with two's-complement wrap (the
kernel sums in unsigned arithmetic; the plain version's int32 tensors
wrap the same way), then an arithmetic ``>> 16`` and a clamp to
[0, 255]; the Q16 taps of a normalized kernel add up to about 65,536, so
the sum of any K up to 15 stays below 2^31. cuDNN's ``conv2d`` would sum
in float (TF32 by default on the card), and a float sum in another order
does not give these bytes.

:func:`median_filter` is the reference's benchmarked-and-rejected median
variant (``tests/noise_filter_benchmark/v3.cu``), byte-exact against
:func:`reference_cpu.median_filter`. No serving path calls it; it is
reached by the API only, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from cudavideostream_tpu_torch.kernels import launch
from cudavideostream_tpu_torch.kernels.launch import I, LL, P

# K8's launch geometry (csrc/convolve.cu): a block of CONV_THREADS threads
# makes a tile of CONV_THREADS * CONV_STRIP_BYTES output bytes of a row by
# conv_plan's tile rows, each thread a strip of CONV_STRIP_BYTES bytes of
# each row; it stages CONV_BAND_ROWS input rows at a time, in a ring of
# 2 * CONV_BAND_ROWS + K - 1 rows with 3 * (K // 2) bytes, rounded up to
# 16, on each side of the tile; K runs 1..CONV_MAX_K. conv_plan aims at
# one wave of CONV_BLOCKS_PER_SM blocks an SM.
CONV_THREADS = 128
CONV_STRIP_BYTES = 8
CONV_TILE_BYTES = CONV_THREADS * CONV_STRIP_BYTES
CONV_BAND_ROWS = 8
CONV_MAX_K = 15
CONV_BLOCKS_PER_SM = 4

SOURCE = launch.Source(
    "convolve",
    {"cvs_convolve_q16": [I, P, LL, I, I, P, LL, I, I, I, P, I, I, P]},
    {"cvs_conv_threads": CONV_THREADS,
     "cvs_conv_strip_bytes": CONV_STRIP_BYTES,
     "cvs_conv_band_rows": CONV_BAND_ROWS, "cvs_conv_max_k": CONV_MAX_K})


def conv_plan(rows: int, row_bytes: int, streams: int = 1,
              sms: int = 132):
    """``((x, y, z), tile_rows)`` of one K8 launch on a card of ``sms``
    SMs: ``x`` tiles of :data:`CONV_TILE_BYTES` bytes across a row, ``y``
    tiles of ``tile_rows`` rows down it, ``z`` streams. ``tile_rows`` is
    the least that keeps the grid within one wave of
    :data:`CONV_BLOCKS_PER_SM` blocks an SM (so no SM runs a second, short
    wave), at least :data:`CONV_BAND_ROWS` (a tile sums at least one whole
    band) and at least ``rows / 65535`` (the grid's ``y`` limit)."""
    if rows <= 0 or row_bytes <= 0 or streams <= 0 or sms <= 0:
        raise ValueError("conv_plan takes nonzero rows, row bytes, streams "
                         "and SMs")
    x = -(-row_bytes // CONV_TILE_BYTES)
    groups = max(1, CONV_BLOCKS_PER_SM * sms // (x * streams))
    tile_rows = max(CONV_BAND_ROWS, -(-rows // groups), -(-rows // 65535))
    return (x, -(-rows // tile_rows), streams), tile_rows


def _taps(weights_q16: np.ndarray) -> np.ndarray:
    """The Q16 taps as a flat int32 array, refused unless square with
    1..:data:`CONV_MAX_K` rows and every tap in int32."""
    w = np.asarray(weights_q16)
    if (w.ndim != 2 or w.shape[0] != w.shape[1]
            or not 1 <= w.shape[0] <= CONV_MAX_K
            or w.dtype.kind not in "iu"):
        raise ValueError(f"K8 takes a square KxK integer tap array, K in "
                         f"1..{CONV_MAX_K}")
    if w.size and (w.min() < -(1 << 31) or w.max() >= 1 << 31):
        raise ValueError("K8's Q16 taps must each fit in int32")
    return np.ascontiguousarray(w, dtype=np.int32).reshape(-1)


def _launch(src: torch.Tensor, src_stride: int, src_rows: int, row_off: int,
            rows: int, width: int, weights_q16: np.ndarray,
            streams: int) -> torch.Tensor:
    """One K8 launch over ``streams`` inputs at ``src_stride`` bytes;
    returns the flat ``(streams * rows * width * 3,)`` uint8 output."""
    taps = _taps(weights_q16)
    dev = src.device
    lib = launch.library(SOURCE)
    out = torch.empty(streams * rows * width * 3, dtype=torch.uint8,
                      device=dev)
    idx = launch.device_index(dev)
    _, tile_rows = conv_plan(rows, width * 3, streams, launch.sm_count(idx))
    rc = lib.cvs_convolve_q16(
        idx, src.data_ptr(), src_stride, src_rows, row_off, out.data_ptr(),
        rows * width * 3, rows, width * 3, tile_rows,
        taps.ctypes.data_as(ctypes.c_void_p), weights_q16.shape[0], streams,
        launch.stream_handle(dev))
    launch.raise_on(rc, lib, "convolve_q16")
    convolve_q16.launches += 1
    return out


def _check_frames(frame: torch.Tensor, size: int) -> None:
    if (frame.dtype != torch.uint8 or not frame.is_contiguous()
            or frame.numel() != size):
        raise ValueError(f"K8 takes a contiguous uint8 tensor of {size} "
                         f"bytes")
    if frame.device.type not in ("cpu", "cuda"):
        raise ValueError(f"convolve_q16 runs on cuda or cpu, not "
                         f"{frame.device}")


def convolve_q16(frame: torch.Tensor, weights_q16: np.ndarray, height: int,
                 width: int, streams: int = 1) -> torch.Tensor:
    """Zero-padded KxK convolution per channel; flat uint8 in/out.

    ``weights_q16`` is a (k, k) integer numpy array of Q16 taps
    (:func:`reference_cpu.quantize_kernel_q16`); ``frame`` holds
    ``streams`` frames of ``height * width * 3`` bytes back to back, each
    filtered on its own (its zero padding never reads a neighbour
    stream's rows), and is not modified.

    CUDA tensors launch K8 once (and count one in
    ``convolve_q16.launches``); CPU tensors run
    :func:`convolve_q16_reference` on each stream."""
    n = height * width * 3
    _check_frames(frame, streams * n)
    if frame.device.type == "cpu":
        return torch.cat([
            convolve_q16_reference(frame[b * n:(b + 1) * n], weights_q16,
                                   height, width)
            for b in range(streams)]) if streams > 1 else (
                convolve_q16_reference(frame, weights_q16, height, width))
    return _launch(frame, n, height, -(weights_q16.shape[0] // 2), height,
                   width, weights_q16, streams)


convolve_q16.launches = 0


def convolve_q16_halo(rows_with_halo: torch.Tensor, weights_q16: np.ndarray,
                      rows: int, width: int) -> torch.Tensor:
    """The stencil of a row shard whose vertical halo is in place:
    ``rows_with_halo`` holds ``(rows + 2*(K//2), width*3)`` uint8 rows
    (``parallel.halo_conv.halo_exchange_rows``); the horizontal zero
    padding is the shard's own. Returns the shard's flat
    ``(rows * width * 3,)`` uint8 rows, as the solo
    :func:`convolve_q16` of the whole frame gives them.

    CUDA tensors launch K8 (and count one in ``convolve_q16.launches``);
    CPU tensors run :func:`accumulate_q16_reference`."""
    pad = weights_q16.shape[0] // 2
    src_rows = rows + 2 * pad
    _check_frames(rows_with_halo, src_rows * width * 3)
    if rows_with_halo.device.type == "cpu":
        img = rows_with_halo.reshape(src_rows, width * 3).to(torch.int32)
        return accumulate_q16_reference(F.pad(img, (3 * pad, 3 * pad)),
                                        weights_q16, rows, width)
    return _launch(rows_with_halo, 0, src_rows, 0, rows, width, weights_q16,
                   1)


def convolve_q16_reference(frame: torch.Tensor, weights_q16: np.ndarray,
                           height: int, width: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`convolve_q16` for one frame:
    the frame as a zero-padded int32 ``(H, W*3)`` byte view, then
    :func:`accumulate_q16_reference`."""
    pad = weights_q16.shape[0] // 2
    img = frame.reshape(height, width * 3).to(torch.int32)
    padded = F.pad(img, (3 * pad, 3 * pad, pad, pad))
    return accumulate_q16_reference(padded, weights_q16, height, width)


def accumulate_q16_reference(padded: torch.Tensor, weights_q16: np.ndarray,
                             rows: int, width: int) -> torch.Tensor:
    """The Q16 stencil over a padded byte-space image: ``padded`` is
    ``(rows + 2*pad, width*3 + 6*pad)`` int32; returns flat uint8
    ``(rows * width * 3,)``, ``clip(sum >> 16, 0, 255)``, the int32 sum
    wrapping on overflow."""
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
