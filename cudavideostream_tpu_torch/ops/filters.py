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
  one as ``(114*B + 587*G + 299*R) // 1000`` in int32, visualizer 4:
  :func:`grayscale_average` and :func:`grayscale_weighted` are the
  wrappers of K13 (``csrc/visualize.cu``), one launch a call on a CUDA
  tensor; :func:`grayscale_average_reference` and
  :func:`grayscale_weighted_reference` are their plain versions;
* the binarize chain (``kernels.cu:138-241``, CPU scan
  ``server.cpp:96-135``), visualizer 5: :func:`binarize_pipeline` is the
  wrapper of K9, the hand-written Hopper kernels of ``csrc/binarize.cu``:
  on a CUDA tensor one cooperative launch a call, ``streams=B`` frames at
  a stride included (per-pixel gray values kept in registers, their
  exact 256-bin histogram a stream, a grid barrier, every block's top-2
  scan of its stream's histogram, and 255/0 three times a pixel;
  :func:`binarize_plan` sizes it to the blocks the card holds at once,
  and a launch the card refuses raises). The row-sharded step keeps two
  launches, because its histogram is summed over the shards between
  them: :func:`gray_hist` (per-pixel gray values and their histogram,
  one read of the frame) on each shard, then :func:`binarize_apply`
  (every block runs the CPU scan's top-2 rule on the summed histogram and
  writes 255/0), each counting its launches. On a CPU tensor each runs
  its plain version; a CUDA tensor either reaches the kernels or the
  call raises. :func:`binarize_pipeline_reference` is the plain version:
  the gray values, :func:`cudavideostream_tpu_torch.ops.hist.histogram_reference`,
  the top-2 rule as an exclusive running max (:func:`top2_prefix_max`)
  and the clamped threshold, in torch ops. :func:`value_histogram` keeps
  K4 (:func:`cudavideostream_tpu_torch.ops.hist.histogram`);
* the motion heatmap (``kernels.cu:243-270``) through the 766-entry LUT,
  wrap past ``d = 510`` included, visualizer 1: :func:`heatmap` is the
  wrapper of K11 (``csrc/visualize.cu``, the LUT by value in the launch's
  parameters), :func:`heatmap_reference` its plain version. The JAX
  package's sine path gives the same bytes and exists for TPU speed; it
  is not ported;
* the red visualizers (``kernels.cu:273-281``), visualizers 2 and 3:
  :func:`red_visualizer` is the wrapper of K12 (``csrc/visualize.cu``,
  the changed-pixel test and the select in one pass),
  :func:`red_visualizer_reference` its plain version. :func:`red_black`
  and :func:`red_overlap`, the selects on a given mask, stay as the JAX
  API's counterparts, in torch ops; no served path calls them.

K9 and K11-K13 read the overlay strip (``region``) in place of the
frame's prefix, so no overlaid copy of the frame is made for them; with
``streams=B`` the frame is B streams at a stride, each with its strip at
``region[b * len(region) // B:]`` (and, for K12, the one map of a
stream's length). Each wrapper counts its launches in ``.launches``; on
a CPU tensor it runs its plain version, and a CUDA tensor either reaches
the kernel or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cudavideostream_tpu_torch.kernels import launch
from cudavideostream_tpu_torch.kernels.launch import I, LL, OUT, P
from cudavideostream_tpu_torch.ops import diff as diff_ops
from cudavideostream_tpu_torch.ops import hist
from cudavideostream_tpu_torch.ops import reference_cpu

_LUTS: dict = {}

# K9's launch geometry (csrc/binarize.cu): each thread takes BIN_PIXELS
# pixels at a time; the fused kernel's and gray_hist's blocks have
# BIN_HIST_THREADS threads (K4's design), binarize_apply's
# BIN_APPLY_THREADS, and apply_plan puts at most BIN_APPLY_BLOCKS_PER_SM of
# those on an SM; a thread of the fused kernel keeps BIN_REG_RUNS runs of
# BIN_PIXELS pixels in registers across its grid barrier
BIN_PIXELS = 16
BIN_HIST_THREADS = 1024
BIN_APPLY_THREADS = 256
BIN_APPLY_BLOCKS_PER_SM = 8
BIN_REG_RUNS = 4

BINARIZE_SOURCE = launch.Source("binarize", {
    "cvs_gray_hist": [I, P, P, LL, LL, I, P, P, P, P],
    "cvs_binarize_apply": [I, P, LL, P, I, P, P],
    "cvs_binarize_fused": [I, P, LL, I, P, LL, P, P, P, I, I, P],
    "cvs_bin_fused_blocks_per_sm": [I, OUT],
}, {"cvs_bin_hist_threads": BIN_HIST_THREADS,
    "cvs_bin_apply_threads": BIN_APPLY_THREADS,
    "cvs_bin_scratch_words": hist.HIST_SCRATCH_WORDS,
    "cvs_bin_pixels": BIN_PIXELS, "cvs_bin_reg_runs": BIN_REG_RUNS})

# K11-K13's launch geometry (csrc/visualize.cu): blocks of VIS_THREADS
# threads. K11 and K12 walk warp tiles of VIS_TILE bytes (512 pixels),
# VIS_VECS 16-byte vectors a lane, HEAT_BLOCKS_PER_SM (K11) or
# RED_BLOCKS_PER_SM (K12, whose map instance takes 116 registers) blocks
# an SM; K13 takes VIS_PIXELS pixels a thread at a time, at most
# VIS_BLOCKS_PER_SM blocks an SM. The heatmap's LUT has LUT_SIZE entries
VIS_THREADS = 256
VIS_WARPS = VIS_THREADS // 32
VIS_VECS = 3
VIS_TILE = 512 * VIS_VECS
HEAT_BLOCKS_PER_SM = 4
RED_BLOCKS_PER_SM = 2
VIS_PIXELS = 16
VIS_BLOCKS_PER_SM = 8
LUT_SIZE = 766
# the kernel's op codes
VIS_OPS = {"heatmap": 0, "red_black": 1, "red_overlap": 2,
           "grayscale_average": 3, "grayscale_weighted": 4}

VISUALIZE_SOURCE = launch.Source("visualize", {
    "cvs_visualize": [I, I, P, P, LL, LL, P, P, I, P, LL, I, P, P],
}, {"cvs_vis_threads": VIS_THREADS, "cvs_vis_lut_size": LUT_SIZE,
    "cvs_tile_vecs": VIS_VECS, "cvs_heat_blocks_per_sm": HEAT_BLOCKS_PER_SM,
    "cvs_red_blocks_per_sm": RED_BLOCKS_PER_SM, "cvs_vis_pixels": VIS_PIXELS,
    "cvs_vis_blocks_per_sm": VIS_BLOCKS_PER_SM})
_lut_words = None


def _pixels(frame: torch.Tensor) -> torch.Tensor:
    """The ``(npx, 3)`` int32 pixel view of a flat BGR frame."""
    return frame.reshape(-1, 3).to(torch.int32)


def _replicate(g: torch.Tensor) -> torch.Tensor:
    """Per-pixel ``uint8`` values written to all three channels."""
    return g.to(torch.uint8)[:, None].expand(-1, 3).reshape(-1)


def grayscale_average_reference(frame: torch.Tensor,
                                region: Optional[torch.Tensor] = None,
                                streams: int = 1) -> torch.Tensor:
    """The plain version of :func:`grayscale_average`."""
    frame = diff_ops.region_frame(frame, region, streams)
    return _replicate(_pixels(frame).sum(dim=1) // 3)


def grayscale_average(frame: torch.Tensor,
                      region: Optional[torch.Tensor] = None,
                      streams: int = 1) -> torch.Tensor:
    """``(B+G+R)//3`` broadcast to all three channels; flat uint8 in/out.

    CUDA tensors launch K13 (and count one in
    ``grayscale_average.launches``); CPU tensors run
    :func:`grayscale_average_reference`."""
    return _visualize("grayscale_average", grayscale_average, frame, None,
                      region, streams)


grayscale_average.launches = 0


def gray_pixels(frame: torch.Tensor) -> torch.Tensor:
    """Per-pixel weighted gray values, ``(114*B + 587*G + 299*R) //
    1000``, as ``(npx,)`` uint8 (each at most 255 by construction)."""
    px = _pixels(frame)
    g = (114 * px[:, 0] + 587 * px[:, 1] + 299 * px[:, 2]) // 1000
    return g.to(torch.uint8)


def grayscale_weighted_reference(frame: torch.Tensor,
                                 region: Optional[torch.Tensor] = None,
                                 streams: int = 1) -> torch.Tensor:
    """The plain version of :func:`grayscale_weighted`."""
    return _replicate(gray_pixels(diff_ops.region_frame(frame, region,
                                                        streams)))


def grayscale_weighted(frame: torch.Tensor,
                       region: Optional[torch.Tensor] = None,
                       streams: int = 1) -> torch.Tensor:
    """Weighted gray broadcast to all three channels; flat uint8 in/out.

    CUDA tensors launch K13 (and count one in
    ``grayscale_weighted.launches``); CPU tensors run
    :func:`grayscale_weighted_reference`."""
    return _visualize("grayscale_weighted", grayscale_weighted, frame, None,
                      region, streams)


grayscale_weighted.launches = 0


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


def gray_hist_plan(npx: int, sms: int) -> int:
    """Blocks of one :func:`gray_hist` launch over ``npx`` pixels on a
    card of ``sms`` SMs: one per :data:`BIN_HIST_THREADS` whole runs of
    :data:`BIN_PIXELS` pixels, at most one per SM, at least one (block 0
    also takes the ragged tail of fewer than 16 pixels). Block ``b``'s
    thread ``t`` takes runs ``b * BIN_HIST_THREADS + t``, then every
    ``grid * BIN_HIST_THREADS`` further."""
    if npx <= 0 or sms <= 0:
        raise ValueError("gray_hist_plan takes a nonzero length and SM count")
    runs = npx // BIN_PIXELS
    return max(1, min(sms, -(-runs // BIN_HIST_THREADS)))


def apply_plan(npx: int, sms: int) -> int:
    """Blocks of one :func:`binarize_apply` launch over ``npx`` pixels:
    one per :data:`BIN_APPLY_THREADS` whole runs of :data:`BIN_PIXELS`
    pixels, at most :data:`BIN_APPLY_BLOCKS_PER_SM` an SM, at least one
    (block 0 also takes the ragged tail); runs are taken as in
    :func:`gray_hist_plan`."""
    if npx <= 0 or sms <= 0:
        raise ValueError("apply_plan takes a nonzero length and SM count")
    runs = npx // BIN_PIXELS
    return max(1, min(BIN_APPLY_BLOCKS_PER_SM * sms,
                      -(-runs // BIN_APPLY_THREADS)))


def binarize_plan(npx: int, streams: int, coresident: int
                  ) -> Tuple[int, int, int]:
    """``(grid, per_stream, block_runs)`` of one fused K9 launch over
    ``streams`` frames of ``npx`` pixels on a card that holds
    ``coresident`` of its blocks at once: ``per_stream`` blocks a stream
    (``grid = streams * per_stream``, never above ``coresident``, so the
    cooperative launch fits), each thread ``block_runs`` runs of
    :data:`BIN_PIXELS` pixels. Block ``j`` of stream ``b`` is block ``b *
    per_stream + j``; its thread ``t`` takes runs ``(j * block_runs + k) *
    BIN_HIST_THREADS + t``, ``k < block_runs``, of the stream; runs past
    :data:`BIN_REG_RUNS` go through device memory. The stream's first
    block also takes the ragged tail of fewer than 16 pixels. Raises when
    there are more streams than co-resident blocks."""
    if npx <= 0 or streams <= 0 or coresident <= 0:
        raise ValueError("binarize_plan takes a nonzero length, stream "
                         "count and co-resident block count")
    if streams > coresident:
        raise ValueError(f"K9 takes at most {coresident} streams a launch "
                         f"on this card (one block a stream at least)")
    runs = npx // BIN_PIXELS
    per_stream = coresident // streams
    block_runs = max(1, -(-runs // (per_stream * BIN_HIST_THREADS)))
    # the fewest blocks that still cover the stream at that depth
    per_stream = max(1, -(-runs // (block_runs * BIN_HIST_THREADS)))
    return streams * per_stream, per_stream, block_runs


def fused_coresident(device: torch.device) -> int:
    """The fused K9 kernel's blocks that ``device`` holds at once:
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` times its SMs (read
    once per device, ``launch.query``)."""
    idx = _cuda_index(device)
    (per_sm,) = launch.query(launch.library(BINARIZE_SOURCE),
                             "cvs_bin_fused_blocks_per_sm", idx, 1)
    return per_sm * launch.sm_count(idx)


def fused_scratch(device: torch.device, stream: int,
                  streams: int) -> torch.Tensor:
    """The fused K9 kernel's scratch (``launch.scratch``) for launches of
    ``streams`` streams on ``stream`` of ``device``: ``streams * 256 + 1``
    int32, each stream's sums, then the grid barrier's arrival word; one
    for each stream count."""
    return launch.scratch(("binarize_fused", int(streams)), device, stream,
                          streams * hist.NBINS + 1, torch.int32)


def _cuda_index(dev: torch.device) -> int:
    if dev.type != "cuda":
        raise ValueError(f"K9 runs on cuda or cpu, not {dev}")
    return launch.device_index(dev)


def _check_region(region: Optional[torch.Tensor], frame: torch.Tensor,
                  streams: int) -> int:
    """The length of one stream's overlay strip (0 without one); raises on
    a region the kernels do not take."""
    if region is None:
        return 0
    if (region.dtype != torch.uint8 or region.dim() != 1
            or not region.is_contiguous() or region.device != frame.device
            or region.numel() % streams
            or region.numel() > frame.numel()):
        raise ValueError("region must be a contiguous 1-D uint8 tensor on "
                         "the frame's device, an equal strip a stream, at "
                         "most a stream long")
    return region.numel() // streams


def gray_hist(frame: torch.Tensor, region: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch 1 of K9: ``(gray, hist)``, the ``(npx,)`` uint8 gray values
    of a flat contiguous BGR frame (:func:`gray_pixels`), ``region`` read
    in place of its prefix, and their ``(256,)`` int32 histogram, from one
    read of the frame.

    CUDA tensors launch the kernel (and count one in
    ``gray_hist.launches``); CPU tensors run :func:`gray_pixels` and
    :func:`hist.histogram_reference`."""
    if (frame.dtype != torch.uint8 or not frame.is_contiguous()
            or frame.numel() == 0 or frame.numel() % 3):
        raise ValueError("gray_hist takes a contiguous uint8 BGR frame")
    npx = frame.numel() // 3
    if npx >= 1 << 31:
        raise ValueError("gray_hist counts exceed int32")
    rlen = _check_region(region, frame, 1)
    dev = frame.device
    if dev.type == "cpu":
        gv = gray_pixels(diff_ops.region_frame(frame, region))
        return gv, hist.histogram_reference(gv)
    idx = _cuda_index(dev)
    lib = launch.library(BINARIZE_SOURCE)
    gray = torch.empty(npx, dtype=torch.uint8, device=dev)
    out = torch.empty(hist.NBINS, dtype=torch.int32, device=dev)
    stream = launch.stream_handle(dev)
    # K4's per-stream scratch: the launches on a stream run in its order,
    # and each leaves the scratch zero
    scratch = hist.hist_scratch(torch.device("cuda", idx), stream)
    rc = lib.cvs_gray_hist(idx, frame.data_ptr(),
                           region.data_ptr() if rlen else None, rlen, npx,
                           gray_hist_plan(npx, launch.sm_count(idx)),
                           gray.data_ptr(), scratch.data_ptr(),
                           out.data_ptr(), stream)
    launch.raise_on(rc, lib, "gray_hist")
    gray_hist.launches += 1
    return gray, out


gray_hist.launches = 0


def binarize_apply(gray: torch.Tensor, histogram: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch 2 of K9: the threshold of ``histogram`` (the CPU top-2
    scan, :func:`binarize_threshold`) applied to the ``(npx,)`` uint8 gray
    values, 255/0 written to all three bytes of each pixel: a flat
    ``(3 * npx,)`` uint8 frame, into ``out`` when given (a contiguous
    uint8 tensor of that size, which may be a view).

    CUDA tensors launch the kernel (and count one in
    ``binarize_apply.launches``); CPU tensors run :func:`binarize_pixels`
    on :func:`binarize_threshold`."""
    if (gray.dtype != torch.uint8 or not gray.is_contiguous()
            or gray.numel() == 0):
        raise ValueError("binarize_apply takes contiguous uint8 gray values")
    if (histogram.dtype != torch.int32 or histogram.numel() != hist.NBINS
            or not histogram.is_contiguous()
            or histogram.device != gray.device):
        raise ValueError("binarize_apply takes a (256,) int32 histogram on "
                         "the gray values' device")
    npx = gray.numel()
    if out is not None and (out.dtype != torch.uint8
                            or not out.is_contiguous()
                            or out.numel() != 3 * npx
                            or out.device != gray.device):
        raise ValueError("binarize_apply writes a contiguous uint8 tensor "
                         "of 3 bytes a pixel on the gray values' device")
    dev = gray.device
    if dev.type == "cpu":
        res = binarize_pixels(gray.reshape(-1),
                              binarize_threshold(histogram))
        if out is None:
            return res
        out.copy_(res.reshape(out.shape))
        return out
    idx = _cuda_index(dev)
    lib = launch.library(BINARIZE_SOURCE)
    if out is None:
        out = torch.empty(3 * npx, dtype=torch.uint8, device=dev)
    rc = lib.cvs_binarize_apply(idx, gray.data_ptr(), npx,
                                histogram.data_ptr(),
                                apply_plan(npx, launch.sm_count(idx)),
                                out.data_ptr(), launch.stream_handle(dev))
    launch.raise_on(rc, lib, "binarize_apply")
    binarize_apply.launches += 1
    return out


binarize_apply.launches = 0


def binarize_pipeline(frame: torch.Tensor,
                      out: Optional[torch.Tensor] = None,
                      region: Optional[torch.Tensor] = None,
                      streams: int = 1) -> torch.Tensor:
    """Visualizer 5: gray -> histogram -> top-2 threshold -> 255/0, the
    per-pixel gray computed once and read by both the histogram and the
    output (the JAX ``binarize_pipeline(fused=True)``), ``region`` read in
    place of the frame's prefix; into ``out`` when given (a contiguous
    uint8 tensor of the frame's size, which may be a view). With
    ``streams=B`` the frame is B frames back to back, each with its own
    histogram and threshold and its strip at ``region[b * len(region) //
    B:]``.

    CUDA tensors make one cooperative launch of K9's fused kernel (and
    count one in ``binarize_pipeline.launches``); a launch the card
    refuses raises. CPU tensors run :func:`binarize_pipeline_reference` on
    each stream."""
    if (frame.dtype != torch.uint8 or not frame.is_contiguous()
            or frame.numel() == 0 or streams < 1
            or frame.numel() % (3 * streams)):
        raise ValueError("binarize_pipeline takes a contiguous uint8 BGR "
                         "frame of `streams` equal frames")
    npx = frame.numel() // (3 * streams)
    if npx >= 1 << 31:
        raise ValueError("binarize_pipeline counts exceed int32")
    rlen = _check_region(region, frame, streams)
    if out is not None and (out.dtype != torch.uint8
                            or not out.is_contiguous()
                            or out.numel() != frame.numel()
                            or out.device != frame.device):
        raise ValueError("binarize_pipeline writes a contiguous uint8 tensor "
                         "of the frame's size on the frame's device")
    dev = frame.device
    if dev.type == "cpu":
        n = 3 * npx
        res = torch.cat([binarize_pipeline_reference(
            frame[b * n:(b + 1) * n],
            region[b * rlen:(b + 1) * rlen] if rlen else None)
            for b in range(streams)]) if streams > 1 else (
                binarize_pipeline_reference(frame, region))
        if out is None:
            return res
        out.copy_(res.reshape(out.shape))
        return out
    idx = _cuda_index(dev)
    lib = launch.library(BINARIZE_SOURCE)
    if out is None:
        out = torch.empty(3 * npx * streams, dtype=torch.uint8, device=dev)
    grid, per_stream, block_runs = binarize_plan(npx, streams,
                                                 fused_coresident(dev))
    stream = launch.stream_handle(dev)
    # past the register budget, 16 gray bytes a run wait in device memory
    spill = (torch.empty(streams * (npx // BIN_PIXELS) * BIN_PIXELS,
                         dtype=torch.uint8, device=dev)
             if block_runs > BIN_REG_RUNS else None)
    scratch = fused_scratch(torch.device("cuda", idx), stream, streams)
    rc = lib.cvs_binarize_fused(
        idx, frame.data_ptr(), npx, streams,
        region.data_ptr() if rlen else None, rlen, out.data_ptr(),
        None if spill is None else spill.data_ptr(), scratch.data_ptr(),
        per_stream, block_runs, stream)
    launch.raise_on(rc, lib, f"binarize_pipeline (grid {grid} of "
                             f"{BIN_HIST_THREADS} threads)")
    binarize_pipeline.launches += 1
    return out


binarize_pipeline.launches = 0


def binarize_pipeline_reference(frame: torch.Tensor,
                                region: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """The plain PyTorch version of :func:`binarize_pipeline`: the gray
    values, their histogram by :func:`hist.histogram_reference`, the
    threshold and the 255/0 replication, each in torch ops."""
    gv = gray_pixels(diff_ops.region_frame(frame, region))
    t = binarize_threshold(hist.histogram_reference(gv))
    return binarize_pixels(gv, t)


def _heatmap_lut(device: torch.device) -> torch.Tensor:
    """The ``(766, 3)`` uint8 BGR LUT of :func:`reference_cpu.heatmap_lut`
    on ``device``, uploaded once per device, for the plain version; K11
    takes the LUT in its launch's parameters instead."""
    lut = _LUTS.get(device)
    if lut is None:
        lut = torch.from_numpy(reference_cpu.heatmap_lut().copy()).to(device)
        _LUTS[device] = lut
    return lut


def heatmap_lut_words():
    """:func:`reference_cpu.heatmap_lut` packed ``b | g << 8 | r << 16``,
    one 32-bit word an entry, as a ``ctypes`` array of :data:`LUT_SIZE`
    (K11 copies it into its launch's parameters)."""
    global _lut_words
    if _lut_words is None:
        lut = reference_cpu.heatmap_lut().astype("uint32")
        if lut.shape != (LUT_SIZE, 3):
            raise RuntimeError("the heatmap LUT does not have 766 entries")
        words = lut[:, 0] | lut[:, 1] << 8 | lut[:, 2] << 16
        _lut_words = (ctypes.c_uint * LUT_SIZE)(*words.tolist())
    return _lut_words


def heatmap_reference(current: torch.Tensor, previous: torch.Tensor,
                      region: Optional[torch.Tensor] = None,
                      streams: int = 1) -> torch.Tensor:
    """The plain version of :func:`heatmap`."""
    cur = diff_ops.region_frame(current, region, streams)
    d = (_pixels(cur) - _pixels(previous)).abs().sum(dim=1)
    return _heatmap_lut(current.device)[d].reshape(-1)


def heatmap(current: torch.Tensor, previous: torch.Tensor,
            region: Optional[torch.Tensor] = None,
            streams: int = 1) -> torch.Tensor:
    """Visualizer 1: per-pixel ``sum |cur - prev|`` over the three
    channels (0..765) through the sine-colormap LUT; flat uint8 BGR.

    CUDA tensors launch K11 (and count one in ``heatmap.launches``); CPU
    tensors run :func:`heatmap_reference`."""
    return _visualize("heatmap", heatmap, current, previous, region, streams)


heatmap.launches = 0


def changed_pixels(mask: torch.Tensor) -> torch.Tensor:
    """``(npx,)`` bool: any of the pixel's three bytes shipped."""
    return mask.reshape(-1, 3).any(dim=1)


def red_black(mask: torch.Tensor) -> torch.Tensor:
    """Visualizer 2 on a given mask: a black frame with R = 255 on changed
    pixels; flat uint8. The JAX API's ``red_black``; the served path
    runs :func:`red_visualizer`."""
    ch = changed_pixels(mask)
    out = torch.zeros((ch.numel(), 3), dtype=torch.uint8, device=mask.device)
    out[:, 2] = torch.where(ch, 255, 0).to(torch.uint8)
    return out.reshape(-1)


def red_overlap(previous: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Visualizer 3 on a given mask: a copy of ``previous`` with R = 255
    on changed pixels; flat uint8. The JAX API's ``red_overlap``; the
    served path runs :func:`red_visualizer`."""
    out = previous.reshape(-1, 3).clone()
    out[:, 2] = torch.where(changed_pixels(mask), 255, out[:, 2])
    return out.reshape(-1)


def red_visualizer_reference(current: torch.Tensor, previous: torch.Tensor,
                             threshold, overlap: bool,
                             region: Optional[torch.Tensor] = None,
                             streams: int = 1) -> torch.Tensor:
    """The plain version of :func:`red_visualizer`: the mask of
    :func:`diff_mask` on the overlaid frame (the map repeated for each
    stream), then :func:`red_black` or :func:`red_overlap`."""
    if isinstance(threshold, torch.Tensor) and streams > 1:
        threshold = threshold.repeat(streams)
    mask = diff_ops.diff_mask(diff_ops.region_frame(current, region, streams),
                              previous, threshold)[0]
    return red_overlap(previous, mask) if overlap else red_black(mask)


def red_visualizer(current: torch.Tensor, previous: torch.Tensor,
                   threshold, overlap: bool,
                   region: Optional[torch.Tensor] = None,
                   streams: int = 1) -> torch.Tensor:
    """Visualizers 2 (``overlap=False``) and 3 (``overlap=True``) in one
    pass: a pixel is changed where any of its bytes has ``|cur - prev| >
    threshold`` on the overlaid frame, ``threshold`` an int or a per-byte
    ``uint8`` map of one stream's length (compared as ints); mode 2 writes
    ``(0, 0, 255)`` there and black elsewhere, mode 3 ``previous`` with R
    = 255 there. Flat uint8.

    CUDA tensors launch K12 (and count one in
    ``red_visualizer.launches``); CPU tensors run
    :func:`red_visualizer_reference`."""
    return _visualize("red_overlap" if overlap else "red_black",
                      red_visualizer, current, previous, region, streams,
                      threshold)


red_visualizer.launches = 0


def tile_plan(n: int, sms: int, per_sm: int) -> int:
    """Blocks of one K11 or K12 launch over ``n`` frame bytes (all streams)
    on a card of ``sms`` SMs: ``per_sm`` an SM (:data:`HEAT_BLOCKS_PER_SM`
    or :data:`RED_BLOCKS_PER_SM`, as the kernel is compiled), one wave,
    fewer where the frame has fewer tiles of :data:`VIS_TILE` bytes (the
    last one ragged). Warp ``w`` of block ``b`` takes tiles ``w * grid +
    b``, then every ``grid * VIS_WARPS`` further, so tile ``t`` falls to
    block ``t mod grid``, and with block ``b`` on SM ``b mod sms`` every SM
    takes the same number of tiles, give or take one."""
    if n <= 0 or sms <= 0 or per_sm <= 0:
        raise ValueError("tile_plan takes a nonzero length, SM count and "
                         "blocks an SM")
    return max(1, min(per_sm * sms, -(-n // VIS_TILE)))


def vis_plan(npx: int, sms: int) -> int:
    """Blocks of one K13 launch over ``npx`` pixels on a card of ``sms``
    SMs: one per :data:`VIS_THREADS` whole runs of :data:`VIS_PIXELS`
    pixels, at most :data:`VIS_BLOCKS_PER_SM` an SM, at least one (block
    0 also takes the ragged tail of fewer than 16 pixels). Block ``b``'s
    thread ``t`` takes runs ``b * VIS_THREADS + t``, then every ``grid *
    VIS_THREADS`` further."""
    if npx <= 0 or sms <= 0:
        raise ValueError("vis_plan takes a nonzero length and SM count")
    runs = npx // VIS_PIXELS
    return max(1, min(VIS_BLOCKS_PER_SM * sms, -(-runs // VIS_THREADS)))


def _visualize(op: str, wrapper, frame: torch.Tensor,
               previous: Optional[torch.Tensor],
               region: Optional[torch.Tensor], streams: int,
               threshold=0) -> torch.Tensor:
    """Check the arguments of one of K11-K13, then launch it on a CUDA
    tensor (one more in ``wrapper.launches``) or run its plain version on
    a CPU one."""
    if (frame.dtype != torch.uint8 or frame.dim() != 1
            or not frame.is_contiguous() or frame.numel() == 0):
        raise ValueError(f"{op} takes a contiguous 1-D uint8 frame")
    n = frame.numel()
    if streams < 1 or n % streams or (n // streams) % 3:
        raise ValueError(f"{op}: {n} bytes are not {streams} equal streams "
                         f"of whole BGR pixels")
    sn = n // streams
    rlen = _check_region(region, frame, streams)
    if rlen > sn:
        raise ValueError(f"{op}: the region is longer than a stream")
    if previous is not None and (
            previous.dtype != torch.uint8 or previous.dim() != 1
            or not previous.is_contiguous() or previous.numel() != n
            or previous.device != frame.device):
        raise ValueError(f"{op}: previous must be a contiguous uint8 tensor "
                         f"of the frame's length on its device")
    tmap = threshold if isinstance(threshold, torch.Tensor) else None
    if tmap is not None:
        if (tmap.dtype != torch.uint8 or tmap.dim() != 1
                or not tmap.is_contiguous() or tmap.numel() != sn
                or tmap.device != frame.device):
            raise ValueError(f"{op}: the threshold map must be a contiguous "
                             f"uint8 tensor of one stream's length on the "
                             f"frame's device")
    elif not 0 <= int(threshold) <= 255:
        raise ValueError("threshold must be in [0, 255]")
    dev = frame.device
    if dev.type == "cpu":
        if op == "heatmap":
            return heatmap_reference(frame, previous, region, streams)
        if op == "grayscale_average":
            return grayscale_average_reference(frame, region, streams)
        if op == "grayscale_weighted":
            return grayscale_weighted_reference(frame, region, streams)
        return red_visualizer_reference(frame, previous, threshold,
                                        op == "red_overlap", region, streams)
    if dev.type != "cuda":
        raise ValueError(f"K11-K13 run on cuda or cpu, not {dev}")
    idx = launch.device_index(dev)
    lib = launch.library(VISUALIZE_SOURCE)
    npx = n // 3
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    sms = launch.sm_count(idx)
    rc = lib.cvs_visualize(
        idx, VIS_OPS[op], frame.data_ptr(),
        region.data_ptr() if rlen else None, rlen, sn,
        None if previous is None else previous.data_ptr(),
        None if tmap is None else tmap.data_ptr(),
        0 if tmap is not None else int(threshold),
        heatmap_lut_words() if op == "heatmap" else None, npx,
        vis_plan(npx, sms) if op.startswith("grayscale") else tile_plan(
            n, sms, HEAT_BLOCKS_PER_SM if op == "heatmap"
            else RED_BLOCKS_PER_SM), out.data_ptr(),
        launch.stream_handle(dev))
    launch.raise_on(rc, lib, op)
    wrapper.launches += 1
    return out
