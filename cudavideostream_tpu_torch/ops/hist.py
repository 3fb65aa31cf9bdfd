"""The exact 256-bin histogram of gray values (K4), and the compare
probe (K7): the counterparts of the JAX package's ``ops/hist_pallas.py``
``pallas_histogram``, which ``filters.value_histogram`` sends every
(M, 128) gray grid to on hardware (the binarize visualizer's threshold;
in the port that visualizer runs K9, ``csrc/binarize.cu``, whose first
launch reuses K4's design and its scratch, and K4 serves
``filters.value_histogram`` and ``gray_histogram``), and ``vpu_probe``,
the benchmark probe of ``benchmarks/binarize_pallas_ab``.

* :func:`histogram` — on a CUDA tensor it launches the hand-written
  Hopper kernel (``csrc/histogram.cu``: one launch a call, at most one
  block per SM, the blocks' sums merged through a per-stream scratch
  that the last block empties, :func:`hist_plan`, :func:`hist_scratch`)
  and adds one to its ``launches`` count; on a CPU tensor it runs
  :func:`histogram_reference`. There is no other route: a CUDA tensor
  either reaches the kernel or the call raises.
* :func:`histogram_reference` — the plain PyTorch version: the chunked
  compare-and-sum of the JAX package's ``_value_histogram_xla``.

* :func:`vpu_probe` — 256 compares and adds per value of an ``(M, 128)``
  int32 grid, one checksum per tile of the JAX tile geometry; on a CUDA
  tensor the kernel of ``csrc/probe.cu`` (one launch a call: equal
  slices of the values on every SM, :func:`probe_slices`, each tile's
  partial sums added by the last CTA to finish, which a per-stream count
  in :func:`probe_scratch` finds), on a CPU tensor
  :func:`vpu_probe_reference`, as above.

The histogram kernel reads the gray values as ``uint8``, one per pixel,
where the TPU kernel reads an int32 grid: the bytes read fall by 4 and
the counts are the same. The probe reads int32, as the TPU probe does:
its values may lie outside [0, 255], and those add nothing.
"""

from __future__ import annotations

import torch

from cudavideostream_tpu_torch.kernels import launch
from cudavideostream_tpu_torch.kernels.launch import I, LL, OUT, P

NBINS = 256
# threads of a K4 block (csrc/histogram.cu kThreads), each reading 16-byte
# vectors, and the int32 words of its scratch: the 256 sums, the done count
HIST_THREADS = 1024
HIST_SCRATCH_WORDS = NBINS + 1
# bins compared at once by the plain version: a 1080p call holds a
# (2,073,600, 32) bool block, 66 MB, at a time
_REF_CHUNK = 32

SOURCE = launch.Source(
    "histogram", {"cvs_histogram": [I, P, LL, I, P, P, P]},
    {"cvs_hist_bins": NBINS, "cvs_hist_threads": HIST_THREADS,
     "cvs_hist_scratch_words": HIST_SCRATCH_WORDS})


def hist_plan(n: int, sms: int) -> int:
    """Blocks of one K4 launch over ``n`` bytes on a card of ``sms`` SMs:
    one per :data:`HIST_THREADS` whole 16-byte vectors, at most one per
    SM, at least one (block 0 also counts the ragged tail of fewer than
    16 bytes). Block ``b``'s thread ``t`` reads vectors ``b *
    HIST_THREADS + t``, then every ``grid * HIST_THREADS`` further."""
    if n <= 0 or sms <= 0:
        raise ValueError("hist_plan takes a nonzero length and SM count")
    return max(1, min(sms, -(-(n // 16) // HIST_THREADS)))


def hist_scratch(device: torch.device, stream: int) -> torch.Tensor:
    """K4's scratch (``launch.scratch``) for launches on ``stream`` of
    ``device``: :data:`HIST_SCRATCH_WORDS` int32, the 256 sums and the
    done count, which its last block empties."""
    return launch.scratch("histogram", device, stream, HIST_SCRATCH_WORDS,
                          torch.int32)


def histogram(g: torch.Tensor) -> torch.Tensor:
    """``(256,)`` int32 counts of the values of ``g``, a contiguous
    ``uint8`` tensor of any shape (the gray values, 0..255).

    CUDA tensors launch the kernel (and count one in
    ``histogram.launches``); CPU tensors run :func:`histogram_reference`.
    Another dtype raises: the kernel reads bytes, and a silent cast would
    hide a caller that hands it wider values."""
    if g.dtype != torch.uint8 or not g.is_contiguous():
        raise ValueError("histogram takes a contiguous uint8 tensor")
    n = g.numel()
    if n == 0:
        raise ValueError("histogram takes a nonzero length")
    if n >= 1 << 31:
        raise ValueError("histogram counts exceed int32")
    dev = g.device
    if dev.type == "cpu":
        return histogram_reference(g)
    if dev.type != "cuda":
        raise ValueError(f"histogram runs on cuda or cpu, not {dev}")
    if g.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte vectors: g must be "
                         "16-byte aligned")
    lib = launch.library(SOURCE)
    out = torch.empty(NBINS, dtype=torch.int32, device=dev)
    idx = launch.device_index(dev)
    stream = launch.stream_handle(dev)
    scratch = hist_scratch(torch.device("cuda", idx), stream)
    rc = lib.cvs_histogram(idx, g.data_ptr(), n,
                           hist_plan(n, launch.sm_count(idx)),
                           scratch.data_ptr(), out.data_ptr(), stream)
    launch.raise_on(rc, lib, "histogram")
    histogram.launches += 1
    return out


histogram.launches = 0


def histogram_reference(g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`histogram`, for integer
    values in [0, 255] of any dtype and shape: for each chunk of bins, a
    broadcast compare and a sum (``_value_histogram_xla``,
    ``filters.py:173-188`` of the JAX package)."""
    v = g.reshape(-1, 1).to(torch.int32)
    parts = []
    for b0 in range(0, NBINS, _REF_CHUNK):
        bins = torch.arange(b0, b0 + _REF_CHUNK, dtype=torch.int32,
                            device=g.device)
        parts.append((v == bins).sum(dim=0, dtype=torch.int32))
    return torch.cat(parts)


# -- K7 -------------------------------------------------------------------

# CTAs of a K7 launch an SM holds (csrc/probe.cu kCtasPerSm): the slices
# come in whole waves of PROBE_CTAS_PER_SM x the SMs
PROBE_CTAS_PER_SM = 2

PROBE_SOURCE = launch.Source(
    "probe", {"cvs_vpu_probe": [I, P, I, I, I, P, P, P, P],
              "cvs_probe_plan": [I, OUT, OUT, OUT]},
    {"cvs_probe_bins": NBINS})


def probe_slices(tiles: int, sms: int) -> int:
    """CTAs of one K7 launch over ``tiles`` tiles on a card of ``sms``
    SMs: the fewest whole waves of :data:`PROBE_CTAS_PER_SM` CTAs an SM
    that give every tile a CTA (264 on an H100 up to 264 tiles). CTA
    ``c`` takes the 16-byte vectors ``[c * V // slices, (c + 1) * V //
    slices)`` of the ``V`` of the grid's whole tiles: a slice is never
    longer than a tile."""
    if tiles <= 0 or sms <= 0:
        raise ValueError("probe_slices takes a nonzero tile and SM count")
    wave = PROBE_CTAS_PER_SM * sms
    return -(-tiles // wave) * wave


def probe_plan(device: torch.device) -> dict:
    """The shape of a K7 launch on ``device`` (a CUDA device): threads
    per CTA, the CTAs an SM is planned to hold (``per_sm``), and
    ``resident``, the CTAs it can hold
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; below ``per_sm``
    the slices would not all run at once). Asked once per device
    (``launch.query``)."""
    plan = dict(zip(("threads", "per_sm", "resident"), launch.query(
        launch.library(PROBE_SOURCE), "cvs_probe_plan",
        launch.device_index(device), 3)))
    if plan["per_sm"] != PROBE_CTAS_PER_SM:
        raise RuntimeError("csrc/probe.cu CTAs an SM disagree with "
                           "ops/hist.py PROBE_CTAS_PER_SM")
    return plan


def probe_scratch(device: torch.device, stream: int) -> torch.Tensor:
    """K7's scratch (``launch.scratch``) for launches on ``stream`` of
    ``device``: one int32, the count of finished slices, which its last
    CTA resets."""
    return launch.scratch("probe", device, stream, 1, torch.int32)


def probe_tile(rows: int) -> int:
    """Rows per tile of :func:`vpu_probe`: the largest multiple of 8 up to
    512 that divides ``rows``, else 8 (``hist_pallas._tile``, copied). A
    grid of ``rows // tile`` tiles runs, as in the JAX wrapper: rows past
    the last whole tile are not read."""
    best = 8
    for d in range(8, 513, 8):
        if rows % d == 0:
            best = d
    return best


def _probe_grid(g2: torch.Tensor):
    if (g2.dim() != 2 or g2.shape[1] != 128 or g2.dtype.is_floating_point
            or g2.dtype.is_complex or g2.dtype == torch.bool):
        raise ValueError("vpu_probe takes an (M, 128) integer grid")
    tile = probe_tile(g2.shape[0])
    grid = g2.shape[0] // tile
    if grid == 0:
        raise ValueError("vpu_probe takes at least 8 rows")
    if grid * tile * 128 >= 1 << 31:
        raise ValueError("vpu_probe indices exceed int32")
    return tile, grid


def vpu_probe(g2: torch.Tensor, unroll: bool = False) -> torch.Tensor:
    """``(grid,)`` int32 checksums of an ``(M, 128)`` integer grid: for
    each tile of :func:`probe_tile` rows, the sum over its values ``g``
    and the 256 bins ``b`` of ``g == b`` (its count of values in [0, 255],
    its element count for gray values). The JAX package's ``vpu_probe``,
    whose 256 compare-and-adds per value are the work being measured; the
    grid is cast to int32 as there. ``unroll`` picks the TPU kernel's
    code shape and changes no value: it is accepted and ignored.

    CUDA tensors launch the kernel (and count one in
    ``vpu_probe.launches``); CPU tensors run :func:`vpu_probe_reference`.
    """
    del unroll
    tile, grid = _probe_grid(g2)
    g2 = g2.to(torch.int32).contiguous()
    dev = g2.device
    if dev.type == "cpu":
        return vpu_probe_reference(g2)
    if dev.type != "cuda":
        raise ValueError(f"vpu_probe runs on cuda or cpu, not {dev}")
    if g2.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte vectors: g2 must be "
                         "16-byte aligned")
    lib = launch.library(PROBE_SOURCE)
    out = torch.empty(grid, dtype=torch.int32, device=dev)
    idx = launch.device_index(dev)
    stream = launch.stream_handle(dev)
    slices = probe_slices(grid, launch.sm_count(idx))
    part = torch.empty(2 * slices, dtype=torch.int32, device=dev)
    rc = lib.cvs_vpu_probe(idx, g2.data_ptr(), tile * 128, grid, slices,
                           part.data_ptr(),
                           probe_scratch(torch.device("cuda", idx),
                                         stream).data_ptr(),
                           out.data_ptr(), stream)
    launch.raise_on(rc, lib, "vpu_probe")
    vpu_probe.launches += 1
    return out


vpu_probe.launches = 0


def vpu_probe_reference(g2: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`vpu_probe`: the same 256
    compares per value, one bin at a time, into an int32 accumulator per
    value, then one sum per tile."""
    tile, grid = _probe_grid(g2)
    g = g2[: grid * tile].to(torch.int32).reshape(grid, tile * 128)
    acc = torch.zeros_like(g)
    for b in range(NBINS):
        acc += g == b
    return acc.sum(dim=1, dtype=torch.int32)
