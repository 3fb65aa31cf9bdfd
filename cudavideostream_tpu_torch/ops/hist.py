"""The exact 256-bin histogram of gray values (K4): the counterpart of
the JAX package's ``ops/hist_pallas.py`` ``pallas_histogram``, which
``filters.value_histogram`` sends every (M, 128) gray grid to on
hardware (the binarize visualizer's threshold).

* :func:`histogram` — on a CUDA tensor it launches the hand-written
  Hopper kernel (``csrc/histogram.cu``) and adds one to its ``launches``
  count; on a CPU tensor it runs :func:`histogram_reference`. There is no
  other route: a CUDA tensor either reaches the kernel or the call
  raises.
* :func:`histogram_reference` — the plain PyTorch version: the chunked
  compare-and-sum of the JAX package's ``_value_histogram_xla``.

The kernel reads the gray values as ``uint8``, one per pixel, where the
TPU kernel reads an int32 grid: the bytes read fall by 4 and the counts
are the same.
"""

from __future__ import annotations

import ctypes

import torch

from cudavideostream_tpu_torch.kernels import build

NBINS = 256
# bins compared at once by the plain version: a 1080p call holds a
# (2,073,600, 32) bool block, 66 MB, at a time
_REF_CHUNK = 32

_lib = None


def _hist_lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/histogram.cu`` (K4)."""
    global _lib
    if _lib is None:
        lib = build.load("histogram")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.cvs_histogram.argtypes = [i, p, ll, p, p]
        lib.cvs_histogram.restype = i
        lib.cvs_error_string.argtypes = [i]
        lib.cvs_error_string.restype = ctypes.c_char_p
        lib.cvs_hist_bins.argtypes = []
        lib.cvs_hist_bins.restype = i
        if lib.cvs_hist_bins() != NBINS:
            raise RuntimeError("csrc/histogram.cu bin count disagrees with "
                               "ops/hist.py NBINS")
        _lib = lib
    return _lib


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
    lib = _hist_lib()
    out = torch.empty(NBINS, dtype=torch.int32, device=dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    rc = lib.cvs_histogram(idx, g.data_ptr(), n, out.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed: "
                           f"{lib.cvs_error_string(rc).decode()} ({rc})")
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
