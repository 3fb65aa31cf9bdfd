"""The ``register`` compaction scheme (K6): diff + negative feedback +
stream compaction by a row loop with register staging, at whole-tile
units.

The counterpart of the JAX package's ``ops/pallas_compact.py``
(``_kernel``, launched by ``run_register``), reached the same way:
through ``logcompact.fused_diff_compact(scheme="register")`` and
``fused_diff_compact_tiled(scheme="register")``. Like it, this is a
correctness cross-check, a third independently derived implementation of
K1's bytes, reached by no serving path. The kernel
(``csrc/register_compact.cu``) takes each tile on one thread-block
cluster of CTAs, each CTA a band of the tile's 16-byte vectors ranked by
warp ballots, the carried offset passed between the CTAs through
distributed shared memory (:func:`register_plan` gives the launch's
shape); every SM is busy at 1080p.

* :func:`register_compact` — on a CUDA tensor it launches the
  hand-written Hopper kernel and adds one to its ``launches`` count; on a
  CPU tensor it runs :func:`register_compact_reference`. There is no
  other route: a CUDA tensor either reaches the kernel or the call raises.
* :func:`register_compact_reference` — the plain PyTorch version, by the
  same scheme: a row loop with a carried offset, vectorized over tiles.

Scalar threshold only, no overlay region: the JAX package refuses both
for this scheme (``logcompact.py:671-675``), and so does
``logcompact._check_scheme``.
"""

from __future__ import annotations

import ctypes

import torch

from cudavideostream_tpu_torch.kernels import build
from cudavideostream_tpu_torch.ops import diff as diff_ops
from cudavideostream_tpu_torch.ops import logcompact

_lib = None


def _register_lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/register_compact.cu`` (K6)."""
    global _lib
    if _lib is None:
        lib = build.load("register_compact")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.cvs_register_compact.argtypes = [
            i, p, p, ll, i, i, i, i, p, p, p, p,
        ]
        lib.cvs_register_compact.restype = i
        lib.cvs_error_string.argtypes = [i]
        lib.cvs_error_string.restype = ctypes.c_char_p
        lib.cvs_register_plan.argtypes = [i, p, p, p, p]
        lib.cvs_register_plan.restype = i
        _lib = lib
    return _lib


def register_plan(device: torch.device) -> dict:
    """The shape of a K6 launch on ``device`` (a CUDA device): CTAs per
    cluster (one cluster a tile), threads per CTA, dynamic shared memory
    per CTA in bytes, and ``active_clusters``, the clusters the card holds
    at once (``logcompact.cluster_plan``)."""
    return logcompact.cluster_plan(_register_lib(), "cvs_register_plan",
                                   device)


def register_compact(current: torch.Tensor, previous: torch.Tensor,
                     threshold: int = 20, negative_feedback: bool = True):
    """The register scheme (K6); returns ``(counts, xs_t, vals_t,
    new_prev)`` exactly as ``logcompact.segment_compact`` does: one int32
    count per tile, the ``(n_units, unit_bytes)`` blocks at
    ``tiled_geometry(n, 0)`` zero past each count, ``new_prev`` =
    ``previous`` updated in place.

    CUDA tensors launch the kernel (and count one in
    ``register_compact.launches``); CPU tensors run
    :func:`register_compact_reference`.
    """
    logcompact._check_args(current, previous, threshold, None)
    dev = current.device
    if dev.type == "cpu":
        return register_compact_reference(current, previous, threshold,
                                          negative_feedback)
    if dev.type != "cuda":
        raise ValueError(f"register_compact runs on cuda or cpu, not {dev}")
    if current.data_ptr() == previous.data_ptr():
        raise ValueError("current and previous must not share storage")
    lib = _register_lib()
    n_pad, unit_bytes = logcompact.tiled_geometry(current.numel(), 0)
    n_units = n_pad // unit_bytes
    counts = torch.empty(n_units, dtype=torch.int32, device=dev)
    xs_t = torch.empty((n_units, unit_bytes), dtype=torch.int32, device=dev)
    vals_t = torch.empty((n_units, unit_bytes), dtype=torch.uint8,
                         device=dev)
    rc = lib.cvs_register_compact(
        logcompact._device_index(dev), current.data_ptr(),
        previous.data_ptr(), current.numel(), int(threshold),
        int(bool(negative_feedback)), unit_bytes, n_units,
        counts.data_ptr(), xs_t.data_ptr(), vals_t.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    logcompact._raise_on(rc, lib, "register_compact")
    register_compact.launches += 1
    return counts, xs_t, vals_t, previous


register_compact.launches = 0


def register_compact_reference(current: torch.Tensor,
                               previous: torch.Tensor, threshold: int = 20,
                               negative_feedback: bool = True):
    """The plain PyTorch version of :func:`register_compact`, by its
    scheme: the tiles' rows of 128 bytes in order (at most 512
    iterations), each row's shipped bytes ranked by a ``cumsum`` and
    scattered at the tile's running offset, which the row's count then
    advances. Bytes that do not ship scatter to a spare column that is
    dropped, so nothing waits on the device."""
    logcompact._check_args(current, previous, threshold, None)
    dev = current.device
    n = current.numel()
    n_pad, unit_bytes = logcompact.tiled_geometry(n, 0)
    n_units = n_pad // unit_bytes
    rows = unit_bytes // logcompact.LANES
    mask, dvals, new_prev = diff_ops.diff_mask(current, previous, threshold,
                                               negative_feedback)
    m = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    m[:n] = mask
    d = torch.zeros(n_pad, dtype=torch.uint8, device=dev)
    d[:n] = dvals
    m3 = m.view(n_units, rows, logcompact.LANES)
    d3 = d.view(n_units, rows, logcompact.LANES)
    g3 = torch.arange(n_pad, dtype=torch.int32, device=dev).view(
        n_units, rows, logcompact.LANES)
    xs_w = torch.zeros((n_units, unit_bytes + 1), dtype=torch.int32,
                       device=dev)
    vals_w = torch.zeros((n_units, unit_bytes + 1), dtype=torch.uint8,
                         device=dev)
    off = torch.zeros((n_units, 1), dtype=torch.int64, device=dev)
    for r in range(rows):
        row = m3[:, r]
        slot = torch.where(row, off + torch.cumsum(row, dim=1) - 1,
                           unit_bytes)
        xs_w.scatter_(1, slot, g3[:, r])
        vals_w.scatter_(1, slot, d3[:, r])
        off += row.sum(dim=1, keepdim=True)
    previous.copy_(new_prev)  # in place, as the kernel does
    return (off.view(n_units).to(torch.int32),
            xs_w[:, :unit_bytes].contiguous(),
            vals_w[:, :unit_bytes].contiguous(), previous)
