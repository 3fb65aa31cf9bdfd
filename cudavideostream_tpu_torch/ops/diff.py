"""The elementwise delta operator: thresholded per-byte diff with
negative feedback, and the LSB-first change bitmask (the counterpart of
the JAX package's ``ops/diff.py``).

They are the elementwise half of the plain versions of the fused kernel
(:func:`cudavideostream_tpu_torch.ops.logcompact.fused_diff_compact_reference`
and its tiled and bitmask-only siblings).

:func:`diff_pack` is the wrapper of K10, the hand-written Hopper kernel of
``csrc/diff_pack.cu``: the HOST backend's device step (the diff, the
bitmask, the new previous frame in place and, on request, the dense
delta) in one launch on a CUDA tensor, counted in ``diff_pack.launches``.
On a CPU tensor it runs :func:`diff_pack_reference`, the plain version:
:func:`diff_mask` and :func:`pack_bitmask` with the same in-place
contract. A CUDA tensor either reaches the kernel or the call raises.

Byte-exact contract (vs :func:`reference_cpu.diff_encode`):

* ``df = int(cur) - int(prev)`` (true signed difference, no uint8 wrap);
* a byte ships iff ``|df| > threshold`` (strictly greater), the threshold
  being one int or a per-byte ``uint8`` map read at the byte's own index;
* shipped value is ``df mod 256`` (client wrap-add reproduces ``cur``);
* non-shipped bytes of the new previous-frame buffer keep the *previous*
  value under negative feedback (``kernels.cu:318-323``).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from cudavideostream_tpu_torch.kernels import launch
from cudavideostream_tpu_torch.kernels.launch import I, LL, P

# K10's launch geometry (csrc/diff_pack.cu): a warp takes tiles of DP_TILE
# frame bytes, DP_VECS 16-byte vectors a lane; blocks of DP_THREADS
# threads, DP_BLOCKS_PER_SM an SM
DP_THREADS = 256
DP_WARPS = DP_THREADS // 32
DP_VECS = 2
DP_TILE = 512 * DP_VECS
DP_BLOCKS_PER_SM = 2

SOURCE = launch.Source(
    "diff_pack", {"cvs_diff_pack": [I, P, P, LL, P, P, I, I, LL, I, P, P, P]},
    {"cvs_dp_threads": DP_THREADS, "cvs_dp_vecs": DP_VECS,
     "cvs_dp_blocks_per_sm": DP_BLOCKS_PER_SM})


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


def region_frame(current: torch.Tensor, region: Optional[torch.Tensor],
                 streams: int = 1) -> torch.Tensor:
    """``current`` with the overlay region substituted for its prefix (a
    new tensor where there is a region): the overlaid frame of the plain
    versions and of the SORT step. With ``streams=B``, each of the B
    equal streams of ``current`` takes its slice of ``region``, stream
    ``b`` the ``b``-th ``len(region) // B`` bytes."""
    if region is None or region.numel() == 0:
        return current
    out = current.clone()
    out.view(streams, -1)[:, :region.numel() // streams] = region.view(
        streams, -1)
    return out


def diff_pack_reference(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: Union[int, torch.Tensor],
    negative_feedback: bool = True,
    region: Optional[torch.Tensor] = None,
    want_delta: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of :func:`diff_pack`: :func:`diff_mask` on the
    overlaid frame, :func:`pack_bitmask`, and ``previous`` overwritten
    with the new previous frame."""
    mask, delta, new_prev = diff_mask(region_frame(current, region),
                                      previous, threshold, negative_feedback)
    previous.copy_(new_prev)
    return pack_bitmask(mask), (delta if want_delta else None)


def diff_pack_plan(n: int, sms: int) -> int:
    """Blocks of one :func:`diff_pack` launch over ``n`` frame bytes on a
    card of ``sms`` SMs: :data:`DP_BLOCKS_PER_SM` an SM, one wave, fewer
    where the frame has fewer tiles of :data:`DP_TILE` bytes (the last one
    ragged). Warp ``w`` of block ``b`` takes tiles ``w * grid + b``, then
    every ``grid * DP_WARPS`` further, so tile ``t`` falls to block ``t
    mod grid``, and with block ``b`` on SM ``b mod sms`` every SM takes
    the same number of tiles, give or take one."""
    if n <= 0 or sms <= 0:
        raise ValueError("diff_pack_plan takes a nonzero length and SM count")
    return max(1, min(DP_BLOCKS_PER_SM * sms, -(-n // DP_TILE)))


def _check_pack_args(current, previous, threshold, region):
    for name, t in (("current", current), ("previous", previous)):
        if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D uint8 tensor")
    n = current.numel()
    if previous.numel() != n or n == 0:
        raise ValueError("current and previous must have one nonzero length")
    if previous.device != current.device:
        raise ValueError("current and previous must be on one device")
    if isinstance(threshold, torch.Tensor):
        if (threshold.dtype != torch.uint8 or threshold.dim() != 1
                or not threshold.is_contiguous() or threshold.numel() != n
                or threshold.device != current.device):
            raise ValueError("the threshold map must be a contiguous uint8 "
                             "tensor of the frame's length on its device")
    elif not 0 <= int(threshold) <= 255:
        raise ValueError("threshold must be in [0, 255]")
    if region is not None and (
            region.dtype != torch.uint8 or region.dim() != 1
            or not region.is_contiguous() or region.numel() > n
            or region.device != current.device):
        raise ValueError("region must be a contiguous 1-D uint8 tensor on "
                         "the frame's device, at most the frame's length")


def diff_pack(
    current: torch.Tensor,
    previous: torch.Tensor,
    threshold: Union[int, torch.Tensor],
    negative_feedback: bool = True,
    region: Optional[torch.Tensor] = None,
    want_delta: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The HOST backend's device step over flat ``uint8`` frames: returns
    ``(bits, delta)``, the ``((n + 7) // 8,)`` LSB-first change bitmask
    (:func:`pack_bitmask` of :func:`diff_mask`'s mask, zero padding bits)
    and, with ``want_delta``, the ``(n,)`` wrapped delta (else None).
    ``previous`` is updated IN PLACE to the new previous frame. ``region``
    (the overlay strip) is read in place of ``current``'s prefix;
    ``threshold`` is an int or a per-byte ``uint8`` map of the frame's
    length.

    CUDA tensors launch K10 (and count one in ``diff_pack.launches``);
    CPU tensors run :func:`diff_pack_reference`."""
    _check_pack_args(current, previous, threshold, region)
    dev = current.device
    if dev.type == "cpu":
        return diff_pack_reference(current, previous, threshold,
                                   negative_feedback, region, want_delta)
    if dev.type != "cuda":
        raise ValueError(f"K10 runs on cuda or cpu, not {dev}")
    if current.data_ptr() == previous.data_ptr():
        raise ValueError("current and previous must not share storage")
    idx = launch.device_index(dev)
    lib = launch.library(SOURCE)
    n = current.numel()
    tmap = threshold if isinstance(threshold, torch.Tensor) else None
    rlen = 0 if region is None else region.numel()
    bits = torch.empty((n + 7) // 8, dtype=torch.uint8, device=dev)
    delta = (torch.empty(n, dtype=torch.uint8, device=dev) if want_delta
             else None)
    rc = lib.cvs_diff_pack(
        idx, current.data_ptr(), region.data_ptr() if rlen else None, rlen,
        previous.data_ptr(), None if tmap is None else tmap.data_ptr(),
        0 if tmap is not None else int(threshold), int(negative_feedback), n,
        diff_pack_plan(n, launch.sm_count(idx)), bits.data_ptr(),
        None if delta is None else delta.data_ptr(), launch.stream_handle(dev))
    launch.raise_on(rc, lib, "diff_pack")
    diff_pack.launches += 1
    return bits, delta


diff_pack.launches = 0
