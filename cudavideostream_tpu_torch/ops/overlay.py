"""Device text overlay: glyph-atlas blit onto the frame before diffing
(the counterpart of the JAX package's ``ops/overlay.py``).

The reference launches one ``kernel2_char`` per character
(``kernels.cu:351-375``, driven from exec_core ``kernels.cu:466-476``),
copying the full glyph cell — background included — into the frame's top
rows at ``x = j * cell_w``. On a CUDA tensor the blit is K14
(``csrc/overlay.cu``): one launch writes the blended strip straight from
the frame, the atlas and the glyph ids, for one stream
(:func:`overlay_blit`) or for B streams at once
(:func:`overlay_blit_streams`), and counts one in
``overlay_blit.launches``; it raises where the kernel cannot run. On a
CPU tensor :func:`overlay_blit_reference` gathers the selected cells with
``index_select`` into one text strip and writes it with one slice copy.
The JAX package selects cells with a one-hot float matmul because TPU
gathers are slow; on the card an index gather is exact, where a float
matmul would be one more exactness hazard. The solo, batched and
sharded steps take their glyph ids from one :class:`Glyphs` a device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from cudavideostream_tpu_torch.kernels import launch
from cudavideostream_tpu_torch.kernels.launch import I, LL, P
from cudavideostream_tpu_torch.utils import fonts

# K14's launch geometry (csrc/overlay.cu): blocks of OVERLAY_THREADS lanes,
# each lane one OVERLAY_VEC-byte vector of the output at a time, at most
# OVERLAY_BLOCKS_PER_SM blocks an SM
OVERLAY_THREADS = 128
OVERLAY_BLOCKS_PER_SM = 8
OVERLAY_VEC = 16
# the status line's longest text: characters past it are not drawn
MAX_OVERLAY_CHARS = 28

SOURCE = launch.Source(
    "overlay",
    {"cvs_overlay": [I, P, LL, P, I, I, I, P, I, P, I, LL, LL, I, I, P, P]},
    {"cvs_overlay_threads": OVERLAY_THREADS,
     "cvs_overlay_blocks_per_sm": OVERLAY_BLOCKS_PER_SM,
     "cvs_overlay_vec": OVERLAY_VEC})


def overlay_plan(n: int, sms: int) -> int:
    """Blocks of one K14 launch over ``n`` output bytes (all streams) on a
    card of ``sms`` SMs: one a :data:`OVERLAY_THREADS` vectors of
    :data:`OVERLAY_VEC` bytes, at most :data:`OVERLAY_BLOCKS_PER_SM` an SM
    (one wave), at least one. Lane ``t`` of block ``b`` takes vector ``b *
    OVERLAY_THREADS + t``, then every ``grid * OVERLAY_THREADS`` further."""
    if n <= 0 or sms <= 0:
        raise ValueError("overlay_plan takes a nonzero length and SM count")
    vecs = -(-n // OVERLAY_VEC)
    return max(1, min(OVERLAY_BLOCKS_PER_SM * sms,
                      -(-vecs // OVERLAY_THREADS)))


def text_glyphs(texts: Sequence[str], max_chars: int, cells_a_row: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The glyph ids ``(B, max_chars)`` and the characters each stream
    draws, ``n_fit (B,)`` = ``min(max_chars, cells_a_row, len(text))``,
    int32 on ``device``, in one upload; views of one buffer."""
    b = len(texts)
    host = torch.tensor(
        [min(max_chars, cells_a_row, len(t)) for t in texts]
        + [i for t in texts for i in fonts.encode_text(t, max_chars)],
        dtype=torch.int32)
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    buf = host.to(device, non_blocking=True)
    return buf[b:].view(b, max_chars), buf[:b]


class Glyphs:
    """The glyph ids of the last tuple of status texts on one device:
    :func:`text_glyphs` of the texts at :data:`MAX_OVERLAY_CHARS` and
    ``cells_a_row`` cells a row, uploaded when the texts change. While the
    number of texts holds, the same two tensors are handed back, and new
    texts are written into their memory in the current stream's order, so
    a CUDA graph that launched K14 on them reads the new ids (a count
    passed by value stays the captured one). Calling it with a tuple of B
    texts returns ``(ids (B, MAX_OVERLAY_CHARS), n_fit (B,))``, int32."""

    def __init__(self, device, cells_a_row: int):
        self.device = torch.device(device)
        self.cells_a_row = cells_a_row
        self._texts: Optional[Tuple[str, ...]] = None
        self._last: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def __call__(self, texts: Sequence[str]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        texts = tuple(texts)
        if texts != self._texts:
            new = text_glyphs(texts, MAX_OVERLAY_CHARS, self.cells_a_row,
                              self.device)
            if self._last is not None and len(texts) == len(self._texts):
                for old, upload in zip(self._last, new):
                    old.copy_(upload)
            else:
                self._last = new
            self._texts = texts
        return self._last


def overlay_blit_reference(
    frame: torch.Tensor,
    atlas: torch.Tensor,
    char_ids: torch.Tensor,
    n_chars: int,
    height: int,
    width: int,
) -> torch.Tensor:
    """The plain version of :func:`overlay_blit`, in PyTorch ops."""
    cell_h, cell_w = atlas.shape[1], atlas.shape[2]
    n_fit = min(char_ids.shape[0], width // cell_w, n_chars)
    if n_fit <= 0 or cell_h > height:
        return frame.clone()
    cw3 = cell_w * 3
    # byte-space 2D view (height, width*3): the strip is a plain slice
    img = frame.reshape(height, width * 3).clone()
    cells = atlas.index_select(0, char_ids[:n_fit])  # (n_fit, ch, cw, 3)
    strip = cells.reshape(n_fit, cell_h, cw3).permute(1, 0, 2)
    img[:cell_h, : n_fit * cw3] = strip.reshape(cell_h, n_fit * cw3)
    return img.reshape(-1)


def _check(frames: torch.Tensor, atlas: torch.Tensor, rows_bytes: int,
           streams: int) -> int:
    """Raise on what K14 does not take; returns a stream's bytes."""
    if (frames.dtype != torch.uint8 or frames.dim() != 1
            or not frames.is_contiguous()):
        raise ValueError("overlay_blit takes a contiguous 1-D uint8 frame")
    if streams < 1 or frames.numel() % streams:
        raise ValueError(f"overlay_blit: {frames.numel()} bytes are not "
                         f"{streams} equal streams")
    sn = frames.numel() // streams
    if sn < rows_bytes:
        raise ValueError(f"overlay_blit: a stream of {sn} bytes is shorter "
                         f"than the {rows_bytes} bytes blended")
    if (atlas.dtype != torch.uint8 or atlas.dim() != 4 or atlas.shape[3] != 3
            or not atlas.is_contiguous() or atlas.device != frames.device):
        raise ValueError("overlay_blit: the atlas must be a contiguous "
                         "(n_glyphs, cell_h, cell_w, 3) uint8 tensor on the "
                         "frame's device")
    return sn


def _launch(frames: torch.Tensor, stride: int, atlas: torch.Tensor,
            ids: torch.Tensor, n_fit: Optional[torch.Tensor], nfit: int,
            streams: int, height: int, width: int) -> torch.Tensor:
    """One K14 launch on a CUDA tensor (one more in
    ``overlay_blit.launches``): ``streams`` strips of ``height`` rows."""
    dev = frames.device
    if dev.type != "cuda":
        raise ValueError(f"K14 runs on cuda or cpu, not {dev}")
    for t, what in ((ids, "glyph ids"), (n_fit, "n_fit")):
        if t is not None and (t.dtype != torch.int32 or not t.is_contiguous()
                              or t.device != dev):
            raise ValueError(f"overlay_blit: the {what} must be a contiguous "
                             f"int32 tensor on the frame's device")
    idx = launch.device_index(dev)
    lib = launch.library(SOURCE)
    row = width * 3
    n = streams * height * row
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    rc = lib.cvs_overlay(
        idx, frames.data_ptr(), stride, atlas.data_ptr(), atlas.shape[0],
        atlas.shape[1], atlas.shape[2] * 3,
        ids.data_ptr() if ids.shape[-1] else None, ids.shape[-1],
        None if n_fit is None else n_fit.data_ptr(), nfit, row, height,
        streams, overlay_plan(n, launch.sm_count(idx)), out.data_ptr(),
        launch.stream_handle(dev))
    launch.raise_on(rc, lib, "overlay")
    overlay_blit.launches += 1
    return out


def overlay_blit(
    frame: torch.Tensor,
    atlas: torch.Tensor,
    char_ids: torch.Tensor,
    n_chars: int,
    height: int,
    width: int,
) -> torch.Tensor:
    """Blit the first ``n_chars`` glyph cells of ``char_ids``.

    Args:
      frame: flat uint8 frame of ``height * width * 3`` bytes (not
        modified; a blended copy is returned).
      atlas: (n_glyphs, cell_h, cell_w, 3) uint8 atlas on the frame's
        device.
      char_ids: (max_chars,) atlas indices on the frame's device (int32;
        K14 converts other integer types first).
      n_chars: host int — characters beyond it leave the frame intact.

    A CUDA frame launches K14 once, B = 1, with the characters drawn
    passed by value; a cell taller than the frame returns
    ``frame.clone()``.
    """
    if _check(frame, atlas, height * width * 3, 1) != height * width * 3:
        raise ValueError(f"overlay_blit: the frame has {frame.numel()} "
                         f"bytes, not {height} x {width} x 3")
    if frame.device.type == "cpu":
        return overlay_blit_reference(frame, atlas, char_ids, n_chars,
                                      height, width)
    if atlas.shape[1] > height:
        return frame.clone()
    n_fit = max(0, min(char_ids.shape[0], width // atlas.shape[2], n_chars))
    return _launch(frame, frame.numel(), atlas, char_ids.to(torch.int32),
                   None, n_fit, 1, height, width)


overlay_blit.launches = 0


def overlay_blit_streams(
    frames: torch.Tensor,
    atlas: torch.Tensor,
    ids: torch.Tensor,
    n_fit: torch.Tensor,
    height: int,
    width: int,
    streams: int,
) -> torch.Tensor:
    """:func:`overlay_blit` on the first ``height`` rows of each of B
    streams, into one flat ``(B * height * width * 3,)`` tensor, stream
    ``b``'s strip at ``b * height * width * 3``.

    ``frames`` is B equal streams, flat; ``ids`` ``(B, max_chars)`` and
    ``n_fit`` ``(B,)`` int32 on its device (:func:`text_glyphs`). A CUDA
    tensor launches K14 once for every stream.
    """
    sn = _check(frames, atlas, height * width * 3, streams)
    if ids.dim() != 2 or ids.shape[0] != streams or n_fit.shape != (streams,):
        raise ValueError(f"overlay_blit_streams: ids must be (B, max_chars) "
                         f"and n_fit (B,), B = {streams}")
    strip = height * width * 3
    if atlas.shape[1] > height:  # no cell fits: the strips as they are
        return torch.cat([frames[b * sn:b * sn + strip]
                          for b in range(streams)])
    if frames.device.type == "cpu":
        return torch.cat([
            overlay_blit_reference(frames[b * sn:b * sn + strip], atlas,
                                   ids[b], int(n_fit[b]), height, width)
            for b in range(streams)])
    return _launch(frames, sn, atlas, ids, n_fit, 0, streams, height, width)
