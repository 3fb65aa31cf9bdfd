"""Builtin fonts and glyph-atlas builder for the text overlay.

The reference renders its atlas at startup with OpenCV ``putText``
(FONT_HERSHEY_PLAIN, green, ``threads.cpp:44-54``) for the alphabet
``CHARS_STR "0123456789BFPSWbkps :/"`` (``common.h:13``). We have no
OpenCV dependency, so the atlas is rendered host-side — same contract:
a dense ``(n_chars, cell_h, cell_w, 3)`` uint8 array of green-on-black
cells uploaded to the device once and blitted whole (background
included) onto the frame. Two styles:

* ``"stroke"`` (default) — an original thin-stroke vector font in the
  visual family of FONT_HERSHEY_PLAIN: polyline glyphs rasterized with
  anti-alias-free round caps at any scale (glyph paths designed here,
  not copied from anywhere);
* ``"bitmap"`` — the embedded 5x7 bitmap font, nearest-scaled.

A copy of the JAX package's ``utils/fonts.py`` (host-only NumPy), so
both packages render byte-identical atlases.
"""

from __future__ import annotations

from typing import List

import numpy as np

CHARS = "0123456789BFPSWbkps :/"

# Each glyph: 7 rows of 5 bits, MSB = leftmost column.
_FONT_5X7 = {
    "0": (0b01110, 0b10001, 0b10011, 0b10101, 0b11001, 0b10001, 0b01110),
    "1": (0b00100, 0b01100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    "2": (0b01110, 0b10001, 0b00001, 0b00010, 0b00100, 0b01000, 0b11111),
    "3": (0b11111, 0b00010, 0b00100, 0b00010, 0b00001, 0b10001, 0b01110),
    "4": (0b00010, 0b00110, 0b01010, 0b10010, 0b11111, 0b00010, 0b00010),
    "5": (0b11111, 0b10000, 0b11110, 0b00001, 0b00001, 0b10001, 0b01110),
    "6": (0b00110, 0b01000, 0b10000, 0b11110, 0b10001, 0b10001, 0b01110),
    "7": (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b01000, 0b01000),
    "8": (0b01110, 0b10001, 0b10001, 0b01110, 0b10001, 0b10001, 0b01110),
    "9": (0b01110, 0b10001, 0b10001, 0b01111, 0b00001, 0b00010, 0b01100),
    "B": (0b11110, 0b10001, 0b10001, 0b11110, 0b10001, 0b10001, 0b11110),
    "F": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b10000),
    "P": (0b11110, 0b10001, 0b10001, 0b11110, 0b10000, 0b10000, 0b10000),
    "S": (0b01111, 0b10000, 0b10000, 0b01110, 0b00001, 0b00001, 0b11110),
    "W": (0b10001, 0b10001, 0b10001, 0b10101, 0b10101, 0b10101, 0b01010),
    "b": (0b10000, 0b10000, 0b10110, 0b11001, 0b10001, 0b10001, 0b11110),
    "k": (0b10000, 0b10000, 0b10010, 0b10100, 0b11000, 0b10100, 0b10010),
    "p": (0b00000, 0b00000, 0b11110, 0b10001, 0b11110, 0b10000, 0b10000),
    "s": (0b00000, 0b00000, 0b01111, 0b10000, 0b01110, 0b00001, 0b11110),
    " ": (0, 0, 0, 0, 0, 0, 0),
    ":": (0b00000, 0b00100, 0b00100, 0b00000, 0b00100, 0b00100, 0b00000),
    "/": (0b00001, 0b00010, 0b00100, 0b00100, 0b01000, 0b10000, 0b00000),
}

GLYPH_H, GLYPH_W = 7, 5
CELL_H, CELL_W = GLYPH_H + 1, GLYPH_W + 1  # 1px padding row/col


def glyph_bitmap(ch: str) -> np.ndarray:
    """(CELL_H, CELL_W) 0/1 array for one character."""
    rows = _FONT_5X7[ch]
    out = np.zeros((CELL_H, CELL_W), dtype=np.uint8)
    for r, bits in enumerate(rows):
        for c in range(GLYPH_W):
            out[r, c] = (bits >> (GLYPH_W - 1 - c)) & 1
    return out


# Stroke font: polylines in a (x: 0..4, y: 0..8) glyph box, y down,
# baseline at y=7 ('p' descends to 8). Original designs in the
# FONT_HERSHEY_PLAIN visual family (thin strokes, round joins).
_STROKES = {
    "0": [[(1, 0), (3, 0), (4, 1), (4, 6), (3, 7), (1, 7), (0, 6), (0, 1), (1, 0)],
          [(0, 6), (4, 1)]],
    "1": [[(1, 1), (2, 0), (2, 7)], [(1, 7), (3, 7)]],
    "2": [[(0, 1), (1, 0), (3, 0), (4, 1), (4, 2), (0, 6), (0, 7), (4, 7)]],
    "3": [[(0, 0), (4, 0), (2, 3), (3, 3), (4, 4), (4, 6), (3, 7), (1, 7), (0, 6)]],
    "4": [[(3, 0), (0, 5), (4, 5)], [(3, 0), (3, 7)]],
    "5": [[(4, 0), (0, 0), (0, 3), (3, 3), (4, 4), (4, 6), (3, 7), (1, 7), (0, 6)]],
    "6": [[(3, 0), (1, 0), (0, 1), (0, 6), (1, 7), (3, 7), (4, 6), (4, 4),
           (3, 3), (0, 3)]],
    "7": [[(0, 0), (4, 0), (1, 7)]],
    "8": [[(1, 0), (3, 0), (4, 1), (4, 2), (3, 3), (1, 3), (0, 2), (0, 1), (1, 0)],
          [(1, 3), (0, 4), (0, 6), (1, 7), (3, 7), (4, 6), (4, 4), (3, 3), (1, 3)]],
    "9": [[(1, 7), (3, 7), (4, 6), (4, 1), (3, 0), (1, 0), (0, 1), (0, 3),
           (1, 4), (4, 4)]],
    "B": [[(0, 0), (0, 7)],
          [(0, 0), (3, 0), (4, 1), (4, 2), (3, 3), (0, 3)],
          [(3, 3), (4, 4), (4, 6), (3, 7), (0, 7)]],
    "F": [[(0, 7), (0, 0), (4, 0)], [(0, 3), (3, 3)]],
    "P": [[(0, 7), (0, 0), (3, 0), (4, 1), (4, 3), (3, 4), (0, 4)]],
    "S": [[(4, 1), (3, 0), (1, 0), (0, 1), (0, 2), (1, 3), (3, 4), (4, 5),
           (4, 6), (3, 7), (1, 7), (0, 6)]],
    "W": [[(0, 0), (1, 7), (2, 3), (3, 7), (4, 0)]],
    "b": [[(0, 0), (0, 7)],
          [(0, 4), (1, 3), (3, 3), (4, 4), (4, 6), (3, 7), (1, 7), (0, 6)]],
    "k": [[(0, 0), (0, 7)], [(3, 3), (0, 5)], [(1, 4), (3, 7)]],
    "p": [[(0, 3), (0, 8)],
          [(0, 4), (1, 3), (3, 3), (4, 4), (4, 5), (3, 6), (1, 6), (0, 7)]],
    "s": [[(4, 3), (1, 3), (0, 4), (1, 5), (3, 5), (4, 6), (3, 7), (0, 7)]],
    " ": [],
    ":": [[(2, 2), (2, 2)], [(2, 6), (2, 6)]],
    "/": [[(0, 7), (4, 0)]],
}

STROKE_CELL_H, STROKE_CELL_W = 10, 6  # glyph-box units incl. margins


def _stroke_glyph(ch: str, scale: int) -> np.ndarray:
    """(10*scale, 6*scale) 0/1 raster of the stroke glyph: pixels within
    the stroke radius of any polyline segment (round caps/joins)."""
    H, W = STROKE_CELL_H * scale, STROKE_CELL_W * scale
    img = np.zeros((H, W), np.uint8)
    radius = max(0.6, 0.35 * scale)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    for poly in _STROKES[ch]:
        pts = [(scale + gx * scale, 0.5 * scale + gy * scale)
               for gx, gy in poly]
        segs = list(zip(pts, pts[1:])) or [(pts[0], pts[0])]
        for (x0, y0), (x1, y1) in segs:
            dx, dy = x1 - x0, y1 - y0
            L2 = dx * dx + dy * dy
            if L2 == 0:
                d2 = (xx - x0) ** 2 + (yy - y0) ** 2
            else:
                t = np.clip(((xx - x0) * dx + (yy - y0) * dy) / L2, 0.0, 1.0)
                d2 = (xx - (x0 + t * dx)) ** 2 + (yy - (y0 + t * dy)) ** 2
            img[d2 <= radius * radius] = 1
    return img


def make_atlas(scale: int = 5, style: str = "stroke") -> np.ndarray:
    """(len(CHARS), cell_h, cell_w, 3) uint8 BGR atlas, green glyphs on
    black (the reference's cv::Scalar(0,255,0)).

    ``style="stroke"`` renders the vector font at (10*scale, 6*scale)
    cells; ``style="bitmap"`` nearest-scales the 5x7 bitmap font to
    (8*scale, 6*scale) cells.
    """
    cells = []
    for ch in CHARS:
        if style == "stroke":
            bm = _stroke_glyph(ch, scale)
        elif style == "bitmap":
            bm = np.kron(
                glyph_bitmap(ch), np.ones((scale, scale), dtype=np.uint8)
            )
        else:
            raise ValueError(f"unknown font style {style!r}")
        cell = np.zeros((*bm.shape, 3), dtype=np.uint8)
        cell[:, :, 1] = bm * 255  # G channel in BGR
        cells.append(cell)
    return np.stack(cells, axis=0)


def encode_text(text: str, max_len: int | None = None) -> List[int]:
    """Map a status string to atlas indices; unknown chars become spaces
    (the reference leaves ``idx`` stale on a miss — we define spaces)."""
    ids = [CHARS.index(c) if c in CHARS else CHARS.index(" ") for c in text]
    if max_len is not None:
        ids = ids[:max_len] + [CHARS.index(" ")] * max(0, max_len - len(ids))
    return ids
