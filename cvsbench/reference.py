"""Plain NumPy reference of the server step that the benchmark times.

A frozen copy of the step's semantics, written apart from the program:
it imports nothing but NumPy, and works out everything the program
derives (the glyph atlas, the Q16 filter taps, the overlaid and filtered
frames, the state and the payload) again from the raw frames and the base
frame that the harness made.

One step of one camera (the upstream server's ``exec_core``,
``server/src/kernels.cu:430-525``, in the order the port keeps):

1. under ``noise_filter``, the zero-padded K x K Gaussian in Q16 fixed
   point, per channel, ``clip(sum >> 16, 0, 255)`` (``kernels.cu:97-136``,
   taps ``server.cpp:20-36`` with sigma K*K/6);
2. the status text's glyph cells copied whole, background included, over
   the frame's top-left corner (``kernels.cu:351-375``, ``466-476``);
3. byte ``i`` ships iff ``|c - prev| > threshold``, with the delta
   ``(c - prev) mod 256``; under negative feedback the state takes ``c``
   only where a byte ships (``kernels.cu:289-334``), else everywhere.

Every byte of a step depends on the state and the frame at that byte
alone (the filter reads only frames), so the check runs bands of rows on
their own, in threads.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# The status text's alphabet and the stroke font of the port's overlay
# (glyph boxes x 0..4, y 0..8, y down; cells of 10 x 6 box units), copied
# so that the reference renders its own atlas.
CHARS = "0123456789BFPSWbkps :/"
_STROKES = {
    "0": [[(1, 0), (3, 0), (4, 1), (4, 6), (3, 7), (1, 7), (0, 6), (0, 1),
           (1, 0)], [(0, 6), (4, 1)]],
    "1": [[(1, 1), (2, 0), (2, 7)], [(1, 7), (3, 7)]],
    "2": [[(0, 1), (1, 0), (3, 0), (4, 1), (4, 2), (0, 6), (0, 7), (4, 7)]],
    "3": [[(0, 0), (4, 0), (2, 3), (3, 3), (4, 4), (4, 6), (3, 7), (1, 7),
           (0, 6)]],
    "4": [[(3, 0), (0, 5), (4, 5)], [(3, 0), (3, 7)]],
    "5": [[(4, 0), (0, 0), (0, 3), (3, 3), (4, 4), (4, 6), (3, 7), (1, 7),
           (0, 6)]],
    "6": [[(3, 0), (1, 0), (0, 1), (0, 6), (1, 7), (3, 7), (4, 6), (4, 4),
           (3, 3), (0, 3)]],
    "7": [[(0, 0), (4, 0), (1, 7)]],
    "8": [[(1, 0), (3, 0), (4, 1), (4, 2), (3, 3), (1, 3), (0, 2), (0, 1),
           (1, 0)],
          [(1, 3), (0, 4), (0, 6), (1, 7), (3, 7), (4, 6), (4, 4), (3, 3),
           (1, 3)]],
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
MAX_CHARS = 28  # the status line's longest text


def glyph(ch: str, scale: int) -> np.ndarray:
    """``(10*scale, 6*scale)`` 0/1 raster of one glyph: the pixels within
    the stroke radius of any of its segments."""
    h, w = 10 * scale, 6 * scale
    img = np.zeros((h, w), np.uint8)
    r2 = max(0.6, 0.35 * scale) ** 2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for poly in _STROKES[ch]:
        pts = [(scale + gx * scale, 0.5 * scale + gy * scale)
               for gx, gy in poly]
        for (x0, y0), (x1, y1) in list(zip(pts, pts[1:])) or [(pts[0],
                                                              pts[0])]:
            dx, dy = x1 - x0, y1 - y0
            seg2 = dx * dx + dy * dy
            t = 0.0 if seg2 == 0 else np.clip(
                ((xx - x0) * dx + (yy - y0) * dy) / seg2, 0.0, 1.0)
            d2 = (xx - (x0 + t * dx)) ** 2 + (yy - (y0 + t * dy)) ** 2
            img[d2 <= r2] = 1
    return img


def text_strip(text: str, scale: int, width: int) -> np.ndarray:
    """The glyph cells of ``text`` side by side, green on black, as BGR
    bytes ``(cell_h, n_fit * cell_w * 3)``: what the overlay writes over
    the frame's first rows. Characters outside the alphabet are spaces;
    the cells that do not fit the width are left out."""
    text = "".join(c if c in CHARS else " " for c in text[:MAX_CHARS])
    cell_w = 6 * scale
    cells = []
    for ch in text[:width // cell_w]:
        cell = np.zeros((10 * scale, cell_w, 3), np.uint8)
        cell[:, :, 1] = glyph(ch, scale) * 255
        cells.append(cell)
    if not cells:
        return np.zeros((10 * scale, 0), np.uint8)
    return np.concatenate(cells, axis=1).reshape(10 * scale, -1)


def gaussian_q16(k: int) -> np.ndarray:
    """The K x K Gaussian of sigma K*K/6, normalised, in Q16 integers."""
    sigma = k * k / 6.0
    i = np.arange(k, dtype=np.float64) - (k - 1) / 2.0
    w = np.exp(-(i[:, None] ** 2 + i[None, :] ** 2) / (2.0 * sigma * sigma))
    return np.rint(w / w.sum() * 65536.0).astype(np.int64)


class Step:
    """The reference step of one configuration (its ``stream`` block and
    status text, as the configuration file gives them). It works out no
    side output (:mod:`cvsbench.check` names the interface); a reference
    of a configuration with a visualizer subclasses it."""

    outputs: Tuple[str, ...] = ()

    def __init__(self, stream: Dict, text: str):
        self.height, self.width = int(stream["height"]), int(stream["width"])
        self.row_bytes = self.width * 3
        self.threshold = int(stream["threshold"])
        self.feedback = bool(stream["negative_feedback"])
        self.taps = (gaussian_q16(int(stream["conv_k"]))
                     if stream["noise_filter"] else None)
        strip = text_strip(text, int(stream["overlay_scale"]), self.width)
        # a cell taller than the frame is never drawn
        self.strip = strip if strip.shape[0] <= self.height else strip[:0]

    def prepare(self, raw: np.ndarray):
        """Values that cover the whole frame, for ``aux_rows``: none."""
        return None

    def frame_rows(self, raw: np.ndarray, r0: int, r1: int) -> np.ndarray:
        """Rows ``[r0, r1)`` of the frame the diff reads: ``raw`` (one
        flat camera frame) filtered, then overlaid; flat uint8."""
        img = raw.reshape(self.height, self.row_bytes)
        if self.taps is None:
            out = img[r0:r1].copy()
        else:
            out = self._filter_rows(img, r0, r1)
        h, w = self.strip.shape
        if r0 < h and w:
            out[:h - r0, :w] = self.strip[r0:min(h, r1)]
        return out.reshape(-1)

    def _filter_rows(self, img: np.ndarray, r0: int, r1: int) -> np.ndarray:
        k = self.taps.shape[0]
        pad = k // 2
        lo, hi = max(0, r0 - pad), min(self.height, r1 + pad)
        padded = np.zeros((r1 - r0 + 2 * pad, self.row_bytes + 6 * pad),
                          np.int32)
        padded[lo - (r0 - pad):hi - (r0 - pad), 3 * pad:3 * pad
               + self.row_bytes] = img[lo:hi]
        acc = np.zeros((r1 - r0, self.row_bytes), np.int32)
        tmp = np.empty_like(acc)
        for i in range(k):
            for j in range(k):
                np.multiply(padded[i:i + r1 - r0, 3 * j:3 * j
                                   + self.row_bytes],
                            int(self.taps[i, j]), out=tmp)
                acc += tmp
        np.right_shift(acc, 16, out=acc)
        return np.clip(acc, 0, 255).astype(np.uint8)

    def update(self, state: np.ndarray, cur: np.ndarray,
               feedback: bool | None = None) -> Tuple[np.ndarray, np.ndarray]:
        """One diff over a band: ``state`` updated in place; returns the
        band-local indices that ship and their deltas. ``feedback`` False
        breaks the negative-feedback guarantee (the control)."""
        mask = absdiff(cur, state) > self.threshold
        xs = np.flatnonzero(mask)
        vals = cur[xs] - state[xs]  # uint8: (c - p) mod 256
        if self.feedback if feedback is None else feedback:
            np.copyto(state, cur, where=mask)
        else:
            np.copyto(state, cur)
        return xs, vals


def absdiff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``|a - b|`` of two uint8 arrays, in uint8."""
    return np.maximum(a, b) - np.minimum(a, b)


def bands(rows: int, count: int) -> List[Tuple[int, int]]:
    """``count`` bands of whole rows (fewer where there are fewer rows)."""
    count = max(1, min(count, rows))
    edges = [rows * i // count for i in range(count + 1)]
    return [(a, b) for a, b in zip(edges, edges[1:]) if b > a]
