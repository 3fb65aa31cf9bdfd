"""A plain NumPy reference of visualizer 5, binarize (``NOISE_VISUALIZER``
5, ``server/include/common.h:1-20``), for configuration ``cvs_1080p_bin``.

The upstream chain (``server/src/kernels.cu:491-499``) runs on the frame
the diff reads (overlaid, and filtered where the configuration says so):

1. the weighted gray of each pixel, ``(114*B + 587*G + 299*R) // 1000``
   (``grayscale_kernel_v3``, ``kernels.cu:67-95``, BGR order);
2. the 256-bin histogram of the gray values, one count a pixel
   (``generate_histogram``, ``kernels.cu:138-175``);
3. the top-2 scan of the CPU build (``server.cpp:108-120``), written here
   as its literal loop, and the threshold ``T = trunc((imax + isec) / 2)``
   clamped to [50, 200] (``server.cpp:121-127``);
4. each pixel's three bytes 255 where its gray exceeds T, else 0
   (``binarize_kernel_v2``, ``kernels.cu:222-241``).

The histogram and T cover the whole camera frame, so :meth:`Step.prepare`
works them out once a frame; :meth:`Step.aux_rows` maps a band of rows.
The overlay, the filter and the diff are those of
:mod:`cvsbench.reference`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from cvsbench import reference

BINARIZE = 5
BINS = 256
T_MIN, T_MAX = 50, 200


def gray(rows: np.ndarray) -> np.ndarray:
    """The weighted gray of each pixel of flat BGR bytes, as uint8."""
    px = rows.reshape(-1, 3).astype(np.int32)
    return ((114 * px[:, 0] + 587 * px[:, 1] + 299 * px[:, 2])
            // 1000).astype(np.uint8)


def top2_scan(hist) -> Tuple[int, int]:
    """``(index_max, index_sec_max)`` of ``server.cpp:108-120``, bin by
    bin: a count at least the running max takes the max slot (the later
    bin wins a tie), hands the old max index to the runner-up slot and
    sets the runner-up count to the new max; a count strictly between
    the two takes the runner-up slot. ``index_sec_max`` is -1 where the
    max was taken only once."""
    max_count, sec_count = -1, -1
    index_max, index_sec = -1, -1
    for i in range(BINS):
        count = int(hist[i])
        if count >= max_count:
            index_sec = index_max
            index_max = i
            max_count = count
            sec_count = max_count
        elif sec_count < count < max_count:
            sec_count = count
            index_sec = i
    return index_max, index_sec


def threshold(hist) -> int:
    """T of one histogram: the two indices' sum halved, truncated toward
    zero as C's integer division does, clamped to [50, 200]."""
    index_max, index_sec = top2_scan(hist)
    total = index_max + index_sec
    t = total // 2 if total >= 0 else -((-total) // 2)
    return min(T_MAX, max(T_MIN, t))


class Step(reference.Step):
    outputs = ("aux",)

    def __init__(self, stream: Dict, text: str):
        if int(stream["visualizer"]) != BINARIZE:
            raise ValueError("this reference works out visualizer 5 only")
        super().__init__(stream, text)

    def prepare(self, raw: np.ndarray) -> int:
        """T of one camera frame, from the gray histogram of the whole
        frame that the diff reads."""
        g = gray(self.frame_rows(raw, 0, self.height))
        return threshold(np.bincount(g, minlength=BINS))

    def aux_rows(self, cur_rows: np.ndarray, prev_rows: np.ndarray,
                 r0: int, r1: int, ctx: int) -> np.ndarray:
        on = np.where(gray(cur_rows) > ctx, 255, 0).astype(np.uint8)
        return np.repeat(on, 3)
