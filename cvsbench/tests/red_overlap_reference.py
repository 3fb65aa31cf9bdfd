"""A plain NumPy reference of visualizer 3, red overlap (``NOISE_VISUALIZER``
3, ``server/include/common.h:10-11``), for the tests of the check's side
outputs: a configuration names it as ``"reference":
"cvsbench.tests.red_overlap_reference"``.

The aux frame is the state as it was before the step, with R (the third
byte of a BGR pixel) set to 255 on every pixel of which any byte has
``|cur - prev| > threshold`` on the overlaid (and filtered) frame. The
overlay, the filter and the diff are those of :mod:`cvsbench.reference`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from cvsbench import reference

RED_OVERLAP = 3


class Step(reference.Step):
    outputs = ("aux",)

    def __init__(self, stream: Dict, text: str):
        if int(stream["visualizer"]) != RED_OVERLAP:
            raise ValueError("this reference works out visualizer 3 only")
        super().__init__(stream, text)

    def aux_rows(self, cur_rows: np.ndarray, prev_rows: np.ndarray,
                 r0: int, r1: int, ctx) -> np.ndarray:
        changed = (reference.absdiff(cur_rows, prev_rows)
                   > self.threshold).reshape(-1, 3).any(axis=1)
        out = prev_rows.reshape(-1, 3).copy()
        out[changed, 2] = 255
        return out.reshape(-1)
