"""Frame sources: where frames come from (port of the JAX package's
``runtime/sources.py``, synthetic source only).

The reference captures via OpenCV/V4L2 on a dedicated pthread feeding a
pipe-based ring (``threads.cpp:166-179``). Here a source is a simple
iterator protocol the executor pulls from. :class:`SyntheticSource` uses
NumPy with the same seed semantics as the JAX package's, so both packages
see identical frames. File and camera sources are not ported yet
(``ROADMAP.md`` M16).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from cudavideostream_tpu_torch.config import StreamConfig

# SyntheticSource's scene: sensor noise amplitude (below the default diff
# threshold), the moving square's side and its speed in pixels per frame.
# The JAX package's defaults, so both packages draw identical frames.
NOISE = 10
OBJECT_SIZE = 200
SPEED = 12


class FrameSource:
    """Iterator protocol: ``__next__`` returns a flat uint8 frame."""

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:  # pragma: no cover - interface
        raise NotImplementedError

    def base_frame(self) -> np.ndarray:
        """First frame, used for the base-frame handshake."""
        return next(self)


class SyntheticSource(FrameSource):
    """Procedural scene: static textured background + per-frame sensor
    noise below the diff threshold + a moving bright rectangle above it.

    Calibrated so the changed-byte rate is in the ballpark of the
    reference's measured 5.93% (report.tex:2594).
    """

    def __init__(self, config: StreamConfig, seed: int = 0):
        self.cfg = config
        self.rng = np.random.default_rng(seed)
        self.t = 0
        self.background = self.rng.integers(
            0, 255, config.frame_bytes, endpoint=True, dtype=np.uint8
        )

    def __next__(self) -> np.ndarray:
        cfg = self.cfg
        img = self.background.reshape(cfg.height, cfg.width, 3).astype(np.int16)
        img = img + self.rng.integers(
            -NOISE, NOISE, img.shape, endpoint=True, dtype=np.int16
        )
        s = max(1, min(OBJECT_SIZE, cfg.height // 2, cfg.width // 2))
        y = (self.t * SPEED) % max(1, cfg.height - s)
        x = (self.t * SPEED * 2) % max(1, cfg.width - s)
        img[y : y + s, x : x + s] = 255
        self.t += 1
        return np.clip(img, 0, 255).astype(np.uint8).ravel()


def make_source(kind: str, config: StreamConfig, seed: int = 0) -> FrameSource:
    if kind == "synthetic":
        return SyntheticSource(config, seed=seed)
    if kind in ("file", "v4l2"):
        raise NotImplementedError(
            f"the {kind} source is not ported to cudavideostream_tpu_torch "
            "yet: see ROADMAP.md M16"
        )
    raise ValueError(f"unknown source kind {kind!r}")
