"""Runtime configuration of the delta-streaming framework (PyTorch port).

A copy of the JAX package's ``config.py``: the same frozen dataclass, the
same fields and the same validation, so a configuration means the same
thing in both packages. The reference system
(``server/include/common.h:1-20``) uses compile-time ``#define``s: frame
geometry 1920x1080 BGR24 (``kernels.cu:107-133``), ``LR_THRESHOLDS 20``,
``K 3`` conv kernel, the ``NOISE_VISUALIZER`` mode select, and the
``127.0.0.1:2734`` endpoint (``threads.cpp:187``, ``client/opencv.cpp:23``).

Every field selects work the port runs; ``pair_lanes`` is a TPU lane
layout with identical outputs, and a no-op here.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class Visualizer(enum.Enum):
    """Auxiliary-output mode, mirroring ``NOISE_VISUALIZER`` (common.h:10-11).

    ``NONE`` disables the aux frame; the numbered modes match the reference:
    1 heatmap, 2 red-black, 3 red-overlap, 4 grayscale, 5 binarization.
    """

    NONE = 0
    HEATMAP = 1
    RED_BLACK = 2
    RED_OVERLAP = 3
    GRAYSCALE = 4
    BINARIZE = 5


class CompactionBackend(enum.Enum):
    """How the sparse (pos, xs, vals) payload is produced.

    The reference compacts with ``atomicInc`` on the GPU
    (``kernels.cu:313-315``), which is nondeterministic in output order.
    All backends here are deterministic (ascending byte index), which the
    reference client is insensitive to (pure scatter-add,
    ``client/opencv.cpp:64-66``).
    """

    SORT = "sort"          # one sort over packed (idx, val) keys
    PALLAS = "pallas"      # the fused diff+compact kernel (K1)
    HOST = "host"          # device emits dense delta + bitmask; host packs


class PayloadOverflowError(RuntimeError):
    """A frame changed more bytes than ``payload_capacity`` allows.

    ``payload_capacity`` is an explicit opt-in memory bound (the default,
    None, is the worst case and can never overflow — the reference's
    ``atomicInc`` bound of 6220801, kernels.cu:313). Exceeding it cannot
    be silently truncated: dropped deltas would already be absorbed into
    the server's previous-frame state, so a v1 client would diverge
    permanently. Raise ``payload_capacity`` (or leave it None).

    Raisers that already hold the post-step previous-frame state attach
    it as ``state``.
    """

    def __init__(self, msg: str, state=None):
        super().__init__(msg)
        self.state = state


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static configuration of the delta-stream pipeline.

    Defaults replicate the reference's shipped build: 1080p BGR24, threshold
    20, negative feedback on, no noise filter, no visualizer.
    """

    height: int = 1080
    width: int = 1920
    channels: int = 3

    # |delta| must be strictly greater than this to ship (kernels.cu:312).
    threshold: int = 20
    # Sub-threshold drift accumulates in the previous-frame buffer
    # (KERNEL2_NEGFEED_OPT, common.h:16, kernels.cu:318-323).
    negative_feedback: bool = True

    # Gaussian denoise convolution in the delta path (common.h:5-8,
    # kernels.cu:457-459). K is the kernel size; sigma defaults to the
    # reference's K*K/6 (server.cpp:43).
    noise_filter: bool = False
    conv_k: int = 3

    visualizer: Visualizer = Visualizer.NONE

    compaction: CompactionBackend = CompactionBackend.PALLAS
    # Payload capacity in bytes; None means worst case (= frame_bytes),
    # matching the reference's atomicInc bound of 6220801 (kernels.cu:313).
    # A frame that changes more bytes raises PayloadOverflowError (never
    # a silent truncation — that desyncs clients permanently).
    payload_capacity: int | None = None
    # Hand the payload to the host as per-unit compacted blocks + counts
    # instead of one merged flat array (the tiled emission).
    tiled_payload: bool = False
    # How the executor lands a tiled payload on the host: "tiles",
    # "flat", "mask" or "auto" (tiled_payload only).
    fetch_mode: str = "auto"
    # Compaction unit of the tiled emission, in 128-byte rows
    # (0 = one unit per kernel tile). Wire bytes are identical at any
    # granularity.
    subtile_rows: int = 1
    # Pair-packed lane layout of the TPU kernel (subtile_rows == 1 only);
    # identical outputs, a TPU layout choice.
    pair_lanes: bool = True
    # Emit a packed LSB-first change-bitmask (n/8 bytes) alongside the
    # tiled payload. tiled_payload only.
    emit_bitmask: bool = False
    # Return "mask"-flavor landings as the raw bits window
    # (wire v4's winmask mode). Requires emit_bitmask.
    mask_payload: bool = False
    # Bitmask-only kernel emission: no index blocks, the change-bits
    # packed in the kernel; indices are rebuilt exactly from the bits.
    # Requires emit_bitmask + fetch_mode="mask".
    maskonly_payload: bool = False

    # Text overlay (kernel2_char, kernels.cu:351-375): glyph cell scale,
    # and font style — "stroke" is a thin vector font in the visual
    # family of the reference's FONT_HERSHEY_PLAIN (threads.cpp:47);
    # "bitmap" is the embedded 5x7 pixel font.
    overlay_scale: int = 5
    overlay_font: str = "stroke"

    # TCP endpoint (threads.cpp:187).
    host: str = "127.0.0.1"
    port: int = 2734
    # Wire format: "v1" is the reference-compatible contract (default);
    # "v2" delta16 index gaps, "v3" adaptive delta16/bitmask/raw, "v4"
    # adds the window bitmask mode. v2/v3/v4 need both ends to opt in.
    wire_format: str = "v1"

    @property
    def frame_shape(self) -> Tuple[int, int, int]:
        return (self.height, self.width, self.channels)

    @property
    def frame_bytes(self) -> int:
        return self.height * self.width * self.channels

    @property
    def capacity(self) -> int:
        cap = self.payload_capacity
        return self.frame_bytes if cap is None else cap

    def __post_init__(self):
        if self.channels != 3:
            raise ValueError("only 3-channel BGR frames are supported")
        if not (0 <= self.threshold <= 255):
            raise ValueError("threshold must be in [0, 255]")
        if self.conv_k < 1 or self.conv_k > 15:
            raise ValueError("conv_k out of supported range")
        if self.payload_capacity is not None and self.payload_capacity < 1:
            raise ValueError("payload_capacity must be positive (None = "
                             "worst case)")
        if self.overlay_scale < 1:
            raise ValueError("overlay_scale must be >= 1")
        if self.overlay_font not in ("stroke", "bitmap"):
            raise ValueError(f"unknown overlay_font {self.overlay_font!r}")
        if self.tiled_payload:
            if self.compaction is not CompactionBackend.PALLAS:
                raise ValueError("tiled_payload requires the PALLAS backend")
            if self.payload_capacity is not None:
                raise ValueError("tiled_payload is always worst-case capacity")
        if self.wire_format not in ("v1", "v2", "v3", "v4"):
            raise ValueError(f"unknown wire_format {self.wire_format!r}")
        if self.fetch_mode not in ("auto", "tiles", "flat", "mask"):
            raise ValueError(f"unknown fetch_mode {self.fetch_mode!r}")
        if self.fetch_mode != "auto" and not self.tiled_payload:
            raise ValueError(
                "fetch_mode tiles/flat/mask applies to tiled_payload"
            )
        if self.fetch_mode == "mask" and not self.emit_bitmask:
            raise ValueError("fetch_mode 'mask' requires emit_bitmask")
        if self.emit_bitmask and not self.tiled_payload:
            raise ValueError("emit_bitmask requires tiled_payload")
        if self.mask_payload and not self.emit_bitmask:
            raise ValueError("mask_payload requires emit_bitmask")
        if self.maskonly_payload:
            if not self.emit_bitmask:
                raise ValueError("maskonly_payload requires emit_bitmask")
            if self.fetch_mode != "mask":
                raise ValueError(
                    "maskonly_payload requires fetch_mode='mask' (the "
                    "tiles/flat fetch flavors need the index blocks "
                    "this emission deletes)"
                )
        if self.subtile_rows < 0 or (
            self.subtile_rows & (self.subtile_rows - 1)
        ):
            raise ValueError("subtile_rows must be 0 or a power of two")


DEFAULT_CONFIG = StreamConfig()
