"""cudavideostream_tpu_torch — the PyTorch/CUDA port of cudavideostream_tpu.

The same delta-streaming framework — thresholded per-byte frame deltas
with negative feedback, deterministic ascending compaction into a
``(pos, xs, vals)`` payload, a glyph text overlay, and the reference
client's TCP wire format — written in PyTorch for an NVIDIA H100, with
the JAX package's TPU kernels rewritten by hand for Hopper (``csrc/``).
Entry points run on the card unless the caller passes ``device="cpu"``,
which runs each kernel's plain PyTorch version.
"""

from cudavideostream_tpu_torch.config import (
    DEFAULT_CONFIG,
    CompactionBackend,
    StreamConfig,
    Visualizer,
)

__version__ = "0.1.0"

__all__ = [
    "StreamConfig",
    "Visualizer",
    "CompactionBackend",
    "DEFAULT_CONFIG",
    "__version__",
]
