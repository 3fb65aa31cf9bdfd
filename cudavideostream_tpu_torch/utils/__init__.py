"""Host utilities: the glyph fonts of the text overlay, frame geometry,
the PNG writer, and the timing and profiling harness."""

from cudavideostream_tpu_torch.utils.shapes import MatSize
from cudavideostream_tpu_torch.utils.timing import Timer, bench_op

__all__ = ["MatSize", "Timer", "bench_op"]
