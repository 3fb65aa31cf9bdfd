"""Build the port's native host library.

``python -m cudavideostream_tpu_torch.native.build``
"""

import sys

from cudavideostream_tpu_torch import native

if __name__ == "__main__":
    try:
        path = native.build()
    except RuntimeError as e:
        print(f"FAILED to build: {e}", file=sys.stderr)
        sys.exit(1)
    print(f"built {path}")
