"""Library-API walkthrough: every model variant over a synthetic scene
(the port of the JAX package's ``examples/stream_demo.py``).

Runs each named pipeline variant for a few frames through
``DeltaStreamPipeline``, prints payload sizes and aux-frame stats, and
dumps a viewable PPM of each aux frame and of the reconstruction. It
runs on the card unless given ``--device cpu``.

    python -m cudavideostream_tpu_torch.examples.stream_demo \
        [--height 256 --width 384] [--out build/examples/demo]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "examples" / "demo"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--device", default=None,
                   help="cpu: the plain PyTorch versions (default: the card)")
    args = p.parse_args(argv)

    from cudavideostream_tpu_torch.models import DeltaStreamPipeline
    from cudavideostream_tpu_torch.models.variants import (
        available,
        get_config,
    )
    from cudavideostream_tpu_torch.runtime.client import write_ppm
    from cudavideostream_tpu_torch.runtime.sources import SyntheticSource

    os.makedirs(args.out, exist_ok=True)
    for name in available():
        cfg = get_config(name, height=args.height, width=args.width)
        pipe = DeltaStreamPipeline(cfg, device=args.device)
        src = SyntheticSource(cfg, seed=4)
        state = pipe.init_state(src.base_frame())
        total_payload = 0
        aux = None
        for t in range(args.frames):
            out = pipe.step(state, next(src), text=f"FPS: {30+t}")
            state, pos, aux = out[0], out[1], out[-1]
            total_payload += 4 + 5 * int(pos)
        dense = args.frames * cfg.frame_bytes
        line = (f"{name:16s} payload {total_payload/1024:8.1f} KiB "
                f"({100*total_payload/dense:5.2f}% of dense)")
        if aux is not None:
            aux_np = aux.cpu().numpy()
            line += f"   aux mean {aux_np.mean():6.1f}"
            write_ppm(os.path.join(args.out, f"{name}_aux.ppm"),
                      aux_np, cfg.height, cfg.width)
        print(line)
    # the reconstruction itself, viewable
    write_ppm(os.path.join(args.out, "reconstruction.ppm"),
              state.cpu().numpy(), cfg.height, cfg.width)
    print(f"viewable PPM dumps in {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
