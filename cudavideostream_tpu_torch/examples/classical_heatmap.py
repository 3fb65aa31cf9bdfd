"""Classical-CV motion-heatmap baseline vs the delta-mask heatmap (the
port of the JAX package's ``examples/classical_heatmap.py``, through the
port's copies of ``reference_cpu`` and ``png``; the same bytes).

The reference keeps a classical comparison point for its heatmap
feature: MOG2 background subtraction, binary threshold, accumulation,
HOT colormap, 50/50 blend over the first frame
(``tests/motion-heatmap-cpp/motion_heatmap.cpp:1-124``). This example
reproduces that pipeline in NumPy (the background model is the
single-Gaussian core of MOG2: per-pixel running mean/variance,
foreground when the squared deviation exceeds ``k^2 * var``, model
updated with learning rate ``alpha``) and runs it side by side with the
delta-mask accumulation (the changed-pixel mask from
``ops/reference_cpu.step_oracle``, the byte-exact spec of the card's
pipeline) on the same synthetic scene.

It writes into ``--out``:

* ``classical_mog2_heatmap.png`` — the MOG2-style accumulation blended
  over the first frame (the reference's ``result_overlay_final.jpg``);
* ``delta_mask_heatmap.png``     — the same accumulation driven by the
  delta pipeline's changed-pixel mask.

    python -m cudavideostream_tpu_torch.examples.classical_heatmap \
        [--out build/examples/artifacts] [--frames 48]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from cudavideostream_tpu_torch.config import StreamConfig
from cudavideostream_tpu_torch.examples.make_artifacts import (
    DEFAULT_OUT,
    demo_scene,
)
from cudavideostream_tpu_torch.ops import reference_cpu as ref
from cudavideostream_tpu_torch.utils.png import write_png

N_FRAMES = 48


def hot_colormap(v: np.ndarray) -> np.ndarray:
    """COLORMAP_HOT on uint8 input -> BGR uint8 (black->red->yellow->white),
    the map the reference applies to its accumulation."""
    t = v.astype(np.float32) / 255.0
    r = np.clip(t * 3.0, 0, 1)
    g = np.clip(t * 3.0 - 1.0, 0, 1)
    b = np.clip(t * 3.0 - 2.0, 0, 1)
    return (np.stack([b, g, r], axis=-1) * 255).astype(np.uint8)


def bgr_to_gray(frame: np.ndarray) -> np.ndarray:
    b, g, r = frame[..., 0], frame[..., 1], frame[..., 2]
    return (0.114 * b + 0.587 * g + 0.299 * r).astype(np.float32)


class RunningGaussianBackground:
    """Single-Gaussian per-pixel background model (the core of MOG2)."""

    def __init__(self, first_gray: np.ndarray, alpha: float = 0.02,
                 k: float = 2.5, var_init: float = 15.0 ** 2):
        self.mean = first_gray.astype(np.float32)
        self.var = np.full_like(self.mean, var_init)
        self.alpha = alpha
        self.k2 = k * k

    def apply(self, gray: np.ndarray) -> np.ndarray:
        d2 = (gray - self.mean) ** 2
        fg = d2 > self.k2 * self.var
        # background pixels update the model; foreground is held out,
        # like MOG2's per-component ownership update
        a = np.where(fg, 0.0, self.alpha).astype(np.float32)
        self.mean += a * (gray - self.mean)
        self.var += a * (d2 - self.var)
        self.var = np.maximum(self.var, 4.0)
        return fg


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--frames", type=int, default=N_FRAMES)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    cfg = StreamConfig(height=270, width=480)
    rng = np.random.default_rng(3)
    h, w = cfg.height, cfg.width

    first = demo_scene(cfg, 0, rng).reshape(h, w, 3)
    gray0 = bgr_to_gray(first)
    mog = RunningGaussianBackground(gray0)
    accum_mog = np.zeros((h, w), np.float32)
    accum_delta = np.zeros((h, w), np.float32)

    prev = first.reshape(-1).copy()
    for t in range(1, args.frames):
        frame = demo_scene(cfg, t, rng).reshape(h, w, 3)

        # classical: background-subtract the gray frame, threshold,
        # accumulate (+2 per hit, the reference's maxValue=2)
        fg = mog.apply(bgr_to_gray(frame))
        accum_mog += 2.0 * fg

        # delta pipeline: the changed-pixel mask is a by-product of the
        # encode step (any of the pixel's three byte-deltas shipped)
        flat = frame.reshape(-1)
        new_prev, pos, xs, vals, _ = ref.step_oracle(prev, flat, cfg)
        mask = np.zeros(cfg.frame_bytes, bool)
        mask[xs] = True
        changed_px = mask.reshape(h, w, 3).any(axis=2)
        accum_delta += 2.0 * changed_px
        prev = new_prev

    for name, accum in (("classical_mog2_heatmap", accum_mog),
                        ("delta_mask_heatmap", accum_delta)):
        color = hot_colormap(np.clip(accum, 0, 255).astype(np.uint8))
        overlay = ((first.astype(np.float32) + color.astype(np.float32)) / 2
                   ).astype(np.uint8)
        rgb = overlay[..., ::-1]  # BGR -> RGB for PNG
        path = os.path.join(args.out, f"{name}.png")
        write_png(path, rgb)
        print(f"wrote {path}  (trail pixels: {(accum > 0).sum()})")

    # the two trails must agree on where motion happened
    inter = ((accum_mog > 0) & (accum_delta > 0)).sum()
    union = ((accum_mog > 0) | (accum_delta > 0)).sum()
    print(f"trail IoU classical vs delta-mask: {inter / union:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
