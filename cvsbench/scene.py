"""The one traffic generator: a bank of camera frames made on the device
from ``--seed`` and a traffic file's parameters (``traffic/<name>.json``).

Each stream's scene is a copy of the port's own synthetic arithmetic:

* a background of uniform random bytes, one per stream;
* a subject band of ``band_share`` of the frame's bytes, which starts at a
  phase drawn from the seed for each stream, drifts ``band_stride_bytes``
  a frame and adds ``band_deltas[t % len(band_deltas)]`` mod 256 to the
  background (``loopback_sweep.DeviceClusteredSource``);
* on top of it, sensor noise of ``+-noise_amplitude`` on every byte of
  every frame, clipped to 0-255 (``runtime/sources.device_synthetic_frames``).

The bank holds ``bank_frames`` frames a stream, which the benchmark steps
through as a cycle; the base frame (each stream's background) is the
state the program starts from. The same seed gives the same bank on the
same kind of device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def band_bytes(traffic: Dict, n: int) -> int:
    return max(1, min(n - 1, round(traffic["band_share"] * n)))


def make_bank(traffic: Dict, height: int, width: int, seed: int,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(bank, base)``: ``bank`` uint8 ``(T, B, n)`` and ``base`` uint8
    ``(B, n)`` on ``device``, with ``T = bank_frames``, ``B = streams`` and
    ``n`` a frame's bytes."""
    n = height * width * 3
    streams, frames = int(traffic["streams"]), int(traffic["bank_frames"])
    seed = int(seed) % (1 << 63)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    base = torch.randint(0, 256, (streams, n), generator=gen, device=device,
                         dtype=torch.uint8)
    band = band_bytes(traffic, n)
    span = n - band
    phases = np.random.default_rng(seed).integers(0, span, streams)
    stride = int(traffic["band_stride_bytes"])
    deltas = [int(d) for d in traffic["band_deltas"]]
    amp = int(traffic["noise_amplitude"])
    bank = torch.empty((frames, streams, n), dtype=torch.uint8, device=device)
    scene = torch.empty((streams, n), dtype=torch.int16, device=device)
    noise = torch.empty((streams, n), dtype=torch.int16, device=device)
    for t in range(frames):
        scene.copy_(base)
        for b in range(streams):
            start = (int(phases[b]) + t * stride) % span
            part = scene[b, start:start + band]
            part.add_(deltas[t % len(deltas)]).remainder_(256)
        noise.random_(0, 2 * amp + 1, generator=gen)
        scene.add_(noise).sub_(amp).clamp_(0, 255)
        bank[t].copy_(scene)
    return bank, base
