"""Named pipeline variants — the framework's "model families" (a copy
of the JAX package's ``models/variants.py`` over this package's
:class:`~cudavideostream_tpu_torch.config.StreamConfig`: the same eight
names build the same configurations).

The reference selects behavior by editing ``common.h`` and recompiling
(``NOISE_VISUALIZER`` 1-5, ``NOISE_FILTER``, CPU vs GPU). Here each
shipped combination is a named, constructible configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from cudavideostream_tpu_torch.config import StreamConfig, Visualizer

_REGISTRY: Dict[str, Callable[..., StreamConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def available() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str, **overrides) -> StreamConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown variant {name!r}; have {available()}")
    return dataclasses.replace(_REGISTRY[name](), **overrides)


@register("delta-stream")
def _delta():
    """The shipped reference build: plain diff streaming (common.h with
    everything commented out)."""
    return StreamConfig()


@register("delta-denoised")
def _denoised():
    """NOISE_FILTER build: Gaussian denoise in the delta path to cut
    bandwidth (kernels.cu:457-459; operating point report.tex:2697)."""
    return StreamConfig(noise_filter=True, conv_k=3)


@register("delta-maskonly")
def _maskonly():
    """Bitmask-only emission for mask/v4 serving: no int32 index blocks
    (they were half of the kernel's HBM writes at 1080p), change-bits
    packed in-kernel (ROADMAP M8)."""
    return StreamConfig(tiled_payload=True, fetch_mode="mask",
                        emit_bitmask=True, maskonly_payload=True)


@register("heatmap")
def _heatmap():
    """NOISE_VISUALIZER=1: motion heatmap aux stream."""
    return StreamConfig(visualizer=Visualizer.HEATMAP)


@register("red-black")
def _redblack():
    """NOISE_VISUALIZER=2: changed pixels red on black."""
    return StreamConfig(visualizer=Visualizer.RED_BLACK)


@register("red-overlap")
def _redoverlap():
    """NOISE_VISUALIZER=3: changed pixels red over the previous frame."""
    return StreamConfig(visualizer=Visualizer.RED_OVERLAP)


@register("grayscale")
def _grayscale():
    """NOISE_VISUALIZER=4: weighted grayscale aux stream."""
    return StreamConfig(visualizer=Visualizer.GRAYSCALE)


@register("binarize")
def _binarize():
    """NOISE_VISUALIZER=5: adaptive-threshold binarization aux stream."""
    return StreamConfig(visualizer=Visualizer.BINARIZE)
