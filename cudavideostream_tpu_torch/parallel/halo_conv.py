"""Row-sharded KxK convolution with an explicit halo exchange (the
counterpart of the JAX package's ``parallel/halo_conv.py``).

Each of the S space shards holds ``H/S`` image rows of a frame, on its
own device. Before the same Q16 stencil runs on each shard, every shard
receives ``K//2`` boundary rows from each row neighbour: the JAX
package's ``ppermute`` of the boundary strips becomes a copy of each
strip to the neighbour's device (``t.to(dev)``, a no-op where both shards
share a device, so one code path serves one card and several). The edge
shards get zero rows, the reference's zero padding at the image border.
The exchange moves the shards' uint8 rows (the JAX package's moves int32
ones), and each shard's stencil is one launch of K8
(:func:`~cudavideostream_tpu_torch.ops.convolve.convolve_q16_halo`),
which pads horizontally itself; on CPU tensors its plain version.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from cudavideostream_tpu_torch.ops.convolve import convolve_q16_halo


def halo_exchange_rows(shards: Sequence[torch.Tensor],
                       pad: int) -> List[torch.Tensor]:
    """Every shard's ``(rows, row_bytes)`` block with ``pad`` rows of each
    neighbour around it: ``(rows + 2*pad, row_bytes)``, on the shard's
    device. The first shard's top and the last shard's bottom are zeros.
    A halo deeper than a shard would need rows from two shards away, and
    raises."""
    if pad == 0:
        return list(shards)
    rows = shards[0].shape[0]
    if pad > rows:
        raise ValueError(
            f"conv halo of {pad} rows exceeds the {rows}-row shard — a halo "
            f"may only reach the adjacent shard; use fewer shards or a "
            f"smaller conv_k")
    out = []
    for s, local in enumerate(shards):
        dev = local.device
        zero = local.new_zeros((pad,) + tuple(local.shape[1:]))
        top = shards[s - 1][-pad:].to(dev) if s > 0 else zero
        bot = shards[s + 1][:pad].to(dev) if s + 1 < len(shards) else zero
        out.append(torch.cat([top, local, bot]))
    return out


def sharded_convolve_q16(local_frames: Sequence[torch.Tensor],
                         weights_q16: np.ndarray, local_rows: int,
                         width: int) -> List[torch.Tensor]:
    """Each shard's flat ``(local_rows * width * 3,)`` uint8 rows ->
    its convolved rows, as the solo ``convolve_q16`` of the whole frame
    gives them. Byte-space ``(rows, W*3)`` views; a pixel's horizontal
    neighbour is 3 bytes away, and the horizontal zero padding is
    shard-local."""
    pad = weights_q16.shape[0] // 2
    imgs = [f.reshape(local_rows, width * 3) for f in local_frames]
    return [convolve_q16_halo(img, weights_q16, local_rows, width)
            for img in halo_exchange_rows(imgs, pad)]
