"""Serving executors over the sharded pipeline (the counterpart of the JAX
package's ``runtime/sharded_executor.py``): ``server --mesh 1,S`` serves
one stream whose state and compute are cut into S row shards, over the
same wire.

With the default ``"sharded"`` payload layout no payload moves between
devices: each shard compacts its rows with K1 tiled and its
``index_offset`` mode, so its unit blocks hold global indices, and the
host lands the blocks from the device that holds each shard. On a
``(1, 1)`` mesh the one shard's blocks are a solo tiled payload and land
through the solo executor's :class:`~.executor.TiledLander` in the
configured flavor (``auto`` by default, which may merge with K2); with
S > 1 the landing is pinned to ``tiles``, each shard's non-empty unit span
copied as int32 (:meth:`~.executor.TiledLander.land_shard_spans`). The
``"replicated"`` layout assembles the flat payload on the mesh's first
device instead, and lands its ``pos`` prefix.

:class:`PipelinedShardedExecutor` lands frame N-1 while frame N computes,
as the solo ``PipelinedExecutor`` does.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from cudavideostream_tpu_torch.config import StreamConfig
from cudavideostream_tpu_torch.parallel import make_mesh as _make_mesh
from cudavideostream_tpu_torch.parallel.sharded import ShardedDeltaPipeline
from cudavideostream_tpu_torch.runtime.executor import (
    ExecMetrics,
    TiledLander,
    _Copier,
    _Staged,
)


def make_mesh(n_data: int, n_space: int, device=None, devices=None):
    """A ``(data=n_data, space=n_space)`` mesh over the first ``n_data *
    n_space`` visible CUDA devices, or every shard on the CPU with
    ``device="cpu"`` (``parallel.make_mesh``; ``devices`` lays the shards
    on an explicit list, which may repeat a device)."""
    return _make_mesh(n_devices=n_data * n_space, data_parallel=n_data,
                      device=device, devices=devices)


class ShardedStreamExecutor:
    """Drives one stream through the sharded pipeline's flat step; the
    server's ``start`` / ``process`` / ``flush`` as in ``StreamExecutor``:
    ``process`` returns ``(pos, TiledPayload or flat payload, None, aux)``
    under the ``"sharded"`` layout, ``(pos, xs, vals, aux)`` under
    ``"replicated"``."""

    def __init__(self, config: StreamConfig, mesh=None,
                 payload_layout: str = "sharded",
                 threshold_map: Optional[np.ndarray] = None):
        if mesh is None:
            import torch

            mesh = make_mesh(1, max(1, torch.cuda.device_count()))
        if config.tiled_payload:
            raise ValueError(
                "tiled_payload is a single-chip emit mode; the sharded "
                "executor's analogue is payload_layout='sharded'")
        if mesh.shape["data"] != 1:
            raise ValueError(
                f"server --mesh serves one stream: data axis must be 1 "
                f"(got data={mesh.shape['data']}); use multiserve --mesh "
                f"D,S for multi-stream data sharding")
        self.cfg = config
        self.pipe = ShardedDeltaPipeline(config, mesh,
                                         payload_layout=payload_layout,
                                         threshold_map=threshold_map)
        self.payload_layout = payload_layout
        self._state = None
        mode = config.fetch_mode
        if payload_layout == "sharded" and self.pipe.n_space > 1:
            mode = "tiles"
        self._lander = TiledLander(mode)
        self._copier = _Copier(mesh.device(0, 0))
        self.metrics = ExecMetrics()

    @property
    def fetch_counts(self) -> dict:
        """Landings per flavor (the ``"sharded"`` layout; empty
        otherwise)."""
        return (self._lander.fetch_counts
                if self.payload_layout == "sharded" else {})

    def start(self, base_frame: np.ndarray) -> np.ndarray:
        base = np.asarray(base_frame, dtype=np.uint8).ravel()
        self._state = self.pipe.init_state_flat(base)
        return base

    def _dispatch(self, frame, text: str):
        if self._state is None:
            raise RuntimeError("call start(base_frame) first")
        t0 = time.perf_counter()
        out = self.pipe.step_flat(self._state, frame, text=text)
        self._state = out[0]
        return t0, _Staged(out[1:], 1)

    def process(self, frame: np.ndarray, text: str = ""):
        return self._land(*self._dispatch(frame, text))

    def _land(self, t0: float, staged: _Staged):
        sizes = staged.wait()[0]
        if self.payload_layout == "sharded":
            counts_d, xs_d, vals_d = staged.outs[:3]
            pos = int(sum(c.sum(dtype=np.int64) for c in sizes))
            if len(sizes) == 1:
                res = self._lander.land(
                    pos, sizes[0], (counts_d[0], xs_d[0], vals_d[0], None),
                    staged, self._copier)
            else:
                res = self._lander.land_shard_spans(
                    pos, list(zip(sizes, xs_d, vals_d)), staged,
                    self._copier)
            aux = self._copier.land_aux(staged)
            self.metrics.record(time.perf_counter() - t0, pos)
            if isinstance(res, tuple):
                return (pos, *res, aux)
            return pos, res, None, aux
        pos = int(sizes)
        xs_d, vals_d = staged.outs[1:3]
        xs, vals = self._copier.run_views(staged, [xs_d[:pos], vals_d[:pos]])
        self.metrics.record(time.perf_counter() - t0, pos)
        return pos, xs, vals, staged.aux_host

    def flush(self):
        return None


class PipelinedShardedExecutor(ShardedStreamExecutor):
    """One-frame-deep software pipeline over the sharded step: dispatch
    frame N, land frame N-1's payload while N computes. The output lags
    one frame; call :meth:`flush` after the last frame."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending = None

    def process(self, frame, text: str = ""):
        prev, self._pending = self._pending, self._dispatch(frame, text)
        return None if prev is None else self._land(*prev)

    def flush(self):
        prev, self._pending = self._pending, None
        return None if prev is None else self._land(*prev)
