"""Multi-device parallelism (the counterpart of the JAX package's
``parallel/``): the pipeline step over a ``(data, space)`` mesh of
devices, streams sharded over ``data`` and each frame's rows over
``space``, driven by one process (single-process multi-device).

* :func:`make_mesh` — the ``(data, space)`` device grid (``mesh.py``);
* :class:`ShardedDeltaPipeline` — the sharded step, each shard compacting
  its rows with K1's ``index_offset`` mode (``sharded.py``);
* ``halo_conv`` — the noise filter's halo rows exchanged between row
  neighbours.
"""

from cudavideostream_tpu_torch.parallel.mesh import Mesh, make_mesh
from cudavideostream_tpu_torch.parallel.sharded import ShardedDeltaPipeline

__all__ = ["Mesh", "make_mesh", "ShardedDeltaPipeline"]
