"""Device meshes (the counterpart of the JAX package's
``parallel/mesh.py``).

A :class:`Mesh` is a ``(data, space)`` grid of ``torch.device``\\ s: one
process drives every shard, each shard's tensors live on its own device,
and the step launches each shard's work there (single-process
multi-device, the PyTorch idiom for the JAX package's single-controller
``shard_map``). A grid may name one device more than once: on the CPU
every shard is the CPU, and S shards can be laid on one card, where they
run one after another on its stream.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


class Mesh:
    """A ``(data, space)`` grid of devices; ``shape`` maps each axis name
    to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 axis_names: Sequence[str] = ("data", "space")):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                          for r in grid):
            raise ValueError("a mesh is a nonempty rectangular device grid")
        if len(axis_names) != 2:
            raise ValueError("a mesh has two axes, (data, space)")
        self.devices: List[List[torch.device]] = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (len(grid), len(grid[0]))))

    def device(self, d: int, s: int) -> torch.device:
        """The device of data row ``d``, space shard ``s``."""
        return self.devices[d][s]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data", "space"),
    data_parallel: int = 1,
    device=None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``(data, space)`` mesh over ``n_devices`` devices, ``data``
    sharding independent streams and ``space`` frame rows; with
    ``data_parallel=1`` it is one row of space shards.

    The devices are, in order of precedence:

    * ``devices``: an explicit list, which may repeat a device (the
      counterpart of the JAX tests' virtual CPU devices, and the way to
      lay S > 1 shards on one card); ``n_devices`` defaults to its length;
    * ``device="cpu"``: every shard on the CPU (``n_devices`` defaults to
      1);
    * by default the first ``n_devices`` visible CUDA devices (all of them
      by default). Without CUDA this raises, as every entry point of the
      port does; asking for more devices than are visible raises
      ``requested N devices, have M``.
    """
    if devices is not None:
        pool = [torch.device(d) for d in devices]
        n = len(pool) if n_devices is None else n_devices
    elif device is not None and torch.device(device).type == "cpu":
        n = 1 if n_devices is None else n_devices
        pool = [torch.device("cpu")] * n
    else:
        from cudavideostream_tpu_torch.models.pipeline import resolve_device

        resolve_device(device)  # raises without CUDA
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        n = len(pool) if n_devices is None else n_devices
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    if n > len(pool):
        raise ValueError(f"requested {n} devices, have {len(pool)}")
    if n % data_parallel:
        raise ValueError("n_devices must be divisible by data_parallel")
    per_row = n // data_parallel
    return Mesh([pool[r * per_row:(r + 1) * per_row]
                 for r in range(data_parallel)], axis_names)
