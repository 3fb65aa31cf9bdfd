"""Pipeline models: configured end-to-end frame processors."""

from cudavideostream_tpu_torch.models.batched import (
    BatchedDeltaPipeline,
    from_jax_batched,
)
from cudavideostream_tpu_torch.models.pipeline import (
    DeltaStreamPipeline,
    from_jax_sharded,
)

__all__ = ["DeltaStreamPipeline", "BatchedDeltaPipeline", "from_jax_batched",
           "from_jax_sharded"]
