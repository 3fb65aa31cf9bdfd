"""The benchmark of ``cudavideostream_tpu_torch``, the PyTorch and CUDA
port, on one NVIDIA H100: ``python3 -m cvsbench.run --workload CELL
--seed N --seconds S --trace 0|1`` (see ``README.md``).

Importing this package imports nothing else: ``run`` times set-up from
its own first line.
"""
