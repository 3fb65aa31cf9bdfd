"""One reader a per-layer metric: ``metrics/<name>.py`` defines
``read(slice) -> float | None`` over a :class:`cvsbench.trace.Slice`,
and the harness finds it by the metric's name in ``BENCHMARK.json``."""

# The port's own hand-written kernels (``cudavideostream_tpu_torch/csrc``),
# by the base name the profiler gives them.
PORT_KERNELS = (
    "tiled_unit_kernel", "tiled_chunk_count_kernel",
    "tiled_chunk_compact_kernel", "flat_lookback_kernel",       # K1
    "pair_lookback_kernel", "vals_lookback_kernel",             # K2, K3
    "hist_kernel",                                              # K4
    "segment_kernel", "register_kernel", "probe_kernel",        # K5-K7
    "conv_kernel",                                              # K8
    "binarize_fused_kernel", "binarize_gray_kernel",
    "binarize_apply_kernel",                                    # K9
    "diff_pack_kernel",                                         # K10
    "heat_kernel", "red_kernel", "vis_kernel",                  # K11-K13
)
