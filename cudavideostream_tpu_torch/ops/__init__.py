"""Device operators (PyTorch and hand-written CUDA kernels) and their golden CPU reference."""


def kernel_sources():
    """The binding table (``kernels.launch.Source``) of every
    ``csrc/*.cu`` library, one a source, from the ops module that launches
    it."""
    from cudavideostream_tpu_torch.ops import (
        convolve,
        diff,
        filters,
        hist,
        logcompact,
        overlay,
        register_compact,
    )

    return (logcompact.SOURCE, logcompact.PAIR_SOURCE,
            logcompact.SEGMENT_SOURCE, register_compact.SOURCE, hist.SOURCE,
            hist.PROBE_SOURCE, convolve.SOURCE, filters.BINARIZE_SOURCE,
            diff.SOURCE, filters.VISUALIZE_SOURCE, overlay.SOURCE)
