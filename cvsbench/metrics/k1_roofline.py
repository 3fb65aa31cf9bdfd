"""``k1_roofline``: K1's least bytes a camera frame, the step's own
(``roofline.step_least_bytes``), at the HBM rate, over K1's kernel time a
camera frame in the traced slice."""

from cvsbench import roofline

# K1's kernels: the tiled and batched emission (one kernel, or two for
# units larger than a tile) and the flat emission
KERNELS = ("tiled_unit_kernel", "tiled_chunk_count_kernel",
           "tiled_chunk_compact_kernel", "flat_lookback_kernel")


def read(s):
    recs = s.of(KERNELS)
    if not recs:
        return None
    least_s = roofline.step_least_bytes(s.frame_bytes, s.pos_mean) \
        / roofline.HBM_BYTES_PER_S
    return roofline.share_pct(least_s, s.seconds_per_frame(recs))
