"""``k9_roofline``: the least bytes of the binarize visualizer a camera
frame, one read of the frame and one write of the aux frame (2n), at the
HBM rate, over K9's kernel time a camera frame in the traced slice. The
count is K9's own, so it lives here and not in ``roofline.py``."""

from cvsbench import roofline

BINARIZE = 5
# K9's kernels: the solo and batched fused launch, and the sharded path's
# two launches a shard
KERNELS = ("binarize_fused_kernel", "binarize_gray_kernel",
           "binarize_apply_kernel")


def read(s):
    recs = s.of(KERNELS)
    if not recs or int(s.stream.get("visualizer", 0)) != BINARIZE:
        return None
    least_s = 2 * s.frame_bytes / roofline.HBM_BYTES_PER_S
    return roofline.share_pct(least_s, s.seconds_per_frame(recs))
