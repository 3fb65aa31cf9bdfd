"""``step_roofline``: the least bytes a camera frame's step must move
(``roofline.step_least_bytes``, with the aux frame where the
configuration has a visualizer) at the HBM rate, over the device's busy
time a camera frame in the traced slice."""

from cvsbench import roofline


def read(s):
    if not s.records or s.busy_s <= 0:
        return None
    aux = s.stream.get("visualizer", 0) != 0
    least_s = roofline.step_least_bytes(s.frame_bytes, s.pos_mean, aux) \
        / roofline.HBM_BYTES_PER_S
    return roofline.share_pct(least_s, s.busy_s / s.frames)
