"""``k8_roofline``: the noise filter's least time a camera frame, by
bytes or by int32 multiply-adds, whichever bounds it
(``roofline.filter_least_s``), over K8's kernel time a camera frame in
the traced slice."""

from cvsbench import roofline

KERNELS = ("conv_kernel",)


def read(s):
    recs = s.of(KERNELS)
    if not recs or not s.stream.get("noise_filter"):
        return None
    least_s = roofline.filter_least_s(s.frame_bytes, int(s.stream["conv_k"]))
    return roofline.share_pct(least_s, s.seconds_per_frame(recs))
