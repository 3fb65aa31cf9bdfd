"""``device_ops_per_frame``: the kernel, memset and copy records of the
traced slice over the camera frames it stepped."""


def read(s):
    if not s.records:
        return None
    return len(s.records) / s.frames
