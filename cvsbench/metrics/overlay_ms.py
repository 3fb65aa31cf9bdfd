"""``overlay_ms``: device milliseconds a camera frame in the traced
slice's records that the step's ``cvs.overlay`` span launched (the
slice's ``stages``, labelled by ``cvsbench.stages``); None where the
slice has no stage labels."""

STAGE = "cvs.overlay"


def read(s):
    stages = getattr(s, "stages", None)
    if not stages:
        return None
    return 1e3 * s.seconds_per_frame(
        r for r, st in zip(s.records, stages) if st == STAGE)
