"""``torch_ops_ms``: device milliseconds a camera frame in the ops that
are not the port's own kernels (``metrics.PORT_KERNELS``): the overlay's
gather and copies and the step's other PyTorch calls, with their
memsets and copies."""

from cvsbench.metrics import PORT_KERNELS


def read(s):
    own = {id(r) for r in s.of(PORT_KERNELS)}
    recs = [r for r in s.records if id(r) not in own]
    if not recs:
        return None
    return 1e3 * s.seconds_per_frame(recs)
