"""``idle_pct``: the share of the traced slice, from its first device
record's start to its last one's end, in which the card ran no kernel,
memset or copy."""


def read(s):
    if not s.records or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
