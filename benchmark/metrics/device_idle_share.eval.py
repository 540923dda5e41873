"""Share of the traced stretch in which no kernel, copy or set ran on the
device: 100 (1 - busy / window)."""


def read(rec):
    s = rec.summary
    if s is None or s.window_s <= 0 or s.launches == 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
