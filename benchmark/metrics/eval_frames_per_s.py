"""Orbit frames rendered and written in the window over its seconds (the
window ends in a device synchronize)."""


def read(rec):
    return rec.units / rec.seconds if rec.unit == "frame" else None
