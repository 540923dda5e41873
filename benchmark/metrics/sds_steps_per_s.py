"""SDS steps completed in the window over the window's seconds (the
window ends in a device synchronize)."""


def read(rec):
    return rec.units / rec.seconds if rec.unit == "sds_step" else None
