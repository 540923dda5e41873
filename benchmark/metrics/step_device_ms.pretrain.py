"""Device milliseconds a pretraining step: the device's busy time over
the traced stretch's steps."""


def read(rec):
    s = rec.summary
    if s is None or rec.unit != "pretrain_step" or not rec.units:
        return None
    return 1e3 * s.busy_s / rec.units
