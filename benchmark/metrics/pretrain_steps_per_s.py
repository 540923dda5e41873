"""DVGO pretraining steps completed in the window over its seconds (the
window ends in a device synchronize)."""


def read(rec):
    return rec.units / rec.seconds if rec.unit == "pretrain_step" else None
