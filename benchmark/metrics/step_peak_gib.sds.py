"""The allocation peak over the profiled stretch of SDS steps (a refresh
among them), in GiB: what is held plus a step's working set."""


def read(rec):
    if rec.unit != "sds_step" or not rec.stretch_peak_bytes:
        return None
    return rec.stretch_peak_bytes / 2 ** 30
