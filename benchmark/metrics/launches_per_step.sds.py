"""Device operations (kernels, copies, sets) a step, from the profiler."""


def read(rec):
    s = rec.summary
    if s is None or rec.unit != "sds_step" or not rec.units:
        return None
    return s.launches / rec.units
