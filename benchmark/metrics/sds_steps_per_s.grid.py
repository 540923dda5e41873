"""sds_steps_per_s, read in a traced run: the SDS steps of its timed
window (run before the profiled stretch, with no profiler) over the
window's seconds, ending in a device synchronize."""


def read(rec):
    if rec.unit != "sds_step" or not rec.window_seconds:
        return None
    return rec.window_units / rec.window_seconds
