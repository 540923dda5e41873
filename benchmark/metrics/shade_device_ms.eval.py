"""Device milliseconds a frame of the kernels launched under the span
eval/shade (the field queries and the compact compositor)."""


def read(rec):
    s = rec.summary
    if s is None or rec.unit != "frame" or "eval/shade" not in s.span_s:
        return None
    return 1e3 * s.span_s["eval/shade"] / rec.units
