"""Device milliseconds a step of the kernels launched under the span
step/render (the forward render; the backward runs on autograd's thread,
outside it)."""


def read(rec):
    s = rec.summary
    if s is None or rec.unit != "sds_step" or "step/render" not in s.span_s:
        return None
    return 1e3 * s.span_s["step/render"] / rec.units
