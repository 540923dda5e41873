"""Device milliseconds a step of the kernels launched under the span
step/guidance (the VAE encoder's forward and the UNet's CFG forward)."""


def read(rec):
    s = rec.summary
    if s is None or rec.unit != "sds_step" or "step/guidance" not in s.span_s:
        return None
    return 1e3 * s.span_s["step/guidance"] / rec.units
