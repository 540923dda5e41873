"""Device milliseconds a step of the kernels launched under the span
step/guidance/unet (the UNet's CFG forward, inside step/guidance, which
also holds the VAE encoder's forward). A program without the span reads
nothing."""


def read(rec):
    s = rec.summary
    if s is None or rec.unit != "sds_step" or not rec.units \
            or "step/guidance/unet" not in s.span_s:
        return None
    return 1e3 * s.span_s["step/guidance/unet"] / rec.units
