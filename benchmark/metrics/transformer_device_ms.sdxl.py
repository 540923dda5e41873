"""Device milliseconds a step of the kernels launched under the span
step/guidance/unet/transformer (the UNet's transformer stacks: GroupNorm,
the projections in and out, the blocks' attention and GEGLU, inside
step/guidance/unet). A program without the span reads nothing."""


def read(rec):
    s = rec.summary
    name = "step/guidance/unet/transformer"
    if s is None or rec.unit != "sds_step" or not rec.units \
            or name not in s.span_s:
        return None
    return 1e3 * s.span_s[name] / rec.units
