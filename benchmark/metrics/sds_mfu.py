"""The SDS step's share of the card's bf16 peak: SD operations a step
(the UNet's CFG forward, the VAE encoder's forward and input gradient at
the configuration's widths, benchkit/counts.py) times the traced
stretch's steps a second, over 989 TFLOP/s. The field's work (about 1%)
is left out."""

from benchkit.device import H100_BF16_FLOPS


def read(rec):
    s = rec.summary
    if s is None or rec.unit != "sds_step" or not rec.units:
        return None
    return 100.0 * rec.extra["sd_step_flops"] * rec.units / s.window_s \
        / H100_BF16_FLOPS
