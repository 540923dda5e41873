"""The pretraining step's share of its least time on the card: the
larger of its operations at the f32 peak (67 TFLOP/s) and its bytes at
3.35 TB/s (benchkit/counts.dvgo_step_work: the configuration's shapes and
the step's live samples), over the traced stretch's seconds a step."""

from benchkit.device import H100_F32_FLOPS, least_seconds


def read(rec):
    s = rec.summary
    if s is None or rec.unit != "pretrain_step" or not rec.units:
        return None
    flops, nbytes = rec.extra["step_work"]
    return 100.0 * least_seconds(flops, nbytes, H100_F32_FLOPS) \
        / (s.window_s / rec.units)
