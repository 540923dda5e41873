"""Device milliseconds a pretraining step of the kernels launched under
the span step/optimizer of DVGOTrainer.step (GroupAdam's per-parameter
update, on the main thread). A program without the span reads nothing."""


def read(rec):
    s = rec.summary
    if s is None or rec.unit != "pretrain_step" or not rec.units \
            or "step/optimizer" not in s.span_s:
        return None
    return 1e3 * s.span_s["step/optimizer"] / rec.units
