"""The card's allocation peak of an SDS training run, in GiB: from the
program's first step (the Trainer's first occupancy refresh, where the
runner resets the peak) to the window's end; the SD weights, the field,
its optimizer state and every step's working set. Where the runner marks
no first step, nothing."""


def read(rec):
    if rec.unit != "sds_step" or not rec.run_peak_bytes:
        return None
    return rec.run_peak_bytes / 2 ** 30
