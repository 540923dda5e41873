"""What the card holds between SDS steps when the window starts, in GiB
(torch.cuda.memory_allocated()): SD's weights, the field, its optimizer
state and the occupancy grid."""


def read(rec):
    if rec.unit != "sds_step" or not rec.resident_bytes:
        return None
    return rec.resident_bytes / 2 ** 30
