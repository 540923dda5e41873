"""Seconds from the process's start to the window's: imports, the
kernels' build or load, the inputs and weights, the warm-up."""


def read(rec):
    return rec.setup_s
