"""The benchmark's yardstick: finding a cell's files by name (cells.py),
the device's name and peaks (device.py), seeded inputs (inputs.py), the
reduction of a profiler trace (trace.py), the work counters (counts.py),
the comparisons that decide `correct` (compare.py), the controls' lower
precision (lowp.py) and one run of a cell (harness.py). Nothing here
imports JAX or the JAX package; the program is imported only by the
runners."""
