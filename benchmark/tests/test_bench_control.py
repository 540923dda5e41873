"""On the card, at each cell's own size: a sound run's numbers stay within
the cell's limits, and the control (the reference in the next precision
below the configuration's, in the program's place) fails at least one of
them. The limits were set from these readings over a dozen seeds or more
(PERF.md); this keeps one seed of them as a test.

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q -p no:cacheprovider
"""

import pytest

import calibrate
from benchkit import cells

CELLS = [w["name"] for w in cells.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(gpu, name):
    limits = cells.load_cell(name).limits
    line = next(calibrate.calibrate(name, [20260418], True, []))
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
