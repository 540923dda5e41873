"""BENCHMARK.json against the benchmark's files and its contract: every
cell names a known configuration, mix and runner and has its limits;
every metric has a reader; and a cell, a configuration, a mix and a
metric are added by adding files alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchkit import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = cells.load_benchmark()


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(w):
    cell = cells.load_cell(w["name"])
    assert NAME.match(w["name"]) and w["chips"] == 1
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert (cells.BENCH_DIR / "runners" / f"{cell.mix['runner']}.py").exists()
    mod = cells.runner(cell.mix["runner"])
    assert hasattr(mod, "Run") and hasattr(mod, "readings")
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_a_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(cells.metric_reader(m["name"]))
    known = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", known)) <= known
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        e2e = {e["name"]: e for e in BENCH["end_to_end"]}
        assert m["moves"] in e2e
        moved = set(e2e[m["moves"]].get("workloads", known))
        assert set(m["workloads"]) <= moved


def test_configs_are_used_and_their_files_hold_them():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert json.loads(Path(cells.ROOT, c["file"]).read_text())["name"] \
            == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a cell and a
    metric from files of their own and an entry each in BENCHMARK.json;
    the harness finds them by name."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((root / "benchmark/configs/grid_sd15.json").read_text())
    conf["name"] = "grid_sd15_128"
    conf["trainer"]["H"] = conf["trainer"]["W"] = 128
    (root / "benchmark/configs/grid_sd15_128.json").write_text(json.dumps(conf))
    mix = {"runner": "orbit", "why": "small frames", "orbit": 8,
           "warmup_frames": 1, "check_frames": 1, "trace_frames": 1}
    (root / "benchmark/mixes/small_orbit.json").write_text(json.dumps(mix))
    (root / "benchmark/cells/grid_sd15_128.small_orbit.json").write_text(
        json.dumps({"limits": {"frame_mean_gap": 1.0, "frame_max_gap": 9.0}}))
    (root / "benchmark/metrics/frames_per_minute.py").write_text(
        "def read(rec):\n    return 60.0 * rec.units / rec.seconds\n")
    bench["configs"].append({"name": "grid_sd15_128", "source": "x",
                             "file": "benchmark/configs/grid_sd15_128.json",
                             "reduced": ["H", "W"], "why": "x"})
    bench["workloads"].append({"name": "grid_sd15_128.small_orbit",
                               "config": "grid_sd15_128",
                               "traffic": "small_orbit", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "frames_per_minute",
                                "unit": "frames/min", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["grid_sd15_128.small_orbit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load_cell("grid_sd15_128.small_orbit", root=root)
    assert cell.config["trainer"]["H"] == 128 and cell.mix["orbit"] == 8
    assert cell.limits["frame_max_gap"] == 9.0
    names = [m["name"] for m in cell.end_to_end]
    assert "frames_per_minute" in names and "eval_frames_per_s" not in names
    reader = cells.metric_reader("frames_per_minute",
                                 bench_dir=root / "benchmark")
    assert reader(type("R", (), {"units": 3, "seconds": 6.0})) == 30.0
