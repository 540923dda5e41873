"""A cell's files, found by the names in BENCHMARK.json:

- ``configs``' ``file``: the configuration (sizes, trainer settings);
- ``mixes/<traffic>.json``: the traffic mix; its ``runner`` names the
  general runner in ``runners/<runner>.py`` that reads it;
- ``cells/<workload>.json``: the limits of the numbers that decide the
  cell's ``correct``;
- ``metrics/<metric>.py``: one reader per metric, end-to-end or per-layer,
  with ``read(record) -> float or None``.

A cell, a configuration, a mix or a metric is added by adding its files
and its entry in BENCHMARK.json; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    limits: Dict[str, float]
    chips: int
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[Dict] = None,
              root: Path = ROOT) -> Cell:
    """The cell's configuration, mix, limits and metrics, from the files
    of the checkout at `root`."""
    bench = bench if bench is not None else load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: "
                       f"{', '.join(sorted(work))})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    bench_dir = root / "benchmark"
    with open(bench_dir / "mixes" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    with open(bench_dir / "cells" / f"{name}.json") as f:
        limits = json.load(f)["limits"]
    return Cell(name=name, config=config, mix=mix, limits=limits,
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """read(record) of metrics/<name>.py (a metric's name may hold dots,
    so the file is loaded by its path)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def trainer_fields(cell: Cell) -> Dict:
    """The program's Config fields of a cell: the configuration's
    "trainer", then the mix's (lists as tuples)."""
    fields = dict(cell.config["trainer"])
    fields.update(cell.mix.get("trainer", {}))
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in fields.items()}


def cascade(bound: float) -> int:
    """The occupancy grid's cascades for a scene bound (Config.cascade)."""
    return 1 + math.ceil(math.log2(max(bound, 1.0)))


def runner(name: str):
    """The general runner, runners/<name>.py of a mix."""
    return importlib.import_module(f"runners.{name}")
