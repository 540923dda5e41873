#!/usr/bin/env python3
"""The benchmark of dreamfusion_torch on one or more NVIDIA GPUs: one run
of one cell of BENCHMARK.json.

    python benchmark/run.py --workload grid_sd15.sds_train --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics over a window of ``--seconds``; ``--trace 1`` runs a stretch of the
same loop under torch.profiler (after such a window, unprofiled, where a
per-layer metric reads the host's clock) and reports the per-layer
metrics. Either
way the run then compares what the timed path produced with the plain
reference (benchmark/dfref) and prints each number compared beside its
limit on standard error; the last line of standard output is the result
object. Without a GPU, with fewer GPUs than the cell asks for, or with the
program missing, it exits non-zero and prints no result.

The kernel and compiler caches live under .bench_cache/ in the checkout
(the program builds its kernels into dreamfusion_torch/build/)."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)
# one process with few threads: the host launches the kernels, and idle
# CPU worker threads spinning beside it only add to the runs' spread
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
if HERE not in sys.path:
    sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "dreamfusion_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that this run must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from benchkit import cells, device, harness

    try:
        cell = cells.load_cell(a.workload)
    except (OSError, KeyError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    why_not = device.require_cards(cell.chips)
    if why_not:
        print(f"benchmark: {why_not}", file=sys.stderr)
        return 3
    try:
        import dreamfusion_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is missing ({e})", file=sys.stderr)
        return 4
    result, checks = harness.run(a.workload, a.seed, a.seconds,
                                 bool(a.trace), T_START, cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 5
    print(f"# {result['device']['kind']}, power limit "
          f"{result['device'].get('power_limit_w')} W, seed {a.seed}",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
