"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference (dfref) imports nothing of the program. Module names are
compared by their whole top-level name: the program's name,
dreamfusion_torch, begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchkit import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "dreamfusion_tpu"}
FILES = sorted(p for p in cells.BENCH_DIR.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(cells.BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((cells.BENCH_DIR / "dfref").rglob("*.py")):
        assert "dreamfusion_torch" not in top_level_imports(path), path


def test_forbidden_modules_compares_whole_names():
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run; "
            "import types; sys.modules['dreamfusion_tpu_x'] = "
            "types.ModuleType('x'); print(run.forbidden_modules()); "
            "sys.modules['flax.core'] = types.ModuleType('y'); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.split("\n")[:2] == ["[]", "['flax']"]


def test_the_harness_loads_no_jax():
    """Importing the harness, the runners and the reference loads neither
    JAX nor the JAX package (run.py checks the same after every window)."""
    code = ("import sys; sys.path[:0] = ['benchmark', '.']; import run; "
            "from benchkit import harness, counts, trace, inputs, compare; "
            "import runners.sds, runners.pretrain, runners.orbit; "
            "import dfref.steps, dfref.models.kailu; "
            "import dreamfusion_torch.training.trainer; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"
