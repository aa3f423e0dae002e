"""No module of the benchmark imports JAX or the JAX package, the
reference imports nothing of the program, and the check at the end of a
run compares top-level module names whole."""

import ast
import re
from pathlib import Path

from slam_bench import harness

BENCH = Path(harness.__file__).resolve().parent


def imported_top_levels(path: Path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = imported_top_levels(path) & set(harness.FORBIDDEN_MODULES)
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "orb_slam_tpu_torch" not in imported_top_levels(path), path


def test_names_compare_whole():
    loaded = {"orb_slam_tpu_torch": 1, "orb_slam_tpu_torch.pipeline": 1,
              "jax_like": 1, "numpy": 1}
    assert harness.forbidden_modules(loaded) == []
    assert harness.forbidden_modules({**loaded, "orb_slam_tpu.ops": 1}) == ["orb_slam_tpu"]
    assert harness.forbidden_modules({"jaxlib.xla_client": 1, "flax": 1}) == ["flax", "jaxlib"]


def test_nothing_reads_the_old_benchmark_files():
    old = re.compile(r"\bbench\.py|BENCH_r0|BASELINE\.json|MULTICHIP_|EVAL_r0|LONGRUN_r0")
    for path in BENCH.rglob("*.py"):
        if "tests" not in path.relative_to(BENCH).parts:
            assert not old.search(path.read_text()), path
