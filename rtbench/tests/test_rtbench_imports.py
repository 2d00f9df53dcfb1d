"""Neither the harness nor the reference imports JAX or the JAX package,
and the reference imports nothing of the port: by whole top-level module
names, in the sources and in a run's process."""

import ast
import json
import subprocess
import sys

from rtbench import core
from rtbench.tests.common import ROOT

HARNESS = sorted(p for p in (ROOT / "rtbench").rglob("*.py")
                 if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax():
    for path in HARNESS:
        assert not top_level_imports(path) & set(core.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "rtbench" / "reference").glob("*.py"):
        names = top_level_imports(path)
        assert "ray_tracer_tpu_torch" not in names, path
        assert names <= {"__future__", "math", "numpy", "torch"}, path


def test_the_check_compares_whole_top_level_names():
    assert core.forbidden_modules({"ray_tracer_tpu_torch.ops": 1,
                                   "jaxtyping": 1}) == []
    assert core.forbidden_modules({"jax.numpy": 1, "torch": 1}) == ["jax"]
    assert core.forbidden_modules({"ray_tracer_tpu.ops": 1}) == [
        "ray_tracer_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys, time, json; sys.path.insert(0, %r); "
            "import torch; torch.set_num_threads(2); "
            "from rtbench import core; "
            "from rtbench.tests.common import small; "
            "from rtbench.tests.common import CELLS; "
            "core.run_cell(CELLS[-1], 5, 0.2, True, time.perf_counter(), "
            "device='cpu', overrides=small(CELLS[-1])); "
            "print(json.dumps(sorted(m.split('.')[0] for m in sys.modules)))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "ray_tracer_tpu_torch" in loaded
    assert not loaded & set(core.FORBIDDEN)
