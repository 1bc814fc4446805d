"""Nothing the benchmark runs loads JAX, flax or the JAX package, compared
by the whole top-level name (the port, ``promptttspp_tpu_torch``, passes);
the reference loads nothing of the port either."""

import ast
import subprocess
import sys
from pathlib import Path

from perfbench.harness import cell as cells
from perfbench.harness.main import FORBIDDEN, forbidden_modules

SOURCES = sorted(cells.PERFBENCH.rglob("*.py"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_no_source_imports_a_forbidden_module():
    for path in SOURCES:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((cells.PERFBENCH / "reference").rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] != "promptttspp_tpu_torch", (path,
                                                                  name)


def test_whole_name_comparison():
    names = ["promptttspp_tpu_torch", "promptttspp_tpu_torch.infer",
             "jaxtyping", "flax_like", "jax.numpy", "flax.linen",
             "promptttspp_tpu.models", "jaxlib"]
    assert forbidden_modules(names) == ["flax", "jax", "jaxlib",
                                        "promptttspp_tpu"]


def _loaded_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(cells.ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return eval(out.stdout.strip().splitlines()[-1])


def test_a_cpu_run_loads_no_forbidden_module(tmp_path):
    code = f"""
import os, time
os.environ["TMPDIR"] = {str(tmp_path)!r}
from perfbench.tests import tiny
from perfbench.harness import main as M, cell as cells
from perfbench.harness.run import Run
spec = tiny.spec("serve_online_b1", rate_per_s=4.0, check_requests=2)
run = Run(spec, 3, 1.0, False, time.perf_counter(), device="cpu")
M.execute(run, cells.driver("open_loop"))
assert run.correct, run.checks
"""
    loaded = _loaded_after(code)
    assert not set(loaded) & set(FORBIDDEN)
    assert "promptttspp_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import perfbench.reference.serve, perfbench.reference.train, "
        "perfbench.reference.judge")
    assert "promptttspp_tpu_torch" not in loaded
    assert not set(loaded) & set(FORBIDDEN)
