"""Nothing the benchmark runs imports JAX or the JAX package, and nothing
reads the JAX package's benchmarks; the reference and the yardstick
import nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness as hb

FILES = sorted(p for p in hb.BENCH.rglob("*.py") if "tests" not in p.parts)
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
#: The yardstick: frozen code that takes nothing of the program, and
#: every family file (``families/*.py``).
FROZEN = {"reference.py", "counting.py", "weights.py", "trace.py"}
#: The tests' family file, held to the rule a family file is held to.
TEST_FAMILY = hb.BENCH / "tests" / "moe_shared_family.py"


def frozen(path: Path) -> bool:
    return path.name in FROZEN or path.parent.name in ("metrics", "families")


def imports(source: str):
    """Every absolute module an import statement names."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_files_found():
    assert {p.name for p in FILES} >= FROZEN | {"run.py", "harness.py", "calibrate.py"}
    assert len([p for p in FILES if p.parent.name == "metrics"]) >= 10
    assert hb.BENCH / "families" / "__init__.py" in FILES


@pytest.mark.parametrize("path", FILES + [TEST_FAMILY],
                         ids=lambda p: str(p.relative_to(hb.ROOT)))
def test_no_banned_imports(path):
    src = path.read_text()
    assert [m for m in imports(src) if m.split(".")[0] in BANNED] == []
    assert "benchmarks/" not in src and "BENCH_trajectory" not in src
    if frozen(path) or path == TEST_FAMILY:
        assert [m for m in imports(src) if m.split(".")[0] == "repro_torch"] == []


@pytest.mark.parametrize("source,bad", [
    ("from perfbench import reference, counting", False),
    ("import torch, numpy", False),
    ("from repro_torch.models.model import param_spec", True),
    ("import repro_torch", True),
    ("from repro.models import forward", True),
    ("import jax.numpy as jnp", True),
])
def test_a_family_file_that_imports_the_program_is_refused(tmp_path, source, bad):
    """The rule ``test_no_banned_imports`` holds a family file to, on a new
    file under ``families/``."""
    path = tmp_path / "families" / "new_family.py"
    path.parent.mkdir()
    path.write_text(source + "\n")
    assert frozen(path)
    names = {m.split(".")[0] for m in imports(path.read_text())}
    assert bool(names & (BANNED | {"repro_torch"})) is bad


@pytest.mark.parametrize("src,bad", [
    ("import jax", True), ("import jax.numpy as jnp", True), ("from jaxlib import x", True),
    ("import flax", True), ("from repro.core import DFG", True), ("import repro", True),
    ("import repro_torch", False), ("from repro_torch.core import DFG", False),
    ("import reprolib", False), ("import torch", False),
])
def test_top_level_names_compared_whole(src, bad):
    assert any(m.split(".")[0] in BANNED for m in imports(src)) is bad


@pytest.mark.parametrize("names,found", [
    (["repro_torch_fake.sub", "reproduction", "torch"], []),
    (["repro.core", "repro_torch"], ["repro"]),
    (["jax.numpy", "flax.linen", "jaxlib"], ["flax", "jax", "jaxlib"]),
])
def test_banned_modules_compares_whole_names(names, found):
    assert hb.banned_modules(names) == found


def test_what_a_run_imports_holds_no_banned_module():
    """A fresh process that imports everything a run imports holds no
    banned top-level module (the test process may hold JAX from others)."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import perfbench.run, perfbench.calibrate\n"
        "from perfbench import harness, reference, counting, weights, trace, families\n"
        "import repro_torch.serving, repro_torch.kernels._build, repro_torch.core\n"
        "for e in harness.spec()['end_to_end'] + harness.spec()['per_layer']:\n"
        "    harness.metric(e['name'])\n"
        "print(harness.banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(hb.ROOT / "src"), str(hb.ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
