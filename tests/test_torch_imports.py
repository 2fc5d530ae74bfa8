"""The PyTorch port stands alone: neither ``src/repro_torch``, nor
``chip_smoke.py``, nor the port's card tools under ``tools/`` import JAX
or the JAX package ``repro``."""

import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "kernel_variants.py",
    ROOT / "tools" / "plant_faults.py", ROOT / "tools" / "logit_agreement.py",
    ROOT / "tools" / "bwd_splits.py", ROOT / "tools" / "mesh_ranks.py",
    ROOT / "tools" / "profiler_loss.py"]
BANNED = {"jax", "jaxlib", "repro"}


def banned_imports(source: str):
    """(line, module) for every absolute import of a banned top-level
    package; ``repro_torch`` and relative imports pass."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in BANNED:
                yield node.lineno, name


def test_port_files_exist():
    assert all(f.exists() for f in FILES)
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert list(banned_imports(path.read_text())) == []


@pytest.mark.parametrize(
    "src,bad",
    [
        ("import jax", True),
        ("import jax.numpy as jnp", True),
        ("from jax import numpy", True),
        ("import repro", True),
        ("from repro.core import DFG", True),
        ("from repro import core", True),
        ("def f():\n    import repro.models", True),
        ("import repro_torch", False),
        ("from repro_torch.core import DFG", False),
        ("from . import ops", False),
        ("import torch", False),
    ],
)
def test_scanner_flags_exactly_the_banned_imports(src, bad):
    assert bool(list(banned_imports(src))) == bad
