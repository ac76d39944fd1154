"""The port and ``chip_smoke.py`` import no JAX stack, nothing of the JAX
package, and neither pandas nor matplotlib, which the card machine lacks
(an AST scan of every import statement)."""

import ast
import os
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dstdgcn_tpu", "pandas",
             "matplotlib")
FILES = sorted((REPO / "dstdgcn_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_scan_covers_the_port():
    names = {p.relative_to(REPO).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "dstdgcn_tpu_torch/kernels/fused.py" in names
    assert "dstdgcn_tpu_torch/models/infer.py" in names
    assert "dstdgcn_tpu_torch/kernels/sparse.py" in names
    assert "dstdgcn_tpu_torch/models/autotune.py" in names
    assert "dstdgcn_tpu_torch/data/kinematics.py" in names
    assert "dstdgcn_tpu_torch/data/native.py" in names
    assert "dstdgcn_tpu_torch/runner/action_runner.py" in names
    assert len(names) > 20


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, REPO) for p in FILES])
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
