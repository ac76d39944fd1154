"""The port and ``chip_smoke.py`` import no JAX stack, nothing of the JAX
package, no ``msgpack``, and neither pandas, matplotlib nor imageio, which
the card machine lacks (an AST scan of every import statement).

One exception: ``utils/visualization.py`` imports matplotlib and imageio
inside its plotting functions, each import in the body of a ``try`` whose
handler catches ``ImportError``, so that without them a plot writes nothing
and returns None, as the JAX package's does on a headless host.  The scan
holds that file to exactly that guard.
"""

import ast
import os
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dstdgcn_tpu", "pandas",
             "matplotlib", "imageio", "msgpack")
#: the plotting packages the visualization module may import, guarded
PLOTTING = ("matplotlib", "imageio")
VISUALIZATION = REPO / "dstdgcn_tpu_torch" / "utils" / "visualization.py"
FILES = sorted((REPO / "dstdgcn_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imports(tree):
    """(node, module) of every import statement of an absolute module."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, node.module or ""


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for _, module in _imports(tree):
        yield module


def _catches_import_error(handler):
    kinds = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    return any(isinstance(k, ast.Name) and k.id == "ImportError"
               for k in kinds)


def _guarded(tree, node):
    """Whether ``node`` sits in the body of a ``try`` that catches
    ``ImportError``, inside a function."""
    parents = {}
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent
    guarded, child = False, node
    while child in parents:
        parent = parents[child]
        if isinstance(parent, ast.Try) and child in parent.body and any(
                _catches_import_error(h) for h in parent.handlers):
            guarded = True
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return guarded
        child = parent
    return False


def _plotting_imports(source):
    """[(module, guarded)] of the plotting imports of ``source``."""
    tree = ast.parse(source)
    return [(module, _guarded(tree, node)) for node, module in _imports(tree)
            if module.split(".")[0] in PLOTTING]


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
    assert "dstdgcn_tpu_torch/engine/checkpoint.py" in names
    assert "dstdgcn_tpu_torch/utils/visualization.py" in names
    assert len(names) > 20


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, REPO) for p in FILES])
def test_no_jax_imports(path):
    allowed = PLOTTING if path == VISUALIZATION else ()
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN and m.split(".")[0] not in allowed]
    assert not bad, f"{path} imports {bad}"


GUARDED = '''
def plot():
    try:
        import matplotlib
        import imageio.v2 as imageio
    except ImportError:
        return None
'''
MODULE_LEVEL = '''
try:
    import matplotlib
except ImportError:
    matplotlib = None
'''
UNGUARDED = '''
def plot():
    import matplotlib
'''
OTHER_HANDLER = '''
def plot():
    try:
        from imageio import v2
    except ValueError:
        return None
'''
IN_HANDLER = '''
def plot():
    try:
        pass
    except ImportError:
        import matplotlib
'''


@pytest.mark.parametrize("source,ok", [
    (None, True), (GUARDED, True), (MODULE_LEVEL, False), (UNGUARDED, False),
    (OTHER_HANDLER, False), (IN_HANDLER, False)],
    ids=["visualization.py", "guarded", "module_level", "unguarded",
         "other_handler", "import_in_handler"])
def test_plotting_imports_only_guarded_in_functions(source, ok):
    source = VISUALIZATION.read_text() if source is None else source
    found = _plotting_imports(source)
    assert found
    assert all(guarded for _, guarded in found) == ok, found
