"""The PyTorch port never imports JAX and never loads a file of the JAX
package: an AST scan of every Python file of exponentialutilities_jl_torch/
and of chip_smoke.py (a subprocess check would not do, since this test
process has already imported jax through tests/conftest.py).

A load by path (``importlib.util.spec_from_file_location`` and its kin)
hides from an import scan, so those calls are flagged too, and no string
constant of the package's code (docstrings aside) may name the JAX
package, which is how such a path would be spelled. chip_smoke.py is held
to the import and load rules only: its kernel records name the TPU kernels
each CUDA kernel replaces by file."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "exponentialutilities_jl_torch"
FILES = sorted(PORT.rglob("*.py"))
SCANNED = FILES + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "exponentialutilities_jl_tpu")
# calls that execute a Python file named by its path
PATH_LOADERS = ("spec_from_file_location", "SourceFileLoader", "load_source",
                "run_path", "exec_module")


def _rel(p):
    return str(p.relative_to(ROOT))


def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and isinstance(node.func,
                                                        (ast.Name, ast.Attribute))
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _docstrings(tree):
    """ids of the string constants that are docstrings."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                out.add(id(first.value))
    return out


def test_port_has_files():
    assert len(FILES) >= 10


@pytest.mark.parametrize("path", SCANNED, ids=_rel)
def test_no_jax_import(path):
    bad = [name for name in _imports(_tree(path))
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", SCANNED, ids=_rel)
def test_no_load_by_path(path):
    calls = [getattr(n.func, "attr", getattr(n.func, "id", None))
             for n in ast.walk(_tree(path)) if isinstance(n, ast.Call)]
    bad = [c for c in calls if c in PATH_LOADERS]
    assert not bad, f"{path} loads a file by its path: {bad}"


@pytest.mark.parametrize("path", FILES, ids=_rel)
def test_no_string_names_the_jax_package(path):
    tree = _tree(path)
    docs = _docstrings(tree)
    bad = [n.value for n in ast.walk(tree)
           if isinstance(n, ast.Constant) and isinstance(n.value, str)
           and id(n) not in docs and "exponentialutilities_jl_tpu" in n.value]
    assert not bad, f"{path} names the JAX package in {bad}"


def test_scan_catches_a_load_by_path(tmp_path):
    """The checks above see what the port's old utils/native.py did."""
    src = tmp_path / "bad.py"
    src.write_text(
        "import importlib.util\n"
        "_SOURCE = 'exponentialutilities_jl_tpu/native/__init__.py'\n"
        "spec = importlib.util.spec_from_file_location('m', _SOURCE)\n"
        "mod = importlib.import_module('exponentialutilities_jl_tpu')\n")
    tree = _tree(src)
    assert "exponentialutilities_jl_tpu" in list(_imports(tree))
    assert any(getattr(n.func, "attr", None) == "spec_from_file_location"
               for n in ast.walk(tree) if isinstance(n, ast.Call))
    assert any(isinstance(n, ast.Constant) and "_jl_tpu" in str(n.value)
               and id(n) not in _docstrings(tree) for n in ast.walk(tree))


def test_host_reduced_is_the_ports_own():
    """ops/host_reduced.py (host scipy, no JAX) is scanned above, and in a
    fresh process importing it and evaluating a reduced problem loads no
    module of JAX or of the JAX package."""
    assert PORT / "ops" / "host_reduced.py" in FILES
    code = (
        "import sys\n"
        "import torch\n"
        "before = set(sys.modules)\n"
        "from exponentialutilities_jl_torch.ops import host_reduced as h\n"
        "h.host_phiv_e1(torch.eye(4, dtype=torch.float64), 0.5, 2)\n"
        "new = set(sys.modules) - before\n"
        f"bad = [m for m in new if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)
