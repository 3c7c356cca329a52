"""The port stands alone: nothing in src/repro_torch/ or chip_smoke.py
imports jax or the reference package repro."""
import ast
import pathlib

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    assert path.exists(), path
    bad = {r for r in _imported_roots(path)} & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_guard_sees_the_package():
    assert len(FILES) > 20


def test_port_modules_import_without_a_gpu():
    """Every module imports on a CPU-only host (no triton, no nvcc):
    kernels are built inside the call that launches them."""
    import importlib
    for path in FILES[:-1]:
        rel = path.relative_to(ROOT / "src").with_suffix("")
        name = ".".join(p for p in rel.parts if p != "__init__")
        importlib.import_module(name)
