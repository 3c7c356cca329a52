"""The benchmark measures the port alone: the top-level-name check for
JAX and the JAX package, and what the benchmark's sources import and
read."""
import ast
import sys
from pathlib import Path

import pytest

from bench import harness

BENCH = Path(harness.BENCH)


@pytest.mark.parametrize("mod, bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("repro", True), ("repro.core.safl", True),
    ("repro_torch", False), ("repro_torch.core", False),
    ("jaxtyping", False), ("reprox", False), ("numpy", False)])
def test_forbidden_by_whole_top_level_name(monkeypatch, mod, bad):
    clean = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] not in harness.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", {**clean, mod: None})
    assert harness.forbidden_modules() == (
        [mod.split(".")[0]] if bad else [])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def test_no_source_imports_jax_or_the_jax_package():
    for p in _sources():
        assert not set(_imports(p)) & set(harness.FORBIDDEN), p


def test_the_reference_imports_nothing_of_the_program():
    for p in sorted((BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in set(_imports(p)), p
        assert "bench.program" not in p.read_text(), p


def test_only_the_program_module_imports_the_port():
    users = [p.name for p in _sources()
             if "repro_torch" in set(_imports(p))]
    assert users == ["program.py"]


def test_nothing_reads_the_old_benchmarks():
    for p in sorted(BENCH.rglob("*")):
        if p.is_file() and p.suffix in (".py", ".json", ".sh"):
            text = p.read_text()
            if p.name == "test_bench_imports.py":
                continue
            assert "benchmarks/" not in text and "BENCH_" not in text, p
