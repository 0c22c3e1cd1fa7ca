"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the program, and nothing the benchmark runs
reads the JAX package's benchmark records."""

from __future__ import annotations

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "mcray_tpu"}


def imported(path: pathlib.Path) -> set[str]:
    """The top-level name of every absolute import in the file, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & (JAX | {"mcray_tpu_torch", "benchmark"})


@pytest.mark.parametrize("path", [p for p in FILES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_the_jax_benchmark_records(path):
    text = path.read_text()
    assert "bench.py" not in text.replace("bench.py)", "")
    assert "BENCH_" not in text and "BASELINE" not in text
