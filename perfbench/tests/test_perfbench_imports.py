"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the port: top-level module names,
compared whole, of every import in every file."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "vln_goat_tpu"}
TPU_RECORDS = ("bench.py", "BENCH_", "MULTICHIP_", "BASELINE.json")


def imports(path: Path):
    """Top-level names of the absolute imports of `path`, and whether a
    relative import leaves its package."""
    tree = ast.parse(path.read_text(), str(path))
    depth = len(path.relative_to(BENCH).parts) - 1
    names, escapes = set(), False
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            elif node.level > depth:
                escapes = True
    return names, escapes


FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    names, _ = imports(path)
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"


REFERENCE = [p for p in FILES if "reference" in p.relative_to(BENCH).parts]


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_stands_alone(path):
    names, _ = imports(path)
    assert names <= {"__future__", "math", "dataclasses", "json", "typing",
                     "numpy", "torch", "contextlib", "heapq", "os",
                     "random", "zlib", "collections", "re"}, \
        f"{path} imports {names}"
    # relative imports stay inside perfbench.reference
    tree = ast.parse(path.read_text())
    rel = path.relative_to(BENCH / "reference")
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level <= len(rel.parts), f"{path}: {node.module}"


def test_reads_no_tpu_records():
    for p in FILES:
        if p.name == Path(__file__).name:
            continue
        text = p.read_text()
        for rec in TPU_RECORDS:
            assert rec not in text, f"{p} names {rec}"
