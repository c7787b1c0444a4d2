"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program under test. Top-level module
names are compared whole: `repro_torch` is not `repro`."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
NEVER = {"jax", "jaxlib", "flax", "repro"}


def top_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    # plain torch only: neither the program nor the harness around it
    assert not top_imports(path) & (NEVER | {"repro_torch", "bench"})


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.models\nfrom repro_torch import x\n"
                 "from . import y\n")
    assert top_imports(f) == {"repro_torch"}
    assert not top_imports(f) & NEVER
    f.write_text("import repro.models\n")
    assert top_imports(f) & NEVER == {"repro"}
