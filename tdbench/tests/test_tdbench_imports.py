"""Nothing under tdbench/ imports JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is not ``repro``); the reference imports
nothing of the program either."""
import ast
from pathlib import Path

import pytest

TD = Path(__file__).resolve().parents[1]
REFUSED = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(TD.rglob("*.py"))


def imports(path: Path):
    """Every imported module's full name (absolute imports only)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(TD)))
def test_no_jax_and_no_program_in_the_reference(path):
    mods = set(imports(path))
    tops = {m.split(".")[0] for m in mods}
    assert not tops & REFUSED, tops & REFUSED
    if "reference" in path.relative_to(TD).parts:
        assert "repro_torch" not in tops
        # nor through the harness, whose modules import the program
        assert all(m.startswith(("tdbench.reference", "tdbench.traffic"))
                   for m in mods if m.split(".")[0] == "tdbench")


def test_nothing_reads_the_jax_benchmarks_folder():
    for path in FILES:
        if path.name != Path(__file__).name:
            assert "benchmarks" not in path.read_text(), path
