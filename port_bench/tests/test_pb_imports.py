"""No file of the benchmark imports JAX or the JAX package (top-level
names compared whole: `repro_torch` is not `repro`), and the reference
imports nothing of the program."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


FILES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "repro_torch" not in path.read_text()


def test_the_check_compares_whole_names():
    src = "import repro_torch.models\nfrom repro_torch import kernels\n"
    tree_names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tree_names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tree_names.add(node.module.split(".")[0])
    assert tree_names == {"repro_torch"} and not tree_names & FORBIDDEN


def test_the_run_guard_names_loaded_modules(monkeypatch):
    import types
    from port_bench import harness
    loaded = {"repro_torch": None, "repro_torch.models": None, "numpy": None}
    monkeypatch.setattr(harness, "sys", types.SimpleNamespace(modules=loaded))
    assert harness.forbidden_modules() == []
    loaded.update({"jax.numpy": None, "repro.core": None})
    assert harness.forbidden_modules() == ["jax", "repro"]
