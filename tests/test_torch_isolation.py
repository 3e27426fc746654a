"""The port stands alone: no module of `repro_torch`, nor `chip_smoke.py`
or `xlstm_stamps.py`, imports JAX or the JAX package, statically or at
import time."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "xlstm_stamps.py"]


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _imported(tree, path):
    pkg = path.relative_to(ROOT / "src").parent.parts \
        if PORT in path.parents else ()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:                  # resolve relative imports
                base = pkg[:len(pkg) - node.level + 1]
                yield ".".join(base + ((node.module,) if node.module
                                       else ()))
            else:
                yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    names = list(_imported(ast.parse(path.read_text()), path))
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_module_loads_no_jax():
    mods = list(_modules())
    assert "repro_torch.kernels.moe_gemm" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
