"""Import boundary of the PyTorch port: nothing under src/repro_torch/ and
nothing in chip_smoke.py imports JAX or the JAX package ``repro``, and no
try/except in the kernel wrappers can hide a failed build or launch."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            bad += [a.value for a in node.args if isinstance(
                a, ast.Constant) and isinstance(a.value, str)
                and _forbidden(a.value)]
    assert not bad, f"{path.name} imports {bad}"


def test_kernel_wrappers_have_no_try():
    """A failed build or launch must raise, never fall back quietly."""
    for name in ("ops.py", "build.py"):
        tree = ast.parse((PORT / "kernels" / name).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], name


def test_boundary_scan_catches_a_jax_import(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("import os\nfrom jax import numpy\nfrom repro.models import x\n")
    tree = ast.parse(p.read_text())
    found = [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and _forbidden(n.module)]
    assert found == ["jax", "repro.models"]
    assert not _forbidden("repro_torch.models")
