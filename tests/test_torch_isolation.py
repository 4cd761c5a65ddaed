"""The port stands alone and passes the repo's lint gate.

Every file of ``src/repro_torch/``, ``chip_smoke.py`` and the on-card
tests ``tests/test_torch_kernels_gpu.py`` imports neither
``jax``/``jaxlib`` nor anything of the reference package ``repro``, and
``repro.analysis.lint`` finds nothing in the port — so a port fault shows
up here under the port's own name as well as in the repo-wide gate.
"""
import ast
from pathlib import Path

import pytest

from repro.analysis.lint import lint_paths

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the card's machine has no JAX: chip_smoke.py and the gpu tests run there
FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_gpu.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_nothing_of_jax_or_the_reference(path):
    bad = [m for m in _imported(ast.parse(path.read_text()))
           if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_found():
    assert (PORT / "serve" / "engine.py") in FILES
    assert (PORT / "kernels" / "orchestration.py") in FILES


def test_port_passes_the_repo_lint():
    findings = lint_paths([str(PORT)])
    assert findings == [], "\n".join(f.format() for f in findings)
