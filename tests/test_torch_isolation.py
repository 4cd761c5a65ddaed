"""The port stands alone and passes the repo's lint gate.

Every file of ``src/repro_torch/`` and ``tools/``, ``chip_smoke.py``
and the on-card tests ``tests/test_torch_kernels_gpu.py`` imports neither
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
# the card's machine has no JAX: chip_smoke.py, the gpu tests and the
# tools' measurements run there
FILES = (sorted(PORT.rglob("*.py")) + sorted((ROOT / "tools").glob("*.py"))
         + [ROOT / "chip_smoke.py",
            ROOT / "tests" / "test_torch_kernels_gpu.py"])
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
    for rel in ("serve/engine.py", "kernels/orchestration.py",
                "kernels/flash_attention.py", "kernels/wkv6.py",
                "models/attention.py", "models/rwkv6.py",
                "models/transformer.py", "serving/engine.py",
                "launch/serve.py", "configs/shapes.py", "kernels/ssd.py",
                "models/mamba2.py", "configs/zamba2_1p2b.py",
                "economy/__init__.py", "economy/tiers.py",
                "economy/routing.py", "env/edge_cloud.py", "core/agent.py",
                "core/baselines.py", "core/replay.py",
                "core/orchestrator.py", "configs/mobilenet_pool.py",
                "models/moe.py", "configs/mixtral_8x7b.py",
                "configs/mistral_nemo_12b.py", "configs/nemotron_4_15b.py",
                "models/mla.py", "configs/deepseek_v2_236b.py",
                "configs/qwen2_vl_7b.py", "configs/musicgen_medium.py",
                "training/schedule.py", "training/train_step.py",
                "training/optimizer.py", "data/pipeline.py",
                "launch/train.py", "checkpoint/ckpt.py"):
        assert (PORT / rel) in FILES, rel


def test_port_passes_the_repo_lint():
    findings = lint_paths([str(PORT)])
    assert findings == [], "\n".join(f.format() for f in findings)
