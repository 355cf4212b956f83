"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no twin of an example (``examples/*_torch.py``)
imports JAX, the JAX package (``repro``) or
``ml_dtypes`` (which the GPU host lacks).  Checked on the source's syntax
tree, so an import inside a function counts too."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes"}


def forbidden_imports(source: str) -> list:
    """(line, module) of every absolute import whose top-level package is
    in FORBIDDEN."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in FORBIDDEN]
    return found


def test_the_walk_finds_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/kernels/conv_dataflow/ops.py" in names
    assert "src/repro_torch/core/pipeline.py" in names
    twins = ("quickstart", "serve_driving_pipeline", "train_with_failures")
    assert {f"examples/{n}_torch.py" for n in twins} <= names
    assert len(FILES) > 30


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_imports(path):
    assert forbidden_imports(path.read_text()) == []


def test_the_check_catches_each_form():
    src = ("import jax\nimport jax.numpy as jnp\nfrom jax import lax\n"
           "from repro.core import hmai\nimport repro\n"
           "def f():\n    from jaxlib import xla_client\n"
           "import repro_torch\nfrom . import ops\nimport reprox\n")
    assert [n for _, n in forbidden_imports(src)] == [
        "jax", "jax.numpy", "jax", "repro.core", "repro", "jaxlib"]
