"""Nothing the harness runs imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level module
name, the part before the first dot, compared whole (the program's name
begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

from vio_bench import spec

JAX = {"jax", "jaxlib", "flax", "rebvio_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted(p for p in spec.HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(spec.HERE).as_posix())
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "rebvio_tpu_torch" not in top_level_imports(path)
    assert not top_level_imports(path) & JAX


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import rebvio_tpu_torch.runner\nfrom rebvio_tpu_torch import pipeline\n")
    assert top_level_imports(f) == {"rebvio_tpu_torch"} and not top_level_imports(f) & JAX
    f.write_text("from rebvio_tpu.ops import imu\n")
    assert top_level_imports(f) & JAX
