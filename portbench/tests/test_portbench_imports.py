"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Top-level module names are
compared whole: volumetricinterp_tpu_torch is the program, and
volumetricinterp_tpu is the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "volumetricinterp_tpu"}
SOURCES = sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_name_check_is_whole():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax",
                                 "volumetricinterp_tpu")
    assert "volumetricinterp_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert harness.PROGRAM not in top_level_imports(path)
    assert not top_level_imports(path) & FORBIDDEN


def test_loaded_modules_in_a_fresh_process():
    """The reference and the harness load neither the program (the harness
    imports it only when a cell runs) nor JAX."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.harness, portbench.reference.fit, "
            "portbench.reference.product, portbench.reference.data\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (FORBIDDEN | {harness.PROGRAM})
