"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program it judges."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imported(path: Path) -> set:
    """Top-level names (before the first dot) of every import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_reference_to_the_program(path):
    names = _imported(path)
    assert not names & FORBIDDEN, (path, names & FORBIDDEN)
    if "reference" in path.relative_to(HERE).parts:
        assert "repro_torch" not in names, path


def test_the_guard_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.api\nfrom repro_torch import random\n"
                 "import jaxtyping\n")
    assert not _imported(f) & FORBIDDEN
    f.write_text("import os\nfrom repro.core import lattice\n")
    assert _imported(f) & FORBIDDEN == {"repro"}
    f.write_text("import jax.numpy as jnp\n")
    assert _imported(f) & FORBIDDEN == {"jax"}
