"""The import guard and what the benchmark's sources import."""

import ast
from pathlib import Path

import pytest

from nfcbench import guard

PKG = Path(guard.__file__).resolve().parent


@pytest.mark.parametrize("mods,bad", [
    ({"numpy": 1, "nfclab_torch": 1, "nfclab_torch.runtime.farm": 1}, []),
    ({"nfclab": 1}, ["nfclab"]),
    ({"nfclab.dsp.frontend": 1, "nfclab_torch": 1}, ["nfclab"]),
    ({"jax": 1, "jaxlib.xla_client": 1}, ["jax", "jaxlib"]),
    ({"flax.linen": 1}, ["flax"]),
    ({"jax_utils": 1, "nfclabx": 1, "myjax": 1}, []),
])
def test_top_level_names_whole(mods, bad):
    assert guard.forbidden_loaded(mods) == bad


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_neither_jax_nor_nfclab():
    for path in PKG.rglob("*.py"):
        assert not _imports(path) & set(guard.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    """The traffic, its frame table and the comparison are the reference:
    plain numpy, none of the port."""
    ref = [PKG / "check.py", PKG / "roofline.py",
           *(PKG / "traffic").glob("*.py")]
    for path in ref:
        assert "nfclab_torch" not in _imports(path), path
        assert "torch" not in _imports(path), path
