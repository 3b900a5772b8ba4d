"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names are
compared whole (``repro_torch`` begins with ``repro``)."""
import ast

import pytest

from portbench.lib import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in manifest.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and isinstance(
                    node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(manifest.HERE)) for p in FILES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((manifest.HERE / "reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "typing", "math",
                                       "numpy", "torch"}


def test_the_whole_name_is_compared():
    assert "repro_torch" not in FORBIDDEN
    src = "import repro_torch\nfrom repro import core\n"
    tree = ast.parse(src)
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
             else n.module.split(".")[0] for n in tree.body}
    assert names & FORBIDDEN == {"repro"}


def test_a_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from portbench.lib import bench

    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert bench.forbidden_modules() == ["jax"]
