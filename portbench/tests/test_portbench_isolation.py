"""What runs on the card imports neither JAX nor the JAX package, and the
reference imports nothing of the port either.

Every module under ``portbench/`` is parsed and each import's top-level
name (the part before the first dot) is compared whole: the port's name
``fastapriori_tpu_torch`` begins with the JAX package's
``fastapriori_tpu``.
"""

import ast
import os

import pytest

from portbench.tests.helpers import ROOT

PB = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "fastapriori_tpu"}


def _modules():
    for dirpath, _, files in os.walk(PB):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


MODULES = sorted(_modules())


def test_every_module_is_scanned():
    rel = {os.path.relpath(p, PB) for p in MODULES}
    assert {"run.py", "harness.py", "reference/apriori.py",
            "drivers/batch.py"} <= rel


@pytest.mark.parametrize("path", MODULES,
                         ids=[os.path.relpath(p, PB) for p in MODULES])
def test_no_jax_on_the_card(path):
    bad = top_level_imports(path) & FORBIDDEN
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


def test_reference_takes_nothing_of_the_port():
    ref = os.path.join(PB, "reference")
    for f in sorted(os.listdir(ref)):
        if f.endswith(".py"):
            names = top_level_imports(os.path.join(ref, f))
            assert not names & (FORBIDDEN | {"fastapriori_tpu_torch",
                                             "portbench"}), f
            assert names <= {"__future__", "math", "typing", "numpy"}, f


def test_the_check_compares_whole_names():
    from portbench import harness

    import sys
    import types

    sys.modules["fastapriori_tpu_torchx_probe"] = types.ModuleType("x")
    try:
        assert "fastapriori_tpu" not in harness.forbidden_loaded()
    finally:
        del sys.modules["fastapriori_tpu_torchx_probe"]
    sys.modules["jaxlib.probe"] = types.ModuleType("y")
    try:
        assert "jaxlib" in harness.forbidden_loaded()
    finally:
        del sys.modules["jaxlib.probe"]
