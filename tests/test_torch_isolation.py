"""The port stands alone and never quietly runs on the CPU:

- importing fastapriori_tpu_torch (and its CLI) leaves jax and the JAX
  package out of sys.modules, and no module of the port, nor
  chip_smoke.py, has an import statement naming either;
- without a CUDA device, every entry point that was not asked for the CPU
  raises InputError (the CLI exits 2), and chip_smoke.py exits non-zero
  without a result line;
- the engines this slice does not have are refused by name.

The vertical engine's modules (ops/vertical.py, ops/vertical_kernel.py,
utils/env.py) are imported by name, and a forced vertical mine without
a CUDA device is refused like any other run.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from fastapriori_tpu_torch import AssociationRules, FastApriori, InputError
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "fastapriori_tpu_torch")
FORBIDDEN = {"jax", "fastapriori_tpu"}


def test_import_leaves_jax_out():
    code = (
        "import sys, fastapriori_tpu_torch, fastapriori_tpu_torch.cli, "
        "fastapriori_tpu_torch.convert, fastapriori_tpu_torch.ops.vertical, "
        "fastapriori_tpu_torch.ops.vertical_kernel, "
        "fastapriori_tpu_torch.utils.env\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'fastapriori_tpu'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_module_of_the_port_names_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    names = {os.path.relpath(f, ROOT) for f in files}
    assert {os.path.join("fastapriori_tpu_torch", "ops", "vertical.py"),
            os.path.join("fastapriori_tpu_torch", "ops", "vertical_kernel.py"),
            os.path.join("fastapriori_tpu_torch", "utils", "env.py")} <= names
    for path in files:
        assert FORBIDDEN.isdisjoint(_imported_roots(path)), path


def test_no_cuda_means_an_error_not_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(InputError, match="CUDA"):
        FastApriori(0.1)
    with pytest.raises(InputError, match="CUDA"):
        AssociationRules(["1", "2"], {"1": 0, "2": 1}, [], [3, 2])
    (tmp_path / "D.dat").write_text("1 2\n2 3\n")
    (tmp_path / "U.dat").write_text("1\n")
    rc = torch_main([str(tmp_path) + "/", str(tmp_path) + "/out-"])
    assert rc == 2
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "out-freqItemset").exists()
    monkeypatch.setenv("FA_MINE_ENGINE", "vertical")
    rc = torch_main([str(tmp_path) + "/", str(tmp_path) + "/out-"])
    assert rc == 2
    assert "CUDA" in capsys.readouterr().err
    with pytest.raises(InputError, match="CUDA"):
        FastApriori(0.1, config=MinerConfig(mine_engine="vertical"))
    monkeypatch.delenv("FA_MINE_ENGINE")
    # Asked for explicitly, the CPU is fine.
    assert FastApriori(0.1, device="cpu").ctx.platform == "cpu"


def test_fused_engine_is_refused(tmp_path, capsys):
    with pytest.raises(InputError, match="later slice"):
        FastApriori(0.1, config=MinerConfig(engine="fused"), device="cpu")
    (tmp_path / "D.dat").write_text("1 2\n")
    (tmp_path / "U.dat").write_text("1\n")
    rc = torch_main([str(tmp_path) + "/", str(tmp_path) + "/o-",
                     "--engine", "fused", "--platform", "cpu"])
    assert rc == 2
    assert "not ported yet" in capsys.readouterr().err


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
