"""The port stands alone and never quietly runs on the CPU:

- importing fastapriori_tpu_torch (and its CLI) leaves jax and the JAX
  package out of sys.modules, and no module of the port, nor
  chip_smoke.py, has an import statement naming either;
- without a CUDA device, every entry point that was not asked for the CPU
  raises InputError (the CLI exits 2), and chip_smoke.py exits non-zero
  without a result line;
- an engine name the port does not know is refused by name;
- no code of the port names a path under the JAX package (it builds and
  loads only its own native sources).

The vertical engine's modules (ops/vertical.py, ops/vertical_kernel.py,
utils/env.py), the device rule engine's (rules/gen.py, ops/contain.py,
device.py), the reliability core's (reliability/*, io/checkpoint.py,
io/resume.py), observability's (obs/*: alone they import neither jax
nor torch, so not torch.profiler) and the serving tier's (serve/*) are
imported by name, and a forced vertical mine or a
forced device rule engine without a CUDA device is refused like any
other run.  fsspec is imported only inside the functions that open a
remote path: importing the port, and a local run, leave it out.
"""

import ast
import os
import re
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
        "fastapriori_tpu_torch.ops.fused, "
        "fastapriori_tpu_torch.utils.env, fastapriori_tpu_torch.native, "
        "fastapriori_tpu_torch.native.loader, fastapriori_tpu_torch.device, "
        "fastapriori_tpu_torch.rules.gen, fastapriori_tpu_torch.ops.contain, "
        "fastapriori_tpu_torch.models.recommender, "
        "fastapriori_tpu_torch.reliability.failpoints, "
        "fastapriori_tpu_torch.reliability.ledger, "
        "fastapriori_tpu_torch.reliability.retry, "
        "fastapriori_tpu_torch.reliability.watchdog, "
        "fastapriori_tpu_torch.io.checkpoint, "
        "fastapriori_tpu_torch.io.resume, fastapriori_tpu_torch.io.writer, "
        "fastapriori_tpu_torch.obs, fastapriori_tpu_torch.obs.trace, "
        "fastapriori_tpu_torch.obs.flight, fastapriori_tpu_torch.obs.metrics, "
        "fastapriori_tpu_torch.obs.device_trace, "
        "fastapriori_tpu_torch.serve, fastapriori_tpu_torch.serve.state, "
        "fastapriori_tpu_torch.serve.server, "
        "fastapriori_tpu_torch.serve.loadgen, "
        "fastapriori_tpu_torch.serve.router, "
        "fastapriori_tpu_torch.models.apriori, "
        "fastapriori_tpu_torch.models.candidates, "
        "fastapriori_tpu_torch.io.reader, fastapriori_tpu_torch.preprocess, "
        "fastapriori_tpu_torch.utils.datagen\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'fastapriori_tpu', 'fsspec'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_serving_worker_leaves_jax_out(tmp_path):
    """The ProcHost worker, run as ``python -m
    fastapriori_tpu_torch.serve.router --worker``, imports neither jax
    nor the JAX package (here it exits 2: no serving.npz to load)."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['router', '--worker', '--dir', {str(tmp_path)!r}, "
        f"'--serving', {str(tmp_path / 'none') + '/'!r}, "
        "'--platform', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('fastapriori_tpu_torch.serve.router', "
        "run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'fastapriori_tpu'))\n"
        "print(rc, ','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2"], out.stdout
    assert "serving checkpoint" in out.stderr


OBS_MODULES = ("fastapriori_tpu_torch.obs", "fastapriori_tpu_torch.obs.trace",
               "fastapriori_tpu_torch.obs.flight",
               "fastapriori_tpu_torch.obs.metrics",
               "fastapriori_tpu_torch.obs.device_trace")


def test_obs_imports_leave_jax_and_the_profiler_out():
    """The observability modules are standard library plus the port's
    own at import: no jax, no JAX package, no torch (so no
    torch.profiler, which device_trace imports inside a capture only)."""
    code = (
        "import sys\n"
        f"for m in {OBS_MODULES!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'fastapriori_tpu', 'torch'))\n"
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
            os.path.join("fastapriori_tpu_torch", "utils", "env.py"),
            os.path.join("fastapriori_tpu_torch", "rules", "gen.py"),
            os.path.join("fastapriori_tpu_torch", "ops", "contain.py"),
            os.path.join("fastapriori_tpu_torch", "device.py"),
            os.path.join("fastapriori_tpu_torch", "reliability", "retry.py"),
            os.path.join("fastapriori_tpu_torch", "reliability",
                         "watchdog.py"),
            os.path.join("fastapriori_tpu_torch", "io", "checkpoint.py"),
            os.path.join("fastapriori_tpu_torch", "io", "resume.py"),
            *(os.path.join("fastapriori_tpu_torch", "obs", n + ".py")
              for n in ("__init__", "trace", "flight", "metrics",
                        "device_trace")),
            *(os.path.join("fastapriori_tpu_torch", "serve", n + ".py")
              for n in ("__init__", "state", "server", "loadgen",
                        "router"))} <= names
    for path in files:
        assert FORBIDDEN.isdisjoint(_imported_roots(path)), path


def test_fsspec_is_imported_only_for_a_remote_path(tmp_path):
    """No module of the port imports fsspec at its top level, and a local
    CLI run with checkpoints and phase-1 artifacts leaves it out."""
    for dirpath, _, names in os.walk(PKG):
        for n in names:
            if not n.endswith(".py"):
                continue
            with open(os.path.join(dirpath, n)) as f:
                tree = ast.parse(f.read())
            top = [a.name for node in tree.body
                   if isinstance(node, ast.Import) for a in node.names]
            top += [node.module for node in tree.body
                    if isinstance(node, ast.ImportFrom) and node.module]
            assert "fsspec" not in top, n
    (tmp_path / "D.dat").write_text("1 2\n2 3\n1 2 3\n")
    (tmp_path / "U.dat").write_text("1\n")
    out = str(tmp_path) + "/out-"
    code = (
        "import sys\n"
        "from fastapriori_tpu_torch.cli import main\n"
        f"assert main([{str(tmp_path) + '/'!r}, {out!r}, '--platform', "
        "'cpu', '--min-support', '0.3', '--checkpoint-every-level', "
        "'--save-counts']) == 0\n"
        f"assert main([{str(tmp_path) + '/'!r}, {out!r}, '--platform', "
        f"'cpu', '--resume-from', {out!r}]) == 0\n"
        "print('fsspec' in sys.modules)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


# A path under the JAX package: "fastapriori_tpu/...", or the bare
# directory name as a path component (not fastapriori_tpu_torch).
JAX_PATH = re.compile(r"fastapriori_tpu(?![\w])(/|\\|$)")


def _code_strings(path):
    """The string constants of a Python file, docstrings left out."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


def test_no_source_of_the_port_names_a_jax_package_path():
    checked = set()
    for dirpath, _, names in os.walk(PKG):
        if "_build" in dirpath.split(os.sep):
            continue
        for n in names:
            path = os.path.join(dirpath, n)
            if n.endswith(".py"):
                strings = list(_code_strings(path))
            elif n.endswith((".cc", ".cu")):
                with open(path) as f:
                    text = f.read()
                strings = re.findall(r'"(?:[^"\\\n]|\\.)*"', text)
                strings += re.findall(r"#include\s*<[^>]*>", text)
            else:
                continue
            checked.add(os.path.relpath(path, PKG))
            for text in strings:
                assert not JAX_PATH.search(text), (path, text)
    assert {os.path.join("csrc", "preprocess.cc"),
            os.path.join("native", "loader.py"),
            os.path.join("ops", "build.py")} <= checked
    assert JAX_PATH.search("fastapriori_tpu/native/libfa_native.so")
    assert JAX_PATH.search("fastapriori_tpu")
    assert not JAX_PATH.search("fastapriori_tpu_torch/csrc/preprocess.cc")


def test_no_cuda_means_an_error_not_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(InputError, match="CUDA"):
        FastApriori(0.1)
    with pytest.raises(InputError, match="CUDA"):
        AssociationRules([], ["1", "2"], {"1": 0, "2": 1},
                         levels=[], item_counts=[3, 2])
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


def test_serve_without_cuda_exits_2(tmp_path):
    """``python -m fastapriori_tpu_torch serve`` without a CUDA device and
    without ``--platform cpu`` exits 2 naming CUDA, and writes nothing."""
    (tmp_path / "D.dat").write_text("1 2\n2 3\n1 2 3\n")
    (tmp_path / "U.dat").write_text("1\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "fastapriori_tpu_torch", "serve",
         str(tmp_path) + "/", str(tmp_path) + "/out-", "--min-support",
         "0.3"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 2, out.stderr
    assert "CUDA" in out.stderr
    assert not (tmp_path / "out-recommends").exists()


def test_forced_device_rule_engine_without_cuda_is_refused(
        monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("FA_RULE_ENGINE", "device")
    (tmp_path / "D.dat").write_text("1 2\n2 3\n1 2 3\n")
    (tmp_path / "U.dat").write_text("1\n")
    rc = torch_main([str(tmp_path) + "/", str(tmp_path) + "/out-"])
    assert rc == 2
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "out-recommends").exists()
    with pytest.raises(InputError, match="CUDA"):
        AssociationRules([], ["1", "2"], {"1": 0, "2": 1},
                         levels=[], item_counts=[3, 2],
                         config=MinerConfig(rule_engine="device"))


def test_unknown_engine_is_refused(tmp_path, capsys):
    with pytest.raises(InputError, match="'fuse'"):
        FastApriori(0.1, config=MinerConfig(engine="fuse"), device="cpu")
    (tmp_path / "D.dat").write_text("1 2\n")
    (tmp_path / "U.dat").write_text("1\n")
    with pytest.raises(SystemExit) as exc:
        torch_main([str(tmp_path) + "/", str(tmp_path) + "/o-",
                    "--engine", "fuse", "--platform", "cpu"])
    assert exc.value.code == 2
    assert "'fuse'" in capsys.readouterr().err
    assert not (tmp_path / "o-freqItemset").exists()


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
