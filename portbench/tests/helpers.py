"""A tiny copy of the benchmark in a temporary root, run on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The configurations cut to a size a test run holds; every other setting
# (generator, layout, min-support rule) as committed.
TINY = {
    "t10i4d100k": {"n_txns": 3000, "n_items": 100, "n_users": 300,
                   "min_support": 0.02},
}


def tiny_root(tmp_path) -> str:
    """BENCHMARK.json and portbench/ copied under ``tmp_path``, the port
    linked in, the configurations cut to :data:`TINY`."""
    root = str(tmp_path / "root")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "fastapriori_tpu_torch"),
               os.path.join(root, "fastapriori_tpu_torch"))
    for name, cut in TINY.items():
        path = os.path.join(root, "portbench", "configs", name + ".json")
        cfg = json.load(open(path))
        cfg.update(cut)
        json.dump(cfg, open(path, "w"))
    return root


def run_cell(root: str, workload: str, seed: int = 11, seconds: float = 1.0,
             trace: int = 0, jobs=None):
    """One run on the CPU in this process: (exit code, last stdout line
    parsed or None, stderr text).  The process's environment is restored
    afterwards (a run sets its configuration's)."""
    from portbench import run

    env = dict(os.environ)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run.main(["--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          root=root, platform="cpu", jobs=jobs)
    finally:
        os.environ.clear()
        os.environ.update(env)
    lines = out.getvalue().strip().splitlines()
    line = json.loads(lines[-1]) if lines and rc == 0 else None
    return rc, line, err.getvalue()


def card_present() -> bool:
    import torch

    return torch.cuda.is_available()

