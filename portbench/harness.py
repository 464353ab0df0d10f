"""What every cell shares: finding the cell's files by name, the run's
directories, the card check, the metric readers, the checks that decide
``correct`` and the result line.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``mixes/<name>.json``); the mix names its driver (``drivers/<name>.py``),
and each metric is read by ``metrics/<name>.py``.  A later change adds a
cell, a mix, a configuration or a metric by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names that may not be loaded in a run's process: the
# JAX package and JAX itself, compared whole (the port's name begins with
# the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fastapriori_tpu")


class CellError(Exception):
    """A run that cannot produce a result (exit 2, no result line)."""


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it.get("name") == name:
            return it
    raise CellError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: str, name: str) -> ModuleType:
    """A module of the benchmark by file path (names may hold dots)."""
    if not os.path.isfile(path):
        raise CellError(f"missing file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        "portbench_dyn." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that are forbidden."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


class Run:
    """One run of one cell: its inputs, its directories and what the
    driver and the readers hand each other."""

    def __init__(self, bench: dict, workload: str, seed: int,
                 seconds: float, trace: bool, root: str = ROOT,
                 t_start: Optional[float] = None):
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.root = root
        self.bench = bench
        self.cell = find(bench["workloads"], workload, "workload")
        # The benchmark's files under this checkout's root.
        self.home = os.path.join(root, "portbench")
        self.config = load_json(os.path.join(
            self.home, "configs", self.cell["config"] + ".json"))
        self.mix = load_json(os.path.join(
            self.home, "mixes", self.cell["traffic"] + ".json"))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.chips = int(self.cell["chips"])
        # Fixed paths inside the checkout: a later run of the same cell
        # reuses them, so a run writes what one run needs and no more.
        self.dir = os.path.join(root, ".portbench", "runs", workload)
        os.makedirs(self.dir, exist_ok=True)
        self.t_window0: Optional[float] = None
        self.values: Dict[str, float] = {}   # metrics a driver measured
        self.records: Dict[str, Any] = {}    # what readers read
        self.checks: List[dict] = []
        self.attempted = 0
        self.failed = 0
        self.device: Dict[str, Any] = {}
        self.breakdown: Optional[dict] = None
        # "cuda" on the card; the harness's own tests drive a run on the
        # CPU at a tiny size with "cpu".
        self.platform = "cuda"
        self.inputs: Dict[str, Any] = {}
        # What runs the timed jobs, where a driver takes it: None is the
        # port; the controls put another system in its place.
        self.jobs = None

    def read_device_memory(self) -> None:
        """The peak of device memory on the fullest card."""
        peak = 0
        if self.platform == "cuda":
            import torch

            peak = max(torch.cuda.max_memory_allocated(d)
                       for d in range(torch.cuda.device_count()))
        self.device["memory_peak_bytes"] = int(peak)

    def free_device(self) -> None:
        if self.platform == "cuda":
            import torch

            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- metrics --------------------------------------------------------
    def metric_entries(self) -> List[dict]:
        """The metrics this run reports: with --trace 0 the cell's
        end-to-end metrics, with --trace 1 its per-layer metrics."""
        name = self.cell["name"]
        e2e = [m for m in self.bench["end_to_end"]
               if name in m.get("workloads", [name])]
        if not self.trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.bench.get("per_layer", [])
                if (name in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def read_metrics(self) -> Dict[str, dict]:
        """Each metric's reader (``metrics/<name>.py``, ``read(run)``); a
        reader that finds nothing returns None and the metric is left
        out."""
        out = {}
        for m in self.metric_entries():
            reader = load_module(os.path.join(self.home, "metrics",
                                              m["name"] + ".py"), m["name"])
            value = reader.read(self)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    # -- checks ---------------------------------------------------------
    def check(self, name: str, value: float, limit: float) -> bool:
        """A number that decides ``correct``: it passes at or under its
        limit."""
        self.checks.append({"name": name, "value": value, "limit": limit})
        return value <= limit

    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] <= c["limit"] for c in self.checks)


def card_info(chips: int) -> dict:
    """The card's name and count; raises CellError without enough CUDA
    cards (no fallback to the CPU)."""
    import torch

    if not torch.cuda.is_available():
        raise CellError("no CUDA device: torch.cuda.is_available() is false")
    n = torch.cuda.device_count()
    if n < chips:
        raise CellError(f"the cell needs {chips} cards, {n} visible")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def emit(run: Run, metrics: Dict[str, dict]) -> str:
    """The result line (stdout's last line); the checks go last on
    stderr, each with its limit."""
    line = {
        "correct": run.correct(),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": run.device,
    }
    if run.breakdown is not None:
        line["breakdown"] = run.breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in run.checks}
    for c in run.checks:
        print(f"check {c['name']} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    text = json.dumps(line)
    print(text, flush=True)
    return text


class GcWatch:
    """Pauses of Python's cyclic collector in a window (every thread
    stops for one): count and seconds of the full passes, for the log."""

    def __init__(self):
        self.full = []
        self._t0 = 0.0

    def _cb(self, phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.full.append(time.perf_counter() - self._t0)

    def __enter__(self) -> "GcWatch":
        import gc

        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> bool:
        import gc

        gc.callbacks.remove(self._cb)
        return False

    def summary(self) -> str:
        return (f"{len(self.full)} full collections, "
                f"{sum(self.full) * 1e3:.1f} ms in all, longest "
                f"{max(self.full, default=0.0) * 1e3:.1f} ms")


def log(*parts: Any) -> None:
    print("portbench:", *parts, file=sys.stderr, flush=True)
