"""The traced run's device trace and the program's spans, on one clock.

:class:`Capture` brackets the measured window with ``torch.profiler``
(host and CUDA activity) and marks the profiler's clock against
``time.perf_counter`` with ``record_function`` markers.  :class:`Trace`
reads the exported Chrome trace: each device operation, and for each
kernel the host time of the call that launched it.  Time is attributed
to a layer by the program span that was open when the kernel was
launched (:data:`STAGES`), never by the kernel's name, so a kernel that
a later change renames, fuses or replaces is still charged to the same
layer.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MARK = "portbench.clock"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# Layers by the program spans that launch their kernels, most specific
# first: a kernel goes to the first stage with a span open at its launch.
# Spans come from the program's tracer (obs/trace.py); the stage names
# are the layers of PERF.md.
STAGES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("ingest", ("preprocess",)),
    ("layout_build", ("bitmap_build", "arena_build")),
    ("mine_levels", ("level", "tail_fuse", "fused_mine", "counts_resolve")),
    ("rules", ("gen_rules",)),
    ("recommend", ("user_dedup", "first_match")),
    ("mine", ("mine",)),
)


class Capture:
    """``torch.profiler`` over a window, exported to ``path``."""

    def __init__(self, path: str):
        self.path = path
        self.marks: List[float] = []
        self._prof = None

    def mark(self) -> None:
        from torch.profiler import record_function

        t = time.perf_counter()
        with record_function(MARK):
            pass
        self.marks.append(t)

    def __enter__(self) -> "Capture":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(3):
            self.mark()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        import torch

        self.t1 = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        for _ in range(3):
            self.mark()
        self._prof.__exit__(*exc)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        return False


class Spans:
    """Program spans on the ``perf_counter`` clock: name, start, end,
    thread."""

    def __init__(self):
        self.name: List[str] = []
        self.t0: List[float] = []
        self.t1: List[float] = []
        self.thread: List[str] = []
        self.args: List[dict] = []

    def add_tracer_events(self, events: Sequence[dict],
                          epoch: float) -> None:
        for e in events:
            if e.get("ph") != "X":
                continue
            t0 = epoch + e["ts_us"] / 1e6
            self.name.append(e["name"])
            self.t0.append(t0)
            self.t1.append(t0 + e["dur_us"] / 1e6)
            self.thread.append(e.get("thread", ""))
            self.args.append(e.get("args", {}))

    def of(self, names: Sequence[str]) -> List[int]:
        want = set(names)
        return [i for i, n in enumerate(self.name) if n in want]

    def intervals(self, names: Sequence[str]) -> np.ndarray:
        """Merged [start, end] rows of the spans named ``names``."""
        idx = self.of(names)
        if not idx:
            return np.zeros((0, 2))
        iv = np.array([[self.t0[i], self.t1[i]] for i in idx])
        return merge(iv)


def tracer_epoch() -> float:
    """The program tracer's clock origin on ``perf_counter``: an instant
    event recorded now, read back."""
    from fastapriori_tpu_torch.obs import trace

    t = time.perf_counter()
    trace.instant(MARK)
    ev = [e for e in trace.TRACER.events()
          if e.get("ph") == "i" and e.get("name") == MARK]
    if not ev:
        raise RuntimeError("the program tracer is not recording")
    return t - ev[-1]["ts_us"] / 1e6


def merge(iv: np.ndarray) -> np.ndarray:
    """Union of [start, end] rows, as sorted disjoint rows."""
    if iv.shape[0] == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out)


def inside(times: np.ndarray, iv: np.ndarray) -> np.ndarray:
    """Which ``times`` fall in one of the disjoint sorted rows ``iv``."""
    if iv.shape[0] == 0 or times.size == 0:
        return np.zeros(times.shape, dtype=bool)
    pos = np.searchsorted(iv[:, 0], times, side="right") - 1
    ok = pos >= 0
    pos = np.maximum(pos, 0)
    return ok & (times <= iv[pos, 1])


class Trace:
    """The device operations of a :class:`Capture`, on ``perf_counter``
    seconds: start, duration, name, category, and for each the host time
    of its launch (NaN where none was recorded)."""

    def __init__(self, path: str, marks: Sequence[float]):
        with open(path) as f:
            doc = json.load(f)
        events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
        mark_ts = sorted(e["ts"] for e in events
                         if e.get("name") == MARK and e.get("ph") == "X")
        if len(mark_ts) != len(marks):
            raise RuntimeError(f"{len(mark_ts)} clock marks in the trace, "
                               f"{len(marks)} made")
        # Profiler microseconds minus perf_counter microseconds.
        self.offset_us = statistics.median(
            ts - m * 1e6 for ts, m in zip(mark_ts, sorted(marks)))
        launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and e.get("ph") == "X":
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = e["ts"]
        rows = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in DEVICE_CATS
                and isinstance(e.get("dur"), (int, float))]
        self.name = [e["name"] for e in rows]
        self.cat = np.array([e["cat"] for e in rows], dtype=object)
        self.start = np.array([self._s(e["ts"]) for e in rows])
        self.dur = np.array([e["dur"] / 1e6 for e in rows])
        self.launch = np.array([
            self._s(launch[c]) if (c := (e.get("args") or {}).get(
                "correlation")) in launch else np.nan for e in rows])
        self.is_kernel = self.cat == "kernel"

    def _s(self, ts_us: float) -> float:
        return (ts_us - self.offset_us) / 1e6

    def busy_s(self, t0: float, t1: float) -> float:
        """Seconds of [t0, t1] in which an operation ran on the device."""
        iv = np.stack([self.start, self.start + self.dur], axis=1) \
            if self.start.size else np.zeros((0, 2))
        iv = merge(np.clip(iv, t0, t1))
        return float((iv[:, 1] - iv[:, 0]).sum()) if iv.size else 0.0

    def kernel_s_launched_in(self, iv: np.ndarray) -> float:
        """Device seconds of the kernels launched inside the rows ``iv``."""
        sel = self.is_kernel & inside(self.launch, iv)
        return float(self.dur[sel].sum())

    def stages(self, spans: Spans) -> Dict[str, float]:
        """Device seconds of every operation by the stage its launch lies
        in; ``other`` for the rest (no launch recorded, or no stage's
        span open)."""
        left = np.ones(self.dur.shape, dtype=bool)
        out: Dict[str, float] = {}
        for stage, names in STAGES:
            sel = left & inside(self.launch, spans.intervals(names))
            out[stage] = float(self.dur[sel].sum())
            left &= ~sel
        out["other"] = float(self.dur[left].sum())
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        totals: Dict[str, float] = {}
        for name, d in zip(self.name, self.dur.tolist()):
            totals[name] = totals.get(name, 0.0) + d
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], s] for name, s in top]

    def idle_gaps(self, t0: float, t1: float, spans: Spans,
                  n: int = 10) -> List[list]:
        """The longest stretches of [t0, t1] with nothing on the device,
        each named by the innermost program span open at its middle
        (``harness`` where none was)."""
        iv = np.stack([self.start, self.start + self.dur], axis=1) \
            if self.start.size else np.zeros((0, 2))
        iv = merge(np.clip(iv, t0, t1))
        edges = np.concatenate([[t0], iv.ravel(), [t1]]).reshape(-1, 2)
        lens = edges[:, 1] - edges[:, 0]
        order = np.argsort(-lens)[:n]
        t0s = np.asarray(spans.t0)
        t1s = np.asarray(spans.t1)
        out = []
        for i in order:
            if lens[i] <= 0:
                continue
            mid = (edges[i, 0] + edges[i, 1]) / 2
            open_ = np.flatnonzero((t0s <= mid) & (t1s >= mid)) \
                if t0s.size else np.zeros(0, int)
            label = "harness"
            if open_.size:
                j = open_[np.argmax(t0s[open_])]
                label = f"{spans.thread[j]}:{spans.name[j]}"
            out.append([label, float(lens[i])])
        return out


def window_device(run, cap: Capture, spans: Spans,
                  log=None) -> Optional[Trace]:
    """Read the capture, fill ``run.device``'s ``busy_s`` and ``window_s``
    and ``run.breakdown``, and log the device time by stage."""
    tr = Trace(cap.path, cap.marks)
    window = cap.t1 - cap.t0
    run.device["busy_s"] = tr.busy_s(cap.t0, cap.t1) / max(run.chips, 1)
    run.device["window_s"] = window
    run.breakdown = {"device_ops": tr.top_ops(),
                     "idle_gaps": tr.idle_gaps(cap.t0, cap.t1, spans)}
    if log is not None:
        log("device seconds by the stage that launched them:",
            json.dumps(tr.stages(spans)))
    return tr
