"""Device trace capture and per-kernel attribution (counterpart:
fastapriori_tpu/obs/device_trace.py, on ``torch.profiler`` in place of
``jax.profiler``).

The span tracer (obs/trace.py) sees host wall time: a ``level`` span
covers dispatch, device execution and the wait without saying which
kernel burned the time.  :func:`capture` brackets a region with
``torch.profiler.profile`` (CPU and, on a CUDA machine, CUDA activity)
and writes the profile as a gzip Chrome trace under ``logdir``;
:func:`kernel_summary` reads that artifact with the standard library
alone and sums device time per kernel, each kernel mapped onto the host
stage that launches it (:func:`stage_for_kernel`).

Contracts:

- Importing this module imports no part of ``torch.profiler``:
  :func:`capture` imports it inside, :func:`kernel_summary` is gzip and
  json only.
- A capture never crashes the run it observes: a profiler that fails to
  start or to stop, or whose device trace comes back empty on a CUDA
  machine, is a once-keyed ``device_trace_unavailable`` ledger event
  (``phase`` start, stop or empty), and the run goes on.
- ``FA_DEVICE_TRACE`` (strict flag) turns capture on where the caller
  passes ``explicit=False``; a value it does not know raises InputError.
- Kernel rows keep the profiler's full (demangled) kernel name: K1's and
  K2's sources each define an anonymous-namespace ``pack_kernel``, and
  only their parameter lists tell them apart, so rows are never merged
  by a short name.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

TRACE_SUFFIX = ".pt.trace.json.gz"
# Chrome-trace categories of device activity in a torch.profiler export.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_env_memo: Optional[bool] = None


def enabled_by_env() -> bool:
    """The strict ``FA_DEVICE_TRACE`` knob, parsed once per process
    (tests use :func:`reload_from_env`)."""
    global _env_memo
    if _env_memo is None:
        from fastapriori_tpu_torch.utils.env import env_flag

        _env_memo = env_flag("FA_DEVICE_TRACE", False)
    return _env_memo


def reload_from_env() -> None:
    global _env_memo
    _env_memo = None


def _unavailable(phase: str, exc: Optional[BaseException] = None,
                 **fields: Any) -> None:
    from fastapriori_tpu_torch.reliability import ledger

    if exc is not None:
        fields["error"] = f"{type(exc).__name__}: {exc}"[:200]
    ledger.record("device_trace_unavailable", once_key=phase, phase=phase,
                  **fields)


@contextmanager
def capture(logdir: str, explicit: bool = False) -> Iterator[Dict[str, Any]]:
    """Bracket a region with a ``torch.profiler`` capture written under
    ``logdir``.

    Yields a dict; after the block it holds ``active`` (whether a trace
    was written), and when active ``trace`` (the artifact's path) and
    ``device_events`` (kernel, memcpy and memset events in it).  Without
    ``explicit`` or ``FA_DEVICE_TRACE`` the body runs uncaptured.
    Profiler failures are ledgered (module docstring), never raised."""
    info: Dict[str, Any] = {"active": False, "trace_dir": logdir}
    if not (explicit or enabled_by_env()):
        yield info
        return
    prof = None
    cuda = False
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    except Exception as exc:  # the observer must not kill the run
        prof = None
        _unavailable("start", exc)
    try:
        yield info
    finally:
        if prof is not None:
            try:
                if cuda:
                    torch.cuda.synchronize()
                prof.stop()
                info.update(_write(prof, logdir))
                info["active"] = True
            except Exception as exc:  # ledgered; the mine goes on
                _unavailable("stop", exc)
            else:
                if cuda and not info["device_events"]:
                    _unavailable("empty", trace=info["trace"])


def _write(prof, logdir: str) -> Dict[str, Any]:
    """Export ``prof`` as ``<logdir>/capture_<ns>.pt.trace.json.gz``:
    the profiler's JSON, gzipped, the plain file removed."""
    os.makedirs(logdir, exist_ok=True)
    base = os.path.join(logdir, f"capture_{time.time_ns()}")
    raw = base + ".pt.trace.json"
    prof.export_chrome_trace(raw)
    try:
        with open(raw, "rb") as src, gzip.open(base + TRACE_SUFFIX,
                                               "wb") as dst:
            dst.write(src.read())
    finally:
        os.unlink(raw)
    doc = _load(base + TRACE_SUFFIX)
    return {"trace": base + TRACE_SUFFIX,
            "device_events": sum(1 for _ in _device_events(doc))}


def find_device_trace(trace_dir: str) -> Optional[str]:
    """The newest capture under ``trace_dir`` (``trace_dir`` itself when
    it is a capture file)."""
    if os.path.isfile(trace_dir):
        return trace_dir
    hits = sorted(glob.glob(os.path.join(trace_dir, "**", "*" + TRACE_SUFFIX),
                            recursive=True))
    return hits[-1] if hits else None


# Raw kernel names -> the host span stage that launches them.  Ordered:
# the first entry whose fragments all occur in the lower-cased name wins,
# so the port's kernel symbols come first.  K1 (csrc/level_counts.cu)
# launches, per call, pack_kernel (its parameters name the Scratch
# struct), prep_rows_kernel and level_counts_packed (packed form) or
# prep_dense_kernel, prep_items_kernel and level_counts_dense (dense
# form); K3
# (csrc/vertical_counts.cu) run_starts_kernel and vertical_counts_kernel;
# K2 (csrc/first_match.cu) its own pack_kernel and first_match_kernel.
# Then the JAX package's generic fragments.  Unmatched kernels map to
# "other": attribution never drops device time.
STAGE_PATTERNS = (
    (("level_counts_packed",), "mine.count"),
    (("level_counts_dense",), "mine.count"),
    (("prep_rows_kernel",), "mine.count"),
    (("prep_items_kernel",), "mine.count"),
    (("prep_dense_kernel",), "mine.count"),
    (("pack_kernel", "scratch"), "mine.count"),
    (("vertical_counts_kernel",), "mine.count"),
    (("run_starts_kernel",), "mine.count"),
    (("first_match_kernel",), "serve.scan"),
    (("pack_kernel",), "serve.scan"),
    (("strided_best_rank",), "serve.scan"),
    (("first_match",), "serve.scan"),
    (("serve",), "serve.scan"),
    (("vertical",), "mine.count"),
    (("count",), "mine.count"),
    (("contain",), "rules.join"),
    (("rule",), "rules.join"),
    (("gather",), "serve.scan"),
    (("convert",), "xfer"),
    (("copy",), "xfer"),
    (("memcpy",), "xfer"),
    (("transfer",), "xfer"),
)


def stage_for_kernel(name: str) -> str:
    """The stage of one raw kernel name (:data:`STAGE_PATTERNS`)."""
    low = name.lower()
    for frags, stage in STAGE_PATTERNS:
        if all(f in low for f in frags):
            return stage
    return "other"


def _load(path: str):
    with gzip.open(path, "rt", encoding="utf-8", errors="replace") as fh:
        return json.load(fh)


def _device_events(doc) -> Iterator[Dict[str, Any]]:
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    for ev in events:
        if (isinstance(ev, dict) and ev.get("ph") == "X"
                and ev.get("cat") in DEVICE_CATEGORIES
                and isinstance(ev.get("name"), str)
                and isinstance(ev.get("dur"), (int, float))):
            yield ev


def kernel_summary(trace_dir: str, top: int = 0) -> Dict[str, Any]:
    """Per-kernel device time of the newest capture under ``trace_dir``.

    Returns ``{"trace": path or None, "kernels": [{name, stage, calls,
    total_us}, ...], "by_stage": {stage: total_us}}``, the kernel rows
    (device events: kernels, copies, fills, by full name) sorted by
    total time, longest first (``top`` > 0 keeps that many rows; the
    stage sums always cover every event).  A missing or malformed trace
    gives an empty kernel list, never an exception."""
    path = find_device_trace(trace_dir)
    out: Dict[str, Any] = {"trace": path, "kernels": [], "by_stage": {}}
    if path is None:
        return out
    try:
        doc = _load(path)
    except (OSError, ValueError, EOFError):  # summarised as empty
        return out
    agg: Dict[str, list] = {}
    for ev in _device_events(doc):
        slot = agg.setdefault(ev["name"], [0, 0.0])
        slot[0] += 1
        slot[1] += float(ev["dur"])
    rows = [{"name": k, "stage": stage_for_kernel(k), "calls": n,
             "total_us": us} for k, (n, us) in agg.items()]
    rows.sort(key=lambda r: (-r["total_us"], r["name"]))
    by_stage: Dict[str, float] = {}
    for r in rows:
        by_stage[r["stage"]] = by_stage.get(r["stage"], 0.0) + r["total_us"]
    out["kernels"] = rows[:top] if top > 0 else rows
    out["by_stage"] = dict(sorted(by_stage.items(),
                                  key=lambda kv: (-kv[1], kv[0])))
    return out
