"""Helpers the metric readers share (each metric is its own file under
``metrics/``)."""

from __future__ import annotations

from typing import Optional, Sequence


def span_ms_per_unit(run, names: Sequence[str]) -> Optional[float]:
    """Host milliseconds under the spans named ``names`` (their union, so
    nested ones count once), per job of the window."""
    spans = run.records.get("spans")
    n = len(run.records.get("jobs", ()))
    if spans is None or not n or not spans.of(names):
        return None
    iv = spans.intervals(names)
    return float((iv[:, 1] - iv[:, 0]).sum()) * 1e3 / n


def idle_pct(run) -> Optional[float]:
    dev = run.device
    if not dev.get("window_s"):
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])


def roofline_pct(run, least_s: float, span_names: Sequence[str]
                 ) -> Optional[float]:
    """The least time for the work over the device time of the kernels
    launched under ``span_names``; None when no such kernel ran."""
    tr = run.records.get("trace")
    spans = run.records.get("spans")
    if tr is None or spans is None:
        return None
    device_s = tr.kernel_s_launched_in(spans.intervals(span_names))
    if device_s <= 0:
        return None
    return 100.0 * least_s / device_s
