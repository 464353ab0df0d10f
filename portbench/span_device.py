"""Device time of the kernels launched under some of the port's spans,
per job of the window."""

from __future__ import annotations

from typing import Optional, Sequence


def device_ms_per_job(run, span_names: Sequence[str]) -> Optional[float]:
    """The device time of the kernels launched under ``span_names`` over
    the jobs, in ms; None where no such span or kernel is there."""
    tr = run.records.get("trace")
    spans = run.records.get("spans")
    n = len(run.records.get("jobs", ()))
    if tr is None or spans is None or not n or not spans.of(span_names):
        return None
    device_s = tr.kernel_s_launched_in(spans.intervals(span_names))
    if device_s <= 0:
        return None
    return device_s * 1e3 / n
