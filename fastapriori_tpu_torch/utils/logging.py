"""Structured per-phase metrics (counterpart: fastapriori_tpu/utils/
logging.py ``MetricsLogger`` and ``phase_timer``): one JSON object per
line on stderr when enabled, each with its phase's wall time.  Every
event is also kept in ``records`` (enabled or not, up to the logger's
``records_cap``, then counted in ``records_dropped``), where tests and
in-process callers read it.

The same events feed the span tracer (obs/trace.py): every ``timed``
section is a span carrying the section's fields, every ``emit`` an
instant event, so the JSON metrics stream and the Chrome trace are two
views of one event source.  Disabled, the tracer costs one branch per
section.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Optional

from fastapriori_tpu_torch.obs import trace

# Retention cap of MetricsLogger.records (a batch run emits tens).
RECORDS_CAP = 100_000

# The process's active logger, the latest enabled one (the ledger's
# latest-binding rule): phase_timer emits its phase walls through it.
_active: Optional["MetricsLogger"] = None


def active_logger() -> Optional["MetricsLogger"]:
    return _active


class MetricsLogger:
    def __init__(self, enabled: bool = False, records_cap: int = RECORDS_CAP):
        global _active
        self.enabled = enabled
        self.records: list = []
        self.records_cap = records_cap
        self.records_dropped = 0
        if enabled:
            _active = self

    def _record(self, rec: dict) -> None:
        if len(self.records) < self.records_cap:
            self.records.append(rec)
        else:
            self.records_dropped += 1
        if self.enabled:
            print(json.dumps(rec), file=sys.stderr)

    def emit(self, event: str, **fields) -> None:
        trace.instant(event, **fields)
        self._record({"event": event, **fields})

    def bind_global_ledger(self) -> "MetricsLogger":
        """Route degradation-ledger events (reliability/ledger.py) through
        this logger as ``event="degraded"`` records; the latest binding
        wins."""
        from fastapriori_tpu_torch.reliability import ledger

        ledger.attach_metrics(self)
        return self

    @contextlib.contextmanager
    def timed(self, event: str, **fields):
        """Time the block as one span; the caller may add fields to the
        yielded dict.  The record is written in a ``finally``, so a
        section that raises still leaves its fields (and the span its
        ``error``)."""
        t0 = time.perf_counter()
        with trace.span(event, **fields) as sp:
            try:
                yield fields
            finally:
                fields.setdefault(
                    "wall_ms", round((time.perf_counter() - t0) * 1e3, 3))
                sp.update(**fields)
                self._record({"event": event, **fields})


@contextlib.contextmanager
def phase_timer(label: str, enabled: bool = True, metrics=None):
    """Reference-style ``==== Use Time <label> <ms>`` phase wall
    (FastApriori.scala:108) as a ``phase`` span, and a ``phase`` event
    through ``metrics`` or the active logger; the human line prints only
    when ``enabled`` (the CLI prints its own ``====`` lines)."""
    t0 = time.perf_counter()
    with trace.span("phase", label=label):
        yield
    ms = int((time.perf_counter() - t0) * 1e3)
    logger = metrics if metrics is not None else _active
    if logger is not None:
        logger.emit("phase", label=label, wall_ms=ms)
    if enabled:
        print(f"==== Use Time {label} {ms}", file=sys.stderr)
