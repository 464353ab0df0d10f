"""Structured per-phase metrics (a small counterpart of
fastapriori_tpu/utils/logging.py ``MetricsLogger``): one JSON object per
line on stderr when enabled, each with its phase's wall time.  Every
event is also kept in ``records`` (enabled or not, up to
:data:`RECORDS_CAP`, then counted in ``records_dropped``), where tests
and in-process callers read it."""

from __future__ import annotations

import contextlib
import json
import sys
import time

# Retention cap of MetricsLogger.records (a batch run emits tens).
RECORDS_CAP = 100_000


class MetricsLogger:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.records: list = []
        self.records_dropped = 0

    def emit(self, event: str, **fields) -> None:
        rec = {"event": event, **fields}
        if len(self.records) < RECORDS_CAP:
            self.records.append(rec)
        else:
            self.records_dropped += 1
        if self.enabled:
            print(json.dumps(rec), file=sys.stderr)

    @contextlib.contextmanager
    def timed(self, event: str, **fields):
        """Time the block; the caller may add fields to the yielded dict."""
        t0 = time.perf_counter()
        yield fields
        fields["wall_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        self.emit(event, **fields)
