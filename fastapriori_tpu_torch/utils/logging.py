"""Structured per-phase metrics (a small counterpart of
fastapriori_tpu/utils/logging.py ``MetricsLogger``): one JSON object per
line on stderr when enabled, each with its phase's wall time."""

from __future__ import annotations

import contextlib
import json
import sys
import time


class MetricsLogger:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled

    def emit(self, event: str, **fields) -> None:
        if self.enabled:
            print(json.dumps({"event": event, **fields}), file=sys.stderr)

    @contextlib.contextmanager
    def timed(self, event: str, **fields):
        """Time the block; the caller may add fields to the yielded dict."""
        t0 = time.perf_counter()
        yield fields
        fields["wall_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        self.emit(event, **fields)
