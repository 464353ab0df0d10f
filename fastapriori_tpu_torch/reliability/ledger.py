"""Degradation ledger: every fallback becomes a structured event
(counterpart: fastapriori_tpu/reliability/ledger.py, without its
flight-recorder and span-tracer hooks).

The engines degrade in a handful of places (a pair or level-3 budget
that overflowed, a fused attempt salvaged into the level engine, a
forced device rule engine that fell back, a retried fetch, a walk down a
cascade chain, an unloadable native library).  Each such place calls
:func:`record`; the event lands in

- the in-memory ledger (``snapshot()``/``summary()``): a run whose
  summary is empty did not degrade;
- the attached metrics logger (:func:`attach_metrics`, the miner's
  ``--metrics`` stream) as an ``event="degraded"`` line;
- stderr, once per ``(kind, once_key)``.

The ledger is a process singleton: the sites that degrade have no
config or logger in scope.  Tests ``reset()`` around assertions.
"""

from __future__ import annotations

import sys
import threading
from collections import Counter
from typing import Any, Dict, List, Optional


class DegradationLedger:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._warned: set = set()
        self._metrics = None  # the attached MetricsLogger (latest wins)

    def attach_metrics(self, metrics) -> None:
        """Forward future events to ``metrics.emit("degraded", ...)``."""
        self._metrics = metrics

    def record(
        self, kind: str, once_key: Optional[str] = None, **fields: Any
    ) -> None:
        event = {"kind": kind, **fields}
        warn_key = (kind, once_key if once_key is not None else kind)
        with self._lock:
            self._events.append(event)
            first = warn_key not in self._warned
            if first:
                self._warned.add(warn_key)
            metrics = self._metrics
        if metrics is not None:
            metrics.emit("degraded", **event)
        if first:
            detail = " ".join(f"{k}={v}" for k, v in fields.items())
            print(
                f"fastapriori: degraded: {kind}"
                + (f" ({detail})" if detail else ""),
                file=sys.stderr,
            )

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def summary(self) -> Dict[str, int]:
        """Event counts by kind."""
        with self._lock:
            return dict(Counter(e["kind"] for e in self._events))

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._warned.clear()


LEDGER = DegradationLedger()


def record(kind: str, once_key: Optional[str] = None, **fields: Any) -> None:
    LEDGER.record(kind, once_key=once_key, **fields)


def attach_metrics(metrics) -> None:
    LEDGER.attach_metrics(metrics)


def snapshot() -> List[Dict[str, Any]]:
    return LEDGER.snapshot()


def summary() -> Dict[str, int]:
    return LEDGER.summary()


def reset() -> None:
    LEDGER.reset()
