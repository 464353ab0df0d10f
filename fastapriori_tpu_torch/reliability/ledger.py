"""Degradation ledger: every fallback becomes a structured event
(counterpart: fastapriori_tpu/reliability/ledger.py).

The engines degrade in a handful of places (a pair or level-3 budget
that overflowed, a fused attempt salvaged into the level engine, a
forced device rule engine that fell back, a retried fetch, a walk down a
cascade chain, an unloadable native library).  Each such place calls
:func:`record`; the event lands in

- the in-memory ledger (``snapshot()``/``summary()``): a run whose
  summary is empty did not degrade;
- the flight recorder's ring (obs/flight.py), so a post-mortem dump
  shows the trips, retries and walks that led to a failure;
- the span tracer (obs/trace.py) as a ``degraded`` instant under the
  current span, so the event sits on the timeline it degraded;
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
        self._record(kind, once_key, fields, only_once=False)

    def record_once(self, kind: str, once_key: str, **fields: Any) -> None:
        """:meth:`record`, unless ``(kind, once_key)`` was recorded since
        the last :meth:`reset`: a choice that holds for the whole run,
        recorded at each site that makes it."""
        self._record(kind, once_key, fields, only_once=True)

    def _record(self, kind: str, once_key: Optional[str], fields: dict,
                only_once: bool) -> None:
        event = {"kind": kind, **fields}
        warn_key = (kind, once_key if once_key is not None else kind)
        with self._lock:
            first = warn_key not in self._warned
            if only_once and not first:
                return
            self._events.append(event)
            self._warned.add(warn_key)
            metrics = self._metrics
        from fastapriori_tpu_torch.obs import flight, trace

        flight.note("ledger", **{"event": kind, **fields})
        if metrics is not None:
            metrics.emit("degraded", **event)  # also the trace's instant
        else:
            trace.instant("degraded", **event)
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


def record_once(kind: str, once_key: str, **fields: Any) -> None:
    LEDGER.record_once(kind, once_key, **fields)


def attach_metrics(metrics) -> None:
    LEDGER.attach_metrics(metrics)


def snapshot() -> List[Dict[str, Any]]:
    return LEDGER.snapshot()


def summary() -> Dict[str, int]:
    return LEDGER.summary()


def reset() -> None:
    LEDGER.reset()
