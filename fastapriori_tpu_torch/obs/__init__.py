"""Observability (counterpart: fastapriori_tpu/obs/), standard library
plus the port's own modules at import:

- :mod:`~fastapriori_tpu_torch.obs.trace`: nestable, thread-aware spans
  with deterministic ids, exported as Chrome trace-event JSON (Perfetto
  loads it); near-zero cost when disabled.
- :mod:`~fastapriori_tpu_torch.obs.metrics`: allocation-free counters,
  gauges and fixed-bucket histograms with a Prometheus-text snapshot.
- :mod:`~fastapriori_tpu_torch.obs.flight`: a bounded ring of the last N
  span, ledger and watchdog events, dumped as a manifest-committed
  artifact on classified errors and at the watchdog's abandoned-thread
  cap.
- :mod:`~fastapriori_tpu_torch.obs.device_trace`: ``torch.profiler``
  capture (imported inside the capture only) and a gzip + json parser
  that attributes device time per kernel and stage.
"""

from fastapriori_tpu_torch.obs import (  # noqa: F401
    device_trace,
    flight,
    metrics,
    trace,
)
from fastapriori_tpu_torch.obs.metrics import MetricsRegistry  # noqa: F401
from fastapriori_tpu_torch.obs.trace import TRACER, span  # noqa: F401
