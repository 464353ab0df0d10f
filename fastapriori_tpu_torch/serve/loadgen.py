"""Open-loop load generation for the serving tier (counterpart:
fastapriori_tpu/serve/loadgen.py ``arrival_offsets``, ``percentiles_ms``
and ``run_open_loop``).

Arrivals follow a seeded Poisson schedule that does not wait for
completions, so queueing and overload show as latency and recorded
sheds, and latency counts from each request's scheduled arrival (a
lagging generator counts against the server).  The schedule is the JAX
package's, byte for byte, for the same (n, rate, seed).  Pure host code;
every wait is bounded.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from fastapriori_tpu_torch.errors import InputError


def arrival_offsets(n_requests: int, rate_rps: float, seed: int) -> np.ndarray:
    """``n`` cumulative arrival offsets (seconds from t0) with
    exponential gaps at ``rate_rps``, from ``numpy.random.default_rng
    (seed)``."""
    if rate_rps <= 0:
        raise InputError(f"rate_rps must be positive, got {rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)
    return np.cumsum(gaps)


def percentiles_ms(latencies_ms: Sequence[float]) -> dict:
    if not len(latencies_ms):
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
    arr = np.asarray(latencies_ms, dtype=np.float64)
    return {
        "p50_ms": round(float(np.percentile(arr, 50)), 2),
        "p95_ms": round(float(np.percentile(arr, 95)), 2),
        "p99_ms": round(float(np.percentile(arr, 99)), 2),
    }


def run_open_loop(
    server,
    baskets: Sequence[Sequence[str]],
    *,
    rate_rps: float,
    n_requests: int,
    seed: int,
    drain_timeout_s: float = 60.0,
    label: str = "open_loop",
    requests_out: Optional[List] = None,
) -> dict:
    """Drive ``server`` (a RecommendServer or a MeshRouter) with a seeded
    open-loop burst: request i is basket ``i mod len(baskets)``,
    submitted once its scheduled offset has passed (every due arrival in
    one sweep).  Returns the record: offered and achieved rates,
    percentile latencies over the served requests, shed, failed and
    queue counts, batches and their average fill."""
    if not baskets:
        raise InputError("run_open_loop needs a non-empty basket pool")
    offsets = arrival_offsets(n_requests, rate_rps, seed)
    server.reset_max_queue()
    before = server.stats()
    reqs: List = []
    t0 = time.monotonic()
    i = 0
    while i < n_requests:
        now = time.monotonic() - t0
        while i < n_requests and offsets[i] <= now:
            reqs.append(server.submit(baskets[i % len(baskets)],
                                      t_sched=t0 + offsets[i]))
            i += 1
        if i < n_requests:
            time.sleep(min(max(offsets[i] - (time.monotonic() - t0), 0.0),
                           0.002))
    if requests_out is not None:
        requests_out.extend(reqs)
    drained = server.wait_for(reqs, timeout_s=drain_timeout_s)
    t_end = time.monotonic()
    served = [r for r in reqs if r.done and not r.shed and r.error is None]
    shed = sum(1 for r in reqs if r.shed)
    failed = sum(1 for r in reqs if r.error is not None)
    lat = [r.latency_ms() for r in served]
    last_done = max((r.t_done for r in served), default=t_end)
    wall = max(last_done - t0, 1e-9)
    after = server.stats()
    out = {
        "label": label,
        "seed": seed,
        "n_requests": n_requests,
        "offered_rps": round(rate_rps, 1),
        "scheduled_rps": round(float(n_requests / offsets[-1]), 1),
        "achieved_rps": round(len(served) / wall, 1),
        "served": len(served),
        "shed": shed,
        "failed": failed,
        "drained": drained,
        "wall_s": round(t_end - t0, 3),
        "max_queue": after["max_queue"],
        "batches": after["batches"] - before["batches"],
        **percentiles_ms(lat),
    }
    n_batches = out["batches"]
    out["avg_batch"] = round(len(served) / n_batches, 1) if n_batches else 0
    return out
