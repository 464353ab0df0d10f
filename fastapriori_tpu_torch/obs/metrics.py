"""Metrics registry: allocation-free instruments with a Prometheus
text snapshot (counterpart: fastapriori_tpu/obs/metrics.py).

The batch CLI feeds one instrument today: every audited fetch
(reliability/retry.py) observes its wall latency into the per-site
histogram ``fa_fetch_latency_ms`` of the process-global :data:`GLOBAL`
registry.  The serving tier's server holds its own registry of the same
instruments (queue depth, batch fill, shed counts) and exposes it while
it runs.

Hot-path discipline: every instrument is fixed-size at construction;
``observe``/``inc``/``set`` are integer increments plus, for
histograms, one binary search over a static bound tuple: no allocation
and no lock on the write path (single-writer counters tolerate torn
reads in a text snapshot; the GIL keeps int increments atomic).  The
Prometheus text form renders cumulative buckets
(``_bucket{le=...}``/``_sum``/``_count``) so any standard scraper
parses it.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

# Latency-shaped default bounds (milliseconds): sub-ms dispatch floors
# through multi-second stalls.
LATENCY_BUCKETS_MS = (
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0,
)


class Counter:
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def render(self) -> List[str]:
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} counter",
            f"{self.name} {self.value}",
        ]

    def snapshot(self):
        return self.value


class Gauge:
    __slots__ = ("name", "help", "value", "max_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0
        self.max_value = 0

    def set(self, v) -> None:
        self.value = v
        if v > self.max_value:
            self.max_value = v

    def render(self) -> List[str]:
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} gauge",
            f"{self.name} {self.value}",
            f"{self.name}_max {self.max_value}",
        ]

    def snapshot(self):
        return {"value": self.value, "max": self.max_value}


class Histogram:
    """Fixed-bucket histogram: ``bounds`` are upper bucket edges (an
    implicit +Inf bucket follows).  ``observe`` is one bisect over the
    static bound tuple + two int adds — exact bucket placement is
    test-pinned (a value equal to a bound lands in that bound's bucket,
    the Prometheus ``le`` contract)."""

    __slots__ = ("name", "help", "bounds", "counts", "total", "sum")

    def __init__(
        self, name: str, bounds: Sequence[float], help: str = ""
    ):
        self.name = name
        self.help = help
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(
                f"histogram {name}: bounds must be strictly increasing, "
                f"got {bounds}"
            )
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v

    def render(self) -> List[str]:
        out = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        cum = 0
        for bound, n in zip(self.bounds, self.counts):
            cum += n
            le = f"{bound:g}"
            out.append(f'{self.name}_bucket{{le="{le}"}} {cum}')
        cum += self.counts[-1]
        out.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        out.append(f"{self.name}_sum {round(self.sum, 6)}")
        out.append(f"{self.name}_count {self.total}")
        return out

    def snapshot(self):
        return {
            "buckets": dict(
                zip([f"{b:g}" for b in self.bounds] + ["+Inf"], self.counts)
            ),
            "count": self.total,
            "sum": round(self.sum, 6),
        }


class _LabeledHistogram:
    """One histogram per label value (bounded by the label cardinality —
    here the audited fetch sites, a finite census: obs/trace.py
    ``FETCH_SITE_SPANS``)."""

    __slots__ = ("name", "help", "label", "bounds", "series")

    def __init__(self, name, bounds, help="", label="site"):
        self.name = name
        self.help = help
        self.label = label
        self.bounds = tuple(bounds)
        self.series: Dict[str, Histogram] = {}

    def observe(self, key: str, v: float) -> None:
        h = self.series.get(key)
        if h is None:
            h = self.series[key] = Histogram(self.name, self.bounds)
        h.observe(v)

    def render(self) -> List[str]:
        out = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        for key in sorted(self.series):
            h = self.series[key]
            cum = 0
            lbl = f'{self.label}="{key}"'
            for bound, n in zip(h.bounds, h.counts):
                cum += n
                out.append(
                    f'{self.name}_bucket{{{lbl},le="{bound:g}"}} {cum}'
                )
            cum += h.counts[-1]
            out.append(f'{self.name}_bucket{{{lbl},le="+Inf"}} {cum}')
            out.append(f'{self.name}_sum{{{lbl}}} {round(h.sum, 6)}')
            out.append(f'{self.name}_count{{{lbl}}} {h.total}')
        return out

    def snapshot(self):
        return {k: h.snapshot() for k, h in sorted(self.series.items())}


class MetricsRegistry:
    """An ordered collection of instruments with one text/snapshot
    surface.  Instrument getters are get-or-create and idempotent, so
    hot paths hold direct instrument references and cold paths may
    re-resolve by name."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = Counter(name, help)
        return inst

    def gauge(self, name: str, help: str = "") -> Gauge:
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = Gauge(name, help)
        return inst

    def histogram(
        self,
        name: str,
        bounds: Sequence[float] = LATENCY_BUCKETS_MS,
        help: str = "",
    ) -> Histogram:
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = Histogram(name, bounds, help)
        return inst

    def labeled_histogram(
        self,
        name: str,
        bounds: Sequence[float] = LATENCY_BUCKETS_MS,
        help: str = "",
        label: str = "site",
    ) -> _LabeledHistogram:
        # Re-resolving by name is a plain dict hit with NO factory
        # allocation — cold misses construct inline — so per-fetch
        # callers (fetch_latency_observe) stay allocation-free without
        # holding a reference that a test's registry reset would orphan.
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = _LabeledHistogram(
                name, bounds, help, label
            )
        return inst

    def render(self) -> str:
        lines: List[str] = []
        for name in sorted(self._instruments):
            lines.extend(self._instruments[name].render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        return {
            name: inst.snapshot()
            for name, inst in sorted(self._instruments.items())
        }

    def reset(self) -> None:
        self._instruments.clear()


# -- cross-process aggregation ------------------------------------------
# A serving mesh has one registry PER HOST PROCESS; the router merges
# their snapshot() dicts into one scrapeable surface.  Snapshots are the
# merge currency (JSON-safe, so a subprocess host's registry rides a
# file): the instrument kind is recovered from the snapshot shape —
# Counter -> number, Gauge -> {value,max}, Histogram ->
# {buckets,count,sum}, labeled histogram -> {label: histogram}.


def _snap_kind(val) -> str:
    if isinstance(val, (int, float)) and not isinstance(val, bool):
        return "counter"
    if isinstance(val, dict):
        if set(val) == {"value", "max"}:
            return "gauge"
        if set(val) == {"buckets", "count", "sum"}:
            return "histogram"
        return "labeled"
    raise ValueError(f"unrecognized metrics snapshot value: {val!r}")


def _copy_val(val):
    if isinstance(val, dict):
        return {k: _copy_val(v) for k, v in val.items()}
    return val


def _merge_hist(name: str, a: dict, b: dict) -> dict:
    if set(a["buckets"]) != set(b["buckets"]):
        raise ValueError(
            f"histogram {name}: bucket bounds differ across hosts "
            f"({sorted(a['buckets'])} vs {sorted(b['buckets'])}) — "
            "mesh hosts must run the same instrument layout"
        )
    return {
        "buckets": {
            k: a["buckets"][k] + b["buckets"][k] for k in a["buckets"]
        },
        "count": a["count"] + b["count"],
        "sum": round(a["sum"] + b["sum"], 6),
    }


def _merge_val(name: str, a, b):
    ka, kb = _snap_kind(a), _snap_kind(b)
    if ka != kb:
        raise ValueError(
            f"metric {name}: instrument kind differs across hosts "
            f"({ka} vs {kb})"
        )
    if ka == "counter":
        return a + b
    if ka == "gauge":
        return {
            "value": max(a["value"], b["value"]),
            "max": max(a["max"], b["max"]),
        }
    if ka == "histogram":
        return _merge_hist(name, a, b)
    out = {k: _copy_val(v) for k, v in a.items()}
    for k, v in b.items():
        out[k] = _merge_hist(name, out[k], v) if k in out else _copy_val(v)
    return out


def merge_snapshots(snaps: Sequence[dict]) -> dict:
    """Fold per-host registry ``snapshot()`` dicts into one mesh-level
    snapshot: counters SUM, gauges MAX (current value and peak —
    per-host queue depths are not additive load), histograms add
    BUCKET-WISE (same bounds required; a mismatch raises rather than
    silently skewing percentiles), labeled histograms merge per label.
    The result is itself snapshot-shaped — :func:`render_snapshot`
    exposes it as ordinary Prometheus text."""
    out: Dict[str, object] = {}
    for snap in snaps:
        for name, val in snap.items():
            if name in out:
                out[name] = _merge_val(name, out[name], val)
            else:
                out[name] = _copy_val(val)
    return dict(sorted(out.items()))


def _hist_lines(name: str, lbl: str, hs: dict) -> List[str]:
    # Cumulative le-ordered buckets (the Prometheus contract); bucket
    # keys sort numerically with +Inf last — a JSON round-trip keeps
    # insertion order, but don't depend on it.
    finite = sorted(
        (k for k in hs["buckets"] if k != "+Inf"), key=float
    )
    out = []
    cum = 0
    for k in finite:
        cum += hs["buckets"][k]
        sel = f'{lbl},le="{k}"' if lbl else f'le="{k}"'
        out.append(f"{name}_bucket{{{sel}}} {cum}")
    cum += hs["buckets"].get("+Inf", 0)
    sel = f'{lbl},le="+Inf"' if lbl else 'le="+Inf"'
    out.append(f"{name}_bucket{{{sel}}} {cum}")
    suffix = f"{{{lbl}}}" if lbl else ""
    out.append(f"{name}_sum{suffix} {round(hs['sum'], 6)}")
    out.append(f"{name}_count{suffix} {hs['count']}")
    return out


def render_snapshot(
    snap: dict, helps: Optional[Dict[str, str]] = None,
    label: str = "site",
) -> str:
    """Prometheus text exposition of a snapshot dict (typically the
    output of :func:`merge_snapshots`) — the same format the live
    registries render, so one scraper config serves single-host and
    mesh deployments."""
    lines: List[str] = []
    for name in sorted(snap):
        val = snap[name]
        kind = _snap_kind(val)
        h = (helps or {}).get(name, "")
        if kind == "counter":
            lines += [
                f"# HELP {name} {h}", f"# TYPE {name} counter",
                f"{name} {val}",
            ]
        elif kind == "gauge":
            lines += [
                f"# HELP {name} {h}", f"# TYPE {name} gauge",
                f"{name} {val['value']}", f"{name}_max {val['max']}",
            ]
        elif kind == "histogram":
            lines += [f"# HELP {name} {h}", f"# TYPE {name} histogram"]
            lines += _hist_lines(name, "", val)
        else:
            lines += [f"# HELP {name} {h}", f"# TYPE {name} histogram"]
            for key in sorted(val):
                lines += _hist_lines(name, f'{label}="{key}"', val[key])
    return "\n".join(lines) + ("\n" if lines else "")


# Process-global registry for instruments whose sites have no server or
# config in scope (the ledger pattern): today the per-site audited-fetch
# latency histograms updated by reliability/retry.py.
GLOBAL = MetricsRegistry()


def fetch_latency_observe(site: str, ms: float) -> None:
    """Record one audited fetch's wall latency (reliability/retry.py) —
    the per-site serving-path fetch histograms the registry snapshot
    exposes."""
    GLOBAL.labeled_histogram(
        "fa_fetch_latency_ms",
        help="audited device fetch wall latency by site",
    ).observe(site, ms)


_dump_interval_memo: Optional[float] = None


def dump_interval_s() -> float:
    """``FA_METRICS_DUMP_S``: seconds between periodic metrics-snapshot
    writes under ``serve --metrics-dump`` (strictly parsed, default 5;
    must be positive).  Parsed once per process; tests use
    :func:`reload_from_env`."""
    global _dump_interval_memo
    if _dump_interval_memo is None:
        from fastapriori_tpu_torch.utils.env import env_float

        _dump_interval_memo = env_float(
            "FA_METRICS_DUMP_S", 5.0, minimum=0.05
        )
    return _dump_interval_memo


def reload_from_env() -> None:
    global _dump_interval_memo
    _dump_interval_memo = None
