"""Span tracer: nestable, thread-aware spans with deterministic ids,
exported as Chrome trace-event JSON (counterpart:
fastapriori_tpu/obs/trace.py).

The tracer threads through the CLI's run (from the tracer's enable to
the export), its ``job_setup`` (context, miner, the first rendezvous),
``read_users`` (``U.dat``) and phases, the mine, every
``MetricsLogger.timed`` section (preprocess, bitmap_build, level,
tail_fuse, fused_mine, counts_resolve, checkpoint, gen_rules,
user_dedup, first_match ...), the pair program's launch
(``pair_program``, inside ``bitmap_build``), the vertical engine's pair
phase (``vertical_pairs``, inside level 2's ``level``) and each of its
K3 launches (``vertical_count``, inside its ``level``, with ``k``,
``candidates``, ``lanes`` and ``vops``), every artifact write
(``write``, with its ``fsync`` child; io/writer.py), the device rule
join's levels, every audited fetch (reliability/retry.py) and the block
uploader's copies, and exports the Chrome trace-event JSON that Perfetto
(ui.perfetto.dev) loads (``--trace out.trace.json``).

Contracts:

- **Near-zero cost when disabled** (the default): ``span()`` is one
  attribute read and one branch returning a shared no-op context
  manager: no allocation, no clock read.
- **Deterministic ids**: a span's id is its path (parent id, name and
  per-parent occurrence index, ``main:run#0/phase#0/mine#0/level#3``),
  not a global counter that interleaves across threads, so two identical
  seeded runs produce identical span trees modulo timestamps.  Root
  spans are keyed by thread name: ``main``, ``fa-upload_0`` (the block
  uploader), ``fa-watchdog:<site>``.  A root's occurrence index counts
  per thread name, so threads that reuse a name one after another (each
  run's uploader, each watchdog worker) continue its count instead of
  repeating an id.
- **Thread-aware**: each thread nests under its own root; export maps
  threads to stable small tids with ``thread_name`` metadata events.
- **Bounded**: past ``max_events`` (``FA_TRACE_EVENTS``) new events are
  counted as dropped, never grown without bound.

Enabled by the CLI's ``--trace PATH`` or the strict ``FA_TRACE`` knob
(spans recorded process-wide; export still needs a path).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

# Every audited fetch site label of the port: reliability/retry.py opens
# a span named "fetch." + site around each audited call, so this census
# is the list of fetch spans a traced run can show.  The port has no
# lint gate over its package; tests/test_torch_obs.py holds the census
# to the sites named in the port's code and to the JAX package's census.
FETCH_SITE_SPANS = (
    "fetch.counts",
    "fetch.counts_drain",
    "fetch.counts_resolve",
    "fetch.fused",
    "fetch.level_bits",
    "fetch.level_bits_sparse",
    "fetch.level_counts",
    "fetch.pair",
    "fetch.pair_pre",
    "fetch.pair_regather",
    "fetch.pair_sparse",
    "fetch.rec_match",
    "fetch.rule_counts",
    "fetch.rule_mask",
    "fetch.serve_match",
    "fetch.serve_swap_ready",
    "fetch.tail",
    "fetch.vlevel_bits",
    "fetch.vlevel_bits_sparse",
    "fetch.vpair",
    "fetch.vpair_sparse",
)


class _NoopSpan:
    """The disabled path's context manager: one shared instance."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def update(self, **args: Any) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "sid", "parent_sid", "t0", "args", "_children")

    def __init__(self, name: str, sid: str, parent_sid: Optional[str]):
        self.name = name
        self.sid = sid
        self.parent_sid = parent_sid
        self.t0 = 0.0
        self.args: Dict[str, Any] = {}
        self._children: Dict[str, int] = {}

    def child_sid(self, name: str) -> str:
        idx = self._children.get(name, 0)
        self._children[name] = idx + 1
        return f"{self.sid}/{name}#{idx}"


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_args", "_span")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._span: Optional[_Span] = None

    def __enter__(self):
        self._span = self._tracer._push(self._name, self._args)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and self._span is not None:
            self._span.args.setdefault("error", exc_type.__name__)
        self._tracer._pop(self._span)
        return False

    def update(self, **args: Any) -> None:
        """Attach attributes to this span (the exported ``args``)."""
        if self._span is not None:
            self._span.args.update(args)


DEFAULT_MAX_EVENTS = 200_000
_max_events_memo: Optional[int] = None


def max_events_from_env() -> int:
    """``FA_TRACE_EVENTS``: the tracer's buffer capacity in events
    (strict integer >= 1; default 200,000).  Parsed once per process
    (tests use :func:`reload_from_env`): by :class:`Tracer` when built
    without a capacity and by :func:`maybe_enable`, never at import."""
    global _max_events_memo
    if _max_events_memo is None:
        from fastapriori_tpu_torch.utils.env import env_int

        _max_events_memo = env_int("FA_TRACE_EVENTS", DEFAULT_MAX_EVENTS,
                                   minimum=1)
    return _max_events_memo


class Tracer:
    """Span collector (module docstring).  :data:`TRACER` is the
    process-wide one, a singleton like the degradation ledger: the sites
    that trace (retry wrappers, the uploader thread) have no config in
    scope.  ``max_events`` None reads ``FA_TRACE_EVENTS``."""

    def __init__(self, max_events: Optional[int] = None):
        self.enabled = False
        self.max_events = (
            max_events_from_env() if max_events is None else max_events
        )
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self.dropped = 0
        self._tls = threading.local()
        self._root_counts: Dict[tuple, int] = {}
        self._epoch = time.perf_counter()

    # -- lifecycle ------------------------------------------------------
    def _clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._root_counts.clear()
        # Fresh thread-local stacks, so two enable()+identical-run cycles
        # produce identical span ids.
        self._tls = threading.local()
        self._epoch = time.perf_counter()

    def enable(self) -> "Tracer":
        self._clear()
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self._clear()

    # -- thread-local span stack ---------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    @staticmethod
    def _thread_key() -> str:
        name = threading.current_thread().name
        return "main" if name == "MainThread" else name

    def _push(self, name: str, args: Dict[str, Any]) -> _Span:
        stack = self._stack()
        if stack:
            sid = stack[-1].child_sid(name)
            parent = stack[-1].sid
        else:
            key = self._thread_key()
            with self._lock:
                idx = self._root_counts.get((key, name), 0)
                self._root_counts[(key, name)] = idx + 1
            sid = f"{key}:{name}#{idx}"
            parent = None
        span = _Span(name, sid, parent)
        span.args.update(args)
        span.t0 = time.perf_counter()
        stack.append(span)
        return span

    def _pop(self, span: Optional[_Span]) -> None:
        t1 = time.perf_counter()
        stack = self._stack()
        # Pop down TO the span: an unbalanced inner exit never corrupts
        # the outer spans; stranded frames close with their parent.
        while stack:
            if stack.pop() is span:
                break
        if span is None:
            return
        self._record({
            "ph": "X",
            "name": span.name,
            "sid": span.sid,
            "parent": span.parent_sid,
            "ts_us": (span.t0 - self._epoch) * 1e6,
            "dur_us": (t1 - span.t0) * 1e6,
            "thread": self._thread_key(),
            "args": span.args,
        })
        from fastapriori_tpu_torch.obs import flight

        flight.note("span", name=span.name, sid=span.sid,
                    dur_ms=round((t1 - span.t0) * 1e3, 3), **span.args)

    def _record(self, event: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)

    # -- public emit API ------------------------------------------------
    def span(self, name: str, **args: Any):
        """Open a nested span (context manager).  Disabled: one branch
        and the shared no-op instance."""
        if not self.enabled:
            return _NOOP
        return _SpanCtx(self, name, args)

    def instant(self, name: str, **args: Any) -> None:
        """A point-in-time event under the current span."""
        if not self.enabled:
            return
        stack = self._stack()
        self._record({
            "ph": "i",
            "name": name,
            "sid": None,
            "parent": stack[-1].sid if stack else None,
            "ts_us": (time.perf_counter() - self._epoch) * 1e6,
            "thread": self._thread_key(),
            "args": args,
        })

    def counter(self, name: str, **values: Any) -> None:
        """A Chrome counter event (a track in Perfetto)."""
        if not self.enabled:
            return
        self._record({
            "ph": "C",
            "name": name,
            "sid": None,
            "parent": None,
            "ts_us": (time.perf_counter() - self._epoch) * 1e6,
            "thread": self._thread_key(),
            "args": values,
        })

    def annotate(self, **args: Any) -> None:
        """Attach attributes to the current innermost span (for sites
        that hold no span handle)."""
        if not self.enabled:
            return
        stack = self._stack()
        if stack:
            stack[-1].args.update(args)

    # -- inspection / export -------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def span_tree(self) -> List[tuple]:
        """The deterministic structure: sorted ``(sid, name, parent)`` of
        every completed span (timestamps left out)."""
        with self._lock:
            return sorted((e["sid"], e["name"], e["parent"])
                          for e in self._events if e["ph"] == "X")

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto loads it).  Threads map to
        small tids in first-event order, named by ``thread_name``
        metadata events."""
        events = self.events()
        out: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": 1, "tid": 0,
            "args": {"name": "fastapriori_tpu_torch"},
        }]
        threads: Dict[str, int] = {}
        for e in events:
            key = e["thread"]
            if key not in threads:
                threads[key] = len(threads) + 1
                out.append({"ph": "M", "name": "thread_name", "pid": 1,
                            "tid": threads[key], "args": {"name": key}})
        for e in events:
            ev: Dict[str, Any] = {
                "ph": e["ph"],
                "name": e["name"],
                "cat": e["name"].split(".")[0].split(":")[0],
                "pid": 1,
                "tid": threads[e["thread"]],
                "ts": round(e["ts_us"], 3),
                "args": dict(e["args"]),
            }
            if e["ph"] == "X":
                ev["dur"] = round(e["dur_us"], 3)
                ev["args"]["sid"] = e["sid"]
            if e["ph"] == "i":
                ev["s"] = "t"
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str, manifest: Optional[dict] = None) -> str:
        """Write the Chrome trace JSON through the crash-safe writer (tmp,
        fsync, rename; failpoint site ``write.trace``)."""
        from fastapriori_tpu_torch.io.writer import write_artifact_bytes

        body = json.dumps(self.chrome_trace()) + "\n"
        return write_artifact_bytes(path, [body.encode("utf-8")], "trace",
                                    manifest)


def validate_chrome_trace(obj) -> List[str]:
    """Schema problems of a Chrome trace-event JSON object (an empty list
    means the shape Perfetto loads)."""
    problems: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a traceEvents array"]
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["traceEvents must be a non-empty array"]
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "C", "M"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            problems.append(f"event {i}: missing name")
        if not isinstance(e.get("pid"), int) or not isinstance(
                e.get("tid"), int):
            problems.append(f"event {i}: pid/tid must be ints")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
            if not isinstance(e.get("args", {}).get("sid"), str):
                problems.append(f"event {i}: span missing sid")
        if "args" in e and not isinstance(e["args"], dict):
            problems.append(f"event {i}: args must be an object")
    return problems


# Built at the default capacity, so that importing the port parses no
# knob; maybe_enable (the CLI, every run) applies FA_TRACE_EVENTS.
TRACER = Tracer(DEFAULT_MAX_EVENTS)


def span(name: str, **args: Any):
    return TRACER.span(name, **args)


def instant(name: str, **args: Any) -> None:
    TRACER.instant(name, **args)


def counter(name: str, **values: Any) -> None:
    TRACER.counter(name, **values)


def annotate(**args: Any) -> None:
    TRACER.annotate(**args)


_env_memo: Optional[bool] = None


def enabled_by_env() -> bool:
    """The strict ``FA_TRACE`` knob: true records spans process-wide
    (``--trace PATH`` also exports); a value it does not know raises
    InputError.  Parsed once per process; tests use
    :func:`reload_from_env`."""
    global _env_memo
    if _env_memo is None:
        from fastapriori_tpu_torch.utils.env import env_flag

        _env_memo = env_flag("FA_TRACE", False)
    return _env_memo


def reload_from_env() -> None:
    global _env_memo, _max_events_memo
    _env_memo = None
    _max_events_memo = None
    TRACER.max_events = max_events_from_env()


def maybe_enable(explicit: bool = False) -> bool:
    """Apply ``FA_TRACE_EVENTS`` to the global tracer (strictly parsed
    whether or not it records), then enable it when ``explicit``
    (``--trace``) or ``FA_TRACE`` asks for it; returns the resulting
    state."""
    TRACER.max_events = max_events_from_env()
    if explicit or enabled_by_env():
        TRACER.enable()
    return TRACER.enabled
