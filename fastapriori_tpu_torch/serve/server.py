"""RecommendServer: the resident, admission-controlled request loop
(counterpart: fastapriori_tpu/serve/server.py ``RecommendServer``,
``ServeRequest`` and ``pipeline_depth_from_env``).

The dispatcher turns a request stream into the micro-batches K2 serves
best, with two knobs:

- **batch_rows** (``config.rec_batch_rows`` / ``FA_REC_BATCH``,
  pow2-bucketed by ``bucket_batch_rows``): the most requests one
  micro-batch collects, and the largest block the scan launches K2 on;
- **linger** (``config.serve_linger_ms``): the longest a partial batch
  waits to fill; 0 dispatches at once.

**Admission.**  The queue is bounded (``serve_queue_depth``; 0 = 4x
batch_rows).  :meth:`RecommendServer.submit` on a full queue (or a
stopped server) sheds: the request is answered "0" at once, counted, and
the accept -> shed transition of each overload episode is one
``serving`` cascade event.  :meth:`RecommendServer.submit_wait` waits,
bounded, for room instead (file and stdin sources).

**Two stages** (``FA_SERVE_PIPELINE_DEPTH``, default 2, strictly
parsed).  At depth >= 1 the pack thread (``fa-serve-pack``) collects,
deduplicates and packs batch k+1 into numpy bitmap blocks while the scan
thread (``fa-serve-dispatch``) uploads, launches K2 and fetches batch k;
a ring of at most ``pipeline_depth`` packed batches joins them and a full
ring holds the pack stage back.  Depth 0 is the serial one-thread loop.
Only the scan thread touches CUDA, after setting its device.

**Hot swap.**  :meth:`RecommendServer.swap` enqueues a barrier marker:
requests enqueued before it are served by the old state, after it by the
new one; every response carries the signature of the state that served
it, and the old state's table is freed at the barrier.

**Failures.**  A batch whose scan raises is answered "0" with a
``serve_error`` ledger event, and the next batch gets a fresh attempt,
as in the JAX package.  One difference: an error after which the
process's CUDA context cannot serve again (reliability/retry.py
``context_lost``: a sticky CUDA error, an injected abort, the watchdog's
abandoned-thread cap) stops the dispatcher instead: that batch, the
queue and the ring complete as failed (``error`` set, no answer), later
submits are shed, and :meth:`RecommendServer.alive` turns False.  A swap
barrier still in the queue or the ring fails too: its incoming state is
released, its :class:`SwapEvent` is set with ``error``, and ``wait``
returns False at once.

Every wait in this module is bounded by a timeout.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Sequence

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.obs import metrics as obs_metrics
from fastapriori_tpu_torch.obs import trace
from fastapriori_tpu_torch.obs.metrics import MetricsRegistry
from fastapriori_tpu_torch.reliability import (
    failpoints,
    ledger,
    retry,
    watchdog,
)
from fastapriori_tpu_torch.serve.state import PackedBatch, ServingState
from fastapriori_tpu_torch.utils.env import env_int

# Batch-fill histogram bounds: pow2 rows up to the largest bucketed
# micro-batch.
_FILL_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# The pack stage's shutdown sentinel, pushed to the ring after its last
# batch so that the scan stage ends in order.
_STOP = object()

_PIPELINE_DEPTH: Optional[int] = None


def pipeline_depth_from_env() -> int:
    """``FA_SERVE_PIPELINE_DEPTH``: the ring's capacity between the pack
    and scan stages; 0 = the serial dispatcher; default 2.  Strict
    integer >= 0 (a typo is an InputError)."""
    global _PIPELINE_DEPTH
    if _PIPELINE_DEPTH is None:
        _PIPELINE_DEPTH = env_int("FA_SERVE_PIPELINE_DEPTH", 2, minimum=0)
    return _PIPELINE_DEPTH


def reload_from_env() -> None:
    """Forget the parsed knob (tests change the environment)."""
    global _PIPELINE_DEPTH
    _PIPELINE_DEPTH = None


class ServeRequest:
    """One request.  ``t_sched`` is the open-loop arrival time (submit
    time by default): latency counts from it, so a lagging generator
    cannot hide queueing.  ``error`` is set on a request that failed
    when its dispatcher stopped (``item`` stays None)."""

    __slots__ = (
        "tokens", "t_sched", "t_enq", "t_done", "item", "shed", "model",
        "error",
    )

    def __init__(self, tokens, t_sched: Optional[float], t_enq: float):
        self.tokens = tokens
        self.t_sched = t_enq if t_sched is None else t_sched
        self.t_enq = t_enq
        self.t_done: Optional[float] = None
        self.item: Optional[str] = None
        self.shed = False
        self.model: Optional[str] = None
        self.error: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.t_done is not None

    def latency_ms(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return max(self.t_done - self.t_sched, 0.0) * 1e3


class SwapEvent(threading.Event):
    """What :meth:`RecommendServer.swap` returns: set when the barrier
    committed, or when it failed because the dispatcher stopped first;
    ``error`` says why it failed (None: committed), and :meth:`wait` is
    True only for a committed swap."""

    def __init__(self):
        super().__init__()
        self.error: Optional[str] = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return super().wait(timeout) and self.error is None


class _SwapMarker:
    __slots__ = ("state", "release_old", "event", "t_enq")

    def __init__(self, state: ServingState, release_old: bool):
        self.state = state
        self.release_old = release_old
        self.event = SwapEvent()
        self.t_enq = time.monotonic()


class RecommendServer:
    def __init__(
        self,
        state: ServingState,
        batch_rows: Optional[int] = None,
        linger_ms: Optional[float] = None,
        queue_depth: Optional[int] = None,
        metrics: bool = True,
        pipeline_depth: Optional[int] = None,
    ):
        from fastapriori_tpu_torch.models.recommender import (
            bucket_batch_rows,
        )

        self._state = state
        cfg = state.config
        rows = batch_rows if batch_rows else state.batch_rows()
        self._batch_rows = bucket_batch_rows(rows)
        self._linger_s = (
            cfg.serve_linger_ms if linger_ms is None else linger_ms) / 1e3
        depth = queue_depth if queue_depth else cfg.serve_queue_depth
        self._depth = int(depth) if depth else 4 * self._batch_rows
        if pipeline_depth is None:
            pipeline_depth = pipeline_depth_from_env()
        if pipeline_depth < 0:
            raise InputError(
                f"pipeline_depth must be >= 0, got {pipeline_depth}")
        self._pipeline_depth = int(pipeline_depth)
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._running = False
        self._in_flight = 0  # requests popped and not yet completed
        self._thread: Optional[threading.Thread] = None
        self._shedding = False
        self._pending_swaps = 0  # markers in the queue
        # The hand-off ring (pipeline_depth >= 1): bounded, so a slow
        # scan holds the pack stage back.
        self._ring: deque = deque()
        self._ring_cond = threading.Condition()
        self._ring_cap = max(self._pipeline_depth, 1)
        self._ring_peak = 0
        self._pack_state = state  # the pack stage's model pointer
        self._pack_thread: Optional[threading.Thread] = None
        # The error that stopped the dispatcher (module docstring).
        self._fatal: Optional[str] = None
        # Counters (under _cond).
        self._submitted = 0
        self._served = 0
        self._shed = 0
        self._failed = 0
        self._errors = 0
        self._batches = 0
        self._batch_rows_served = 0
        self._swaps = 0
        self._swaps_failed = 0
        self._max_depth = 0
        self._scan_wall_s = 0.0
        # The live metrics registry, readable mid-run (metrics_text, the
        # CLI's --metrics-dump); metrics=False turns the updates off.
        self._obs = metrics
        self.registry = MetricsRegistry()
        reg = self.registry
        self._m_submitted = reg.counter(
            "fa_serve_submitted_total", "requests submitted")
        self._m_served = reg.counter(
            "fa_serve_served_total", "requests answered by a scan batch")
        self._m_shed = reg.counter(
            "fa_serve_shed_total", "requests shed by admission control")
        self._m_errors = reg.counter(
            "fa_serve_errors_total", "batches answered '0' on a fatal error")
        self._m_swaps = reg.counter(
            "fa_serve_swaps_total", "hot-swap barriers committed")
        self._m_queue = reg.gauge(
            "fa_serve_queue_depth", "admission queue depth (and peak)")
        self._m_ring = reg.gauge(
            "fa_serve_ring_depth",
            "pack-to-scan hand-off ring depth (and peak)")
        self._m_fill = reg.histogram(
            "fa_serve_batch_fill", _FILL_BUCKETS,
            "rows per dispatched micro-batch")
        self._m_linger = reg.histogram(
            "fa_serve_linger_ms",
            help="first-request wait from enqueue to batch dispatch")
        self._m_batch_ms = reg.histogram(
            "fa_serve_batch_ms", help="per-batch serve wall (scan incl.)")
        self._m_swap_ms = reg.histogram(
            "fa_serve_swap_barrier_ms",
            help="swap-marker wait from enqueue to barrier commit")

    # -- lifecycle ------------------------------------------------------
    def start(self, warm: bool = True) -> "RecommendServer":
        if self._thread is not None:
            raise InputError("RecommendServer.start called twice")
        # The scan's largest block equals the collection bound.
        self._state.set_batch_rows(self._batch_rows)
        if warm:
            self._state.warm()
        self._running = True
        self._pack_state = self._state
        if self._pipeline_depth > 0:
            self._pack_thread = threading.Thread(
                target=self._pack_loop, name="fa-serve-pack", daemon=True)
            self._pack_thread.start()
            self._thread = threading.Thread(
                target=self._scan_loop, name="fa-serve-dispatch",
                daemon=True)
        else:
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="fa-serve-dispatch",
                daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> bool:
        """Stop the dispatcher, after draining (bounded) when ``drain``.
        True when every stage thread ended inside the bound."""
        if drain:
            self.drain(timeout_s=timeout_s)
        with self._cond:
            self._running = False
            self._cond.notify_all()
        with self._ring_cond:
            self._ring_cond.notify_all()
        deadline = time.monotonic() + timeout_s
        ok = True
        for t in (self._pack_thread, self._thread):
            if t is not None:
                t.join(max(deadline - time.monotonic(), 0.001))
                ok = ok and not t.is_alive()
        return ok

    def alive(self) -> bool:
        """The router's liveness probe: the scan-stage thread serves."""
        t = self._thread
        return bool(self._running and t is not None and t.is_alive())

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait (bounded) until the queue is empty and nothing is in
        flight; False on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._q or self._in_flight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.1))
        return True

    # -- admission ------------------------------------------------------
    def _enqueue_locked(self, req: ServeRequest) -> None:
        if self._shedding:
            self._shedding = False  # the overload episode is over
        self._q.append(req)
        depth = len(self._q)
        if self._obs:
            self._m_queue.set(depth)
        if depth > self._max_depth:
            self._max_depth = depth
        self._cond.notify_all()

    def submit(
        self,
        tokens: Sequence[str],
        t_sched: Optional[float] = None,
    ) -> ServeRequest:
        """Open-loop admission: enqueue, or shed at once ("0", counted,
        the episode recorded) when the queue is full or the server is
        not running."""
        now = time.monotonic()
        req = ServeRequest(tokens, t_sched, now)
        with self._cond:
            self._submitted += 1
            if self._obs:
                self._m_submitted.inc()
            if not self._running or len(self._q) >= self._depth:
                return self._shed_locked(req, now)
            self._enqueue_locked(req)
        return req

    def try_submit(
        self,
        tokens: Sequence[str],
        t_sched: Optional[float] = None,
    ) -> Optional[ServeRequest]:
        """The router's admission probe: enqueue like :meth:`submit`, or
        return None and count nothing when the queue is full or the
        server stopped (the router spills first, sheds last)."""
        now = time.monotonic()
        with self._cond:
            if not self._running or len(self._q) >= self._depth:
                return None
            req = ServeRequest(tokens, t_sched, now)
            self._submitted += 1
            if self._obs:
                self._m_submitted.inc()
            self._enqueue_locked(req)
        return req

    def submit_wait(
        self,
        tokens: Sequence[str],
        t_sched: Optional[float] = None,
        timeout_s: float = 30.0,
    ) -> ServeRequest:
        """Closed-loop admission: wait (bounded) for room; shed only on
        timeout or a stopped server."""
        deadline = time.monotonic() + timeout_s
        req = ServeRequest(tokens, t_sched, time.monotonic())
        with self._cond:
            self._submitted += 1
            if self._obs:
                self._m_submitted.inc()
            while self._running and len(self._q) >= self._depth:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, 0.1))
            if not self._running or len(self._q) >= self._depth:
                return self._shed_locked(req, time.monotonic())
            req.t_enq = time.monotonic()
            self._enqueue_locked(req)
        return req

    def _shed_locked(self, req: ServeRequest, now: float) -> ServeRequest:
        """Complete ``req`` as shed (the caller holds the lock); one
        cascade event per overload episode."""
        req.item = "0"
        req.shed = True
        req.t_done = now
        self._shed += 1
        if self._obs:
            self._m_shed.inc()
        if not self._shedding:
            self._shedding = True
            watchdog.downgrade(
                "serving", "accept", "shed",
                reason="queue_full" if self._running else "not_running",
                once_key="serving:accept>shed",
                depth=self._depth,
                shed_so_far=self._shed,
            )
        return req

    def wait_for(
        self, reqs: Sequence[ServeRequest], timeout_s: float = 30.0
    ) -> bool:
        """Wait (bounded) until every request in ``reqs`` completed."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while not all(r.done for r in reqs):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.1))
        return True

    # -- hot swap -------------------------------------------------------
    def swap(
        self, new_state: ServingState, release_old: bool = True
    ) -> SwapEvent:
        """Hot-swap the model at a barrier in the queue (module
        docstring).  Returns the event set when the swap committed (the
        outgoing state is released there unless ``release_old`` is
        False) or failed (``error`` set)."""
        marker = _SwapMarker(new_state, release_old)
        with self._cond:
            if not self._running:
                raise InputError("cannot swap a stopped server")
            self._q.append(marker)
            self._pending_swaps += 1
            self._cond.notify_all()
        return marker.event

    @property
    def state(self) -> ServingState:
        return self._state

    # -- dispatcher -----------------------------------------------------
    def _collect_batch(self) -> Optional[list]:
        """One micro-batch under the lock: up to batch_rows requests,
        ended early by a swap marker or the first request's linger
        deadline; a marker alone is returned as its own batch.  None
        when stopped and empty."""
        with self._cond:
            while self._running and not self._q:
                self._cond.wait(0.05)
            if not self._q:
                return None
            if isinstance(self._q[0], _SwapMarker):
                self._in_flight += 1
                self._pending_swaps -= 1
                return [self._q.popleft()]
            deadline = self._q[0].t_enq + self._linger_s
            while (self._running and len(self._q) < self._batch_rows
                   and not self._pending_swaps):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, 0.05))
            batch = []
            while self._q and len(batch) < self._batch_rows:
                if isinstance(self._q[0], _SwapMarker):
                    break  # the barrier: the next batch takes it
                batch.append(self._q.popleft())
            self._in_flight += len(batch)
            return batch

    def _commit_swap(self, marker: _SwapMarker) -> None:
        """Commit a barrier on the scan stage: install the new state,
        record the swap, release the old state, wake the waiters."""
        old = self._state
        marker.state.set_batch_rows(self._batch_rows)
        with self._cond:
            self._state = marker.state
            self._swaps += 1
        if self._obs:
            self._m_swaps.inc()
            self._m_swap_ms.observe((time.monotonic() - marker.t_enq) * 1e3)
        ledger.record("serve_swap", once_key=marker.state.signature,
                      frm=old.signature, to=marker.state.signature)
        if marker.release_old:
            old.release()
        marker.event.set()
        with self._cond:
            self._in_flight -= 1
            self._cond.notify_all()

    def _fail_swaps(self, markers: list) -> None:
        """Barriers the stopped dispatcher will never reach: release each
        incoming state (it must not pin its table), record the loss, set
        each event with the error (outside the lock)."""
        for marker in markers:
            marker.state.release()
            ledger.record("serve_swap_failed", once_key=marker.state.signature,
                          to=marker.state.signature, error=self._fatal)
            with self._cond:
                self._swaps_failed += 1
            marker.event.error = self._fatal
            marker.event.set()

    def _fail_locked(self, reqs, now: float) -> None:
        """Complete ``reqs`` as failed (the caller holds the lock)."""
        for r in reqs:
            r.error = self._fatal
            r.t_done = now
        self._failed += len(reqs)

    def _stop_on_fatal(self, batch: list, error: str) -> None:
        """The dispatcher's context is lost: ``batch`` and every queued
        request complete as failed, the server stops admitting, and the
        scan stage fails whatever the ring still brings."""
        with self._cond:
            self._fatal = error
            self._running = False
            now = time.monotonic()
            self._fail_locked(batch, now)
            self._in_flight -= len(batch)
            queued = [r for r in self._q if isinstance(r, ServeRequest)]
            markers = [m for m in self._q if isinstance(m, _SwapMarker)]
            self._pending_swaps = 0
            self._q.clear()
            self._fail_locked(queued, now)
            self._cond.notify_all()
        with self._ring_cond:
            self._ring_cond.notify_all()
        self._fail_swaps(markers)

    def _serve_batch(
        self,
        batch: list,
        packed: Optional[PackedBatch],
        state: ServingState,
    ) -> None:
        """Serve one micro-batch on ``state`` (the pack-time state under
        the pipeline) and complete its requests; ``packed`` is its pack
        stage's output, or None to run the whole path here."""
        if self._fatal is not None:
            with self._cond:
                self._fail_locked(batch, time.monotonic())
                self._in_flight -= len(batch)
                self._cond.notify_all()
            return
        t0 = time.monotonic()
        with trace.span("serve.batch", rows=len(batch)) as sp:
            sp.update(admission_wait_ms=round(
                (t0 - batch[0].t_enq) * 1e3, 3))
            try:
                if packed is not None:
                    items = state.scan_packed(packed)
                else:
                    items = state.recommend_batch([r.tokens for r in batch])
            # The dispatcher outlives what a batch raises: "0" for this
            # batch and a serve_error, unless the CUDA context is lost
            # (an injected abort, a BaseException, stands for a crash:
            # it stops the dispatcher and fails the outstanding work).
            # lint: waive G006 -- answered "0" + ledger serve_error; a lost context stops the dispatcher
            except (Exception, failpoints.InjectedAbort) as exc:
                error = f"{type(exc).__name__}: {exc}"[:200]
                lost = retry.context_lost(exc)
                ledger.record("serve_error", once_key=type(exc).__name__,
                              error=error, rows=len(batch), fatal=lost)
                with self._cond:
                    self._errors += 1
                if self._obs:
                    self._m_errors.inc()
                if lost:
                    sp.update(fatal=True)
                    self._stop_on_fatal(batch, error)
                    return
                items = ["0"] * len(batch)
            now = time.monotonic()
            sig = state.signature
            with trace.span("serve.respond", rows=len(batch)):
                with self._cond:
                    for r, item in zip(batch, items):
                        r.item = item
                        r.model = sig
                        r.t_done = now
                    self._served += len(batch)
                    self._batches += 1
                    self._batch_rows_served += len(batch)
                    self._scan_wall_s += now - t0
                    self._in_flight -= len(batch)
                    depth = len(self._q)
                    shed = self._shed
                    # The instruments before the waiters wake: a scrape
                    # racing wait_for() sees the last batch.
                    if self._obs:
                        self._m_served.inc(len(batch))
                        self._m_fill.observe(len(batch))
                        self._m_linger.observe((t0 - batch[0].t_enq) * 1e3)
                        self._m_batch_ms.observe((now - t0) * 1e3)
                        self._m_queue.set(depth)
                    self._cond.notify_all()
            trace.counter("serve_queue", depth=depth, shed=shed)

    def _dispatch_loop(self) -> None:
        """The serial dispatcher (pipeline_depth 0): collect, scan and
        respond on one thread."""
        self._state.bind_thread()
        while True:
            batch = self._collect_batch()
            if batch is None:
                return
            if len(batch) == 1 and isinstance(batch[0], _SwapMarker):
                self._commit_swap(batch[0])
                continue
            self._serve_batch(batch, None, self._state)

    # -- two stages (pipeline_depth >= 1) -------------------------------
    def _ring_push(self, item) -> None:
        """Bounded hand-off: wait while the ring is full; the sentinel
        and pushes after a stop always land, so the scan stage drains in
        order."""
        with self._ring_cond:
            while (self._running and item is not _STOP
                   and len(self._ring) >= self._ring_cap):
                self._ring_cond.wait(0.05)
            self._ring.append(item)
            depth = len(self._ring)
            if depth > self._ring_peak:
                self._ring_peak = depth
            if self._obs:
                self._m_ring.set(depth)
            self._ring_cond.notify_all()

    def _pack_loop(self) -> None:
        """Stage 1: collect, dedup and pack on the host (no CUDA).  A swap
        marker moves the pack-side model pointer at once; the marker
        commits downstream, in ring order, behind the batches packed
        against the old state."""
        try:
            while True:
                batch = self._collect_batch()
                if batch is None:
                    return
                if len(batch) == 1 and isinstance(batch[0], _SwapMarker):
                    marker = batch[0]
                    marker.state.set_batch_rows(self._batch_rows)
                    self._pack_state = marker.state
                    self._ring_push(marker)
                    continue
                state = self._pack_state
                try:
                    packed = state.pack_batch([r.tokens for r in batch])
                # A failed pack runs again whole on stage 2, where the
                # serve_error rule answers it.
                except Exception:  # lint: waive G006 -- pack failure replays on stage 2's unsplit path
                    packed = None
                self._ring_push((batch, packed, state))
        finally:
            # The sentinel lands even after a crash of this thread, so
            # stage 2 never waits on a dead feeder.
            self._ring_push(_STOP)

    def _scan_loop(self) -> None:
        """Stage 2: drain the ring in order; swap barriers commit between
        batches as on the serial path."""
        self._state.bind_thread()
        while True:
            with self._ring_cond:
                while not self._ring:
                    self._ring_cond.wait(0.05)
                item = self._ring.popleft()
                if self._obs:
                    self._m_ring.set(len(self._ring))
                self._ring_cond.notify_all()
            if item is _STOP:
                return
            if isinstance(item, _SwapMarker):
                if self._fatal is not None:
                    self._fail_swaps([item])
                    with self._cond:
                        self._in_flight -= 1
                        self._cond.notify_all()
                    continue
                self._commit_swap(item)
                continue
            batch, packed, state = item
            self._serve_batch(batch, packed, state)

    # -- observability --------------------------------------------------
    def metrics_text(self) -> str:
        """The Prometheus-text snapshot: this server's registry and the
        process-wide instruments (per-site fetch latency)."""
        return self.registry.render() + obs_metrics.GLOBAL.render()

    def metrics_snapshot(self) -> dict:
        return {
            "server": self.registry.snapshot(),
            "global": obs_metrics.GLOBAL.snapshot(),
        }

    def reset_max_queue(self) -> int:
        """Reset the queue-depth peak to the current depth; returns the
        old peak (each open-loop scenario reports its own)."""
        with self._cond:
            old = self._max_depth
            self._max_depth = len(self._q)
            return old

    def stats(self) -> dict:
        with self._cond:
            out = {
                "batch_rows": self._batch_rows,
                "linger_ms": round(self._linger_s * 1e3, 3),
                "queue_depth": self._depth,
                "submitted": self._submitted,
                "served": self._served,
                "shed": self._shed,
                "failed": self._failed,
                "errors": self._errors,
                "batches": self._batches,
                "avg_batch": round(
                    self._batch_rows_served / max(self._batches, 1), 1),
                "max_queue": self._max_depth,
                "swaps": self._swaps,
                "swaps_failed": self._swaps_failed,
                "scan_wall_s": round(self._scan_wall_s, 3),
                "pipeline_depth": self._pipeline_depth,
                "ring_peak": self._ring_peak,
                "fatal": self._fatal,
            }
        out["model"] = self._state.describe()
        return out
