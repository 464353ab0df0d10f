"""MeshRouter: one request stream across several serving hosts
(counterpart: fastapriori_tpu/serve/router.py ``MeshRouter``,
``LocalHost``, ``ProcHost``, ``_worker_serve``, ``main`` and
``hosts_from_env``; ``spill_order`` and ``resolve_spec`` come from
parallel/hier.py, the port's copy of the JAX package's).

The router presents the single server's surface (submit, wait_for,
stats, metrics, swap) over a list of hosts, each a whole admission queue
+ dispatcher + scan stack, so the load generator and the CLI drive a
mesh like one server.  Two host forms share one face:

- :class:`LocalHost`: one started ``RecommendServer`` in this process.
- :class:`ProcHost`: a worker process (``python -m
  fastapriori_tpu_torch.serve.router --worker``) serving a
  ``serving.npz`` prefix on its own card (``env={"CUDA_VISIBLE_DEVICES":
  ...}`` pins it) or, with ``platform="cpu"``, on the CPU; without a
  card and without that flag the worker exits 2 and ``ProcHost`` raises
  InputError naming the exit code.  The router talks to it through the
  JAX package's file protocol: ``req-<seq>.json`` batches and
  ``swap-<seq>.json`` barriers on one sequence stream, answered by
  ``rsp-<seq>.json`` and ``swapped-<seq>.json``; ``reset-<seq>.json``,
  ``stop``; the worker's ``ready.json`` (model signature, pid),
  ``hb``, ``metrics.json`` and ``stats.json`` (with the worker's kernel
  launch counts and the scan dispatches of every model it mounted).  Every file is committed whole (``tmp`` +
  ``os.replace``); the heartbeat is published every ``FA_HEARTBEAT_MS``
  and judged against ``FA_QUORUM_TIMEOUT_S``.  The worker mounts the
  table on its device (and launches K2 once) before it writes
  ``ready.json``, and readies a swap's table before the barrier.

- **Routing and global shed.**  Requests go round-robin over the live
  hosts; a host that refuses (``try_submit``: full queue, nothing
  counted) spills the request along :func:`spill_order`.  Only when
  every live host refused does the router shed it ("0", counted once
  here, one ``serving`` accept -> shed event per overload episode), so
  a request is counted by exactly one host or by the router.
- **Mesh swap.**  :meth:`MeshRouter.swap` holds admission while each live
  host enqueues its barrier, in host order, then waits for all of them
  (bounded); the payload count must equal the host count.
- **Host loss.**  A monitor thread polls each host's liveness; a dead
  host walks the ``serve_mesh`` full -> degraded chain once, its
  outstanding requests are answered "0" as recorded sheds, and its
  share goes to the survivors through ordinary routing.
- **Metrics.**  One merged snapshot (obs/metrics.py
  ``merge_snapshots`` / ``render_snapshot``): counters sum, gauges take
  the max, histograms add bucket by bucket.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.obs import metrics as obs_metrics
from fastapriori_tpu_torch.obs.metrics import MetricsRegistry
from fastapriori_tpu_torch.parallel.hier import (  # noqa: F401
    resolve_spec,
    spill_order,
)
from fastapriori_tpu_torch.reliability import failpoints, ledger, watchdog
from fastapriori_tpu_torch.reliability.quorum import (
    heartbeat_ms,
    quorum_timeout_s,
)
from fastapriori_tpu_torch.serve.server import RecommendServer, ServeRequest
from fastapriori_tpu_torch.serve.state import ServingState
from fastapriori_tpu_torch.utils.env import env_int

_HOSTS: Optional[int] = None


def hosts_from_env() -> int:
    """``FA_SERVE_HOSTS``: the host count the CLI's default mesh has
    (strict integer >= 1; default 1, the plain single server)."""
    global _HOSTS
    if _HOSTS is None:
        _HOSTS = env_int("FA_SERVE_HOSTS", 1, minimum=1)
    return _HOSTS


def reload_from_env() -> None:
    """Forget the parsed knob (tests change the environment)."""
    global _HOSTS
    _HOSTS = None


def _write_json_atomic(path: str, obj) -> None:
    """Commit ``obj`` whole: a tmp name, then one ``os.replace``, so a
    reader sees the old file or the new one, never a torn prefix."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(json.dumps(obj))
    os.replace(tmp, path)


def _read_json(path: str):
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.loads(f.read())
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return None


_PROTOCOL_PREFIXES = ("req-", "rsp-", "swap-", "swapped-", "reset-")
_PROTOCOL_FILES = ("stop", "hb", "ready.json", "metrics.json", "stats.json")


def _remove(path: str) -> None:
    """Drop a protocol file its reader has consumed (a request or swap
    read by the worker, a response or swap ack read by the router), so
    each side's directory scan stays short; nothing reads one twice."""
    try:
        os.remove(path)
    except OSError:
        pass


class LocalHost:
    """An in-process mesh host: one started :class:`RecommendServer`."""

    def __init__(self, name: str, server: RecommendServer):
        self.name = name
        self.server = server
        self._failed = False
        # Requests this host accepted, perhaps still in flight: the
        # router answers them as sheds if the host dies (pruned lazily).
        self._outstanding: deque = deque()

    def try_submit(
        self, tokens: Sequence[str], t_sched: Optional[float] = None
    ) -> Optional[ServeRequest]:
        if self._failed:
            return None
        req = self.server.try_submit(tokens, t_sched)
        if req is not None:
            out = self._outstanding
            while out and out[0].done:
                out.popleft()
            out.append(req)
        return req

    def alive(self) -> bool:
        return not self._failed and self.server.alive()

    def swap(self, payload: ServingState) -> threading.Event:
        return self.server.swap(payload)

    def fail_outstanding(self) -> int:
        """Answer every unfinished request of this host as a recorded
        shed; returns how many."""
        now = time.monotonic()
        n = 0
        while self._outstanding:
            r = self._outstanding.popleft()
            if not r.done:
                r.item = "0"
                r.shed = True
                r.t_done = now
                n += 1
        return n

    def kill(self) -> None:
        """Abrupt host death (tests, chaos): the queue and the ring are
        dropped (their requests are the router's to answer) and the
        stage threads end without draining."""
        self._failed = True
        srv = self.server
        with srv._cond:
            srv._q.clear()
            srv._running = False
            srv._cond.notify_all()
        with srv._ring_cond:
            srv._ring.clear()
            srv._ring_cond.notify_all()

    def stats(self) -> dict:
        return self.server.stats()

    def metrics_snapshot(self) -> dict:
        snap = self.server.metrics_snapshot()
        return {**snap["server"], **snap["global"]}

    def reset_max_queue(self) -> None:
        self.server.reset_max_queue()

    def stop(self, timeout_s: float = 30.0) -> bool:
        if self._failed:
            return True
        return self.server.stop(timeout_s=timeout_s)


class ProcHost:
    """A worker-process mesh host (module docstring): spawns ``python -m
    fastapriori_tpu_torch.serve.router --worker`` on ``serving_prefix``
    and proxies admission through the file protocol.  ``try_submit``
    bounds the requests in flight at the worker's queue depth; a flusher
    thread writes pending requests as ``req-<seq>.json`` batches of up to
    ``batch_rows`` (one that is not full waits up to ``linger_ms``, 2 ms
    by default, from its first request's admission, so a burst crosses
    as a few files, not one per request) and a poller thread completes
    them from ``rsp-<seq>.json``.  A swap
    barrier takes the next sequence number after every request admitted
    before it, so the worker sees router order.  ``platform``:
    ``"default"`` (the worker's CUDA device) or ``"cpu"``; ``env``: the
    worker's extra environment (``CUDA_VISIBLE_DEVICES`` picks its
    card).  The worker's stderr goes to ``<workdir>/worker.log``."""

    def __init__(
        self,
        name: str,
        workdir: str,
        serving_prefix: str,
        *,
        batch_rows: int = 0,
        linger_ms: float = -1.0,
        queue_depth: int = 0,
        engine: str = "auto",
        pipeline_depth: Optional[int] = None,
        start_timeout_s: float = 120.0,
        env: Optional[dict] = None,
        platform: str = "default",
    ):
        self.name = name
        self.dir = workdir
        os.makedirs(workdir, exist_ok=True)
        # A reused directory's files belong to an earlier worker: its
        # ready.json would pass for this one's, its stop would end it.
        for fn in os.listdir(workdir):
            if fn.startswith(_PROTOCOL_PREFIXES) or fn in _PROTOCOL_FILES:
                _remove(os.path.join(workdir, fn))
        self._cap = queue_depth if queue_depth else 4 * (batch_rows or 256)
        self._lock = threading.Condition()
        self._pending: deque = deque()  # ServeRequest | ("swap", ...)
        self._outstanding: Dict[int, ServeRequest] = {}
        self._next_id = 0
        self._next_seq = 0
        self._swap_events: Dict[int, threading.Event] = {}
        self._swap_sigs: Dict[int, str] = {}
        self._failed = False
        self._alive_until = 0.0
        self._running = True
        self._stats_cache: dict = {}
        self._batch_cap = max(batch_rows or 256, 1)
        self._linger_s = (linger_ms if linger_ms >= 0 else 2.0) / 1e3
        cmd = [
            sys.executable, "-m", "fastapriori_tpu_torch.serve.router",
            "--worker", "--dir", workdir, "--serving", serving_prefix,
            "--engine", engine, "--platform", platform,
            "--batch-rows", str(batch_rows),
            "--linger-ms", str(linger_ms),
            "--queue-depth", str(queue_depth),
        ]
        if pipeline_depth is not None:
            cmd += ["--pipeline-depth", str(pipeline_depth)]
        penv = dict(os.environ)
        if env:
            penv.update(env)
        self._log_path = os.path.join(workdir, "worker.log")
        with open(self._log_path, "wb") as log:
            self.proc = subprocess.Popen(
                cmd, env=penv, stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL, stderr=log)
        deadline = time.monotonic() + start_timeout_s
        ready = None
        while time.monotonic() < deadline:
            ready = _read_json(os.path.join(workdir, "ready.json"))
            if ready is not None or self.proc.poll() is not None:
                break
            time.sleep(0.02)
        if ready is None:
            self.proc.kill()
            rc = self.proc.wait()
            raise InputError(
                f"mesh host {name}: worker failed to become ready within "
                f"{start_timeout_s}s (exit={rc}): {self._log_tail()}")
        self.signature = ready["signature"]
        self.pid = ready.get("pid")
        self._flusher = threading.Thread(
            target=self._flush_loop, name=f"fa-mesh-flush-{name}",
            daemon=True)
        self._poller = threading.Thread(
            target=self._poll_loop, name=f"fa-mesh-poll-{name}",
            daemon=True)
        self._flusher.start()
        self._poller.start()

    def _log_tail(self) -> str:
        try:
            with open(self._log_path, "rb") as f:
                lines = f.read().decode("utf-8", "replace").splitlines()
        except OSError:
            return ""
        return " | ".join(x for x in lines if x.strip())[-400:]

    # -- admission ------------------------------------------------------
    def try_submit(
        self, tokens: Sequence[str], t_sched: Optional[float] = None
    ) -> Optional[ServeRequest]:
        if self._failed:
            return None
        with self._lock:
            if len(self._pending) + len(self._outstanding) >= self._cap:
                return None
            req = ServeRequest(list(tokens), t_sched, time.monotonic())
            self._pending.append(req)
            self._lock.notify_all()
        return req

    def swap(self, payload: str) -> threading.Event:
        """Enqueue a swap barrier to the ``serving.npz`` prefix
        ``payload``, flushed behind every request admitted before it."""
        ev = threading.Event()
        with self._lock:
            self._pending.append(("swap", payload, ev))
            self._lock.notify_all()
        return ev

    # -- router-side threads --------------------------------------------
    def _flush_loop(self) -> None:
        while self._running:
            with self._lock:
                if not self._pending:
                    self._lock.wait(0.005)
                    continue
                head = self._pending[0]
                if (not isinstance(head, tuple)
                        and len(self._pending) < self._batch_cap):
                    wait = head.t_enq + self._linger_s - time.monotonic()
                    if wait > 0:
                        self._lock.wait(wait)
                        continue
                batch: List[ServeRequest] = []
                swap_cmd = None
                while self._pending and len(batch) < self._batch_cap:
                    if isinstance(self._pending[0], tuple):
                        if not batch:  # admitted requests flush first
                            swap_cmd = self._pending.popleft()
                        break
                    batch.append(self._pending.popleft())
                ids = []
                for r in batch:
                    self._outstanding[self._next_id] = r
                    ids.append(self._next_id)
                    self._next_id += 1
                seq = self._next_seq
                self._next_seq += 1
                if swap_cmd is not None:
                    # Registered under the lock: fail_outstanding either
                    # sees the barrier (and releases it) or misses the
                    # whole swap.
                    self._swap_events[seq] = swap_cmd[2]
            if swap_cmd is not None:
                _write_json_atomic(
                    os.path.join(self.dir, f"swap-{seq:08d}.json"),
                    {"prefix": swap_cmd[1]})
                continue
            _write_json_atomic(
                os.path.join(self.dir, f"req-{seq:08d}.json"),
                {"ids": ids, "baskets": [list(r.tokens) for r in batch]})

    def _poll_loop(self) -> None:
        done_rsp = set()
        stats_mtime = None
        stats_path = os.path.join(self.dir, "stats.json")
        while self._running:
            progressed = False
            try:
                names = os.listdir(self.dir)
            except OSError:
                names = []
            for fn in sorted(names):
                if fn.startswith("rsp-") and fn.endswith(".json"):
                    if fn in done_rsp:
                        continue
                    data = _read_json(os.path.join(self.dir, fn))
                    if data is None:
                        continue
                    done_rsp.add(fn)
                    _remove(os.path.join(self.dir, fn))
                    now = time.monotonic()
                    with self._lock:
                        for i, rid in enumerate(data["ids"]):
                            r = self._outstanding.pop(rid, None)
                            if r is None:
                                continue
                            r.item = data["items"][i]
                            r.model = data["models"][i]
                            r.shed = bool(data["shed"][i])
                            r.t_done = now
                        self._lock.notify_all()
                    progressed = True
                elif fn.startswith("swapped-") and fn.endswith(".json"):
                    seq = int(fn[8:-5])
                    ev = self._swap_events.get(seq)
                    if ev is not None and not ev.is_set():
                        data = _read_json(os.path.join(self.dir, fn))
                        if data is not None:
                            self._swap_sigs[seq] = data.get("to", "")
                            ev.set()
                            _remove(os.path.join(self.dir, fn))
                            progressed = True
            try:
                mtime = os.stat(stats_path).st_mtime_ns
            except OSError:
                mtime = None
            if mtime is not None and mtime != stats_mtime:
                data = _read_json(stats_path)
                if data is not None:
                    stats_mtime = mtime
                    with self._lock:
                        self._stats_cache = data
            if not progressed:
                time.sleep(0.003)

    # -- health / teardown ----------------------------------------------
    def alive(self) -> bool:
        """The process runs and its heartbeat is younger than the quorum
        bound; a live verdict is reused for 10 ms (the router asks on
        every admission, and each check is two system calls)."""
        if self._failed:
            return False
        now = time.monotonic()
        if now < self._alive_until:
            return True
        if self.proc.poll() is not None:
            return False
        try:
            age = time.time() - os.path.getmtime(
                os.path.join(self.dir, "hb"))
        except OSError:
            age = 0.0  # not yet published: the process is alive
        if age > quorum_timeout_s():
            return False
        self._alive_until = now + 0.01
        return True

    def fail_outstanding(self) -> int:
        """Answer every unfinished request of this host as a recorded
        shed and release its swap barriers; returns how many."""
        self._failed = True
        now = time.monotonic()
        n = 0
        with self._lock:
            for r in list(self._pending) + list(self._outstanding.values()):
                if not isinstance(r, tuple) and not r.done:
                    r.item = "0"
                    r.shed = True
                    r.t_done = now
                    n += 1
            events = [r[2] for r in self._pending if isinstance(r, tuple)]
            self._pending.clear()
            self._outstanding.clear()
            self._lock.notify_all()
            events += list(self._swap_events.values())
        for ev in events:
            ev.set()  # a dead host cannot hold the mesh barrier
        return n

    def kill(self) -> None:
        """Hard-kill the worker process (tests, chaos)."""
        self.proc.kill()

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats_cache)

    def metrics_snapshot(self) -> dict:
        return _read_json(os.path.join(self.dir, "metrics.json")) or {}

    def reset_max_queue(self) -> None:
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
        _write_json_atomic(os.path.join(self.dir, f"reset-{seq}.json"), {})

    def stop(self, timeout_s: float = 60.0) -> bool:
        with self._lock:
            self._running = False
            self._lock.notify_all()
        if self._failed or self.proc.poll() is not None:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc.wait()
            return True
        _write_json_atomic(os.path.join(self.dir, "stop"), {})
        try:
            self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            return False
        # The worker's final state lands before it exits.
        data = _read_json(os.path.join(self.dir, "stats.json"))
        if data is not None:
            with self._lock:
                self._stats_cache = data
        return True


class MeshRouter:
    """Routes a request stream across serving hosts (module docstring);
    the load generator drives it like one server."""

    def __init__(self, hosts: Sequence, metrics: bool = True):
        if not hosts:
            raise InputError("MeshRouter needs at least one host")
        self._hosts = list(hosts)
        self._lock = threading.Condition()
        self._admit_lock = threading.Lock()
        self._rr = 0
        self._submitted = 0
        self._shed = 0          # router sheds (every live host refused)
        self._lost_shed = 0     # a dead host's requests answered as shed
        self._rerouted = 0      # primary dead, a survivor accepted
        self._swaps = 0
        self._lost: set = set()
        self._shedding = False
        self._obs = metrics
        self.registry = MetricsRegistry()
        reg = self.registry
        self._m_submitted = reg.counter(
            "fa_mesh_submitted_total", "requests routed by the mesh")
        self._m_shed = reg.counter(
            "fa_mesh_shed_total",
            "requests shed at the router (every live host refused)")
        self._m_lost = reg.counter(
            "fa_mesh_lost_shed_total",
            "dead-host in-flight requests answered as sheds")
        self._m_rerouted = reg.counter(
            "fa_mesh_rerouted_total",
            "requests rerouted off a dead primary host")
        self._m_swaps = reg.counter(
            "fa_mesh_swaps_total", "mesh-wide hot-swap barriers")
        self._m_hosts = reg.gauge("fa_mesh_hosts_live", "live serving hosts")
        self._m_hosts.set(len(self._hosts))
        self._interval = max(heartbeat_ms() / 1e3, 0.02)
        self._running = True
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="fa-mesh-monitor", daemon=True)
        self._monitor.start()

    # -- routing --------------------------------------------------------
    def submit(
        self,
        tokens: Sequence[str],
        t_sched: Optional[float] = None,
    ) -> ServeRequest:
        """Round-robin admission with spill; a global shed only when
        every live host refused (counted once, here)."""
        with self._admit_lock:
            with self._lock:
                self._submitted += 1
                if self._obs:
                    self._m_submitted.inc()
                primary = self._rr % len(self._hosts)
                self._rr += 1
            rerouted = False
            for idx in spill_order(primary, len(self._hosts)):
                host = self._hosts[idx]
                if host.name in self._lost or not host.alive():
                    if host.name not in self._lost:
                        self._on_host_lost(host)
                    rerouted = rerouted or idx == primary
                    continue
                req = host.try_submit(tokens, t_sched)
                if req is not None:
                    if rerouted:
                        with self._lock:
                            self._rerouted += 1
                            if self._obs:
                                self._m_rerouted.inc()
                    self._shedding = False
                    return req
            return self._shed_global(tokens, t_sched)

    def _shed_global(self, tokens, t_sched) -> ServeRequest:
        now = time.monotonic()
        req = ServeRequest(list(tokens), t_sched, now)
        req.item = "0"
        req.shed = True
        req.t_done = now
        with self._lock:
            self._shed += 1
            if self._obs:
                self._m_shed.inc()
        if not self._shedding:
            self._shedding = True
            watchdog.downgrade(
                "serving", "accept", "shed",
                reason="mesh_queue_full",
                once_key="mesh:accept>shed",
                hosts=len(self._hosts),
                lost=len(self._lost),
            )
        return req

    # -- failure detector -----------------------------------------------
    def _monitor_loop(self) -> None:
        while self._running:
            for host in self._hosts:
                if host.name not in self._lost and not host.alive():
                    self._on_host_lost(host)
            time.sleep(self._interval)

    def _on_host_lost(self, host) -> None:
        with self._lock:
            if host.name in self._lost:
                return
            self._lost.add(host.name)
            live = len(self._hosts) - len(self._lost)
        watchdog.downgrade(
            "serve_mesh", "full", "degraded",
            reason="host_lost",
            once_key=f"serve_mesh:{host.name}",
            host=host.name,
            survivors=live,
        )
        n = host.fail_outstanding()
        with self._lock:
            self._lost_shed += n
            self._shed += n
            if self._obs:
                self._m_lost.inc(n)
                self._m_shed.inc(n)
                self._m_hosts.set(live)
            self._lock.notify_all()
        ledger.record("serve_host_lost", once_key=f"host:{host.name}",
                      host=host.name, survivors=live, inflight_shed=n)
        if live == 0:
            # Every host is gone: admission sheds from now on.
            ledger.record("serve_mesh_empty", once_key="serve_mesh_empty")

    # -- waiting / swap -------------------------------------------------
    def wait_for(
        self, reqs: Sequence[ServeRequest], timeout_s: float = 30.0
    ) -> bool:
        """Bounded wait until every request completed (polled: requests
        complete on the hosts' threads, a dead host's by the monitor)."""
        deadline = time.monotonic() + timeout_s
        while not all(r.done for r in reqs):
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)
        return True

    def swap(
        self, payloads: Sequence, timeout_s: Optional[float] = None
    ) -> bool:
        """Mesh-wide hot swap: admission is held while every live host
        enqueues its barrier (``payloads[i]`` for host i), so a request
        admitted after this returns is served by the new model on any
        host; then every barrier is awaited, bounded."""
        if len(payloads) != len(self._hosts):
            raise InputError(
                f"swap needs one payload per host "
                f"({len(payloads)} != {len(self._hosts)})")
        bound = quorum_timeout_s() if timeout_s is None else timeout_s
        events = []
        with self._admit_lock:
            for host, payload in zip(self._hosts, payloads):
                if host.name in self._lost:
                    continue
                events.append(host.swap(payload))
        deadline = time.monotonic() + bound
        ok = True
        for ev in events:
            ok = ev.wait(max(deadline - time.monotonic(), 0.001)) and ok
        with self._lock:
            self._swaps += 1
            if self._obs:
                self._m_swaps.inc()
        ledger.record("serve_mesh_swap", hosts=len(events), ok=ok)
        return ok

    # -- observability ---------------------------------------------------
    def metrics_snapshot(self) -> dict:
        """Every host's registry and the router's own, merged."""
        snaps = [self.registry.snapshot()]
        snaps += [h.metrics_snapshot() for h in self._hosts]
        return obs_metrics.merge_snapshots(snaps)

    def metrics_text(self) -> str:
        """One Prometheus text for the whole mesh."""
        return obs_metrics.render_snapshot(self.metrics_snapshot())

    def stats(self) -> dict:
        per_host = []
        totals = dict.fromkeys(
            ("served", "batches", "shed", "failed", "errors"), 0)
        max_queue = 0
        for h in self._hosts:
            s = h.stats()
            per_host.append({"host": h.name, "lost": h.name in self._lost,
                             **s})
            for key in totals:
                totals[key] += s.get(key, 0)
            max_queue = max(max_queue, s.get("max_queue", 0))
        with self._lock:
            return {
                "hosts": len(self._hosts),
                "hosts_lost": len(self._lost),
                "submitted": self._submitted,
                "served": totals["served"],
                "shed": self._shed + totals["shed"],
                "failed": totals["failed"],
                "errors": totals["errors"],
                "router_shed": self._shed,
                "lost_shed": self._lost_shed,
                "rerouted": self._rerouted,
                "swaps": self._swaps,
                "batches": totals["batches"],
                "max_queue": max_queue,
                "per_host": per_host,
            }

    def reset_max_queue(self) -> None:
        for h in self._hosts:
            if h.name not in self._lost:
                h.reset_max_queue()

    def drain(self, timeout_s: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout_s
        for h in self._hosts:
            if h.name in self._lost or not isinstance(h, LocalHost):
                continue
            if not h.server.drain(max(deadline - time.monotonic(), 0.001)):
                return False
        return True

    def stop(self, timeout_s: float = 60.0) -> bool:
        with self._admit_lock:
            self._running = False
        ok = True
        for h in self._hosts:
            ok = h.stop(timeout_s=timeout_s) and ok
        self._monitor.join(timeout_s)
        return ok and not self._monitor.is_alive()


# ---------------------------------------------------------------------
# Worker process: one serving host behind the file protocol.
# ---------------------------------------------------------------------

def _launch_counts() -> dict:
    """The process's hand-kernel launch counters (each wrapper counts
    its own launches)."""
    from fastapriori_tpu_torch.ops.level_kernel import level_counts
    from fastapriori_tpu_torch.ops.match_kernel import first_match
    from fastapriori_tpu_torch.ops.vertical_kernel import vertical_counts

    return {"level_counts": level_counts.launches,
            "first_match": first_match.launches,
            "vertical_counts": vertical_counts.launches}


def _worker_serve(args) -> int:
    from fastapriori_tpu_torch.device import resolve_device
    from fastapriori_tpu_torch.obs import trace
    from fastapriori_tpu_torch.reliability.quorum import heartbeat_ms

    trace.maybe_enable(explicit=False)
    device = "cpu" if args.platform == "cpu" else "cuda"
    resolve_device(device)  # no CUDA device and no --platform cpu: exit 2
    state = ServingState.load(args.serving, device=device,
                              engine=args.engine)
    # start() mounts the table on the device and launches K2 once
    # (ServingState.warm) before ready.json is written.
    server = RecommendServer(
        state,
        batch_rows=args.batch_rows or None,
        linger_ms=None if args.linger_ms < 0 else args.linger_ms,
        queue_depth=args.queue_depth or None,
        pipeline_depth=args.pipeline_depth,
    ).start()
    d = args.dir
    hb_s = heartbeat_ms() / 1e3
    states = [state]  # every model this worker mounted

    def publish() -> None:
        # Only the heartbeat's mtime is read (ProcHost.alive); the
        # atomic commit refreshes it.
        _write_json_atomic(os.path.join(d, "hb"), {"t": time.time()})
        snap = server.metrics_snapshot()
        _write_json_atomic(os.path.join(d, "metrics.json"),
                           {**snap["server"], **snap["global"]})
        _write_json_atomic(os.path.join(d, "stats.json"), {
            **server.stats(), "launches": _launch_counts(),
            "scan_dispatches_total": sum(s.scan_dispatches for s in states)})

    publish()
    _write_json_atomic(os.path.join(d, "ready.json"),
                       {"signature": state.signature, "pid": os.getpid()})
    processed: set = set()
    outstanding: deque = deque()  # (seq, ids, requests)
    swaps_pending: Dict[int, tuple] = {}  # seq -> (event, signature)
    last_hb = time.monotonic()
    while True:
        progressed = False
        try:
            names = sorted(os.listdir(d))
        except OSError:
            names = []
        for fn in names:
            # The heartbeat is due between files too: a long backlog of
            # requests never leaves it stale.
            if time.monotonic() - last_hb >= hb_s:
                last_hb = time.monotonic()
                publish()
            if fn.startswith("req-") and fn.endswith(".json"):
                seq = int(fn[4:-5])
                if seq in processed:
                    continue
                data = _read_json(os.path.join(d, fn))
                if data is None:
                    continue
                processed.add(seq)
                _remove(os.path.join(d, fn))
                failpoints.fire("router.req")
                reqs = [server.submit(b) for b in data["baskets"]]
                outstanding.append((seq, data["ids"], reqs))
                progressed = True
            elif fn.startswith("swap-") and fn.endswith(".json"):
                seq = int(fn[5:-5])
                if seq in processed:
                    continue
                data = _read_json(os.path.join(d, fn))
                if data is None:
                    continue
                processed.add(seq)
                _remove(os.path.join(d, fn))
                failpoints.fire("router.swap")
                new_state = ServingState.load(data["prefix"], device=device,
                                              engine=args.engine)
                # The new table is mounted (K2 launched once, fetched)
                # before it enters the queue, so the scan stage never
                # stalls on it mid-batch.
                new_state.device_ready()
                states.append(new_state)
                swaps_pending[seq] = (server.swap(new_state),
                                      new_state.signature)
                progressed = True
            elif fn.startswith("reset-"):
                server.reset_max_queue()
                _remove(os.path.join(d, fn))
        answered = False
        while outstanding and all(r.done for r in outstanding[0][2]):
            seq, ids, reqs = outstanding.popleft()
            _write_json_atomic(os.path.join(d, f"rsp-{seq:08d}.json"), {
                "ids": ids,
                "items": [r.item for r in reqs],
                "models": [r.model for r in reqs],
                "shed": [bool(r.shed) for r in reqs],
            })
            answered = progressed = True
        if answered:
            # The counters are current once this round's responses are
            # visible (one publish a round, not one a response: the
            # loop's Python work competes with the scan thread).
            publish()
            last_hb = time.monotonic()
        for seq in list(swaps_pending):
            ev, sig = swaps_pending[seq]
            if ev.is_set():
                del swaps_pending[seq]
                _write_json_atomic(os.path.join(d, f"swapped-{seq:08d}.json"),
                                   {"to": sig, "error": ev.error})
                progressed = True
        if (os.path.exists(os.path.join(d, "stop")) and not outstanding
                and not swaps_pending):
            break
        if time.monotonic() - last_hb >= hb_s:
            last_hb = time.monotonic()
            publish()
        if not progressed:
            time.sleep(0.002)
    server.stop(drain=True)
    publish()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m fastapriori_tpu_torch.serve.router --worker``: one
    serving host behind the file protocol (spawned by :class:`ProcHost`).
    Exit 2 on an InputError (no CUDA device without ``--platform cpu``,
    a missing or corrupt ``serving.npz``)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="fastapriori_tpu_torch.serve.router",
        description="serving-mesh worker host (spawned by ProcHost)")
    p.add_argument("--worker", action="store_true", required=True)
    p.add_argument("--dir", required=True)
    p.add_argument("--serving", required=True,
                   help="serving.npz prefix to serve from")
    p.add_argument("--engine", default="auto")
    p.add_argument("--platform", choices=["default", "cpu"],
                   default="default",
                   help="default = the CUDA device; cpu = plain PyTorch "
                   "versions of every kernel on the CPU")
    p.add_argument("--batch-rows", type=int, default=0)
    p.add_argument("--linger-ms", type=float, default=-1.0)
    p.add_argument("--queue-depth", type=int, default=0)
    p.add_argument("--pipeline-depth", type=int, default=None)
    args = p.parse_args(argv)
    try:
        return _worker_serve(args)
    except InputError as e:
        print(f"fastapriori worker: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
