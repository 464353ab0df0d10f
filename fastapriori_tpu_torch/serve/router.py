"""MeshRouter: one request stream across several serving hosts
(counterpart: fastapriori_tpu/serve/router.py ``MeshRouter``,
``LocalHost`` and ``hosts_from_env``; ``spill_order`` and
``resolve_spec`` come from parallel/hier.py, the port's copy of the JAX
package's).

The router presents the single server's surface (submit, wait_for,
stats, metrics, swap) over a list of hosts, each a whole admission queue
+ dispatcher + scan stack, so the load generator and the CLI drive a
mesh like one server.  The hosts here are in-process
(:class:`LocalHost`, one started ``RecommendServer`` each).

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

Left for the multi-GPU slice: the JAX package's ``ProcHost`` (a
subprocess host behind a file protocol with heartbeats), its worker
``_worker_serve`` and the module's ``main``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Sequence

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.obs import metrics as obs_metrics
from fastapriori_tpu_torch.obs.metrics import MetricsRegistry
from fastapriori_tpu_torch.parallel.hier import (  # noqa: F401
    resolve_spec,
    spill_order,
)
from fastapriori_tpu_torch.reliability import ledger, watchdog
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
            if h.name in self._lost:
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
