"""Dispatch watchdog and the degradation cascade (counterpart:
fastapriori_tpu/reliability/watchdog.py).

**Watchdog.**  A blocking fetch can hang (a wedged device, a runtime
bug), and the retry layer sees only raised errors.  :func:`guard` bounds
every audited fetch with a wall clock: past ``FA_DISPATCH_TIMEOUT_S``
(strictly parsed; unset or 0 disables it, the default) the blocked call
is abandoned and :class:`DispatchTimeout` raises with the
``DEADLINE_EXCEEDED`` status, which retry.py classifies as transient, so
the bounded retry policy gets its shot.  Every trip is a
``watchdog_timeout`` ledger event carrying the live abandoned-thread
count; a trip past ``FA_DISPATCH_MAX_ABANDONED`` (default 8, 0 = no cap)
raises the fatal :class:`AbandonedThreadCap` instead of leaking one more
thread, after the flight recorder (obs/flight.py ``auto_dump``) has
written its ring against the prefix the CLI registered.

**Cascade.**  :data:`CHAINS` is the one escalation policy: each
subsystem's downgrade order, the same table as the JAX package's.
:func:`downgrade` records one forward walk as a ``cascade`` ledger event.
The chains this port walks: ``engine`` (fused -> tail -> level),
``mine_engine`` (vertical -> bitmap) and ``rule_engine`` (device ->
host), each only on a transient that an audited fetch's bounded retry
gave up on (retry.py ``exhausted``): an error raised anywhere else, a
kernel wrapper's launch or allocation included, propagates.  ``rule_scan``
(device table -> host scan) and the kernel-tier chains
``vertical_kernel`` and ``serve_scan`` (stages "cuda", "torch") keep
their names but are never walked, on the batch path and in the serving
tier alike: each would move K2's or K3's work off the card to the CPU or
to the kernel's plain version, so a failure of K1, K2 or K3 on the card
stays an error.  The serving tier walks ``serving`` (accept -> shed, an
overload episode) and ``serve_mesh`` (full -> degraded, a lost host).
On a mesh of more than one transaction shard the level engine also walks
``exchange`` (hier -> flat) and ``count_reduce`` (sparse -> dense), again
only when a sparse reduction's audited fetch used up its retries (the
level, or the pair phase, is then counted dense); a union past its
budget walks ``count_reduce`` for that reduction.  In a multi-process
fault domain (reliability/quorum.py) a walk of a chain in
``CONSENSUS_CHAINS`` is proposed to the domain and adopted by every
rank; ``elastic`` (continue -> abort) is walked when elastic
continuation spends its ``FA_EPOCH_RETRY_MAX`` budget.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple, TypeVar

from fastapriori_tpu_torch.reliability import ledger

T = TypeVar("T")

# The escalation policy: per subsystem, the downgrade order (most capable
# first).  Tests pin this ordering against the JAX package's table.
CHAINS: Dict[str, Tuple[str, ...]] = {
    "engine": ("fused", "tail", "level"),
    "mine_engine": ("vertical", "bitmap"),
    "count_reduce": ("sparse", "dense"),
    "exchange": ("hier", "flat"),
    "rule_engine": ("sharded", "device", "host"),
    "rule_scan": ("device", "host"),  # named, never walked (docstring)
    "serving": ("accept", "shed"),
    "elastic": ("continue", "abort"),
    # Kernel tiers: named so the tables match, never walked (docstring).
    "vertical_kernel": ("cuda", "torch"),
    "serve_scan": ("cuda", "torch"),
    "serve_mesh": ("full", "degraded"),
}


def chain_rank(chain: str, stage: str) -> int:
    """Position of ``stage`` in its chain (0 = most capable)."""
    return CHAINS[chain].index(stage)


def downgrade(
    chain: str,
    frm: str,
    to: str,
    reason: str,
    once_key: Optional[str] = None,
    **fields: Any,
) -> None:
    """Record one walk down an escalation chain.  ``frm`` and ``to`` must
    both belong to ``chain`` and the walk must be forward (toward the end
    of the chain); a backward call is a wiring bug and raises."""
    order = CHAINS.get(chain)
    if order is None:
        raise ValueError(f"unknown cascade chain {chain!r}")
    i, j = order.index(frm), order.index(to)
    if j <= i:
        raise ValueError(
            f"cascade {chain}: {frm!r} -> {to!r} walks backward "
            f"(chain order {order})"
        )
    if reason != "quorum":
        # A local walk of a chain that shapes the mesh's collectives is
        # a proposal to the fault domain at once (peers adopt it before
        # their next dispatch); an adoption comes back here with reason
        # "quorum" and proposes nothing.  No-op without a domain.
        from fastapriori_tpu_torch.reliability import quorum

        if chain in quorum.CONSENSUS_CHAINS:
            quorum.propose(chain, to, reason)
    ledger.record(
        "cascade",
        once_key=once_key or f"{chain}:{frm}>{to}:{reason}",
        chain=chain,
        frm=frm,
        to=to,
        rank=j,
        reason=reason,
        **fields,
    )


def transient(exc: BaseException) -> bool:
    """True when ``exc`` is transient-classified (retry.classify).  User
    and fatal errors never walk a chain (a chain cannot fix a bad input,
    a shape bug or a dead CUDA context)."""
    from fastapriori_tpu_torch.reliability import retry

    return retry.classify(exc) == "transient"


class DispatchTimeout(RuntimeError):
    """A watchdog-abandoned fetch.  The message leads with
    ``DEADLINE_EXCEEDED``, so retry.classify sees a transient."""


class AbandonedThreadCap(RuntimeError):
    """A watchdog trip past ``FA_DISPATCH_MAX_ABANDONED``.  The message
    carries no transient status: the device is down, not flapping, so
    retry.classify sees a fatal."""


_timeout_memo: Optional[float] = None
_max_abandoned_memo: Optional[int] = None

_abandoned_lock = threading.Lock()
_abandoned: list = []


def dispatch_timeout_s() -> float:
    """The process-wide watchdog bound in seconds:
    ``FA_DISPATCH_TIMEOUT_S``, strictly parsed; 0 or unset disables it.
    Parsed once per process (:func:`reload_from_env`)."""
    global _timeout_memo
    if _timeout_memo is None:
        from fastapriori_tpu_torch.utils.env import env_float

        _timeout_memo = env_float("FA_DISPATCH_TIMEOUT_S", 0.0, minimum=0.0)
    return _timeout_memo


def max_abandoned() -> int:
    """Cap on abandoned fetch threads alive at once:
    ``FA_DISPATCH_MAX_ABANDONED``, strictly parsed; default 8, 0 = no
    cap."""
    global _max_abandoned_memo
    if _max_abandoned_memo is None:
        from fastapriori_tpu_torch.utils.env import env_int

        _max_abandoned_memo = env_int("FA_DISPATCH_MAX_ABANDONED", 8,
                                      minimum=0)
    return _max_abandoned_memo


def abandoned_live() -> int:
    """Abandoned worker threads still alive (dead ones are pruned)."""
    with _abandoned_lock:
        _abandoned[:] = [t for t in _abandoned if t.is_alive()]
        return len(_abandoned)


def _register_abandoned(worker: threading.Thread) -> int:
    with _abandoned_lock:
        _abandoned[:] = [t for t in _abandoned if t.is_alive()]
        _abandoned.append(worker)
        return len(_abandoned)


def reload_from_env() -> None:
    """Re-read the FA_DISPATCH_* knobs (tests; otherwise read once)."""
    global _timeout_memo, _max_abandoned_memo
    _timeout_memo = None
    _max_abandoned_memo = None


def reset_abandoned() -> None:
    """Forget the abandoned-thread registry (tests)."""
    with _abandoned_lock:
        _abandoned.clear()


def guard(
    thunk: Callable[[], T],
    site: str,
    timeout_s: Optional[float] = None,
) -> T:
    """Run ``thunk`` under the watchdog bound.  Disabled (the default)
    this is a plain call.  Enabled, the thunk runs on a daemon thread and
    the caller waits at most the bound; past it the thread is abandoned,
    a ``watchdog_timeout`` event is recorded and :class:`DispatchTimeout`
    raises.  The thunk's own exceptions, BaseExceptions included,
    re-raise on the caller."""
    bound = dispatch_timeout_s() if timeout_s is None else timeout_s
    if not bound:
        return thunk()
    box: list = []

    def run() -> None:
        try:
            box.append(("ok", thunk()))
        except BaseException as exc:  # re-raised on the caller below
            box.append(("err", exc))

    worker = threading.Thread(target=run, name=f"fa-watchdog:{site}",
                              daemon=True)
    worker.start()
    worker.join(bound)
    if not box:
        live = _register_abandoned(worker)
        cap = max_abandoned()
        ledger.record("watchdog_timeout", once_key=site, site=site,
                      timeout_s=bound, abandoned_live=live)
        if cap and live > cap:
            # The process is wedged, not flapping: ship the post-mortem
            # (the trips and retries that led here) before the fatal
            # raise; a failing dump returns None and masks nothing.
            from fastapriori_tpu_torch.obs import flight

            flight.auto_dump(
                "abandoned_thread_cap",
                extra={"site": site, "abandoned_live": live, "cap": cap},
            )
            raise AbandonedThreadCap(
                f"dispatch watchdog: {live} abandoned fetch threads still "
                f"live after abandoning {site!r}, past the "
                f"FA_DISPATCH_MAX_ABANDONED cap of {cap}; the device is "
                "wedged, not flapping"
            )
        raise DispatchTimeout(
            f"DEADLINE_EXCEEDED: dispatch watchdog abandoned {site!r} "
            f"after {bound}s (FA_DISPATCH_TIMEOUT_S); the retried thunk "
            "is a re-runnable host materialization"
        )
    kind, payload = box[0]
    if kind == "err":
        raise payload
    return payload
