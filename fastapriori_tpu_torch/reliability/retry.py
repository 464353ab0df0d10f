"""Bounded retry with transient/fatal/user error classification
(counterpart: fastapriori_tpu/reliability/retry.py; ``classify`` holds
the CUDA rules in place of the XLA runtime's types).

Classification contract:

- **user**: :class:`~fastapriori_tpu_torch.errors.InputError` and
  FileNotFoundError: the user can fix it; retrying is noise.
- **fatal**: :class:`~fastapriori_tpu_torch.reliability.failpoints.
  InjectedAbort` (a stand-in for a crash); a *sticky* CUDA error (an
  illegal address or instruction, a misaligned address, an unspecified
  launch failure, a device-side assert, a launch timeout): the process's
  CUDA context is dead after it, and a retry only repeats it.
- **transient**: ``torch.cuda.OutOfMemoryError`` (the caching allocator
  is emptied before the retry), a ``RuntimeError`` whose message carries
  one of :data:`TRANSIENT_STATUS` (the injected ``oom`` kind, the
  watchdog's ``DEADLINE_EXCEEDED``), and the OSError errnos a flaky link
  or filesystem produces (EIO, EAGAIN, EBUSY, ETIMEDOUT, ECONNRESET).
- **fatal**: everything else (shape errors, TypeError): retrying cannot
  change the outcome.

Backoff is deterministic (exponential, no jitter).  ``FA_RETRY_MAX`` and
``FA_RETRY_BACKOFF_MS`` tune the policy for the process, strictly parsed
(:func:`policy_from_env`); explicit ``policy=`` arguments win.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import time
from typing import Callable, Optional, TypeVar

import numpy as np
import torch

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.reliability import failpoints

T = TypeVar("T")

# Status codes that justify a retry, matched against the message.
TRANSIENT_STATUS = (
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "INTERNAL",
)

# CUDA errors after which the context is unusable: every later call in
# the process fails the same way, so they are fatal however often retried
# (cudaErrorIllegalAddress, cudaErrorIllegalInstruction,
# cudaErrorMisalignedAddress, cudaErrorLaunchFailure, cudaErrorAssert,
# cudaErrorLaunchTimeout, cudaErrorHardwareStackError, and the context's
# own verdict), matched in PyTorch's and the runtime's spellings.
STICKY_CUDA_ERRORS = (
    "illegal memory access",
    "illegal address",
    "illegal instruction",
    "misaligned address",
    "unspecified launch failure",
    "device-side assert",
    "launch timed out",
    "cudaErrorLaunchTimeout",
    "cudaErrorIllegalAddress",
    "cudaErrorLaunchFailure",
    "cudaErrorAssert",
    "hardware stack error",
    "context is destroyed",
)

_TRANSIENT_ERRNOS = frozenset(
    {errno.EIO, errno.EAGAIN, errno.EBUSY, errno.ETIMEDOUT, errno.ECONNRESET}
)


def classify(exc: BaseException) -> str:
    """``"user"`` | ``"transient"`` | ``"fatal"`` (module docstring)."""
    if isinstance(exc, failpoints.InjectedAbort):
        return "fatal"
    if isinstance(exc, (InputError, FileNotFoundError)):
        return "user"
    if isinstance(exc, OSError):
        return "transient" if exc.errno in _TRANSIENT_ERRNOS else "fatal"
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "transient"
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        if any(s in msg for s in STICKY_CUDA_ERRORS):
            return "fatal"
        if any(code in msg for code in TRANSIENT_STATUS):
            return "transient"
    return "fatal"


def context_lost(exc: BaseException) -> bool:
    """True for the fatal errors after which nothing more can run on this
    process's CUDA context: a sticky CUDA error, an injected abort (the
    stand-in for a crash) and the watchdog's abandoned-thread cap (a
    wedged device).  A server's dispatcher stops on them
    (serve/server.py) instead of answering on a dead context."""
    from fastapriori_tpu_torch.reliability import watchdog

    if isinstance(exc, (failpoints.InjectedAbort,
                        watchdog.AbandonedThreadCap)):
        return True
    return (isinstance(exc, RuntimeError)
            and any(s in str(exc) for s in STICKY_CUDA_ERRORS))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff.  ``max_attempts`` counts the first
    try; delays are ``base_delay_s * factor**i`` capped at
    ``max_delay_s``."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    factor: float = 4.0
    max_delay_s: float = 2.0

    def delay(self, attempt: int) -> float:
        return min(self.base_delay_s * (self.factor ** attempt),
                   self.max_delay_s)


DEFAULT_POLICY = RetryPolicy()

_env_policy: Optional[RetryPolicy] = None


def policy_from_env() -> RetryPolicy:
    """The process-wide policy with ``FA_RETRY_MAX`` (attempts including
    the first try, >= 1) and ``FA_RETRY_BACKOFF_MS`` (base backoff, >= 0)
    applied; a malformed value raises InputError at the first retryable
    call.  Parsed once per process (:func:`reload_policy_from_env`)."""
    global _env_policy
    if _env_policy is not None:
        return _env_policy
    kw = {}
    raw = os.environ.get("FA_RETRY_MAX", "").strip()
    if raw:
        try:
            val = int(raw)
        except ValueError:
            raise InputError(
                f"unrecognized FA_RETRY_MAX value {raw!r}: expected an "
                "integer >= 1 (attempts including the first try)"
            ) from None
        if val < 1:
            raise InputError(
                f"FA_RETRY_MAX={val} is out of range: at least 1 attempt "
                "(the first try) is required"
            )
        kw["max_attempts"] = val
    raw = os.environ.get("FA_RETRY_BACKOFF_MS", "").strip()
    if raw:
        try:
            ms = float(raw)
        except ValueError:
            raise InputError(
                f"unrecognized FA_RETRY_BACKOFF_MS value {raw!r}: "
                "expected a number of milliseconds >= 0"
            ) from None
        if ms < 0:
            raise InputError(
                f"FA_RETRY_BACKOFF_MS={ms} is out of range: backoff "
                "cannot be negative"
            )
        kw["base_delay_s"] = ms / 1e3
    _env_policy = RetryPolicy(**kw) if kw else DEFAULT_POLICY
    return _env_policy


def reload_policy_from_env() -> None:
    """Re-read the FA_RETRY_* knobs (tests; otherwise read once)."""
    global _env_policy
    _env_policy = None


def call_with_retries(
    thunk: Callable[[], T],
    site: str,
    policy: Optional[RetryPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Run ``thunk`` with the site's failpoint fired inside the retried
    body (so an ``oom*1`` spec fails once and passes on the retry), each
    attempt under the dispatch watchdog (watchdog.py ``guard``).
    Transient errors back off and retry up to the policy bound, each
    retry a ``retry`` ledger event; user and fatal errors re-raise
    unchanged, and an exhausted transient re-raises tagged with the site
    (:func:`exhausted`).  After a real CUDA OOM the caching
    allocator is emptied before the retry.

    Every call is a span named ``site`` (obs/trace.py; one branch when
    tracing is off): ``retries=`` on it after a retry, ``failed=`` and
    ``attempts=`` when it gives up or meets an error it does not retry.
    A ``fetch.`` site's wall latency, retries included, goes into the
    per-site histogram of obs/metrics.py ``fetch_latency_observe``."""
    from fastapriori_tpu_torch.obs import metrics as obs_metrics
    from fastapriori_tpu_torch.obs import trace
    from fastapriori_tpu_torch.reliability import ledger, watchdog

    policy = policy or policy_from_env()
    attempt = 0
    with trace.span(site) as sp:
        t0 = time.perf_counter()
        while True:
            try:
                failpoints.fire(site)
                result = watchdog.guard(thunk, site)
                if site.startswith("fetch."):
                    obs_metrics.fetch_latency_observe(
                        site[6:], (time.perf_counter() - t0) * 1e3)
                return result
            except Exception as exc:
                transient = classify(exc) == "transient"
                if not transient or attempt >= policy.max_attempts - 1:
                    sp.update(failed=type(exc).__name__,
                              attempts=attempt + 1)
                    if transient:
                        exc.fa_retries_exhausted_at = site  # exhausted()
                    raise
                ledger.record(
                    "retry",
                    site=site,
                    attempt=attempt + 1,
                    error=f"{type(exc).__name__}: {exc}"[:200],
                )
                sp.update(retries=attempt + 1)
                if (isinstance(exc, torch.cuda.OutOfMemoryError)
                        and torch.cuda.is_initialized()):
                    torch.cuda.empty_cache()
                sleep(policy.delay(attempt))
                attempt += 1


def exhausted(exc: BaseException) -> Optional[str]:
    """The site whose bounded retry gave up on ``exc``, else None: the
    test every cascade walk makes before it walks.  Only
    :func:`call_with_retries` sets it, so an error raised outside an
    audited call (a kernel wrapper's launch or allocation, an operation
    between fetches) has none.  In a multi-process world the rank that
    gave up walks when a quorum domain is active (its walk is a proposal
    its peers adopt, reliability/quorum.py); without one, never: the
    error ends the rank and its peers see it within
    ``FA_QUORUM_TIMEOUT_S``."""
    from fastapriori_tpu_torch.parallel import mesh
    from fastapriori_tpu_torch.reliability import quorum

    if mesh.process_count() > 1 and quorum.active() is None:
        return None
    return getattr(exc, "fa_retries_exhausted_at", None)


def fetch(
    thunk: Callable[[], T],
    site: str,
    policy: Optional[RetryPolicy] = None,
) -> T:
    """Audited device -> host fetch: failpoint-instrumented and retried
    under ``fetch.<site>``.  The thunk must be re-runnable (a host
    materialization of an already computed device tensor)."""
    return call_with_retries(thunk, "fetch." + site, policy)


class AsyncFetch:
    """An audited device -> host fetch issued without waiting: on CUDA a
    non-blocking copy into pinned host memory and an event behind it;
    :meth:`result` waits for the event with the same ``fetch.<site>``
    failpoint and retry discipline as :func:`fetch`."""

    def __init__(self, x: torch.Tensor, site: str,
                 policy: Optional[RetryPolicy] = None):
        self._site = site
        self._policy = policy
        self._result: Optional[np.ndarray] = None
        if x.device.type == "cuda":
            self._host = torch.empty(x.shape, dtype=x.dtype,
                                     pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = x, None

    def _land(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()

    def result(self) -> np.ndarray:
        """The host array (blocks until the copy lands; memoized)."""
        if self._result is None:
            self._result = call_with_retries(self._land,
                                             "fetch." + self._site,
                                             self._policy)
        return self._result


def fetch_async(x: torch.Tensor, site: str,
                policy: Optional[RetryPolicy] = None) -> AsyncFetch:
    """Issue an audited fetch without blocking: an :class:`AsyncFetch`
    whose ``result()`` is read later (the level loop's survivor masks,
    the count drains and the resolve)."""
    return AsyncFetch(x, site, policy)
