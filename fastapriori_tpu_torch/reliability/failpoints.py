"""Deterministic fault injection, stdlib only (counterpart:
fastapriori_tpu/reliability/failpoints.py, with the same grammar, kinds
and site names).

Each degradation path (a device OOM mid-fetch, a truncated artifact, a
slow link, a crash between two levels) has a *name*: an injection site
threaded through the audited fetch sites, the native loader and every
artifact write.  Tests, or ``FA_FAILPOINTS``, arm a site with a
deterministic failure spec, so the retry, ledger and manifest machinery
runs on the CPU in milliseconds.

Spec grammar (comma-separated sites)::

    FA_FAILPOINTS="<site>:<kind>[@<arg>][*<count>][,<site>:<kind>...]"

kinds:

- ``oom``          raise a ``RuntimeError`` whose message starts
                   ``RESOURCE_EXHAUSTED:`` (retry.py classifies it as
                   transient; it is deliberately not
                   ``torch.cuda.OutOfMemoryError``, so an injected fault
                   stays distinguishable from a real one);
- ``io``           raise ``OSError`` (filesystem failure);
- ``abort``        raise :class:`InjectedAbort` — a stand-in for a hard
                   crash (SIGKILL) that nothing downstream may catch as
                   transient;
- ``delay@MS``     sleep MS milliseconds (slow-link simulation);
- ``truncate@N``   artifact-write sites only: physically truncate the
                   written file at byte N (the manifest still records the
                   full intended content, so validation must reject it).

``*count`` arms the site for the first ``count`` hits only — ``oom*1``
fails once and then passes, which is exactly the shape of a transient
fault the retry policy must absorb.  Without ``*count`` the site fires on
every hit.

Sites are plain dotted names (``fetch.pair``, ``write.freqItems``,
``level.4``); :func:`fire` is a no-op for unarmed sites (one dict lookup
— safe on hot paths).  Unknown kinds or malformed specs raise
:class:`fastapriori_tpu_torch.errors.InputError` at parse time, not silently at
the hundredth hit.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

from fastapriori_tpu_torch.errors import InputError

_KINDS = ("oom", "io", "abort", "delay", "truncate")

# Kinds that take / require an integer argument.
_ARG_REQUIRED = ("delay", "truncate")


class InjectedAbort(BaseException):
    """A failpoint-injected hard crash.  Deliberately a BaseException
    subclass so no ``except Exception`` recovery path (retry, fallback)
    can absorb it — the closest in-process analog of SIGKILL."""


class _Spec:
    __slots__ = ("kind", "arg", "remaining")

    def __init__(self, kind: str, arg: Optional[int], count: Optional[int]):
        self.kind = kind
        self.arg = arg
        self.remaining = count  # None = unlimited

    def take(self) -> bool:
        """Consume one hit; False once the armed count is exhausted."""
        if self.remaining is None:
            return True
        if self.remaining <= 0:
            return False
        self.remaining -= 1
        return True


_lock = threading.Lock()
_active: Dict[str, _Spec] = {}
_env_loaded = False


def _resource_exhausted(site: str) -> Exception:
    """A ``RESOURCE_EXHAUSTED``-shaped error: what retry.classify treats
    as a transient device allocation or transfer failure."""
    return RuntimeError(
        "RESOURCE_EXHAUSTED: injected failpoint "
        f"{site!r} (FA_FAILPOINTS): out of memory while simulating a "
        "device allocation/transfer failure"
    )


def parse_spec(text: str) -> Dict[str, _Spec]:
    """Parse a ``FA_FAILPOINTS`` value; InputError on malformed input."""
    out: Dict[str, _Spec] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        site, sep, rest = part.partition(":")
        if not sep or not site:
            raise InputError(
                f"malformed FA_FAILPOINTS entry {part!r}: expected "
                "'<site>:<kind>[@arg][*count]'"
            )
        count: Optional[int] = None
        if "*" in rest:
            rest, _, cnt = rest.rpartition("*")
            try:
                count = int(cnt)
            except ValueError:
                raise InputError(
                    f"malformed FA_FAILPOINTS count in {part!r}: "
                    f"{cnt!r} is not an integer"
                ) from None
        kind, _, arg_s = rest.partition("@")
        if kind not in _KINDS:
            raise InputError(
                f"unknown FA_FAILPOINTS kind {kind!r} in {part!r} "
                f"(known: {', '.join(_KINDS)})"
            )
        arg: Optional[int] = None
        if arg_s:
            try:
                arg = int(arg_s)
            except ValueError:
                raise InputError(
                    f"malformed FA_FAILPOINTS argument in {part!r}: "
                    f"{arg_s!r} is not an integer"
                ) from None
        if arg is None and kind in _ARG_REQUIRED:
            raise InputError(
                f"FA_FAILPOINTS kind {kind!r} requires '@<int>' "
                f"(e.g. '{site}:{kind}@100') in {part!r}"
            )
        out[site] = _Spec(kind, arg, count)
    return out


def _ensure_env_loaded() -> None:
    global _env_loaded
    if _env_loaded:
        return
    with _lock:
        if _env_loaded:
            return
        text = os.environ.get("FA_FAILPOINTS", "")
        if text:
            _active.update(parse_spec(text))
        _env_loaded = True


def reload_from_env() -> None:
    """Re-read ``FA_FAILPOINTS`` (tests; the env is otherwise read once)."""
    global _env_loaded
    with _lock:
        _active.clear()
        _env_loaded = False
    _ensure_env_loaded()


def arm(site: str, spec: str) -> None:
    """Programmatic arming: ``arm("fetch.pair", "oom*1")``."""
    _ensure_env_loaded()
    with _lock:
        _active.update(parse_spec(f"{site}:{spec}"))


def disarm_all() -> None:
    """Clear every armed site (tests)."""
    global _env_loaded
    with _lock:
        _active.clear()
        _env_loaded = True  # explicit state; reload_from_env re-reads


def active() -> Dict[str, str]:
    """Armed sites -> kind (diagnostics)."""
    _ensure_env_loaded()
    with _lock:
        return {s: sp.kind for s, sp in _active.items()}


def fire(site: str) -> None:
    """Injection point.  No-op unless ``site`` is armed; otherwise raise
    or delay per the armed spec.  ``truncate`` specs do NOT fire here —
    they are consumed by the writing layer via :func:`truncation`."""
    _ensure_env_loaded()
    with _lock:
        spec = _active.get(site)
        if spec is None or spec.kind == "truncate" or not spec.take():
            return
        kind, arg = spec.kind, spec.arg
    if kind == "oom":
        raise _resource_exhausted(site)
    if kind == "io":
        raise OSError(
            f"injected failpoint {site!r} (FA_FAILPOINTS): simulated "
            "filesystem failure"
        )
    if kind == "abort":
        raise InjectedAbort(f"injected failpoint {site!r} (FA_FAILPOINTS)")
    if kind == "delay":
        time.sleep((arg or 0) / 1e3)


def truncation(site: str) -> Optional[int]:
    """For artifact-write sites: byte count to truncate the physical
    write at, or None when unarmed.  Consumes one hit."""
    _ensure_env_loaded()
    with _lock:
        spec = _active.get(site)
        if spec is None or spec.kind != "truncate" or not spec.take():
            return None
        return spec.arg
