"""Strict environment parsing (counterpart: fastapriori_tpu/utils/env.py
``env_flag``, ``env_choice``, ``env_int`` and ``env_float``).

The port reads ``FA_MINE_ENGINE``, ``FA_COUNT_REDUCE``,
``FA_COUNT_SPARSE_CAP``, ``FA_VERTICAL_CHUNK`` and
``FA_VERTICAL_LANE_TILE`` (models/apriori.py), ``FA_EXCHANGE_GROUPS``
(parallel/hier.py), ``FA_RULE_SHARDS`` (rules/gen.py),
``FA_NO_PALLAS`` (device.py ``plain_kernels``), ``FA_REC_BATCH``
(models/recommender.py), ``FA_INGEST_THREADS`` (preprocess.py
``ingest_thread_count``), ``FA_RULE_ENGINE`` (rules/gen.py
``rule_engine_from_env``), the reliability core's ``FA_FAILPOINTS``
(reliability/failpoints.py), ``FA_RETRY_MAX`` and
``FA_RETRY_BACKOFF_MS`` (reliability/retry.py),
``FA_DISPATCH_TIMEOUT_S`` and ``FA_DISPATCH_MAX_ABANDONED``
(reliability/watchdog.py), and the observability knobs ``FA_TRACE``,
``FA_TRACE_EVENTS`` (obs/trace.py), ``FA_FLIGHT_RECORDER_N``
(obs/flight.py), ``FA_METRICS_DUMP_S`` (obs/metrics.py) and
``FA_DEVICE_TRACE`` (obs/device_trace.py), and the serving tier's
``FA_SERVE_PIPELINE_DEPTH`` (serve/server.py) and ``FA_SERVE_HOSTS``
(serve/router.py), and the quorum domain's ``FA_QUORUM_DIR``,
``FA_QUORUM_RANK``, ``FA_QUORUM_PROCS``, ``FA_QUORUM_TIMEOUT_S``,
``FA_HEARTBEAT_MS`` and ``FA_EPOCH_RETRY_MAX``
(reliability/quorum.py); a value it does not know is an error, never a
quiet default.
"""

from __future__ import annotations

import os
from typing import Optional

from fastapriori_tpu_torch.errors import InputError

_FALSY = ("", "0", "false", "no")
_TRUTHY = ("1", "true", "yes", "on")


def env_flag(name: str, default: bool = False) -> bool:
    """Strict boolean knob: unset -> ``default``; ``0``/``false``/``no``
    (or empty) -> False; ``1``/``true``/``yes``/``on`` -> True (any case,
    surrounding blanks ignored); anything else -> ``InputError``."""
    raw = os.environ.get(name, "")
    val = raw.strip().lower()
    if val in _FALSY:
        return default if raw == "" else False
    if val in _TRUTHY:
        return True
    raise InputError(
        f"unrecognized {name} value {raw!r}: use one of "
        f"{'/'.join(_TRUTHY)} to enable, "
        f"{'/'.join(v for v in _FALSY if v)} (or unset) to disable"
    )


def env_choice(
    name: str, choices: tuple, default: Optional[str] = None
) -> Optional[str]:
    """Strict enumerated knob: unset -> ``default``, a listed choice ->
    itself (case-normalized), anything else -> ``InputError``."""
    raw = os.environ.get(name, "")
    val = raw.strip().lower()
    if not val:
        return default
    if val in choices:
        return val
    raise InputError(
        f"unrecognized {name} value {raw!r}: use one of "
        f"{'/'.join(choices)} (or unset for the config default)"
    )


def env_str(name: str, default: str = "") -> str:
    """Free-form knob (a path: every string is valid): the value with
    surrounding blanks stripped, ``default`` when unset or blank."""
    return os.environ.get(name, "").strip() or default


def env_int(name: str, default: int, minimum: Optional[int] = None) -> int:
    """Strict integer knob: unset -> ``default``, an integer of at least
    ``minimum`` -> itself, anything else -> ``InputError``."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        raise InputError(
            f"unrecognized {name} value {raw!r}: expected an integer"
        ) from None
    if minimum is not None and val < minimum:
        raise InputError(f"{name}={val} is out of range: must be >= {minimum}")
    return val


def env_float(
    name: str, default: float, minimum: Optional[float] = None
) -> float:
    """Strict float knob: unset -> ``default``, a number of at least
    ``minimum`` -> itself, anything else -> ``InputError``."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = float(raw)
    except ValueError:
        raise InputError(
            f"unrecognized {name} value {raw!r}: expected a number"
        ) from None
    if minimum is not None and val < minimum:
        raise InputError(f"{name}={val} is out of range: must be >= {minimum}")
    return val
