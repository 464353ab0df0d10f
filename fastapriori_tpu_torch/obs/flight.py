"""Crash flight recorder: the last N observability events, dumped on
failure (counterpart: fastapriori_tpu/obs/flight.py).

By the time a watchdog trip, an ``AbandonedThreadCap`` or a classified
error surfaces, what the process was doing just before is gone from
every log that only aggregates.  The recorder keeps a bounded ring of the
most recent span, ledger and watchdog events (always on: an append is a
lock and a deque append; spans enter only while tracing is enabled) and
writes it as a manifest-committed JSON artifact when something dies:

- the degradation ledger forwards every event here (watchdog timeouts,
  cascade walks and retries included);
- the tracer appends each completed span while enabled;
- the quorum domain (reliability/quorum.py) notes every completed sync
  (``quorum``: its epoch, site and positions) and every elastic rejoin
  (``mesh_epoch``), and the miner its re-seed after one
  (``mesh_epoch_reseed``: the epoch, the members, the level it resumes
  from);
- :func:`auto_dump` fires at the watchdog's abandoned-thread cap
  (reliability/watchdog.py), on the CLI's ``InputError`` exit and when a
  quorum sync or exchange gives up on a lost peer or a divergent mesh
  (reason ``PeerLost`` or ``MeshDivergence``, the domain's epoch trail
  in the dump), against the prefix the CLI registered
  (:func:`set_dump_prefix`; ``rank<r>.`` after the output prefix in a
  domain of more than one rank).

``FA_FLIGHT_RECORDER_N`` sizes the ring (strict; 0 disables), read when
a recorder is built without a capacity and by :func:`reload_from_env`,
which the CLI calls at the start of every run; the process-wide
:data:`RECORDER` is built at the default size, so importing the port
parses no knob.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

FLIGHT_NAME = "flight.json"
DEFAULT_RING = 256


def ring_size() -> int:
    """``FA_FLIGHT_RECORDER_N``: ring capacity in events (strictly
    parsed; default 256, 0 disables recording)."""
    from fastapriori_tpu_torch.utils.env import env_int

    return env_int("FA_FLIGHT_RECORDER_N", DEFAULT_RING, minimum=0)


class FlightRecorder:
    """Bounded ring (module docstring).  ``seq`` is a monotone event
    number, so a dump shows how many events the ring dropped."""

    def __init__(self, cap: Optional[int] = None):
        self._lock = threading.Lock()
        self._dump_prefix: Optional[str] = None
        self._init(cap)

    def _init(self, cap: Optional[int]) -> None:
        self._cap = ring_size() if cap is None else cap
        self._ring: deque = deque(maxlen=self._cap or 1)
        self._seq = 0
        self._t0 = time.monotonic()
        # Wall-clock anchor of the same instant as _t0: event t_s values
        # are monotonic-relative; t_abs = t0_unix_s + t_s.
        self._t0_wall = time.time()
        self.dumps = 0

    @property
    def cap(self) -> int:
        return self._cap

    def note(self, kind: str, **fields: Any) -> None:
        if not self._cap:
            return
        with self._lock:
            self._seq += 1
            self._ring.append({
                "seq": self._seq,
                "t_s": round(time.monotonic() - self._t0, 6),
                "kind": kind,
                **fields,
            })

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._ring]

    def set_dump_prefix(self, prefix: Optional[str]) -> None:
        """Where :meth:`auto_dump` writes: the CLI registers its output
        prefix, so the reliability layer's triggers, which have no path
        in scope, can still ship the post-mortem."""
        self._dump_prefix = prefix

    def dump(self, prefix: str, reason: str,
             extra: Optional[dict] = None) -> str:
        """Write ``<prefix>flight.json`` through the crash-safe writer and
        the run's manifest: the ring, the trigger's reason and the drop
        accounting (``first_seq`` > 1 means the ring wrapped).  Returns
        the artifact's path."""
        from fastapriori_tpu_torch.io.writer import (
            write_artifact_bytes,
            write_manifest,
        )

        events = self.snapshot()
        body = {
            "version": 1,
            "reason": reason,
            "ring_capacity": self._cap,
            "total_events": self._seq,
            "first_seq": events[0]["seq"] if events else None,
            "t0_unix_s": round(self._t0_wall, 6),
            "events": events,
        }
        if extra:
            body["context"] = extra
        manifest: Dict[str, dict] = {}
        path = write_artifact_bytes(
            prefix + FLIGHT_NAME,
            [(json.dumps(body, indent=1, default=str) + "\n").encode()],
            FLIGHT_NAME,
            manifest,
        )
        write_manifest(prefix, manifest)
        self.dumps += 1
        return path

    def auto_dump(self, reason: str,
                  extra: Optional[dict] = None) -> Optional[str]:
        """Dump against the registered prefix; None when none is
        registered or the dump fails: the recorder rides error paths,
        and a failing dump must never mask the error it documents."""
        if self._dump_prefix is None:
            return None
        try:
            return self.dump(self._dump_prefix, reason, extra)
        except Exception:  # a post-mortem on a path that is failing anyway
            return None

    def reset(self, cap: Optional[int] = None) -> None:
        """Empty the ring; ``cap`` None re-reads ``FA_FLIGHT_RECORDER_N``.
        The dump prefix stays."""
        with self._lock:
            self._init(cap)


RECORDER = FlightRecorder(DEFAULT_RING)


def note(kind: str, **fields: Any) -> None:
    RECORDER.note(kind, **fields)


def snapshot() -> List[Dict[str, Any]]:
    return RECORDER.snapshot()


def dump(prefix: str, reason: str, extra: Optional[dict] = None) -> str:
    return RECORDER.dump(prefix, reason, extra)


def auto_dump(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    return RECORDER.auto_dump(reason, extra)


def set_dump_prefix(prefix: Optional[str]) -> None:
    RECORDER.set_dump_prefix(prefix)


def reload_from_env() -> None:
    """Re-read ``FA_FLIGHT_RECORDER_N`` and rebuild the ring (the CLI at
    the start of each run; tests)."""
    RECORDER.reset()
