"""Per-level checkpoints (counterpart: fastapriori_tpu/io/checkpoint.py,
byte-compatible with it): each completed Apriori level's survivors as a
crash-safe artifact, so ``--resume-from`` restarts a mine from the
deepest completed level instead of from scratch.

The level loop (models/apriori.py, ``--checkpoint-every-level``)
rewrites ``<prefix>checkpoint.npz`` after every completed level through
the atomic writer and the run manifest, so the file on disk is always a
complete set of levels.

Format (the JAX package's): one npz with ``meta`` = int64 ``[n_levels,
n_raw, min_count, num_items, fence]`` (fence 0 at one process) and per
level ``mat_<i>`` (int32 [N, k] lex-sorted member matrix) and ``cnt_<i>``
(int64 [N] weighted supports).  ``n_raw``, ``min_count`` and
``num_items`` pin the checkpoint to its dataset and support threshold:
resuming against other data is an :class:`InputError`.  The fence is
the quorum domain's (reliability/quorum.py): the writer stamps it into
the meta and the manifest, and a load in a domain whose fence has moved
past it raises ``StaleFenceError``.  A checkpoint either package writes
resumes under the other.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, List, Tuple

import numpy as np

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.io.reader import _open_bytes
from fastapriori_tpu_torch.io.writer import (
    write_artifact_bytes,
    write_manifest,
)

CHECKPOINT_NAME = "checkpoint.npz"

Level = Tuple[np.ndarray, np.ndarray]


def save_checkpoint(
    prefix: str, levels: List[Level], meta: Dict[str, int]
) -> int:
    """Atomically (re)write ``<prefix>checkpoint.npz`` and its manifest
    entry; returns the npz's size in bytes.  ``meta`` needs ``n_raw``,
    ``min_count`` and ``num_items``; an optional ``fence`` is stamped into
    the meta and the manifest."""
    fence = int(meta.get("fence", 0))
    arrays = {
        "meta": np.array(
            [len(levels), meta["n_raw"], meta["min_count"],
             meta["num_items"], fence],
            dtype=np.int64,
        )
    }
    for i, (mat, cnt) in enumerate(levels):
        arrays[f"mat_{i}"] = np.ascontiguousarray(mat, dtype=np.int32)
        arrays[f"cnt_{i}"] = np.ascontiguousarray(cnt, dtype=np.int64)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    raw = buf.getvalue()
    manifest: Dict[str, dict] = {}
    write_artifact_bytes(prefix + CHECKPOINT_NAME, [raw], CHECKPOINT_NAME,
                         manifest)
    write_manifest(prefix, manifest, fence=fence or None)
    return len(raw)


def checkpoint_available(prefix: str) -> bool:
    try:
        with _open_bytes(prefix + CHECKPOINT_NAME):
            return True
    except FileNotFoundError:
        return False


def load_checkpoint(prefix: str) -> Tuple[List[Level], Dict[str, int]]:
    """Load and validate ``<prefix>checkpoint.npz``: ``(levels, meta)``
    with meta keys ``n_raw``, ``min_count``, ``num_items`` (and
    ``fence`` when one was stamped).  The manifest is checked first; a
    mismatch there is most often a stale entry (a crash between the
    checkpoint's replace and the manifest's rewrite), so it is recorded
    as a ``checkpoint_manifest_stale`` ledger event and the npz's own
    structure decides: a truncated or corrupt archive raises InputError
    naming the file."""
    from fastapriori_tpu_torch.io.resume import validate_artifact_bytes

    path = prefix + CHECKPOINT_NAME
    try:
        with _open_bytes(path) as f:
            raw = f.read()
    except FileNotFoundError:
        raise InputError(
            f"checkpoint {path!r} not found — --resume-from mid-mine "
            "needs the checkpoint a --checkpoint-every-level run writes"
        ) from None
    try:
        validate_artifact_bytes(prefix, CHECKPOINT_NAME, raw)
    except InputError as e:
        from fastapriori_tpu_torch.reliability import ledger

        ledger.record("checkpoint_manifest_stale", path=path,
                      error=str(e)[:200])
    try:
        with np.load(io.BytesIO(raw)) as z:
            m = z["meta"]
            n_levels = int(m[0])
            meta = {"n_raw": int(m[1]), "min_count": int(m[2]),
                    "num_items": int(m[3])}
            # A 4-slot meta (no fence) stays loadable; 0 = unfenced.
            if m.shape[0] >= 5 and int(m[4]):
                meta["fence"] = int(m[4])
            levels = [(z[f"mat_{i}"], z[f"cnt_{i}"])
                      for i in range(n_levels)]
    except (KeyError, ValueError, OSError, zipfile.BadZipFile) as e:
        raise InputError(
            f"corrupt checkpoint {path!r}: {e} — re-run with "
            "--checkpoint-every-level to regenerate it"
        ) from None
    for i, (mat, cnt) in enumerate(levels):
        if mat.ndim != 2 or mat.shape[1] != i + 2 or cnt.shape != (
                mat.shape[0],):
            raise InputError(
                f"corrupt checkpoint {path!r}: level {i + 2} has shape "
                f"{mat.shape}/{cnt.shape} (expected [N, {i + 2}]/[N])"
            )
    # In a quorum domain a checkpoint whose fence (the larger of the meta
    # slot and the manifest's monotone copy) is older than the domain's
    # FENCE was written by a superseded writer: it must not seed a
    # resume.  Without a domain the fence is informational and the
    # manifest is not read again.
    from fastapriori_tpu_torch.reliability import quorum

    if quorum.active() is not None:
        from fastapriori_tpu_torch.io.resume import manifest_fence

        fences = [f for f in (meta.get("fence"), manifest_fence(prefix))
                  if f is not None]
        quorum.validate_resume_fence(max(fences) if fences else None)
    return levels, meta


def validate_checkpoint(prefix: str) -> Dict[str, int]:
    """The checkpoint under ``prefix`` through the full load path, plus
    a lattice check: every count at least ``min_count`` and every member
    a rank in ``[0, num_items)``.  Returns the meta; raises InputError
    naming the violation."""
    levels, meta = load_checkpoint(prefix)
    for i, (mat, cnt) in enumerate(levels):
        if cnt.size and int(cnt.min()) < meta["min_count"]:
            raise InputError(
                f"corrupt checkpoint under {prefix!r}: level {i + 2} "
                f"carries a count below min_count ({int(cnt.min())} < "
                f"{meta['min_count']})"
            )
        if mat.size and (int(mat.min()) < 0
                         or int(mat.max()) >= meta["num_items"]):
            raise InputError(
                f"corrupt checkpoint under {prefix!r}: level {i + 2} "
                f"references item ranks outside [0, {meta['num_items']})"
            )
    return meta


def check_meta(meta: Dict[str, int], *, n_raw: int, min_count: int,
               num_items: int, prefix: str) -> None:
    """Reject a checkpoint written for other data or support (the fence
    is the writer's identity, not the dataset's, and is left out)."""
    got = {"n_raw": n_raw, "min_count": min_count, "num_items": num_items}
    meta = {k: v for k, v in meta.items() if k in got}
    if meta != got:
        raise InputError(
            f"checkpoint under {prefix!r} was written for different "
            f"data/support (checkpoint {json.dumps(meta)}, current run "
            f"{json.dumps(got)}) — it cannot seed this mine"
        )
