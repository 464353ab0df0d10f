"""Phase-1 save and resume (counterpart: fastapriori_tpu/io/resume.py;
reference C14, Utils.scala:51-81) with manifest-backed validation.

A ``--save-counts`` run writes ``<prefix>freqItems`` (the itemsets with
``[count]`` suffixes), ``<prefix>FreqItems`` (one item per line) and
``<prefix>ItemsToRank`` ("item rank" per line); ``--resume-from`` reads
them back (:func:`load_phase1`) and runs the recommend phase alone.

Every artifact read is first checked against ``<prefix>MANIFEST.json``
(size and sha256 of the intended content): a truncated or modified
artifact raises :class:`InputError` naming the file instead of parsing
into a smaller lattice.  A missing manifest skips the check.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.io.reader import (
    _open,
    _open_bytes,
    split_lines_java,
)
from fastapriori_tpu_torch.io.writer import (
    MANIFEST_NAME,
    save_freq_itemsets_with_count,
    write_artifact,
    write_manifest,
)

ItemsetWithCount = Tuple[FrozenSet[int], int]


def save_phase1(
    prefix: str,
    freq_itemsets: Sequence[ItemsetWithCount],
    freq_items: Sequence[str],
    item_to_rank: Dict[str, int],
) -> None:
    """Write the three phase-1 artifacts and the run manifest, stamped
    with the quorum writer's fence."""
    from fastapriori_tpu_torch.reliability import quorum

    manifest: Dict[str, dict] = {}
    save_freq_itemsets_with_count(prefix, freq_itemsets, freq_items,
                                  manifest=manifest)
    save_phase1_aux(prefix, freq_items, item_to_rank, manifest=manifest)
    write_manifest(prefix, manifest, fence=quorum.writer_fence())


def save_phase1_aux(
    prefix: str,
    freq_items: Sequence[str],
    item_to_rank: Dict[str, int],
    manifest: Optional[Dict[str, dict]] = None,
) -> None:
    """The two small phase-1 artifacts (FreqItems, ItemsToRank)."""
    write_artifact(prefix + "FreqItems",
                   (item + "\n" for item in freq_items), "FreqItems",
                   manifest)
    write_artifact(prefix + "ItemsToRank",
                   (f"{item} {rank}\n" for item, rank in item_to_rank.items()),
                   "ItemsToRank", manifest)


def load_manifest(prefix: str) -> Optional[Dict[str, dict]]:
    """The artifact table of ``<prefix>MANIFEST.json``, or None when
    there is no manifest.  A manifest that cannot be parsed is an
    InputError: unreadable integrity data must not turn checking off."""
    path = prefix + MANIFEST_NAME
    try:
        with _open_bytes(path) as f:
            raw = f.read()
    except FileNotFoundError:
        return None
    try:
        artifacts = json.loads(raw.decode("utf-8"))["artifacts"]
        if not isinstance(artifacts, dict):
            raise ValueError("artifacts is not an object")
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
        raise InputError(
            f"corrupt run manifest {path!r}: {e} — delete it to skip "
            "integrity validation, or re-run the producing step"
        ) from None
    return artifacts


def manifest_fence(prefix: str) -> Optional[int]:
    """The fence epoch recorded in ``<prefix>MANIFEST.json``, or None
    (no manifest, no fence, or unparsable: :func:`load_manifest` owns
    the loud contract)."""
    try:
        with _open_bytes(prefix + MANIFEST_NAME) as f:
            fence = json.loads(f.read().decode("utf-8")).get("fence")
        return fence if isinstance(fence, int) else None
    except (OSError, ValueError, UnicodeDecodeError, AttributeError):
        return None


def validate_artifact_bytes(
    prefix: str,
    name: str,
    raw: bytes,
    manifest: Optional[Dict[str, dict]] = None,
) -> None:
    """Check ``raw``, the content of ``<prefix><name>``, against the run
    manifest; InputError naming the file on a mismatch.  No-op without a
    manifest or without an entry for ``name``."""
    artifacts = load_manifest(prefix) if manifest is None else manifest
    entry = (artifacts or {}).get(name)
    if entry is None:
        return
    if len(raw) != entry.get("bytes"):
        raise InputError(
            f"artifact {prefix + name!r} fails manifest validation: "
            f"expected {entry.get('bytes')} bytes, found {len(raw)} — the "
            "file is truncated or was modified after the run wrote it; "
            "re-run the producing step"
        )
    if hashlib.sha256(raw).hexdigest() != entry.get("sha256"):
        raise InputError(
            f"artifact {prefix + name!r} fails manifest validation: "
            "content checksum mismatch — the file was modified or "
            "corrupted after the run wrote it; re-run the producing step"
        )


def _read_artifact(prefix: str, name: str) -> List[str]:
    path = prefix + name
    try:
        with _open_bytes(path) as f:
            raw = f.read()
    except FileNotFoundError:
        raise InputError(
            f"resume artifact {path!r} not found — --resume-from needs the "
            "three files a --save-counts run writes (freqItems, FreqItems, "
            "ItemsToRank) under the given prefix"
        ) from None
    validate_artifact_bytes(prefix, name, raw)
    return split_lines_java(raw.decode("utf-8"))


def phase1_available(prefix: str) -> bool:
    """True when the phase-1 artifact set exists under ``prefix`` (probe:
    the freqItems table; the other two are written after it)."""
    try:
        with _open(prefix + "freqItems"):
            return True
    except FileNotFoundError:
        return False


def load_phase1(
    prefix: str,
) -> Tuple[List[ItemsetWithCount], Dict[str, int], List[str]]:
    """``(freqItemsets, itemToRank, freqItems)`` from the saved artifacts
    (Utils.getAll, Utils.scala:65-81): items sorted by rank, itemset
    lines split at the last ``[``.  A malformed line raises InputError
    naming the file and line.  In a quorum domain, artifacts whose
    manifest fence a newer writer superseded raise ``StaleFenceError``."""
    from fastapriori_tpu_torch.reliability import quorum

    if quorum.active() is not None:
        quorum.validate_resume_fence(manifest_fence(prefix))
    item_to_rank: Dict[str, int] = {}
    for lineno, line in enumerate(_read_artifact(prefix, "ItemsToRank"), 1):
        if not line:
            continue
        try:
            item, rank = line.split(" ")
            item_to_rank[item] = int(rank)
        except ValueError:
            raise InputError(
                f"malformed resume artifact {prefix + 'ItemsToRank'!r} "
                f"line {lineno}: expected '<item> <rank>', got {line!r}"
            ) from None
    freq_items = [x for x in _read_artifact(prefix, "FreqItems") if x != ""]
    try:
        freq_items.sort(key=lambda i: item_to_rank[i])
    except KeyError as e:
        raise InputError(
            f"resume artifacts disagree: item {e.args[0]!r} appears in "
            f"{prefix + 'FreqItems'!r} but not in "
            f"{prefix + 'ItemsToRank'!r} — the artifacts are from "
            "different runs or were edited"
        ) from None
    freq_itemsets: List[ItemsetWithCount] = []
    for lineno, line in enumerate(_read_artifact(prefix, "freqItems"), 1):
        if not line:
            continue
        # "<item> <item> ...[count]"; the [count] suffix is required.
        body, sep, cnt = line.rpartition("[")
        try:
            if not sep or not cnt.endswith("]"):
                raise ValueError
            count = int(cnt[:-1])
            freq_itemsets.append(
                (frozenset(item_to_rank[i] for i in body.split(" ")), count))
        except (ValueError, KeyError):
            raise InputError(
                f"malformed resume artifact {prefix + 'freqItems'!r} "
                f"line {lineno}: expected '<item> <item> ...[count]' with "
                f"items from ItemsToRank, got {line!r}"
            ) from None
    return freq_itemsets, item_to_rank, freq_items


def phase1_levels(
    freq_itemsets: Sequence[ItemsetWithCount], num_items: int
) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], np.ndarray]:
    """The miner's matrix form of loaded phase-1 itemsets: ``(levels,
    item_counts)`` with levels ``[(int32 [N, k] lex-sorted, int64 [N]),
    ...]`` for k = 2, 3, ... and the 1-itemsets' counts per rank, which
    is what the recommender reads."""
    item_counts = np.zeros(num_items, dtype=np.int64)
    by_k: Dict[int, list] = {}
    for items, count in freq_itemsets:
        if len(items) == 1:
            item_counts[next(iter(items))] = count
        else:
            by_k.setdefault(len(items), []).append((sorted(items), count))
    levels = []
    for k in range(2, max(by_k, default=1) + 1):
        rows = sorted(by_k.get(k, []))
        mat = np.array([r for r, _ in rows], dtype=np.int32).reshape(-1, k)
        cnt = np.array([c for _, c in rows], dtype=np.int64)
        levels.append((mat, cnt))
    return levels, item_counts
