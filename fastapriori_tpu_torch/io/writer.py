"""Byte-exact, crash-safe output writers (counterpart:
fastapriori_tpu/io/writer.py; reference Utils.scala:29-49).

``<output>freqItemset``: itemset lines print ranks in descending order
mapped back to item strings, the whole file sorted lexicographically
(Utils.scala:36-39).  ``<output>recommends``: one item (or "0") per line
in original row order (Utils.scala:48).

Every artifact goes through :func:`write_artifact_bytes`: a ``.tmp``
file, fsync, then an atomic rename, so a crash mid-write never leaves a
torn file under the final name; each write records its size and sha256
into a manifest dict that :func:`write_manifest` persists as
``<prefix>MANIFEST.json``.  Local paths only; no quorum fence (the port
runs one process).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

MANIFEST_NAME = "MANIFEST.json"


def write_artifact_bytes(
    path: str,
    chunks: Iterable[bytes],
    name: str,
    manifest: Optional[Dict[str, dict]] = None,
) -> str:
    """Atomic write of ``path``; records ``manifest[name]`` (size and
    sha256 of the content) when a manifest dict is given."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    digest = hashlib.sha256()
    size = 0
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            for chunk in chunks:
                digest.update(chunk)
                size += len(chunk)
                f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if manifest is not None:
        manifest[name] = {"bytes": size, "sha256": digest.hexdigest()}
    return path


def write_artifact(
    path: str,
    lines: Iterable[str],
    name: str,
    manifest: Optional[Dict[str, dict]] = None,
) -> str:
    """Text form of :func:`write_artifact_bytes` (utf-8)."""
    return write_artifact_bytes(
        path, (line.encode("utf-8") for line in lines), name, manifest
    )


def write_manifest(prefix: str, entries: Dict[str, dict]) -> str:
    """Persist ``<prefix>MANIFEST.json``, merged over any manifest already
    at the prefix (phase 1 and phase 2 write at different times).  The
    manifest is the last write, so a crash between an artifact and its
    entry leaves a manifest that still validates what it lists."""
    path = prefix + MANIFEST_NAME
    merged: Dict[str, dict] = {}
    try:
        with open(path, "rb") as f:
            prev = json.loads(f.read().decode("utf-8"))
        artifacts = prev.get("artifacts", {})
        if isinstance(artifacts, dict):
            merged.update(artifacts)
    except (OSError, ValueError, UnicodeDecodeError, AttributeError):
        pass  # absent or corrupt old manifest: superseded by the rewrite
    merged.update(entries)
    body = json.dumps({"version": 1, "artifacts": merged}, indent=2,
                      sort_keys=True)
    return write_artifact(path, [body + "\n"], MANIFEST_NAME)


def _level_joined(levels, freq_items: Sequence[str]):
    """Format level matrices (lex-sorted int32 [N, k] with counts) into
    per-level joined string arrays.  Members print in descending rank
    order (Utils.scala:38 ``sortBy(-_)``): rows are ascending, so the
    reversed row is the print order."""
    items_arr = np.asarray(freq_items, dtype=np.str_)
    for mat, cnts in levels:
        toks = items_arr[mat[:, ::-1]]  # [N, k] descending-rank strings
        joined = toks[:, 0]
        for j in range(1, toks.shape[1]):
            joined = np.char.add(np.char.add(joined, " "), toks[:, j])
        yield joined, cnts


def save_freq_itemsets_levels(
    output_prefix: str,
    levels,
    freq_items: Sequence[str],
    manifest: Optional[Dict[str, dict]] = None,
) -> str:
    """Write ``<output>freqItemset`` from the level matrices plus the
    1-itemsets (every rank), lines sorted lexicographically."""
    lines: list = []
    for joined, _ in _level_joined(levels, freq_items):
        lines.extend(joined.tolist())
    lines.extend(freq_items)
    lines.sort()
    path = output_prefix + "freqItemset"
    return write_artifact(
        path, (line + "\n" for line in lines), "freqItemset", manifest
    )


def save_recommends(
    output_prefix: str,
    recommends: Sequence[Tuple[int, str]],
    manifest: Optional[Dict[str, dict]] = None,
) -> str:
    """Write ``<output>recommends``: sorted by original row index, one
    recommended item (or "0") per line (Utils.scala:43-49)."""
    path = output_prefix + "recommends"
    return write_artifact(
        path,
        (item + "\n" for _, item in sorted(recommends, key=lambda x: x[0])),
        "recommends",
        manifest,
    )
