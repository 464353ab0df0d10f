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
``<prefix>MANIFEST.json``, which io/resume.py validates artifacts
against.  The failpoint site ``write.<name>`` can fail a write or
truncate its physical bytes (reliability/failpoints.py).  A remote
prefix (``gs://``, ``memory://`` ...) goes through fsspec, imported only
for such a path (no tmp + rename: object stores commit on close).  The
manifest's ``fence`` is the quorum domain's fence epoch
(reliability/quorum.py ``writer_fence``), stamped by the writer rank of
a file domain and monotone under merge; a run without a domain stamps
none.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from fastapriori_tpu_torch.reliability import failpoints

MANIFEST_NAME = "MANIFEST.json"


def _open_write(path: str, mode: str):
    if "://" in path:
        from fastapriori_tpu_torch.io.reader import _require_fsspec

        return _require_fsspec(path).open(path, mode).open()
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    return open(path, mode)


def _open_write_bytes(path: str):
    return _open_write(path, "wb")


def open_write(path: str):
    """A raw text handle on ``path`` (fsspec for a remote URL).  Prefer
    :func:`write_artifact` for run artifacts: this handle is not atomic,
    records no manifest entry and fires no failpoint."""
    return _open_write(path, "w")


def write_artifact_bytes(
    path: str,
    chunks: Iterable[bytes],
    name: str,
    manifest: Optional[Dict[str, dict]] = None,
) -> str:
    """Crash-safe write of ``path``: locally ``<path>.tmp``, fsync and an
    atomic ``os.replace``; remote paths stream.  The failpoint site
    ``write.<name>`` may raise or truncate the physical bytes at byte N;
    the manifest entry ``manifest[name]`` records the full intended
    content (size and sha256), so a truncation is exactly what
    resume-side validation rejects."""
    site = "write." + name
    failpoints.fire(site)
    trunc = failpoints.truncation(site)
    digest = hashlib.sha256()
    intended = written = 0
    local = "://" not in path
    tmp = path + ".tmp" if local else path
    f = _open_write_bytes(tmp)
    try:
        with f:
            for chunk in chunks:
                digest.update(chunk)
                intended += len(chunk)
                if trunc is not None:
                    chunk = chunk[: max(trunc - written, 0)]
                if chunk:
                    f.write(chunk)
                    written += len(chunk)
            if local:
                f.flush()
                os.fsync(f.fileno())
        if local:
            os.replace(tmp, path)
    except BaseException:
        if local and os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if manifest is not None:
        manifest[name] = {"bytes": intended, "sha256": digest.hexdigest()}
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


def write_manifest(
    prefix: str, entries: Dict[str, dict], fence: Optional[int] = None
) -> str:
    """Persist ``<prefix>MANIFEST.json``, merged over any manifest already
    at the prefix (phase 1 and phase 2 write at different times).  The
    manifest is the last write, so a crash between an artifact and its
    entry leaves a manifest that still validates what it lists.
    ``fence``: a writer's fence epoch, stamped as a top-level field that
    a merge never lowers (None without a quorum domain)."""
    from fastapriori_tpu_torch.io.reader import _open_bytes

    path = prefix + MANIFEST_NAME
    merged: Dict[str, dict] = {}
    prev_fence: Optional[int] = None
    try:
        with _open_bytes(path) as f:
            prev = json.loads(f.read().decode("utf-8"))
        artifacts = prev.get("artifacts", {})
        if isinstance(artifacts, dict):
            merged.update(artifacts)
        if isinstance(prev.get("fence"), int):
            prev_fence = prev["fence"]
    except (OSError, ValueError, UnicodeDecodeError, AttributeError):
        pass  # absent or corrupt old manifest: superseded by the rewrite
    merged.update(entries)
    doc: Dict[str, object] = {"version": 1, "artifacts": merged}
    fences = [f for f in (fence, prev_fence) if f is not None]
    if fences:
        doc["fence"] = max(fences)
    body = json.dumps(doc, indent=2, sort_keys=True)
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


def format_itemset_line(ranks: Iterable[int],
                        freq_items: Sequence[str]) -> str:
    """One itemset: ranks sorted descending, mapped to item strings,
    joined by a single space (Utils.scala:38)."""
    return " ".join(freq_items[r] for r in sorted(ranks, reverse=True))


def save_freq_itemsets(
    output_prefix: str,
    freq_itemsets: Sequence[Tuple[frozenset, int]],
    freq_items: Sequence[str],
    manifest: Optional[Dict[str, dict]] = None,
) -> str:
    """Write ``<output>freqItemset`` (Utils.scala:29-41) from ``(rank
    frozenset, count)`` pairs, lines sorted lexicographically."""
    lines = [format_itemset_line(s, freq_items) for s, _ in freq_itemsets]
    lines.sort()
    return write_artifact(
        output_prefix + "freqItemset", (line + "\n" for line in lines),
        "freqItemset", manifest,
    )


def save_freq_itemsets_with_count(
    output_prefix: str,
    freq_itemsets: Sequence[Tuple[frozenset, int]],
    freq_items: Sequence[str],
    manifest: Optional[Dict[str, dict]] = None,
) -> str:
    """Write ``<output>freqItems`` with counts as ``...[count]``
    (Utils.scala:51-63) from ``(rank frozenset, count)`` pairs."""
    lines = [format_itemset_line(s, freq_items) + "[" + str(c) + "]"
             for s, c in freq_itemsets]
    lines.sort()
    return write_artifact(
        output_prefix + "freqItems", (line + "\n" for line in lines),
        "freqItems", manifest,
    )


def save_freq_itemsets_levels(
    output_prefix: str,
    levels,
    freq_items: Sequence[str],
    manifest: Optional[Dict[str, dict]] = None,
    item_counts=None,
    with_counts_path: bool = False,
) -> str:
    """Write ``<output>freqItemset`` from the level matrices plus the
    1-itemsets (every rank), lines sorted lexicographically.
    ``with_counts_path`` (the CLI's ``--save-counts``): also
    ``<output>freqItems``, the same itemsets with ``[count]`` suffixes
    (the 1-itemsets' from ``item_counts``), the phase-1 resume
    artifact."""
    lines: list = []
    clines: list = []
    for joined, cnts in _level_joined(levels, freq_items):
        lines.extend(joined.tolist())
        if with_counts_path:
            clines.extend(np.char.add(
                np.char.add(joined, "["),
                np.char.add(np.asarray(cnts).astype(np.str_), "]"),
            ).tolist())
    lines.extend(freq_items)
    lines.sort()
    path = output_prefix + "freqItemset"
    write_artifact(
        path, (line + "\n" for line in lines), "freqItemset", manifest
    )
    if with_counts_path:
        clines.extend(f"{tok}[{int(c)}]"
                      for tok, c in zip(freq_items, np.asarray(item_counts)))
        clines.sort()
        write_artifact(output_prefix + "freqItems",
                       (line + "\n" for line in clines), "freqItems",
                       manifest)
    return path


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
