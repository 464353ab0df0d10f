"""Byte-exact, crash-safe output writers (counterpart:
fastapriori_tpu/io/writer.py; reference Utils.scala:29-49).

``<output>freqItemset``: itemset lines print ranks in descending order
mapped back to item strings, the whole file sorted lexicographically
(Utils.scala:36-39).  ``<output>recommends``: one item (or "0") per line
in original row order (Utils.scala:48).  Each is laid out whole, as one
chunk, by the native library (``fa_format_lines``), or by NumPy and
``list.sort`` when the library is unavailable: the same bytes.

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

import contextlib
import hashlib
import json
import os
from typing import (
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from fastapriori_tpu_torch.native import loader
from fastapriori_tpu_torch.obs import trace
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
    resume-side validation rejects.  Traced as a ``write`` span (args
    ``artifact``, ``bytes``; ``lines`` and ``formatter`` for the
    artifacts :func:`_laid_out` builds) that covers the chunks'
    formatting, with a ``fsync`` child from the flush to the rename.
    A chunk is any bytes-like object."""
    site = "write." + name
    with trace.span("write", artifact=name) as sp:
        failpoints.fire(site)
        trunc = failpoints.truncation(site)
        digest = hashlib.sha256()
        intended = written = 0
        local = "://" not in path
        tmp = path + ".tmp" if local else path
        f = _open_write_bytes(tmp)
        try:
            # The fsync span opens before the flush and closes after the
            # file's close and the rename.
            with contextlib.ExitStack() as durable:
                with f:
                    for chunk in chunks:
                        digest.update(chunk)
                        intended += len(chunk)
                        if trunc is not None:
                            chunk = chunk[: max(trunc - written, 0)]
                        if chunk:
                            f.write(chunk)
                            written += len(chunk)
                    sp.update(bytes=intended)
                    if local:
                        durable.enter_context(trace.span("fsync"))
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


def _text(lines: List[str]) -> bytes:
    """``lines`` as one UTF-8 chunk, each line ended by a newline."""
    return ("\n".join(lines) + "\n").encode("utf-8") if lines else b""


def _laid_out(build: Callable[[], Tuple[object, int, str]]) -> Iterator:
    """The artifact's one chunk, ``build()``'s bytes, built inside a
    ``write_format`` span (the layout before the first byte is written);
    the enclosing ``write`` span gets the ``lines`` and the ``formatter``
    (``native`` or ``python``) that ``build`` reports."""
    with trace.span("write_format"):
        data, lines, formatter = build()
    trace.annotate(lines=lines, formatter=formatter)
    yield data


def _itemset_text(levels, freq_items: Sequence[str],
                  with_counts: bool) -> Tuple[object, int, str]:
    """The itemset lines of ``levels`` (``[(ascending rank rows [N, k],
    counts [N]), ...]``, the 1-itemsets among them), sorted as Python
    sorts their strings, with ``[count]`` suffixes when ``with_counts``:
    ``(bytes, lines, formatter)``.  The native library lays them out
    whole when it loads (native/loader.py ``format_lines``, whose
    ``get_lib`` records ``native_unavailable`` when it does not); else
    NumPy joins each level's strings and ``list.sort`` orders them."""
    n = sum(len(mat) for mat, _ in levels)
    data = loader.format_lines(
        freq_items, [mat for mat, _ in levels],
        [cnts for _, cnts in levels] if with_counts else None, sort=True)
    if data is not None:
        return memoryview(data), n, "native"
    lines: List[str] = []
    for strings, cnts in _level_joined(levels, freq_items):
        if with_counts:
            strings = np.char.add(
                np.char.add(strings, "["),
                np.char.add(np.asarray(cnts).astype(np.str_), "]"))
        lines.extend(strings.tolist())
    lines.sort()
    return _text(lines), n, "python"


def _write_itemsets(path: str, name: str, levels, freq_items: Sequence[str],
                    with_counts: bool,
                    manifest: Optional[Dict[str, dict]]) -> str:
    return write_artifact_bytes(
        path,
        _laid_out(lambda: _itemset_text(levels, freq_items, with_counts)),
        name, manifest)


def _pair_levels(freq_itemsets: Sequence[Tuple[frozenset, int]]):
    """``(rank frozenset, count)`` pairs as level matrices, one per
    itemset size: ``[(ascending rank rows [N, k], counts [N]), ...]``."""
    by_k: Dict[int, Tuple[list, list]] = {}
    for s, c in freq_itemsets:
        rows, counts = by_k.setdefault(len(s), ([], []))
        rows.append(sorted(s))
        counts.append(c)
    return [(np.array(rows, dtype=np.int32).reshape(len(rows), k),
             np.array(counts, dtype=np.int64))
            for k, (rows, counts) in by_k.items()]


def save_freq_itemsets(
    output_prefix: str,
    freq_itemsets: Sequence[Tuple[frozenset, int]],
    freq_items: Sequence[str],
    manifest: Optional[Dict[str, dict]] = None,
) -> str:
    """Write ``<output>freqItemset`` (Utils.scala:29-41) from ``(rank
    frozenset, count)`` pairs, lines sorted lexicographically."""
    return _write_itemsets(output_prefix + "freqItemset", "freqItemset",
                           _pair_levels(freq_itemsets), freq_items, False,
                           manifest)


def save_freq_itemsets_with_count(
    output_prefix: str,
    freq_itemsets: Sequence[Tuple[frozenset, int]],
    freq_items: Sequence[str],
    manifest: Optional[Dict[str, dict]] = None,
) -> str:
    """Write ``<output>freqItems`` with counts as ``...[count]``
    (Utils.scala:51-63) from ``(rank frozenset, count)`` pairs."""
    return _write_itemsets(output_prefix + "freqItems", "freqItems",
                           _pair_levels(freq_itemsets), freq_items, True,
                           manifest)


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
    ones = np.arange(len(freq_items), dtype=np.int32)[:, None]
    levels = [(ones, item_counts), *levels]
    path = output_prefix + "freqItemset"
    _write_itemsets(path, "freqItemset", levels, freq_items, False, manifest)
    if with_counts_path:
        _write_itemsets(output_prefix + "freqItems", "freqItems", levels,
                        freq_items, True, manifest)
    return path


def save_recommends(
    output_prefix: str,
    recommends: Sequence[Tuple[int, str]],
    manifest: Optional[Dict[str, dict]] = None,
) -> str:
    """Write ``<output>recommends``: sorted by original row index, one
    recommended item (or "0") per line (Utils.scala:43-49)."""

    def build() -> Tuple[object, int, str]:
        rows, items = zip(*recommends) if recommends else ((), ())
        order = np.argsort(np.asarray(rows, dtype=np.int64), kind="stable")
        data = loader.format_lines(items, [order[:, None]])
        if data is not None:
            return memoryview(data), len(items), "native"
        return _text(list(map(items.__getitem__, order.tolist()))), \
            len(items), "python"

    path = output_prefix + "recommends"
    return write_artifact_bytes(path, _laid_out(build), "recommends",
                                manifest)
