"""Host-side preprocessing: frequent-item discovery and transaction
compression (counterpart: fastapriori_tpu/preprocess.py; reference
components C3/C4/C10, FastApriori.scala:52-85 and
AssociationRules.scala:33-64).

Produces the miner's whole input:

- ``freq_items``: item strings sorted by descending occurrence count
  (rank 0 = most frequent, ties by utils/order.py);
- ``item_counts``: occurrence counts by rank.  Occurrences, not
  transaction support: the reference counts ``flatMap(_.map((_,1)))``
  (FastApriori.scala:55), so duplicates within a line each count;
- deduplicated baskets with multiplicity weights in CSR form: per
  transaction keep the frequent items, map them to ranks, drop baskets of
  size <= 1, and merge identical baskets into one weighted row.

Two engines give the same arrays: the native C++ scanner
(csrc/preprocess.cc through native/loader.py, one pass over the raw
bytes), taken whenever its library is available (:func:`_use_native`),
and the Python path (:func:`_python_preprocess`).
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.io.reader import JAVA_WS, read_dat
from fastapriori_tpu_torch.utils.env import env_int
from fastapriori_tpu_torch.utils.order import item_sort_key

# In-memory token lists take the native path from this many lines on
# (below it, re-serializing them costs more than the scan saves).
NATIVE_MIN_LINES = 50_000


@dataclasses.dataclass
class CompressedData:
    """Output of phase-1 preprocessing.  Basket ``i`` spans
    ``basket_indices[basket_offsets[i]:basket_offsets[i+1]]``."""

    n_raw: int  # raw transaction count N (FastApriori.scala:38)
    min_count: int  # ceil(minSupport * N)   (FastApriori.scala:39)
    freq_items: List[str]  # rank -> item string
    item_to_rank: Dict[str, int]
    item_counts: np.ndarray  # int64[F] occurrence counts by rank
    basket_indices: np.ndarray  # int32[nnz] flattened sorted ranks
    basket_offsets: np.ndarray  # int64[T'+1]
    weights: np.ndarray  # int32[T'] multiplicities

    @property
    def num_items(self) -> int:
        return len(self.freq_items)

    @property
    def total_count(self) -> int:  # T' (FastApriori.scala:79)
        return len(self.weights)


def count_item_occurrences(
    transactions: Sequence[Sequence[str]],
) -> Counter:
    """C3 first half (FastApriori.scala:55-56): global occurrence counts."""
    counts: Counter = Counter()
    for t in transactions:
        counts.update(t)
    return counts


def build_rank_map(
    counts: Counter, min_count: int
) -> Tuple[List[str], Dict[str, int], np.ndarray]:
    """C3 second half (FastApriori.scala:57-62): threshold, sort by
    descending count (deterministic tie-break), dense ranks."""
    freq = [(i, c) for i, c in counts.items() if c >= min_count]
    freq.sort(key=item_sort_key)
    freq_items = [i for i, _ in freq]
    item_counts = np.asarray([c for _, c in freq], dtype=np.int64)
    item_to_rank = {item: r for r, item in enumerate(freq_items)}
    return freq_items, item_to_rank, item_counts


def dedup_baskets(
    transactions: Sequence[Sequence[str]],
    item_to_rank: Dict[str, int],
    min_size: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """C4 (FastApriori.scala:66-79): filter to frequent items, rank-map,
    ``toSet`` dedupe within a line, drop baskets smaller than ``min_size``,
    merge identical baskets with multiplicity.  Returns CSR
    ``(indices, offsets, weights)`` with baskets in first-seen order."""
    mult: Dict[Tuple[int, ...], int] = {}
    for t in transactions:
        ranks = {item_to_rank[i] for i in t if i in item_to_rank}
        if len(ranks) < min_size:
            continue
        key = tuple(sorted(ranks))
        mult[key] = mult.get(key, 0) + 1
    offsets = np.zeros(len(mult) + 1, dtype=np.int64)
    sizes = [len(k) for k in mult.keys()]
    offsets[1:] = np.cumsum(sizes, dtype=np.int64) if sizes else 0
    indices = (
        np.concatenate([np.asarray(k, dtype=np.int32) for k in mult.keys()])
        if mult
        else np.empty(0, dtype=np.int32)
    )
    weights = np.fromiter(mult.values(), dtype=np.int32, count=len(mult))
    return indices, offsets, weights


def _python_preprocess(
    transactions: Sequence[Sequence[str]], min_support: float
) -> CompressedData:
    n_raw = len(transactions)
    min_count = int(math.ceil(min_support * n_raw))
    counts = count_item_occurrences(transactions)
    freq_items, item_to_rank, item_counts = build_rank_map(counts, min_count)
    indices, offsets, weights = dedup_baskets(transactions, item_to_rank)
    return CompressedData(
        n_raw=n_raw,
        min_count=min_count,
        freq_items=freq_items,
        item_to_rank=item_to_rank,
        item_counts=item_counts,
        basket_indices=indices,
        basket_offsets=offsets,
        weights=weights,
    )


def _native_result_to_data(result) -> CompressedData:
    n_raw, min_count, freq_items, item_counts, indices, offsets, weights = (
        result
    )
    return CompressedData(
        n_raw=n_raw,
        min_count=min_count,
        freq_items=freq_items,
        item_to_rank={item: r for r, item in enumerate(freq_items)},
        item_counts=item_counts,
        basket_indices=indices,
        basket_offsets=offsets,
        weights=weights,
    )


def native_choice(
    native: Optional[bool], size_hint: int
) -> Tuple[bool, Optional[str]]:
    """The ingest engine: ``(use_native, reason)``, the reason being why
    not when ``use_native`` is false.  ``native``: False forbids the
    native path, True requires it (InputError when the library is
    unavailable), None takes it when the library is available and the
    input has at least :data:`NATIVE_MIN_LINES` lines (``size_hint``)."""
    if native is False:
        return False, "forced off"
    from fastapriori_tpu_torch.native import unavailable_reason

    reason = unavailable_reason()
    if native is True:
        if reason is not None:
            raise InputError(
                f"native preprocessing requested but the library is "
                f"unavailable: {reason}"
            )
        return True, None
    if reason is not None:
        return False, reason
    if size_hint < NATIVE_MIN_LINES:
        return False, f"below the gate ({size_hint} < {NATIVE_MIN_LINES} lines)"
    return True, None


def _use_native(native: Optional[bool], size_hint: int) -> bool:
    return native_choice(native, size_hint)[0]


def ingest_thread_count(configured: Optional[int]) -> int:
    """Host threads for the arena build's reduce pass (and the
    ``n_threads`` of the native block ingest): the
    ``FA_INGEST_THREADS`` environment variable (strictly parsed: a value
    that is not a positive integer is an InputError) over the config,
    over one thread per core."""
    n = env_int("FA_INGEST_THREADS", 0, minimum=1)
    if n:
        return n
    if configured:
        return configured
    return os.cpu_count() or 1


def preprocess(
    transactions: Sequence[Sequence[str]],
    min_support: float,
    native: Optional[bool] = None,
) -> CompressedData:
    """Full phase-1 preprocessing (genFreqItems, FastApriori.scala:46-86)
    from already-tokenized lines.

    ``native``: force (True) or forbid (False) the C++ path; None takes
    it when the library is available and the input is large.  Lines
    whose tokens would not survive re-serialization take the Python path
    either way (:func:`_tokens_serialize_exactly`)."""
    if _use_native(native, len(transactions)) and _tokens_serialize_exactly(
        transactions
    ):
        from fastapriori_tpu_torch.native.loader import (
            join_transactions,
            preprocess_buffer,
        )

        return _native_result_to_data(
            preprocess_buffer(join_transactions(transactions), min_support)
        )
    return _python_preprocess(transactions, min_support)


def _tokens_serialize_exactly(transactions) -> bool:
    """True iff re-serializing the token lists for the native byte
    scanner round-trips exactly: a token whose first or last char is
    <= 0x20 (e.g. a bare "\\x01" token from a "7 \\x01 8" line) would be
    eaten by the scanner's Java trim at a line edge or glued to a
    neighbour, and a token holding Java \\s anywhere (only possible
    through the API, since the tokenizer splits on \\s) would be re-split
    into other items.  Interior control chars that are not Java \\s are
    safe.  An empty token is safe only as a line's sole token (the
    empty-line form, which serializes to an empty line); a zero-token
    line has no serialized form at all.  Such input takes the Python
    path; file input is scanned as raw bytes and never re-serialized."""
    return all(
        (len(line) == 1 and line[0] == "")
        or (
            bool(line)
            and all(
                t
                and t[0] > "\x20"
                and t[-1] > "\x20"
                and JAVA_WS.isdisjoint(t)
                for t in line
            )
        )
        for line in transactions
    )


def preprocess_file(
    path: str, min_support: float, native: Optional[bool] = None
) -> CompressedData:
    """Phase-1 preprocessing straight from a ``D.dat`` file: the native
    path parses the raw bytes without building Python token lists (the
    reference's ingest and first shuffle, Utils.scala:21 +
    FastApriori.scala:52-85, as one C++ scan); a file always passes the
    size gate."""
    if _use_native(native, 1 << 62):
        from fastapriori_tpu_torch.native.loader import (
            preprocess_file as native_file,
        )

        return _native_result_to_data(native_file(path, min_support))
    return _python_preprocess(read_dat(path), min_support)


def dedup_user_baskets(
    user_lines: Sequence[Sequence[str]], item_to_rank: Dict[str, int]
) -> Tuple[List[np.ndarray], List[List[int]], List[int]]:
    """C10 (AssociationRules.scala:33-64): filter users to frequent items,
    dedupe identical baskets keeping the original row indexes per distinct
    basket; empty baskets are returned separately (they recommend "0",
    AssociationRules.scala:49).

    Returns (distinct baskets, per-basket original row-index lists,
    empty-row indexes)."""
    index_map: Dict[Tuple[int, ...], List[int]] = {}
    order: List[Tuple[int, ...]] = []
    empty: List[int] = []
    for idx, line in enumerate(user_lines):
        ranks = {item_to_rank[i] for i in line if i in item_to_rank}
        if not ranks:
            empty.append(idx)
            continue
        key = tuple(sorted(ranks))
        if key in index_map:
            index_map[key].append(idx)
        else:
            index_map[key] = [idx]
            order.append(key)
    baskets = [np.asarray(k, dtype=np.int32) for k in order]
    indexes = [index_map[k] for k in order]
    return baskets, indexes, empty
