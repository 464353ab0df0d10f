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

A multi-process world ingests sharded (:func:`preprocess_file_sharded`,
natively): each process reads its own line-aligned byte range of
``D.dat`` (:func:`read_shard`), the small count tables cross the
processes (parallel/mesh.py ``allgather_bytes``), and each process keeps
its own baskets against the global ranks (:class:`ShardInfo`).
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
class ShardInfo:
    """Present when a :class:`CompressedData` holds one process's shard
    of the transactions (:func:`preprocess_file_sharded`): the basket CSR
    covers this process's byte range of ``D.dat`` only, while every
    table (n_raw, min_count, freq_items, item_counts) is global.
    Identical baskets of two shards stay two rows with their own
    multiplicities; the weighted counts are the same."""

    process_id: int
    num_processes: int
    local_counts: List[int]  # distinct baskets of each process
    max_weight: int  # the global largest multiplicity

    @property
    def global_count(self) -> int:
        return sum(self.local_counts)


@dataclasses.dataclass
class CompressedData:
    """Output of phase-1 preprocessing.  Basket ``i`` spans
    ``basket_indices[basket_offsets[i]:basket_offsets[i+1]]``; ``shard``
    is set on a process's shard of a sharded ingest."""

    n_raw: int  # raw transaction count N (FastApriori.scala:38)
    min_count: int  # ceil(minSupport * N)   (FastApriori.scala:39)
    freq_items: List[str]  # rank -> item string
    item_to_rank: Dict[str, int]
    item_counts: np.ndarray  # int64[F] occurrence counts by rank
    basket_indices: np.ndarray  # int32[nnz] flattened sorted ranks
    basket_offsets: np.ndarray  # int64[T'+1]
    weights: np.ndarray  # int32[T'] multiplicities
    shard: Optional[ShardInfo] = None

    @property
    def num_items(self) -> int:
        return len(self.freq_items)

    @property
    def total_count(self) -> int:  # T' (FastApriori.scala:79)
        return len(self.weights)

    @property
    def baskets(self) -> List[np.ndarray]:
        """Ragged view (one rank array per basket); prefer the CSR
        fields."""
        if self.total_count > 0 and len(self.basket_offsets) != (
            self.total_count + 1
        ):
            raise InputError(
                "CompressedData carries no basket CSR (produced by the "
                "pipelined capture ingest with retain_csr=False); "
                "re-ingest with retain_csr=True to read baskets"
            )
        return [
            self.basket_indices[self.basket_offsets[i]:
                                self.basket_offsets[i + 1]]
            for i in range(self.total_count)
        ]


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
    """Host threads of the native block ingest (its ``n_threads``): the
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


def shard_byte_range(size: int, idx: int, n: int) -> Tuple[int, int]:
    """The nominal byte range of shard ``idx`` of ``n``; :func:`read_shard`
    moves its start past the line that straddles it (shard 0 starts at 0)
    and reads through the end of the line straddling its end, so every
    line lands in exactly one shard."""
    return (size * idx) // n, (size * (idx + 1)) // n


def split_buffer_ranges(data: bytes, n: int) -> List[Tuple[int, int]]:
    """``n`` line-aligned byte ranges of an in-memory buffer, by the
    alignment rule of :func:`read_shard` (a range starts past the line
    that straddles its nominal start, which the previous range owns), so
    that the ranges cover every line once."""
    size = len(data)
    cuts = [0]
    for i in range(1, n):
        b = (size * i) // n
        prev = cuts[-1]
        if b <= prev:
            cuts.append(prev)
            continue
        if data[b - 1 : b] == b"\n":
            cuts.append(b)
        else:
            j = data.find(b"\n", b)
            cuts.append(size if j < 0 else j + 1)
    cuts.append(size)
    return list(zip(cuts[:-1], cuts[1:]))


def _open_ranged(path: str):
    """``(binary file handle, size)``: through fsspec for a URL, so that a
    process reads only its own range of a remote ``D.dat``."""
    if "://" in path:
        from fastapriori_tpu_torch.io.reader import _require_fsspec

        fs, rpath = _require_fsspec(path).core.url_to_fs(path)
        return fs.open(rpath, "rb"), fs.size(rpath)
    return open(path, "rb"), os.path.getsize(path)


def read_shard(path: str, idx: int, n: int) -> bytes:
    """The lines of shard ``idx`` of ``n`` (:func:`shard_byte_range`)."""
    fh, size = _open_ranged(path)
    lo, hi = shard_byte_range(size, idx, n)
    with fh:
        if lo > 0:
            # Past the partial line the previous shard owns.
            fh.seek(lo - 1)
            if fh.read(1) != b"\n":
                fh.readline()
            lo = fh.tell()
        else:
            fh.seek(0)
        data = fh.read(max(hi - lo, 0))
        if not data:
            return b""
        # Through the end of the line that straddles the end.
        if not data.endswith(b"\n"):
            data += fh.readline()
        return data


def preprocess_file_sharded(
    path: str,
    min_support: float,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    allgather=None,
) -> CompressedData:
    """Phase-1 preprocessing of this process's shard of ``D.dat`` against
    the globally merged item counts (counterpart: the JAX package's
    ``preprocess_file_sharded``).  Every process of the world calls it;
    the result holds the global tables, this process's baskets and a
    :class:`ShardInfo`.  ``process_id``, ``num_processes`` and
    ``allgather`` (one bytes blob per process in, the list in process
    order out) default to the live world (parallel/mesh.py); tests
    inject their own.  The count tables cross the processes pickled:
    only this program's processes write them."""
    import pickle

    from fastapriori_tpu_torch.native.loader import (
        compress_with_ranks,
        count_buffer,
    )

    if allgather is None or process_id is None or num_processes is None:
        from fastapriori_tpu_torch.parallel import mesh

        allgather = allgather or mesh.allgather_bytes
        if process_id is None or num_processes is None:
            process_id = mesh.process_index()
            num_processes = mesh.process_count()
    data = read_shard(path, process_id, num_processes)
    n_lines, tokens, counts = count_buffer(data)
    blobs = allgather(pickle.dumps((n_lines, tokens, counts), protocol=4))
    if len(blobs) != num_processes:
        raise InputError(f"the sharded ingest's exchange returned "
                         f"{len(blobs)} tables for {num_processes} processes")
    merged: Dict[str, int] = {}
    n_raw = 0
    for blob in blobs:
        nl, toks, cnts = pickle.loads(blob)
        n_raw += nl
        for tok, c in zip(toks, cnts.tolist()):
            merged[tok] = merged.get(tok, 0) + c
    min_count = math.ceil(min_support * n_raw)
    freq = [(t, c) for t, c in merged.items() if c >= min_count]
    freq.sort(key=item_sort_key)
    freq_items = [t for t, _ in freq]
    item_counts = np.array([c for _, c in freq], dtype=np.int64)
    _, indices, offsets, weights = compress_with_ranks(data, freq_items)
    local = pickle.dumps(
        (len(weights), int(weights.max()) if len(weights) else 1),
        protocol=4)
    local_counts: List[int] = []
    max_w = 1
    for blob in allgather(local):
        t_loc, w_loc = pickle.loads(blob)
        local_counts.append(t_loc)
        max_w = max(max_w, w_loc)
    return CompressedData(
        n_raw=n_raw,
        min_count=min_count,
        freq_items=freq_items,
        item_to_rank={item: r for r, item in enumerate(freq_items)},
        item_counts=item_counts,
        basket_indices=indices,
        basket_offsets=offsets,
        weights=weights,
        shard=ShardInfo(process_id=process_id, num_processes=num_processes,
                        local_counts=local_counts, max_weight=max_w),
    )


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
