"""Apriori candidate generation on the host (counterpart:
fastapriori_tpu/models/candidates.py ``gen_candidates``,
``gen_candidates_blocks``, ``gen_candidates_stream`` and
``gen_candidates_arrays``; reference C7,
FastApriori.scala:167-193).

Classic prefix join: two frequent (k-1)-sets sharing their first k-2
sorted elements join into ``c = x ∪ {y}`` (``x`` = c minus its largest
element, ``y = max(c)``), and the other k-2 subsets of ``c`` are checked
by a sorted-key lookup.  A pair ``(x, y)`` with ``y > max(x)`` survives
iff every (k-1)-subset of ``x ∪ {y}`` is frequent — the same set as the
reference's per-rank enumeration and hashed prune (:176-188).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np

Prefix = Tuple[int, ...]  # sorted ranks


def gen_candidates(
    k_items: Sequence[FrozenSet[int]], num_items: int
) -> List[Tuple[Prefix, List[int]]]:
    """The object form: ``(sorted prefix, sorted surviving extensions)``
    per prefix with at least one extension (:190).  ``num_items`` is
    unused, as in the JAX package: the join only extends by items
    already in some frequent set."""
    if not k_items:
        return []
    tuples = sorted(tuple(sorted(x)) for x in k_items)
    k_set = set(tuples)
    s = len(tuples[0])  # = k-1
    by_prefix: Dict[Prefix, List[Prefix]] = defaultdict(list)
    for t in tuples:
        by_prefix[t[:-1]].append(t)
    out: Dict[Prefix, List[int]] = defaultdict(list)
    for group in by_prefix.values():
        # Sorted by last element (the tuples were sorted globally).
        for i in range(len(group) - 1):
            x = group[i]
            for j in range(i + 1, len(group)):
                y = group[j][-1]
                c = x + (y,)
                # Dropping x's last element gives group[j] and dropping y
                # gives x: check the k-2 subsets that drop a prefix item.
                if all(c[:d] + c[d + 1:] in k_set for d in range(s - 1)):
                    out[x].append(y)
    return [(x, ys) for x, ys in out.items()]


def _encode_rows(a: np.ndarray) -> np.ndarray:
    """Encode int rows as fixed-width big-endian byte strings: memcmp
    order == lexicographic row order, so a lex-sorted matrix encodes to a
    sorted key array ready for ``np.searchsorted``."""
    a = np.ascontiguousarray(a.astype(">u4"))
    return a.view("S%d" % (4 * a.shape[1])).ravel()


def _keys_member(qk: np.ndarray, table_keys: np.ndarray) -> np.ndarray:
    pos = np.searchsorted(table_keys, qk)
    ok = pos < table_keys.shape[0]
    ok[ok] = table_keys[pos[ok]] == qk[ok]
    return ok


def gen_candidates_blocks(level: np.ndarray, pair_budget: int = 1 << 21):
    """Join + Apriori prune, vectorized, streamed in blocks of at most
    about ``pair_budget`` join pairs before the prune.

    ``level``: lex-sorted int32 ``[M, s]`` matrix of the frequent
    (k-1)-sets.  Yields ``(x_idx int64, y int32)`` blocks in global
    ``(x_idx, y)`` order: candidate ``i`` is ``level[x_idx[i]] ∪ {y[i]}``
    with ``y[i] > max(level[x_idx[i]])``.  Blocks cut on x-row boundaries
    (y rows may lie past the block: the lookup table is global)."""
    m, s = level.shape
    if m < 2:
        return
    # Rows are joinable when they share their first s-1 elements; the
    # matrix is lex-sorted, so each join group is a contiguous row range.
    if s == 1:
        group_of_row = np.zeros(m, dtype=np.int64)
        group_end = np.full(1, m, dtype=np.int64)
    else:
        new_group = np.any(level[1:, :-1] != level[:-1, :-1], axis=1)
        group_of_row = np.concatenate(
            [[0], np.cumsum(new_group)]
        ).astype(np.int64)
        group_end = np.zeros(int(group_of_row[-1]) + 1, dtype=np.int64)
        np.maximum.at(group_end, group_of_row, np.arange(m) + 1)
    # Pair (x, y_row) for every x < y_row inside a group: x repeats once
    # per later row of its group.
    reps = group_end[group_of_row] - np.arange(m) - 1
    cum = np.concatenate([[0], np.cumsum(reps)])  # [m+1]
    if cum[-1] == 0:
        return
    table_keys = _encode_rows(level)
    lo = 0
    while lo < m:
        hi = int(np.searchsorted(cum, cum[lo] + pair_budget, side="left"))
        hi = min(max(hi, lo + 1), m)
        yield _join_prune_rows(level, s, reps, cum, table_keys, lo, hi)
        lo = hi


def _join_prune_rows(level, s, reps, cum, table_keys, lo, hi):
    """Join + prune for the x rows in [lo, hi) against the whole table."""
    reps_blk = reps[lo:hi]
    total = int(cum[hi] - cum[lo])
    if total == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32)
    x_idx = np.repeat(np.arange(lo, hi, dtype=np.int64), reps_blk)
    offs = np.concatenate([[0], np.cumsum(reps_blk)[:-1]])
    y_row = x_idx + 1 + (np.arange(total) - offs[x_idx - lo])
    y = level[y_row, -1].astype(np.int32)

    # Apriori prune: every (k-1)-subset obtained by dropping one of the
    # shared-prefix positions must be frequent.  (Dropping y gives
    # level[x_idx]; dropping x's last element gives level[y_row] — both
    # frequent by construction.)
    ok = np.ones(total, dtype=bool)
    for d in range(s - 1):
        live = np.flatnonzero(ok)
        if live.size == 0:
            break
        xi = x_idx[live]
        sub = np.empty((live.size, s), dtype=level.dtype)
        sub[:, :d] = level[xi, :d]
        sub[:, d:s - 1] = level[xi, d + 1:]
        sub[:, s - 1] = y[live]
        ok[live] = _keys_member(_encode_rows(sub), table_keys)
    return x_idx[ok], y[ok]


def gen_candidates_stream(level: np.ndarray, pair_budget: int = 1 << 21):
    """The level loop's candidate stream: the native join + prune
    (csrc/preprocess.cc ``fa_gen_candidates``, an early-exit prune with
    narrowed search ranges) as one block when the native library is
    available, else the numpy blocks of :func:`gen_candidates_blocks`.
    The same candidates in the same global ``(x_idx, y)`` order either
    way; empty blocks are not yielded by the native path."""
    from fastapriori_tpu_torch.native import native_available

    if level.shape[0] >= 2 and native_available():
        from fastapriori_tpu_torch.native.loader import gen_candidates_native

        x_idx, y = gen_candidates_native(level)
        if x_idx.size:
            yield x_idx, y
        return
    yield from gen_candidates_blocks(level, pair_budget=pair_budget)


def concat_blocks(blocks) -> Tuple[np.ndarray, np.ndarray]:
    """The ``(x_idx, y)`` blocks of a stream as one pair of arrays."""
    xs, ys = [], []
    for x_idx, y in blocks:
        xs.append(x_idx)
        ys.append(y)
    if not xs:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32)
    return np.concatenate(xs), np.concatenate(ys)


def gen_candidates_arrays(
    level: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot form of :func:`gen_candidates_blocks`: the whole level's
    ``(x_idx int64[C], y int32[C])`` in global ``(x_idx, y)`` order."""
    return concat_blocks(gen_candidates_blocks(level, pair_budget=1 << 62))
