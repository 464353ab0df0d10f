"""Apriori candidate generation on the host (counterpart:
fastapriori_tpu/models/candidates.py ``gen_candidates_arrays``; reference
C7, FastApriori.scala:167-193).

Classic prefix join: two frequent (k-1)-sets sharing their first k-2
sorted elements join into ``c = x ∪ {y}`` (``x`` = c minus its largest
element, ``y = max(c)``), and the other k-2 subsets of ``c`` are checked
by a sorted-key lookup.  A pair ``(x, y)`` with ``y > max(x)`` survives
iff every (k-1)-subset of ``x ∪ {y}`` is frequent — the same set as the
reference's per-rank enumeration and hashed prune (:176-188).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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


def gen_candidates_arrays(
    level: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Join + Apriori prune of a whole level.

    ``level``: lex-sorted int32 ``[M, s]`` matrix of the frequent
    (k-1)-sets.  Returns ``(x_idx int64[C], y int32[C])`` in global
    ``(x_idx, y)`` order: candidate ``i`` is ``level[x_idx[i]] ∪ {y[i]}``
    with ``y[i] > max(level[x_idx[i]])``."""
    empty = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32))
    m, s = level.shape
    if m < 2:
        return empty
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
    # Pair (x, y_row) for every x < y_row inside a group.
    reps = group_end[group_of_row] - np.arange(m) - 1
    total = int(reps.sum())
    if total == 0:
        return empty
    x_idx = np.repeat(np.arange(m, dtype=np.int64), reps)
    offs = np.concatenate([[0], np.cumsum(reps)[:-1]])
    y_row = x_idx + 1 + (np.arange(total) - offs[x_idx])
    y = level[y_row, -1].astype(np.int32)

    # Apriori prune: every (k-1)-subset obtained by dropping one of the
    # shared-prefix positions must be frequent.  (Dropping y gives
    # level[x_idx]; dropping x's last element gives level[y_row] — both
    # frequent by construction.)
    table_keys = _encode_rows(level)
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
