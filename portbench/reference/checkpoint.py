"""The reference's side of a per-level checkpoint, in plain NumPy: what a
durable checkpoint of a mine must hold, a reader of the file, and a cut
of it to its first levels.

The format is the port's documented one (``io/checkpoint.py``): one npz
with ``meta`` = int64 ``[n_levels, n_raw, min_count, num_items, fence]``
and per level i (k = i + 2) ``mat_<i>``, int32 ``[N, k]``, each row the
itemset's ascending ranks in the job's item table and the rows in
lexicographic order, and ``cnt_<i>``, int64 ``[N]``, the exact supports.
A job's item table is its frequent items by rank, as the job reports
them; the ranks in a checkpoint mean nothing without it.

It imports nothing but NumPy, and reads and writes files by path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Level = Tuple[np.ndarray, np.ndarray]


def expected_meta(mined) -> Dict[str, int]:
    """The meta a checkpoint of ``mined`` (reference/apriori.py ``Mined``)
    carries: the raw transaction count, the min count, the number of
    frequent items."""
    return {"n_raw": int(mined.n_txns), "min_count": int(mined.min_count),
            "num_items": int(mined.n_freq)}


def expected_levels(mined, item_table: Sequence) -> Optional[List[Level]]:
    """The reference's levels 2..L in the id space of ``item_table`` (the
    job's frequent items by rank, integer ids or their strings): each row
    the ascending ranks of its items, the rows lexicographic, the supports
    int64.  None where the table is not a ranking of the reference's
    frequent items."""
    table = np.array([int(x) for x in item_table], dtype=np.int64)
    if table.shape != mined.items.shape or not np.array_equal(
            np.sort(table), np.sort(mined.items)):
        return None
    rank = np.full(int(table.max(initial=0)) + 1, -1, np.int64)
    rank[table] = np.arange(table.shape[0])
    out = []
    for rows, cnt in mined.levels:
        mat = np.sort(rank[mined.items[rows]], axis=1)
        order = np.lexsort(mat.T[::-1])
        out.append((mat[order].astype(np.int32),
                    np.asarray(cnt, dtype=np.int64)[order]))
    return out


def read(path: str) -> Tuple[List[Level], Dict[str, int]]:
    """The checkpoint at ``path``: its levels and meta, read with
    ``np.load``; ValueError for arrays other than the format's."""
    with np.load(path, allow_pickle=False) as z:
        m = z["meta"]
        n = int(m[0])
        meta = {"n_raw": int(m[1]), "min_count": int(m[2]),
                "num_items": int(m[3]),
                "fence": int(m[4]) if m.shape[0] >= 5 else 0}
        levels = [(z[f"mat_{i}"], z[f"cnt_{i}"]) for i in range(n)]
        extra = set(z.files) - {"meta"} - {
            f"{p}_{i}" for p in ("mat", "cnt") for i in range(n)}
    if extra:
        raise ValueError(f"not a checkpoint: extra arrays {sorted(extra)}")
    return levels, meta


def matches(path: str, mined, item_table: Sequence) -> bool:
    """The checkpoint at ``path`` holds exactly the reference's levels
    2..L through ``item_table``, with int32 members and int64 supports,
    and the reference's meta (fence 0: one process)."""
    want = expected_levels(mined, item_table)
    if want is None:
        return False
    try:
        levels, meta = read(path)
    except Exception:  # a file np.load cannot read holds no levels
        return False
    if meta != dict(expected_meta(mined), fence=0) or len(levels) != len(
            want):
        return False
    return all(
        mat.dtype == np.int32 and cnt.dtype == np.int64
        and np.array_equal(mat, wm) and np.array_equal(cnt, wc)
        for (mat, cnt), (wm, wc) in zip(levels, want))


def cut(path: str, n_levels: int, out_path: str) -> None:
    """The checkpoint at ``path`` cut to its first ``n_levels`` levels and
    written to ``out_path`` in the same format, as an interrupted job
    would have left it."""
    levels, meta = read(path)
    if not 1 <= n_levels <= len(levels):
        raise ValueError(f"cannot cut {len(levels)} levels to {n_levels}")
    arrays = {"meta": np.array(
        [n_levels, meta["n_raw"], meta["min_count"], meta["num_items"],
         meta["fence"]], dtype=np.int64)}
    for i, (mat, cnt) in enumerate(levels[:n_levels]):
        arrays[f"mat_{i}"] = np.ascontiguousarray(mat, dtype=np.int32)
        arrays[f"cnt_{i}"] = np.ascontiguousarray(cnt, dtype=np.int64)
    with open(out_path, "wb") as f:
        np.savez(f, **arrays)
