"""Synthetic transaction datasets in the style of the IBM Quest generator
(counterpart: fastapriori_tpu/utils/datagen.py ``generate_transactions``,
``generate_doc_transactions`` and ``generate_user_baskets``).

A numpy-only copy, so that a machine without JAX can make the same data:
for the same arguments it returns the same lines, line for line.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


def _make_patterns(rng, n_items, n_patterns, avg_pattern_len):
    """Pattern pool as a padded int matrix + normalized pick weights."""
    sizes = np.maximum(
        1, rng.exponential(avg_pattern_len, n_patterns).astype(np.int64)
    )
    sizes = np.minimum(sizes, min(3 * avg_pattern_len, n_items))
    pat = np.zeros((n_patterns, int(sizes.max())), dtype=np.int64)
    for i, s in enumerate(sizes):
        pat[i, :s] = rng.choice(n_items, size=int(s), replace=False) + 1
    weights = rng.exponential(1.0, n_patterns)
    weights /= weights.sum()
    # Expected frequent items contributed per weighted pattern draw.
    yield_per_draw = float((sizes * weights).sum())
    return pat, weights, yield_per_draw


def _txn_block(rng, pat, weights, yield_per_draw, targets, n_items,
               corruption):
    """One block of transactions as sorted unique item rows: returns
    (flat 1-based item ids, items per transaction)."""
    n = targets.shape[0]
    keep_rate = max(1e-3, 1.0 - corruption)
    npat = np.ceil(
        targets / max(yield_per_draw * keep_rate, 1e-3)
    ).astype(np.int64) + 1
    draws = rng.choice(pat.shape[0], size=int(npat.sum()), p=weights)
    row_of_draw = np.repeat(np.arange(n), npat)
    items = pat[draws]  # (total_draws, max_pat_len), 0 = padding
    keep = (items > 0) & (rng.random(items.shape) >= corruption)
    rows = np.repeat(row_of_draw, items.shape[1])[keep.ravel()]
    flat = items.ravel()[keep.ravel()]

    # Uniform noise injection so the infrequent tail exists.
    n_noise = max(1, int(0.1 * n))
    noise_rows = rng.integers(0, n, size=n_noise)
    noise_items = rng.integers(1, n_items + 1, size=n_noise)
    rows = np.concatenate([rows, noise_rows])
    flat = np.concatenate([flat, noise_items])

    # Dedupe within each transaction, then truncate each to its target
    # length, dropping uniformly at random (random key sort).
    key = rows * np.int64(n_items + 1) + flat
    _, first = np.unique(key, return_index=True)
    rows, flat = rows[first], flat[first]
    order = np.lexsort((rng.random(rows.shape[0]), rows))
    rows, flat = rows[order], flat[order]
    counts = np.bincount(rows, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(rows.shape[0]) - starts[rows]
    sel = rank < targets[rows]
    rows, flat = rows[sel], flat[sel]
    # Guarantee non-empty rows (corruption can empty a txn): give any
    # empty transaction one uniform item.
    counts = np.bincount(rows, minlength=n)
    empty = np.flatnonzero(counts == 0)
    if empty.size:
        rows = np.concatenate([rows, empty])
        flat = np.concatenate(
            [flat, rng.integers(1, n_items + 1, size=empty.size)]
        )
    order = np.lexsort((flat, rows))
    return flat[order], np.bincount(rows, minlength=n)


_TOK_CACHE: dict = {}


def _token_table(n_items: int):
    """item id -> str, computed once per distinct vocabulary size."""
    tab = _TOK_CACHE.get(n_items)
    if tab is None:
        tab = np.array([str(i) for i in range(n_items + 1)], dtype=object)
        _TOK_CACHE[n_items] = tab
    return tab


def _format_rows(flat, counts, n_items) -> List[str]:
    """Vectorized int->str (cached table lookup) then per-row join."""
    toks = _token_table(n_items)[flat]
    out = []
    pos = 0
    for c in counts:
        out.append(" ".join(toks[pos:pos + int(c)]))
        pos += int(c)
    return out


def iter_transaction_blocks(
    n_txns: int = 100_000,
    n_items: int = 1000,
    avg_txn_len: int = 10,
    n_patterns: int = 100,
    avg_pattern_len: int = 4,
    corruption: float = 0.25,
    seed: int = 2017,
    block: int = 100_000,
) -> Iterator[List[str]]:
    """Stream transaction lines in blocks (bounded memory)."""
    rng = np.random.default_rng(seed)
    pat, weights, ypd = _make_patterns(
        rng, n_items, n_patterns, avg_pattern_len
    )
    done = 0
    while done < n_txns:
        n = min(block, n_txns - done)
        targets = np.clip(
            rng.exponential(avg_txn_len, n).astype(np.int64),
            1,
            min(3 * avg_txn_len, n_items),
        )
        flat, counts = _txn_block(
            rng, pat, weights, ypd, targets, n_items, corruption
        )
        yield _format_rows(flat, counts, n_items)
        done += n


def generate_transactions(
    n_txns: int = 100_000,
    n_items: int = 1000,
    avg_txn_len: int = 10,
    n_patterns: int = 100,
    avg_pattern_len: int = 4,
    corruption: float = 0.25,
    seed: int = 2017,
) -> List[str]:
    """Return raw transaction lines (space-separated 1-based item ids)."""
    lines: List[str] = []
    for blk in iter_transaction_blocks(
        n_txns, n_items, avg_txn_len, n_patterns, avg_pattern_len,
        corruption, seed,
    ):
        lines.extend(blk)
    return lines


def _doc_block(rng, p_cum, pat, pat_w_cum, targets, pattern_frac, n_items):
    """One block of doc-style transactions: independent zipf draws plus a
    fraction of tokens contributed by planted head-item patterns."""
    n = targets.shape[0]
    n_zipf = np.maximum(1, (targets * (1.0 - pattern_frac)).astype(np.int64))
    rows_z = np.repeat(np.arange(n), n_zipf)
    # Clip: float error can leave p_cum[-1] a hair below 1.0, and a draw
    # above it would index past the vocabulary.
    flat_z = np.minimum(
        np.searchsorted(p_cum, rng.random(rows_z.shape[0]), side="right"),
        n_items - 1,
    ) + 1
    # Pattern overlay: each txn picks a couple of patterns whose items are
    # all drawn from the popularity head, planting real correlations.
    npat = np.maximum(
        1, (targets * pattern_frac / max(pat.shape[1], 1)).astype(np.int64)
    )
    row_of_draw = np.repeat(np.arange(n), npat)
    draws = np.searchsorted(
        pat_w_cum, rng.random(row_of_draw.shape[0]), side="right"
    )
    items = pat[draws]
    rows_p = np.repeat(row_of_draw, items.shape[1])
    flat_p = items.ravel()
    keep = flat_p > 0
    rows = np.concatenate([rows_z, rows_p[keep]])
    flat = np.concatenate([flat_z, flat_p[keep]])
    # Dedupe within each transaction: the key orders (row, item), so one
    # stable sort both groups the rows and orders the items in each.
    key = rows * np.int64(n_items + 1) + flat
    key.sort(kind="stable")
    first = np.empty(key.shape[0], dtype=bool)
    first[0] = True
    np.not_equal(key[1:], key[:-1], out=first[1:])
    key = key[first]
    rows, flat = np.divmod(key, np.int64(n_items + 1))
    return flat, np.bincount(rows, minlength=n)


def iter_doc_transaction_blocks(
    n_txns: int = 1_700_000,
    n_items: int = 50_000,
    avg_txn_len: int = 177,
    zipf_s: float = 1.05,
    zipf_shift: float = 12.0,
    n_patterns: int = 60,
    avg_pattern_len: int = 4,
    pattern_frac: float = 0.15,
    head_items: int = 400,
    seed: int = 2017,
    block: int = 100_000,
) -> Iterator[List[str]]:
    """Doc-corpus-style transactions in blocks: item marginals follow a
    shifted zipf law (the number of items above any support threshold
    decays smoothly), with planted patterns over the popularity head for
    real multi-item correlations."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(n_items, dtype=np.float64)
    p = 1.0 / np.power(ranks + zipf_shift, zipf_s)
    p /= p.sum()
    p_cum = np.cumsum(p)
    sizes = np.clip(
        np.maximum(1, rng.exponential(avg_pattern_len, n_patterns)),
        2, 8,
    ).astype(np.int64)
    pat = np.zeros((n_patterns, int(sizes.max())), dtype=np.int64)
    for i, s in enumerate(sizes):
        pat[i, :s] = rng.choice(
            min(head_items, n_items), size=int(s), replace=False
        ) + 1
    pat_w = rng.exponential(1.0, n_patterns)
    pat_w_cum = np.cumsum(pat_w / pat_w.sum())

    done = 0
    while done < n_txns:
        n = min(block, n_txns - done)
        targets = np.clip(
            rng.exponential(avg_txn_len, n).astype(np.int64),
            1,
            min(3 * avg_txn_len, n_items),
        )
        flat, counts = _doc_block(
            rng, p_cum, pat, pat_w_cum, targets, pattern_frac, n_items
        )
        yield _format_rows(flat, counts, n_items)
        done += n


def generate_doc_transactions(**kw) -> List[str]:
    """Materialized form of :func:`iter_doc_transaction_blocks`."""
    lines: List[str] = []
    for blk in iter_doc_transaction_blocks(**kw):
        lines.extend(blk)
    return lines


def generate_user_baskets(
    n_users: int = 10_000,
    n_items: int = 1000,
    avg_len: int = 5,
    seed: int = 2018,
) -> List[str]:
    """User baskets for the recommendation phase (U.dat analog)."""
    rng = np.random.default_rng(seed)
    sizes = np.clip(
        rng.exponential(avg_len, n_users).astype(np.int64),
        1,
        min(3 * avg_len, n_items),
    )
    rows = np.repeat(np.arange(n_users), sizes)
    flat = rng.integers(1, n_items + 1, size=int(sizes.sum()))
    key = rows * np.int64(n_items + 1) + flat
    _, first = np.unique(key, return_index=True)
    rows, flat = rows[np.sort(first)], flat[np.sort(first)]
    counts = np.bincount(rows, minlength=n_users)
    # Unique-ing can only shrink rows, never empty them (sizes >= 1).
    return _format_rows(flat, counts, n_items)
