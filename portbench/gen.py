"""The benchmark's own data generator: IBM Quest transactions (Agrawal and
Srikant, "Fast Algorithms for Mining Association Rules", VLDB 1994, section
2.4.3) and uniform user baskets, written as ``D.dat`` / ``U.dat`` bytes.

The structure of a corpus (the potentially large itemsets, the transaction
lengths, the itemsets each transaction draws) comes from the
configuration's fixed ``base_seed``, as the FIMI repository's files are
one fixed corpus each.  ``--seed`` then relabels the item ids by a
permutation and shuffles the order of the transactions and of the user
baskets.  So every seed gives the program the same amount of work in
another guise (the same itemset and rule counts under other names, other
rank ties, another dedup order), and runs with different seeds spread no
more than runs of one seed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def quest_itemsets(rng, n_items: int, n_patterns: int,
                   avg_pattern_len: float, correlation: float
                   ) -> List[np.ndarray]:
    """The |L| potentially large itemsets (0-based item ids): sizes
    Poisson of mean |I| (at least 1); the first itemset's items at
    random; each later one takes a fraction of its items, exponential of
    mean ``correlation``, from the itemset before it, the rest at
    random."""
    sizes = np.clip(rng.poisson(avg_pattern_len, n_patterns), 1, n_items)
    fracs = rng.exponential(correlation, n_patterns)
    out: List[np.ndarray] = []
    for i, s in enumerate(sizes.tolist()):
        n_old = 0 if not out else min(int(round(min(fracs[i], 1.0) * s)),
                                      out[-1].size)
        old = (rng.choice(out[-1], n_old, replace=False) if n_old
               else np.zeros(0, np.int64))
        fresh = rng.choice(n_items, s + n_old, replace=False)
        fresh = fresh[~np.isin(fresh, old)][:s - n_old]
        out.append(np.sort(np.concatenate([old, fresh])).astype(np.int64))
    return out


def _instances(rng, pats, weights, corrupt, n: int) -> List[tuple]:
    """``n`` itemsets picked by weight, each corrupted as it is added: items
    dropped while a uniform draw stays under the itemset's corruption
    level, the dropped ones at random.  Each as a tuple of item ids."""
    pick = rng.choice(len(pats), size=n, p=weights)
    width = max(p.size for p in pats)
    table = np.full((len(pats), width), -1, np.int64)
    for i, p in enumerate(pats):
        table[i, :p.size] = p
    size = (table >= 0).sum(axis=1)[pick]
    c = corrupt[pick]
    # Drops d with P(d >= j) = c ** j.
    u = rng.random(n)
    with np.errstate(divide="ignore"):
        d = np.where(c > 0, np.floor(np.log(u) / np.log(np.maximum(c, 1e-12))),
                     0)
    d = np.where(c >= 1, size, np.minimum(d, size)).astype(np.int64)
    items = table[pick]
    key = np.where(items >= 0, rng.random(items.shape), 2.0)
    rank = np.argsort(np.argsort(key, axis=1), axis=1)
    keep = rank < (size - d)[:, None]
    rows = np.repeat(np.arange(n), width)[keep.ravel()]
    flat = items.ravel()[keep.ravel()]
    bounds = np.searchsorted(rows, np.arange(n + 1))
    flat = flat.tolist()
    return [tuple(flat[bounds[i]:bounds[i + 1]]) for i in range(n)]


def quest_transactions(cfg: dict) -> Tuple[np.ndarray, np.ndarray]:
    """The configuration's base corpus: (flat 1-based item ids, row
    lengths).  Transaction lengths are Poisson of mean |T| (at least 1);
    each transaction takes corrupted itemsets by weight (exponential of
    unit mean, normalised) until it is full; an itemset that does not fit
    goes in anyway half the time and starts the next transaction the
    other half.  Corruption levels are normal of the configured mean and
    variance, clipped to [0, 1]."""
    n, n_items = int(cfg["n_txns"]), int(cfg["n_items"])
    n_pat = int(cfg["n_patterns"])
    rng = np.random.default_rng(int(cfg["base_seed"]))
    pats = quest_itemsets(rng, n_items, n_pat, float(cfg["avg_pattern_len"]),
                          float(cfg["correlation"]))
    weights = rng.exponential(1.0, n_pat)
    weights /= weights.sum()
    corrupt = np.clip(rng.normal(float(cfg["corruption_mean"]),
                                 float(cfg["corruption_var"]) ** 0.5, n_pat),
                      0.0, 1.0)
    target = np.maximum(1, rng.poisson(float(cfg["avg_txn_len"]), n)).tolist()
    coin = rng.random(n).tolist()
    batch = max(1024, 2 * n)
    inst, j = _instances(rng, pats, weights, corrupt, batch), 0
    flat: List[int] = []
    lens: List[int] = []
    carry = None
    for t in range(n):
        cur: set = set()
        want = target[t]
        while True:
            if carry is not None:
                add, carry = carry, None
            else:
                if j == len(inst):
                    inst, j = _instances(rng, pats, weights, corrupt,
                                         batch), 0
                add = inst[j]
                j += 1
            if not add:
                continue
            grown = cur.union(add)
            if len(grown) <= want or not cur:
                cur = grown
                if len(cur) >= want:
                    break
            elif coin[t] < 0.5:
                cur = grown
                break
            else:
                carry = add
                break
        row = sorted(cur)
        flat.extend(row)
        lens.append(len(row))
    return np.asarray(flat, np.int64) + 1, np.asarray(lens, np.int64)


def user_baskets(cfg: dict) -> Tuple[np.ndarray, np.ndarray]:
    """The configuration's base user baskets (``U.dat``): uniform items,
    exponential lengths, each a set."""
    rng = np.random.default_rng(int(cfg["user_base_seed"]))
    n_users, n_items = int(cfg["n_users"]), int(cfg["n_items"])
    avg = int(cfg["user_avg_len"])
    sizes = np.clip(rng.exponential(avg, n_users).astype(np.int64), 1,
                    min(3 * avg, n_items))
    rows = np.repeat(np.arange(n_users), sizes)
    flat = rng.integers(1, n_items + 1, size=int(sizes.sum()))
    key = rows * np.int64(n_items + 1) + flat
    _, first = np.unique(key, return_index=True)
    first.sort()
    rows, flat = rows[first], flat[first]
    return flat, np.bincount(rows, minlength=n_users)


def relabeling(n_items: int, seed: int) -> np.ndarray:
    """Old item id -> new item id (index 0 unused), from ``seed``."""
    perm = np.random.default_rng([int(seed), 1]).permutation(n_items) + 1
    return np.concatenate([[0], perm])


def shuffle_rows(flat: np.ndarray, lens: np.ndarray, relabel: np.ndarray,
                 seed: int, stream: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows in an order drawn from ``(seed, stream)``, items relabelled
    and sorted ascending within each row."""
    n = lens.shape[0]
    order = np.random.default_rng([int(seed), stream]).permutation(n)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    new_lens = lens[order]
    # Gather each row's items in the new order.
    idx = np.repeat(starts[order] - np.concatenate(
        [[0], np.cumsum(new_lens)[:-1]]), new_lens) + np.arange(
            int(new_lens.sum()))
    items = relabel[flat[idx]]
    rows = np.repeat(np.arange(n, dtype=np.int64), new_lens)
    key = rows * np.int64(relabel.shape[0]) + items
    key.sort()
    return key % np.int64(relabel.shape[0]), new_lens


def to_bytes(flat: np.ndarray, lens: np.ndarray) -> bytes:
    """``D.dat`` text: each row's ids joined by one space, one row a line,
    a newline after the last."""
    flat = np.asarray(flat, dtype=np.int64)
    if lens.size == 0 or np.any(lens <= 0) or flat.min() < 0:
        raise ValueError("rows must be non-empty and ids non-negative")
    width = len(str(int(flat.max())))
    digits = np.zeros((flat.size, width), dtype=np.uint8)
    ndig = np.ones(flat.size, dtype=np.int64)
    v = flat.copy()
    for d in range(width - 1, -1, -1):
        digits[:, d] = 48 + v % 10
        v //= 10
    for d in range(1, width):
        ndig += flat >= 10 ** d
    # Each token's digits, then its separator (space, or newline at the
    # end of a row).
    tok_len = ndig + 1
    start = np.concatenate([[0], np.cumsum(tok_len)[:-1]])
    out = np.empty(int(tok_len.sum()), dtype=np.uint8)
    for d in range(width):
        sel = ndig > d
        out[start[sel] + d] = digits[sel, width - ndig[sel] + d]
    sep = np.full(flat.size, 32, dtype=np.uint8)
    sep[np.cumsum(lens) - 1] = 10
    out[start + ndig] = sep
    return out.tobytes()


def make_inputs(cfg: dict, seed: int) -> dict:
    """The cell's inputs for ``seed``: ``D``/``U`` as (flat ids, row
    lengths) and as file bytes."""
    relabel = relabeling(int(cfg["n_items"]), seed)
    d_flat, d_lens = shuffle_rows(*quest_transactions(cfg),
                                  relabel, seed, 2)
    u_flat, u_lens = shuffle_rows(*user_baskets(cfg), relabel, seed, 3)
    return {"D": (d_flat, d_lens), "U": (u_flat, u_lens),
            "D.dat": to_bytes(d_flat, d_lens),
            "U.dat": to_bytes(u_flat, u_lens)}


def rows_as_tokens(flat: np.ndarray, lens: np.ndarray) -> List[List[str]]:
    """Rows as lists of item tokens (what a request carries)."""
    toks = flat.astype(str).tolist()
    out, pos = [], 0
    for n in lens.tolist():
        out.append(toks[pos:pos + n])
        pos += n
    return out
