"""The port's host rule engine (fastapriori_tpu_torch/rules/gen.py
``_rule_arrays_host``, which finds every antecedent row by one integer
key per itemset) against the JAX package's host engine (packed or
structured row keys): the same survivor arrays, array for array, with
bitwise-equal float64 confidences, over random downward-closed tables
at narrow and wide item axes, rows in any order and 1-itemset tables
that do or do not hold every rank; and the same "not downward-closed"
InputError when a subset is missing."""

import itertools

import numpy as np
import pytest

from fastapriori_tpu.rules import gen as jgen
from fastapriori_tpu_torch import InputError
from fastapriori_tpu_torch.rules import gen as tgen


def _closed_tables(seed, f, n_max, max_len, shuffle, every_rank,
                   deep=0):
    """Size-grouped tables of the downward closure of ``n_max`` random
    itemsets of 2..``max_len`` ranks below ``f`` (plus one of ``deep``
    ranks when given), each with a random weight; an itemset's count is
    the weight of the sets holding it, so counts fall with size and
    confidences tie.  ``shuffle`` permutes each table's rows;
    ``every_rank`` gives the 1-itemset table every rank in order (the
    CLI's form) instead of the ranks that occur (the object form's)."""
    rng = np.random.default_rng(seed)
    # Forty ranks spread over the whole axis, the top rank f - 1 among
    # them and in the first set, so a wide f keeps small closures but
    # large ranks.
    pool = np.append(rng.choice(f - 1, size=39, replace=False), f - 1)
    counts = {}
    sizes = list(rng.integers(2, max_len + 1, size=n_max))
    if deep:
        sizes.append(deep)
    for i, size in enumerate(sizes):
        pick = rng.choice(39, size=size, replace=False)
        if i == 0:
            pick[0] = 39
        top = tuple(sorted(pool[pick].tolist()))
        w = int(rng.integers(1, 50))
        for r in range(1, size + 1):
            for sub in itertools.combinations(top, r):
                counts[sub] = counts.get(sub, 0) + w
    by_len = {}
    for s, c in counts.items():
        by_len.setdefault(len(s), []).append((s, c))
    mats = {}
    for k, rows in by_len.items():
        rows.sort()
        mat = np.array([s for s, _ in rows], dtype=np.int32).reshape(-1, k)
        cnts = np.array([c for _, c in rows], dtype=np.int64)
        if shuffle:
            perm = rng.permutation(len(rows))
            mat, cnts = mat[perm], cnts[perm]
        mats[k] = (mat, cnts)
    if every_rank:
        ones = np.full(f, 1, dtype=np.int64)
        ones[mats[1][0][:, 0]] = mats[1][1]
        mats[1] = (np.arange(f, dtype=np.int32)[:, None], ones)
    return mats


CASES = {
    # f <= 256: the JAX engine packs 8-bit ranks into one uint64.
    "narrow": dict(seed=1, f=60, n_max=12, max_len=6, shuffle=False,
                   every_rank=True),
    "narrow_shuffled": dict(seed=2, f=256, n_max=12, max_len=7,
                            shuffle=True, every_rank=False),
    # 257 <= f <= 65,536 at width >= 6: the JAX engine's structured
    # fallback (T20's f = 1,467).
    "wide": dict(seed=3, f=1467, n_max=14, max_len=8, shuffle=False,
                 every_rank=True),
    "wide_shuffled": dict(seed=4, f=40_000, n_max=14, max_len=8,
                          shuffle=True, every_rank=False),
    "wide_65536": dict(seed=5, f=65_536, n_max=10, max_len=7, shuffle=True,
                       every_rank=True),
    # f > 65,536: 32-bit ranks in the JAX engine.
    "wider": dict(seed=6, f=70_001, n_max=10, max_len=6, shuffle=True,
                  every_rank=False),
    # One itemset of 11 ranks tops the lattice (T20's level 11 has one).
    "single_deep": dict(seed=7, f=1467, n_max=6, max_len=4, shuffle=True,
                        every_rank=True, deep=11),
}


def _tables(name):
    if name == "ones_only":
        return {1: (np.array([[3], [0], [7]], dtype=np.int32),
                    np.array([5, 9, 2], dtype=np.int64))}
    return _closed_tables(**CASES[name])


@pytest.mark.parametrize("name", sorted(CASES) + ["ones_only"])
def test_host_engine_matches_the_jax_host_engine(name):
    mats = _tables(name)
    if name == "single_deep":
        assert len(mats[11][0]) == 1
    if name != "ones_only":
        assert 1 + max(int(m.max()) for m, _ in mats.values()) == (
            CASES[name]["f"])
    got = tgen._rule_arrays_host(mats)
    want = jgen._rule_arrays_host(mats)
    assert len(got) == len(want)
    if name == "ones_only":
        assert got == []
    else:
        assert sum(len(c) for _, c, _ in got) > 0
    for (ga, gc, gf), (wa, wc, wf) in zip(got, want):
        for g, w in ((ga, wa), (gc, wc), (gf, wf)):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w)


def _lattice():
    """The closure of {1, 2, 3} and {5, 6, 7, 8} with every rank up to 8
    as a 1-itemset."""
    counts = {}
    for top in ((1, 2, 3), (5, 6, 7, 8)):
        for r in range(1, len(top) + 1):
            for sub in itertools.combinations(top, r):
                counts[sub] = counts.get(sub, 0) + 4
    mats = {}
    for k in (2, 3, 4):
        rows = sorted(s for s in counts if len(s) == k)
        mats[k] = (np.array(rows, dtype=np.int32),
                   np.array([counts[s] for s in rows], dtype=np.int64))
    ones = np.array([counts.get((r,), 1) for r in range(9)], dtype=np.int64)
    mats[1] = (np.arange(9, dtype=np.int32)[:, None], ones)
    return mats


def _drop(mats, k, row):
    mat, cnts = mats[k]
    keep = ~np.all(mat == np.asarray(row, dtype=np.int32), axis=1)
    assert keep.sum() == len(keep) - 1
    out = dict(mats)
    out[k] = (mat[keep], cnts[keep])
    return out


@pytest.mark.parametrize("case,k,row,named", [
    # (1, 3) is the antecedent of (1, 2, 3) without its middle column and
    # the prefix of no 3-itemset.
    ("middle", 2, (1, 3), r"\[1, 3\]"),
    # (1, 2) is the prefix of (1, 2, 3).
    ("prefix", 2, (1, 2), r"\[1, 2\]"),
    # Rank 3 has no 1-itemset: (1, 3) and (2, 3) lose an antecedent.
    ("one", 1, (3,), r"\[3\]"),
])
def test_missing_subset_raises_not_downward_closed(case, k, row, named):
    mats = _lattice()
    assert tgen._rule_arrays_host(mats)
    torn = _drop(mats, k, row)
    with pytest.raises(InputError, match="not downward-closed: " + named):
        tgen._rule_arrays_host(torn)
    # The JAX package's engine refuses the same table.
    with pytest.raises(Exception, match="not downward-closed"):
        jgen._rule_arrays_host(torn)
