"""The port's two kernels, through their plain PyTorch versions, against
the JAX package's Pallas kernels in interpret mode (exact equality: every
output is an integer count or rank).

- K1: fastapriori_tpu_torch/ops/level_kernel.py vs
  fastapriori_tpu/ops/pallas_level.py ``level_counts_pallas``;
- K2: fastapriori_tpu_torch/ops/match_kernel.py vs
  fastapriori_tpu/ops/pallas_vertical.py ``strided_best_rank_pallas`` at
  one shard.

The CUDA kernels themselves only run on a GPU (chip_smoke.py); on CPU
tensors each wrapper runs its plain version and launches nothing.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastapriori_tpu.ops.pallas_level import level_counts_pallas
from fastapriori_tpu.ops.pallas_vertical import strided_best_rank_pallas
from fastapriori_tpu_torch.ops import level_kernel
from fastapriori_tpu_torch.ops.level_kernel import (
    level_counts,
    level_counts_plain,
)
from fastapriori_tpu_torch.ops import match_kernel
from fastapriori_tpu_torch.ops.match_kernel import (
    GROUP,
    NO_MATCH,
    RULE_TILE,
    check_limits,
    first_match,
    first_match_plain,
    work_plan,
)
from test_pallas import M_TILE, T_TILE, _case, _expected


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("k", [2, 3, 5])
def test_level_counts_matches_pallas_interpret(k):
    bitmap, w, wb, s = _case(0, T_TILE * 2, M_TILE, 256, k)
    want = np.asarray(
        level_counts_pallas(
            jnp.asarray(bitmap), jnp.asarray(wb), jnp.asarray(s),
            jnp.int32(k - 1), t_tile=T_TILE, m_tile=M_TILE, interpret=True,
        )
    )
    got = level_counts_plain(_t(bitmap), _t(wb), _t(s), k - 1).numpy()
    assert got.dtype == np.int32
    assert (got == want).all()
    assert (got == _expected(bitmap, w, s, k)).all()


def test_level_counts_ragged_shape():
    # Neither T, M nor F is a tile multiple (the TPU wrapper asserted it).
    bitmap, w, wb, s = _case(4, 1001, 77, 200, 4)
    got = level_counts(_t(bitmap), _t(wb), _t(s), 3).numpy()
    assert (got == _expected(bitmap, w, s, 4)).all()


def test_level_counts_wide_prefix():
    # k-1 >= 128: beyond the int8 membership bound of the JAX engine.
    rng = np.random.default_rng(9)
    t, m, f, k1 = 300, 20, 256, 130
    bitmap = (rng.random((t, f)) < 0.5).astype(np.int8)
    bitmap[::7] = 1  # dense rows hold every wide prefix
    s = np.zeros((m, f), dtype=np.int8)
    for i in range(m - 2):
        s[i, rng.choice(f, size=k1, replace=False)] = 1
    w = rng.integers(1, 128, size=t).astype(np.int64)
    wb = (bitmap * w[:, None]).astype(np.int8)
    got = level_counts(_t(bitmap), _t(wb), _t(s), k1).numpy()
    want = _expected(bitmap, w, s, k1 + 1)
    assert want.sum() > 0
    assert (got == want).all()


def test_level_counts_refuses_row_wider_than_k1():
    # The kernel tests exact-k1 rows as subsets; a wider row would need an
    # overlap count, so the wrapper refuses it on the CPU (on the card
    # the kernel asserts).
    bitmap, w, wb, s = _case(3, 64, 16, 128, 3)
    s[0, :4] = 1
    with pytest.raises(ValueError, match="at most k1=2"):
        level_counts(_t(bitmap), _t(wb), _t(s), 2)


@pytest.mark.parametrize("f", [12_416, 41_088])
def test_k1_check_limits_takes_any_f(f):
    # The wrapper's host checks accept F past the 12,288 an earlier form
    # of the kernel took, and the plain version answers there.
    assert not hasattr(level_kernel, "MAX_F")
    level_kernel.check_limits(71_304, f, 8192)
    level_kernel.check_limits(1, 10**7, 1)
    with pytest.raises(ValueError, match="2\\^31"):
        level_kernel.check_limits(2**31, f, 1)
    with pytest.raises(ValueError, match="2\\^31"):
        level_kernel.check_limits(1, f, 2**31)
    rng = np.random.default_rng(f)
    t, m, k1 = 40, 9, 3
    bitmap = (rng.random((t, f)) < 0.001).astype(np.int8)
    bitmap[::4, :64] = 1
    s = np.zeros((m, f), dtype=np.int8)
    for i in range(m - 1):
        s[i, rng.choice(64, size=k1, replace=False)] = 1
    s[-1, f - 1] = 1  # a padding row
    w = rng.integers(1, 128, size=t).astype(np.int64)
    wb = (bitmap * w[:, None]).astype(np.int8)
    got = level_counts(_t(bitmap), _t(wb), _t(s), k1).numpy()
    want = _expected(bitmap, w, s, k1 + 1)
    assert want.sum() > 0
    assert (got == want).all()


def _k1_by_row_words(bitmap, wb, s, k1):
    """K1's packed, word-sparse membership in numpy: 32-column words (bit
    j = column 32 w + j), each prefix row reduced to its non-zero words; a
    row of exactly k1 items holds a transaction iff none of its listed
    words has a bit the transaction lacks, and a row with fewer items
    never matches."""
    t, f = bitmap.shape
    words = -(-f // 32)

    def pack(x):
        bits = np.zeros((x.shape[0], words * 32), dtype=np.uint64)
        bits[:, :f] = x != 0
        return (bits.reshape(x.shape[0], words, 32)
                << np.arange(32, dtype=np.uint64)).sum(axis=2)

    bp, sp = pack(bitmap), pack(s)
    out = np.zeros(s.shape, dtype=np.int64)
    for m in range(s.shape[0]):
        if (s[m] != 0).sum() != k1:
            continue
        listed = np.nonzero(sp[m])[0]
        held = np.ones(t, dtype=bool)
        for w in listed:
            held &= (sp[m, w] & ~bp[:, w]) == 0
        out[m] = wb[held].astype(np.int64).sum(axis=0)
    return out.astype(np.int32)


@pytest.mark.parametrize("k, f", [(2, 256), (3, 200), (5, 256)])
def test_k1_row_word_decomposition_matches_pallas(k, f):
    bitmap, w, wb, s = _case(k, T_TILE * 2, M_TILE, f, k)
    s[3] = 0
    s[3, :k - 2] = 1  # a row of k - 2 items: it never matches
    want = np.asarray(
        level_counts_pallas(
            jnp.asarray(bitmap), jnp.asarray(wb), jnp.asarray(s),
            jnp.int32(k - 1), t_tile=T_TILE, m_tile=M_TILE, interpret=True,
        )
    )
    assert (_k1_by_row_words(bitmap, wb, s, k - 1) == want).all()
    assert (want[3] == 0).all() and want.sum() > 0


def _match_case(seed, mb=64, f=128, r=256, k=4, density=0.15):
    """Baskets with padding rows (len 0), a rule table with padding rules
    (size > F) pointing at the all-zero column, and some baskets that no
    rule matches (F >= 8)."""
    rng = np.random.default_rng(seed)
    zcol = f - 1
    baskets = (rng.random((mb, f)) < density).astype(np.int8)
    baskets[:, zcol] = 0
    baskets[-8:] = 0  # padding rows
    blen = baskets.sum(axis=1).astype(np.int32)
    baskets[5] = 0  # a real basket no rule can match
    baskets[5, zcol - 1] = 1
    blen[5] = 1
    size = rng.integers(1, k + 1, size=r).astype(np.int32)
    ant = rng.integers(0, zcol - 1, size=(r, k)).astype(np.int32)
    ant[np.arange(k)[None, :] >= size[:, None]] = zcol
    cons = rng.integers(0, zcol - 1, size=r).astype(np.int32)
    size[-40:] = f + 1  # padding rules
    ant[-40:] = zcol
    cons[-40:] = 0
    return baskets, blen, ant, size, cons


@pytest.mark.parametrize("seed", [0, 1])
def test_first_match_matches_pallas_interpret(seed):
    baskets, blen, ant, size, cons = _match_case(seed)
    want = np.asarray(
        strided_best_rank_pallas(
            jnp.asarray(baskets), jnp.asarray(blen), jnp.asarray(ant),
            jnp.asarray(size), jnp.asarray(cons), jnp.int32(0),
            n_shards=1, rule_tile=128, no_match=NO_MATCH, interpret=True,
        )
    )
    got = first_match_plain(
        *(_t(x) for x in (baskets, blen, ant, size, cons)), rule_chunk=96
    ).numpy()
    assert (got == want).all()
    assert (got[-8:] == NO_MATCH).all()  # padding rows never match
    assert got[5] == NO_MATCH
    assert (got < NO_MATCH).sum() > 10
    assert not np.isin(got, np.arange(len(size) - 40, len(size))).any()


def test_wrappers_on_cpu_tensors_launch_nothing():
    level_counts.launches = 0
    first_match.launches = 0
    bitmap, w, wb, s = _case(1, 64, 16, 128, 3)
    level_counts(_t(bitmap), _t(wb), _t(s), 2)
    baskets, blen, ant, size, cons = _match_case(2)
    first_match(*(_t(x) for x in (baskets, blen, ant, size, cons)))
    assert level_counts.launches == 0
    assert first_match.launches == 0


def _pallas_best(baskets, blen, ant, size, cons):
    rt = 128
    r = ant.shape[0]
    pad = -r % rt  # the Pallas wrapper wants whole rule tiles
    if pad:
        zcol = baskets.shape[1] - 1
        ant = np.concatenate([ant, np.full((pad, ant.shape[1]), zcol,
                                           dtype=np.int32)])
        size = np.concatenate([size, np.full(pad, baskets.shape[1] + 1,
                                             dtype=np.int32)])
        cons = np.concatenate([cons, np.zeros(pad, dtype=np.int32)])
    return np.asarray(
        strided_best_rank_pallas(
            jnp.asarray(baskets), jnp.asarray(blen), jnp.asarray(ant),
            jnp.asarray(size), jnp.asarray(cons), jnp.int32(0),
            n_shards=1, rule_tile=rt, no_match=NO_MATCH, interpret=True,
        )
    )


def _planted_case(seed, mb, f, r, k, density=0.15):
    """:func:`_match_case` with a third of the rules taken from the
    baskets' own items, so matches land at many ranks."""
    baskets, blen, ant, size, cons = _match_case(seed, mb, f, r, k, density)
    rng = np.random.default_rng(seed + 100)
    for q in rng.choice(r - 40, size=(r - 40) // 3, replace=False):
        items = np.nonzero(baskets[rng.integers(mb - 8)])[0]
        if len(items) >= size[q]:
            ant[q, : size[q]] = rng.choice(items, size=size[q],
                                           replace=False)
    return baskets, blen, ant, size, cons


@pytest.mark.parametrize("f", [7296, 300])
def test_first_match_wide_and_ragged_f_matches_pallas_interpret(f):
    # F = 7,296 lies just above the old kernel's 7,168 limit; F = 300 is
    # no multiple of 32 (the packed baskets' last word is partial).
    case = _planted_case(3, 24, f, 300, 5)
    want = _pallas_best(*case)
    got = first_match_plain(*(_t(x) for x in case), rule_chunk=64).numpy()
    assert (got == want).all()
    assert (got[-8:] == NO_MATCH).all() and (got < NO_MATCH).sum() > 5


def test_check_limits_takes_any_f():
    assert not hasattr(match_kernel, "MAX_F")
    check_limits(4096, 41_088, 65_536, 6)  # the kosarak-shape corpus padded
    check_limits(1, 10**7, 1, 1)
    check_limits(match_kernel.MAX_BASKETS, 1, match_kernel.MAX_RULES, 64)
    with pytest.raises(ValueError, match="R <="):
        check_limits(1, 128, match_kernel.MAX_RULES + 1, 4)
    with pytest.raises(ValueError, match="MB <="):
        check_limits(match_kernel.MAX_BASKETS + 1, 128, 1, 4)


@pytest.mark.parametrize("mb, r, blocks", [
    (4096, 131_072, 792),  # the T10I4D100K-shape launch
    (256, 65_536, 792),  # the vertical path's launch
    (1, 1, 528), (77, 1000, 1), (130, 70_001, 10), (10_000, 300, 1000),
])
def test_work_plan_covers_every_pair_once(mb, r, blocks):
    groups, per_range, ranges = work_plan(mb, r, blocks)
    tiles = -(-r // RULE_TILE)
    assert groups == -(-mb // GROUP)
    seen = np.zeros((groups, tiles), dtype=np.int64)
    for item in range(groups * ranges):
        g, rg = item % groups, item // groups
        seen[g, rg * per_range : (rg + 1) * per_range] += 1
    assert (seen == 1).all()
    assert (ranges - 1) * per_range < tiles <= ranges * per_range
    # Enough items for the wave unless every range is one tile.
    want = match_kernel.ITEMS_PER_BLOCK * blocks
    assert groups * ranges >= min(want, groups * tiles) * 0.5


def _k2_by_items(baskets, blen, ant, size, cons, per_range, order):
    """The CUDA kernel's decomposition in numpy: baskets packed to 32-bit
    words (bit j of word w = column 32 w + j, as the packing pass does),
    work items (group of ``GROUP`` baskets, range of ``per_range`` tiles)
    in the given order, each scanning its live baskets tile by tile, a
    basket stopping at its first match (the first ``size`` antecedent
    positions tested as bits) and dropping out once its running minimum
    lies below the next tile; results merged by a running minimum, as
    atomicMin does."""
    mb, _ = baskets.shape
    r, k = ant.shape
    groups = -(-mb // GROUP)
    ranges = -(-(-(-r // RULE_TILE)) // per_range)
    words = -(-baskets.shape[1] // 32)
    bits = np.zeros((mb, words * 32), dtype=np.uint8)
    bits[:, : baskets.shape[1]] = baskets != 0
    packed = np.packbits(bits, axis=1, bitorder="little").view("<u4")

    def has(b, c):
        return (packed[b, c >> 5] >> np.uint32(c & 31)) & 1

    tiles = -(-r // RULE_TILE)
    best = np.full(mb, NO_MATCH, dtype=np.int64)
    for item in order(groups * ranges):
        g, rg = item % groups, item // groups
        t0 = rg * per_range
        rows = [g * GROUP + s for s in range(GROUP) if g * GROUP + s < mb]
        limit = {b: best[b] for b in rows}
        live = [b for b in rows
                if blen[b] > 0 and limit[b] > t0 * RULE_TILE]
        for t in range(t0, min(tiles, t0 + per_range)):
            if not live:
                break
            found = set()
            for b in live:
                for q in range(t * RULE_TILE, min((t + 1) * RULE_TILE, r)):
                    sz = size[q]
                    if (sz <= blen[b] and sz <= k and not has(b, cons[q])
                            and all(has(b, ant[q, j]) for j in range(sz))):
                        best[b] = min(best[b], q)
                        found.add(b)
                        break
            live = [b for b in live if b not in found
                    and limit[b] > (t + 1) * RULE_TILE]
    return best.astype(np.int32)


@pytest.mark.parametrize("per_range, shuffled", [(3, False), (2, False),
                                                 (1, False), (1, True)])
def test_k2_item_decomposition_matches_pallas(per_range, shuffled):
    # MB and R multiples of neither the group nor the tile; the table cut
    # into one range, ranges of two tiles and one tile, run in counter or
    # shuffled order.
    case = _planted_case(5, 100, 400, 700, 4, density=0.02)
    rng = np.random.default_rng(0)

    def order(n):
        return rng.permutation(n) if shuffled else range(n)

    want = _pallas_best(*case)
    got = _k2_by_items(*case, per_range=per_range, order=order)
    assert (got == want).all()
    assert 10 < (got < NO_MATCH).sum() < 92
    assert (got[(got < NO_MATCH)] >= RULE_TILE).any()


@pytest.mark.parametrize("breach, message", [
    ("basket_value", "0/1"), ("ant_range", "ant entries"),
    ("cons_range", "cons entries"), ("size_zero", ">= 1"),
    ("padding_column", "zero in every basket"),
])
def test_first_match_refuses_contract_breaches_on_cpu(breach, message):
    baskets, blen, ant, size, cons = _match_case(4)
    f = baskets.shape[1]
    if breach == "basket_value":
        baskets[0, 3] = 2
    elif breach == "ant_range":
        ant[7, 0] = f
    elif breach == "cons_range":
        cons[7] = -1
    elif breach == "size_zero":
        size[7] = 0
    else:
        q = int(np.nonzero(size < ant.shape[1])[0][0])
        ant[q, -1] = int(np.nonzero(baskets.any(axis=0))[0][0])
    with pytest.raises(ValueError, match=message):
        first_match(*(_t(x) for x in (baskets, blen, ant, size, cons)))
