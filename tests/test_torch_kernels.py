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
from fastapriori_tpu_torch.ops.level_kernel import (
    level_counts,
    level_counts_plain,
)
from fastapriori_tpu_torch.ops.match_kernel import (
    NO_MATCH,
    first_match,
    first_match_plain,
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


def _match_case(seed, mb=64, f=128, r=256, k=4):
    """Baskets with padding rows (len 0), a rule table with padding rules
    (size > F) pointing at the all-zero column, and some baskets that no
    rule matches."""
    rng = np.random.default_rng(seed)
    zcol = f - 1
    baskets = (rng.random((mb, f)) < 0.15).astype(np.int8)
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
