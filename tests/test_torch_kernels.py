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


def _k1_dense_by_tiles(bitmap, wb, s, k1):
    """K1's dense (tensor-core) form in numpy, as csrc/level_counts.cu
    lays it out: B's bits sliced by transaction (bit i of word (f, w) =
    B[32 w + i, f], T padded to 512 and F to 64), each row of exactly k1
    items listed by item; per 128-row tile holding a live row (tiles of
    padding rows only take no work), 256-column F slice and
    128-transaction sub-tile, the ballot word of each (row, 32-transaction
    group) (the AND of the row's item words, masked past T) expanded to
    the 0/1 int8 tile common[128, 128], times the sub-tile of WB
    transposed to [Fp, Tp] (T contiguous, the .col operand), in int32,
    accumulated over T.  Returns the counts and the tiles visited."""
    t, f = bitmap.shape
    m = s.shape[0]
    tp, fp = -(-t // 512) * 512, -(-f // 64) * 64
    bits = np.zeros((fp, tp), dtype=np.uint64)
    bits[:f, :t] = (bitmap != 0).T
    bv = (bits.reshape(fp, tp // 32, 32)
          << np.arange(32, dtype=np.uint64)).sum(axis=2).astype(np.uint32)
    valid = np.zeros(tp, dtype=np.uint64)
    valid[:t] = 1
    valid_w = (valid.reshape(-1, 32)
               << np.arange(32, dtype=np.uint64)).sum(axis=1).astype(np.uint32)
    wbt = np.zeros((fp, tp), dtype=np.int8)
    wbt[:f, :t] = wb.T
    live = (s != 0).sum(axis=1) == k1
    out = np.zeros((m, f), dtype=np.int32)
    visited = []
    for tile in range(-(-m // 128)):
        rows = np.arange(tile * 128, min(m, tile * 128 + 128))
        if not live[rows].any():
            continue
        visited.append(tile)
        words = np.zeros((128, tp // 32), dtype=np.uint32)
        for r in rows[live[rows]]:
            words[r - tile * 128] = np.bitwise_and.reduce(
                bv[np.flatnonzero(s[r])], axis=0, initial=0xFFFFFFFF)
        words &= valid_w
        common = ((words[:, :, None] >> np.arange(32, dtype=np.uint32))
                  & 1).reshape(128, tp).astype(np.int8)
        for f0 in range(0, fp, 256):
            acc = np.zeros((128, min(256, fp - f0)), dtype=np.int32)
            for t0 in range(0, tp, 128):
                acc += (common[:, t0 : t0 + 128].astype(np.int32)
                        @ wbt[f0 : f0 + 256, t0 : t0 + 128].T.astype(
                            np.int32))
            cols = min(f0 + 256, f) - f0
            if cols > 0:
                out[rows, f0 : f0 + cols] = acc[: len(rows), :cols]
    return out, visited


def _pallas_padded(bitmap, wb, s, k1):
    """The Pallas kernel in interpret mode on T and M padded to its tile
    multiples with zero rows (a zero prefix row never holds k1 >= 1
    items), cropped back."""
    t, f = bitmap.shape
    m = s.shape[0]
    tp, mp = -(-t // T_TILE) * T_TILE, -(-m // M_TILE) * M_TILE
    pad = lambda x, n: np.concatenate(  # noqa: E731
        [x, np.zeros((n - x.shape[0], f), dtype=np.int8)])
    got = level_counts_pallas(
        jnp.asarray(pad(bitmap, tp)), jnp.asarray(pad(wb, tp)),
        jnp.asarray(pad(s, mp)), jnp.int32(k1), t_tile=T_TILE,
        m_tile=M_TILE, interpret=True)
    return np.asarray(got)[:m]


def _k1_prefix_case(seed, t, m, f, k1, fill, held, n_live):
    """A bitmap of about ``fill``, rows 0..n_live-1 prefixes of k1 items
    from the first 16 columns (each planted in about ``held`` of the
    transactions, so they are contained: every fifth row holds k1 - 1
    items and never matches), the rest padding rows (one item in the
    last column)."""
    rng = np.random.default_rng(seed)
    bitmap = (rng.random((t, f)) < fill).astype(np.int8)
    s = np.zeros((m, f), dtype=np.int8)
    s[:, f - 1] = 1
    for i in range(n_live):
        s[i] = 0
        cols = rng.choice(16, size=k1 - 1 if i % 5 == 4 else k1,
                          replace=False)
        s[i, cols] = 1
        bitmap[rng.random(t) < held, cols[:, None]] = 1
    bitmap[:, f - 1] = 0
    w = rng.integers(1, 128, size=t).astype(np.int64)
    wb = (bitmap * w[:, None]).astype(np.int8)
    return bitmap, w, wb, s


@pytest.mark.parametrize(
    "case, t, m, f, k1, fill, held, n_live",
    [("sparse", 1024, 512, 256, 3, 0.03, 0.02, 300),
     ("dense", 1024, 512, 256, 4, 0.45, 0.3, 512),
     ("ragged", 1001, 300, 203, 2, 0.4, 0.2, 100)])
def test_k1_dense_tile_decomposition_matches_pallas(case, t, m, f, k1, fill,
                                                     held, n_live):
    bitmap, w, wb, s = _k1_prefix_case(len(case), t, m, f, k1, fill, held,
                                       n_live)
    if case == "dense":
        assert (bitmap != 0).mean() >= 0.4
    got, visited = _k1_dense_by_tiles(bitmap, wb, s, k1)
    want = _pallas_padded(bitmap, wb, s, k1)
    assert (got == want).all()
    assert (want == _expected(bitmap, w, s, k1 + 1)).all()
    assert want[:n_live].sum() > 0 and (want[n_live:] == 0).all()
    # Tiles of padding rows only take no work.
    assert visited == list(range(-(-n_live // 128)))


@pytest.mark.parametrize("f, cross", [(256, 0.0025), (384, 0.0105),
                                      (768, 0.0065), (96, 0.0025)])
def test_k1_form_rule_picks_each_side_of_its_crossover(f, cross):
    # The crossover share at F: 0.8 % per dense slice over packed slice,
    # less 0.55 % (the sweeps put it near 0.25 % at F = 256, 1.05 % at
    # 384, 0.6 % at 768).
    assert level_kernel.pick_form(cross * 1.01, f) == "dense"
    assert level_kernel.pick_form(1.0, f) == "dense"
    assert level_kernel.pick_form(cross * 0.99, f) == "packed"
    assert level_kernel.pick_form(0.0, f) == "packed"
    assert set(level_kernel.FORMS) == {"packed", "dense"}


def test_k1_form_on_cpu_runs_the_plain_version_and_launches_nothing():
    bitmap, w, wb, s = _case(11, 300, 40, 96, 3)
    want = level_counts_plain(_t(bitmap), _t(wb), _t(s), 2)
    before = (level_counts.launches, dict(level_counts.launches_by_form))
    for form in (*level_kernel.FORMS, None):
        got = level_counts(_t(bitmap), _t(wb), _t(s), 2, form=form)
        assert torch.equal(got, want)
    assert (level_counts.launches, level_counts.launches_by_form) == before
    with pytest.raises(ValueError, match="form"):
        level_counts(_t(bitmap), _t(wb), _t(s), 2, form="tensor")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a card as its device: enough for the
    wrapper's checks, up to its launch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_k1_on_the_card_without_a_form_raises_before_launching(monkeypatch):
    class NoGuard:
        def __init__(self, device):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def no_launch(*_a, **_k):
        raise AssertionError("reached the library without a form")

    monkeypatch.setattr(torch.cuda, "device", NoGuard)
    monkeypatch.setattr(level_kernel, "_lib", no_launch)
    bitmap, w, wb, s = _case(12, 64, 8, 32, 3)
    args = [torch.Tensor._make_subclass(_OnCard, _t(x))
            for x in (bitmap, wb, s)]
    before = (level_counts.launches, dict(level_counts.launches_by_form))
    with pytest.raises(ValueError, match="needs its form"):
        level_counts(*args, 2)
    assert (level_counts.launches, level_counts.launches_by_form) == before


@pytest.mark.parametrize("min_support, form", [(0.3, "dense"),
                                               (0.002, "packed")])
def test_level_loop_launches_k1_in_the_rules_form(min_support, form,
                                                  monkeypatch):
    # The level loop hands pick_form's choice for the mine's min support
    # (min count over the transaction count) to each K1 launch.
    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.models import apriori as ap

    seen = []
    real = ap.level_counts

    def recorded(*args, **kw):
        seen.append(kw.get("form"))
        return real(*args, **kw)

    monkeypatch.setattr(ap, "level_counts", recorded)
    rng = np.random.default_rng(5)
    lines = [" ".join(str(i) for i in range(1, 9) if rng.random() < 0.8)
             + f" {100 + j % 40}" for j in range(400)]
    miner = ap.FastApriori(config=MinerConfig(
        min_support=min_support, engine="level", tail_fuse_rows=0),
        device="cpu")
    # The bitmap is at most 256 columns wide: one slice of each form.
    assert all(level_kernel.pick_form(min_support, f) == form
               for f in (64, 128, 256))
    miner.run(lines)
    assert seen and set(seen) == {form}


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
