"""The port's fused whole-loop engine, its pair pre-pass, the shallow-tail
fold and the engine choice against the JAX package's, on the CPU.

The ops compare the packed int32 results element for element (tolerance
0) with fastapriori_tpu/ops/fused.py at ``mesh=None``: the fused miner
with both input forms, one and two weight digits, one and two
transaction chunks, float32 and int8 products, a row-budget overflow and
the l_max bound; the pair counter; the tail fold with heavy rows, a
prefix-budget overflow and the depth bound; the candidate products in
row blocks; the unpack and decode helpers on the same arrays.  The
engine runs on both packages at the same block and thread counts (one
CPU device on the JAX side): the auto choice, the forced fused attempt
that salvages and falls back, the memory skip, an explicit tail fold
and the fold's entry test; then the CLI bytes against the JAX CLI's and
the oracle's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dataset
from fastapriori_tpu import oracle
from fastapriori_tpu.cli import main as jax_main
from fastapriori_tpu.config import MinerConfig as JaxConfig
from fastapriori_tpu.models.apriori import FastApriori as JaxApriori
from fastapriori_tpu.ops import fused as jf
from fastapriori_tpu.parallel.mesh import DeviceContext as JaxContext
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.io.reader import tokenize_line
from fastapriori_tpu_torch.models.apriori import FastApriori, split_weights
from fastapriori_tpu_torch.ops import fused as tf
from fastapriori_tpu_torch.ops.bitmap import next_pow2, weight_digits
from test_torch_e2e import _write_inputs


def _case(seed, t=600, f=128, n_items=40, heavy=False, pattern_len=6):
    """A 0/1 bitmap with four planted patterns (so the lattice is a few
    levels deep), items past ``n_items`` empty, and weights 1..5 (a few
    of 128..399 when ``heavy``)."""
    rng = np.random.default_rng(seed)
    b = (rng.random((t, f)) < 0.06).astype(np.int8)
    pats = [rng.choice(n_items, pattern_len, replace=False) for _ in range(4)]
    for i in range(t):
        if rng.random() < 0.35:
            b[i, pats[rng.integers(4)]] = 1
    b[:, n_items:] = 0
    w = rng.integers(1, 6, size=t).astype(np.int32)
    if heavy:
        w[rng.choice(t, 5, replace=False)] = rng.integers(128, 400, size=5)
    return b, w


def _both_fused(b, w, min_count, m_cap, l_max, n_digits, n_chunks, fast_f32,
                packed_input):
    x = jf.pack_bitmap(b) if packed_input else b
    want = np.asarray(jf.make_fused_miner(
        None, m_cap, l_max, n_digits, n_chunks, fast_f32, packed_input)(
        jnp.asarray(x), jnp.asarray(w), jnp.int32(min_count)))
    got = tf.make_fused_miner(m_cap, l_max, n_digits, n_chunks, fast_f32,
                              packed_input)(
        torch.from_numpy(x), torch.from_numpy(w), min_count)
    assert got.dtype == torch.int32
    got = got.numpy()
    assert got.shape == want.shape == (3 * l_max + 1, m_cap)
    assert np.array_equal(got, want)
    return got


def _same_unpacked(got, l_max):
    """unpack_fused_result and decode_level_matrices of both packages
    agree on the same array."""
    a = tf.unpack_fused_result(got, l_max)
    b = jf.unpack_fused_result(got, l_max)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    rows, cols, counts, n_lvl, incomplete, overflow = a[:6]
    m_cap = got.shape[1]
    for cap in (None, m_cap):
        mine = tf.decode_level_matrices(rows, cols, counts, n_lvl, cap)
        ref = jf.decode_level_matrices(rows, cols, counts, n_lvl, cap)
        assert len(mine) == len(ref)
        for (m1, c1), (m2, c2) in zip(mine, ref):
            assert m1.dtype == m2.dtype and np.array_equal(m1, m2)
            assert c1.dtype == c2.dtype and np.array_equal(c1, c2)
    return n_lvl, incomplete, overflow


@pytest.mark.parametrize(
    "packed_input, heavy, n_chunks, fast_f32",
    [(True, False, 1, True), (False, False, 2, False),
     (True, True, 2, False), (False, True, 1, True)],
    ids=["packed-1digit-f32", "resident-1digit-2chunks-int8",
         "packed-2digits-2chunks-int8", "resident-2digits-f32"],
)
def test_fused_miner_matches_jax(packed_input, heavy, n_chunks, fast_f32):
    b, w = _case(1, heavy=heavy)
    n_digits = 2 if heavy else 1
    assert (w >= 128).any() == heavy
    got = _both_fused(b, w, 30, 1024, 10, n_digits, n_chunks, fast_f32,
                      packed_input)
    n_lvl, incomplete, overflow = _same_unpacked(got, 10)
    assert not incomplete and not overflow
    assert np.count_nonzero(n_lvl) >= 4


@pytest.mark.parametrize("m_cap", [128, 256], ids=["at-level-2", "mid-loop"])
def test_fused_miner_overflow_matches_jax(m_cap):
    """n2 > m_cap stops before the loop; a later level past m_cap stops
    it there, with the true count in the meta row either way (levels of
    215, 450, 744, ... rows)."""
    b, w = _case(2, heavy=True, pattern_len=8)
    got = _both_fused(b, w, 35, m_cap, 8, 2, 1, False, True)
    n_lvl, incomplete, overflow = _same_unpacked(got, 8)
    assert incomplete and overflow and n_lvl.max() > m_cap
    assert (n_lvl[0] > m_cap) == (m_cap == 128)


def test_fused_miner_l_max_bound_matches_jax():
    b, w = _case(3)
    got = _both_fused(b, w, 30, 256, 3, 1, 1, True, False)
    n_lvl, incomplete, overflow = _same_unpacked(got, 3)
    assert incomplete and not overflow and n_lvl.min() > 0


@pytest.mark.parametrize("heavy, n_chunks, f", [(False, 1, 128),
                                                (True, 2, 256)])
def test_pair_counter_matches_jax(heavy, n_chunks, f):
    b, w = _case(4, f=f, heavy=heavy)
    n_digits = 2 if heavy else 1
    packed = jf.pack_bitmap(b)
    for min_count in (1, 30, 10**6):
        want = jf.make_pair_counter(None, n_digits, n_chunks)(
            jnp.asarray(packed), jnp.asarray(w), jnp.int32(min_count))
        got = tf.make_pair_counter(n_digits, n_chunks)(
            torch.from_numpy(packed), torch.from_numpy(w), min_count)
        assert [int(x) for x in got] == [int(x) for x in want]
    assert int(got[0]) == 0 and int(want[1]) == 0


@pytest.mark.parametrize("row_chunks", [1, 4])
@pytest.mark.parametrize("f32", [True, False])
def test_gen_candidates_matches_jax(row_chunks, f32):
    rng = np.random.default_rng(5)
    m, f, k = 64, 48, 4
    s = np.zeros((m, f), np.int8)
    base = rng.choice(f, 8, replace=False)
    for i in range(56):  # 3-subsets of a few 8-item sets: many candidates
        s[i, rng.choice(base if i % 2 else rng.choice(f, 8), 3,
                        replace=False)] = 1
    valid = (np.arange(m) < 50)[:, None]
    want = np.asarray(jf._gen_candidates_matmul(
        jnp.asarray(s), jnp.int32(k), jnp.arange(f, dtype=jnp.int32),
        jnp.asarray(valid), row_chunks=row_chunks))
    got = tf.gen_candidates_matmul(
        torch.from_numpy(s), k, torch.arange(f), torch.from_numpy(valid),
        row_chunks=row_chunks, f32=f32).numpy()
    assert want.any() and np.array_equal(got, want)


def test_weighted_counts_matches_jax():
    b, w = _case(6, t=200, heavy=True)
    common = (np.random.default_rng(6).random((200, 40)) < 0.3).astype(
        np.int8)
    for fast_f32 in (True, False):
        want = np.asarray(jf._weighted_counts(
            jnp.asarray(common), jnp.asarray(b), jnp.asarray(w), 2,
            fast_f32))
        got = tf.weighted_counts(torch.from_numpy(common.T.copy()),
                                 torch.from_numpy(b), torch.from_numpy(w), 2,
                                 fast_f32).numpy()
        assert np.array_equal(got, want)


def _seed_level(b, w, min_count, k0):
    """Level k0 (k0 >= 2) of the case, from the JAX fused miner."""
    out = np.asarray(jf.make_fused_miner(None, 1024, 10, 2, 1, True, False)(
        jnp.asarray(b), jnp.asarray(w), jnp.int32(min_count)))
    rows, cols, counts, n_lvl = jf.unpack_fused_result(out, 10)[:4]
    return jf.decode_level_matrices(rows, cols, counts, n_lvl)[k0 - 2][0]


@pytest.mark.parametrize(
    "k0, p_cap, l_max, n_chunks, want_incomplete",
    [(2, 512, 8, 2, False), (3, 4, 8, 1, True), (2, 512, 2, 1, True)],
    ids=["heavy-rows", "p_cap-overflow", "depth-bound"],
)
def test_tail_miner_matches_jax(k0, p_cap, l_max, n_chunks, want_incomplete):
    b, w = _case(7, heavy=True)
    min_count = 25
    cur = _seed_level(b, w, min_count, k0)
    n0 = cur.shape[0]
    m_cap = max(next_pow2(n0), 128)
    seed = np.zeros((m_cap, k0), np.int32)
    seed[:n0] = cur
    t, f = b.shape
    w_digits, scales, heavy_b, heavy_w = split_weights(
        w, t, *_csr(b), f - 1, 128)
    assert heavy_b is not None and scales == [1]
    want = np.asarray(jf.make_tail_miner(
        None, tuple(scales), k0, m_cap, p_cap, l_max, n_chunks, True)(
        jnp.asarray(b), jnp.asarray(w_digits), jnp.asarray(seed),
        jnp.int32(n0), jnp.int32(min_count), jnp.asarray(heavy_b),
        jnp.asarray(heavy_w)))
    got = tf.make_tail_miner(scales, k0, m_cap, p_cap, l_max, n_chunks,
                             True)(
        torch.from_numpy(b), torch.from_numpy(w_digits),
        torch.from_numpy(seed), n0, min_count, torch.from_numpy(heavy_b),
        torch.from_numpy(heavy_w)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    mine = tf.unpack_tail_result(got, m_cap, l_max)
    ref = jf.unpack_tail_result(got, m_cap, l_max)
    for x, y in zip(mine, ref):
        if isinstance(x, list):
            assert all(np.array_equal(p, q) for p, q in zip(x, y))
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y))
    assert mine[4] == want_incomplete
    caps = list(tf.tail_slot_caps(m_cap, l_max))
    assert caps == list(jf.tail_slot_caps(m_cap, l_max))
    lv = tf.decode_level_matrices(*mine[:4], max_rows=caps, prev=cur)
    ref_lv = jf.decode_level_matrices(*ref[:4], max_rows=caps, prev=cur)
    assert [m.tolist() for m, _ in lv] == [m.tolist() for m, _ in ref_lv]
    if k0 == 3:
        assert mine[3][0] == m_cap + 1  # the sentinel, first tail level
    else:
        assert len(lv) >= 1


def _csr(b):
    rows, cols = np.nonzero(b)
    offsets = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=b.shape[0]))]).astype(np.int64)
    return cols.astype(np.int32), offsets


def test_tail_helpers_match_jax():
    for m_cap in (128, 4096, 16384, 65536):
        assert tf.tail_cand_row_chunks(m_cap) == jf.tail_cand_row_chunks(
            m_cap)
        assert tf.tail_slot_caps(m_cap, 8) == jf.tail_slot_caps(m_cap, 8)


# ---------------------------------------------------------------- engine

def _dense_lines(seed=11, n=700):
    """Eleven items that co-occur densely (every pair and triple
    frequent at 3 %), some with weights >= 128 through repeats, plus
    noise items."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        items = [str(i) for i in range(1, 12) if rng.random() < 0.5]
        items += [str(x) for x in rng.integers(20, 60, size=2)]
        lines.append(" ".join(items))
    return lines + ["1 2 3 4 5"] * 150


def _write(tmp_path, lines):
    path = tmp_path / "D.dat"
    path.write_text("".join(x + "\n" for x in lines))
    return str(path)


def _jax_mine(path, min_support, **cfg):
    miner = JaxApriori(config=JaxConfig(min_support=min_support, **cfg),
                       context=JaxContext(num_devices=1))
    return miner.run_file_raw(path)[0], miner


def _port_mine(path, min_support, **cfg):
    miner = FastApriori(config=MinerConfig(min_support=min_support, **cfg),
                        device="cpu")
    return miner.run_file_raw(path)[0], miner


def _events(miner, name):
    return [r for r in miner.metrics.records if r["event"] == name]


def _levels_equal(got, want):
    assert len(got) == len(want)
    for (gm, gc), (wm, wc) in zip(got, want):
        assert gm.dtype == np.int32 and np.array_equal(gm, wm)
        assert np.array_equal(gc, wc)


@pytest.mark.parametrize(
    "blocks, knobs, choice",
    [(4, {}, "fused"), (1, {}, "fused"),
     (4, {"fused_m_cap_max": 64}, "level")],
    ids=["pipelined-fits", "one-call-fits", "pipelined-too-big"],
)
def test_auto_choice_matches_jax(tmp_path, blocks, knobs, choice):
    path = _write(tmp_path, _dense_lines())
    cfg = dict(engine="auto", ingest_pipeline_blocks=blocks,
               ingest_threads=2, **knobs)
    want, jminer = _jax_mine(path, 0.03, **cfg)
    got, miner = _port_mine(path, 0.03, **cfg)
    _levels_equal(got, want)
    (ev,) = _events(miner, "engine_auto")
    (jev,) = _events(jminer, "engine_auto")
    assert ev["choice"] == jev["choice"] == choice
    assert (ev["n2"], ev["cand3"]) == (jev["n2"], jev["cand3"])
    fm = _events(miner, "fused_mine")
    assert bool(fm) == (choice == "fused")
    if fm:
        assert not fm[-1]["incomplete"] and fm[-1]["packed_input"] == (
            blocks == 1)
        assert not _events(miner, "level")
    else:
        assert _events(miner, "level")


@pytest.mark.parametrize("blocks", [4, 1], ids=["pipelined", "one-call"])
def test_forced_fused_salvages_and_falls_back(tmp_path, blocks):
    """n2 = 65 fits a 128-row ceiling, level 3 (165 rows) does not: the
    attempt fails, level 2 is salvaged and the level engine goes on from
    it."""
    path = _write(tmp_path, _dense_lines())
    cfg = dict(engine="fused", fused_m_cap_max=128,
               ingest_pipeline_blocks=blocks, ingest_threads=2)
    want, _ = _jax_mine(path, 0.03, **cfg)
    got, miner = _port_mine(path, 0.03, **cfg)
    _levels_equal(got, want)
    fm = _events(miner, "fused_mine")
    assert fm and all(e["incomplete"] and e["overflow"] for e in fm)
    (fb,) = _events(miner, "fused_fallback")
    assert fb["resume_levels"] >= 1
    (res,) = _events(miner, "level_resume")
    assert res["from_k"] == 2 + fb["resume_levels"]


def test_tiny_memory_budget_skips_fused(tmp_path):
    path = _write(tmp_path, _dense_lines())
    cfg = dict(engine="fused", fused_hbm_budget_bytes=1 << 16,
               ingest_pipeline_blocks=4, ingest_threads=2)
    want, _ = _jax_mine(path, 0.03, **cfg)
    got, miner = _port_mine(path, 0.03, **cfg)
    _levels_equal(got, want)
    (skip,) = _events(miner, "fused_skip")
    assert skip["reason"] == "memory"
    assert not _events(miner, "fused_mine")


@pytest.mark.parametrize("p_cap", [2048, 4], ids=["complete", "p_cap-abort"])
def test_explicit_tail_fold_matches_jax(tmp_path, p_cap):
    path = _write(tmp_path, _dense_lines())
    cfg = dict(engine="level", tail_fuse_rows=100_000,
               tail_fuse_p_cap=p_cap, ingest_pipeline_blocks=4,
               ingest_threads=2)
    want, _ = _jax_mine(path, 0.03, **cfg)
    got, miner = _port_mine(path, 0.03, **cfg)
    _levels_equal(got, want)
    folds = _events(miner, "tail_fuse")
    assert folds and folds[0]["k0"] == 3
    if p_cap == 4:
        # The first fold aborts at its first level; K1 counts levels 4
        # and 5 (330 rows, not below the failed seed's 165); the second
        # fold takes the rest from level 5's 78 rows (3 candidates).
        assert [(e["k0"], e["incomplete"]) for e in folds] == [
            (3, True), (5, False)]
        assert {e["k"] for e in _events(miner, "level")} == {2, 3, 4, 5}
    else:
        assert not folds[-1]["incomplete"]


@pytest.mark.parametrize(
    "auto_tail, n0, prev_rows",
    [(False, 60_000, None), (True, 16_384, None), (True, 16_385, None),
     (True, 30_000, 40_000), (True, 30_000, 25_000), (True, 30_000, 24_000),
     (True, 30_001, 25_000), (True, 100, 50)],
)
def test_tail_entry_ok_matches_jax(auto_tail, n0, prev_rows):
    assert FastApriori._tail_entry_ok(auto_tail, n0, prev_rows) == \
        JaxApriori._tail_entry_ok(auto_tail, n0, prev_rows)


@pytest.mark.parametrize("engine", ["fused", "auto"])
def test_cli_bytes_match_jax_cli_and_oracle(tmp_path, capsys, engine):
    d_raw = _dense_lines(13, n=400) + random_dataset(8, n_txns=200,
                                                     n_items=30)
    u_raw = random_dataset(16, n_txns=60, n_items=30)
    inp = _write_inputs(tmp_path, d_raw, u_raw)
    assert torch_main([inp, str(tmp_path / "out_torch") + "/",
                       "--min-support", "0.03", "--engine", engine,
                       "--platform", "cpu", "--metrics"]) == 0
    events = [json.loads(x) for x in capsys.readouterr().err.splitlines()
              if x.startswith("{")]
    fm = [e for e in events if e["event"] == "fused_mine"]
    assert fm and not fm[-1]["incomplete"]
    assert jax_main([inp, str(tmp_path / "out_jax") + "/", "--min-support",
                     "0.03", "--engine", "fused", "--num-devices", "1",
                     "--platform", "cpu"]) == 0
    exp_freq, exp_rec = oracle.run_pipeline(
        [tokenize_line(x) for x in d_raw], [tokenize_line(x) for x in u_raw],
        0.03)
    for name, exp in (("freqItemset", exp_freq), ("recommends", exp_rec)):
        got = (tmp_path / "out_torch" / name).read_bytes()
        assert got == (tmp_path / "out_jax" / name).read_bytes()
        assert got == exp.encode("utf-8")


def test_weight_digits_agree_with_the_miner_split():
    """The engine's digit count is the one ops/bitmap.py's digits use."""
    from fastapriori_tpu_torch.models.apriori import weight_digit_count

    for w in (1, 127, 128, 16383, 16384):
        assert weight_digit_count(w) == len(
            weight_digits(np.array([w], np.int32), 1)[1])


def test_t10_auto_choice_matches_jax(tmp_path):
    """On chip_smoke.py's T10I4D100K-shape corpus both packages' auto
    choice is the level engine: the level-3 candidate census (135,521)
    exceeds every row-budget ceiling (32,768 at most), though the
    survivor budget (next_pow2(2 · 6,446) = 16,384) fits."""
    from fastapriori_tpu.preprocess import preprocess_file as jax_preprocess
    from fastapriori_tpu_torch.preprocess import preprocess_file
    from fastapriori_tpu_torch.utils.datagen import generate_transactions

    path = _write(tmp_path, generate_transactions(
        n_txns=100_000, n_items=1000, avg_txn_len=10, seed=2017))
    jminer = JaxApriori(config=JaxConfig(min_support=0.0025, engine="auto"),
                        context=JaxContext(num_devices=1))
    assert jminer._mine_fused(jax_preprocess(path, 0.0025),
                              auto=True) == (None, None)
    miner = FastApriori(config=MinerConfig(min_support=0.0025),
                        device="cpu")
    assert miner._mine_fused(preprocess_file(path, 0.0025),
                             auto=True) == (None, None)
    (jev,) = _events(jminer, "engine_auto")
    (ev,) = _events(miner, "engine_auto")
    assert ev["choice"] == jev["choice"] == "level"
    assert (ev["n2"], ev["cand3"]) == (jev["n2"], jev["cand3"]) == (
        6446, 135_521)
    assert ev["cand3"] > MinerConfig().fused_m_cap_max


@pytest.mark.parametrize("engine", ["auto", "level"])
def test_mine_without_csr_is_refused(tmp_path, engine):
    """A CompressedData from the capture ingest with retain_csr=False
    holds no CSR: re-mining it on the bitmap layout raises, as the JAX
    package's ``_require_csr`` does, instead of mining nothing."""
    from fastapriori_tpu_torch.errors import InputError

    path = _write(tmp_path, _dense_lines())
    miner = FastApriori(config=MinerConfig(
        min_support=0.03, retain_csr=False, engine=engine,
        ingest_pipeline_blocks=4), device="cpu")
    levels, data = miner.run_file_raw(path)
    assert levels and data.total_count > 0
    with pytest.raises(InputError, match="retain_csr"):
        miner.mine_levels_raw(data)


def _six_item_lines(seed=5, n=40):
    rng = np.random.default_rng(seed)
    items = list("abcdef")
    return [" ".join(rng.choice(items, rng.integers(1, 5), replace=False))
            for _ in range(n)]


@pytest.mark.parametrize("min_support", ["0", "-0.1"])
@pytest.mark.parametrize("corpus", ["two-line", "six-item"])
@pytest.mark.parametrize("run", ["zero-flag", "fused", "vertical"])
def test_min_support_at_most_zero_mines_only_real_items(
        tmp_path, monkeypatch, min_support, corpus, run):
    """At min support <= 0 min_count is <= 0, which the padded item
    columns (count 0) pass: every fused, tail and candidate mask is bound
    to the real columns, so each engine writes the JAX level engine's
    bytes (every subset of the real items) within a few seconds (the
    bound leaves room for a loaded test machine; unbounded, the two-line
    corpus seeds 8,128 pairs and runs past 600 s).  The oracle divides
    by zero here, so the JAX level engine is the reference."""
    import time

    if corpus == "two-line":
        d_raw, u_raw = ["a b", "b c"], ["b"]
    else:
        d_raw, u_raw = _six_item_lines(), _six_item_lines(6, n=8)
    inp = _write_inputs(tmp_path, d_raw, u_raw)
    flags = {"zero-flag": [], "fused": ["--engine", "fused"],
             "vertical": []}[run]
    if run == "vertical":
        monkeypatch.setenv("FA_MINE_ENGINE", "vertical")
    t0 = time.perf_counter()
    assert torch_main([inp, str(tmp_path / "out_torch") + "/",
                       f"--min-support={min_support}", "--platform", "cpu",
                       *flags]) == 0
    wall = time.perf_counter() - t0
    monkeypatch.delenv("FA_MINE_ENGINE", raising=False)
    assert jax_main([inp, str(tmp_path / "out_jax") + "/",
                     f"--min-support={min_support}", "--engine", "level",
                     "--num-devices", "1", "--platform", "cpu"]) == 0
    for name in ("freqItemset", "recommends"):
        assert (tmp_path / "out_torch" / name).read_bytes() == \
            (tmp_path / "out_jax" / name).read_bytes(), name
    n_sets = len((tmp_path / "out_jax" / "freqItemset").read_text()
                 .splitlines())
    assert n_sets == (7 if corpus == "two-line" else 63)
    assert wall < 30.0, wall
