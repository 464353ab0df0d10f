"""Mining, recommending and serving on S transaction shards of the port's
one-process mesh (CPU shards here; ``chip_smoke.py`` phase 12 runs the
same paths on one H100 named S times), held to the JAX package at one
device and to ``fastapriori_tpu/oracle.py``, which exact integer counting
makes valid at any shard count: the levels of every engine (level, tail
fold, fused, vertical) under every count reduction (dense, sparse, auto)
at S = 1, 2, 4 and 8; the reduction and exchange choices and their
ledger and metrics events; the reductions' bytes against the JAX byte
models; the cascade walks (an exhausted sparse fetch walks hier -> flat
-> dense, a kernel launch fault walks nothing); and the CLI's bytes at
``--num-devices 4``, ``--cand-devices 2`` and ``serve --num-devices 2``.
Nothing here runs the JAX package at more than one device."""

import os

import numpy as np
import pytest

from conftest import tokenized
from fastapriori_tpu import oracle
from fastapriori_tpu.cli import main as jax_main
from fastapriori_tpu.config import MinerConfig as JaxConfig
from fastapriori_tpu.models.apriori import FastApriori as JaxApriori
from fastapriori_tpu.ops import count as jcount
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.device import DeviceContext
from fastapriori_tpu_torch.io.reader import read_dat
from fastapriori_tpu_torch.models import apriori as tapriori
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.models.recommender import AssociationRules
from fastapriori_tpu_torch.reliability import (
    failpoints,
    ledger,
    retry,
    watchdog,
)
from fastapriori_tpu_torch.utils.datagen import (
    generate_transactions,
    generate_user_baskets,
)

MIN_SUPPORT = 0.05
JAX_FLAGS = ("--platform", "cpu", "--engine", "level", "--num-devices", "1")


@pytest.fixture(autouse=True)
def _clean_reliability_state():
    def clean():
        failpoints.disarm_all()
        ledger.reset()
        watchdog.reload_from_env()
        retry.reload_policy_from_env()

    clean()
    yield
    clean()


def _d_lines():
    """40 items, a planted 6-itemset so the lattice reaches k = 6 (the
    tail fold has a level-3 seed and more)."""
    return (["3 5 8 13 21 34"] * 60
            + generate_transactions(n_txns=540, n_items=40, seed=17))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    (d / "D.dat").write_text("".join(x + "\n" for x in _d_lines()))
    (d / "U.dat").write_text("".join(
        x + "\n" for x in generate_user_baskets(n_users=120, n_items=40,
                                                seed=18)))
    return str(d) + "/"


def _as_sets(levels, freq_items):
    return {frozenset(freq_items[r] for r in row): int(c)
            for mat, cnt in levels for row, c in zip(mat, cnt)}


@pytest.fixture(scope="module")
def reference(corpus):
    """The JAX package's levels at one device, and the oracle's itemsets
    (k >= 2) with their counts."""
    jlv, jdata = JaxApriori(config=JaxConfig(
        min_support=MIN_SUPPORT, engine="level",
        num_devices=1)).run_file_raw(corpus + "D.dat")
    got, _, freq = oracle.mine(tokenized(_d_lines()), MIN_SUPPORT)
    want = {frozenset(freq[r] for r in s): c for s, c in got if len(s) >= 2}
    assert _as_sets(jlv, jdata.freq_items) == want
    return jlv, want


def _mine(corpus, **knobs):
    miner = FastApriori(config=MinerConfig(min_support=MIN_SUPPORT, **knobs),
                        device="cpu")
    levels, data = miner.run_file_raw(corpus + "D.dat")
    return levels, data, miner


def _events(miner, name):
    return [r for r in miner.metrics.records if r["event"] == name]


def _levels_equal(got, want):
    assert len(got) == len(want)
    for (gm, gc), (wm, wc) in zip(got, want):
        assert np.array_equal(gm, wm)
        assert np.array_equal(np.asarray(gc, np.int64), np.asarray(wc))


ENGINES = {
    "level": {"engine": "level"},
    "tail": {"engine": "level", "tail_fuse_rows": 1 << 16},
    "fused": {"engine": "fused"},
    "vertical": {"engine": "level", "mine_engine": "vertical"},
}


@pytest.mark.parametrize("reduce", ["dense", "sparse", "auto"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_sharded_levels_equal_the_jax_package_and_the_oracle(
        s, engine, reduce, corpus, reference):
    jlv, want = reference
    got, data, miner = _mine(corpus, num_devices=s, count_reduce=reduce,
                             count_sparse_min=8, **ENGINES[engine])
    _levels_equal(got, jlv)
    assert _as_sets(got, data.freq_items) == want
    # The engine asked for ran, on the reduction the JAX package picks.
    if engine == "fused":
        assert _events(miner, "fused_mine")[-1]["incomplete"] is False
        ran = [e["reduce"] for e in _events(miner, "fused_mine")]
    else:
        if engine == "tail":
            assert _events(miner, "tail_fuse")
        if engine == "vertical":
            assert _events(miner, "mine_engine")[0]["engine"] == "vertical"
        (cr,) = _events(miner, "count_reduce")
        ran = [cr["engine"]]
    sparse = reduce in ("sparse", "auto") and s > 1
    assert ran[0] == ("sparse" if sparse else "dense")
    kinds = ledger.summary()
    assert ("count_reduce_engine" in kinds) == sparse
    assert ("count_reduce_fallback" in kinds) == (reduce == "sparse"
                                                  and s == 1)
    # With many shards of a small corpus the thresholds are low and a
    # union may pass its default budget: only a sparse run overflows, and
    # the dense redo keeps the levels above exact.
    assert "count_sparse_overflow" not in kinds or sparse


def _heavy_lines():
    """Three baskets of multiplicity >= 128 (the weight split's heavy
    rows: the kernels count ``w % 128`` and shard 0 adds the remainder)
    at the start, the middle and the end of the file, among the light
    ones."""
    light = generate_transactions(n_txns=540, n_items=40, seed=23)
    return (["2 7 11 19"] * 130 + light[:270] + ["5 8 13 29 31"] * 150
            + light[270:] + ["1 3 17 23 37"] * 200)


@pytest.fixture(scope="module")
def heavy_reference(tmp_path_factory):
    """The heavy corpus's input prefix, and the JAX package's levels at
    one device, equal to the oracle's itemsets."""
    d = tmp_path_factory.mktemp("heavy")
    (d / "D.dat").write_text("".join(x + "\n" for x in _heavy_lines()))
    corpus = str(d) + "/"
    jlv, jdata = JaxApriori(config=JaxConfig(
        min_support=MIN_SUPPORT, engine="level",
        num_devices=1)).run_file_raw(corpus + "D.dat")
    got, _, freq = oracle.mine(tokenized(_heavy_lines()), MIN_SUPPORT)
    want = {frozenset(freq[r] for r in s): c for s, c in got if len(s) >= 2}
    assert _as_sets(jlv, jdata.freq_items) == want
    return corpus, jlv, want


@pytest.mark.parametrize("reduce", ["dense", "sparse"])
@pytest.mark.parametrize("engine", ["level", "tail"])
@pytest.mark.parametrize("s", [2, 4, 8])
def test_heavy_rows_count_once_across_the_shards(s, engine, reduce,
                                                 heavy_reference):
    """The heavy remainder is counted by shard 0 alone, on the pair
    level, the bitmap levels and the tail fold, and the sparse
    reduction's pigeonhole thresholds carry it on shard 0's total: the
    levels stay those of one device."""
    corpus, jlv, want = heavy_reference
    got, data, miner = _mine(corpus, num_devices=s, count_reduce=reduce,
                             count_sparse_min=8, **ENGINES[engine])
    _levels_equal(got, jlv)
    assert _as_sets(got, data.freq_items) == want
    (build,) = _events(miner, "bitmap_build")
    assert build["heavy_rows"] == 3
    # The heavy rows lie on more than one shard.
    per = build["shape"][0] // s
    assert len({int(r) // per for r in np.flatnonzero(data.weights >= 128)}
               ) >= 2
    # The pigeonhole thresholds are those of the weight each shard
    # counts: its rows' w % 128, and on shard 0 the heavy remainder.
    t_pad = build["shape"][0]
    digits, scales, _, heavy_w = tapriori.split_weights(
        data.weights, t_pad, data.basket_indices, data.basket_offsets,
        data.num_items, miner.config.item_tile)
    counted = (digits.astype(np.int64) * np.asarray(scales)[:, None]).sum(
        axis=0).reshape(s, -1).sum(axis=1)
    counted[0] += int(heavy_w.sum())
    total = int(counted.sum())
    assert total == int(data.weights.sum())
    assert miner._sparse_thresholds(data, t_pad, heavy=True) == [
        max(1, -(-int(data.min_count) * int(c) // total)) for c in counted]
    assert _events(miner, "count_reduce")[0]["engine"] == reduce
    ev2 = _level2(miner)
    assert (ev2["reduce"] == "sparse"
            or ev2.get("fallback") == "sparse_overflow") == (
                reduce == "sparse")
    if engine == "tail":
        assert _events(miner, "tail_fuse")
    else:
        assert [e for e in _events(miner, "level") if e["k"] >= 3]


def _level2(miner):
    (ev,) = [e for e in _events(miner, "level") if e["k"] == 2]
    return ev


def test_auto_takes_the_sparse_exchange_from_two_shards(corpus):
    _, data, miner = _mine(corpus, num_devices=2, engine="level")
    assert _events(miner, "count_reduce") == [
        {"event": "count_reduce", "engine": "sparse", "requested": "auto"}]
    ev = _level2(miner)
    f_pad = 128
    cap = jcount.sparse_union_cap(f_pad * f_pad)
    assert ev["reduce"] == "sparse" and ev["exchange"] == "flat"
    assert 0 < ev["n_union"] <= cap
    g_b, p_b = jcount.sparse_psum_bytes(f_pad * f_pad, cap, 2, None)
    i_b, e_b = jcount.sparse_stage_bytes(f_pad * f_pad, cap, 2, None)
    assert (ev["gather_bytes"], ev["psum_bytes"]) == (g_b, p_b)
    assert (ev["intra_bytes"], ev["inter_bytes"]) == (i_b, e_b)
    snap = ledger.snapshot()
    assert [e["engine"] for e in snap if e["kind"] == "exchange_engine"] == [
        "flat"]


@pytest.mark.parametrize("shape,reason", [((1, 1), "one_txn_shard"),
                                          ((4, 2), "cand_mesh")])
def test_forced_sparse_falls_back_where_undefined(shape, reason, corpus,
                                                  reference, monkeypatch):
    monkeypatch.setenv("FA_COUNT_REDUCE", "sparse")
    n, c = shape
    got, _, miner = _mine(corpus, num_devices=n, cand_devices=c,
                          engine="level")
    _levels_equal(got, reference[0])
    fb = [e for e in ledger.snapshot() if e["kind"] == "count_reduce_fallback"]
    assert [e["reason"] for e in fb] == [reason]
    casc = [e for e in ledger.snapshot() if e["kind"] == "cascade"]
    assert [(e["chain"], e["frm"], e["to"]) for e in casc] == [
        ("count_reduce", "sparse", "dense")]
    assert _events(miner, "count_reduce")[0]["engine"] == "dense"


def test_sparse_overflow_redoes_dense_with_the_same_levels(
        corpus, reference, monkeypatch):
    monkeypatch.setenv("FA_COUNT_SPARSE_CAP", "1")
    got, _, miner = _mine(corpus, num_devices=2, engine="level",
                          count_sparse_min=8)
    _levels_equal(got, reference[0])
    over = [e for e in ledger.snapshot()
            if e["kind"] == "count_sparse_overflow"]
    assert {e["site"] for e in over} == {"pair", "level"}
    ev2 = _level2(miner)
    assert ev2["fallback"] == "sparse_overflow" and ev2["reduce"] == "dense"
    redone = [e for e in _events(miner, "level")
              if e.get("recount") == "union_overflow"]
    assert redone and all(e["sparse_overflow"] > 1 for e in redone)
    # The grown budget is remembered on the context: a second mine on it
    # starts above the overflowing cap.
    assert any(k[0] == "sparse_pair" for k in miner.ctx._pair_caps)


def test_eight_shards_auto_run_the_two_level_exchange(corpus, reference):
    got, _, miner = _mine(corpus, num_devices=8, engine="level")
    _levels_equal(got, reference[0])
    (ex,) = [e for e in ledger.snapshot() if e["kind"] == "exchange_engine"]
    assert (ex["engine"], ex["groups"], ex["per_group"]) == ("hier", 2, 4)
    ev = _level2(miner)
    assert ev["exchange"] == "hier" and ev["exchange_groups"] == 2
    f_pad = 128
    cap = jcount.sparse_union_cap(f_pad * f_pad)
    assert (ev["gather_bytes"], ev["psum_bytes"]) == jcount.sparse_psum_bytes(
        f_pad * f_pad, cap, 8, (2, 4))
    assert (ev["intra_bytes"], ev["inter_bytes"]) == \
        jcount.sparse_stage_bytes(f_pad * f_pad, cap, 8, (2, 4))


def test_exchange_groups_one_is_flat_and_moves_more_bytes(
        corpus, reference, monkeypatch):
    _, _, hier_miner = _mine(corpus, num_devices=8, engine="level")
    ledger.reset()
    monkeypatch.setenv("FA_EXCHANGE_GROUPS", "1")
    got, _, flat_miner = _mine(corpus, num_devices=8, engine="level")
    _levels_equal(got, reference[0])
    (ex,) = [e for e in ledger.snapshot() if e["kind"] == "exchange_engine"]
    assert (ex["engine"], ex["groups"], ex["per_group"]) == ("flat", 1, 8)
    flat, hier = _level2(flat_miner), _level2(hier_miner)
    assert flat["exchange"] == "flat"
    assert hier["gather_bytes"] < flat["gather_bytes"]
    assert hier["psum_bytes"] == flat["psum_bytes"]


def test_exhausted_sparse_fetch_walks_hier_flat_dense(corpus, reference,
                                                      monkeypatch):
    monkeypatch.setenv("FA_RETRY_BACKOFF_MS", "0")
    retry.reload_policy_from_env()
    # Every attempt of the first sparse level fetch fails: its retries
    # give up once, then the level recounts dense.
    failpoints.arm("fetch.level_bits_sparse",
                   f"oom*{retry.policy_from_env().max_attempts}")
    got, _, miner = _mine(corpus, num_devices=8, engine="level",
                          count_sparse_min=8)
    _levels_equal(got, reference[0])
    casc = [(e["chain"], e["frm"], e["to"], e["reason"])
            for e in ledger.snapshot() if e["kind"] == "cascade"]
    assert casc == [("exchange", "hier", "flat", "transient_exhausted"),
                    ("count_reduce", "sparse", "dense",
                     "transient_exhausted")]
    assert miner.ctx.exchange_spec is None
    redone = [e for e in _events(miner, "level")
              if e.get("recount") == "transient_exhausted"]
    assert len(redone) == 1 and redone[0]["reduce"] == "dense"
    # Later levels ran the flat sparse exchange.
    assert any(e.get("exchange") == "flat" for e in _events(miner, "level"))


@pytest.mark.parametrize("layout", ["bitmap", "vertical"])
def test_kernel_launch_fault_is_never_walked_around(layout, corpus,
                                                    monkeypatch):
    def boom(*_a, **_k):
        raise RuntimeError("RESOURCE_EXHAUSTED: injected at the launch")

    name = "vertical_level_local" if layout == "vertical" else "level_counts"
    monkeypatch.setattr(tapriori, name, boom)
    with pytest.raises(RuntimeError, match="injected at the launch"):
        _mine(corpus, num_devices=2, engine="level", mine_engine=layout)
    assert "cascade" not in ledger.summary()


def test_cand_mesh_keeps_the_bitmap_layout(corpus, reference, monkeypatch):
    monkeypatch.setenv("FA_MINE_ENGINE", "vertical")
    got, _, miner = _mine(corpus, num_devices=4, cand_devices=2,
                          engine="level")
    _levels_equal(got, reference[0])
    fb = [e for e in ledger.snapshot() if e["kind"] == "mine_engine_fallback"]
    assert [e["reason"] for e in fb] == ["cand_mesh"]
    assert _events(miner, "mine_engine")[0]["engine"] == "bitmap"
    # K1 ran once per mesh position: 4 per chunk.
    lv = [e for e in _events(miner, "level") if e["k"] >= 3]
    assert lv and all(e["launches"] % 4 == 0 for e in lv)


@pytest.mark.parametrize("s", [2, 4])
def test_sharded_device_scan_equals_the_host_scan(s, corpus):
    levels, data, miner = _mine(corpus, num_devices=s, engine="level")
    users = read_dat(corpus + "U.dat")
    rec = AssociationRules(data.freq_items, data.item_to_rank, levels,
                           data.item_counts,
                           config=MinerConfig(rec_batch_rows=32),
                           context=miner.ctx)
    host = rec.run(users, use_device=False)
    rec.metrics.enabled = True
    dev = rec.run(users, use_device=True)
    assert dev == host
    (fm,) = [r for r in rec.metrics.records
             if r["event"] == "first_match" and r["device"]]
    # One K2 launch per shard and block; blocks padded to whole shards.
    assert fm["shards"] == s and fm["launches"] and fm["launches"] % s == 0
    assert rec.row_multiple() == 32 * s
    for _, _, bm, _ in rec.micro_batches([np.array([0, 1])] * 5):
        assert bm.shape[0] % (32 * s) == 0


def test_sharded_rule_engine_runs_one_shard_join(corpus):
    from fastapriori_tpu_torch.rules import gen as tgen
    from fastapriori_tpu_torch.utils.logging import MetricsLogger

    levels, data, miner = _mine(corpus, num_devices=4, engine="level")
    m = MetricsLogger()
    mats = tgen._level_tables(levels, data.item_counts)
    got = tgen.rule_arrays_from_tables(
        mats, context=miner.ctx, config=MinerConfig(rule_engine="device"),
        metrics=m)
    want = tgen._rule_arrays_host(mats)
    assert len(got) == len(want)
    for (ga, gc, gf), (wa, wc, wf) in zip(got, want):
        assert np.array_equal(ga, wa) and np.array_equal(gc, wc)
        assert gf.tobytes() == wf.tobytes()
    (ev,) = [r for r in m.records if r["event"] == "rule_gen_engine"]
    assert (ev["shards"], ev["reason"]) == (1, "sharded_join_not_ported")


@pytest.mark.parametrize("flags", [("--num-devices", "4"),
                                   ("--num-devices", "4", "--cand-devices",
                                    "2"),
                                   ("--num-devices", "8", "--engine",
                                    "fused")])
def test_cli_on_shards_writes_the_jax_clis_bytes(flags, corpus, tmp_path):
    outs = {name: str(tmp_path / name) + "/" for name in ("torch", "jax")}
    for out in outs.values():
        os.makedirs(out)
    ms = str(MIN_SUPPORT)
    assert torch_main([corpus, outs["torch"], "--min-support", ms,
                       "--platform", "cpu", *flags]) == 0
    assert jax_main([corpus, outs["jax"], "--min-support", ms,
                     *JAX_FLAGS]) == 0
    exp_freq, exp_rec = oracle.run_pipeline(
        oracle.read_lines(corpus + "D.dat"),
        oracle.read_lines(corpus + "U.dat"), MIN_SUPPORT)
    for name, exp in (("freqItemset", exp_freq), ("recommends", exp_rec)):
        with open(outs["torch"] + name, "rb") as f:
            got = f.read()
        with open(outs["jax"] + name, "rb") as f:
            assert got == f.read()
        assert got == exp.encode("utf-8")


def test_serve_on_two_shards_answers_as_the_batch_run(corpus, tmp_path):
    batch = str(tmp_path / "batch") + "/"
    served = str(tmp_path / "served") + "/"
    os.makedirs(batch)
    os.makedirs(served)
    ms = str(MIN_SUPPORT)
    assert torch_main([corpus, batch, "--min-support", ms,
                       "--platform", "cpu"]) == 0
    assert torch_main(["serve", corpus, served, "--min-support", ms,
                       "--platform", "cpu", "--num-devices", "2",
                       "--serve-engine", "device", "--batch-rows",
                       "64"]) == 0
    with open(batch + "recommends", "rb") as f, \
            open(served + "recommends", "rb") as g:
        assert f.read() == g.read()


def test_serving_state_counts_a_launch_per_shard(corpus):
    from fastapriori_tpu_torch.serve import ServingState

    ctx = DeviceContext(devices=["cpu"] * 2)
    state = ServingState.from_mine(
        corpus + "D.dat", config=MinerConfig(min_support=MIN_SUPPORT,
                                             engine="level"),
        engine="device", context=ctx)
    state.warm()
    assert state.ctx is ctx and state.describe()["scan_shards"] == 2
    before = state.scan_dispatches
    users = read_dat(corpus + "U.dat")
    got = state.recommend_batch(users)
    delta = state.scan_dispatches - before
    assert delta > 0 and delta % 2 == 0
    batch = AssociationRules(state.freq_items, state.item_to_rank,
                             state.levels, state.item_counts,
                             device="cpu").run(users, use_device=False)
    assert got == [item for _, item in sorted(batch)]
