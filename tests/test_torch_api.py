"""The object-form library API (README's calls) through both packages on
the same seeded corpora: ``FastApriori(s).run_file`` / ``run`` /
``mine_compressed`` give the JAX package's frozenset lists, item ranks
and item lists; ``gen_rules``, ``gen_rules_levels``, ``sort_rules`` and
``rule_objects_from_arrays`` give the JAX functions' rules and the
oracle's rule set; ``AssociationRules(itemsets, freq_items,
item_to_rank).run`` gives the JAX ``(row, item)`` pairs on the host scan
and on the device scan (K2's plain version on the CPU);
``save_freq_itemsets``, ``read_input_dir``, ``gen_candidates`` and
``CompressedData.baskets`` give equal bytes and arrays; both constructors
take the JAX argument order (``FastApriori(0.01, 2)`` is two devices);
without a CUDA device a call that did not ask for the CPU raises
InputError."""

import numpy as np
import pytest
import torch

from conftest import random_dataset, tokenized
from fastapriori_tpu import oracle
from fastapriori_tpu.config import MinerConfig as JaxConfig
from fastapriori_tpu.io import reader as jreader
from fastapriori_tpu.io import writer as jwriter
from fastapriori_tpu.models import candidates as jcand
from fastapriori_tpu.models.apriori import FastApriori as JaxApriori
from fastapriori_tpu.models.recommender import AssociationRules as JaxRules
from fastapriori_tpu.preprocess import preprocess as jax_preprocess
from fastapriori_tpu.rules import gen as jgen
from fastapriori_tpu_torch import AssociationRules, FastApriori, InputError
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.io import reader as treader
from fastapriori_tpu_torch.io import writer as twriter
from fastapriori_tpu_torch.models import candidates as tcand
from fastapriori_tpu_torch.ops.match_kernel import first_match
from fastapriori_tpu_torch.preprocess import preprocess
from fastapriori_tpu_torch.rules import gen as tgen
from fastapriori_tpu_torch.utils.datagen import generate_doc_transactions

CASES = {
    "quest": (lambda: random_dataset(3, n_items=14, n_txns=300), 0.04),
    "edges": (lambda: random_dataset(8, n_items=10, n_txns=120), 0.08),
    "docs": (lambda: generate_doc_transactions(
        n_txns=400, n_items=300, avg_txn_len=12, seed=5), 0.03),
}


def _corpus(tmp_path, case):
    make, ms = CASES[case]
    d_raw = make()
    u_raw = random_dataset(40, n_items=14, n_txns=90)
    (tmp_path / "D.dat").write_text("".join(x + "\n" for x in d_raw))
    (tmp_path / "U.dat").write_text("".join(x + "\n" for x in u_raw))
    return str(tmp_path) + "/", ms


def _jax_miner(ms):
    # One JAX device: the harness's eight virtual devices fail several
    # JAX engines on this jax version.
    return JaxApriori(ms, 1, config=JaxConfig(engine="level"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_file_run_and_mine_compressed_match_jax(tmp_path, case):
    prefix, ms = _corpus(tmp_path, case)
    want = _jax_miner(ms).run_file(prefix + "D.dat")
    got = FastApriori(ms, device="cpu").run_file(prefix + "D.dat")
    assert got[0] == want[0]
    assert got[1] == want[1] and got[2] == want[2]
    d_lines = treader.read_dat(prefix + "D.dat")
    assert FastApriori(ms, device="cpu").run(d_lines) == want
    assert _jax_miner(ms).run(d_lines) == want
    data = preprocess(d_lines, ms)
    assert FastApriori(ms, device="cpu").mine_compressed(data) == want[0]
    # The oracle's itemsets (its order: levels, then the 1-itemsets).
    o_sets, o_ranks, o_items = oracle.mine(d_lines, ms)
    assert sorted(got[0], key=lambda x: (len(x[0]), sorted(x[0]))) == \
        sorted(o_sets, key=lambda x: (len(x[0]), sorted(x[0])))
    assert (got[1], got[2]) == (o_ranks, o_items)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_functions_match_jax_and_oracle(case):
    make, ms = CASES[case]
    d_lines = tokenized(make())
    itemsets, _, freq_items = _jax_miner(ms).run(d_lines)
    rules = tgen.gen_rules(itemsets)
    assert rules == jgen.gen_rules(itemsets)
    assert set(rules) == set(oracle.gen_rules(itemsets))
    srt = tgen.sort_rules(rules, freq_items)
    assert srt == jgen.sort_rules(rules, freq_items)
    assert set(srt) == set(oracle.sort_rules(oracle.gen_rules(itemsets),
                                             freq_items))
    data = preprocess(d_lines, ms)
    levels = FastApriori(ms, device="cpu").mine_levels_raw(data)
    assert tgen.gen_rules_levels(levels, data.item_counts) == \
        jgen.gen_rules_levels(levels, data.item_counts)
    arrays = tgen.sort_rule_arrays(
        tgen.gen_rule_arrays_levels(levels, data.item_counts), freq_items)
    objs = tgen.rule_objects_from_arrays(*arrays)
    assert objs == jgen.rule_objects_from_arrays(*arrays)
    assert objs == srt
    back = tgen.rule_arrays_from_objects(objs)
    for a, b in zip(back[1:], arrays[1:]):
        assert np.array_equal(a, b)
    assert np.array_equal(back[0][:, :arrays[0].shape[1]], arrays[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_object_recommender_matches_jax_host_and_device(tmp_path, case):
    prefix, ms = _corpus(tmp_path, case)
    d_lines, u_lines = treader.read_input_dir(prefix)
    itemsets, item_to_rank, freq_items = FastApriori(
        ms, device="cpu").run_file(prefix + "D.dat")
    want = JaxRules(itemsets, freq_items, item_to_rank).run(
        u_lines, use_device=False)
    rec = AssociationRules(itemsets, freq_items, item_to_rank, device="cpu")
    assert rec.run(u_lines, use_device=False) == want
    first_match.launches = 0
    assert rec.run(u_lines, use_device=True) == want
    assert first_match.launches == 0  # the plain version on the CPU
    assert rec.sorted_rules == jgen.sort_rules(jgen.gen_rules(itemsets),
                                               freq_items)
    rules = oracle.gen_rules(itemsets)
    assert sorted(want) == sorted(oracle.recommend(u_lines, rules,
                                                   freq_items, item_to_rank))
    # The matrix form of the same mine gives the same answers.
    levels, data = FastApriori(ms, device="cpu").run_file_raw(prefix + "D.dat")
    mat = AssociationRules([], data.freq_items, data.item_to_rank,
                           levels=levels, item_counts=data.item_counts,
                           device="cpu")
    assert mat.run(u_lines, use_device=True) == want


def test_writer_reader_candidates_and_baskets_match_jax(tmp_path):
    prefix, ms = _corpus(tmp_path, "quest")
    got_d, got_u = treader.read_input_dir(prefix)
    assert (got_d, got_u) == jreader.read_input_dir(prefix)
    itemsets, _, freq_items = FastApriori(ms, device="cpu").run(got_d)
    twriter.save_freq_itemsets(str(tmp_path / "t-"), itemsets, freq_items)
    jwriter.save_freq_itemsets(str(tmp_path / "j-"), itemsets, freq_items)
    got = (tmp_path / "t-freqItemset").read_bytes()
    assert got == (tmp_path / "j-freqItemset").read_bytes()
    assert got.decode() == oracle.format_freq_itemsets(itemsets, freq_items)
    with twriter.open_write(str(tmp_path / "sub" / "x.txt")) as f:
        f.write("a\n")
    assert (tmp_path / "sub" / "x.txt").read_text() == "a\n"
    for k in (2, 3):
        k_items = [s for s, _ in itemsets if len(s) == k]
        f = len(freq_items)
        assert tcand.gen_candidates(k_items, f) == \
            jcand.gen_candidates(k_items, f)
    assert tcand.gen_candidates([], 4) == jcand.gen_candidates([], 4) == []
    t_data, j_data = preprocess(got_d, ms), jax_preprocess(got_d, ms)
    tb, jb = t_data.baskets, j_data.baskets
    assert len(tb) == len(jb) == t_data.total_count
    assert all(np.array_equal(a, b) for a, b in zip(tb, jb))


def test_constructors_take_the_jax_argument_order(tmp_path):
    prefix, ms = _corpus(tmp_path, "quest")
    port, jax_m = FastApriori(0.01, 2, device="cpu"), JaxApriori(0.01, 2)
    assert port.config.num_devices == jax_m.config.num_devices == 2
    assert port.context.txn_shards == 2
    assert port.set_min_support(ms) is port
    assert port.config.min_support == ms
    # S = 2 CPU shards, held against the JAX package at one device.
    assert port.run_file(prefix + "D.dat") == \
        _jax_miner(ms).run_file(prefix + "D.dat")
    assert port.set_num_devices(1) is port
    assert port.context.txn_shards == 1
    cfg = MinerConfig(min_support=0.5)
    m = FastApriori(None, None, cfg, None, device="cpu")
    assert m.config.min_support == 0.5 and m.config is not cfg
    itemsets, item_to_rank, freq_items = m.run_file(prefix + "D.dat")
    rec = AssociationRules(itemsets, freq_items, item_to_rank,
                           MinerConfig(rec_batch_rows=64), None,
                           device="cpu")
    assert rec.freq_itemsets == itemsets and rec.config.rec_batch_rows == 64
    assert rec.run(treader.read_dat(prefix + "U.dat")) == JaxRules(
        itemsets, freq_items, item_to_rank).run(
            jreader.read_dat(prefix + "U.dat"))


def test_api_without_a_card_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(InputError, match="CUDA"):
        FastApriori(0.1)
    with pytest.raises(InputError, match="CUDA"):
        FastApriori(0.1, 2)
    with pytest.raises(InputError, match="CUDA"):
        AssociationRules([(frozenset((0,)), 3)], ["1"], {"1": 0})
    miner = FastApriori(0.1, device="cpu")
    assert miner.context.platform == "cpu"
    assert miner.set_num_devices(2).context.platform == "cpu"
