"""The frozen NumPy reference and the benchmark's generator, on the CPU.

The reference's two files must equal the port's CLI output byte for byte
on small seeded corpora of the configuration's shape; the generator is a
pure function of the configuration and the seed, and follows the Quest
procedure's published parameters.
"""

import json
import os

import numpy as np
import pytest

from portbench import gen
from portbench.reference import apriori
from portbench.tests.helpers import ROOT, TINY, card_present


def _cfg(name: str) -> dict:
    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                      name + ".json")))
    cfg.update(TINY[name])
    return cfg


def _cli(tmp_path, inputs: dict, cfg: dict, monkeypatch) -> tuple:
    from fastapriori_tpu_torch import cli

    d_in, d_out = tmp_path / "in", tmp_path / "out"
    d_in.mkdir(exist_ok=True)
    d_out.mkdir(exist_ok=True)
    (d_in / "D.dat").write_bytes(inputs["D.dat"])
    (d_in / "U.dat").write_bytes(inputs["U.dat"])
    for key, value in cfg.get("env", {}).items():
        monkeypatch.setenv(key, value)
    rc = cli.main([str(d_in) + "/", str(d_out) + "/", "--min-support",
                   repr(cfg["min_support"]), "--platform", "cpu"])
    assert rc == 0
    return ((d_out / "freqItemset").read_bytes(),
            (d_out / "recommends").read_bytes())


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40 + 17, 2**33 + 3])
def test_reference_equals_the_port(tmp_path, monkeypatch, seed):
    cfg = _cfg("t10i4d100k")
    inputs = gen.make_inputs(cfg, seed)
    ref = apriori.Result(inputs["D.dat"], inputs["U.dat"],
                         cfg["min_support"])
    assert len(ref.mined.levels) >= 2  # the corpus has multi-level work
    got = _cli(tmp_path, inputs, cfg, monkeypatch)
    assert got[0] == ref.freq_itemset
    assert got[1] == ref.recommends


def test_generator_is_a_function_of_the_seed():
    cfg = _cfg("t10i4d100k")
    a, b = gen.make_inputs(cfg, 123), gen.make_inputs(cfg, 123)
    c = gen.make_inputs(cfg, 124)
    assert a["D.dat"] == b["D.dat"] and a["U.dat"] == b["U.dat"]
    assert a["D.dat"] != c["D.dat"]
    # Another seed: the same rows and baskets under other names and in
    # another order, so the same amount of work.
    for key in ("D", "U"):
        assert np.array_equal(np.sort(a[key][1]), np.sort(c[key][1]))
    ra = apriori.Result(a["D.dat"], a["U.dat"], cfg["min_support"])
    rc = apriori.Result(c["D.dat"], c["U.dat"], cfg["min_support"])
    assert [lv.shape for lv, _ in ra.mined.levels] == \
        [lv.shape for lv, _ in rc.mined.levels]
    assert len(ra.rules) == len(rc.rules)


def test_user_baskets_are_the_repository_generators():
    from fastapriori_tpu_torch.utils.datagen import generate_user_baskets

    cfg = _cfg("t10i4d100k")
    want = "".join(line + "\n" for line in generate_user_baskets(
        n_users=cfg["n_users"], n_items=cfg["n_items"],
        seed=cfg["user_base_seed"]))
    assert gen.to_bytes(*gen.user_baskets(cfg)) == want.encode()


def test_quest_itemsets_follow_the_paper():
    """|L| itemsets of Poisson size |I|; each later one shares with the
    one before it about the correlation level's share of its items."""
    rng = np.random.default_rng(7)
    pats = gen.quest_itemsets(rng, 1000, 2000, 4.0, 0.5)
    sizes = np.array([p.size for p in pats])
    assert len(pats) == 2000 and sizes.min() >= 1
    assert abs(sizes.mean() - 4.0) < 0.2
    assert all(np.unique(p).size == p.size for p in pats)
    shared = [np.intersect1d(a, b).size / b.size
              for a, b in zip(pats, pats[1:])]
    # E[min(Exp(0.5), 1)] = 0.5 (1 - e^-2), rounding to whole items.
    assert 0.3 < float(np.mean(shared)) < 0.55


def test_quest_transactions_have_the_published_shape():
    cfg = _cfg("t10i4d100k")
    cfg.update(n_txns=20000, n_items=1000, min_support=0.0025)
    flat, lens = gen.quest_transactions(cfg)
    assert lens.size == 20000 and lens.min() >= 1
    assert abs(lens.mean() - cfg["avg_txn_len"]) < 0.5
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for s, n in zip(starts[:200], lens[:200]):
        row = flat[s:s + n]
        assert np.all(np.diff(row) > 0) and row.min() >= 1 \
            and row.max() <= cfg["n_items"]
    a, b = gen.quest_transactions(cfg), gen.quest_transactions(cfg)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("data", [
    b"1 2\n\n3\n", b"1  2\n", b"1 2", b"01 2\n", b" 1\n", b"1\t2\n", b"a\n"])
def test_parse_refuses_what_the_generator_never_writes(data):
    with pytest.raises(ValueError):
        apriori.parse_dat(data)


def test_parse_reads_lines_and_tokens():
    flat, lens = apriori.parse_dat(b"5 17 230\n9\n1000000 3\n")
    assert flat.tolist() == [5, 17, 230, 9, 1000000, 3]
    assert lens.tolist() == [3, 1, 2]


@pytest.mark.cuda
def test_a_batch_cell_runs_on_the_card(tmp_path):
    if not card_present():
        pytest.skip("needs a CUDA card")
    from portbench.tests.helpers import tiny_root
    from portbench import run

    root = tiny_root(tmp_path)
    assert run.main(["--workload", "t10-batch", "--seed", "9",
                     "--seconds", "2", "--trace", "0"], root=root) == 0
