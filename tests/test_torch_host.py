"""The port's host layer against the JAX package's, on the same inputs:
reader, preprocess, datagen, candidate generation, rule generation and
priority sort, and the byte-exact writers (exact equality throughout)."""

import pytest

from conftest import random_dataset
from fastapriori_tpu import preprocess as jpre
from fastapriori_tpu.io import reader as jreader
from fastapriori_tpu.io import writer as jwriter
from fastapriori_tpu.models import candidates as jcand
from fastapriori_tpu.rules import gen as jgen
from fastapriori_tpu.utils import datagen as jdatagen
from fastapriori_tpu.utils import order as jorder
from fastapriori_tpu_torch import preprocess as tpre
from fastapriori_tpu_torch.io import reader as treader
from fastapriori_tpu_torch.io import writer as twriter
from fastapriori_tpu_torch.models import candidates as tcand
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.rules import gen as tgen
from fastapriori_tpu_torch.utils import datagen as tdatagen
from fastapriori_tpu_torch.utils import order as torder

ADVERSARIAL = [
    "", "  ", "1 2 3", "\t4\t5 ", "\x01 7 \x01", "8\xa0 9", "a b\rc",
    "10 \x0b 11", "12\x0c13", " 3   1  3 ",
]


def test_reader_matches(tmp_path):
    for line in ADVERSARIAL:
        assert treader.tokenize_line(line) == jreader.tokenize_line(line)
    content = "\n".join(ADVERSARIAL) + "\n\x1c\x85tail"
    assert treader.split_lines_java(content) == jreader.split_lines_java(
        content
    )
    path = tmp_path / "D.dat"
    path.write_text(content)
    assert treader.read_dat(str(path)) == jreader.read_dat(str(path))


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_preprocess_matches(seed):
    lines = [treader.tokenize_line(x) for x in random_dataset(seed)]
    got = tpre.preprocess(lines, 0.08)
    want = jpre.preprocess(lines, 0.08, native=False)
    assert (got.n_raw, got.min_count) == (want.n_raw, want.min_count)
    assert got.freq_items == want.freq_items
    assert got.item_to_rank == want.item_to_rank
    for name in ("item_counts", "basket_indices", "basket_offsets",
                 "weights"):
        assert (getattr(got, name) == getattr(want, name)).all()
    users = [treader.tokenize_line(x)
             for x in random_dataset(seed + 10, n_txns=25)]
    tb, ti, te = tpre.dedup_user_baskets(users, got.item_to_rank)
    jb, ji, je = jpre.dedup_user_baskets(users, want.item_to_rank)
    assert ti == ji and te == je
    assert all((a == b).all() for a, b in zip(tb, jb)) and len(tb) == len(jb)


def test_item_order_matches():
    pairs = [("10", 3), ("9", 3), ("x", 3), ("2", 5), ("b", 1), ("a", 1)]
    assert sorted(pairs, key=torder.item_sort_key) == sorted(
        pairs, key=jorder.item_sort_key
    )
    items = ["10", "9", "x", "2", "b", "a", "007"]
    assert (tgen._consequent_priority(items)
            == jgen._consequent_priority(items)).all()


def test_datagen_matches():
    kw = dict(n_txns=2500, n_items=120, seed=11)
    assert tdatagen.generate_transactions(**kw) == (
        jdatagen.generate_transactions(**kw)
    )
    kw = dict(n_users=700, n_items=120, seed=12)
    assert tdatagen.generate_user_baskets(**kw) == (
        jdatagen.generate_user_baskets(**kw)
    )


def _levels(seed, min_support):
    lines = tdatagen.generate_transactions(n_txns=1500, n_items=60,
                                           seed=seed)
    data = tpre.preprocess([treader.tokenize_line(x) for x in lines],
                           min_support)
    return FastApriori(device="cpu").mine_levels_raw(data), data


@pytest.mark.parametrize("seed", [1, 2])
def test_candidates_match(seed):
    levels, _ = _levels(seed, 0.02)
    assert len(levels) >= 3
    for mat, _ in levels:
        tx, ty = tcand.gen_candidates_arrays(mat)
        jx, jy = jcand.gen_candidates_arrays(mat)
        assert (tx == jx).all() and (ty == jy).all()


@pytest.mark.parametrize("seed", [1, 2])
def test_rules_match(seed):
    levels, data = _levels(seed, 0.02)
    got = tgen.gen_rule_arrays_levels(levels, data.item_counts)
    want = jgen.gen_rule_arrays_levels(levels, data.item_counts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape and (a == b).all()
    ts = tgen.sort_rule_arrays(got, data.freq_items)
    js = jgen.sort_rule_arrays(want, data.freq_items)
    assert len(ts[1]) > 100
    for a, b in zip(ts, js):
        assert (a == b).all()


def test_writers_match(tmp_path):
    levels, data = _levels(3, 0.03)
    recs = [(5, "12"), (0, "0"), (2, "x"), (1, "7")]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tp, jp = str(tmp_path / "t") + "/", str(tmp_path / "j") + "/"
    tm, jm = {}, {}
    twriter.save_freq_itemsets_levels(tp, levels, data.freq_items,
                                      manifest=tm)
    jwriter.save_freq_itemsets_levels(jp, levels, data.item_counts,
                                      data.freq_items, manifest=jm)
    twriter.save_recommends(tp, recs, manifest=tm)
    jwriter.save_recommends(jp, recs, manifest=jm)
    assert tm == jm
    for name in ("freqItemset", "recommends"):
        assert (tmp_path / "t" / name).read_bytes() == (
            tmp_path / "j" / name
        ).read_bytes()
