"""The port's synthetic generators against the JAX package's: the doc
corpus (zipf marginals with planted head patterns) and its block
iterator give the same lines, line for line, over a few seeds and
shapes, with a block smaller than the corpus and more head items than
items; the quest-style and user-basket generators likewise; and the
MovieLens-shape files chip_smoke.py writes hash to the JAX generators'
files' digests."""

import hashlib
import importlib.util
import os

import pytest

from fastapriori_tpu.utils import datagen as jd
from fastapriori_tpu_torch.utils import datagen as td


@pytest.mark.parametrize("kw", [
    dict(n_txns=500, n_items=300, avg_txn_len=20, seed=1),
    dict(n_txns=1_000, n_items=2_000, avg_txn_len=40, seed=2017),
    dict(n_txns=300, n_items=50, avg_txn_len=30, head_items=400, seed=7),
    dict(n_txns=200, n_items=5, avg_txn_len=4, n_patterns=3, seed=3),
], ids=["small", "wide", "head-past-items", "tiny-vocab"])
def test_doc_transactions_match_jax(kw):
    got = td.generate_doc_transactions(**kw)
    assert len(got) == kw["n_txns"]
    assert got == jd.generate_doc_transactions(**kw)


@pytest.mark.parametrize("block", [64, 250, 10_000])
def test_doc_blocks_match_jax(block):
    kw = dict(n_txns=700, n_items=900, avg_txn_len=25, zipf_s=1.2,
              pattern_frac=0.3, seed=11, block=block)
    got = list(td.iter_doc_transaction_blocks(**kw))
    want = list(jd.iter_doc_transaction_blocks(**kw))
    assert [len(b) for b in got] == [len(b) for b in want]
    assert got == want
    if block < kw["n_txns"]:
        assert len(got) > 1


@pytest.mark.parametrize("seed", [0, 42])
def test_quest_and_user_generators_match_jax(seed):
    kw = dict(n_txns=400, n_items=120, avg_txn_len=8, seed=seed)
    assert td.generate_transactions(**kw) == jd.generate_transactions(**kw)
    assert td.generate_user_baskets(n_users=300, n_items=120, seed=seed) \
        == jd.generate_user_baskets(n_users=300, n_items=120, seed=seed)


def test_chip_smoke_movielens_files_are_the_jax_generators():
    """chip_smoke.py phase 15 holds the files its prep child writes with
    the port's generators to these SHA-256s, which the JAX generators'
    files have (generated at full size, 162,000 document lines)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_consts", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ml = cs.MOVIELENS
    d = td.generate_doc_transactions(
        n_txns=ml["n_txns"], n_items=ml["n_items"],
        avg_txn_len=ml["avg_txn_len"], seed=ml["seed"])
    assert hashlib.sha256(("\n".join(d) + "\n").encode()).hexdigest() == \
        ml["d_sha256"]
    del d
    u = td.generate_user_baskets(n_users=ml["n_users"], n_items=ml["n_items"],
                                 seed=ml["user_seed"])
    assert hashlib.sha256(("\n".join(u) + "\n").encode()).hexdigest() == \
        ml["u_sha256"]
    assert u == jd.generate_user_baskets(
        n_users=ml["n_users"], n_items=ml["n_items"], seed=ml["user_seed"])
