"""Per-level checkpoints, resume and the phase-1 artifacts of the port,
held against the JAX package on the CPU: the checkpoint's round trip,
truncation, a stale manifest and a meta mismatch; the phase-1 artifacts'
manifest checks and a remote (``memory://``) prefix; one-shot resume;
the CLI killed at ``level.k`` and resumed; a torn phase 1; a resume from
nothing; a kill in the middle of a count drain; the fused engine's
checkpoint segments killed at a segment boundary; ``--save-counts`` then
``--resume-from`` the phase-1 artifacts; and each package resuming from
a checkpoint the other wrote, with the same output bytes."""

import os

import numpy as np
import pytest

from conftest import random_dataset
from fastapriori_tpu.cli import main as jax_main
from fastapriori_tpu.config import MinerConfig as JaxConfig
from fastapriori_tpu.io import checkpoint as jax_ckpt
from fastapriori_tpu.models.apriori import FastApriori as JaxApriori
from fastapriori_tpu.reliability import failpoints as jax_failpoints
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.io import checkpoint as ckpt
from fastapriori_tpu_torch.io import resume as resume_io
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.reliability import failpoints, ledger

JAX_FLAGS = ("--platform", "cpu", "--engine", "level", "--num-devices", "1")
MIN_SUPPORT = "0.08"


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.disarm_all()
    jax_failpoints.disarm_all()
    ledger.reset()
    yield
    failpoints.disarm_all()
    jax_failpoints.disarm_all()
    ledger.reset()


def _meta(n_raw=100, min_count=5, num_items=7):
    return {"n_raw": n_raw, "min_count": min_count, "num_items": num_items}


def _levels():
    return [
        (np.array([[0, 1], [0, 2]], np.int32), np.array([9, 8], np.int64)),
        (np.array([[0, 1, 2]], np.int32), np.array([7], np.int64)),
    ]


# ---------------------------------------------------------------------------
# io/checkpoint.py and io/resume.py


def test_checkpoint_round_trip_and_the_jax_layout(tmp_path):
    prefix = str(tmp_path) + "/"
    ckpt.save_checkpoint(prefix, _levels(), _meta())
    assert ckpt.checkpoint_available(prefix)
    got, meta = ckpt.load_checkpoint(prefix)
    assert meta == _meta()
    for (m0, c0), (m1, c1) in zip(_levels(), got):
        assert m1.dtype == np.int32 and np.array_equal(m0, m1)
        assert c1.dtype == np.int64 and np.array_equal(c0, c1)
    with np.load(prefix + "checkpoint.npz") as z:
        assert sorted(z.files) == ["cnt_0", "cnt_1", "mat_0", "mat_1",
                                   "meta"]
        assert z["meta"].dtype == np.int64
        assert z["meta"].tolist() == [2, 100, 5, 7, 0]  # fence 0
    # The JAX package loads it, and the port loads the JAX package's.
    jax_levels, jax_meta = jax_ckpt.load_checkpoint(prefix)
    assert jax_meta == _meta() and len(jax_levels) == 2
    other = str(tmp_path / "jax") + "/"
    jax_ckpt.save_checkpoint(other, _levels(), _meta())
    assert ckpt.validate_checkpoint(other) == _meta()


def test_checkpoint_truncation_rejected(tmp_path):
    prefix = str(tmp_path) + "/"
    failpoints.arm("write.checkpoint.npz", "truncate@40")
    ckpt.save_checkpoint(prefix, _levels()[:1], _meta())
    with pytest.raises(InputError, match="checkpoint.npz"):
        ckpt.load_checkpoint(prefix)


def test_checkpoint_survives_a_stale_manifest(tmp_path):
    """A crash between the checkpoint's replace and the manifest's
    rewrite: level 3's npz under level 2's manifest entry loads, with a
    ledger event."""
    prefix = str(tmp_path) + "/"
    ckpt.save_checkpoint(prefix, _levels()[:1], _meta())
    stale = open(prefix + "MANIFEST.json", "rb").read()
    ckpt.save_checkpoint(prefix, _levels(), _meta())
    with open(prefix + "MANIFEST.json", "wb") as f:
        f.write(stale)
    levels, meta = ckpt.load_checkpoint(prefix)
    assert len(levels) == 2 and meta == _meta()
    assert ledger.summary() == {"checkpoint_manifest_stale": 1}


def test_checkpoint_meta_mismatch_rejected(tmp_path):
    prefix = str(tmp_path) + "/"
    ckpt.save_checkpoint(prefix, _levels(), _meta())
    _, meta = ckpt.load_checkpoint(prefix)
    with pytest.raises(InputError, match="different data/support"):
        ckpt.check_meta(meta, n_raw=101, min_count=5, num_items=7,
                        prefix=prefix)


def test_validate_checkpoint_rejects_a_corrupt_lattice(tmp_path):
    prefix = str(tmp_path) + "/"
    bad = [(np.array([[0, 9]], np.int32), np.array([9], np.int64))]
    ckpt.save_checkpoint(prefix, bad, _meta())
    with pytest.raises(InputError, match="item ranks"):
        ckpt.validate_checkpoint(prefix)
    low = [(np.array([[0, 1]], np.int32), np.array([2], np.int64))]
    ckpt.save_checkpoint(prefix, low, _meta())
    with pytest.raises(InputError, match="below min_count"):
        ckpt.validate_checkpoint(prefix)


def test_phase1_round_trip_truncation_and_corrupt_manifest(tmp_path):
    prefix = str(tmp_path) + "/"
    itemsets = [(frozenset([0, 1]), 7), (frozenset([2]), 5)]
    items, ranks = ["a", "b", "c"], {"a": 0, "b": 1, "c": 2}
    resume_io.save_phase1(prefix, itemsets, items, ranks)
    got_sets, got_ranks, got_items = resume_io.load_phase1(prefix)
    assert sorted(got_sets) == sorted(itemsets)
    assert got_ranks == ranks and got_items == items
    with open(prefix + "FreqItems", "r+b") as f:
        f.write(b"Z")
    with pytest.raises(InputError, match="FreqItems"):
        resume_io.load_phase1(prefix)
    failpoints.arm("write.freqItems", "truncate@7")
    resume_io.save_phase1(prefix, itemsets, items, ranks)
    assert os.path.getsize(prefix + "freqItems") == 7
    with pytest.raises(InputError, match="manifest"):
        resume_io.load_phase1(prefix)
    for corrupt in ("{not json", "[]", '{"artifacts": 3}'):
        with open(prefix + "MANIFEST.json", "w") as f:
            f.write(corrupt)
        with pytest.raises(InputError, match="MANIFEST"):
            resume_io.load_phase1(prefix)


def test_remote_prefix_through_fsspec():
    pytest.importorskip("fsspec")
    prefix = "memory://fa_torch_checkpoint/"
    ckpt.save_checkpoint(prefix, _levels(), _meta())
    assert ckpt.checkpoint_available(prefix)
    levels, meta = ckpt.load_checkpoint(prefix)
    assert meta == _meta() and len(levels) == 2
    resume_io.save_phase1(prefix, [(frozenset([0]), 3)], ["a"], {"a": 0})
    assert set(resume_io.load_manifest(prefix)) == {
        "checkpoint.npz", "freqItems", "FreqItems", "ItemsToRank"}
    assert resume_io.load_phase1(prefix)[0] == [(frozenset([0]), 3)]


def test_remote_prefix_without_fsspec_names_it(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_fsspec(name, *a, **k):
        if name == "fsspec":
            raise ImportError("no fsspec here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_fsspec)
    with pytest.raises(InputError, match="requires fsspec"):
        ckpt.checkpoint_available("gs://bucket/run/")


def test_phase1_levels_are_the_miner_form():
    itemsets = [(frozenset([2]), 4), (frozenset([0]), 6),
                (frozenset([1, 2]), 3), (frozenset([0, 2]), 5),
                (frozenset([0, 1, 2]), 2), (frozenset([0, 1]), 4)]
    levels, item_counts = resume_io.phase1_levels(itemsets, 3)
    assert item_counts.tolist() == [6, 0, 4]
    assert levels[0][0].tolist() == [[0, 1], [0, 2], [1, 2]]
    assert levels[0][1].tolist() == [4, 5, 3]
    assert levels[1][0].tolist() == [[0, 1, 2]]


# ---------------------------------------------------------------------------
# resume in the API


def _deep_lines():
    return ["1 2 3 4 5 6"] * 50 + random_dataset(5, n_txns=110)


@pytest.fixture
def corpus(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    (d / "D.dat").write_text("".join(x + "\n" for x in _deep_lines()))
    (d / "U.dat").write_text(
        "".join(x + "\n" for x in random_dataset(13, n_txns=30)))
    return str(d) + "/"


def _miner(**knobs):
    return FastApriori(config=MinerConfig(min_support=float(MIN_SUPPORT),
                                          **knobs), device="cpu")


def _levels_equal(got, want):
    assert len(got) == len(want)
    for (gm, gc), (wm, wc) in zip(got, want):
        assert np.array_equal(gm, wm) and np.array_equal(gc, wc)


def test_checkpoint_written_every_level_and_resumed_once(corpus, tmp_path):
    prefix = str(tmp_path / "ck") + "/"
    clean = _miner(engine="level").run_file_raw(corpus + "D.dat")[0]
    failpoints.arm("level.4", "abort")
    miner = _miner(checkpoint_prefix=prefix)
    with pytest.raises(failpoints.InjectedAbort, match="level.4"):
        miner.run_file_raw(corpus + "D.dat")
    ks = [r["k"] for r in miner.metrics.records if r["event"] ==
          "checkpoint"]
    assert ks == [2, 3, 4]
    failpoints.disarm_all()
    levels, meta = ckpt.load_checkpoint(prefix)
    assert [m.shape[1] for m, _ in levels] == [2, 3, 4]
    _levels_equal(levels, clean[:3])
    resumed = _miner()
    resumed.set_resume_levels(levels, meta, label=prefix)
    got = resumed.run_file_raw(corpus + "D.dat")[0]
    _levels_equal(got, clean)
    assert [r["from_k"] for r in resumed.metrics.records
            if r["event"] == "level_resume"] == [5]
    assert not any(r["event"] == "level" and r["k"] <= 4
                   for r in resumed.metrics.records)
    assert resumed._resume_levels is None  # consumed
    again = resumed.run_file_raw(corpus + "D.dat")[0]  # a full mine
    _levels_equal(again, clean)


# The card's fold threshold (``tail_fuse_rows`` None is 65,536 on CUDA):
# every seed of the corpus is under it, so the tail fold would take the
# levels after 3 in one program.
CARD_FOLD_ROWS = 1 << 16


def _commits(miner):
    return [r for r in miner.metrics.records if r["event"] == "checkpoint"]


@pytest.mark.parametrize("engine", ["auto", "level"])
def test_every_level_commits_under_the_cards_fold_threshold(
        corpus, tmp_path, engine):
    """Under a checkpoint prefix no tail fold runs outside the fused
    engine's segments: one commit per level 2..L, each one level deeper,
    each span's ``bytes`` the npz it wrote."""
    clean = _miner(engine="level").run_file_raw(corpus + "D.dat")[0]
    prefix = str(tmp_path / "ck") + "/"
    miner = _miner(engine=engine, checkpoint_prefix=prefix,
                   tail_fuse_rows=CARD_FOLD_ROWS)
    got = miner.run_file_raw(corpus + "D.dat")[0]
    _levels_equal(got, clean)
    deepest = clean[-1][0].shape[1]
    commits = _commits(miner)
    assert [r["k"] for r in commits] == list(range(2, deepest + 1))
    assert [r["levels"] for r in commits] == list(range(1, deepest))
    assert not any(r["event"] in ("tail_fuse", "fused_mine")
                   for r in miner.metrics.records)
    assert commits[-1]["bytes"] == os.path.getsize(prefix + "checkpoint.npz")
    assert all(r["bytes"] > 0 for r in commits)
    _levels_equal(ckpt.load_checkpoint(prefix)[0], clean)


def test_kill_inside_the_fold_range_then_resume(corpus, tmp_path):
    """A ``level.5`` abort where the card would fold levels 4-6 finds
    levels 2-5 committed; the resume (folding again, as it may without a
    prefix) gives the clean levels."""
    clean = _miner(engine="level").run_file_raw(corpus + "D.dat")[0]
    prefix = str(tmp_path / "ck") + "/"
    failpoints.arm("level.5", "abort")
    miner = _miner(checkpoint_prefix=prefix, tail_fuse_rows=CARD_FOLD_ROWS)
    with pytest.raises(failpoints.InjectedAbort, match="level.5"):
        miner.run_file_raw(corpus + "D.dat")
    failpoints.disarm_all()
    assert [r["k"] for r in _commits(miner)] == [2, 3, 4, 5]
    levels, meta = ckpt.load_checkpoint(prefix)
    _levels_equal(levels, clean[:4])
    resumed = _miner(tail_fuse_rows=CARD_FOLD_ROWS)
    resumed.set_resume_levels(levels, meta, label=prefix)
    _levels_equal(resumed.run_file_raw(corpus + "D.dat")[0], clean)
    assert [r["from_k"] for r in resumed.metrics.records
            if r["event"] == "level_resume"] == [6]


def test_fused_segments_hold_under_the_cards_fold_threshold(corpus,
                                                            tmp_path):
    """``engine="fused"`` keeps its cadence segments, whatever the tail
    fold's threshold: one commit per segment."""
    clean = _miner(engine="level").run_file_raw(corpus + "D.dat")[0]
    prefix = str(tmp_path / "ck") + "/"
    miner = _miner(engine="fused", checkpoint_prefix=prefix,
                   checkpoint_every_levels=2, tail_fuse_rows=CARD_FOLD_ROWS)
    _levels_equal(miner.run_file_raw(corpus + "D.dat")[0], clean)
    segs = [r for r in miner.metrics.records if r["event"] == "tail_fuse"]
    assert segs and all(r["checkpoint_segment"] and r["l_max"] == 2
                        for r in segs)
    assert len(_commits(miner)) == 2 + len(segs)


def test_resume_meta_mismatch_is_input_error(corpus, tmp_path):
    prefix = str(tmp_path / "ck") + "/"
    failpoints.arm("level.2", "abort")
    with pytest.raises(failpoints.InjectedAbort):
        _miner(checkpoint_prefix=prefix).run_file_raw(corpus + "D.dat")
    failpoints.disarm_all()
    levels, meta = ckpt.load_checkpoint(prefix)
    other = tmp_path / "other.dat"
    other.write_text("".join(x + "\n" for x in _deep_lines()[:80]))
    resumed = _miner()
    resumed.set_resume_levels(levels, meta, label=prefix)
    with pytest.raises(InputError, match="different data/support"):
        resumed.run_file_raw(str(other))


@pytest.mark.parametrize("layout", ["bitmap", "vertical"])
def test_kill_mid_drain_then_resume(corpus, tmp_path, layout):
    """A checkpointed twin killed after level 3; a deferred run killed in
    its first drain; the resume (drains still on) gives the clean
    levels, which are the JAX package's."""
    prefix = str(tmp_path / "ck") + "/"
    knobs = dict(engine="level", mine_engine=layout)
    clean = _miner(**knobs).run_file_raw(corpus + "D.dat")[0]
    failpoints.arm("level.3", "abort")
    with pytest.raises(failpoints.InjectedAbort):
        _miner(checkpoint_prefix=prefix, **knobs).run_file_raw(
            corpus + "D.dat")
    failpoints.disarm_all()
    failpoints.arm("drain.counts", "abort")
    with pytest.raises(failpoints.InjectedAbort, match="drain.counts"):
        _miner(pending_fetch_budget_bytes=1, **knobs).run_file_raw(
            corpus + "D.dat")
    failpoints.disarm_all()
    levels, meta = ckpt.load_checkpoint(prefix)
    resumed = _miner(pending_fetch_budget_bytes=1, **knobs)
    resumed.set_resume_levels(levels, meta, label=prefix)
    got = resumed.run_file_raw(corpus + "D.dat")[0]
    assert any(r["event"] == "counts_drain" for r in resumed.metrics.records)
    _levels_equal(got, clean)
    jax_cfg = JaxConfig(min_support=float(MIN_SUPPORT), engine="level",
                        num_devices=1, mine_engine=layout)
    _levels_equal(got, JaxApriori(config=jax_cfg).run_file_raw(
        corpus + "D.dat")[0])


def test_fused_checkpoint_cadence_controls_segments(corpus, tmp_path):
    clean = _miner(engine="level").run_file_raw(corpus + "D.dat")[0]
    counts = {}
    for cadence in (1, 3):
        prefix = str(tmp_path / f"c{cadence}") + "/"
        miner = _miner(engine="fused", checkpoint_prefix=prefix,
                       checkpoint_every_levels=cadence)
        _levels_equal(miner.run_file_raw(corpus + "D.dat")[0], clean)
        segs = [r for r in miner.metrics.records
                if r["event"] == "tail_fuse" and r["checkpoint_segment"]]
        assert segs and all(r["l_max"] == cadence for r in segs)
        assert all(r["levels"] <= cadence for r in segs)
        assert not any(r["event"] == "fused_mine"
                       for r in miner.metrics.records)
        counts[cadence] = len(segs)
    assert counts[1] > counts[3]
    assert "cascade" not in ledger.summary()


def test_fused_segment_overflow_degrades_to_per_level(corpus, tmp_path):
    clean = _miner(engine="level").run_file_raw(corpus + "D.dat")[0]
    got = _miner(engine="fused", checkpoint_prefix=str(tmp_path) + "/",
                 checkpoint_every_levels=2, min_prefix_bucket=1,
                 fused_hbm_budget_bytes=1 << 14).run_file_raw(
                     corpus + "D.dat")[0]
    _levels_equal(got, clean)
    casc = [e for e in ledger.snapshot() if e["kind"] == "cascade"]
    assert any(e["chain"] == "engine" and e["to"] == "level" for e in casc)


# ---------------------------------------------------------------------------
# the CLI


def _run_jax(inp, out, *args):
    os.makedirs(out, exist_ok=True)
    return jax_main([inp, out, "--min-support", MIN_SUPPORT, *JAX_FLAGS,
                     *args])


def _run_torch(inp, out, *args):
    os.makedirs(out, exist_ok=True)
    return torch_main([inp, out, "--min-support", MIN_SUPPORT, "--platform",
                       "cpu", *args])


def _same_bytes(a, b, names=("freqItemset", "recommends")):
    for name in names:
        assert open(a + name, "rb").read() == open(b + name, "rb").read(), \
            name


@pytest.fixture
def jax_clean(corpus, tmp_path):
    out = str(tmp_path / "jax_clean") + "/"
    assert _run_jax(corpus, out) == 0
    return out


def test_cli_kill_at_a_level_then_resume(corpus, tmp_path, jax_clean,
                                         capsys):
    out = str(tmp_path / "ck") + "/"
    failpoints.arm("level.3", "abort")
    assert _run_torch(corpus, out, "--checkpoint-every-level") == 1
    assert "level.3" in capsys.readouterr().err
    failpoints.disarm_all()
    assert os.path.exists(out + "checkpoint.npz")
    assert not os.path.exists(out + "freqItemset")
    assert ckpt.validate_checkpoint(out)["min_count"] > 0
    assert _run_torch(corpus, out, "--resume-from", out) == 0
    _same_bytes(out, jax_clean)
    assert "freqItemset" in resume_io.load_manifest(out)


def test_cli_resume_across_packages(corpus, tmp_path, jax_clean):
    """Each package resumes from a checkpoint the other wrote and writes
    the JAX CLI's bytes."""
    jax_out = str(tmp_path / "jax_ck") + "/"
    jax_failpoints.arm("level.4", "abort")
    with pytest.raises(jax_failpoints.InjectedAbort):
        _run_jax(corpus, jax_out, "--checkpoint-every-level")
    jax_failpoints.disarm_all()
    assert [m.shape[1] for m, _ in ckpt.load_checkpoint(jax_out)[0]] == \
        [2, 3, 4]
    assert _run_torch(corpus, jax_out, "--resume-from", jax_out) == 0
    _same_bytes(jax_out, jax_clean)

    torch_out = str(tmp_path / "torch_ck") + "/"
    failpoints.arm("level.3", "abort")
    assert _run_torch(corpus, torch_out, "--checkpoint-every-level") == 1
    failpoints.disarm_all()
    assert _run_jax(corpus, torch_out, "--resume-from", torch_out) == 0
    _same_bytes(torch_out, jax_clean)


def test_cli_fused_checkpoint_killed_at_a_segment_boundary(
        corpus, tmp_path, jax_clean):
    out = str(tmp_path / "ck") + "/"
    flags = ("--engine", "fused", "--checkpoint-every-level",
             "--checkpoint-cadence", "2")
    failpoints.arm("level.5", "abort")  # the first segment: levels 4, 5
    assert _run_torch(corpus, out, *flags) == 1
    failpoints.disarm_all()
    levels, _ = ckpt.load_checkpoint(out)
    assert [m.shape[1] for m, _ in levels] == [2, 3, 4, 5]
    assert _run_torch(corpus, out, *flags, "--resume-from", out) == 0
    _same_bytes(out, jax_clean)


def test_cli_save_counts_then_phase1_resume(corpus, tmp_path, jax_clean):
    """``--save-counts`` writes the JAX CLI's phase-1 artifacts; a resume
    from them runs the recommend phase alone, in both packages, with the
    same recommends."""
    out = str(tmp_path / "p1") + "/"
    assert _run_torch(corpus, out, "--save-counts") == 0
    jax_p1 = str(tmp_path / "jax_p1") + "/"
    assert _run_jax(corpus, jax_p1, "--save-counts") == 0
    _same_bytes(out, jax_p1, ("freqItemset", "freqItems", "FreqItems"))
    assert set(open(out + "ItemsToRank").read().split("\n")) == \
        set(open(jax_p1 + "ItemsToRank").read().split("\n"))
    for pkg, run in (("torch", _run_torch), ("jax", _run_jax)):
        rec_out = str(tmp_path / f"rec_{pkg}") + "/"
        assert run(corpus, rec_out, "--resume-from", out) == 0
        assert not os.path.exists(rec_out + "freqItemset")
        _same_bytes(rec_out, jax_clean, ("recommends",))


def test_cli_truncated_phase1_artifact_rejected(corpus, tmp_path, capsys):
    out = str(tmp_path / "p1") + "/"
    failpoints.arm("write.freqItems", "truncate@25")
    assert _run_torch(corpus, out, "--save-counts") == 0
    failpoints.disarm_all()
    assert _run_torch(corpus, out, "--resume-from", out) == 2
    err = capsys.readouterr().err
    assert "freqItems" in err and "manifest" in err.lower()


def test_cli_torn_phase1_falls_back_to_checkpoint(corpus, tmp_path,
                                                  jax_clean):
    out = str(tmp_path / "ck") + "/"
    failpoints.arm("level.3", "abort")
    assert _run_torch(corpus, out, "--checkpoint-every-level") == 1
    failpoints.disarm_all()
    with open(out + "freqItems", "w") as f:  # freqItems without its aux
        f.write("a[1]\n")
    assert _run_torch(corpus, out, "--resume-from", out) == 0
    _same_bytes(out, jax_clean)


def test_cli_resume_from_nothing_is_input_error(corpus, tmp_path, capsys):
    out = str(tmp_path / "out") + "/"
    assert _run_torch(corpus, out, "--resume-from",
                      str(tmp_path / "empty") + "/") == 2
    assert "neither" in capsys.readouterr().err
