"""The environment knobs the JAX package reads at one device, in the port,
held to the JAX package on the CPU:

- a value neither package knows in ``FA_NO_PALLAS``, ``FA_COUNT_REDUCE``,
  ``FA_VERTICAL_CHUNK`` or ``FA_VERTICAL_LANE_TILE`` makes both CLIs exit
  2; ``FA_REC_BATCH`` makes the port's CLI exit 2 and the JAX package's
  ``rec_batch_rows`` raise (its CLI reads the knob at one device only on
  the resident-table scan, whose sharded rule join fails on jax 0.9.0);
- under ``FA_REC_BATCH=64`` and ``FA_NO_PALLAS=1`` both CLIs write the
  same bytes, each with its device scan;
- ``FA_COUNT_REDUCE=sparse`` records the same ledger events in both
  packages (``count_reduce_fallback`` and the ``count_reduce`` cascade);
- after a run's InputError both CLIs leave ``<output>flight.json`` with
  the same reason;
- the plain K3's lane tiling equals the JAX package's
  ``_lane_tiled_counts`` and its Pallas kernel (interpret mode) exactly;
- ``FA_NO_PALLAS`` on a CUDA device makes the call sites run each
  kernel's plain version (the choice is made by ``_count_level`` and the
  recommender's scan, the wrappers stay strict) and records one
  ``pallas_disabled`` event; the bucketing of the vertical chunk, the
  lane tile and the scan batch is the JAX package's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dataset
from fastapriori_tpu.cli import main as jax_main
from fastapriori_tpu.config import MinerConfig as JaxConfig
from fastapriori_tpu.errors import InputError as JaxInputError
from fastapriori_tpu.models.apriori import FastApriori as JaxApriori
from fastapriori_tpu.models.recommender import (
    AssociationRules as JaxRules,
    bucket_batch_rows as jax_bucket_batch_rows,
)
from fastapriori_tpu.obs import flight as jax_flight
from fastapriori_tpu.ops import vertical as jv
from fastapriori_tpu.ops.pallas_vertical import vertical_counts_pallas
from fastapriori_tpu.reliability import ledger as jax_ledger
from fastapriori_tpu_torch import InputError
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.device import DeviceContext
from fastapriori_tpu_torch.models import recommender as rec_mod
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.models.recommender import (
    AssociationRules,
    bucket_batch_rows,
)
from fastapriori_tpu_torch.obs import flight
from fastapriori_tpu_torch.ops import count as count_mod
from fastapriori_tpu_torch.ops import level_kernel, match_kernel
from fastapriori_tpu_torch.ops import vertical as tv
from fastapriori_tpu_torch.ops import vertical_kernel
from fastapriori_tpu_torch.ops.vertical_kernel import vertical_counts_plain
from fastapriori_tpu_torch.reliability import ledger
from fastapriori_tpu_torch.utils.datagen import (
    generate_transactions,
    generate_user_baskets,
)
from fastapriori_tpu_torch.utils.env import env_flag
from test_torch_e2e import JAX_FLAGS
from test_torch_vertical import _k3_case

KNOBS = ("FA_NO_PALLAS", "FA_COUNT_REDUCE", "FA_REC_BATCH",
         "FA_VERTICAL_CHUNK", "FA_VERTICAL_LANE_TILE", "FA_MINE_ENGINE")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for led in (ledger, jax_ledger):
        led.reset()
    yield
    for led in (ledger, jax_ledger):
        led.reset()
    for fl in (flight, jax_flight):
        fl.set_dump_prefix(None)
        fl.RECORDER.reset(fl.RECORDER.cap)


def _deep_lines():
    """A lattice reaching k = 6 (a planted 6-itemset) plus noise."""
    return ["1 2 3 4 5 6"] * 50 + random_dataset(5, n_txns=110)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("knobs")
    (d / "D.dat").write_text("".join(x + "\n" for x in _deep_lines()))
    (d / "U.dat").write_text(
        "".join(x + "\n" for x in random_dataset(13, n_txns=30)))
    return str(d) + "/"


def _both(inp, out_dir, extra=()):
    """Both CLIs on ``inp``: ``(port rc, JAX rc)``, outputs under
    ``out_dir/{torch,jax}/``."""
    rc_t = torch_main([inp, str(out_dir / "torch") + "/", "--min-support",
                       "0.08", "--platform", "cpu", "--engine", "level",
                       *extra])
    rc_j = jax_main([inp, str(out_dir / "jax") + "/", "--min-support",
                     "0.08", *JAX_FLAGS, *extra])
    return rc_t, rc_j


# ---------------------------------------------------------------------------
# typos


@pytest.mark.parametrize("knob,value,layout", [
    ("FA_NO_PALLAS", "of", None),
    ("FA_COUNT_REDUCE", "sparce", None),
    ("FA_VERTICAL_CHUNK", "4k", "vertical"),
    ("FA_VERTICAL_LANE_TILE", "-128", "vertical"),
])
def test_knob_typo_exits_2_in_both_clis(knob, value, layout, corpus,
                                        tmp_path, monkeypatch, capsys):
    if layout:
        monkeypatch.setenv("FA_MINE_ENGINE", layout)
    monkeypatch.setenv(knob, value)
    assert _both(corpus, tmp_path) == (2, 2)
    err = capsys.readouterr().err
    assert err.count(knob) >= 2, err
    assert not (tmp_path / "torch" / "freqItemset").exists()


def test_rec_batch_typo(corpus, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FA_REC_BATCH", "lots")
    rc = torch_main([corpus, str(tmp_path) + "/", "--min-support", "0.08",
                     "--platform", "cpu"])
    assert rc == 2
    assert "FA_REC_BATCH" in capsys.readouterr().err
    rules = JaxRules([], ["1"], {"1": 0})
    with pytest.raises(JaxInputError, match="FA_REC_BATCH"):
        rules.rec_batch_rows()
    # The port reads it on every run: a typo fails whichever side
    # scans.
    monkeypatch.setattr(rec_mod, "device_scan_wanted", lambda *a: False)
    assert torch_main([corpus, str(tmp_path) + "/", "--min-support", "0.08",
                       "--platform", "cpu"]) == 2


@pytest.mark.parametrize("rows", [None, "0", "1", "33", "64", "5000"])
def test_rec_batch_rows_bucketing_is_the_jax_packages(rows, monkeypatch):
    if rows is not None:
        monkeypatch.setenv("FA_REC_BATCH", rows)
    cfg_rows = 100
    got = AssociationRules([], {}, [], [], device="cpu",
                           config=MinerConfig(rec_batch_rows=cfg_rows))
    want = JaxRules([], ["1"], {"1": 0},
                    config=JaxConfig(rec_batch_rows=cfg_rows))
    assert got.rec_batch_rows() == want.rec_batch_rows()
    for r in (0, 1, 31, 32, 33, 4096, 5000):
        assert bucket_batch_rows(r) == jax_bucket_batch_rows(r)


# ---------------------------------------------------------------------------
# equal bytes and equal ledger events


@pytest.fixture(scope="module")
def scan_corpus(tmp_path_factory):
    """Enough distinct baskets x rules (6,013 x 6,724) that the JAX
    package's CLI scans on its device too (from 3 * 10^7 checks)."""
    d = tmp_path_factory.mktemp("scan")
    (d / "D.dat").write_text("\n".join(generate_transactions(
        n_txns=3000, n_items=100, seed=5)) + "\n")
    (d / "U.dat").write_text("\n".join(generate_user_baskets(
        n_users=9000, n_items=100, seed=6)) + "\n")
    return str(d) + "/"


def test_rec_batch_and_no_pallas_write_the_same_bytes(scan_corpus, tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("FA_REC_BATCH", "64")
    monkeypatch.setenv("FA_NO_PALLAS", "1")
    rows = []
    real = AssociationRules.micro_batches

    def spy(self, baskets):
        for b in real(self, baskets):
            rows.append((b[1], b[2].shape[0]))
            yield b

    monkeypatch.setattr(AssociationRules, "micro_batches", spy)
    rc_t = torch_main([scan_corpus, str(tmp_path / "torch") + "/",
                       "--min-support", "0.02", "--platform", "cpu",
                       "--metrics"])
    rc_j = jax_main([scan_corpus, str(tmp_path / "jax") + "/",
                     "--min-support", "0.02", *JAX_FLAGS])
    assert (rc_t, rc_j) == (0, 0)
    for name in ("freqItemset", "recommends"):
        got = (tmp_path / "torch" / name).read_bytes()
        assert got and got == (tmp_path / "jax" / name).read_bytes()
    # The port's scan ran in micro-batches of 64 baskets, each padded to
    # the next power of two of its own baskets (at least 32); the CPU run
    # records no pallas_disabled (its wrappers run the plain versions
    # anyway).
    assert len(rows) > 1 and set(rows[:-1]) == {(64, 64)}
    last_n, last_rows = rows[-1]
    assert 0 < last_n <= 64
    assert last_rows == max(1 << (last_n - 1).bit_length(), 32)
    assert "pallas_disabled" not in ledger.summary()


def test_count_reduce_sparse_same_ledger_events(corpus, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("FA_COUNT_REDUCE", "sparse")
    assert _both(corpus, tmp_path) == (0, 0)
    kinds = ("count_reduce_fallback", "cascade")
    got = [e for e in ledger.snapshot() if e["kind"] in kinds]
    want = [e for e in jax_ledger.snapshot() if e["kind"] in kinds]
    assert got == want
    assert [e["kind"] for e in got] == list(kinds)
    assert got[0]["reason"] == "one_txn_shard"
    assert got[1]["chain"] == "count_reduce"
    for name in ("freqItemset", "recommends"):
        assert ((tmp_path / "torch" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


@pytest.mark.parametrize("value", ["auto", "dense"])
def test_count_reduce_dense_records_nothing(value, corpus, monkeypatch):
    monkeypatch.setenv("FA_COUNT_REDUCE", value)
    miner = FastApriori(config=MinerConfig(min_support=0.08,
                                           engine="level"), device="cpu")
    miner.run_file_raw(corpus + "D.dat")
    assert ledger.summary() == {}
    (ev,) = [r for r in miner.metrics.records if r["event"] == "count_reduce"]
    assert ev == {"event": "count_reduce", "engine": "dense",
                  "requested": value}


def test_count_reduce_config_strict(corpus):
    miner = FastApriori(config=MinerConfig(min_support=0.08, engine="level",
                                           count_reduce="sparce"),
                        device="cpu")
    with pytest.raises(InputError, match="count_reduce"):
        miner.run_file_raw(corpus + "D.dat")


@pytest.mark.parametrize("case", ["bad_knob", "bad_resume"])
def test_input_error_leaves_the_same_flight_dump(case, corpus, tmp_path,
                                                 monkeypatch):
    extra = ()
    if case == "bad_knob":
        monkeypatch.setenv("FA_COUNT_REDUCE", "sparce")
    else:
        extra = ("--resume-from", str(tmp_path / "nothing") + "/")
    assert _both(corpus, tmp_path, extra) == (2, 2)
    bodies = [json.loads((tmp_path / side / "flight.json").read_text())
              for side in ("torch", "jax")]
    assert bodies[0]["reason"] == bodies[1]["reason"] == "classified_error"
    for body in bodies:
        assert body["context"]["error"].startswith("InputError")
    manifest = json.loads(
        (tmp_path / "torch" / "MANIFEST.json").read_text())
    assert "flight.json" in manifest["artifacts"]


def test_no_flight_dump_without_a_registered_prefix(tmp_path, monkeypatch):
    # An InputError before the run registers its prefix (a bad knob the
    # CLI parses first) writes nothing, in both packages.
    monkeypatch.setenv("FA_TRACE", "maybe")
    (tmp_path / "D.dat").write_text("1 2\n")
    (tmp_path / "U.dat").write_text("1\n")
    flight.set_dump_prefix(None)
    jax_flight.set_dump_prefix(None)
    from fastapriori_tpu.obs import trace as jax_trace
    from fastapriori_tpu_torch.obs import trace

    trace.reload_from_env()
    jax_trace.reload_from_env()
    try:
        assert _both(str(tmp_path) + "/", tmp_path) == (2, 2)
    finally:
        monkeypatch.delenv("FA_TRACE")
        trace.reload_from_env()
        jax_trace.reload_from_env()
    assert not (tmp_path / "torch" / "flight.json").exists()
    assert not (tmp_path / "jax" / "flight.json").exists()


# ---------------------------------------------------------------------------
# lane tiling of the plain K3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("lane_tile", [128, 256, 384, 200])
@pytest.mark.parametrize("n_planes", [1, 3])
def test_lane_tiled_plain_k3_equals_the_jax_package(lane_tile, n_planes):
    arena, planes, prefix, cand = _k3_case(n_planes + 40, n_planes, nl=512)
    scales = tuple(1 << b for b in range(n_planes))
    args = (jnp.asarray(arena), jnp.asarray(planes), scales,
            jnp.asarray(prefix), jnp.asarray(cand))
    want = np.asarray(jv._lane_tiled_counts(*args, 64, lane_tile))
    got = vertical_counts_plain(
        _t(arena.view(np.int32)), _t(planes.view(np.int32)), scales,
        _t(prefix), _t(cand), cand_chunk=50, lane_tile=lane_tile).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    untiled = vertical_counts_plain(
        _t(arena.view(np.int32)), _t(planes.view(np.int32)), scales,
        _t(prefix), _t(cand), cand_chunk=50).numpy()
    assert np.array_equal(got, untiled)
    if lane_tile % 128 == 0:
        pallas = np.asarray(vertical_counts_pallas(
            jnp.asarray(arena), jnp.asarray(planes), jnp.asarray(prefix),
            jnp.asarray(cand), scales, cand_tile=128, lane_tile=lane_tile,
            interpret=True))
        assert np.array_equal(got, pallas)


def test_lane_tile_reaches_the_plain_version_through_the_wrapper(
        monkeypatch):
    arena, planes, prefix, cand = _k3_case(7, 2, nl=300)
    seen = []
    real = vertical_kernel.vertical_counts_plain

    def spy(*a):
        seen.append(a[5:])
        return real(*a)

    monkeypatch.setattr(vertical_kernel, "vertical_counts_plain", spy)
    out = vertical_kernel.vertical_counts(
        _t(arena.view(np.int32)), _t(planes.view(np.int32)), (1, 2),
        _t(prefix), _t(cand), 64, 128)
    assert seen == [(64, 128)]
    assert np.array_equal(out.numpy(), real(
        _t(arena.view(np.int32)), _t(planes.view(np.int32)), (1, 2),
        _t(prefix), _t(cand)).numpy())


@pytest.mark.parametrize("env,cfg", [
    ({}, {}),
    ({"FA_VERTICAL_CHUNK": "1000", "FA_VERTICAL_LANE_TILE": "300"}, {}),
    ({"FA_VERTICAL_CHUNK": "0"}, {"vertical_cand_chunk": 3,
                                  "vertical_lane_tile": 5}),
    ({}, {"vertical_cand_chunk": 1 << 16, "vertical_lane_tile": 1 << 14}),
])
def test_vertical_chunk_and_lane_tile_are_the_jax_packages(env, cfg,
                                                           monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = FastApriori(config=MinerConfig(**cfg), device="cpu")
    ref = JaxApriori(config=JaxConfig(num_devices=1, **cfg))
    assert port._vertical_lane_tile() == ref._vertical_lane_tile()
    for c_cap in (128, 384, 1000, 4096, 1 << 18):
        assert port._vertical_chunk(c_cap) == ref._vertical_chunk(c_cap)


# ---------------------------------------------------------------------------
# FA_NO_PALLAS at the call sites


def test_plain_kernels_parse_and_record(monkeypatch):
    ctx = DeviceContext("cpu")
    assert ctx.plain_kernels() is False
    monkeypatch.setenv("FA_NO_PALLAS", " Yes ")
    assert ctx.plain_kernels() is False  # the CPU: no event
    assert ledger.summary() == {}
    ctx.device = torch.device("cuda")  # the choice a CUDA context makes
    assert ctx.plain_kernels() is True
    assert ctx.plain_kernels() is True
    assert ledger.snapshot() == [{"kind": "pallas_disabled",
                                  "reason": "FA_NO_PALLAS",
                                  "value": " Yes "}]
    monkeypatch.setenv("FA_NO_PALLAS", "off")
    with pytest.raises(InputError, match="FA_NO_PALLAS"):
        ctx.plain_kernels()
    for raw, want in (("", False), ("0", False), ("no", False),
                      ("TRUE", True), ("on", True)):
        monkeypatch.setenv("FA_NO_PALLAS", raw)
        assert env_flag("FA_NO_PALLAS") is want


@pytest.mark.parametrize("layout", ["bitmap", "vertical"])
def test_no_pallas_runs_the_plain_versions_at_the_call_sites(
        layout, corpus, monkeypatch):
    """With plain_kernels() true (a CUDA device under FA_NO_PALLAS), the
    mine and the scan never call the kernel wrappers and still give the
    wrappers' results."""
    cfg = MinerConfig(min_support=0.08, engine="level", mine_engine=layout)
    want_levels, data = FastApriori(config=cfg, device="cpu").run_file_raw(
        corpus + "D.dat")
    rec = AssociationRules(data.freq_items, data.item_to_rank, want_levels,
                           data.item_counts, config=cfg, device="cpu")
    users = [x.split() for x in random_dataset(13, n_txns=30)]
    want_recs = rec.run(users, use_device=True)

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper ran under FA_NO_PALLAS")

    monkeypatch.setattr(DeviceContext, "plain_kernels", lambda self: True)
    monkeypatch.setattr(count_mod, "level_counts", refuse)
    monkeypatch.setattr(level_kernel, "level_counts", refuse)
    monkeypatch.setattr(vertical_kernel, "vertical_counts", refuse)
    monkeypatch.setattr(tv, "vertical_level_local", refuse)
    from fastapriori_tpu_torch.models import apriori as ap
    from fastapriori_tpu_torch.ops import contain

    monkeypatch.setattr(ap, "level_counts", refuse)
    monkeypatch.setattr(ap, "vertical_level_local", refuse)
    monkeypatch.setattr(contain, "first_match", refuse)
    monkeypatch.setattr(rec_mod, "first_match", refuse)
    monkeypatch.setattr(match_kernel, "first_match", refuse)
    miner = FastApriori(config=cfg, device="cpu")
    got_levels, data = miner.run_file_raw(corpus + "D.dat")
    assert len(got_levels) == len(want_levels) >= 4
    for (gm, gc), (wm, wc) in zip(got_levels, want_levels):
        assert np.array_equal(gm, wm) and np.array_equal(gc, wc)
    # The levels _count_level counted (not the pair program's).
    levels = [r for r in miner.metrics.records
              if r["event"] == "level" and "p_cap" in r]
    assert levels and all(r["plain_kernels"] for r in levels)
    rec = AssociationRules(data.freq_items, data.item_to_rank, got_levels,
                           data.item_counts, config=cfg, device="cpu")
    assert rec.run(users, use_device=True) == want_recs
    (fm,) = [r for r in rec.metrics.records if r["event"] == "first_match"]
    assert fm["plain_kernels"] is True


def test_vertical_level_events_carry_vops_and_member_bytes(corpus):
    cfg = MinerConfig(min_support=0.08, engine="level",
                      mine_engine="vertical")
    miner = FastApriori(config=cfg, device="cpu")
    miner.run_file_raw(corpus + "D.dat")
    (arena,) = [r for r in miner.metrics.records
                if r["event"] == "arena_build"]
    nl = arena["shape"][1]
    levels = [r for r in miner.metrics.records
              if r["event"] == "level" and r["k"] >= 3]
    assert levels
    for r in levels:
        assert r["engine"] == "vertical"
        if not r["launches"]:
            assert r["vops"] == r["member_bytes_saved"] == 0
            continue
        # One launch a level on this corpus: its P is the level's p_cap.
        assert r["launches"] == 1
        p, k = r["p_cap"], r["k"] - 1
        assert r["member_bytes_saved"] == tv.vertical_member_bytes(1, p, nl)
        assert r["member_bytes_saved"] == jv.vertical_member_bytes(1, p, nl)
        assert r["vops"] == jv.vertical_level_word_ops(
            1, p, k, r["candidates"], arena["planes"], nl)
