"""The port's quorum domain (fastapriori_tpu_torch/reliability/quorum.py)
in one process on the CPU, held to the JAX package's in-process quorum
tests (tests/test_reliability.py, tests/test_hier_exchange.py): the wire
order, forward-only positions, most-degraded-wins adoption with the
originating rank, the monotonic epoch trail, a lost peer bounded and
named, the exit marker, divergence bounded without consensus and
lockstep with it, fences (monotonic, a stale writer and a stale resume
refused, unfenced checkpoints still loading), the strict knobs, elastic
continuation (survivors go on, budget 0 re-raises, exhaustion clamps,
writer handoff, a straggler fenced out), the miner's level-boundary
clamps and elastic re-seed, the weight-total exchange, the torch
transport over a stand-in process group, and one file domain shared by a
JAX rank and a port rank.  Ranks are domains of this process, each with
its own FileTransport on one directory; their rendezvous run in
threads."""

import os
import threading
import time

import numpy as np
import pytest

from fastapriori_tpu.reliability import ledger as jax_ledger
from fastapriori_tpu.reliability import quorum as jq
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.io import checkpoint as ckpt
from fastapriori_tpu_torch.io import resume as resume_io
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.obs import flight
from fastapriori_tpu_torch.parallel import hier, mesh
from fastapriori_tpu_torch.reliability import (
    failpoints,
    ledger,
    quorum,
    retry,
    watchdog,
)
from fastapriori_tpu_torch.utils.datagen import generate_transactions


@pytest.fixture(autouse=True)
def _clean_state():
    def clean():
        quorum.set_domain(None)
        jq.set_domain(None)
        failpoints.disarm_all()
        ledger.reset()
        jax_ledger.reset()
        retry.reload_policy_from_env()

    clean()
    yield
    clean()


@pytest.fixture
def qroot(tmp_path, monkeypatch):
    """Tight bounds: one exchange waits at most 1 s, heartbeats every
    40 ms."""
    monkeypatch.setenv("FA_QUORUM_TIMEOUT_S", "1.0")
    monkeypatch.setenv("FA_HEARTBEAT_MS", "40")
    return str(tmp_path / "q")


def _dom(root, rank, n, consensus=True):
    return quorum.QuorumDomain(quorum.FileTransport(root, rank, n), rank, n,
                               consensus=consensus)


def _pair(root, consensus=True):
    return _dom(root, 0, 2, consensus), _dom(root, 1, 2, consensus)


def _meet(doms, site):
    """``site`` as a rendezvous of every domain, one thread each."""
    errs = []

    def go(d):
        try:
            d.sync(site, wait=True)
        except (quorum.PeerLost, quorum.MeshDivergence) as e:
            errs.append(e)

    threads = [threading.Thread(target=go, args=(d,)) for d in doms[1:]]
    for t in threads:
        t.start()
    go(doms[0])
    for t in threads:
        t.join(30)
    return errs


def _meta(n_raw=100, min_count=5, num_items=7):
    return {"n_raw": n_raw, "min_count": min_count, "num_items": num_items}


LEVELS = [(np.array([[0, 1]], np.int32), np.array([9], np.int64))]


# ---------------------------------------------------------------------------
# positions and consensus


def test_quorum_wire_order_pinned():
    """The position vector's chain order is the protocol, the JAX
    package's; every chain is in the cascade table."""
    assert quorum.CONSENSUS_CHAINS == jq.CONSENSUS_CHAINS == (
        "engine", "mine_engine", "count_reduce", "rule_engine", "exchange",
        "elastic", "vertical_kernel")
    for chain in quorum.CONSENSUS_CHAINS:
        assert len(watchdog.CHAINS[chain]) == len(jq_chain(chain))


def jq_chain(chain):
    from fastapriori_tpu.reliability import watchdog as jax_watchdog

    return jax_watchdog.CHAINS[chain]


def test_quorum_positions_forward_only(qroot):
    d = _dom(qroot, 0, 1)
    assert d.floor_stage("engine") == "fused"
    d.propose("engine", "level", "test")
    assert d.floor_stage("engine") == "level"
    assert not d.stage_allowed("engine", "fused")
    assert not d.stage_allowed("engine", "tail")
    assert d.stage_allowed("engine", "level")
    d.propose("engine", "tail", "test")  # never back up the chain
    assert d.floor_stage("engine") == "level"
    d.propose("rule_scan", "host", "test")  # host-local: ignored
    assert "rule_scan" not in d._pos
    d.close()


def test_quorum_most_degraded_wins_with_originating_rank(qroot):
    d0, d1 = _pair(qroot)
    try:
        d1.propose("count_reduce", "dense", "transient_exhausted")
        t = threading.Thread(target=lambda: d1.sync("level.3"))
        t.start()
        d0.sync("level.3")
        t.join(10)
        assert d0.floor_stage("count_reduce") == "dense"
        events = ledger.snapshot()
        adopt = [e for e in events if e["kind"] == "quorum_adopt"]
        assert adopt and adopt[0]["chain"] == "count_reduce"
        assert adopt[0]["rank"] == 1
        casc = [e for e in events
                if e["kind"] == "cascade" and e.get("reason") == "quorum"]
        assert casc and casc[0]["src_rank"] == 1
    finally:
        d0.close()
        d1.close()


def test_quorum_downgrade_composes_with_cascade(qroot):
    """watchdog.downgrade is the proposal channel: a local walk of a
    consensus chain publishes at once; a host-local chain does not."""
    d0, d1 = _pair(qroot)
    quorum.set_domain(d0)
    try:
        watchdog.downgrade("engine", "fused", "level",
                           reason="transient_exhausted")
        assert d0.floor_stage("engine") == "level"
        t = threading.Thread(target=lambda: d1.sync("level.2"))
        t.start()
        t.join(10)
        assert d1.floor_stage("engine") == "level"
        watchdog.downgrade("rule_scan", "device", "host", reason="x")
        assert "rule_scan" not in d0._pos
    finally:
        quorum.set_domain(None)
        d0.close()
        d1.close()


def test_quorum_epoch_monotonic(qroot):
    d0, d1 = _pair(qroot)
    try:
        for k in (2, 3, 4):
            t = threading.Thread(target=lambda k=k: d1.sync(f"level.{k}"))
            t.start()
            d0.sync(f"level.{k}")
            t.join(10)
        trail = d0.epoch_trail()
        assert [e["site"] for e in trail] == ["level.2", "level.3",
                                              "level.4"]
        epochs = [e["epoch"] for e in trail]
        assert epochs == sorted(epochs) and len(set(epochs)) == len(epochs)
        assert [e["kind"] for e in flight.snapshot()].count("quorum") >= 3
    finally:
        d0.close()
        d1.close()


# ---------------------------------------------------------------------------
# lost peers and divergence


def test_quorum_peer_lost_bounded_naming_rank(qroot):
    """A rendezvous with a peer that never starts: a classified
    PeerLost naming rank 1 within attempts x FA_QUORUM_TIMEOUT_S."""
    d0 = _dom(qroot, 0, 2)
    try:
        t0 = time.monotonic()
        with pytest.raises(quorum.PeerLost, match="rank 1") as ei:
            d0.sync("run.start", wait=True)
        assert time.monotonic() - t0 < 8.0
        assert ei.value.rank == 1 and ei.value.site == "run.start"
        assert str(ei.value).startswith("UNAVAILABLE")
        assert retry.classify(ei.value) == "transient"
        assert any(e["kind"] == "peer_lost" for e in ledger.snapshot())
    finally:
        d0.close()


def test_quorum_peer_exit_marker_fails_fast(qroot):
    d0, d1 = _pair(qroot)
    d1.close("crashed")
    try:
        t0 = time.monotonic()
        with pytest.raises(quorum.PeerLost, match="rank 1"):
            d0.sync("mine.end", wait=True)
        assert time.monotonic() - t0 < 2.0
    finally:
        d0.close()


def test_divergence_without_consensus_bounded_with_consensus_lockstep(
        qroot):
    """Rank 1 walked the engine chain and rank 0 did not: without
    consensus a bounded, classified MeshDivergence; with it, both ranks
    at the degraded floor."""
    nc0, nc1 = _pair(qroot + ".nc", consensus=False)
    nc1.propose("engine", "level", "injected")
    t0 = time.monotonic()
    errs = _meet([nc0, nc1], "level.4")
    assert any(isinstance(e, quorum.MeshDivergence) for e in errs)
    assert time.monotonic() - t0 < 8.0
    for e in errs:
        if isinstance(e, quorum.MeshDivergence):
            assert retry.classify(e) == "transient"
    nc0.close()
    nc1.close()
    ok0, ok1 = _pair(qroot + ".ok", consensus=False)
    assert _meet([ok0, ok1], "level.2") == []
    ok0.close()
    ok1.close()
    ledger.reset()
    c0, c1 = _pair(qroot + ".c")
    c1.propose("engine", "level", "injected")
    assert _meet([c0, c1], "level.4") == []
    assert c0.floor_stage("engine") == c1.floor_stage("engine") == "level"
    assert any(e["kind"] == "quorum_adopt" and e["rank"] == 1
               for e in ledger.snapshot())
    c0.close()
    c1.close()


# ---------------------------------------------------------------------------
# fences


def test_fence_monotonic_and_stale_writer_rejected(qroot):
    old = _dom(qroot, 0, 2)
    fence_old = old.checkpoint_fence()
    new = _dom(qroot, 0, 2)
    assert new.checkpoint_fence() == fence_old + 1
    with pytest.raises(quorum.StaleFenceError, match="checkpoint fence"):
        old.checkpoint_fence()
    assert isinstance(quorum.StaleFenceError("x"), InputError)
    assert new.checkpoint_fence() == fence_old + 1
    old.close()
    new.close()


def test_writer_fence_none_off_writer_and_epoch_untouched(qroot):
    assert quorum.writer_fence() is None
    r1 = _dom(qroot, 1, 2)
    quorum.set_domain(r1)
    try:
        assert quorum.writer_fence() is None
        assert r1.transport.current_fence() == 0
        r0 = _dom(qroot, 0, 2)
        quorum.set_domain(r0)
        assert quorum.writer_fence() == 1
        assert quorum.writer_fence() == 1  # acquired once per run
        r0.close()
    finally:
        quorum.set_domain(None)
        r1.close()


def test_checkpoint_fence_roundtrip_and_stale_resume_rejected(tmp_path,
                                                              qroot):
    prefix = str(tmp_path / "out") + "/"
    writer = _dom(qroot, 0, 2)
    fence = writer.checkpoint_fence()
    ckpt.save_checkpoint(prefix, LEVELS, dict(_meta(), fence=fence))
    assert resume_io.manifest_fence(prefix) == fence
    quorum.set_domain(writer)
    _, meta = ckpt.load_checkpoint(prefix)
    assert meta["fence"] == fence
    ckpt.check_meta(meta, prefix=prefix, **_meta())
    _dom(qroot, 0, 2).checkpoint_fence()  # a newer writer
    with pytest.raises(quorum.StaleFenceError, match="stale checkpoint"):
        ckpt.load_checkpoint(prefix)
    quorum.set_domain(None)
    _, meta2 = ckpt.load_checkpoint(prefix)  # no domain: informational
    assert meta2["fence"] == fence
    writer.close()


def test_checkpoint_unfenced_stays_compatible(tmp_path):
    prefix = str(tmp_path) + "/"
    ckpt.save_checkpoint(prefix, LEVELS, _meta())
    assert resume_io.manifest_fence(prefix) is None
    _, meta = ckpt.load_checkpoint(prefix)
    assert "fence" not in meta


# ---------------------------------------------------------------------------
# knobs and names


@pytest.mark.parametrize("knob,value,match", [
    ("FA_QUORUM_TIMEOUT_S", "soon", "FA_QUORUM_TIMEOUT_S"),
    ("FA_QUORUM_TIMEOUT_S", "0.0", "out of range"),
    ("FA_HEARTBEAT_MS", "fast", "FA_HEARTBEAT_MS"),
    ("FA_EPOCH_RETRY_MAX", "-1", "out of range"),
    ("FA_EPOCH_RETRY_MAX", "two", "FA_EPOCH_RETRY_MAX"),
])
def test_quorum_knob_strictness(knob, value, match, monkeypatch):
    monkeypatch.setenv(knob, value)
    fn = {"FA_QUORUM_TIMEOUT_S": quorum.quorum_timeout_s,
          "FA_HEARTBEAT_MS": quorum.heartbeat_ms,
          "FA_EPOCH_RETRY_MAX": quorum.epoch_retry_max}[knob]
    with pytest.raises(InputError, match=match):
        fn()


@pytest.mark.parametrize("procs,rank,match", [
    ("2", "2", "FA_QUORUM_RANK=2 is out of range"),
    ("x", "0", "FA_QUORUM_PROCS"),
    ("2", "-1", "FA_QUORUM_RANK"),
])
def test_quorum_domain_knobs_out_of_range(procs, rank, match, tmp_path,
                                          monkeypatch):
    """The JAX package's message for a rank outside the domain; the
    rank and the size parse strictly."""
    monkeypatch.setenv("FA_QUORUM_DIR", str(tmp_path / "q"))
    monkeypatch.setenv("FA_QUORUM_PROCS", procs)
    monkeypatch.setenv("FA_QUORUM_RANK", rank)
    quorum.reload_from_env()
    with pytest.raises(InputError, match=match):
        quorum.active()
    quorum.set_domain(None)


def test_quorum_resolves_file_domain_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("FA_QUORUM_DIR", str(tmp_path / "q"))
    monkeypatch.setenv("FA_QUORUM_PROCS", "2")
    monkeypatch.setenv("FA_QUORUM_RANK", "1")
    quorum.reload_from_env()
    try:
        dom = quorum.active()
        assert isinstance(dom.transport, quorum.FileTransport)
        assert (dom.rank, dom.nprocs) == (1, 2) and not quorum.is_writer()
        assert quorum.rank_path("t.json") == "t.rank1.json"
    finally:
        quorum.shutdown("done")
    assert os.path.exists(str(tmp_path / "q" / "exit.1"))
    monkeypatch.delenv("FA_QUORUM_DIR")
    assert quorum.active() is None and quorum.is_writer()


def test_quorum_rank_path_suffix(qroot):
    assert quorum.rank_path("out.trace.json") == "out.trace.json"
    dom = _dom(qroot, 1, 2)
    quorum.set_domain(dom)
    try:
        assert quorum.rank_suffix() == ".rank1"
        assert quorum.rank_path("out.trace.json") == "out.trace.rank1.json"
        assert quorum.rank_path("noext") == "noext.rank1"
    finally:
        quorum.set_domain(None)
        dom.close()


# ---------------------------------------------------------------------------
# elastic continuation


def _survive(dom, site):
    while True:
        try:
            dom.sync(site, wait=True)
            return
        except (quorum.PeerLost, quorum.MeshEpochAbort) as exc:
            dom.elastic_rejoin(exc)


def test_elastic_rejoin_survivors_continue(qroot, monkeypatch):
    monkeypatch.setenv("FA_EPOCH_RETRY_MAX", "2")
    d0, d1, d2 = (_dom(qroot, r, 3) for r in range(3))
    d2.close("crash")
    t = threading.Thread(target=lambda: _survive(d1, "level.2"))
    t.start()
    _survive(d0, "level.2")
    t.join(30)
    assert (d0.mesh_epoch, d1.mesh_epoch) == (1, 1)
    assert d0.members == [0, 1] and d1.members == [0, 1]
    assert d0.is_writer() and not d1.is_writer()
    assert _meet([d0, d1], "level.3") == []
    names = os.listdir(qroot)
    assert any("e1.level.3" in n for n in names), names
    assert not any("e0.level.3" in n for n in names), names
    ev = [e for e in ledger.snapshot() if e["kind"] == "mesh_epoch"]
    assert ev and ev[0]["epoch"] == 1 and ev[0]["dead"] == [2]
    assert ev[0]["members"] == [0, 1]
    assert any(e.get("mesh_epoch") == 1 for e in d0.epoch_trail())
    assert any(e["kind"] == "mesh_epoch" for e in flight.snapshot())
    d0.close()
    d1.close()


def test_elastic_disabled_budget_zero_reraises(qroot):
    d0 = _dom(qroot, 0, 2)
    quorum.set_domain(d0)
    try:
        assert not quorum.elastic_enabled()
        exc = quorum.PeerLost(1, "level.2", "peer exited")
        with pytest.raises(quorum.PeerLost) as ei:
            d0.elastic_rejoin(exc)
        assert ei.value is exc
        assert d0.mesh_epoch == 0 and d0.members == [0, 1]
        assert not any(e["kind"] == "cascade" and e.get("chain") == "elastic"
                       for e in ledger.snapshot())
    finally:
        quorum.set_domain(None)
        d0.close()


def test_elastic_exhaustion_classifies_and_clamps(qroot, monkeypatch):
    monkeypatch.setenv("FA_EPOCH_RETRY_MAX", "1")
    d0 = _dom(qroot, 0, 2)
    quorum.set_domain(d0)
    try:
        assert quorum.elastic_enabled()
        d0.mesh_epoch = 1  # one retry spent
        exc = quorum.PeerLost(1, "level.4", "no heartbeat")
        with pytest.raises(quorum.PeerLost) as ei:
            d0.elastic_rejoin(exc)
        assert ei.value is exc
        casc = [e for e in ledger.snapshot()
                if e["kind"] == "cascade" and e.get("chain") == "elastic"]
        assert casc and (casc[0]["frm"], casc[0]["to"]) == ("continue",
                                                            "abort")
        assert not d0.stage_allowed("elastic", "continue")
        d0.mesh_epoch = 0
        with pytest.raises(quorum.PeerLost):
            d0.elastic_rejoin(quorum.PeerLost(1, "level.5", "exited"))
    finally:
        quorum.set_domain(None)
        d0.close()
    d = _dom(qroot + ".x", 0, 2)
    d.mesh_epoch = 1
    with pytest.raises(quorum.PeerLost, match="retry budget exhausted"):
        d.elastic_rejoin(quorum.MeshEpochAbort(2, [1], "level.3", "peer"))
    d.close()


def test_elastic_writer_handoff_fences_preabort_artifacts(tmp_path, qroot,
                                                          monkeypatch):
    monkeypatch.setenv("FA_EPOCH_RETRY_MAX", "1")
    prefix = str(tmp_path / "out") + "/"
    d0, d1 = _pair(qroot)
    quorum.set_domain(d0)
    fence = d0.checkpoint_fence()
    ckpt.save_checkpoint(prefix, LEVELS, dict(_meta(), fence=fence))
    resume_io.save_phase1(prefix, [(frozenset([0]), 3)], ["a"], {"a": 0})
    assert resume_io.manifest_fence(prefix) == fence
    d0.close("crash")
    quorum.set_domain(d1)
    d1.elastic_rejoin(quorum.PeerLost(0, "level.3", "peer exited"))
    assert d1.members == [1] and d1.is_writer()
    assert d1.transport.current_fence() == fence + 1  # eager re-acquire
    with pytest.raises(quorum.StaleFenceError, match="stale checkpoint"):
        ckpt.load_checkpoint(prefix)
    with pytest.raises(quorum.StaleFenceError, match="stale checkpoint"):
        resume_io.load_phase1(prefix)
    with pytest.raises(quorum.StaleFenceError, match="checkpoint fence"):
        d0.checkpoint_fence()
    quorum.set_domain(None)
    d1.close()


def test_elastic_straggler_fenced_out(qroot, monkeypatch):
    monkeypatch.setenv("FA_EPOCH_RETRY_MAX", "1")
    d0, d1 = _pair(qroot)
    d0.elastic_rejoin(quorum.PeerLost(1, "level.2", "no heartbeat"))
    assert d0.members == [0] and d0.mesh_epoch == 1
    with pytest.raises(quorum.StaleFenceError, match="fenced this rank out"):
        _survive(d1, "level.2")
    d0.close()
    d1.close()


def test_elastic_refused_in_a_torch_world(qroot, monkeypatch):
    """The ranks of a --distributed world hold rows no survivor has: a
    lost peer there stays classified, even with a file domain."""
    monkeypatch.setenv("FA_EPOCH_RETRY_MAX", "2")
    d0 = _dom(qroot, 0, 2)
    quorum.set_domain(d0)
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    try:
        assert not quorum.elastic_enabled()
        exc = quorum.PeerLost(1, "level.2", "peer exited")
        with pytest.raises(quorum.PeerLost) as ei:
            d0.elastic_rejoin(exc)
        assert ei.value is exc and d0.mesh_epoch == 0
    finally:
        quorum.set_domain(None)
        d0.close()


# ---------------------------------------------------------------------------
# the miner in a domain


def _corpus(tmp_path):
    path = tmp_path / "D.dat"
    path.write_text("".join(
        x + "\n" for x in ["3 5 8 13 21 34"] * 60
        + generate_transactions(n_txns=540, n_items=40, seed=17)))
    return str(path)


def _levels_equal(got, want):
    assert len(got) == len(want)
    for (gm, gc), (wm, wc) in zip(got, want):
        assert np.array_equal(gm, wm)
        assert np.array_equal(np.asarray(gc, np.int64), np.asarray(wc))


CLAMPS = {
    # chain proposed by the peer at level.3 -> (miner knobs, ledger kind)
    "mine_engine": ({"engine": "level", "mine_engine": "vertical"},
                    "mine_engine_fallback"),
    "count_reduce": ({"engine": "level", "num_devices": 2,
                      "count_reduce": "sparse", "count_sparse_min": 8},
                     "count_reduce_fallback"),
    "exchange": ({"engine": "level", "num_devices": 8,
                  "count_reduce": "sparse", "count_sparse_min": 8},
                 "exchange_fallback"),
}
PROPOSED = {"mine_engine": "bitmap", "count_reduce": "dense",
            "exchange": "flat"}


@pytest.mark.parametrize("chain", sorted(CLAMPS))
def test_level_boundary_clamp(chain, tmp_path, qroot, monkeypatch):
    """A peer's walk adopted at the level.3 boundary clamps this rank
    before level 4's dispatch (the vertical loop hands its complete
    levels to the bitmap loop); the levels equal a clean mine's."""
    # A bound no heartbeat misses while a whole mine runs under load.
    monkeypatch.setenv("FA_QUORUM_TIMEOUT_S", "10")
    path = _corpus(tmp_path)
    knobs, kind = CLAMPS[chain]
    want, _ = FastApriori(config=MinerConfig(min_support=0.05, **knobs),
                          device="cpu").run_file_raw(path)
    ledger.reset()
    d0, d1 = _pair(qroot)
    quorum.set_domain(d0)
    # The weight-total cross-check would wait for the peer's payload
    # (tested below on its own).
    monkeypatch.setattr(FastApriori, "_verify_wstotals",
                        lambda self, totals: None)
    real_sync = quorum.sync

    def sync(site, wait=False):
        if site == "level.3":
            d1.propose(chain, PROPOSED[chain], "transient_exhausted")
        real_sync(site, wait)

    monkeypatch.setattr(quorum, "sync", sync)
    try:
        got, _ = FastApriori(config=MinerConfig(min_support=0.05, **knobs),
                             device="cpu").run_file_raw(path)
    finally:
        quorum.set_domain(None)
        d0.close()
        d1.close()
    _levels_equal(got, want)
    ev = [e for e in ledger.snapshot()
          if e["kind"] == kind and e.get("reason") == "quorum"]
    assert ev and ev[0]["k"] == 4, ledger.snapshot()
    assert any(e["kind"] == "quorum_adopt" and e["rank"] == 1
               and e["site"] == "level.3" for e in ledger.snapshot())


def test_elastic_reseed_from_the_last_complete_level(tmp_path, qroot,
                                                     monkeypatch):
    """A peer lost at the level.4 boundary with continuation on: the
    survivor meets alone at mesh epoch 1, counts eagerly, and the level
    loop goes on from level 4 (a level_resume from k = 5 and a
    mesh_epoch_reseed note) with the clean levels."""
    monkeypatch.setenv("FA_QUORUM_TIMEOUT_S", "10")
    path = _corpus(tmp_path)
    cfg = MinerConfig(min_support=0.05, engine="level")
    want, _ = FastApriori(config=cfg, device="cpu").run_file_raw(path)
    monkeypatch.setenv("FA_EPOCH_RETRY_MAX", "1")
    # Rank 1 stays alive (its heartbeat runs) until the injected loss:
    # the rejoin leaves it out, declared dead by rank 0.
    d0, d1 = _pair(qroot)
    quorum.set_domain(d0)
    real_sync = quorum.sync
    fired = []

    def sync(site, wait=False):
        if site == "level.4" and not fired:
            fired.append(site)
            raise quorum.PeerLost(1, site, "peer exited")
        real_sync(site, wait)

    monkeypatch.setattr(quorum, "sync", sync)
    try:
        miner = FastApriori(config=cfg, device="cpu")
        got, _ = miner.run_file_raw(path)
    finally:
        quorum.set_domain(None)
        d0.close()
        d1.close()
    _levels_equal(got, want)
    assert d0.mesh_epoch == 1 and d0.members == [0]
    resumed = [r for r in miner.metrics.records
               if r["event"] == "level_resume"]
    assert resumed and resumed[-1]["from_k"] == 5
    notes = [e for e in flight.snapshot() if e["kind"] == "mesh_epoch_reseed"]
    assert notes and notes[-1]["resume_from_k"] == 4
    assert notes[-1]["mesh_epoch"] == 1


def test_checkpoint_writer_stamps_the_fence(tmp_path, qroot, monkeypatch):
    """The miner's checkpoints in a file domain: rank 0 writes, stamped
    with its fence in the meta and the manifest; rank 1 writes none."""
    monkeypatch.setenv("FA_QUORUM_TIMEOUT_S", "10")
    path = _corpus(tmp_path)
    outs = []
    for rank in (0, 1):
        prefix = str(tmp_path / f"r{rank}") + "/"
        os.makedirs(prefix)
        # A directory each: the rank that runs first must not be judged
        # by the other's stopped heartbeat.
        dom = _dom(f"{qroot}.{rank}", rank, 2)
        quorum.set_domain(dom)
        try:
            FastApriori(config=MinerConfig(
                min_support=0.05, engine="level", checkpoint_prefix=prefix),
                device="cpu").run_file_raw(path)
        finally:
            quorum.set_domain(None)
            dom.close()
        outs.append(prefix)
    _, meta = ckpt.load_checkpoint(outs[0])
    assert meta["fence"] == 1 == resume_io.manifest_fence(outs[0])
    assert not ckpt.checkpoint_available(outs[1])


# ---------------------------------------------------------------------------
# the exchange chain and the weight totals


def test_exchange_chain_is_consensus_registered(qroot):
    assert "exchange" in quorum.CONSENSUS_CHAINS
    assert watchdog.CHAINS["exchange"] == ("hier", "flat")
    dom = _dom(qroot, 0, 1)
    quorum.set_domain(dom)
    try:
        assert hier.resolve_active_spec(8, MinerConfig()) == (2, 4)
        watchdog.downgrade("exchange", "hier", "flat",
                           reason="transient_exhausted")
        assert dom.floor_stage("exchange") == "flat"
        assert hier.resolve_active_spec(8, MinerConfig()) is None
        assert hier.resolve_active_spec(8, MinerConfig(),
                                        unclamped=True) == (2, 4)
    finally:
        quorum.set_domain(None)
        dom.close()


def test_wstotals_rendezvous_transient_absorbed(tmp_path, monkeypatch):
    monkeypatch.setenv("FA_QUORUM_TIMEOUT_S", "5.0")
    d0, d1 = _pair(str(tmp_path / "q"))
    quorum.set_domain(d0)
    failpoints.arm("quorum.mine.wstotals", "oom*1")
    try:
        miner = FastApriori(config=MinerConfig(min_support=0.05,
                                               num_devices=2), device="cpu")
        t = threading.Thread(
            target=lambda: d1.exchange("mine.wstotals", [10, 0]))
        t.start()
        miner._verify_wstotals([10, 0])
        t.join(10)
        assert any("wstotals" in str(e.get("site", ""))
                   for e in ledger.snapshot() if e["kind"] == "retry")
        assert any(e["kind"] == "wstotals_exchange" and e.get("verified")
                   for e in ledger.snapshot())
    finally:
        quorum.set_domain(None)
        d0.close()
        d1.close()


def test_wstotals_divergence_classified(tmp_path, monkeypatch):
    monkeypatch.setenv("FA_QUORUM_TIMEOUT_S", "5.0")
    d0, d1 = _pair(str(tmp_path / "q"))
    quorum.set_domain(d0)
    try:
        miner = FastApriori(config=MinerConfig(min_support=0.05,
                                               num_devices=2), device="cpu")
        t = threading.Thread(
            target=lambda: d1.exchange("mine.wstotals", [999, 1]))
        t.start()
        with pytest.raises(quorum.MeshDivergence, match="wstotals"):
            miner._verify_wstotals([10, 0])
        t.join(10)
    finally:
        quorum.set_domain(None)
        d0.close()
        d1.close()


# ---------------------------------------------------------------------------
# the torch transport and the world's collectives


def test_torch_transport_exchanges_only_at_rendezvous(monkeypatch):
    """A world's domain gathers the rank-prefixed vector through the
    process group, only at wait=True sites (every rank passes them
    once), and adopts the most degraded position; the weight totals
    cross as int64."""
    calls = []
    peer = {"pos": [0, 0, 1, 0, 0, 0, 0]}

    def gather(x, site):
        calls.append((site, x.dtype))
        import torch

        if len(x) == 1 + len(quorum.CONSENSUS_CHAINS):
            other = torch.tensor([1] + peer["pos"], dtype=x.dtype)
        else:
            other = torch.tensor([1] + [2**40] * (len(x) - 1), dtype=x.dtype)
        return [x, other]

    monkeypatch.setattr(mesh, "world_all_gather", gather)
    dom = quorum.QuorumDomain(quorum.TorchTransport(0, 2), 0, 2)
    dom.sync("level.3")  # a boundary poll: no collective
    assert calls == []
    dom.sync("run.start", wait=True)
    assert [c[0] for c in calls] == ["quorum.run.start"]
    assert dom.floor_stage("count_reduce") == "dense"
    got = dom.exchange("mine.wstotals", [3, 4])
    assert got == {0: [3, 4], 1: [2**40, 2**40]}
    import torch

    assert calls[-1] == ("quorum.mine.wstotals", torch.int64)
    assert dom.checkpoint_fence() == 0 and dom.is_writer()
    assert [e["site"] for e in dom.epoch_trail()] == ["run.start"]


def test_world_collective_failure_is_the_quorum_peer_lost(monkeypatch):
    """parallel/mesh.py raises the domain's PeerLost, naming the other
    rank of a world of two and the site; after one failure every later
    collective raises at once."""
    import torch

    world = mesh.World(0, 2, 0, "gloo", torch.device("cpu"), 0.2)
    monkeypatch.setattr(mesh, "_WORLD", world)

    class Work:
        def is_completed(self):
            return False

    t0 = time.monotonic()
    with pytest.raises(quorum.PeerLost) as ei:
        mesh._collective(lambda async_op: Work(), site="agree")
    assert 0.2 <= time.monotonic() - t0 < 2.0
    assert (ei.value.rank, ei.value.site) == (1, "agree")
    assert "no result within 0.2 s" in str(ei.value) and world.lost
    t0 = time.monotonic()
    with pytest.raises(quorum.PeerLost, match="lost at an earlier"):
        mesh._collective(lambda async_op: Work(), site="psum")
    assert time.monotonic() - t0 < 0.1
    world3 = mesh.World(2, 3, 2, "gloo", torch.device("cpu"), 0.1)
    monkeypatch.setattr(mesh, "_WORLD", world3)
    with pytest.raises(quorum.PeerLost) as ei:
        mesh._collective(lambda async_op: Work(), site="all_gather")
    assert ei.value.rank == -1


@pytest.mark.parametrize("domain", [False, True])
def test_exhausted_walks_in_a_world_only_with_a_domain(domain, monkeypatch):
    """At world > 1 a rank whose fetch gave up walks only when a domain
    will carry its walk to the peers."""
    exc = RuntimeError("RESOURCE_EXHAUSTED: x")
    exc.fa_retries_exhausted_at = "fetch.level_bits"
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    quorum.set_domain(quorum.QuorumDomain(quorum.TorchTransport(0, 2), 0, 2)
                      if domain else None)
    assert retry.exhausted(exc) == ("fetch.level_bits" if domain else None)


def test_cli_exits_3_on_a_lost_peer(tmp_path, monkeypatch, capsys):
    """A file-domain rank whose peer never starts: the run.start
    rendezvous gives up within the bound and the CLI exits 3 naming the
    rank, writing nothing."""
    from fastapriori_tpu_torch.cli import main

    inp = tmp_path / "in"
    inp.mkdir()
    (inp / "D.dat").write_text("1 2\n1 2 3\n")
    (inp / "U.dat").write_text("1\n")
    out = str(tmp_path / "out") + "/"
    monkeypatch.setenv("FA_QUORUM_DIR", str(tmp_path / "q"))
    monkeypatch.setenv("FA_QUORUM_PROCS", "2")
    monkeypatch.setenv("FA_QUORUM_RANK", "0")
    monkeypatch.setenv("FA_QUORUM_TIMEOUT_S", "0.3")
    monkeypatch.setenv("FA_RETRY_BACKOFF_MS", "0")
    assert main([str(inp) + "/", out, "--min-support", "0.5",
                 "--platform", "cpu"]) == 3
    err = capsys.readouterr().err
    assert "quorum peer rank 1 lost at 'run.start'" in err
    assert not os.path.exists(out + "freqItemset")
    assert os.path.exists(str(tmp_path / "q" / "exit.0"))


# ---------------------------------------------------------------------------
# one directory, two packages


@pytest.mark.parametrize("proposer", ["jax", "port"])
def test_jax_and_port_ranks_share_one_file_domain(proposer, qroot):
    """A JAX QuorumDomain as rank 0 and the port's as rank 1 on one
    FileTransport directory: a proposal on either side is adopted by the
    other at the next rendezvous, and both read the same FENCE."""
    j0 = jq.QuorumDomain(jq.FileTransport(qroot, 0, 2), 0, 2)
    p1 = _dom(qroot, 1, 2)
    try:
        src, dst = (j0, p1) if proposer == "jax" else (p1, j0)
        src.propose("count_reduce", "dense", "transient_exhausted")
        src.propose("engine", "level", "transient_exhausted")
        errs = []

        def go(d):
            try:
                d.sync("level.3", wait=True)
            except (jq.PeerLost, jq.MeshDivergence, quorum.PeerLost,
                    quorum.MeshDivergence) as e:
                errs.append(e)

        t = threading.Thread(target=go, args=(p1,))
        t.start()
        go(j0)
        t.join(30)
        assert errs == []
        for d in (j0, p1):
            assert d.floor_stage("count_reduce") == "dense"
            assert d.floor_stage("engine") == "level"
        adopted = (ledger if dst is p1 else jax_ledger).snapshot()
        assert any(e["kind"] == "quorum_adopt" and e["rank"] == src.rank
                   for e in adopted)
        fence = j0.checkpoint_fence()
        assert fence == 1 and p1.transport.current_fence() == 1
        p1.validate_resume_fence(fence)
        # A port writer acquires the next fence: the JAX writer is
        # superseded, and the port refuses the JAX writer's old fence.
        p0 = _dom(qroot, 0, 2)
        assert p0.checkpoint_fence() == 2
        with pytest.raises(jq.StaleFenceError):
            j0.checkpoint_fence()
        with pytest.raises(quorum.StaleFenceError):
            p1.validate_resume_fence(fence)
        p0.close()
    finally:
        j0.close()
        p1.close()
