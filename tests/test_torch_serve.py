"""The port's serving tier (fastapriori_tpu_torch/serve/) against the JAX
package's (fastapriori_tpu/serve/), on the CPU, where K2 runs its plain
version: a counterpart of every test of tests/test_serve.py, answer for
answer, on the same seeded corpora; the serving artifact loaded across
the two packages; the ``serve`` CLI's bytes against the JAX ``serve``
CLI's and the JAX batch CLI's; and the port's deliberate differences
(no cascade walk off K2, exit 1 after a failed batch, a lost CUDA
context stops the dispatcher).  Every wait is bounded."""

import functools
import io
import json
import os
import threading
import time
from contextlib import redirect_stderr

import numpy as np
import pytest

from conftest import random_dataset, tokenized
from fastapriori_tpu.cli import main as jax_main
from fastapriori_tpu.config import MinerConfig as JaxConfig
from fastapriori_tpu.models.apriori import FastApriori as JaxApriori
from fastapriori_tpu.models.recommender import (
    AssociationRules as JaxRules,
)
from fastapriori_tpu.preprocess import preprocess as jax_preprocess
from fastapriori_tpu.serve import ServingState as JaxState
from fastapriori_tpu.serve import arrival_offsets as jax_arrival_offsets
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.models import recommender as torch_recommender
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.models.recommender import AssociationRules
from fastapriori_tpu_torch.preprocess import preprocess
from fastapriori_tpu_torch.reliability import failpoints, ledger, retry
from fastapriori_tpu_torch.serve import (
    SERVING_NAME,
    RecommendServer,
    ServingState,
    arrival_offsets,
    model_signature,
    run_open_loop,
)
from fastapriori_tpu_torch.serve import server as serve_server
from fastapriori_tpu_torch.utils.datagen import (
    generate_transactions,
    generate_user_baskets,
)
from test_torch_e2e import JAX_FLAGS

MIN_SUPPORT = 0.05


@pytest.fixture(autouse=True)
def _clean_state():
    failpoints.disarm_all()
    ledger.reset()
    serve_server.reload_from_env()
    yield
    failpoints.disarm_all()
    ledger.reset()
    serve_server.reload_from_env()
    retry.reload_policy_from_env()


def _d_lines(seed):
    return tokenized(random_dataset(seed, n_txns=250, max_len=8))


def _model(seed=6, min_support=MIN_SUPPORT, **cfg_kw):
    data = preprocess(_d_lines(seed), min_support)
    cfg = MinerConfig(min_support=min_support, engine="level", **cfg_kw)
    levels = FastApriori(config=cfg, device="cpu").mine_levels_raw(data)
    return levels, data, cfg


def _state(seed=6, min_support=MIN_SUPPORT, engine="auto", **cfg_kw):
    levels, data, cfg = _model(seed, min_support, **cfg_kw)
    return ServingState(
        levels, data.item_counts, data.freq_items, data.item_to_rank,
        config=cfg, device="cpu", engine=engine,
    )


U_LINES = tokenized(random_dataset(60, n_txns=200))


@functools.lru_cache(maxsize=None)
def _jax_model(seed=6, min_support=MIN_SUPPORT):
    data = jax_preprocess(_d_lines(seed), min_support)
    cfg = JaxConfig(min_support=min_support, engine="level", num_devices=1)
    levels = JaxApriori(config=cfg).mine_levels_raw(data)
    return levels, data, cfg


def _jax_state(seed=6, min_support=MIN_SUPPORT):
    levels, data, cfg = _jax_model(seed, min_support)
    return JaxState(levels, data.item_counts, data.freq_items,
                    data.item_to_rank, config=cfg, engine="host")


@functools.lru_cache(maxsize=None)
def _jax_batch_answers(seed=6, min_support=MIN_SUPPORT):
    """The JAX batch recommender's answers to U_LINES, in row order."""
    levels, data, cfg = _jax_model(seed, min_support)
    rec = JaxRules([], data.freq_items, data.item_to_rank, config=cfg,
                   levels=levels, item_counts=data.item_counts)
    return tuple(item for _, item in sorted(rec.run(U_LINES)))


def _cascades(chain=None):
    return [e for e in ledger.snapshot() if e["kind"] == "cascade"
            and (chain is None or e.get("chain") == chain)]


def _gate(st):
    gate = threading.Event()
    orig = st.recommend_batch

    def gated(lines):
        gate.wait(30.0)
        return orig(lines)

    st.recommend_batch = gated
    return gate


# ---------------------------------------------------------------------------
# ServingState: build, engines, equal answers


def test_serving_state_matches_batch_recommender():
    """Host and device engines answer what the JAX batch pipeline answers
    (and the port's batch recommender)."""
    expected = list(_jax_batch_answers())
    levels, data, cfg = _model()
    rec = AssociationRules([], data.freq_items, data.item_to_rank,
                           levels=levels,
                           item_counts=data.item_counts, config=cfg,
                           device="cpu")
    assert [item for _, item in sorted(rec.run(U_LINES))] == expected
    for engine in ("host", "device"):
        st = _state(engine=engine)
        assert st.recommend_batch(U_LINES) == expected, engine


def test_serving_state_resident_table_mounts():
    """After the device rule engine the state mounts the table built on
    the device (one shard), no rule-table byte crosses the host link,
    and the answers are the JAX package's."""
    st = _state(rule_engine="device")
    st.warm()
    d = st.describe()
    assert d["resident_table"] is True
    assert d["scan_shards"] == 1
    assert d["rule_table_host_bytes"] == 0
    assert d["table_bytes"] == st.resident_device_bytes() > 0
    assert st.recommend_batch(U_LINES) == list(_jax_batch_answers())
    assert st.scan_dispatches >= 2  # the warm probe and the batch


@pytest.mark.parametrize("rule_engine", ["host", "device"])
def test_rule_table_host_bytes_counts_uploads_after_the_mount(rule_engine):
    """The table's host upload happens inside warm(), before the mount
    mark: the whole host-built table, or only the consequent priority
    the device-built one is sorted by.  Serving uploads no more; a table
    uploaded again after the mount counts its bytes."""
    st = _state(engine="device", rule_engine=rule_engine)
    assert st.rule_table_host_bytes == 0
    st.warm()
    rec, table_bytes = st._rec, st.describe()["table_bytes"]
    if rule_engine == "host":
        assert rec.table_upload_bytes == table_bytes > 0
    else:
        assert 0 < rec.table_upload_bytes < table_bytes
    assert st.recommend_batch(U_LINES) == list(_jax_batch_answers())
    assert st.describe()["rule_table_host_bytes"] == 0
    rec._table_dev = None
    again = sum(int(t.nbytes) for t in rec.table())
    assert st.rule_table_host_bytes == again > 0


def test_serving_state_empty_and_no_rules():
    st = _state(min_support=0.9)
    assert st.n_rules == 0
    assert st.recommend_batch(U_LINES[:7]) == ["0"] * 7
    assert _jax_state(min_support=0.9).recommend_batch(U_LINES[:7]) \
        == ["0"] * 7


def test_serving_state_engine_strictness():
    with pytest.raises(InputError, match="ServingState engine"):
        _state(engine="gpu")


def test_swap_readiness_barrier_probes_device_path():
    assert _state(engine="host").device_ready() is False
    st = _state(engine="device")
    assert st.device_ready() is True
    assert st._handle is not None
    before = st.scan_dispatches
    assert st.device_ready() is True  # a mounted table probes again
    assert st.scan_dispatches == before + 1


def test_serving_state_signature_tracks_model():
    a, b, c = _state(seed=6), _state(seed=6), _state(seed=7)
    assert a.signature == b.signature
    assert a.signature != c.signature
    assert model_signature(a.levels, a.item_counts, a.freq_items) \
        == a.signature
    # The JAX package's signature of the same mining result.
    assert a.signature == _jax_state(seed=6).signature
    assert c.signature == _jax_state(seed=7).signature


# ---------------------------------------------------------------------------
# checkpoint -> kill -> warm restart


def test_serving_checkpoint_warm_restart_byte_identical(tmp_path):
    prefix = str(tmp_path) + os.sep
    st = _state()
    baseline = st.recommend_batch(U_LINES)
    st.save(prefix)
    sig = st.signature
    st.release()
    del st
    restored = ServingState.load(prefix, config=MinerConfig(
        min_support=MIN_SUPPORT), device="cpu")
    assert restored.signature == sig
    assert restored.source == "restart"
    assert restored.recommend_batch(U_LINES) == baseline
    events = [e for e in ledger.snapshot() if e["kind"] == "serving_restart"]
    assert events and events[0]["signature"] == sig


def test_serving_checkpoint_truncation_rejected(tmp_path):
    prefix = str(tmp_path) + os.sep
    st = _state()
    failpoints.arm("write." + SERVING_NAME, "truncate@64")
    st.save(prefix)
    failpoints.disarm_all()
    with pytest.raises(InputError, match=SERVING_NAME):
        ServingState.load(prefix, device="cpu")


def test_serving_checkpoint_missing_is_input_error(tmp_path):
    with pytest.raises(InputError, match="not found"):
        ServingState.load(str(tmp_path) + os.sep, device="cpu")


def test_serving_load_failpoint_armable(tmp_path):
    prefix = str(tmp_path) + os.sep
    _state().save(prefix)
    failpoints.arm("serving.load", "io")
    with pytest.raises(OSError):
        ServingState.load(prefix, device="cpu")
    failpoints.disarm_all()
    assert ServingState.load(prefix, device="cpu").n_rules > 0


def test_released_state_refuses_to_serve():
    st = _state()
    st.recommend_batch(U_LINES[:3])
    st.release()
    with pytest.raises(InputError, match="released"):
        st.recommend_batch(U_LINES[:3])


def test_serving_npz_loads_in_both_packages(tmp_path):
    """A port-written serving.npz loads in the JAX package and a
    JAX-written one in the port: equal signatures, equal answers."""
    port_prefix = str(tmp_path / "port") + os.sep
    jax_prefix = str(tmp_path / "jax") + os.sep
    os.makedirs(port_prefix)
    os.makedirs(jax_prefix)
    st = _state()
    st.save(port_prefix)
    _jax_state().save(jax_prefix)
    in_jax = JaxState.load(port_prefix, config=JaxConfig(
        min_support=MIN_SUPPORT, num_devices=1), engine="host")
    in_port = ServingState.load(jax_prefix, device="cpu", engine="device")
    assert in_jax.signature == in_port.signature == st.signature
    expected = list(_jax_batch_answers())
    assert in_jax.recommend_batch(U_LINES) == expected
    assert in_port.recommend_batch(U_LINES) == expected


# ---------------------------------------------------------------------------
# rec_batch_rows: one knob for the batch path and the serving tier


def test_rec_batch_rows_pow2_bucketed_and_shared(monkeypatch):
    st = _state(rec_batch_rows=1000)
    assert st.batch_rows() == 1024
    assert st._rec.rec_batch_rows() == 1024
    monkeypatch.setenv("FA_REC_BATCH", "100")
    assert st.batch_rows() == 128
    monkeypatch.setenv("FA_REC_BATCH", "7")
    assert st.batch_rows() == 32
    monkeypatch.setenv("FA_REC_BATCH", "lots")
    with pytest.raises(InputError, match="FA_REC_BATCH"):
        st.batch_rows()
    monkeypatch.setenv("FA_REC_BATCH", "-1")
    with pytest.raises(InputError, match="out of range"):
        st.batch_rows()


def test_rec_batch_rows_caps_batch_recommender_microbatch(monkeypatch):
    """The batch recommender's scan over the device-built table cuts its
    micro-batches at the same knob."""
    monkeypatch.setenv("FA_REC_BATCH", "64")
    levels, data, cfg = _model(rule_engine="device")
    rec = AssociationRules([], data.freq_items, data.item_to_rank,
                           levels=levels,
                           item_counts=data.item_counts, config=cfg,
                           device="cpu")
    out = rec.run(U_LINES, use_device=True)
    fm = [r for r in rec.metrics.records
          if r.get("event") == "first_match" and r.get("device")][-1]
    assert fm["resident_table"] is True
    n_distinct = [r for r in rec.metrics.records
                  if r.get("event") == "user_dedup"][-1]["distinct"]
    assert fm["launches"] == -(-n_distinct // 64)
    assert out == rec.run(U_LINES, use_device=False)


def test_server_pins_scan_shape_to_its_batch_knob():
    st = _state(engine="device")
    server = RecommendServer(st, batch_rows=48, linger_ms=0.0)
    server.start()
    assert st.batch_rows() == 64
    assert server.stop()


def test_scan_blocks_pad_to_the_pow2_of_their_real_rows():
    """A block covers at most batch_rows baskets and is padded only to
    the next power of two of its real rows, at least 32."""
    st = _state(engine="device")
    st.set_batch_rows(64)
    baskets = [np.array([i % 5], dtype=np.int32) for i in range(70)]
    blocks = st._pack_blocks(baskets)
    assert [(b0, n, bm.shape[0]) for b0, n, bm, _ in blocks] == [
        (0, 64, 64), (64, 6, 32)]
    assert all(int(blen[n:].sum()) == 0 for _, n, _, blen in blocks)


def test_auto_engine_follows_the_batch_paths_threshold(monkeypatch):
    """auto takes the device scan when one full block's basket x rule
    checks reach DEVICE_MIN_CHECKS, else the host scan; either way the
    answers are the same."""
    probe = _state()
    checks = probe.batch_rows() * probe.n_rules
    answers = {}
    for threshold, want in ((checks, "device"), (checks + 1, "host")):
        monkeypatch.setattr(torch_recommender, "DEVICE_MIN_CHECKS",
                            threshold)
        st = _state()
        st.warm()
        assert st.describe()["engine"] == want
        answers[want] = st.recommend_batch(U_LINES)
    assert answers["device"] == answers["host"] == list(_jax_batch_answers())


# ---------------------------------------------------------------------------
# RecommendServer: micro-batching, linger, shed, swap


def test_server_serves_and_orders_responses():
    st = _state()
    expected = st.recommend_batch(U_LINES)
    server = RecommendServer(st, batch_rows=32, linger_ms=1.0).start()
    reqs = [server.submit_wait(t) for t in U_LINES]
    assert server.wait_for(reqs, timeout_s=60.0)
    assert [r.item for r in reqs] == expected == list(_jax_batch_answers())
    stats = server.stats()
    assert stats["served"] == len(U_LINES)
    assert stats["shed"] == 0
    assert stats["batches"] >= 1
    assert server.stop()


def test_server_linger_zero_dispatches_immediately():
    st = _state()
    server = RecommendServer(st, batch_rows=4096, linger_ms=0.0).start()
    req = server.submit(U_LINES[0])
    assert server.wait_for([req], timeout_s=30.0)
    assert req.item is not None and not req.shed
    assert server.stop()


def test_server_shed_mode_answers_zero_with_ledger_event():
    st = _state()
    server = RecommendServer(st, batch_rows=32, linger_ms=0.0,
                             queue_depth=8, pipeline_depth=0)
    barrier = threading.Event()
    orig = st.recommend_batch

    def slow_batch(lines):
        barrier.wait(10.0)
        return orig(lines)

    st.recommend_batch = slow_batch
    server.start(warm=False)
    reqs = [server.submit(t) for t in U_LINES[:60]]
    shed = [r for r in reqs if r.shed]
    live = [r for r in reqs if not r.shed]
    assert len(shed) >= 60 - 8 - 32
    assert all(r.item == "0" and r.done for r in shed)
    cascade = _cascades("serving")
    assert cascade and cascade[0]["frm"] == "accept"
    assert cascade[0]["to"] == "shed"
    barrier.set()
    assert server.wait_for(live, timeout_s=60.0)
    assert all(not r.shed and r.item is not None for r in live)
    assert server.stop()


def test_server_shed_recovery_records_new_episode():
    st = _state()
    server = RecommendServer(st, batch_rows=32, linger_ms=0.0, queue_depth=4)
    r = server.submit(U_LINES[0])
    assert r.shed and r.item == "0"
    server.start(warm=False)
    ok = server.submit_wait(U_LINES[0], timeout_s=30.0)
    assert server.wait_for([ok], timeout_s=30.0) and not ok.shed
    assert server.stop()


def test_server_hot_swap_never_mixes_tables():
    st_a, st_b = _state(seed=6), _state(seed=7)
    assert st_a.signature != st_b.signature
    gate = _gate(st_a)
    server = RecommendServer(st_a, batch_rows=16, linger_ms=0.0).start(
        warm=False)
    before = [server.submit(t) for t in U_LINES[:50]]
    ev = server.swap(st_b)
    after = [server.submit(t) for t in U_LINES[:50]]
    gate.set()
    assert server.wait_for(before + after, timeout_s=60.0)
    assert ev.is_set()
    assert {r.model for r in before} == {st_a.signature}
    assert {r.model for r in after} == {st_b.signature}
    assert st_a._released
    assert server.state is st_b
    swaps = [e for e in ledger.snapshot() if e["kind"] == "serve_swap"]
    assert swaps and swaps[0]["frm"] == st_a.signature
    assert server.stats()["swaps"] == 1
    assert server.stop()


def test_server_swap_responses_match_new_model():
    st_a, st_b = _state(seed=6), _state(seed=7)
    expected_b = st_b.recommend_batch(U_LINES)
    assert expected_b == list(_jax_batch_answers(seed=7))
    server = RecommendServer(st_a, batch_rows=64, linger_ms=0.5).start()
    server.swap(st_b)
    reqs = [server.submit_wait(t) for t in U_LINES]
    assert server.wait_for(reqs, timeout_s=60.0)
    assert [r.item for r in reqs] == expected_b
    assert server.stop()


def test_swap_frees_the_old_table_at_the_barrier():
    """The outgoing state's table and handle are dropped at the barrier:
    it pins no device bytes after it."""
    st_a, st_b = _state(seed=6, engine="device"), _state(seed=7)
    server = RecommendServer(st_a, batch_rows=32, linger_ms=0.0).start()
    assert st_a.resident_device_bytes() > 0
    ev = server.swap(st_b)
    assert ev.wait(30.0)
    assert st_a.resident_device_bytes() == 0
    assert st_a._handle is None and st_a._rec._table_dev is None
    assert server.stop()


def test_server_stop_is_bounded_even_when_blocked():
    st = _state()
    orig = st.recommend_batch
    release = threading.Event()

    def blocked(lines):
        release.wait(5.0)
        return orig(lines)

    st.recommend_batch = blocked
    server = RecommendServer(st, batch_rows=8, linger_ms=0.0).start(
        warm=False)
    server.submit(U_LINES[0])
    t0 = time.monotonic()
    assert not server.drain(timeout_s=0.2)
    assert time.monotonic() - t0 < 2.0
    release.set()
    assert server.stop(drain=True, timeout_s=30.0)


def test_server_survives_fatal_batch_error():
    """A batch whose recommend raises an error that leaves the CUDA
    context alive answers "0" (ledger serve_error) and the dispatcher
    keeps serving, as in the JAX package."""
    st = _state()
    orig = st.recommend_batch
    calls = {"n": 0}

    def flaky(lines):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("model bug")
        return orig(lines)

    st.recommend_batch = flaky
    server = RecommendServer(st, batch_rows=8, linger_ms=0.0).start(
        warm=False)
    bad = server.submit_wait(U_LINES[0])
    assert server.wait_for([bad], timeout_s=30.0)
    assert bad.item == "0" and bad.error is None
    good = server.submit_wait(U_LINES[0])
    assert server.wait_for([good], timeout_s=30.0)
    assert good.item == orig([U_LINES[0]])[0]
    errs = [e for e in ledger.snapshot() if e["kind"] == "serve_error"]
    assert errs and "model bug" in errs[0]["error"]
    assert errs[0]["fatal"] is False
    assert server.alive() and server.stats()["errors"] == 1
    assert server.stop()


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    failpoints.InjectedAbort("injected abort at fetch.serve_match"),
], ids=["sticky_cuda", "abort"])
def test_lost_context_stops_the_dispatcher(depth, error):
    """Departs from the JAX package (which answers "0" and goes on): an
    error after which the CUDA context cannot serve stops the
    dispatcher.  The failing batch and every queued request complete as
    failed (no answer), the server stops admitting, alive() is False."""
    st = _state()
    gate = threading.Event()

    def dead(lines):
        gate.wait(30.0)
        raise error

    st.recommend_batch = dead
    server = RecommendServer(st, batch_rows=8, linger_ms=0.0,
                             pipeline_depth=depth).start(warm=False)
    reqs = [server.submit(t) for t in U_LINES[:40]]
    gate.set()
    assert server.wait_for(reqs, timeout_s=30.0)
    assert all(r.error is not None and r.item is None for r in reqs
               if not r.shed)
    stats = server.stats()
    assert stats["served"] == 0
    assert stats["failed"] + stats["shed"] == 40
    assert stats["fatal"]
    deadline = time.monotonic() + 10.0
    while server.alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not server.alive()
    later = server.submit(U_LINES[0])
    assert later.shed and later.item == "0"
    errs = [e for e in ledger.snapshot() if e["kind"] == "serve_error"]
    assert errs and errs[0]["fatal"] is True
    assert server.stop(timeout_s=10.0)


@pytest.mark.parametrize("depth", [0, 2])
def test_lost_context_fails_pending_swaps(depth):
    """Swap barriers that a stopped dispatcher never reaches (in the
    queue, or in the ring at depth 2) fail at once: each event is set
    with ``error``, ``wait`` is False without running out its timeout,
    the incoming state is released, and the loss is counted and
    recorded.  The old state stays the server's."""
    st = _state()
    incoming = [_state(seed=7), _state(seed=8)]
    gate = threading.Event()

    def dead(lines):
        gate.wait(30.0)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    st.recommend_batch = dead
    server = RecommendServer(st, batch_rows=8, linger_ms=0.0,
                             pipeline_depth=depth).start(warm=False)
    reqs = [server.submit(U_LINES[0])]
    events = []
    for new in incoming:
        events.append(server.swap(new))
        reqs += [server.submit(t) for t in U_LINES[1:4]]
    gate.set()
    t0 = time.monotonic()
    assert not any(ev.wait(30.0) for ev in events)
    assert time.monotonic() - t0 < 10.0
    assert all(ev.is_set() and "illegal memory access" in ev.error
               for ev in events)
    assert all(new._released and new._handle is None for new in incoming)
    assert server.wait_for(reqs, timeout_s=30.0)
    stats = server.stats()
    assert (stats["swaps"], stats["swaps_failed"]) == (0, 2)
    failed = [e for e in ledger.snapshot()
              if e["kind"] == "serve_swap_failed"]
    # The queue's barriers fail before the ring's: compare as sets.
    assert sorted(e["to"] for e in failed) == sorted(
        s.signature for s in incoming)
    assert server.state is st
    assert server.stop(timeout_s=10.0)


def test_serve_transient_exhaustion_never_walks_rule_scan(monkeypatch):
    """Departs from test_serve_transient_exhaustion_walks_rule_scan_cascade
    of the JAX package: a device scan whose transient failures outlast
    the retries raises; nothing walks to the host scan, the device table
    stays mounted, and the server answers that batch "0" with a
    serve_error and serves the next one from the device."""
    monkeypatch.setenv("FA_RETRY_MAX", "2")
    monkeypatch.setenv("FA_RETRY_BACKOFF_MS", "0")
    retry.reload_policy_from_env()
    st = _state(engine="device")
    st.warm()
    failpoints.arm("fetch.serve_match", "oom")
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        st.recommend_batch(U_LINES)
    assert st._engine == "device" and st._handle is not None
    assert st.resident_device_bytes() > 0
    assert _cascades() == []
    server = RecommendServer(st, batch_rows=4096, linger_ms=0.0).start()
    bad = server.submit_wait(U_LINES[0])
    assert server.wait_for([bad], timeout_s=30.0) and bad.item == "0"
    failpoints.disarm_all()
    reqs = [server.submit_wait(t) for t in U_LINES]
    assert server.wait_for(reqs, timeout_s=30.0)
    assert [r.item for r in reqs] == list(_jax_batch_answers())
    assert [e["kind"] for e in ledger.snapshot()
            if e["kind"] not in ("retry", "serve_engine")] == ["serve_error"]
    assert _cascades() == []
    assert server.stop()


def test_serving_k2_scans_the_resident_table(monkeypatch):
    """The counterpart of the JAX package's interpreter pin of its Pallas
    kernel on the resident table: the mounted scan goes through K2's
    wrapper (its plain version on CPU tensors) once per dispatch, on the
    device-built table, and answers as the JAX package does."""
    calls = []
    real = torch_recommender.first_match

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(torch_recommender, "first_match", counting)
    st = _state(rule_engine="device")
    st.warm()
    assert st._handle is not None and st._handle.resident is True
    assert st._handle.kernel is False  # CPU tensors: the plain version
    assert st.recommend_batch(U_LINES) == list(_jax_batch_answers())
    assert len(calls) == st.scan_dispatches >= 2


def test_serve_scan_failure_never_walks_to_the_plain_kernel(monkeypatch):
    """Departs from test_serve_scan_pallas_cascade_walks_to_xla of the
    JAX package: a transient K2 failure at launch is not retried into
    another kernel tier or the host scan; it raises, and the ledger has
    no cascade."""

    def failing(*args):
        raise RuntimeError("RESOURCE_EXHAUSTED: injected K2 launch failure")

    st = _state(rule_engine="device")
    st.warm()
    handle = st._handle
    monkeypatch.setattr(torch_recommender, "first_match", failing)
    st._handle = st._rec.serve_scan()
    with pytest.raises(RuntimeError, match="K2 launch failure"):
        st.recommend_batch(U_LINES)
    assert st._engine == "device" and st._handle.kernel == handle.kernel
    assert _cascades() == []


@pytest.mark.parametrize("site", ["serve_match", "serve_swap_ready"])
def test_serve_fetch_sites_are_armable_and_retried(site):
    """Both serving fetch sites are audited: one injected OOM is one
    retry ledger event at that site, and the answers stay the same."""
    failpoints.arm("fetch." + site, "oom*1")
    st = _state(engine="device")
    st.warm()
    assert st.recommend_batch(U_LINES) == list(_jax_batch_answers())
    retries = [e for e in ledger.snapshot() if e["kind"] == "retry"]
    assert [e["site"] for e in retries] == ["fetch." + site]
    assert _cascades() == []


# ---------------------------------------------------------------------------
# open-loop load generation


def test_arrival_offsets_deterministic_and_rate_shaped():
    a = arrival_offsets(5000, 1000.0, seed=3)
    b = arrival_offsets(5000, 1000.0, seed=3)
    assert np.array_equal(a, b)
    assert np.array_equal(a, jax_arrival_offsets(5000, 1000.0, seed=3))
    c = arrival_offsets(5000, 1000.0, seed=4)
    assert not np.array_equal(a, c)
    assert np.all(np.diff(a) >= 0)
    assert a[-1] / 5000 == pytest.approx(1e-3, rel=0.1)
    with pytest.raises(InputError, match="rate_rps"):
        arrival_offsets(10, 0.0, seed=1)


def test_open_loop_serves_below_capacity():
    st = _state()
    expected = {tuple(t): v for t, v in zip(U_LINES,
                                            st.recommend_batch(U_LINES))}
    server = RecommendServer(st, batch_rows=64, linger_ms=1.0).start()
    reqs = []
    res = run_open_loop(server, U_LINES, rate_rps=2000.0, n_requests=400,
                        seed=11, drain_timeout_s=60.0, requests_out=reqs)
    assert res["drained"] is True
    assert res["served"] + res["shed"] == 400
    assert res["n_requests"] == 400 and res["failed"] == 0
    assert res["p50_ms"] is not None and res["p99_ms"] is not None
    assert res["p50_ms"] <= res["p95_ms"] <= res["p99_ms"]
    assert len(reqs) == 400
    for i, r in enumerate(reqs):
        if not r.shed:
            assert r.item == expected[tuple(U_LINES[i % len(U_LINES)])]
    assert server.stop()


def test_open_loop_overload_sheds_and_stays_bounded():
    st = _state()
    orig = st.recommend_batch

    def slow(lines):
        time.sleep(0.02)
        return orig(lines)

    st.recommend_batch = slow
    server = RecommendServer(st, batch_rows=32, linger_ms=0.0,
                             queue_depth=64).start(warm=False)
    res = run_open_loop(server, U_LINES, rate_rps=20000.0, n_requests=3000,
                        seed=12, drain_timeout_s=60.0, label="overload")
    assert res["drained"] is True
    assert res["shed"] > 0
    assert res["served"] + res["shed"] == 3000
    assert res["max_queue"] <= 64
    assert _cascades("serving")
    gentle = run_open_loop(server, U_LINES, rate_rps=50.0, n_requests=20,
                           seed=13, drain_timeout_s=60.0, label="gentle")
    assert gentle["drained"] and gentle["max_queue"] < res["max_queue"]
    assert server.stop()


# ---------------------------------------------------------------------------
# the serve CLI against the JAX CLIs


@pytest.fixture(scope="module")
def serve_corpus(tmp_path_factory):
    """A corpus, the JAX batch CLI's recommends and each package's serve
    CLI's serving artifact."""
    root = tmp_path_factory.mktemp("serve_cli")
    d = root / "in"
    d.mkdir()
    (d / "D.dat").write_text("\n".join(generate_transactions(
        n_txns=1500, n_items=60, seed=31)) + "\n")
    (d / "U.dat").write_text("\n".join(generate_user_baskets(
        n_users=300, n_items=60, seed=32)) + "\n")
    inp = str(d) + "/"
    batch = str(root / "jax_batch") + "/"
    os.makedirs(batch)
    assert jax_main([inp, batch, "--min-support", "0.03", *JAX_FLAGS]) == 0
    art = str(root / "jax_art") + "/"
    os.makedirs(art)
    assert jax_main(["serve", inp, art, "--min-support", "0.03",
                     "--save-serving", "--platform", "cpu",
                     "--num-devices", "1"]) == 0
    torch_art = str(root / "torch_art") + "/"
    os.makedirs(torch_art)
    assert torch_main(["serve", inp, torch_art, "--min-support", "0.03",
                       "--save-serving", "--platform", "cpu"]) == 0
    with open(batch + "recommends", "rb") as f:
        want = f.read()
    return {"root": root, "in": inp, "batch": want, "jax_art": art,
            "torch_art": torch_art}


SERVE_MODES = {
    "closed": [],
    "rate": ["--rate", "3000", "--seed", "5"],
    "from_serving": ["--from-serving", "ART"],
    "hosts2": ["--hosts", "2", "--batch-rows", "64"],
}


@pytest.mark.parametrize("mode", sorted(SERVE_MODES))
def test_serve_cli_writes_the_jax_serve_and_batch_bytes(serve_corpus, mode):
    """The port's serve CLI on the CPU writes the JAX serve CLI's bytes
    in the same mode, which are the JAX batch CLI's; --from-serving
    loads the JAX-written artifact in the port and the port-written one
    in the JAX package."""
    root, inp = serve_corpus["root"], serve_corpus["in"]
    outs = {}
    for pkg in ("torch", "jax"):
        out = str(root / f"{mode}_{pkg}") + "/"
        os.makedirs(out)
        args = [a for a in SERVE_MODES[mode]]
        if mode == "from_serving":
            # Each package restarts from the other's artifact.
            args[1] = (serve_corpus["jax_art"] if pkg == "torch"
                       else serve_corpus["torch_art"])
        if pkg == "torch":
            rc = torch_main(["serve", inp, out, "--min-support", "0.03",
                             "--platform", "cpu", *args])
        else:
            rc = jax_main(["serve", inp, out, "--min-support", "0.03",
                           "--platform", "cpu", "--num-devices", "1", *args])
        assert rc == 0, pkg
        with open(out + "recommends", "rb") as f:
            outs[pkg] = f.read()
    assert outs["torch"] == outs["jax"] == serve_corpus["batch"]


def test_serve_cli_trace_metrics_dump_and_restart_record(serve_corpus,
                                                         tmp_path, capsys):
    """--save-serving, --trace and --metrics-dump: the trace holds the
    serving spans and the fetch.serve_match span, the dump the served
    count; a --from-serving run records one serving_restart."""
    from fastapriori_tpu_torch.obs import metrics as obs_metrics
    from fastapriori_tpu_torch.obs import trace

    out = str(tmp_path) + "/"
    trace_path = str(tmp_path / "t.json")
    dump = str(tmp_path / "metrics.prom")
    try:
        assert torch_main(["serve", serve_corpus["in"], out, "--min-support",
                           "0.03", "--platform", "cpu", "--save-serving",
                           "--metrics", "--trace", trace_path,
                           "--metrics-dump", dump]) == 0
    finally:
        trace.TRACER.disable()
        trace.TRACER.reset()
        obs_metrics.reload_from_env()
    err = capsys.readouterr().err
    assert "==== serve: 300 served, 0 shed" in err
    stats = [json.loads(ln) for ln in err.splitlines()
             if ln.startswith('{"event": "serve"')][-1]
    assert stats["model"]["engine"] == "device"
    assert stats["model"]["rule_table_host_bytes"] == 0
    with open(trace_path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"serve.batch", "serve.dedup", "serve.pack", "serve.scan",
            "serve.respond", "fetch.serve_match",
            "fetch.serve_swap_ready"} <= names
    with open(dump) as f:
        assert "fa_serve_served_total 300" in f.read()
    with open(out + "recommends", "rb") as f:
        assert f.read() == serve_corpus["batch"]
    ledger.reset()
    out2 = str(tmp_path / "restart") + "/"
    os.makedirs(out2)
    assert torch_main(["serve", serve_corpus["in"], out2, "--platform",
                       "cpu", "--from-serving", out]) == 0
    assert ledger.summary().get("serving_restart") == 1


@pytest.mark.parametrize("spec", ["oom", "abort"])
def test_serve_cli_exits_1_after_a_failed_batch(serve_corpus, tmp_path,
                                                monkeypatch, capsys, spec):
    """Departs from the JAX serve CLI (exit 0 with "0" answers): an
    exhausted fetch.serve_match makes each batch a serve_error, an
    injected abort stops the dispatcher; either way the CLI exits 1 and
    writes no recommends."""
    monkeypatch.setenv("FA_RETRY_MAX", "2")
    monkeypatch.setenv("FA_RETRY_BACKOFF_MS", "0")
    retry.reload_policy_from_env()
    failpoints.arm("fetch.serve_match", spec)
    out = str(tmp_path) + "/"
    assert torch_main(["serve", serve_corpus["in"], out, "--min-support",
                       "0.03", "--platform", "cpu"]) == 1
    assert "batches failed" in capsys.readouterr().err
    assert not os.path.exists(out + "recommends")
    assert "serve_error" in ledger.summary()
    assert _cascades("rule_scan") == [] and _cascades("serve_scan") == []


def test_serve_cli_refuses_save_serving_without_output(serve_corpus,
                                                        capsys):
    assert torch_main(["serve", serve_corpus["in"], "--platform", "cpu",
                       "--save-serving"]) == 2
    assert "output prefix" in capsys.readouterr().err


def test_serve_cli_stdin_requests_answer_on_stdout(serve_corpus, monkeypatch,
                                                   capsys):
    with open(serve_corpus["in"] + "U.dat") as f:
        monkeypatch.setattr("sys.stdin", io.StringIO(f.read()))
    err = io.StringIO()
    with redirect_stderr(err):
        assert torch_main(["serve", serve_corpus["in"], "--min-support",
                           "0.03", "--platform", "cpu", "--requests",
                           "-"]) == 0
    assert capsys.readouterr().out.encode() == serve_corpus["batch"]
