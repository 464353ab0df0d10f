"""The port's serving mesh and pipelined dispatcher (fastapriori_tpu_torch/
serve/router.py, server.py) against the JAX package's: counterparts of
tests/test_serve_router.py on in-process hosts (the JAX ``ProcHost``
waits for the multi-GPU slice): the spill order (equal to the JAX
package's ``spill_order``), the strict FA_SERVE_PIPELINE_DEPTH /
FA_SERVE_HOSTS knobs, pipelined = serial answers, ring buffering, shed
conservation, swaps under the pipeline and across the mesh, a host
killed mid-burst, total loss, and the metrics merge and render."""

import threading
import time

import pytest

from conftest import random_dataset, tokenized
from fastapriori_tpu.parallel.hier import spill_order as jax_spill_order
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.obs import metrics as obs_metrics
from fastapriori_tpu_torch.preprocess import preprocess
from fastapriori_tpu_torch.reliability import failpoints, ledger
from fastapriori_tpu_torch.serve import (
    LocalHost,
    MeshRouter,
    RecommendServer,
    ServingState,
)
from fastapriori_tpu_torch.serve import router as serve_router
from fastapriori_tpu_torch.serve import server as serve_server
from fastapriori_tpu_torch.serve.router import spill_order
from test_torch_serve import _jax_batch_answers


@pytest.fixture(autouse=True)
def _clean_state():
    failpoints.disarm_all()
    ledger.reset()
    serve_server.reload_from_env()
    serve_router.reload_from_env()
    yield
    failpoints.disarm_all()
    ledger.reset()
    serve_server.reload_from_env()
    serve_router.reload_from_env()


def _state(seed=6, min_support=0.05, engine="auto", **cfg_kw):
    d_lines = tokenized(random_dataset(seed, n_txns=250, max_len=8))
    data = preprocess(d_lines, min_support)
    cfg = MinerConfig(min_support=min_support, engine="level", **cfg_kw)
    levels = FastApriori(config=cfg, device="cpu").mine_levels_raw(data)
    return ServingState(
        levels, data.item_counts, data.freq_items, data.item_to_rank,
        config=cfg, device="cpu", engine=engine,
    )


U_LINES = tokenized(random_dataset(60, n_txns=200))


def _gate_state(st):
    gate = threading.Event()
    orig = st.recommend_batch

    def gated(lines):
        gate.wait(30.0)
        return orig(lines)

    st.recommend_batch = gated
    return gate


# ---------------------------------------------------------------------------
# spill_order (the port's copy of parallel/hier.py's)


def test_spill_order_flat_ring():
    assert spill_order(0, 4) == [0, 1, 2, 3]
    assert spill_order(2, 4) == [2, 3, 0, 1]
    assert spill_order(0, 1) == [0]


def test_spill_order_pod_local_first():
    order = spill_order(5, 8, groups=2)
    assert order[:4] == [5, 6, 7, 4]
    assert sorted(order[4:]) == [0, 1, 2, 3]
    assert sorted(spill_order(3, 8, groups=4)) == list(range(8))
    # The JAX package's order, host for host, auto and explicit grids.
    for n in (1, 2, 3, 4, 6, 8, 9, 12, 16):
        for groups in {0, 1, *(g for g in (2, 3, 4) if n % g == 0)}:
            for primary in range(n):
                assert spill_order(primary, n, groups) == \
                    jax_spill_order(primary, n, groups), (primary, n, groups)


def test_spill_order_primary_out_of_range():
    with pytest.raises(InputError, match="primary"):
        spill_order(4, 4)
    with pytest.raises(InputError, match="primary"):
        spill_order(-1, 4)
    with pytest.raises(InputError, match="does not divide"):
        spill_order(0, 8, groups=3)


# ---------------------------------------------------------------------------
# Strict env knobs


def test_pipeline_depth_env_strict(monkeypatch):
    monkeypatch.setenv("FA_SERVE_PIPELINE_DEPTH", "3")
    serve_server.reload_from_env()
    assert serve_server.pipeline_depth_from_env() == 3
    monkeypatch.setenv("FA_SERVE_PIPELINE_DEPTH", "0")
    serve_server.reload_from_env()
    assert serve_server.pipeline_depth_from_env() == 0
    monkeypatch.setenv("FA_SERVE_PIPELINE_DEPTH", "deep")
    serve_server.reload_from_env()
    with pytest.raises(InputError, match="FA_SERVE_PIPELINE_DEPTH"):
        serve_server.pipeline_depth_from_env()
    monkeypatch.setenv("FA_SERVE_PIPELINE_DEPTH", "-1")
    serve_server.reload_from_env()
    with pytest.raises(InputError, match="FA_SERVE_PIPELINE_DEPTH"):
        serve_server.pipeline_depth_from_env()


def test_hosts_env_strict(monkeypatch):
    monkeypatch.setenv("FA_SERVE_HOSTS", "4")
    serve_router.reload_from_env()
    assert serve_router.hosts_from_env() == 4
    monkeypatch.setenv("FA_SERVE_HOSTS", "many")
    serve_router.reload_from_env()
    with pytest.raises(InputError, match="FA_SERVE_HOSTS"):
        serve_router.hosts_from_env()
    monkeypatch.setenv("FA_SERVE_HOSTS", "0")
    serve_router.reload_from_env()
    with pytest.raises(InputError, match="FA_SERVE_HOSTS"):
        serve_router.hosts_from_env()


def test_server_rejects_negative_pipeline_depth():
    st = _state()
    with pytest.raises(InputError, match="pipeline_depth"):
        RecommendServer(st, pipeline_depth=-2)


# ---------------------------------------------------------------------------
# Two-stage pipelined dispatcher


def test_pipelined_matches_serial_responses():
    """Depth 2 (two stages) answers exactly what depth 0 (serial)
    answers, which is the JAX batch pipeline's answer."""
    expected = list(_jax_batch_answers())
    assert _state().recommend_batch(U_LINES) == expected
    for depth in (0, 2):
        server = RecommendServer(_state(), batch_rows=32, linger_ms=0.5,
                                 pipeline_depth=depth).start()
        reqs = [server.submit_wait(t) for t in U_LINES]
        assert server.wait_for(reqs, timeout_s=60.0)
        assert [r.item for r in reqs] == expected, f"depth={depth}"
        assert server.stats()["pipeline_depth"] == depth
        assert server.stop()


def test_pipelined_pack_stage_packs_on_a_warm_state():
    """On a warm device state the pack stage cuts the bitmap blocks
    (no device work) and the scan stage launches on them unchanged."""
    st = _state(engine="device")
    packed_blocks = []
    real = st.pack_batch

    def spy(lines):
        packed = real(lines)
        packed_blocks.append(packed.blocks)
        return packed

    st.pack_batch = spy
    server = RecommendServer(st, batch_rows=32, linger_ms=0.0,
                             pipeline_depth=2).start()
    reqs = [server.submit_wait(t) for t in U_LINES]
    assert server.wait_for(reqs, timeout_s=60.0)
    assert [r.item for r in reqs] == list(_jax_batch_answers())
    assert packed_blocks and all(b is not None for b in packed_blocks)
    # One launch per packed block, plus the warm probe.
    assert st.scan_dispatches == 1 + sum(len(b) for b in packed_blocks)
    assert server.stop()


def test_pipelined_ring_actually_buffers():
    st = _state()
    gate = _gate_state(st)
    server = RecommendServer(st, batch_rows=8, linger_ms=0.0, queue_depth=256,
                             pipeline_depth=2).start(warm=False)
    reqs = [server.submit(t) for t in U_LINES[:80]]
    deadline = time.monotonic() + 10.0
    while server.stats()["ring_peak"] < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    peak = server.stats()["ring_peak"]
    gate.set()
    assert server.wait_for(reqs, timeout_s=60.0)
    assert peak >= 1
    assert server.stats()["ring_peak"] <= 2
    assert server.stop()


def test_pipelined_shed_conservation():
    st = _state()
    gate = _gate_state(st)
    server = RecommendServer(st, batch_rows=8, linger_ms=0.0, queue_depth=16,
                             pipeline_depth=2).start(warm=False)
    reqs = [server.submit(t) for t in (U_LINES * 2)[:300]]
    gate.set()
    assert server.wait_for(reqs, timeout_s=60.0)
    shed = sum(1 for r in reqs if r.shed)
    served = sum(1 for r in reqs if not r.shed)
    assert served + shed == 300
    stats = server.stats()
    assert stats["served"] == served
    assert stats["shed"] == shed
    assert stats["submitted"] == 300
    assert server.stop()


def test_pipelined_hot_swap_never_mixes_tables():
    st_a, st_b = _state(seed=6), _state(seed=7)
    assert st_a.signature != st_b.signature
    gate = _gate_state(st_a)
    server = RecommendServer(st_a, batch_rows=16, linger_ms=0.0,
                             pipeline_depth=2).start(warm=False)
    before = [server.submit(t) for t in U_LINES[:50]]
    ev = server.swap(st_b)
    after = [server.submit(t) for t in U_LINES[:50]]
    gate.set()
    assert server.wait_for(before + after, timeout_s=60.0)
    assert ev.wait(30.0)
    assert {r.model for r in before} == {st_a.signature}
    assert {r.model for r in after} == {st_b.signature}
    expected_b = list(_jax_batch_answers(seed=7))
    assert [r.item for r in after] == expected_b[:50]
    assert server.stop()


# ---------------------------------------------------------------------------
# MeshRouter on LocalHosts


def _mesh(n=2, seeds=None, gated=False, **server_kw):
    seeds = seeds or [6] * n
    states, gates, hosts = [], [], []
    for i, seed in enumerate(seeds):
        st = _state(seed=seed)
        if gated:
            gates.append(_gate_state(st))
        states.append(st)
        hosts.append(LocalHost(
            f"h{i}", RecommendServer(st, **server_kw).start(warm=False)))
    return MeshRouter(hosts), hosts, states, gates


def test_mesh_routes_and_aggregates():
    expected = list(_jax_batch_answers())
    mesh, hosts, _, _ = _mesh(2, batch_rows=32, linger_ms=0.5)
    reqs = [mesh.submit(t) for t in U_LINES]
    assert mesh.wait_for(reqs, timeout_s=60.0)
    assert [r.item for r in reqs] == expected
    st = mesh.stats()
    assert st["served"] == len(U_LINES)
    assert st["shed"] == 0
    assert st["hosts"] == 2 and st["hosts_lost"] == 0
    per_host = {h["host"]: h["served"] for h in st["per_host"]}
    assert all(v > 0 for v in per_host.values()), per_host
    snap = mesh.metrics_snapshot()
    assert snap["fa_serve_served_total"] == len(U_LINES)
    text = mesh.metrics_text()
    assert f"fa_serve_served_total {len(U_LINES)}" in text
    assert "fa_mesh_submitted_total" in text
    assert mesh.stop()


def test_mesh_hot_swap_never_mixes_tables():
    mesh, hosts, states, gates = _mesh(2, gated=True, batch_rows=16,
                                       linger_ms=0.0)
    old_sig = states[0].signature
    new_states = [_state(seed=7), _state(seed=7)]
    new_sig = new_states[0].signature
    assert old_sig != new_sig
    before = [mesh.submit(t) for t in U_LINES[:60]]
    done = threading.Event()

    def do_swap():
        mesh.swap(new_states, timeout_s=60.0)
        done.set()

    swapper = threading.Thread(target=do_swap, daemon=True)
    swapper.start()
    time.sleep(0.05)
    for g in gates:
        g.set()
    assert done.wait(60.0)
    after = [mesh.submit(t) for t in U_LINES[:60]]
    assert mesh.wait_for(before + after, timeout_s=60.0)
    assert {r.model for r in before} == {old_sig}
    assert {r.model for r in after} == {new_sig}
    assert mesh.stats()["swaps"] == 1
    swapper.join(10.0)
    assert mesh.stop()


def test_mesh_swap_payload_count_strict():
    mesh, _, _, _ = _mesh(2, batch_rows=16)
    with pytest.raises(InputError, match="payload"):
        mesh.swap([_state(seed=7)])
    assert mesh.stop()


def test_mesh_exact_shed_accounting_under_overload():
    mesh, hosts, states, gates = _mesh(
        2, gated=True, batch_rows=8, linger_ms=0.0, queue_depth=8,
        pipeline_depth=2)
    n = 400
    reqs = [mesh.submit((U_LINES * 2)[i % len(U_LINES)]) for i in range(n)]
    router_shed = sum(1 for r in reqs if r.done and r.shed)
    assert router_shed > 0
    for g in gates:
        g.set()
    assert mesh.wait_for(reqs, timeout_s=60.0)
    served = sum(1 for r in reqs if not r.shed)
    shed = sum(1 for r in reqs if r.shed)
    assert served + shed == n
    st = mesh.stats()
    assert st["submitted"] == n
    assert st["served"] == served
    assert st["shed"] == shed
    assert st["router_shed"] >= router_shed
    host_shed = sum(h["shed"] for h in st["per_host"])
    assert host_shed + st["router_shed"] == shed
    cascades = [e for e in ledger.snapshot()
                if e.get("kind") == "cascade" and e.get("chain") == "serving"
                and e.get("reason") == "mesh_queue_full"]
    assert len(cascades) >= 1
    assert mesh.stop()


def test_mesh_kill_host_mid_burst_survivors_serve():
    expected = list(_jax_batch_answers())
    mesh, hosts, states, gates = _mesh(2, gated=True, batch_rows=16,
                                       linger_ms=0.0, queue_depth=256)
    reqs = []
    for i in range(240):
        reqs.append(mesh.submit(U_LINES[i % len(U_LINES)]))
        if i == 90:
            hosts[0].kill()
    for g in gates:
        g.set()
    assert mesh.wait_for(reqs, timeout_s=60.0)
    assert all(r.done for r in reqs)
    st = mesh.stats()
    assert st["hosts_lost"] == 1
    assert st["lost_shed"] > 0
    for i, r in enumerate(reqs):
        if not r.shed:
            assert r.item == expected[i % len(U_LINES)]
    served = sum(1 for r in reqs if not r.shed)
    shed = sum(1 for r in reqs if r.shed)
    assert served + shed == 240
    assert st["shed"] == shed
    events = ledger.snapshot()
    assert any(e.get("kind") == "cascade" and e.get("chain") == "serve_mesh"
               and e.get("to") == "degraded" for e in events)
    assert any(e.get("kind") == "serve_host_lost" for e in events)
    assert mesh.stop()


def test_mesh_total_loss_sheds_globally():
    mesh, hosts, _, _ = _mesh(2, batch_rows=16, linger_ms=0.0)
    warm = [mesh.submit(t) for t in U_LINES[:8]]
    assert mesh.wait_for(warm, timeout_s=60.0)
    for h in hosts:
        h.kill()
    deadline = time.monotonic() + 10.0
    while mesh.stats()["hosts_lost"] < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert mesh.stats()["hosts_lost"] == 2
    reqs = [mesh.submit(t) for t in U_LINES[:10]]
    assert all(r.done and r.shed and r.item == "0" for r in reqs)
    assert any(e.get("kind") == "serve_mesh_empty"
               for e in ledger.snapshot())
    assert mesh.stop()


def test_mesh_host_whose_context_is_lost_is_routed_around():
    """A host whose dispatcher stopped on a lost CUDA context is a lost
    host to the router: its share goes to the survivor."""
    mesh, hosts, states, gates = _mesh(2, batch_rows=16, linger_ms=0.0,
                                       queue_depth=512)

    def dead(lines):
        raise RuntimeError("CUDA error: unspecified launch failure")

    states[0].recommend_batch = dead
    first = [mesh.submit(t) for t in U_LINES[:4]]
    assert mesh.wait_for(first, timeout_s=30.0)
    deadline = time.monotonic() + 10.0
    while mesh.stats()["hosts_lost"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    reqs = [mesh.submit(t) for t in U_LINES]
    assert mesh.wait_for(reqs, timeout_s=30.0)
    assert [r.item for r in reqs] == list(_jax_batch_answers())
    st = mesh.stats()
    assert st["hosts_lost"] == 1 and st["failed"] >= 1
    assert mesh.stop()


# ---------------------------------------------------------------------------
# Metrics merge / render


def test_merge_snapshots_counter_gauge_histogram():
    a = obs_metrics.MetricsRegistry()
    b = obs_metrics.MetricsRegistry()
    a.counter("c").inc(3)
    b.counter("c").inc(4)
    a.gauge("g").set(5)
    b.gauge("g").set(2)
    b.gauge("g").set(1)
    ha = a.histogram("h", bounds=(1.0, 10.0))
    hb = b.histogram("h", bounds=(1.0, 10.0))
    ha.observe(0.5)
    ha.observe(5.0)
    hb.observe(50.0)
    merged = obs_metrics.merge_snapshots([a.snapshot(), b.snapshot()])
    assert merged["c"] == 7
    assert merged["g"]["value"] == 5
    assert merged["g"]["max"] == 5
    assert merged["h"]["count"] == 3
    assert merged["h"]["buckets"]["1"] == 1
    assert merged["h"]["buckets"]["10"] == 1
    assert merged["h"]["buckets"]["+Inf"] == 1
    assert merged["h"]["sum"] == pytest.approx(55.5)


def test_merge_snapshots_bucket_mismatch_raises():
    a = obs_metrics.MetricsRegistry()
    b = obs_metrics.MetricsRegistry()
    a.histogram("h", bounds=(1.0, 10.0)).observe(1.0)
    b.histogram("h", bounds=(2.0, 20.0)).observe(1.0)
    with pytest.raises(ValueError, match="bucket"):
        obs_metrics.merge_snapshots([a.snapshot(), b.snapshot()])


def test_render_snapshot_prometheus_text():
    a = obs_metrics.MetricsRegistry()
    a.counter("fa_x_total", "things").inc(2)
    a.gauge("fa_depth").set(3)
    a.histogram("fa_lat_ms", bounds=(1.0, 10.0)).observe(0.5)
    text = obs_metrics.render_snapshot(a.snapshot(),
                                       helps={"fa_x_total": "things"})
    assert "# TYPE fa_x_total counter" in text
    assert "fa_x_total 2" in text
    assert "# HELP fa_x_total things" in text
    assert "fa_depth 3" in text
    assert 'fa_lat_ms_bucket{le="1"} 1' in text
    assert 'fa_lat_ms_bucket{le="+Inf"} 1' in text
    assert "fa_lat_ms_count 1" in text
    merged = obs_metrics.merge_snapshots([a.snapshot(), a.snapshot()])
    assert "fa_x_total 4" in obs_metrics.render_snapshot(merged)
