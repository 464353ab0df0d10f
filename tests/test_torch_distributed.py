"""The port's multi-process world on the CPU (``--distributed`` over
``torch.distributed`` with gloo; parallel/mesh.py
``initialize_distributed``, ``allgather_bytes`` and the cross-process
collectives; preprocess.py's sharded ingest; models/apriori.py
``run_file_sharded`` and ``_shard_weight_totals``), held to the JAX
package's one-process CLI (``--num-devices 1``; its own multi-process
tier cannot run on jax 0.9.0 here) and to ``fastapriori_tpu/oracle.py``.
Two ranks run as subprocesses of the port's CLI on a free port, each
bounded by its own timeout; the JAX functions of the sharded ingest are
called with an injected process id, world size and allgather (ranks as
threads of this process)."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from fastapriori_tpu import oracle
from fastapriori_tpu.cli import main as jax_main
from fastapriori_tpu.config import MinerConfig as JaxConfig
from fastapriori_tpu.models.apriori import FastApriori as JaxApriori
from fastapriori_tpu.parallel import mesh as jmesh
from fastapriori_tpu.preprocess import (
    preprocess_file_sharded as jax_sharded,
)
from fastapriori_tpu.preprocess import read_shard as jax_read_shard
from fastapriori_tpu.preprocess import shard_byte_range as jax_byte_range
from fastapriori_tpu.preprocess import split_buffer_ranges as jax_split
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.device import DeviceContext
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.parallel import mesh as tmesh
from fastapriori_tpu_torch.preprocess import (
    preprocess_file_sharded,
    read_shard,
    shard_byte_range,
    split_buffer_ranges,
)
from fastapriori_tpu_torch.reliability import quorum
from fastapriori_tpu_torch.utils.datagen import (
    generate_transactions,
    generate_user_baskets,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_SUPPORT = "0.05"
# Each rank's own bound (a rank that outlives it is killed, and the test
# fails); the process group's is FA_QUORUM_TIMEOUT_S below.
RANK_TIMEOUT_S = 60
QUORUM_S = "10"


def _d_lines():
    """A planted 6-itemset, heavy repeats (a 2-digit weight) and 40
    items, so every engine reaches k = 6 and both ranks hold work."""
    return (["3 5 8 13 21 34"] * 60 + ["1 2"] * 130
            + generate_transactions(n_txns=540, n_items=40, seed=17))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("distributed")
    (d / "D.dat").write_text("".join(x + "\n" for x in _d_lines()))
    (d / "U.dat").write_text("".join(
        x + "\n" for x in generate_user_baskets(n_users=120, n_items=40,
                                                seed=18)))
    return str(d) + "/"


@pytest.fixture(scope="module")
def expected(corpus, tmp_path_factory):
    """The JAX one-process CLI's bytes, equal to the oracle's."""
    out = str(tmp_path_factory.mktemp("jax_out")) + "/"
    assert jax_main([corpus, out, "--min-support", MIN_SUPPORT,
                     "--platform", "cpu", "--engine", "level",
                     "--num-devices", "1"]) == 0
    exp_freq, exp_rec = oracle.run_pipeline(
        oracle.read_lines(corpus + "D.dat"),
        oracle.read_lines(corpus + "U.dat"), float(MIN_SUPPORT))
    got = {}
    for name, exp in (("freqItemset", exp_freq), ("recommends", exp_rec)):
        with open(out + name, "rb") as f:
            got[name] = f.read()
        assert got[name] == exp.encode("utf-8")
    return got


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(corpus, outs, args=(), env=None, rank_env=None, world=2):
    """``world`` ranks of the port's CLI with ``--distributed`` on one
    free port, rank r writing under ``outs[r]``; returns ``([(rc, stdout,
    stderr)] by rank, wall seconds)``.  Every rank is killed past
    ``RANK_TIMEOUT_S``."""
    port = _free_port()
    procs = []
    t0 = time.monotonic()
    for r in range(world):
        e = {k: v for k, v in os.environ.items()
             if not k.startswith("FA_")}
        e.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 FA_QUORUM_TIMEOUT_S=QUORUM_S, **(env or {}))
        e.update((rank_env or {}).get(r, {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fastapriori_tpu_torch", corpus, outs[r],
             "--min-support", MIN_SUPPORT, "--platform", "cpu",
             "--distributed", "--metrics", *args],
            cwd=ROOT, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    out = []
    try:
        for p in procs:
            left = max(RANK_TIMEOUT_S - (time.monotonic() - t0), 1)
            o, err = p.communicate(timeout=left)
            out.append((p.returncode, o, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out, time.monotonic() - t0


def _events(stderr: str, name: str):
    out = []
    for line in stderr.splitlines():
        if line.startswith("{") and f'"event": "{name}"' in line:
            out.append(json.loads(line))
    return out


def _outs(tmp_path, world=2):
    outs = []
    for r in range(world):
        d = tmp_path / f"rank{r}"
        d.mkdir()
        outs.append(str(d) + "/")
    return outs


@pytest.mark.parametrize("case,args,env", [
    ("level", ("--engine", "level"), {}),
    ("fused", ("--engine", "fused"), {}),
    ("vertical", ("--engine", "level"), {"FA_MINE_ENGINE": "vertical"}),
    ("two_shards_each", ("--engine", "level", "--num-devices", "2"), {}),
])
def test_two_ranks_write_the_jax_clis_bytes(case, args, env, corpus,
                                           expected, tmp_path):
    outs = _outs(tmp_path)
    trace = str(tmp_path / "run.trace.json")
    res, _ = _launch(corpus, outs, (*args, "--trace", trace), env)
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r}: {err[-2000:]}"
        (ev,) = _events(err, "distributed")
        assert (ev["backend"], ev["world"], ev["rank"]) == ("gloo", 2, r)
        assert ev["local_shards"] == (2 if "--num-devices" in args else 1)
        # Both phase lines on every rank, as the JAX CLI prints them.
        assert "==== Total time for get freqItemsets" in err
        assert "==== Total time for get recommends" in err
        (pre,) = _events(err, "preprocess")
        assert pre["global_count"] > pre["local_count"] > 0
        levels = _events(err, "level")
        if case == "fused":
            assert _events(err, "fused_mine") and not levels
        else:
            # This rank's own launches: one per level and local shard.
            assert levels and all(
                lv["launches"] > 0 for lv in levels if lv["k"] >= 3)
        if case == "vertical":
            assert _events(err, "arena_build")
        assert os.path.exists(quorum_path(trace, r))
    for name, want in expected.items():
        with open(outs[0] + name, "rb") as f:
            assert f.read() == want
    # Rank 1 writes nothing: no artifact, no manifest, no trace without
    # its rank in the name.
    assert os.listdir(outs[1]) == []
    assert not os.path.exists(trace)


def quorum_path(path: str, rank: int) -> str:
    """The JAX package's per-rank name (quorum.rank_path) at ``rank``."""
    base, _, ext = path.rpartition(".")
    return f"{base}.rank{rank}.{ext}"


def test_rank_path_names_per_rank_files(monkeypatch):
    assert quorum.rank_path("/o/run.trace.json") == "/o/run.trace.json"
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    monkeypatch.setattr(tmesh, "process_index", lambda: 1)
    assert quorum.rank_path("/o/run.trace.json") == quorum_path(
        "/o/run.trace.json", 1)
    assert quorum.rank_path("/o.d/trace") == "/o.d/trace.rank1"
    assert quorum.rank_suffix() == ".rank1" and not quorum.is_writer()


def test_failed_fetch_on_rank_1_ends_both_ranks(corpus, tmp_path):
    """An audited fetch that fails on rank 1 at every try (no cascade
    walk can help it) ends rank 1; rank 0's next collective finds the
    peer lost, a classified fault-domain exit (3) naming rank 1, within
    the bound, and neither rank writes."""
    outs = _outs(tmp_path)
    res, wall = _launch(
        corpus, outs, ("--engine", "level"),
        rank_env={1: {"FA_FAILPOINTS": "fetch.level_bits:oom",
                      "FA_RETRY_BACKOFF_MS": "0"}})
    (rc0, _, err0), (rc1, _, err1) = res
    assert rc1 != 0 and "fetch.level_bits" in err1
    assert rc0 != 0 and "collective" in err0
    assert rc0 == 3 and "quorum peer rank 1 lost" in err0
    assert wall < float(QUORUM_S) + 20
    assert os.listdir(outs[0]) == [] and os.listdir(outs[1]) == []


ABSENT_PEER = r"""
import os, sys, time
from fastapriori_tpu_torch.parallel import mesh
from fastapriori_tpu_torch.reliability.quorum import PeerLost

world = mesh.initialize_distributed("cpu")
if world.rank == 1:
    time.sleep(world.timeout_s + 3)
    os._exit(0)
t0 = time.monotonic()
try:
    mesh.agree()
except PeerLost as e:
    print(round(time.monotonic() - t0, 3), world.lost, e)
    sys.stdout.flush()
    os._exit(1)
"""


def test_a_peer_that_never_arrives_is_lost_within_the_bound():
    """A collective waits at most FA_QUORUM_TIMEOUT_S for a peer that is
    alive but never arrives (no connection closes to tell the backend),
    then raises PeerLost; the process group's own timeout is twice
    that."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", ABSENT_PEER], cwd=ROOT,
        env=dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 RANK=str(r), WORLD_SIZE="2", FA_QUORUM_TIMEOUT_S="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        out = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert procs[1].returncode == 0, out[1][1][-2000:]
    assert procs[0].returncode == 1, out[0][1][-2000:]
    waited, lost, msg = out[0][0].split(" ", 2)
    assert 2.0 <= float(waited) < 3.5 and lost == "True"
    assert "no result within 2 s" in msg


def test_distributed_without_env_runs_one_process(corpus, expected,
                                                  tmp_path, monkeypatch,
                                                  capsys):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    out = str(tmp_path) + "/"
    assert torch_main([corpus, out, "--min-support", MIN_SUPPORT,
                       "--platform", "cpu", "--distributed"]) == 0
    assert "running single-process" in capsys.readouterr().err
    assert tmesh.process_count() == 1
    for name, want in expected.items():
        with open(out + name, "rb") as f:
            assert f.read() == want


# ---------------------------------------------------------------------------
# The sharded ingest and the weight totals against the JAX functions,
# ranks as threads with an injected allgather.


def _thread_world(n, fn):
    """Run ``fn(rank, allgather)`` on ``n`` threads whose ``allgather``
    exchanges one blob per rank (a barrier per round; a rank that fails
    breaks it for the others within its timeout); the results in rank
    order, the first error raised."""
    barrier = threading.Barrier(n, timeout=30)
    slots = [None] * n

    def allgather_for(r):
        def allgather(blob):
            slots[r] = blob
            barrier.wait()
            out = list(slots)
            barrier.wait()
            return out
        return allgather

    with ThreadPoolExecutor(max_workers=n) as pool:
        futures = [pool.submit(fn, r, allgather_for(r)) for r in range(n)]
        return [f.result(timeout=60) for f in futures]


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_sharded_ingest_matches_jax(n, corpus):
    path = corpus + "D.dat"
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        data = f.read()
    assert split_buffer_ranges(data, n) == jax_split(data, n)
    assert [shard_byte_range(size, i, n) for i in range(n)] == [
        jax_byte_range(size, i, n) for i in range(n)]
    for i in range(n):
        assert read_shard(path, i, n) == jax_read_shard(path, i, n)
    assert b"".join(read_shard(path, i, n) for i in range(n)) == data
    got = _thread_world(n, lambda r, ag: preprocess_file_sharded(
        path, float(MIN_SUPPORT), process_id=r, num_processes=n,
        allgather=ag))
    want = _thread_world(n, lambda r, ag: jax_sharded(
        path, float(MIN_SUPPORT), process_id=r, num_processes=n,
        allgather=ag))
    for g, w in zip(got, want):
        assert (g.n_raw, g.min_count, g.freq_items, g.item_to_rank) == (
            w.n_raw, w.min_count, w.freq_items, w.item_to_rank)
        for field in ("item_counts", "basket_indices", "basket_offsets",
                      "weights"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))
        assert (g.shard.process_id, g.shard.num_processes,
                g.shard.local_counts, g.shard.max_weight) == (
            w.shard.process_id, w.shard.num_processes,
            w.shard.local_counts, w.shard.max_weight)


def test_shard_weight_totals_match_jax(corpus, monkeypatch):
    """Two ranks of two shards each: every rank ends with the same four
    totals as the JAX package's exchange, and the sparse thresholds are
    each rank's slice of the JAX package's."""
    path = corpus + "D.dat"
    datas = _thread_world(2, lambda r, ag: preprocess_file_sharded(
        path, float(MIN_SUPPORT), process_id=r, num_processes=2,
        allgather=ag))
    jdatas = _thread_world(2, lambda r, ag: jax_sharded(
        path, float(MIN_SUPPORT), process_id=r, num_processes=2,
        allgather=ag))
    t_pad = 2 * 2 * 256
    gather = threading.local()
    monkeypatch.setattr(tmesh, "allgather_bytes",
                        lambda blob: gather.fn(blob))
    monkeypatch.setattr(jmesh, "allgather_bytes",
                        lambda blob: gather.fn(blob))

    def port_rank(r, ag):
        gather.fn = ag
        ctx = DeviceContext("cpu", num_devices=2)
        ctx.mesh.world, ctx.mesh.rank = 2, r
        miner = FastApriori(config=MinerConfig(min_support=0.05),
                            context=ctx)
        per = miner._shard_weight_totals(datas[r], t_pad)
        return per, miner._sparse_thresholds(datas[r], t_pad, heavy=False)

    def jax_rank(r, ag):
        gather.fn = ag
        miner = JaxApriori(config=JaxConfig(min_support=0.05,
                                            num_devices=4))
        return miner._shard_weight_totals(jdatas[r], t_pad)

    got = _thread_world(2, port_rank)
    want = _thread_world(2, jax_rank)
    for r, ((per, thr), w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(per, w)
        assert per.sum() == sum(int(d.weights.sum()) for d in datas)
        full = np.maximum(1, -(-(datas[r].min_count * w) // int(w.sum())))
        assert thr == [int(x) for x in full[2 * r : 2 * r + 2]]


def test_allgather_bytes_in_one_process_and_its_failpoint():
    from fastapriori_tpu_torch.reliability import failpoints

    assert tmesh.allgather_bytes(b"abc") == [b"abc"]
    failpoints.arm("allgather", "io")
    try:
        with pytest.raises(OSError):
            tmesh.allgather_bytes(b"abc")
    finally:
        failpoints.disarm_all()


def test_a_rank_refuses_a_named_card_that_is_not_its_own(monkeypatch):
    from fastapriori_tpu_torch import device as tdevice
    from fastapriori_tpu_torch.errors import InputError

    monkeypatch.setattr(tdevice.mesh, "rank_card",
                        lambda: tdevice.torch.device("cuda", 1))
    with pytest.raises(InputError, match="not this rank's card"):
        DeviceContext("cuda:0")
    # The CPU is never moved onto the rank's card.
    assert DeviceContext("cpu", num_devices=2).mesh.devices == \
        [tdevice.torch.device("cpu")] * 2
