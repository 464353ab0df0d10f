"""The quorum domain across real processes on the CPU: ranks are
subprocesses of ``python -m fastapriori_tpu_torch ... --platform cpu``
on a small corpus (the JAX package's chaos corpus), each bounded by its
own timeout, held to the JAX CLI's bytes (``--num-devices 1``) and to
``fastapriori_tpu/oracle.py``.

File domains (``FA_QUORUM_DIR``, one-process ranks mining the whole
corpus): a killed rank is a classified exit 3 on its peer; a fused
fetch that fails on one rank walks ``engine`` on both, with the same
bytes; with ``FA_EPOCH_RETRY_MAX`` the survivor of a kill finishes with
the clean bytes, and without budget it exits 3; ranks whose weight
totals differ meet a ``MeshDivergence``.  Worlds (``--distributed``
over gloo): the torch transport's rendezvous in every rank's epoch
trail, then a fenced ``--checkpoint-every-level`` run, a kill, a
``--resume-from`` that writes the JAX CLI's bytes, and a stale fence
refused.  The JAX package's own multi-process tier cannot run here
(jax 0.9.0 on this CPU), so the JAX side is its one-process CLI."""

import json
import os
import shutil
import socket
import subprocess
import sys
import time

import pytest

from fastapriori_tpu import oracle
from fastapriori_tpu.cli import main as jax_main
from tools import chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_SUPPORT = "0.08"
# Each rank's own bound: a rank that outlives it is killed and the test
# fails (a hang never stalls the suite).
RANK_TIMEOUT_S = 60
NAMES = ("freqItemset", "recommends")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The chaos corpus and the JAX CLI's bytes on it, equal to the
    oracle's."""
    root = str(tmp_path_factory.mktemp("quorum_mp"))
    inp = chaos.make_inputs(root)
    out = os.path.join(root, "jax") + os.sep
    os.makedirs(out)
    assert jax_main([inp, out, "--min-support", MIN_SUPPORT, "--platform",
                     "cpu", "--num-devices", "1"]) == 0
    freq, rec = oracle.run_pipeline(oracle.read_lines(inp + "D.dat"),
                                    oracle.read_lines(inp + "U.dat"),
                                    float(MIN_SUPPORT))
    clean = {}
    for name, want in zip(NAMES, (freq, rec)):
        with open(out + name, "rb") as f:
            clean[name] = f.read()
        assert clean[name] == want.encode("utf-8")
    return inp, clean


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(tmp_path, inputs, args=(), env=None, rank_env=None, qdir=True,
           world=False, outs=None):
    """Two ranks of the port's CLI: a file domain under ``tmp_path/q``
    (``qdir``), a gloo world (``world``) or both.  ``inputs``: one input
    prefix per rank.  Returns ``([(rc, stderr)], out prefixes)``."""
    port = _free_port()
    if outs is None:
        outs = []
        for r in range(2):
            d = tmp_path / f"r{r}"
            d.mkdir()
            outs.append(str(d) + "/")
    procs = []
    t0 = time.monotonic()
    for r in range(2):
        e = {k: v for k, v in os.environ.items() if not k.startswith("FA_")}
        e.update(FA_QUORUM_TIMEOUT_S="5", FA_HEARTBEAT_MS="100",
                 FA_RETRY_BACKOFF_MS="0")
        e.update(env or {})
        if qdir:
            e.update(FA_QUORUM_DIR=str(tmp_path / "q"),
                     FA_QUORUM_RANK=str(r), FA_QUORUM_PROCS="2")
        extra = []
        if world:
            e.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r))
            extra = ["--distributed"]
        e.update((rank_env or {}).get(r, {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fastapriori_tpu_torch", inputs[r],
             outs[r], "--min-support", MIN_SUPPORT, "--platform", "cpu",
             "--metrics", *extra, *args],
            cwd=ROOT, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    res = []
    try:
        for p in procs:
            left = max(RANK_TIMEOUT_S - (time.monotonic() - t0), 1)
            _, err = p.communicate(timeout=left)
            res.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res, outs


def _bytes(out):
    got = {}
    for name in NAMES:
        with open(out + name, "rb") as f:
            got[name] = f.read()
    return got


def _events(err, name):
    return [json.loads(line) for line in err.splitlines()
            if line.startswith("{") and f'"event": "{name}"' in line]


def _degraded(err, kind):
    return [e for e in _events(err, "degraded") if e.get("kind") == kind]


# ---------------------------------------------------------------------------
# file domains


def test_file_domain_kill_is_a_classified_exit_3(corpus, tmp_path):
    inp, _ = corpus
    res, outs = _ranks(tmp_path, [inp, inp], ("--engine", "level"),
                       rank_env={1: {"FA_FAILPOINTS": "level.3:abort"}})
    (rc0, err0), (rc1, err1) = res
    assert rc1 == 1 and "level.3" in err1
    assert rc0 == 3, err0[-2000:]
    assert "quorum peer rank 1 lost" in err0
    assert _degraded(err0, "peer_lost")[0]["rank"] == 1
    assert not os.path.exists(outs[0] + "recommends")


def test_file_domain_divergence_degrades_both_ranks_in_lockstep(corpus,
                                                               tmp_path):
    """Rank 1's fused fetch fails past its retries: it walks engine
    fused -> level, rank 0 adopts the walk naming rank 1, and both write
    the clean bytes."""
    inp, clean = corpus
    res, outs = _ranks(tmp_path, [inp, inp], ("--engine", "fused"),
                       rank_env={1: {"FA_FAILPOINTS": "fetch.fused:oom*3"}})
    for r, (rc, err) in enumerate(res):
        assert rc == 0, f"rank {r}: {err[-2000:]}"
        assert _bytes(outs[r]) == clean
    walked = _degraded(res[1][1], "cascade")
    assert walked and walked[0]["reason"] == "transient_exhausted"
    (adopt,) = _degraded(res[0][1], "quorum_adopt")
    assert (adopt["chain"], adopt["to"], adopt["rank"]) == ("engine",
                                                            "level", 1)
    assert any(e["reason"] == "quorum" and e["src_rank"] == 1
               for e in _degraded(res[0][1], "cascade"))


def test_file_domain_elastic_kill_finishes_with_the_clean_bytes(corpus,
                                                               tmp_path):
    """Rank 1 dies at level.3 with FA_EPOCH_RETRY_MAX=1; rank 0, held at
    level.4 for twice the heartbeat bound (rank 1 may reach level 3 up to
    3 s after rank 0 reaches level 4), finds the loss at that boundary,
    meets alone at mesh epoch 1, re-seeds the level loop from level 4
    (its checkpoint re-committed under fence 2) and writes the clean
    bytes."""
    inp, clean = corpus
    res, outs = _ranks(
        tmp_path, [inp, inp], ("--engine", "level",
                               "--checkpoint-every-level"),
        env={"FA_EPOCH_RETRY_MAX": "1", "FA_QUORUM_TIMEOUT_S": "3"},
        rank_env={0: {"FA_FAILPOINTS": "level.4:delay@6000"},
                  1: {"FA_FAILPOINTS": "level.3:abort"}})
    (rc0, err0), (rc1, _) = res
    assert rc1 == 1 and rc0 == 0, err0[-2000:]
    assert _bytes(outs[0]) == clean
    (ep,) = _degraded(err0, "mesh_epoch")
    assert (ep["epoch"], ep["dead"], ep["members"]) == (1, [1], [0])
    assert _events(err0, "level_resume")[-1]["from_k"] == 5
    (q,) = _events(err0, "quorum")
    assert (q["mesh_epoch"], q["members"], q["fence"]) == (1, [0], 2)
    with open(outs[0] + "MANIFEST.json") as f:
        assert json.load(f)["fence"] == 2


def test_file_domain_elastic_exhaust_is_a_classified_exit_3(corpus,
                                                            tmp_path):
    inp, _ = corpus
    res, _ = _ranks(tmp_path, [inp, inp], ("--engine", "level"),
                    env={"FA_EPOCH_RETRY_MAX": "0"},
                    rank_env={1: {"FA_FAILPOINTS": "level.2:abort"}})
    (rc0, err0), (rc1, _) = res
    assert rc1 == 1 and rc0 == 3, err0[-2000:]
    assert "quorum peer rank 1 lost" in err0
    assert not _degraded(err0, "mesh_epoch")


def test_file_domain_wstotals_mismatch_is_a_mesh_divergence(corpus,
                                                            tmp_path):
    """Two ranks of two CPU shards each whose corpora differ by one
    line: the sparse reduction's weight totals differ, and both ranks
    meet a MeshDivergence at mine.wstotals (exit 3) before any sparse
    collective."""
    inp, _ = corpus
    other = tmp_path / "other"
    shutil.copytree(inp, other)
    with open(other / "D.dat", "a") as f:
        f.write("1 2 3\n")
    res, _ = _ranks(tmp_path, [inp, str(other) + "/"],
                    ("--engine", "level", "--num-devices", "2"))
    for r, (rc, err) in enumerate(res):
        assert rc == 3, f"rank {r}: {err[-2000:]}"
        assert "mesh divergence at 'mine.wstotals'" in err


# ---------------------------------------------------------------------------
# worlds


def test_world_torch_transport_meets_at_every_rendezvous(corpus, tmp_path):
    inp, clean = corpus
    res, outs = _ranks(tmp_path, [inp, inp], ("--engine", "level"),
                       qdir=False, world=True)
    for r, (rc, err) in enumerate(res):
        assert rc == 0, f"rank {r}: {err[-2000:]}"
        (q,) = _events(err, "quorum")
        assert (q["transport"], q["rank"], q["fence"]) == ("torch", r, None)
        assert [e["site"] for e in q["epoch_trail"]] == [
            "run.start", "mine.end", "rules.start", "run.end"]
    assert _bytes(outs[0]) == clean and os.listdir(outs[1]) == []


def test_world_fenced_checkpoint_kill_and_resume(corpus, tmp_path):
    """A fenced two-rank world: rank 0's checkpoint carries fence 1 in
    its meta and its manifest; a kill of rank 1 at level.3 ends rank 0
    with exit 3 naming rank 1; a world-2 --resume-from the checkpoint
    (the domain's per-run files cleared, its FENCE kept) restarts after
    level 3 and writes the JAX CLI's bytes; a FENCE moved past the
    checkpoint's is refused with StaleFenceError on both ranks."""
    import numpy as np

    inp, clean = corpus
    ck = ("--engine", "level", "--checkpoint-every-level")
    (tmp_path / "clean").mkdir()
    res, outs = _ranks(tmp_path / "clean", [inp, inp], ck, world=True)
    for r, (rc, err) in enumerate(res):
        assert rc == 0, f"rank {r}: {err[-2000:]}"
    with np.load(outs[0] + "checkpoint.npz") as z:
        assert int(z["meta"][4]) == 1
    with open(outs[0] + "MANIFEST.json") as f:
        assert json.load(f)["fence"] == 1
    assert _bytes(outs[0]) == clean and os.listdir(outs[1]) == []

    (tmp_path / "kill").mkdir()
    res, outs = _ranks(tmp_path / "kill", [inp, inp], ck, world=True,
                       rank_env={1: {"FA_FAILPOINTS": "level.3:abort"}})
    (rc0, err0), (rc1, err1) = res
    assert rc1 == 1 and "level.3" in err1
    assert rc0 == 3 and "quorum peer rank 1 lost" in err0, err0[-2000:]
    prefix = outs[0]
    with np.load(prefix + "checkpoint.npz") as z:
        assert int(z["meta"][0]) == 2 and int(z["meta"][4]) == 1

    qdir = tmp_path / "kill" / "q"
    for name in os.listdir(qdir):
        if name != "FENCE":
            os.unlink(qdir / name)
    (tmp_path / "kill" / "resumed").mkdir()
    res, outs = _ranks(
        tmp_path / "kill", [inp, inp], ("--engine", "level",
                                        "--resume-from", prefix),
        world=True, outs=[str(tmp_path / "kill" / "resumed") + "/",
                          str(tmp_path / "kill" / "r1") + "/"])
    for r, (rc, err) in enumerate(res):
        assert rc == 0, f"rank {r}: {err[-2000:]}"
        assert _events(err, "level_resume")[0]["from_k"] == 4
    assert _bytes(outs[0]) == clean
    with open(outs[0] + "MANIFEST.json") as f:
        assert json.load(f)["fence"] == 2

    for name in os.listdir(qdir):
        if name != "FENCE":
            os.unlink(qdir / name)
    (qdir / "FENCE").write_text('{"fence": 5}')
    res, _ = _ranks(tmp_path / "kill", [inp, inp],
                    ("--engine", "level", "--resume-from", prefix),
                    world=True, outs=outs)
    for r, (rc, err) in enumerate(res):
        assert rc == 2 and "stale checkpoint fence 1" in err, err[-2000:]
