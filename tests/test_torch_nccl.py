"""The multi-process world's collectives over NCCL (parallel/mesh.py
``allgather_bytes``, ``agree``, ``psum``, ``tiled_all_gather`` and
``union_packed`` at world > 1), two ranks as subprocesses, rank r on
card r.  Each result the host reads must be complete when the helper
returns, ``agree`` must wait for every rank, and a rank of the CLI
whose peer died must end non-zero within ``FA_QUORUM_TIMEOUT_S``.

Needs two CUDA cards (NCCL refuses two ranks on one card): marked
``cuda`` and skipped without them.  This file imports no JAX, so it runs
on a GPU host without it: ``python -m pytest --noconftest
tests/test_torch_nccl.py``."""

import os
import socket
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUORUM_S = 8
RANK_TIMEOUT_S = 120

WORKER = r"""
import time
import torch
from fastapriori_tpu_torch.parallel import mesh

world = mesh.initialize_distributed("cuda")
r, n = world.rank, world.size
assert world.backend == "nccl", world.backend
assert world.device == torch.device("cuda", r), world.device
card = world.device
for it in range(50):
    # Lengths that differ by rank and by round, up to 4 MiB.
    blob = bytes([(r + it) % 251]) * ((r + 1) * (it + 1) * 40_000)
    got = mesh.allgather_bytes(blob)
    want = [bytes([(q + it) % 251]) * ((q + 1) * (it + 1) * 40_000)
            for q in range(n)]
    assert got == want, (it, [len(g) for g in got])
    host = torch.full((3,), r + it, dtype=torch.int64)
    assert mesh.psum([host]).tolist() == [n * it + n * (n - 1) // 2] * 3
    dev = torch.arange(1 << 20, device=card, dtype=torch.int32) + r
    cat = mesh.tiled_all_gather([dev])
    assert cat.device == card and cat.shape[0] == n << 20
    assert int(cat[(1 << 20) * (n - 1)].item()) == n - 1
    bits = torch.zeros(16, dtype=torch.uint8)
    bits[r] = 1 << (it % 8)
    u = mesh.union_packed([bits])
    assert [int(u[q]) for q in range(n)] == [1 << (it % 8)] * n
# agree waits for every rank: rank 1 arrives 2 s late.
if r == 1:
    time.sleep(2.0)
t0 = time.monotonic()
mesh.agree()
waited = time.monotonic() - t0
if r == 0:
    assert waited > 1.0, waited
mesh.shutdown_distributed()
print("ok", r, round(waited, 3))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(argv, rank_env=None, outs=None):
    """Two ranks of ``argv`` (a command after the interpreter, with
    ``{out}`` replaced by ``outs[r]``) on one free port; ``[(rc, stdout,
    stderr, seconds)]`` by rank."""
    port = _free_port()
    procs = []
    t0 = time.monotonic()
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(r), WORLD_SIZE="2",
                   LOCAL_RANK=str(r), FA_QUORUM_TIMEOUT_S=str(QUORUM_S),
                   **(rank_env or {}).get(r, {}))
        procs.append(subprocess.Popen(
            [sys.executable, *(outs[r] if a == "{out}" else a
                               for a in argv)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            left = max(RANK_TIMEOUT_S - (time.monotonic() - t0), 1)
            o, e = p.communicate(timeout=left)
            out.append((p.returncode, o, e, time.monotonic() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: NCCL refuses two ranks on one "
                    "card")


@pytest.mark.cuda
def test_nccl_collectives_are_complete_when_they_return():
    _two_cards()
    for rc, o, e, _ in _ranks(["-c", WORKER]):
        assert rc == 0, e[-3000:]
        assert o.startswith("ok"), o


@pytest.mark.cuda
def test_nccl_rank_whose_peer_died_ends_non_zero_in_the_bound(tmp_path):
    """tests/test_torch_distributed.py's failed fetch on rank 1, over
    NCCL: rank 1 exits on its failpoint, and rank 0, whose next
    collective never completes, ends with exit 3 (a lost peer) within
    the bound; neither writes."""
    _two_cards()
    from fastapriori_tpu_torch.utils.datagen import (
        generate_transactions,
        generate_user_baskets,
    )

    corpus = tmp_path / "in"
    corpus.mkdir()
    # A planted 6-itemset and heavy repeats: the level loop reaches the
    # level_bits fetch on both ranks.
    (corpus / "D.dat").write_text("".join(
        x + "\n" for x in ["3 5 8 13 21 34"] * 60 + ["1 2"] * 130
        + generate_transactions(n_txns=540, n_items=40, seed=17)))
    (corpus / "U.dat").write_text("".join(
        x + "\n" for x in generate_user_baskets(n_users=100, n_items=40,
                                                seed=18)))
    outs = [tmp_path / f"rank{r}" for r in range(2)]
    for o in outs:
        o.mkdir()
    (rc0, _, err0, t0), (rc1, _, err1, _) = _ranks(
        ["-m", "fastapriori_tpu_torch", str(corpus) + "/", "{out}",
         "--min-support", "0.05", "--distributed", "--engine", "level"],
        {1: {"FA_FAILPOINTS": "fetch.level_bits:oom",
             "FA_RETRY_BACKOFF_MS": "0"}}, outs=[str(o) + "/" for o in outs])
    assert rc1 != 0 and "fetch.level_bits" in err1, err1[-3000:]
    assert rc0 != 0 and "collective" in err0, err0[-3000:]
    # A lost peer is a classified fault-domain exit.
    assert rc0 == 3, err0[-3000:]
    # Start-up and the process group's first call take a few seconds.
    assert t0 < QUORUM_S + 30, t0
    assert not os.listdir(outs[0]) and not os.listdir(outs[1])
