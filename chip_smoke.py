#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fastapriori_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards N   # phases 12, 13, 11 (h), 14 over N cards

Phases, each of which fails the run (non-zero exit, no result line):

1. Build the three CUDA kernels from ``fastapriori_tpu_torch/csrc/`` with
   nvcc for sm_90a and the native ingest library (``preprocess.cc``) with
   the host compiler, one compiler per source, started together.
2. A quick check of each kernel against its plain PyTorch version at
   ragged shapes and at the edges of its design (K1 and K2 up to
   F = 41,088; K2 also in its rank-strided form, every shard of S = 2,
   3 and 4), before anything depends on them.
3. The main path: generate the T10I4D100K-shape corpus with the port's
   datagen (100,000 transactions over 1,000 items, seed 2017; 10,000 user
   baskets, seed 2018), run the port's CLI in-process at
   ``--min-support 0.0025`` and compare the SHA-256 of ``freqItemset`` and
   ``recommends`` with the digests the JAX package's CLI writes for the
   same files (``--platform cpu --engine level --num-devices 1``;
   tests/test_torch_e2e.py recomputes them).  Auto picks the bitmap
   layout and, by the JAX package's policy, the level engine: one
   ``engine_auto`` with choice level, because the level-3 candidate
   census from the ingest-overlapped pair program exceeds the fused
   engine's row-budget ceiling; then a ``tail_fuse`` from level 3, which
   the pair program counted; K1 and K2 launch, K3 not.  The same CLI with
   ``--engine fused`` (the same digests): one complete ``fused_mine`` at
   16,384 rows over the resident bitmap; K2 launches once, K1 and K3
   not.  The zero-flag CLI once more with ``FA_RULE_ENGINE=device`` set
   for that call only (the same digests): the device rule engine (a
   ``rule_gen_engine`` device and a ``rule_gen_device`` event, no
   fallback) and K2 over the table built on the device (``first_match``
   ``resident_table: true``); the auto runs must keep the host engine
   (below its 2^21 raw-rule floor) and the host-built table.
4. The vertical path: the kosarak-shape corpus (990,000 transactions over
   41,000 items, length 8, seed 2017; 10,000 user baskets, seed 2018),
   the CLI at ``--min-support 0.002`` with ``FA_MINE_ENGINE=vertical``
   set for that call only, both digests against the JAX CLI's
   (tests/test_torch_vertical.py recomputes them).  K3 and K2 must have
   launched, K1 not.  Then the same with ``FA_RULE_ENGINE=device`` too,
   checked as in phase 3.
   In phases 3 and 4 the launch counts are set to 0 just before each CLI
   call and read just after, and the CLI's ``--metrics`` stderr lines
   are printed again on stdout: one line of phase walls, one of the
   phases' other fields (shapes, counts, launches).  Every run must have
   ingested natively through the pipelined capture ingest on more than
   one thread (``"native": true, "pipelined": true, "capture": true`` and
   ``threads`` > 1 on the ``preprocess`` line); each kernel's launches
   must equal what the run's own ``level`` and ``first_match`` events
   count; float32 matmuls must run in full precision (no TF32); one line
   gives the run's peak device memory.
   Then each corpus goes once through the Python ingest (in the prep
   child) and once through the native one-call scan in-process: the
   arrays must be equal, and one line gives both walls and the thread
   count.  T10 is
   mined in-process through the capture path and through the one-call
   scan (``ingest_pipeline_blocks=1``), each with the auto choice and
   with the fused engine (over the resident bitmap, and over a packed
   upload): the levels must be equal; on the capture path every
   operation from the last block's arrival to the pair program's fetch,
   and inside each level of a fused or tail loop, runs under
   ``torch.cuda.set_sync_debug_mode("error")``.
5. K1 on a second counted path: T10 through the API with
   ``engine="level", tail_fuse_rows=0``, the counts set to 0 just before
   and read just after; K1 must launch as often as the run's ``level``
   events say, and as often as on the main path.
6. Fused compare: T10 mined in-process by the fused engine, by the level
   engine with its tail fold and without it, each twice (the first run
   of that configuration in this process, then warm), and once each in a
   fresh process (cold: the first mine of a process, after CUDA's
   set-up), the levels equal to phase 5's; the card's name and power
   limit beside the walls.  The
   fused loop is called directly at the fused run's row budget (its time,
   and its peak device memory against the memory model, which it must
   not exceed), and the tail fold seeded with level 4 at a prefix budget
   that cannot abort: both must give phase 5's levels.
7. Each kernel against its plain version at the shapes of each path
   that runs it (K1 on the main path, K2 on the main and vertical
   paths, K3 on the vertical path; exact equality: every output is an
   integer count or rank).  Every launch of each path is replayed at its
   own shapes and timed (``per_launch_ms``, ``ms_all_launches``); the
   replay must make as many launches as the counted run (the kernels'
   inputs come from the same capture ingest at the same thread count, so
   their shapes are the counted run's).  K1's level-3 shape is checked
   and timed even when level 3 came from the pair program, labelled "not
   on the path", so that its heaviest shape stays comparable.  At the
   heaviest launch, the kernel's, the plain version's and, for K1, a
   library formulation's times from CUDA events (for K2 also its device
   time from torch.profiler, which leaves out the host's launch
   overhead), and the least time the card could take for the same work
   (K3's counted two ways).  On each path's baskets, the recommender's
   host scan against its device path from one basket up, around its
   switch point (``DEVICE_MIN_CHECKS``).
8. The rule phase on each corpus, in-process (``rule_compare``): the
   device rule engine's arrays against the host engine's, element for
   element and confidences bitwise, its joins under
   ``set_sync_debug_mode("error")`` up to the mask fetches; the
   device-built scan table's real rows against the host-built table's;
   the recommends of K2 on each table; auto at the default floor (host)
   and at a floor of the raw count (device); K2 on the device-built
   table against its plain version, timed; and a "rule crossover" line:
   host ``gen_rules`` against the device engine and the table build,
   cold (in a fresh process) and warm.  The same on T10 at
   ``BIG_MIN_SUPPORT`` (0.0007, 3,003,819 raw rules), above the 2^21
   floor, where auto itself must take the device engine.

9. The reliability core, after phase 4 (``reliability_phases``): the
   zero-flag runs of phases 3 and 4 must have resolved their deferred
   survivor counts in one dispatch (``counts_resolve``).  Then (a) T10
   with ``--checkpoint-every-level``, clean, in-process; the same command
   in a child process with ``FA_FAILPOINTS=level.K:abort``, K a middle
   one of the levels the clean run's ``checkpoint`` events wrote: it
   must exit non-zero naming the site, its ``checkpoint.npz`` must pass
   ``validate_checkpoint`` and hold exactly the clean run's levels 2..K;
   then the checkpoint seeds an API mine with the tail fold off: the JAX
   digests, ``level_resume`` from K + 1, and K1 launched at least once
   and only for the levels after K (as the run's level events count
   them); then ``--resume-from`` in-process: the JAX digests,
   ``level_resume`` from K + 1 and no level at or below K counted (its
   fold may mine every remaining level).  (b) The same on kosarak with
   ``FA_MINE_ENGINE=vertical`` (K3 at least once after the resume, no
   API run).  (c) The same with ``--engine fused
   --checkpoint-cadence 2`` (checkpoint segments).  (d) ``--save-counts``
   (both digests), then ``--resume-from`` its phase-1 artifacts: the
   recommends digest, K2 once, no ingest and no K1.  (e) T10 through the
   API with a 1-byte ``pending_fetch_budget_bytes``: ``counts_drain``
   events and both digests.  (f) The zero-flag CLI with
   ``fetch.level_bits:oom*1`` armed: the digests, and exactly one
   ``retry`` ledger event at that site.  Every CLI run of the script
   that was not injected must leave the degradation ledger empty.
10. Observability (``observability_phase``): (a) the warm T10 zero-flag
   CLI four times each, in turns, plain, with ``--trace`` and with
   ``--profile-dir``, after one untimed round (the process's first
   profiler start): median, min and max wall of each beside the card's
   name and power limit; (b) T10 with ``--trace`` and ``--profile-dir``:
   the JAX digests, a valid Chrome trace whose spans nest run -> phase ->
   mine -> level with one level span per level event, and a device
   trace (obs/device_trace.py ``kernel_summary``) that names K1 7 times
   and K2 once, equal to the launch counters; (c) kosarak with
   ``FA_MINE_ENGINE=vertical --profile-dir``: K3 6 times in the device
   trace, equal to its counter; a capture whose device trace lacks a
   counted launch is retaken up to three times, then the phase fails;
   each capture's device time by stage (``by_stage``) and its heaviest
   rows are printed; (d) T10 with ``FA_NO_PALLAS=1``: the JAX digests,
   no hand kernel launched, ``plain_kernels`` on the level and
   ``first_match`` events, exactly one ``pallas_disabled`` ledger event.
11. Serving (``serving_phase``), on T10: (a) the ``serve`` CLI
   in-process, closed loop over U.dat, with ``--save-serving --trace
   --metrics-dump``: the JAX recommends digest, every request served (no
   shed, no ``serve_error``), the device engine on the host-built table
   with no rule-table byte over the link after the mount, K2 launched
   once per scan dispatch the state counted (the warm probe included),
   K1 as on the main path, ``serve.batch``, ``serve.scan`` and
   ``fetch.serve_match`` spans in the trace, the dump counting every
   request; (b) ``--from-serving`` (a)'s artifact: the same digest, one
   ``serving_restart``, the mount wall; (c) T10 at ``BIG_MIN_SUPPORT``:
   the device rule engine and the resident table, the recommends of the
   batch CLI at that support; (d) through the API on (a)'s model, at
   pipeline depths 2 and 0: the closed-batch capacity, a sustained
   open-loop run at 0.9x of it, an overload at 3x with the queue bounded
   at one micro-batch (sheds, recorded, the queue within its bound),
   then a recovery run at 0.5x without shed; every answer that model's
   batch answer; each batch's upload, launch and fetch issue under
   ``set_sync_debug_mode("error")``; K2 at a serving block against its
   plain version, and one basket's round trip at 32 rows against 4,096;
   (e) an open-loop run on (a)'s model hot-swapped to (c)'s mid-run:
   each response carries its model's signature and that model's answer,
   and the device memory drops at the barrier by at least the old
   table's bytes; (f) ``--hosts 2`` from (a)'s artifact: the digest,
   both hosts served; (g) ``FA_NO_PALLAS=1``: the digest, no K2 launch,
   one ``pallas_disabled``; (h) two worker-process hosts (``ProcHost``,
   ``python -m fastapriori_tpu_torch.serve.router --worker``) on cuda:0,
   started while (e) runs, serving (a)'s artifact behind the router:
   their ready signatures and answers equal a LocalHost run's on the
   same artifact, a swap across both hosts to (c)'s model (answers equal
   a LocalHost run's on it), then worker 0 killed a quarter into a
   burst (its in-flight requests answered "0" and counted as sheds,
   every other answer the model's); each worker's K2 launches from its
   ``stats.json`` (the survivor's equal to the scan dispatches of both
   models it mounted), the router process launching nothing.  Every
   serving run, CLI or API, has its launch counts set to 0 just before
   it and read just after: K2's equal the scan dispatches the serving
   states counted, and K1 and K3 launch no time in a run that mined
   nothing.
12. The one-process device mesh (``mesh_phase``): S transaction
   shards on the one card, a ``DeviceContext`` whose device list names
   cuda:0 S times, injected into the CLI's ``_run`` (``_run_serve``):
   T10 at S = 2 and 4 (auto: the sparse reduction, flat), at S = 8
   (auto: the sparse reduction over the two-level exchange, 2x4), at 4 =
   2 txn x 2 cand (dense), with ``--engine fused`` at S = 2, at S = 2 with
   ``FA_COUNT_SPARSE_CAP`` small enough to overflow (a dense redo),
   kosarak with ``FA_MINE_ENGINE=vertical`` at S = 2, and ``serve`` on
   T10's model at S = 2.  Each run: the launch counts set to 0 just
   before it and read just after, the JAX digests, K1, K2 and K3
   launched as often as the run's own ``level`` and ``first_match``
   events (or the serving state's scan dispatches) say, K2 on S shards,
   the reduction and exchange the JAX package chooses, and a line with
   the wall, the card, the peak device memory and the reductions'
   bytes (from the level, tail-fold and fused events).  The sharded
   rule join: T10 with ``FA_RULE_ENGINE=device`` at S = 2 and T10 at
   ``BIG_MIN_SUPPORT`` at S = 2 and 4 (auto's own device engine), each
   with the JAX digests, ``rule_gen_engine`` and ``rule_gen_device`` on
   S shards, K2 scanning the rank-strided table, each shard's slice 1/S
   of the one-shard table's rows.  Then K1 and K2 (T10) and K3
   (kosarak) at S = 2 through the API, and K2's strided launches (T10
   with the device rule engine, and at ``BIG_MIN_SUPPORT``): every
   launch's per-shard inputs recorded, held against the plain version
   with the same ``shard`` (equal exactly) and timed.
13. The multi-process world (``world_phase``): two rank workers (child
   processes started with the others) run the port's CLI with
   ``--distributed`` over ``env://`` on a free port, both on cuda:0 over
   gloo: T10 with zero flags, T10 with ``--engine fused``, kosarak with
   ``FA_MINE_ENGINE=vertical``.  Each case: the ``distributed`` event on
   both ranks, both ``====`` lines, each rank's K1, K2 and K3 launches
   equal to its own ``level`` and ``first_match`` events, the JAX digests
   from rank 0, nothing written by rank 1, and a line per rank with its
   wall and peak device memory; the phase's wall.

14. The quorum domain (``quorum_phase``, reliability/quorum.py): two
   ranks of the CLI on cuda:0 in four processes started before phase 12
   (one pair for the killed world): (a) a ``--distributed`` gloo world,
   T10 with zero flags: each rank's closing ``quorum`` event names the
   torch transport and the rendezvous ``run.start``, ``mine.end``,
   ``rules.start`` and ``run.end``, launches equal to each rank's
   events, the JAX digests from rank 0, nothing from rank 1; (b) the
   same world with a file domain (``FA_QUORUM_DIR``) and
   ``--checkpoint-every-level``: rank 0's checkpoint meta fence at least
   1 and equal to its ``MANIFEST.json`` fence; then rank 1 killed at a
   middle checkpointed level (``level.5`` when it is one): rank 0 exits
   3 naming rank 1 within 3 x ``FA_QUORUM_TIMEOUT_S`` (5 s); then
   ``--resume-from`` rank 0's checkpoint at world 2 (the domain's
   per-run files cleared, its FENCE kept): the JAX digests,
   ``level_resume`` after the killed level on both ranks, K1 only for
   the levels after it, the manifest at the next fence; (c) a file
   domain of two one-process ranks: T10 ``--engine fused`` with
   ``fetch.fused:oom*3`` on rank 1 (rank 1 walks engine fused -> level,
   rank 0's ledger holds ``quorum_adopt`` naming rank 1), and kosarak
   with ``FA_MINE_ENGINE=vertical`` and ``fetch.vlevel_bits:oom*3`` on
   rank 1, held 1.5 s at ``level.2``, rank 0 held 3 s at ``level.3``
   (rank 0 launches K3 at level 3, then takes the
   ``mine_engine`` clamp at a level boundary; K3 and then K1 launch on
   both ranks); both ranks write the JAX digests; (d) T10 with
   ``FA_EPOCH_RETRY_MAX=1``, rank 1 killed at ``level.5``, rank 0 held
   4 s at ``level.6``, past a 2 s bound: rank 0 finishes alone at mesh epoch
   1 with the JAX digests and a ``mesh_epoch_reseed`` flight note; with
   ``FA_EPOCH_RETRY_MAX=0`` the same kill ends rank 0 with exit 3.  One
   line per case: each rank's exit code, wall, peak device memory,
   launches, mesh epoch and fence.
15. The object-form library API at the MovieLens shape
   (``movielens_phase``): the prep child writes the doc corpus
   (``generate_doc_transactions``: 162,000 transactions over 59,000
   items, length 153, seed 2017; bench.py:96) and 16,200 user baskets
   (seed 2018; bench.py:1408-1414), whose files' SHA-256 must equal the
   JAX generators'; then, the launch counts set to 0 just before and
   read just after, ``FastApriori(0.1).run_file(D)``,
   ``AssociationRules(itemsets, freq_items, item_to_rank).run(users,
   use_device=True)``, ``save_freq_itemsets`` and ``save_recommends``:
   both digests equal the JAX CLI's, K1 and K2 launched as often as the
   run's level and first_match events say (K1 at least once, on the
   level loop; K2 on the table built from the object-form rules); one
   line with F, the levels, the itemset and rule counts, the walls of
   generation, mine (decode), rules, scan and writes, and the peak
   device memory; then every K1 launch replayed at the run's shapes and
   K2's scan block, each against its plain version.

``--cards N`` (N >= 2 visible cards) runs phases 1, 2, 12 and 13, with
each mesh's shard t on card ``t mod N`` and phase 13's rank r on card r
over NCCL, then phase 11 (h) with worker i on card i (T10's two models
mined and saved first) and phase 14's torch-transport cases (a) and
(b) over NCCL with rank r on card r, with the same checks; it prints
the mesh, world, ProcHost and quorum summaries, the first card's name
and power limit and the same last line.

Every child process starts first, when ``nvidia-smi`` is on the path:
the prep child, which writes both corpora and runs the Python ingest of
each (phase 4's compare) while this process builds the kernels, then
writes phase 15's corpus, the
cold runs of phases 6 and 8, one kill worker that serves phase 9's
three killed runs, and phase 13's two rank workers; phase 14's four
start just before phase 12.  All but the first
wait for their arguments on stdin, so
the seconds a process takes to start overlap the parent's work.  All
are stopped when the script ends.  Each log line starts with the
seconds since the script started.

Prints the card's name and power limit, the host's CPU model and core
count (ingest runs on the host), one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero
without a result when there is no CUDA device.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import queue
import shutil
import subprocess
import sys
import threading
import time

# freqItemset / recommends written by `python -m fastapriori_tpu <in>/
# <out>/ --min-support 0.0025 --platform cpu --engine level
# --num-devices 1` on the corpus of phase 3.
FREQ_SHA256 = "c3bdd20e19b8b42fc922ba854fc51efe81bf9803fb1bc62ae3eecff32ab4a707"
REC_SHA256 = "731e69db1ad76336588bfd65aefc2cdceca2895a396fe2cdf3a6d8e3e51f513a"
MIN_SUPPORT = "0.0025"

# Phase 4: the kosarak shape (bench.py:90) and the digests written by
# `FA_MINE_ENGINE=vertical python -m fastapriori_tpu <in>/ <out>/
# --min-support 0.002 --platform cpu --engine level --num-devices 1`.
KOSARAK = {
    "n_txns": 990_000, "n_items": 41_000, "avg_txn_len": 8, "seed": 2017,
    "n_users": 10_000, "user_seed": 2018, "min_support": "0.002",
    "freq_sha256":
        "9b510238756f3acba31addfac72f3c07255e57f1c88065fc4658129854799167",
    "rec_sha256":
        "b5a59dffec02a2fe3563f321739f211b889a4dea93807b682efa1d0b470f850b",
}

# Phase 15: the MovieLens-shape corpus (bench.py:96) and its users
# (bench.py:1408-1414), the SHA-256 of D.dat and U.dat as the JAX
# package's generators write them (tests/test_torch_datagen.py holds
# the port's generators to them), and of freqItemset / recommends
# written by `python -m fastapriori_tpu <in>/ <out>/ --min-support 0.1
# --platform cpu --engine level --num-devices 1` on those files.
MOVIELENS = {
    "n_txns": 162_000, "n_items": 59_000, "avg_txn_len": 153, "seed": 2017,
    "n_users": 16_200, "user_seed": 2018, "min_support": "0.1",
    "d_sha256":
        "22af453633275b3e3fef5b085cc0e679ec31ddf3860dfac9ee2cd5e195bb4208",
    "u_sha256":
        "144938a5b3a4c26eeb5c508fb341d06f20bfa9e6e0c9a320112b65ca14ca8015",
    "freq_sha256":
        "b71064e90528cf316f96630b62a69cce21250fa3474828f2729fa86a34c44e56",
    "rec_sha256":
        "f07567d5864104dc07721ff249ebee4a69e064f87f301e40266ebbe7dfa68354",
}

# Published H100 SXM peaks (dense; NVIDIA data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
# Per-SM results per clock for compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput), and the SMs.
BITWISE32_PER_CLK_SM = 64
POPC_PER_CLK_SM = 16
H100_SMS = 132

# Phase 8: T10 at this min support has 3,003,819 raw rules, above the
# JAX package's 2^21 floor of the auto rule engine (0.001 has 1,280,464).
BIG_MIN_SUPPORT = "0.0007"
# freqItemset / recommends written by `python -m fastapriori_tpu <in>/
# <out>/ --min-support 0.0007 --platform cpu --engine level
# --num-devices 1` on the corpus of phase 3 (phase 12's sharded rule
# join is held to them).
BIG_FREQ_SHA256 = (
    "3f27674ef80613b4b00455166283688eabf79d7bd5ce3d09b97b09fde39e2363")
BIG_REC_SHA256 = (
    "c52f9b86f616c1548cadc96727b0259ec409c1b1e1227aca0dcb03d56840a3b4")

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_smoke")


T_START = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, led by the seconds since the start."""
    print(f"[{time.perf_counter() - T_START:8.3f} s] {msg}", flush=True)


class Child:
    """A child process started ahead of its use: its script imports what
    it needs and then blocks reading its arguments, one JSON line, from
    stdin, so the seconds a process takes to start (Python, torch, the
    port) overlap the parent's work.  Its stderr goes to a file under
    :data:`WORK`.  :meth:`stop_all` ends every child still running."""

    live: list = []

    def __init__(self, name: str, script: str):
        os.makedirs(WORK, exist_ok=True)
        self.name = name
        self.err_path = os.path.join(
            WORK, "child_" + "".join(c if c.isalnum() else "_"
                                     for c in name) + ".err")
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", script], cwd=ROOT, text=True,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err)
        self.lines = None
        Child.live.append(self)

    def stderr(self) -> str:
        with open(self.err_path) as f:
            return f.read()

    def run(self, args, timeout: float = 300) -> tuple:
        """Hand the child its arguments and wait for it to end:
        ``(exit code, stdout, stderr)``."""
        out, _ = self.proc.communicate(json.dumps(args) + "\n",
                                       timeout=timeout)
        return self.proc.returncode, out, self.stderr()

    def request(self, req: dict, timeout: float = 600) -> dict:
        """One request to a child that serves many (:data:`KILL_WORKER`):
        its :meth:`reply`."""
        self.send(req)
        return self.reply(timeout)

    def send(self, req: dict) -> None:
        """Hand a serving child one request without waiting for it."""
        self.proc.stdin.write(json.dumps(req) + "\n")
        self.proc.stdin.flush()

    def reply(self, timeout: float = 600) -> dict:
        """The next JSON reply: the child's next stdout line that starts
        ``REPLY``."""
        if self.lines is None:
            self.lines = queue.Queue()

            def read() -> None:
                for line in self.proc.stdout:
                    self.lines.put(line)
                self.lines.put("")

            threading.Thread(target=read, daemon=True).start()
        deadline = time.perf_counter() + timeout
        while True:
            try:
                line = self.lines.get(
                    timeout=max(deadline - time.perf_counter(), 0.001))
            except queue.Empty:
                raise SystemExit(f"{self.name}: no reply in {timeout} s")
            if not line:
                raise SystemExit(f"{self.name}: the child exited "
                                 f"{self.proc.wait()}: "
                                 f"{self.stderr()[-2000:]}")
            if line.startswith("REPLY "):
                return json.loads(line[len("REPLY "):])

    @classmethod
    def stop_all(cls) -> None:
        for child in cls.live:
            if child.proc.poll() is None:
                child.proc.kill()
            child.proc.wait()
        cls.live.clear()


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def host_line() -> str:
    """The host's CPU (vendor, family, model number and model name, as
    the first processor of /proc/cpuinfo gives them: a virtualised host
    may report its model name as "unknown") and the cores this process
    may use."""
    fields = {}
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    cpu = " ".join(f"{k} {fields[k]}" for k in (
        "vendor_id", "cpu family", "model", "model name") if k in fields)
    return f"{cpu or 'unknown CPU'}, nproc {len(os.sched_getaffinity(0))}"


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0])


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of device time: every CUDA kernel that
    ``iters`` calls launch, summed from torch.profiler.  Unlike
    :func:`time_ms` it leaves out the card's idle gaps when the host's
    launch overhead outlasts the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # The profiler's device trace has come back empty once in a run whose
    # other profiles were full: a second and a third profile are taken
    # before that counts as a failure.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.device_time_total for e in prof.key_averages()
                       if e.device_type.name == "CUDA")
        if total_us > 0:
            return total_us / iters / 1e3
        log(f"torch.profiler recorded no device time (profile "
            f"{attempt + 1} of 3)")
    raise SystemExit("torch.profiler recorded no device time")


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require_equal(name: str, got, want) -> int:
    """Max abs difference of two integer tensors; exits unless they are
    equal (same shape, same values)."""
    import torch

    if got.shape != want.shape:
        raise SystemExit(f"{name}: shape {tuple(got.shape)} != "
                         f"{tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max().item())
    if err or not torch.equal(got, want):
        raise SystemExit(f"{name}: kernel disagrees with its plain version "
                         f"(max abs err {err})")
    return err


def quick_checks(device) -> None:
    """Phase 2: the three kernels at ragged shapes and at the edges of
    their designs (:func:`k1_quick_checks`, :func:`k2_quick_checks`,
    :func:`k3_quick_checks`) against their plain versions."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    k1_quick_checks(device, rng)
    k2_quick_checks(device, rng)
    k3_quick_checks(device, rng)
    torch.cuda.synchronize()


def k2_case(rng, mb: int, f: int, r: int, k: int, density: float) -> list:
    """Baskets of about ``density * F`` items (the last three rows padding,
    length 0; the column F - 1 zero everywhere), rules of 1..K items of
    which a third are taken from a basket's own items (so matches land at
    many ranks), the rest random, and the last 10 rules padding (size
    F + 1); antecedent padding positions point at column F - 1."""
    import numpy as np

    zcol = f - 1
    bask = (rng.random((mb, f)) < density).astype(np.int8)
    bask[:, zcol] = 0
    bask[max(mb - 3, 1):] = 0
    size = rng.integers(1, k + 1, size=r).astype(np.int32)
    ant = rng.integers(0, zcol, size=(r, k)).astype(np.int32)
    donors = rng.integers(0, mb, size=r)
    for q in np.flatnonzero(rng.random(r) < 1 / 3):
        items = np.flatnonzero(bask[donors[q]])
        if len(items) >= size[q]:
            ant[q, : size[q]] = rng.choice(items, size=size[q], replace=False)
    ant[np.arange(k)[None, :] >= size[:, None]] = zcol
    size[-10:] = f + 1
    ant[-10:] = zcol
    cons = rng.integers(0, zcol, size=r).astype(np.int32)
    return [bask, bask.sum(axis=1).astype(np.int32), ant, size, cons]


def k2_quick_checks(device, rng) -> None:
    """K2 against its plain version, exactly: F = 7,296 (above the 7,168
    an earlier design of the kernel took), F = 41,088 (the kosarak-shape
    corpus's 41,000 items padded, MB = 4,096, R = 65,536: the form that
    reads baskets from device memory), F not a multiple of 32 (200 and
    1,000: the packing pass's byte loop; 208: a last word of one 16-byte
    load), MB = 1 and MB not a
    multiple of the 64-basket group, R not a multiple of the 256-rule
    tile, a batch no rule matches (a full sweep), one that matches rule 0
    everywhere, rules whose consequent lies in every basket ahead of the
    first that fires, and K = 1, 16 and 40 (positions past the 32 staged
    ones read from device memory)."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.ops.match_kernel import (
        NO_MATCH,
        first_match,
        first_match_plain,
    )

    def check(name, case, want_np=None, **stride):
        args = [torch.from_numpy(x).to(device) for x in case]
        want = first_match_plain(*args, **stride)
        if want_np is not None and not torch.equal(
                want.cpu(), torch.from_numpy(want_np)):
            raise SystemExit(f"first_match {name}: the case is not what it "
                             f"claims")
        require_equal(f"first_match {name}", first_match(*args, **stride),
                      want)

    for name, mb, f, r, k, density in (
        ("ragged", 77, 200, 1000, 5, 0.1),
        ("F=208", 100, 208, 3000, 4, 0.05),
        ("F=1000", 130, 1000, 3000, 4, 0.02),
        ("F=7296", 300, 7296, 5000, 8, 0.003),
        ("F=41088", 4096, 41_088, 65_536, 6, 8 / 41_088),
        ("MB=1", 1, 384, 2000, 4, 0.05),
        ("K=1", 200, 384, 4000, 1, 0.03),
        ("K=16", 200, 384, 4000, 16, 0.05),
        ("K=40", 64, 384, 2000, 40, 0.2),
    ):
        check(name, k2_case(rng, mb, f, r, k, density))
    # The rank-strided form: each shard of S scans its slice (global
    # rank row·S + s), on both basket forms (F = 41,088: device memory).
    for name, mb, f, r, k, density, n_sh in (
        ("strided S=2", 300, 384, 5000, 6, 0.05, 2),
        ("strided S=3", 77, 200, 1000, 5, 0.1, 3),
        ("strided S=4 F=41088", 512, 41_088, 16_384, 6, 8 / 41_088, 4),
    ):
        case = k2_case(rng, mb, f, r, k, density)
        for sh in range(n_sh):
            check(f"{name} shard {sh}", case, shard=sh, n_shards=n_sh)
    f = 384
    # No basket holds an item of the rules' half of the columns.
    bask, blen, ant, size, cons = k2_case(rng, 500, f, 20_000, 4, 0.03)
    bask[:, f // 2:] = 0
    blen = bask.sum(axis=1).astype(np.int32)
    ant[ant < f // 2] += f // 2
    check("no match (full sweep)", [bask, blen, ant, size, cons],
          np.full(500, NO_MATCH, dtype=np.int32))
    # Column 0 in every real basket, column f - 2 in none: rule 0 fires.
    bask, blen, ant, size, cons = k2_case(rng, 300, f, 3000, 4, 0.05)
    bask[:-3, 0], bask[:, f - 2] = 1, 0
    blen = bask.sum(axis=1).astype(np.int32)
    size[0], ant[0], cons[0] = 1, [0, f - 1, f - 1, f - 1], f - 2
    want = np.where(blen > 0, 0, NO_MATCH).astype(np.int32)
    check("all match rule 0", [bask, blen, ant, size, cons], want)
    # Rules 0..499 hold columns 0 and 1 of every real basket but name
    # column 2, also in every basket, as consequent: none fires; rule 500
    # does.
    bask, blen, ant, size, cons = k2_case(rng, 300, f, 3000, 4, 0.05)
    bask[:-3, :3], bask[:, f - 2] = 1, 0
    blen = bask.sum(axis=1).astype(np.int32)
    size[:500] = rng.integers(1, 3, size=500)
    ant[:500] = f - 1
    ant[:500, 0] = 0
    ant[:500, 1] = np.where(size[:500] == 2, 1, f - 1)
    cons[:500] = 2
    size[500], ant[500], cons[500] = 1, [0, f - 1, f - 1, f - 1], f - 2
    want = np.where(blen > 0, 500, NO_MATCH).astype(np.int32)
    check("consequent in the basket", [bask, blen, ant, size, cons], want)


def k1_quick_checks(device, rng) -> None:
    """K1: T not a multiple of the 512-transaction sub-tile, M not a
    multiple of the 32-row tile, F not a multiple of 32 and F from 33 to
    41,088 (F = 1,000, 2,500 and 6,000 select the 256-, 128- and
    64-transaction sub-tiles; 300 the 512, 12,288 the 32; 12,320 and
    41,088, the kosarak-shape corpus's items padded, the form that reads
    B from device memory), k1 = 3 and 130, rows that cannot match
    (k1 - 1 items, empty), an S of padding rows only (one item in the
    zero column), and WB rows of more than one value (within a 32-column
    word and across words), which the kernel reads as bytes."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.ops.level_kernel import (
        level_counts,
        level_counts_plain,
    )

    def check(name, b, wb, s, k1):
        bt, wbt, st = (torch.from_numpy(x).to(device) for x in (b, wb, s))
        require_equal(f"level_counts {name}", level_counts(bt, wbt, st, k1),
                      level_counts_plain(bt, wbt, st, k1))

    def prefixes(m, f, k1, n_rows):
        # Rows hold exactly k1 items, except every fifth row (k1 - 1
        # items, never a match) and the rows from n_rows on (empty).
        s = np.zeros((m, f), dtype=np.int8)
        for i in range(n_rows):
            n_items = k1 - 1 if i % 5 == 4 else k1
            s[i, rng.choice(f, size=n_items, replace=False)] = 1
        return s

    for t, f, m, density in ((5003, 300, 77, 0.3), (1111, 33, 45, 0.5),
                             (1500, 1000, 70, 0.05), (900, 2500, 40, 0.03),
                             (700, 6000, 40, 0.02), (700, 12288, 41, 0.02),
                             (700, 12320, 41, 0.02),
                             (600, 41_088, 37, 0.002)):
        b = (rng.random((t, f)) < density).astype(np.int8)
        b[rng.random(t) < 0.05] = 1  # dense rows, so wide prefixes match
        wb = b * rng.integers(1, 128, size=(t, 1)).astype(np.int8)
        for k1 in (3, 130):
            if k1 <= f:
                check(f"T={t} F={f} M={m} k1={k1}", b, wb,
                      prefixes(m, f, k1, m - 5), k1)
        pad = np.zeros((m, f), dtype=np.int8)
        pad[:, f - 1] = 1  # padding rows only: never k1 = 3 items
        check(f"T={t} F={f} padding rows only", b, wb, pad, 3)
        if f <= 1000 or f > 12288:
            # A third of the rows keep one value, a third take one per
            # 32-column word, a third one per entry.
            mixed = wb.copy()
            rows = rng.permutation(t)
            per_word = (1 + np.arange(f) // 32 % 7).astype(np.int8)
            mixed[rows[: t // 3]] = b[rows[: t // 3]] * per_word
            per_entry = rng.integers(1, 128, size=(t, f)).astype(np.int8)
            rest = rows[t // 3 : 2 * t // 3]
            mixed[rest] = b[rest] * per_entry[rest]
            check(f"T={t} F={f} M={m} WB rows of mixed values", b, mixed,
                  prefixes(m, f, 3, m - 5), 3)


def k3_quick_checks(device, rng) -> None:
    """K3 at ragged shapes: NL, P and C multiples of nothing (the last
    512-lane chunk holds 17 lanes), prefix widths 1..8 with padded
    positions (the zero column f_pad - 1), 1, 11 and 31 planes (31 with
    the top two planes full; sums wrap alike mod 2^32 in the kernel and
    its plain version), rows without candidates and a row with 150, the
    zero column as an extension, a prefix whose AND is empty everywhere,
    and a lane chunk whose planes above 0 are all zero; and the compressed
    arena upload against the dense one."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.ops.vertical_kernel import (
        vertical_counts,
        vertical_counts_plain,
    )

    f_pad, nl, p = 200, 2 * 512 + 17, 77
    for n_planes in (1, 11, 31):
        arena = (rng.integers(0, 2**32, size=(f_pad + 1, nl), dtype=np.uint64)
                 | rng.integers(0, 2**32, size=(f_pad + 1, nl),
                                dtype=np.uint64)).astype(np.uint32)
        arena[f_pad - 1] = 0
        arena[f_pad] = 0xFFFFFFFF
        arena[0] = 0x0000FFFF  # items 0 and 1 never share a transaction
        arena[1] = 0xFFFF0000
        planes = rng.integers(0, 2**32, size=(n_planes, nl),
                              dtype=np.uint64).astype(np.uint32)
        planes[:, -1] = 0  # the ragged last lane of a corpus
        planes[1:, 512:1024] = 0  # a chunk of weight-1 transactions
        if n_planes == 31:
            planes[29:] = 0xFFFFFFFF
        for k in range(1, 9):
            prefix = rng.integers(2, f_pad - 1, size=(p, k)).astype(np.int32)
            prefix[rng.random((p, k)) < 0.2] = f_pad - 1
            prefix[-5:] = f_pad - 1
            prefix[3, :2] = [0, 1] if k >= 2 else [0]  # an empty AND
            cand = []
            for row in range(p - 5):
                if row % 7 == 3:
                    continue
                n_c = 150 if row == 10 else int(rng.integers(1, 40))
                ys = np.sort(rng.choice(f_pad, size=n_c, replace=False))
                cand += [row * f_pad + int(y) for y in ys]
            cand.append((p - 6) * f_pad + f_pad - 1)
            args = (
                torch.from_numpy(arena.view(np.int32)).to(device),
                torch.from_numpy(planes.view(np.int32)).to(device),
                [1 << b for b in range(n_planes)],
                torch.from_numpy(prefix).to(device),
                torch.tensor(cand, dtype=torch.int32, device=device),
            )
            require_equal(f"vertical_counts ragged B={n_planes} K={k}",
                          vertical_counts(*args), vertical_counts_plain(*args))
    # The compressed arena upload (sparse corpora) lands the same words
    # as the dense one, top bits included.
    from fastapriori_tpu_torch.device import DeviceContext
    from fastapriori_tpu_torch.ops.vertical import compress_arena

    sparse = arena * (rng.random(arena.shape) < 0.01)
    sparse[f_pad] = 0xFFFFFFFF
    ctx = DeviceContext(device)
    dense, _ = ctx.upload_tid_arena(sparse)
    packed, _ = ctx.upload_tid_arena(sparse, compress_arena(sparse, f_pad)[0])
    require_equal("compressed arena upload", packed, dense)


def phase_metrics(stderr_text: str) -> tuple:
    """The CLI's ``--metrics`` lines and its two "==== Total time" walls,
    from its stderr: ``({phase: wall ms}, {phase: other fields})``."""
    walls, fields = {}, {}
    for line in stderr_text.splitlines():
        if line.startswith("==== Total time for "):
            name, _, ms = line[len("==== Total time for "):].rpartition(" ")
            walls[name] = float(ms)
        elif line.startswith("{"):
            rec = json.loads(line)
            key = rec.pop("event") + (f" k={rec.pop('k')}" if "k" in rec
                                      else "")
            base, n = key, 1
            while key in fields:  # a repeated event: "tail_fuse #2"
                n += 1
                key = f"{base} #{n}"
            if "wall_ms" in rec:
                walls[key] = rec.pop("wall_ms")
            rec.pop("path", None)
            fields[key] = rec
    return walls, fields


def kernel_launches() -> dict:
    from fastapriori_tpu_torch.ops.level_kernel import level_counts
    from fastapriori_tpu_torch.ops.match_kernel import first_match
    from fastapriori_tpu_torch.ops.vertical_kernel import vertical_counts

    return {"level_counts": level_counts,
            "first_match": first_match,
            "vertical_counts": vertical_counts}


T10 = {"n_txns": 100_000, "n_items": 1000, "avg_txn_len": 10, "seed": 2017,
       "n_users": 10_000, "user_seed": 2018}


def corpora() -> list:
    """Phases 3 and 4's corpora: ``(name, directory, datagen arguments,
    min support)``."""
    return [("t10i4d100k", os.path.join(WORK, "in"), T10, MIN_SUPPORT),
            ("kosarak", os.path.join(WORK, "kin"),
             {key: KOSARAK[key] for key in (
                 "n_txns", "n_items", "avg_txn_len", "seed", "n_users",
                 "user_seed")}, KOSARAK["min_support"])]


def ingest_digests(data) -> dict:
    """A digest of each field of an ingest's CompressedData (arrays with
    their dtype), for :func:`ingest_compare`."""
    out = {}
    for field in ("n_raw", "min_count", "freq_items", "item_to_rank"):
        out[field] = hashlib.sha256(json.dumps(
            getattr(data, field), sort_keys=True).encode()).hexdigest()
    for field in ("item_counts", "basket_indices", "basket_offsets",
                  "weights"):
        a = getattr(data, field)
        out[field] = f"{a.dtype}:{hashlib.sha256(a.tobytes()).hexdigest()}"
    return out


# The corpora, then the Python ingest of each (phase 4's compare), then
# phase 15's MovieLens-shape corpus, in a child started first
# (:class:`Child`): it needs no card, so it runs while this process
# builds the kernels and runs the phases before 15.  One reply when both
# corpora are written, one with the Python ingests' walls and digests,
# one with the MovieLens-shape corpus's wall and digests.
PREP = """
import json, os, time
import chip_smoke as cs
from fastapriori_tpu_torch.preprocess import preprocess_file
walls = {}
for name, in_dir, spec, _ in cs.corpora():
    t0 = time.perf_counter()
    cs.write_corpus(in_dir, **spec)
    walls[name] = time.perf_counter() - t0
print("REPLY " + json.dumps(walls), flush=True)
out = {}
for name, in_dir, _, min_support in cs.corpora():
    t0 = time.perf_counter()
    data = preprocess_file(os.path.join(in_dir, "D.dat"), float(min_support),
                           native=False)
    out[name] = {"python_s": time.perf_counter() - t0,
                 "digests": cs.ingest_digests(data)}
print("REPLY " + json.dumps(out), flush=True)
print("REPLY " + json.dumps(cs.write_doc_corpus(cs.MOVIELENS_DIR)),
      flush=True)
"""


def write_corpus(in_dir: str, n_txns: int, n_items: int, avg_txn_len: int,
                 seed: int, n_users: int, user_seed: int) -> None:
    from fastapriori_tpu_torch.utils.datagen import (
        generate_transactions,
        generate_user_baskets,
    )

    os.makedirs(in_dir, exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(in_dir, "D.dat"), "w") as f:
        f.write("\n".join(generate_transactions(
            n_txns=n_txns, n_items=n_items, avg_txn_len=avg_txn_len,
            seed=seed)) + "\n")
    with open(os.path.join(in_dir, "U.dat"), "w") as f:
        f.write("\n".join(generate_user_baskets(
            n_users=n_users, n_items=n_items, seed=user_seed)) + "\n")
    log(f"datagen {in_dir}: {time.perf_counter() - t0:.3f} s")


MOVIELENS_DIR = os.path.join(WORK, "mlin")


def write_doc_corpus(in_dir: str) -> dict:
    """Phase 15's corpus (:data:`MOVIELENS`) by the port's doc-corpus and
    user-basket generators: the wall and each file's SHA-256."""
    from fastapriori_tpu_torch.utils.datagen import (
        generate_doc_transactions,
        generate_user_baskets,
    )

    os.makedirs(in_dir, exist_ok=True)
    spec = MOVIELENS
    t0 = time.perf_counter()
    with open(os.path.join(in_dir, "D.dat"), "w") as f:
        f.write("\n".join(generate_doc_transactions(
            n_txns=spec["n_txns"], n_items=spec["n_items"],
            avg_txn_len=spec["avg_txn_len"], seed=spec["seed"])) + "\n")
    with open(os.path.join(in_dir, "U.dat"), "w") as f:
        f.write("\n".join(generate_user_baskets(
            n_users=spec["n_users"], n_items=spec["n_items"],
            seed=spec["user_seed"])) + "\n")
    wall = time.perf_counter() - t0
    return {"wall_s": wall,
            "d_sha256": sha256(os.path.join(in_dir, "D.dat")),
            "u_sha256": sha256(os.path.join(in_dir, "U.dat"))}


# The environment variables the CLI reads (cli_path sets them per call).
CLI_ENV = ("FA_MINE_ENGINE", "FA_RULE_ENGINE", "FA_NO_PALLAS",
           "FA_COUNT_REDUCE", "FA_COUNT_SPARSE_CAP", "FA_EXCHANGE_GROUPS")


def cli_path(name: str, in_dir: str, out_dir: str, min_support: str,
             digests: dict, env=None, extra_args=(), ingest: bool = True,
             injected=None, ledgered=None, allowed=(),
             verbose: bool = True, serve: bool = False,
             context=None) -> tuple:
    """Phases 3, 4, 9, 10, 11 and 12: the port's CLI in-process (its
    ``serve`` subcommand with ``serve``; with ``context``, the CLI's
    ``_run`` / ``_run_serve`` on that DeviceContext), with the
    variables of :data:`CLI_ENV` set as ``env`` says (the rest unset) for
    this call only and ``extra_args`` after the zero-flag arguments;
    checks the output digests and, with ``ingest``, that the run took the
    pipelined capture ingest on more than one thread, and returns the
    kernels' launch counts on this run with the run's metrics fields.
    The degradation ledger is emptied before the run and must be empty
    after it, but for events of the kinds in ``allowed``; with
    ``ledgered`` (a summary) it must hold exactly those; with
    ``injected = (site, spec)`` that failpoint is armed for the run and
    the ledger must hold exactly one ``retry`` at that site.
    ``verbose`` False logs the wall line only."""
    import torch

    from fastapriori_tpu_torch import cli
    from fastapriori_tpu_torch.reliability import failpoints, ledger

    os.makedirs(out_dir, exist_ok=True)
    kernels = kernel_launches()
    captured = io.StringIO()
    saved = {key: os.environ.pop(key, None) for key in CLI_ENV}
    os.environ.update(env or {})
    ledger.reset()
    if injected is not None:
        failpoints.arm(*injected)
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(captured):
            argv = [in_dir + "/", out_dir + "/", "--min-support",
                    min_support, "--metrics", *extra_args]
            if context is None:
                rc = cli.main([*(("serve",) if serve else ()), *argv])
            elif serve:
                rc = cli._run_serve(cli.build_serve_parser().parse_args(argv),
                                    context=context)
            else:
                rc = cli._run(cli.build_parser().parse_args(argv),
                              context=context)
    finally:
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in kernels.items()}
        failpoints.disarm_all()
        for key, value in saved.items():
            os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value
        sys.stderr.write(captured.getvalue())
    if rc != 0:
        raise SystemExit(f"{name}: CLI exited {rc}")
    summary = {k: v for k, v in ledger.summary().items()
                if k not in allowed}
    if ledgered is not None:
        if summary != ledgered:
            raise SystemExit(f"{name}: the ledger holds {ledger.snapshot()}, "
                             f"expected {ledgered}")
        log(f"{name}: ledger {summary}")
    elif injected is None and summary:
        raise SystemExit(f"{name}: a clean run degraded: {summary} "
                         f"{ledger.snapshot()}")
    if injected is not None:
        sites = [e.get("site") for e in ledger.snapshot()]
        if summary != {"retry": 1} or sites != [injected[0]]:
            raise SystemExit(f"{name}: expected one retry at {injected[0]}, "
                             f"the ledger holds {ledger.snapshot()}")
        log(f"{name}: ledger {summary} at {sites}")
    log(f"{name}: CLI wall {wall:.3f} s, launches {launches}, peak device "
        f"memory {torch.cuda.max_memory_allocated()} bytes")
    walls, fields = phase_metrics(captured.getvalue())
    if verbose:
        log(f"{name} phases (wall ms): " + json.dumps(walls))
        log(f"{name} phase metrics: " + json.dumps(fields))
    fields["cli_wall_s"] = wall
    fields["walls"] = walls
    if not ingest:
        check_digests(name, out_dir, digests)
        return launches, fields
    pre = fields.get("preprocess", {})
    if pre.get("native") is not True:
        raise SystemExit(f"{name}: the CLI did not ingest natively "
                         f"({pre.get('native_reason')})")
    if not (pre.get("pipelined") is True and pre.get("capture") is True
            and pre.get("threads", 0) > 1):
        raise SystemExit(f"{name}: the CLI did not take the pipelined "
                         f"capture ingest on more than one thread: {pre}")
    k3 = fields.get("level k=3", {})
    log_if = log if verbose else (lambda msg: None)
    log_if(f"{name}: level 3 overlapped={k3.get('overlapped')} n2="
        f"{k3.get('n2', fields.get('level k=2', {}).get('frequent'))} "
        f"p3={k3.get('p3')} n3={k3.get('n3', k3.get('frequent'))} "
        f"cap3={k3.get('cap3')}; pair_l3_overflow "
        f"{fields.get('pair_l3_overflow')}; float32 matmul precision "
        f"{torch.get_float32_matmul_precision()}, allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        raise SystemExit(f"{name}: float32 matmuls may run as TF32; the "
                         f"pair program's counts would not be exact")
    check_digests(name, out_dir, digests)
    return launches, fields


def check_digests(name: str, out_dir: str, digests: dict) -> None:
    for out_name, want in digests.items():
        got = sha256(os.path.join(out_dir, out_name))
        if got != want:
            raise SystemExit(f"{name}: {out_name} sha256 {got} != the JAX "
                             f"package's {want}")
        log(f"{name}: {out_name} sha256 matches the JAX package ({got})")


def ingest_compare(name: str, in_dir: str, min_support: str,
                   python: dict) -> None:
    """The corpus through the native ingest, in-process, against its
    Python ingest in the prep child (``python``: its wall and
    :func:`ingest_digests`): every field of the two CompressedData must
    be equal (dtypes included)."""
    from fastapriori_tpu_torch.preprocess import (
        ingest_thread_count,
        preprocess_file,
    )

    t0 = time.perf_counter()
    nat = preprocess_file(os.path.join(in_dir, "D.dat"), float(min_support),
                          native=True)
    nat_s = time.perf_counter() - t0
    got = ingest_digests(nat)
    for field, want in python["digests"].items():
        if got[field] != want:
            raise SystemExit(f"{name}: native ingest {field} differs from "
                             f"the Python ingest's")
    log(f"ingest {name}: python {python['python_s']:.3f} s (prep child), "
        f"native {nat_s:.3f} s, equal arrays ({nat.total_count} baskets, "
        f"{nat.num_items} items); the native scan runs on 1 thread, the "
        f"arena build on {ingest_thread_count(None)}")


def expected_launches(fields: dict) -> dict:
    """Each kernel's launches as the run's own metrics count them: K1 or
    K3 (by the level events' engine) once per launch of each level that
    ran through the level loop, K2 once per micro-batch of the device
    first-match scan; none where the event says ``plain_kernels``
    (``FA_NO_PALLAS``: the plain versions ran on the card)."""
    level = sum(v.get("launches", 0) for k, v in fields.items()
                if k.startswith("level k=") and not v.get("plain_kernels"))
    vertical = "arena_build" in fields
    fm = fields.get("first_match", {})
    return {"level_counts": 0 if vertical else level,
            "vertical_counts": level if vertical else 0,
            "first_match": fm.get("launches", 0)
            if fm.get("device") and not fm.get("plain_kernels") else 0}


def require_launches(name: str, launches: dict, fields: dict, ran) -> None:
    """The counted launches must be what the run's metrics say, and each
    kernel of ``ran`` must have launched."""
    want = expected_launches(fields)
    if launches != want:
        raise SystemExit(f"{name}: launches {launches} != the run's level "
                         f"and first_match events' {want}")
    for k in ran:
        if launches[k] <= 0:
            raise SystemExit(f"{name}: kernel {k} never launched")
    log(f"{name}: launches {launches} match the run's own events")


def mine(in_dir: str, device, min_support: str, mine_engine: str = "auto",
         **knobs):
    """A path's phase 1 through the API (after its counted run), through
    the same pipelined capture ingest and thread count as the counted
    run, so that its arrays, and so the kernels' shapes, are the counted
    run's (the CSR kept): the inputs of the kernels' measurements.
    Returns ``(cfg, data, levels, miner)``."""
    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.models.apriori import FastApriori

    cfg = MinerConfig(min_support=float(min_support), mine_engine=mine_engine,
                      **knobs)
    miner = FastApriori(config=cfg, device=device)
    levels, data = miner.run_file_raw(os.path.join(in_dir, "D.dat"))
    return cfg, data, levels, miner


def record_fields(records) -> dict:
    """An API run's metrics records in :func:`phase_metrics`' form."""
    return phase_metrics("\n".join(json.dumps(r) for r in records))[1]


def level_api_path(in_dir: str, device, min_support: str) -> tuple:
    """The path K1 is counted on: T10 through the API on the level engine
    with the tail fold off (``engine="level", tail_fuse_rows=0``), the
    launch counts set to 0 just before and read just after; K1 must have
    launched as often as the run's own ``level`` events say.  Returns
    ``(cfg, data, levels, K1 launches, fields)``."""
    kernels = kernel_launches()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    cfg, data, levels, miner = mine(in_dir, device, min_support,
                                    engine="level", tail_fuse_rows=0)
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    fields = record_fields(miner.metrics.records)
    want = expected_launches(fields)
    if launches != want or launches["level_counts"] <= 0:
        raise SystemExit(f"level API path: launches {launches} != the run's "
                         f"level events' {want}")
    if any(k.startswith(("tail_fuse", "fused_mine")) for k in fields):
        raise SystemExit("level API path: a fold or the fused engine ran")
    log(f"level API path (engine level, tail fold off): mine wall {wall:.3f} "
        f"s, launches {launches} match the run's own level events")
    return cfg, data, levels, launches["level_counts"], fields


def require_auto_main(fields: dict) -> None:
    """The zero-flag run on T10 made the JAX package's auto choice: the
    level engine, because the level-3 candidate census (from the
    ingest-overlapped pair program) exceeds the fused engine's row-budget
    ceiling; then the level engine's tail fold from level 3, which the
    pair program counted."""
    auto = fields.get("engine_auto", {})
    folds = [v for k, v in fields.items() if k.startswith("tail_fuse")]
    log(f"main path: engine_auto {json.dumps(auto)}; tail_fuse "
        f"{json.dumps(folds)}")
    if (auto.get("choice") != "level"
            or not auto.get("cand3", 0) > auto.get("m_cap_max", 1 << 62)):
        raise SystemExit(f"main path: expected the auto choice level on the "
                         f"census: {auto}")
    if any(k.startswith("fused_mine") for k in fields):
        raise SystemExit("main path: the fused engine ran")
    if not folds or folds[0].get("k0") != 3:
        raise SystemExit(f"main path: no tail fold from level 3: {folds}")
    if not fields.get("level k=3", {}).get("overlapped"):
        raise SystemExit("main path: level 3 did not come from the pair "
                         "program")


def require_fused_path(fields: dict) -> None:
    """The ``--engine fused`` run on T10: one complete ``fused_mine`` at
    16,384 rows over the resident bitmap, no level engine."""
    fused = [v for k, v in fields.items() if k.startswith("fused_mine")]
    log(f"fused path: fused_mine {json.dumps(fused)}")
    if (len(fused) != 1 or fused[0].get("incomplete") is not False
            or fused[0].get("m_cap") != 16384
            or fused[0].get("packed_input") is not False):
        raise SystemExit(f"fused path: expected one complete fused_mine at "
                         f"m_cap 16,384 over the resident bitmap, got "
                         f"{fused}")
    if any(k.startswith(("level k=", "fused_fallback", "tail_fuse"))
           for k in fields):
        raise SystemExit("fused path: the level engine ran")


def capture_compare(in_dir: str, device, min_support: str) -> None:
    """T10 in-process through the capture path and through the one-call
    scan (``ingest_pipeline_blocks=1``), each with the auto choice (the
    level engine and its tail fold) and with the fused engine (over the
    resident bitmap on the capture path, over a packed upload on the
    one-call scan): the levels must be equal.  On the capture path every
    operation from the last block's arrival to the pair program's fetch,
    and inside each level of a fused or tail loop, runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (device.py
    ``sync_free``: a hidden wait for the device raises)."""
    import torch

    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.models.apriori import FastApriori

    path = os.path.join(in_dir, "D.dat")
    runs = {}
    for name, blocks, engine in (("capture", 8, "auto"),
                                 ("one-call", 1, "auto"),
                                 ("capture, fused", 8, "fused"),
                                 ("one-call, fused", 1, "fused")):
        cfg = MinerConfig(min_support=float(min_support),
                          ingest_pipeline_blocks=blocks, engine=engine)
        miner = FastApriori(config=cfg, device=device)
        miner.ctx.sync_check = blocks > 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        levels, _ = miner.run_file_raw(path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls, ev = phase_metrics("\n".join(
            json.dumps(r) for r in miner.metrics.records))
        runs[name] = (levels, ev)
        log(f"capture compare, {name}: mine wall {wall:.3f} s; " + ", ".join(
            f"{key} {walls[key]} ms" for key in walls) + "; " + json.dumps({
                key: ev[phase][key] for phase, keys in (
                    ("preprocess", ("pass1_s", "pass2_s", "pack_s")),
                    ("bitmap_build", ("upload_wait_ms", "pair_issue_ms",
                                      "assemble_ms")),
                    ("level k=2", ("pair_device_ms",)),
                    ("fused_mine", ("m_cap", "levels", "packed_input")))
                for key in keys if key in ev.get(phase, {})}))
    want = runs["capture"][0]
    for name, (got, _) in runs.items():
        if not levels_equal(got, want):
            raise SystemExit(f"capture compare: the {name} run's levels "
                             f"differ from the capture path's")
    ev = {name: e for name, (_, e) in runs.items()}
    if not (ev["capture"]["preprocess"].get("pipelined")
            and ev["capture"].get("level k=2", {}).get("overlapped")
            and "tail_fuse" in ev["capture"]
            and not ev["one-call"]["preprocess"].get("pipelined")
            and ev["one-call"].get("engine_auto", {}).get("choice") == "level"
            and "pair_prepass" in ev["one-call"]
            and ev["capture, fused"].get("fused_mine", {}).get(
                "packed_input") is False
            and ev["one-call, fused"].get("fused_mine", {}).get(
                "packed_input") is True):
        raise SystemExit("capture compare: the runs did not take the paths "
                         "they name")
    log(f"capture compare: equal levels ({len(want)}) on all four runs, no "
        f"device wait in the pair dispatch or inside a fused or tail level "
        f"(sync debug mode error)")


def levels_equal(a, b) -> bool:
    """Equal level matrices and counts; a trailing empty level (the level
    engine keeps the one that ends its loop, the fused and tail loops
    stop before it) does not count."""
    import numpy as np

    def strip(levels):
        return [lv for lv in levels if lv[0].shape[0]]

    a, b = strip(a), strip(b)
    return len(a) == len(b) and all(
        np.array_equal(x, y) and np.array_equal(cx, cy)
        for (x, cx), (y, cy) in zip(a, b))


ENGINES_COMPARED = (("fused", {"engine": "fused"}),
                    ("level + tail", {"engine": "level"}),
                    ("level only", {"engine": "level", "tail_fuse_rows": 0}))

# One cold mine in a fresh process: CUDA set up first, then the mine
# timed (the CUDA modules of its operations load at their first launch),
# then a digest of its non-empty levels.
COLD_MINE = """
import json, sys, time, torch
from chip_smoke import levels_digest
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.models.apriori import FastApriori
sys.argv[1:] = json.loads(sys.stdin.readline())
t0 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t1 = time.perf_counter()
cfg = MinerConfig(min_support=float(sys.argv[2]), **json.loads(sys.argv[3]))
levels, _ = FastApriori(config=cfg).run_file_raw(sys.argv[1])
torch.cuda.synchronize()
t2 = time.perf_counter()
print(json.dumps({"cuda_init_s": t1 - t0, "mine_s": t2 - t1,
                  "levels_sha256": levels_digest(levels)}))
"""


def levels_digest(levels) -> str:
    """SHA-256 over the non-empty levels' matrices and counts."""
    h = hashlib.sha256()
    for mat, cnt in levels:
        if mat.shape[0]:
            h.update(mat.tobytes())
            h.update(cnt.tobytes())
    return h.hexdigest()


def cold_mines(in_dir: str, min_support: str, ref_levels) -> dict:
    """T10 mined once by each engine of :data:`ENGINES_COMPARED`, each in a
    fresh process (the first mine of a process, as a CLI user pays it),
    the levels' digest equal to the reference's.  Returns the walls."""
    want = levels_digest(ref_levels)
    walls = {}
    for name, knobs in ENGINES_COMPARED:
        rc, stdout, stderr = CHILDREN.pop(f"cold mine {name}").run(
            [os.path.join(in_dir, "D.dat"), min_support, json.dumps(knobs)])
        if rc != 0:
            raise SystemExit(f"cold mine {name}: exit {rc}: "
                             f"{stderr[-2000:]}")
        got = json.loads(stdout.strip().splitlines()[-1])
        if got["levels_sha256"] != want:
            raise SystemExit(f"cold mine {name}: levels differ from the "
                             f"level engine's")
        walls[name] = got
        log(f"cold mine, {name} (fresh process): CUDA set-up "
            f"{got['cuda_init_s']:.3f} s, mine {got['mine_s']:.3f} s, "
            f"levels equal")
    return walls


def fused_compare(in_dir: str, device, min_support: str, card: str, cfg,
                  data, ref_levels) -> dict:
    """Phase 6: T10 mined three ways in-process through the API, each
    twice (the first run in this process of that configuration, then
    warm): the fused engine (``engine="fused"``), the level engine with
    its tail fold (``engine="level"``) and without it
    (``tail_fuse_rows=0``); the levels must equal the counted level API
    run's (``ref_levels``).  Then the fused loop and the tail fold are
    called directly on the level engine's bitmap: the fused loop at the
    fused run's row budget from level 2 (its time from CUDA events, its peak
    device memory against the memory model of models/apriori.py
    ``fused_bytes``), and the tail fold seeded with level 4 at a prefix
    budget that cannot abort; both must give the reference's levels."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.models.apriori import fused_bytes, txn_multiple
    from fastapriori_tpu_torch.ops.bitmap import build_bitmap_csr, next_pow2
    from fastapriori_tpu_torch.ops.fused import (
        decode_level_matrices,
        make_fused_miner,
        make_tail_miner,
        tail_slot_caps,
        unpack_fused_result,
        unpack_tail_result,
    )

    walls, m_cap = {}, None
    for name, knobs in ENGINES_COMPARED:
        for run in ("first", "warm"):
            torch.cuda.synchronize()
            # device_peak_bytes on the fused and tail events: this run's.
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, _, levels, miner = mine(in_dir, device, min_support, **knobs)
            torch.cuda.synchronize()
            walls[f"{name}, {run}"] = time.perf_counter() - t0
            if not levels_equal(levels, ref_levels):
                raise SystemExit(f"fused compare: {name}'s levels differ "
                                 f"from the level engine's")
        ev = record_fields(miner.metrics.records)
        m_cap = m_cap or ev.get("fused_mine", {}).get("m_cap")
        kinds = sorted({k.split(" ")[0] for k in ev})
        log(f"fused compare, {name}: events {kinds}; " + json.dumps({
            k: {f: v[f] for f in ("m_cap", "p_cap", "k0", "levels",
                                  "incomplete", "device_peak_bytes",
                                  "model_bytes") if f in v}
            for k, v in ev.items() if k.startswith(("fused_mine",
                                                    "tail_fuse"))}))
    log(f"fused compare on {card}: mine walls (s) " + json.dumps(
        {k: round(v, 6) for k, v in walls.items()}))

    # The fused loop and the tail fold, called directly.
    n_chunks = max(1, -(-data.n_raw // cfg.level_txn_chunk))
    b_np = build_bitmap_csr(data.basket_indices, data.basket_offsets,
                            data.num_items, txn_multiple(cfg, n_chunks),
                            cfg.item_tile)
    t_pad, f_pad = b_np.shape
    w_np = np.zeros(t_pad, dtype=np.int32)
    w_np[: data.total_count] = data.weights
    if w_np.max() >= 128:
        raise SystemExit("fused compare expects single-digit weights")
    bitmap = torch.from_numpy(b_np).to(device)
    w = torch.from_numpy(w_np).to(device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    l_max = cfg.fused_l_max
    fn = make_fused_miner(m_cap, l_max, 1, n_chunks, False,
                          packed_input=False)
    out = fn(bitmap, w, data.min_count).cpu().numpy()
    peak = torch.cuda.max_memory_allocated() - base
    fixed, at = fused_bytes(cfg, t_pad, f_pad, n_chunks,
                            unpacked_resident=True)
    model = fixed + at(m_cap) - (t_pad * f_pad + 4 * t_pad)
    rows, cols, counts, n_lvl, incomplete = unpack_fused_result(out, l_max)[:5]
    if incomplete or not levels_equal(
            decode_level_matrices(rows, cols, counts, n_lvl), ref_levels):
        raise SystemExit("fused compare: the fused loop's levels differ from "
                         "the level engine's")
    # CUDA events around whole calls: the host's issue and its one read
    # per level are inside.
    fused_ms = time_ms(lambda: fn(bitmap, w, data.min_count), iters=2,
                       warmup=1)
    log(f"fused loop (direct, T={t_pad} F={f_pad} m_cap={m_cap}, {n_chunks} "
        f"chunks, {int(np.count_nonzero(n_lvl))} levels): {fused_ms:.4f} ms "
        f"a call (CUDA events); peak device memory above the resident "
        f"bitmap {peak} bytes, memory model {model} bytes "
        f"({peak / model:.3f} of it)")
    if peak > model:
        raise SystemExit("fused compare: the fused loop's peak memory "
                         "exceeds the memory model")

    seed = ref_levels[2][0]  # level 4
    k0, n0 = seed.shape[1], seed.shape[0]
    t_cap = max(next_pow2(n0), cfg.min_prefix_bucket)
    seed_pad = np.zeros((t_cap, k0), np.int32)
    seed_pad[:n0] = seed
    wd = torch.from_numpy(w_np.astype(np.int8)[None, :]).to(device)
    seed_dev = torch.from_numpy(seed_pad).to(device)
    tail = make_tail_miner([1], k0, t_cap, t_cap, 8, n_chunks, False)
    out = tail(bitmap, wd, seed_dev, n0, data.min_count).cpu().numpy()
    rows, cols, counts, n_lvl, incomplete, _ = unpack_tail_result(
        out, t_cap, 8)
    got = decode_level_matrices(rows, cols, counts, n_lvl,
                                max_rows=tail_slot_caps(t_cap, 8), prev=seed)
    if incomplete or not levels_equal(ref_levels[:3] + got, ref_levels):
        raise SystemExit("fused compare: the tail fold's levels differ from "
                         "the level engine's")
    tail_ms = time_ms(lambda: tail(bitmap, wd, seed_dev, n0, data.min_count),
                      iters=2, warmup=1)
    log(f"tail fold (direct, seed level {k0} of {n0} rows, m_cap = p_cap = "
        f"{t_cap}, {len(got)} levels): {tail_ms:.4f} ms a call (CUDA events)")
    log("fused compare: the fused engine's, the tail fold's and the level "
        "engine's levels are equal")
    cold = cold_mines(in_dir, min_support, ref_levels)
    return {"walls_s": walls, "cold_s": {k: v["mine_s"]
                                         for k, v in cold.items()},
            "fused_loop_ms": fused_ms, "fused_peak_bytes": peak,
            "fused_model_bytes": model, "tail_fold_ms": tail_ms}


def level_launches(cfg, levels, f_pad: int):
    """Every K1 or K3 launch of a path's level loop, in order, as
    models/apriori.py ``_level_loop`` makes them: ``(k, prefix_cols,
    cand_idx)`` per prefix chunk of each level k >= 3 that runs."""
    from fastapriori_tpu_torch.models.apriori import level_chunks
    from fastapriori_tpu_torch.models.candidates import (
        concat_blocks,
        gen_candidates_stream,
    )

    for i, (mat, _) in enumerate(levels):
        k = i + 3
        if mat.shape[0] < k:  # the level loop stops here
            break
        x_idx, ys = concat_blocks(gen_candidates_stream(mat))
        for prefix_cols, cand_idx, _ in level_chunks(mat, x_idx, ys, f_pad,
                                                     cfg):
            yield k, prefix_cols, cand_idx


def k1_measure(cfg, data, levels, device, fields) -> dict:
    """Phase 5, K1: every level-count launch of the main path replayed at
    its own shapes (held against the plain version, timed), then the
    heaviest (the first with the most prefix rows) in full: the plain
    version, the library formulation and the bound.  A level the counted
    run (``fields``) did not count with K1 (level 3 from the pair
    program, a level a tail fold mined) is not on the path: its launches
    are checked and timed all the same, so that the heaviest shape stays
    comparable with earlier runs, but left out of the replay's count and
    sum."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.models.apriori import txn_multiple
    from fastapriori_tpu_torch.ops.bitmap import build_bitmap_csr
    from fastapriori_tpu_torch.ops.count import prefix_onehot
    from fastapriori_tpu_torch.ops.level_kernel import (
        level_counts,
        level_counts_plain,
    )

    # The transaction axis padded as the pipelined ingest pads it.
    n_chunks = max(1, -(-data.n_raw // cfg.level_txn_chunk))
    b_np = build_bitmap_csr(data.basket_indices, data.basket_offsets,
                            data.num_items, txn_multiple(cfg, n_chunks),
                            cfg.item_tile)
    # The levels the counted run counted with K1; level 3 from the pair
    # program (or a level a tail fold mined) is not on the path.
    on_path = {int(key[len("level k="):]) for key, v in fields.items()
               if key.startswith("level k=") and v.get("launches")}
    f_pad = b_np.shape[1]
    if data.weights.max() >= 128:
        raise SystemExit("K1 measurement expects single-digit weights")
    bitmap = torch.from_numpy(b_np).to(device)
    w = np.zeros(b_np.shape[0], dtype=np.int8)
    w[: data.total_count] = data.weights
    wb = bitmap * torch.from_numpy(w).to(device)[:, None]
    per_launch, off_path, best = [], [], None
    for k, prefix_cols, _ in level_launches(cfg, levels, f_pad):
        k1 = prefix_cols.shape[1]
        s_mat = prefix_onehot(torch.from_numpy(prefix_cols).to(device), f_pad)
        require_equal(f"level_counts k={k} launch",
                      level_counts(bitmap, wb, s_mat, k1),
                      level_counts_plain(bitmap, wb, s_mat, k1))
        ms_k = time_ms(lambda: level_counts(bitmap, wb, s_mat, k1), iters=10)
        (per_launch if k in on_path else off_path).append(ms_k)
        if best is None or s_mat.shape[0] > best[0].shape[0]:
            best = (s_mat, k1, k in on_path)
    log(f"K1 per launch (ms): {json.dumps(per_launch)}, all launches "
        f"{sum(per_launch):.4f} ms; launches not on the path (their level "
        f"came from the pair program or a fold): {json.dumps(off_path)}")
    s_mat, k1, on_path = best
    t, f = bitmap.shape
    m = s_mat.shape[0]
    # Real prefixes hold k1 items; the pow2 padding rows hold one item
    # and the kernel gives tiles of only those no work.
    m_real = int((torch.count_nonzero(s_mat, dim=1) == k1).sum().item())
    log(f"K1 shapes: T={t} F={f} M={m} ({m_real} real prefixes) k1={k1}"
        + ("" if on_path else " (not on the path)"))

    got = level_counts(bitmap, wb, s_mat, k1)
    want = level_counts_plain(bitmap, wb, s_mat, k1)
    err = require_equal("level_counts main shape", got, want)
    b_t = bitmap.t().contiguous()

    def library():
        overlap = torch._int_mm(s_mat, b_t)  # [M, T] materialised
        return torch._int_mm((overlap == k1).to(torch.int8), wb)

    require_equal("level_counts vs torch._int_mm", got, library())
    # Contained (prefix, transaction) pairs: the counting product's real
    # work (overlaps <= F are exact in float32).
    pairs = 0
    s_f = s_mat.float()
    for t0 in range(0, t, 8192):
        ov = s_f @ bitmap[t0 : t0 + 8192].float().T
        pairs += int((ov == k1).sum().item())
    ms = time_ms(lambda: level_counts(bitmap, wb, s_mat, k1), iters=20)
    plain_ms = time_ms(lambda: level_counts_plain(bitmap, wb, s_mat, k1),
                       iters=3, warmup=1)
    library_ms = time_ms(library, iters=5, warmup=1)
    n_bytes = 2 * t * f + m * f + 4 * m * f
    n_ops = 2 * m_real * t * f + 2 * pairs * f
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"K1: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"contained pairs {pairs}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "ms_all_launches": sum(per_launch),
            "per_launch_ms": per_launch, "heaviest_on_path": on_path,
            "per_launch_ms_not_on_path": off_path}


def scan_crossover(path: str, rec, baskets) -> None:
    """The recommender's host scan against its whole device path (rule
    table build and upload, K2 launches, fetch) on the path's first n
    distinct baskets, for n = 1 and n near 10^5 .. 3·10^7 basket x rule
    checks:
    wall clock on the host, the median of 3 runs each.  These are the
    numbers ``models/recommender.py`` ``DEVICE_MIN_CHECKS`` rests on."""
    import statistics

    from fastapriori_tpu_torch.models.recommender import DEVICE_MIN_CHECKS

    def wall_ms(fn) -> float:
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            runs.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(runs)

    def device(sub):
        rec._table_dev = None  # the table upload is part of the path
        return rec._device_first_match(sub, {})

    n_rules = rec.n_rules
    # One distinct basket is the smallest problem the path can reach.
    sizes = sorted({1} | {min(max(round(c / n_rules), 1), len(baskets))
                          for c in (1e5, 3e5, 1e6, 3e6, 1e7, 3e7)})
    for n in sizes:
        sub = baskets[:n]
        if device(sub) != rec._host_first_match(sub):
            raise SystemExit(f"{path}: device scan disagrees with the host "
                             f"scan on {n} baskets")
        host_ms = wall_ms(lambda: rec._host_first_match(sub))
        dev_ms = wall_ms(lambda: device(sub))
        log(f"scan crossover {path}: {n} baskets x {n_rules} rules = "
            f"{n * n_rules} checks: host {host_ms:.3f} ms, device path "
            f"{dev_ms:.3f} ms (DEVICE_MIN_CHECKS {DEVICE_MIN_CHECKS} picks "
            f"{'device' if n * n_rules >= DEVICE_MIN_CHECKS else 'host'})")


def k2_measure(path: str, in_dir: str, data, levels, device) -> dict:
    """Phase 5, K2: the path's first scan micro-batch (each path's
    recommend runs one, its only launch, :func:`k2_replay`), then
    :func:`scan_crossover` on its baskets."""
    from fastapriori_tpu_torch.io.reader import read_dat
    from fastapriori_tpu_torch.models.recommender import AssociationRules
    from fastapriori_tpu_torch.preprocess import dedup_user_baskets

    rec = AssociationRules([], data.freq_items, data.item_to_rank,
                           levels=levels,
                           item_counts=data.item_counts, device=device)
    baskets, _, _ = dedup_user_baskets(
        read_dat(os.path.join(in_dir, "U.dat")), data.item_to_rank)
    out = k2_replay(path, rec, baskets, device)
    scan_crossover(path, rec, baskets)
    return out


def k2_replay(path: str, rec, baskets, device) -> dict:
    """K2 at the first scan micro-batch of ``rec`` on ``baskets``: held
    against its plain version and timed (CUDA events and torch.profiler),
    with its bound."""
    import torch

    from fastapriori_tpu_torch.ops.match_kernel import (
        NO_MATCH,
        first_match,
        first_match_plain,
    )

    _, _, bm, blen = next(rec.micro_batches(baskets))
    ant, size, cons = rec.table()
    args = (torch.from_numpy(bm).to(device), torch.from_numpy(blen).to(device),
            ant, size, cons)
    mb, f = bm.shape
    r, k = ant.shape
    log(f"K2 shapes ({path}): MB={mb} ({len(baskets)} distinct baskets) "
        f"F={f} R={r} K={k} (rules {rec.n_rules})")
    got = first_match(*args)
    want = first_match_plain(*args)
    err = require_equal(f"first_match {path} shape", got, want)
    ms = time_ms(lambda: first_match(*args), iters=20)
    dev_ms = device_ms(lambda: first_match(*args), iters=20)
    plain_ms = time_ms(lambda: first_match_plain(*args), iters=2, warmup=1)
    # Each real basket (length > 0; padding rows match nothing) needs the
    # rules up to its first match, or all real rules.
    scanned = torch.where(got < NO_MATCH, got.long() + 1,
                          torch.full_like(got, rec.n_rules, dtype=torch.long))
    scanned = torch.where(args[1] > 0, scanned, torch.zeros_like(scanned))
    n_ops = 2 * f * int(scanned.sum().item())
    n_bytes = mb * f + 4 * mb + 4 * r * k + 8 * r + 4 * mb
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"K2 ({path}): kernel {ms:.4f} ms (device time {dev_ms:.4f} ms: "
        f"the packing pass and the match kernel), plain {plain_ms:.4f} ms, "
        f"bound "
        f"{bound_ms:.4f} ms ({bound_by}); matched "
        f"{int((got < NO_MATCH).sum().item())} of {len(baskets)} baskets")
    # Each path's recommend launches K2 once: this micro-batch.
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "ms_all_launches": ms, "per_launch_ms": [ms]}


def k3_measure(cfg, data, levels, device, clock_mhz: float) -> dict:
    """Phase 5, K3: every launch of the vertical path replayed at its own
    shapes (held against the plain version, timed), then the heaviest
    (the prefix chunk with the most candidates; every launch has the same
    lanes and planes) in full: the plain version and the bound, counted
    two ways."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.ops.vertical import (
        build_tid_arena_csr,
        weight_bit_planes,
    )
    from fastapriori_tpu_torch.ops.vertical_kernel import (
        _popcount32,
        _prefix_and,
        lane_plane_mask,
        vertical_counts,
        vertical_counts_plain,
    )

    arena_np, f_pad, t_pad = build_tid_arena_csr(
        data.basket_indices, data.basket_offsets, data.num_items, 32,
        cfg.item_tile)
    planes_np, scales = weight_bit_planes(
        np.asarray(data.weights, dtype=np.int64), t_pad)
    arena = torch.from_numpy(arena_np.view(np.int32)).to(device)
    planes = torch.from_numpy(planes_np.view(np.int32)).to(device)
    per_launch, best = [], None
    for k, prefix_cols, cand_np in level_launches(cfg, levels, f_pad):
        args = (arena, planes, scales,
                torch.from_numpy(prefix_cols).to(device),
                torch.from_numpy(cand_np.astype(np.int32)).to(device))
        require_equal(f"vertical_counts k={k} launch", vertical_counts(*args),
                      vertical_counts_plain(
                          *args, cand_chunk=cfg.vertical_cand_chunk))
        per_launch.append(time_ms(lambda: vertical_counts(*args), iters=10))
        if best is None or cand_np.size > best[1].size:
            best = (prefix_cols, cand_np, k, args)
    log(f"K3 per launch (ms): {json.dumps(per_launch)}, all launches "
        f"{sum(per_launch):.4f} ms")
    prefix_cols, cand_np, k, args = best
    nl, n_planes = arena_np.shape[1], len(scales)
    p, width = prefix_cols.shape
    got = vertical_counts(*args)
    want = vertical_counts_plain(*args, cand_chunk=cfg.vertical_cand_chunk)
    err = require_equal("vertical_counts path shape", got, want)
    ms = time_ms(lambda: vertical_counts(*args), iters=20)
    plain_ms = time_ms(lambda: vertical_counts_plain(
        *args, cand_chunk=cfg.vertical_cand_chunk), iters=3, warmup=1)

    # Real work only: prefix rows that have candidates, their positions
    # that name an item, candidates whose extension is an item, lanes
    # that hold a transaction; an AND with a zero plane word, and its
    # popcount, add nothing.  Counted two ways: the first count charges
    # a plane word wherever the plane is non-zero; the recount only where
    # the intersection word is non-zero too.
    rows = np.unique(cand_np // f_pad)
    pos = prefix_cols[rows] != f_pad - 1
    real = cand_np[cand_np % f_pad != f_pad - 1]
    lanes = -(-data.total_count // 32)
    plane_words = np.count_nonzero(planes_np[:, :lanes], axis=1)
    items_read = np.union1d(prefix_cols[rows][pos], real % f_pad).size
    n_bytes = (4 * nl * (items_read + n_planes) + 4 * int(pos.sum())
               + 4 * 2 * cand_np.size)
    pref = _prefix_and(arena, args[3])
    planes_here = _popcount32(lane_plane_mask(planes)[:lanes]).float()
    real_t = torch.from_numpy(real).to(device)
    inter_words = 0  # non-zero (intersection, plane) word pairs
    nonzero_inter = 0  # non-zero intersection words
    for c0 in range(0, real.size, 2048):
        ix = real_t[c0 : c0 + 2048]
        nz = ((pref[ix // f_pad, :lanes] & arena[ix % f_pad, :lanes]) != 0)
        nonzero_inter += int(nz.sum().item())
        # Sums below 2^24 (lanes x planes): exact in float32.
        inter_words += int((nz.float() @ planes_here).sum().item())
    clk = clock_mhz * 1e6 * H100_SMS
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3

    def ops_bound(n_and, n_popc):
        t_and = n_and / (BITWISE32_PER_CLK_SM * clk) * 1e3
        t_popc = n_popc / (POPC_PER_CLK_SM * clk) * 1e3
        # AND and population count issue to different units, so the
        # least time for the operations is the slower of the two.
        t_ops = max(t_and, t_popc)
        log(f"  ANDs {n_and} ({t_and:.4f} ms), popcounts {n_popc} "
            f"({t_popc:.4f} ms), bytes {n_bytes} ({t_bytes:.4f} ms)")
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    log(f"K3 shapes: level k={k} arena [{f_pad + 1}, {nl}] B={n_planes} "
        f"P={p} ({rows.size} with candidates) K={width} C={cand_np.size} "
        f"({real.size} real); non-zero words per plane "
        f"{plane_words.tolist()} of {lanes} real lanes; non-zero "
        f"intersection words {nonzero_inter} of {real.size * lanes}; at "
        f"{clock_mhz:.0f} MHz:")
    log(" counted over every non-zero plane word of every candidate:")
    old_bound_ms, _ = ops_bound(
        int(pos.sum()) * lanes + real.size * (lanes + int(plane_words.sum())),
        real.size * int(plane_words.sum()))
    log(" recount (plane words only where the intersection is non-zero):")
    bound_ms, bound_by = ops_bound(
        int(pos.sum()) * lanes + real.size * lanes + inter_words, inter_words)
    log(f"K3: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; counted over every non-zero plane "
        f"word {old_bound_ms:.4f} ms)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bound_ms_every_plane_word": old_bound_ms,
            "ms_all_launches": sum(per_launch), "per_launch_ms": per_launch}


def require_rule_engine(name: str, fields: dict, device: bool) -> None:
    """A CLI run's rule phase took the engine it should: with
    ``FA_RULE_ENGINE=device`` the device engine (a ``rule_gen_engine``
    event naming it, a ``rule_gen_device`` event whose survivors are the
    run's rules, no fallback) and K2 on the table built on the device
    (``first_match`` ``resident_table`` true, with its build time); else,
    on these corpora below the 2^21 floor, auto's host engine and the
    host-built table."""
    rule_events = {k: fields[k] for k in (
        "rule_gen_engine", "rule_gen_device", "rule_gen_fallback")
        if k in fields}
    fm = fields.get("first_match", {})
    log(f"{name}: rule phase {json.dumps(rule_events)}; first_match "
        f"{json.dumps(fm)}")
    if not fm.get("device"):
        raise SystemExit(f"{name}: the recommend scan did not run on the "
                         f"device")
    if not device:
        if rule_events or fm.get("resident_table") is not False:
            raise SystemExit(f"{name}: auto left the host rule engine")
        return
    if ("rule_gen_fallback" in rule_events
            or rule_events.get("rule_gen_engine", {}).get("engine")
            != "device"
            or rule_events.get("rule_gen_device", {}).get("survivors")
            != fields.get("gen_rules", {}).get("rules")):
        raise SystemExit(f"{name}: the forced device rule engine did not "
                         f"run: {rule_events}")
    if fm.get("resident_table") is not True or "table_build_ms" not in fm:
        raise SystemExit(f"{name}: K2 did not scan the table built on the "
                         f"device")


# The rule phase's first calls in a fresh process, after CUDA's set-up
# and the corpus's mine (what a CLI user pays): the host engine with its
# priority sort, then the device engine with the same sort and the scan
# table built from its state (waited for).
COLD_RULES = """
import json, sys, time, torch
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.models.recommender import AssociationRules
from fastapriori_tpu_torch.rules.gen import (gen_rule_arrays_levels,
                                             sort_rule_arrays)
sys.argv[1:] = json.loads(sys.stdin.readline())
cfg = MinerConfig(min_support=float(sys.argv[2]), **json.loads(sys.argv[3]))
levels, data = FastApriori(config=cfg).run_file_raw(sys.argv[1])
torch.cuda.synchronize()
t0 = time.perf_counter()
host = sort_rule_arrays(gen_rule_arrays_levels(levels, data.item_counts),
                        data.freq_items)
t1 = time.perf_counter()
rec = AssociationRules([], data.freq_items, data.item_to_rank, levels=levels,
                       item_counts=data.item_counts, config=MinerConfig(
                           rule_engine="device"))
rec.rule_arrays()
t2 = time.perf_counter()
build_ms = rec.scan_table()[1]
print(json.dumps({"host_ms": (t1 - t0) * 1e3, "device_ms": (t2 - t1) * 1e3,
                  "table_ms": build_ms, "rules": rec.n_rules,
                  "host_rules": len(host[1])}))
"""


def cold_rules(name: str, in_dir: str, min_support: str, knobs: dict,
               n_rules: int) -> dict:
    """:data:`COLD_RULES` on a corpus in a fresh process; both engines
    must give the ``n_rules`` rules of the in-process run."""
    rc, stdout, stderr = CHILDREN.pop(f"cold rules {name}").run(
        [os.path.join(in_dir, "D.dat"), min_support, json.dumps(knobs)])
    if rc != 0:
        raise SystemExit(f"cold rules {name}: exit {rc}: {stderr[-2000:]}")
    got = json.loads(stdout.strip().splitlines()[-1])
    if got["rules"] != n_rules or got["host_rules"] != n_rules:
        raise SystemExit(f"cold rules {name}: {got} rules, in-process "
                         f"{n_rules}")
    return got


def same_rule_arrays(name: str, host, dev) -> None:
    """Rule arrays equal element for element, confidences bitwise."""
    import numpy as np

    if len(host) != len(dev):
        raise SystemExit(f"{name}: {len(dev)} rule levels, host {len(host)}")
    for (ha, hc, hf), (da, dc, df) in zip(host, dev):
        if not (ha.shape == da.shape and np.array_equal(ha, da)
                and np.array_equal(hc, dc) and hf.dtype == df.dtype
                and hf.tobytes() == df.tobytes()):
            raise SystemExit(f"{name}: the device rule engine's arrays "
                             f"differ from the host engine's")


def rule_compare(name: str, in_dir: str, min_support: str, knobs: dict,
                 data, levels, device, reps: int = 3) -> dict:
    """The rule phase on a corpus, in-process: the device engine's rule
    arrays against the host engine's (the joins under
    ``set_sync_debug_mode("error")`` up to the mask fetches: device.py
    ``sync_free``), the device-built scan table's real rows against the
    host-built ``rule_table``'s, the recommends of a K2 scan of that
    table against the host engine's (K2 on the host-built table, which
    the CLI runs hold to the JAX package's digests), and the auto choice at the default floor and at a
    floor of the raw count.  Then K2 on the first micro-batch of the
    device-built table against its plain version, timed, and the "rule
    crossover" line: host ``gen_rules`` against the device engine plus
    the table build, cold (:func:`cold_rules`) and warm (median of
    ``reps``).  Returns K2's numbers on the device-built table."""
    import statistics

    import numpy as np
    import torch

    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.device import DeviceContext
    from fastapriori_tpu_torch.io.reader import read_dat
    from fastapriori_tpu_torch.models.recommender import AssociationRules
    from fastapriori_tpu_torch.ops.bitmap import pad_axis
    from fastapriori_tpu_torch.ops.contain import rule_table
    from fastapriori_tpu_torch.ops.match_kernel import (
        first_match,
        first_match_plain,
    )
    from fastapriori_tpu_torch.preprocess import dedup_user_baskets
    from fastapriori_tpu_torch.rules import gen
    from fastapriori_tpu_torch.utils.logging import MetricsLogger

    mats = gen._level_tables(levels, data.item_counts)
    raw = gen._raw_rule_count(mats)
    floor = MinerConfig().rule_device_min_rules
    ctx = DeviceContext(device)
    ctx.sync_check = True
    host = gen.gen_rule_arrays_levels(levels, data.item_counts)
    metrics = MetricsLogger()
    dev = gen.gen_rule_arrays_levels(
        levels, data.item_counts, context=ctx,
        config=MinerConfig(rule_engine="device"), metrics=metrics)
    same_rule_arrays(name, host, dev)
    events = {r["event"]: r for r in metrics.records}
    if "rule_gen_fallback" in events or "rule_gen_device" not in events:
        raise SystemExit(f"{name}: the forced device engine did not run: "
                         f"{events}")
    survivors = sum(len(c) for _, c, _ in host)
    want_auto = "device" if raw >= floor else "host"
    picks = (gen._pick_rule_engine(mats, ctx, MinerConfig()),
             gen._pick_rule_engine(
                 mats, ctx, MinerConfig(rule_device_min_rules=raw)))
    if picks != (want_auto, "device"):
        raise SystemExit(f"{name}: auto picked {picks} at the floors "
                         f"({floor}, {raw}) for {raw} raw rules")
    log(f"{name}: {raw} raw rules, {survivors} survive; device engine "
        f"equal to the host engine (confidences bitwise; joins under sync "
        f"debug mode error): {json.dumps(events['rule_gen_device'])}; auto "
        f"picks {picks[0]} at the default floor {floor} and {picks[1]} at "
        f"a floor of {raw}")

    users = read_dat(os.path.join(in_dir, "U.dat"))
    baskets, _, _ = dedup_user_baskets(users, data.item_to_rank)
    rec_host = AssociationRules([], data.freq_items, data.item_to_rank,
                                levels=levels,
                                item_counts=data.item_counts,
                                config=MinerConfig(rule_engine="host"),
                                device=device)
    want = rec_host.run(users, use_device=True)
    # At or above the floor auto itself takes the device engine.
    engine = "auto" if raw >= floor else "device"
    rec = AssociationRules([], data.freq_items, data.item_to_rank,
                           levels=levels,
                           item_counts=data.item_counts,
                           config=MinerConfig(rule_engine=engine),
                           device=device)
    rec.ctx.sync_check = True
    if rec.run(users, use_device=True) != want:
        raise SystemExit(f"{name}: recommends from the device-built table "
                         f"differ")
    rev = {r["event"]: r for r in rec.metrics.records}
    if (rev.get("rule_gen_engine", {}).get("requested") != engine
            or rev.get("first_match", {}).get("resident_table") is not True):
        raise SystemExit(f"{name}: the {engine} engine did not scan a "
                         f"device-built table: {rev}")
    for a, b in zip(rec_host.rule_arrays(), rec.rule_arrays()):
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise SystemExit(f"{name}: sorted rule arrays differ")
    (ant, size, cons), = rec.scan_table()[0]
    ant0, lens, cons0, _ = rec_host.rule_arrays()
    f = len(data.freq_items)
    f_pad = pad_axis(f + 1, rec.config.item_tile)
    h_ant, h_size, h_cons = rule_table(ant0, lens, cons0, f, f_pad,
                                       rec.config.rule_chunk)
    r_host = len(cons0)
    width = max(ant.shape[1], h_ant.shape[1])
    got_ant = np.full((r_host, width), f_pad - 1, np.int32)
    want_ant = got_ant.copy()
    got_ant[:, : ant.shape[1]] = ant[:r_host].cpu().numpy()
    want_ant[:, : h_ant.shape[1]] = h_ant[:r_host]
    size_np = size.cpu().numpy()
    if not (np.array_equal(got_ant, want_ant)
            and np.array_equal(size_np[:r_host], h_size[:r_host])
            and np.array_equal(cons[:r_host].cpu().numpy(), h_cons[:r_host])
            and (size_np[r_host:] > f_pad).all()):
        raise SystemExit(f"{name}: the device-built table's rows differ "
                         f"from the host-built table's")
    log(f"{name}: device-built table [{ant.shape[0]}, {ant.shape[1]}] "
        f"equal to the host-built [{h_ant.shape[0]}, {h_ant.shape[1]}] on "
        f"its {r_host} real rows; recommends equal ({len(baskets)} distinct "
        f"baskets; first_match {json.dumps(rev['first_match'])})")

    _, _, bm, blen = next(rec.micro_batches(baskets))
    args = (torch.from_numpy(bm).to(device),
            torch.from_numpy(blen).to(device), ant, size, cons)
    err = require_equal(f"first_match {name} device-built table",
                        first_match(*args), first_match_plain(*args))
    ms = time_ms(lambda: first_match(*args), iters=20)
    dev_ms = device_ms(lambda: first_match(*args), iters=20)
    log(f"K2 ({name}, device-built table R={ant.shape[0]} K="
        f"{ant.shape[1]}): kernel {ms:.4f} ms (device time {dev_ms:.4f} ms)")

    host_runs, dev_runs, table_runs = [], [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        gen.sort_rule_arrays(
            gen.gen_rule_arrays_levels(levels, data.item_counts),
            data.freq_items)
        host_runs.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = AssociationRules([], data.freq_items, data.item_to_rank,
                             levels=levels,
                             item_counts=data.item_counts,
                             config=MinerConfig(rule_engine="device"),
                             device=device)
        r.rule_arrays()
        dev_runs.append((time.perf_counter() - t0) * 1e3)
        table_runs.append(r.scan_table()[1])
        del r
    warm_host, warm_dev, warm_table = (
        statistics.median(x) for x in (host_runs, dev_runs, table_runs))
    # The card's share of the device engine: its kernels' summed time.
    busy = device_ms(lambda: gen.gen_rule_arrays_levels(
        levels, data.item_counts, context=DeviceContext(device),
        config=MinerConfig(rule_engine="device")), iters=reps)
    cold = cold_rules(name, in_dir, min_support, knobs, r_host)
    log(f"rule crossover {name}: {raw} raw rules, {survivors} survivors; "
        f"host gen_rules cold {cold['host_ms']:.3f} ms, warm "
        f"{warm_host:.3f} ms; device engine + priority sort cold "
        f"{cold['device_ms']:.3f} ms, warm {warm_dev:.3f} ms (its kernels "
        f"{busy:.3f} ms of device time); table build cold "
        f"{cold['table_ms']:.3f} ms, warm {warm_table:.3f} ms (warm: median "
        f"of {reps}, in this process)")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "table_rows": int(ant.shape[0]), "k": int(ant.shape[1]),
            "raw_rules": raw, "survivors": survivors,
            "rule_crossover": {"host_cold_ms": cold["host_ms"],
                               "host_warm_ms": warm_host,
                               "device_cold_ms": cold["device_ms"],
                               "device_warm_ms": warm_dev,
                               "device_kernels_ms": busy,
                               "table_cold_ms": cold["table_ms"],
                               "table_warm_ms": warm_table}}


def checkpoint_ks(fields: dict) -> list:
    """The levels a run's ``checkpoint`` events wrote, in order."""
    return [int(key.split("k=")[1].split()[0]) for key in fields
            if key.startswith("checkpoint k=")]


# Phase 9's killed runs, all in one child process started ahead of them
# (:class:`Child`): per request the port's CLI with the request's
# environment (null unsets a variable), ``FA_FAILPOINTS`` included, then
# one ``REPLY`` line.
KILL_WORKER = """
import contextlib, io, json, os, sys, time
import torch
from fastapriori_tpu_torch import cli
from fastapriori_tpu_torch.reliability import failpoints
torch.zeros(1, device="cuda")
for line in sys.stdin:
    req = json.loads(line)
    saved = dict(os.environ)
    for key, value in req["env"].items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    failpoints.reload_from_env()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(err):
        rc = cli.main(req["argv"])
    wall = time.perf_counter() - t0
    failpoints.disarm_all()
    os.environ.clear()
    os.environ.update(saved)
    print("REPLY " + json.dumps({"rc": rc, "wall_s": wall,
                                 "stderr": err.getvalue()[-4000:]}),
          flush=True)
"""


def kill_child(name: str, in_dir: str, out_dir: str, min_support: str,
               site: str, env=None, extra_args=()) -> float:
    """The CLI in the kill worker's child process with
    ``FA_FAILPOINTS=<site>:abort`` (and ``env``; the other variables of
    :data:`CLI_ENV` unset): it must exit non-zero, name the site and
    write no ``freqItemset``.  Returns its wall in seconds."""
    os.makedirs(out_dir, exist_ok=True)
    req_env = {key: None for key in CLI_ENV}
    req_env.update(env or {})
    req_env["FA_FAILPOINTS"] = f"{site}:abort"
    res = CHILDREN["kill worker"].request({
        "env": req_env,
        "argv": [in_dir + "/", out_dir + "/", "--min-support", min_support,
                 "--checkpoint-every-level", *extra_args]})
    if res["rc"] == 0 or site not in res["stderr"]:
        raise SystemExit(f"{name}: the run killed at {site} exited "
                         f"{res['rc']}: {res['stderr'][-2000:]}")
    if os.path.exists(os.path.join(out_dir, "freqItemset")):
        raise SystemExit(f"{name}: the killed run wrote freqItemset")
    log(f"{name}: killed at {site} in the kill worker's child process, "
        f"exit {res['rc']}, {res['wall_s']:.3f} s: "
        f"{res['stderr'].strip()[-200:]}")
    return res["wall_s"]


def require_checkpoint(name: str, out_dir: str, clean_dir: str,
                       k_kill: int) -> None:
    """The killed run's checkpoint passes ``validate_checkpoint`` and
    holds exactly the clean run's levels 2..k_kill."""
    import numpy as np

    from fastapriori_tpu_torch.io.checkpoint import (
        load_checkpoint,
        validate_checkpoint,
    )

    validate_checkpoint(out_dir + "/")
    got, _ = load_checkpoint(out_dir + "/")
    want, _ = load_checkpoint(clean_dir + "/")
    ks = [m.shape[1] for m, _ in got]
    if ks != list(range(2, k_kill + 1)):
        raise SystemExit(f"{name}: the checkpoint holds levels {ks}, not "
                         f"2..{k_kill}")
    for (gm, gc), (wm, wc) in zip(got, want):
        if not (np.array_equal(gm, wm) and np.array_equal(gc, wc)):
            raise SystemExit(f"{name}: checkpoint level {gm.shape[1]} "
                             f"differs from the clean run's")
    log(f"{name}: checkpoint valid, levels 2..{k_kill} equal the clean "
        f"run's ({sum(m.shape[0] for m, _ in got)} itemsets)")


def require_resumed(name: str, fields: dict, launches: dict,
                    k_kill: int, ran=("first_match",)) -> None:
    """The resumed run restarted after the deepest checkpointed level,
    counted only the levels after it, and launched each kernel of
    ``ran``."""
    resume = fields.get("level_resume", {})
    counted = sorted(int(k.split("k=")[1].split()[0]) for k in fields
                     if k.startswith("level k="))
    if resume.get("from_k") != k_kill + 1 or any(k <= k_kill
                                                 for k in counted):
        raise SystemExit(f"{name}: level_resume {resume}, levels counted "
                         f"{counted}, after a kill at level {k_kill}")
    require_launches(name, launches, fields, ran)
    log(f"{name}: level_resume from k = {k_kill + 1}, levels counted "
        f"{counted}, launches {launches}, tail_fuse "
        + json.dumps([v for k, v in fields.items()
                      if k.startswith("tail_fuse")]))


def kill_and_resume(name: str, in_dir: str, min_support: str,
                    digests: dict, env=None, extra_args=(),
                    resume_checkpointed: bool = False,
                    resumed_ran=("first_match",),
                    api_resume: bool = False) -> dict:
    """Phase 9 (a)-(c): a clean ``--checkpoint-every-level`` run (the
    levels its checkpoints wrote), the same run killed in a child process
    at a middle one of them, the checkpoint checked, and ``--resume-from``
    in-process (with ``--checkpoint-every-level`` again when
    ``resume_checkpointed``): the JAX digests, ``level_resume`` after the
    killed level, launches only for the levels after it, each kernel of
    ``resumed_ran`` at least once.  With ``api_resume`` the checkpoint
    also seeds an API mine with the tail fold off (:func:`api_run`,
    ``tail_fuse_rows=0``), which must count every remaining level with
    K1: the CLI's resume may fold them all.  Returns the walls."""
    clean_dir = os.path.join(WORK, name.replace(" ", "_") + "_clean")
    kill_dir = os.path.join(WORK, name.replace(" ", "_") + "_kill")
    for d in (clean_dir, kill_dir, kill_dir + "_api"):
        shutil.rmtree(d, ignore_errors=True)
    args = ("--checkpoint-every-level", *extra_args)
    clean_launches, clean = cli_path(f"{name} checkpointed", in_dir,
                                     clean_dir, min_support, digests,
                                     env=env, extra_args=args)
    require_launches(f"{name} checkpointed", clean_launches, clean,
                     ran=("first_match",))
    ks = checkpoint_ks(clean)
    # A level the loop counted (past the pair program's 2 and 3) with
    # levels left after it.
    resumable = ([k for k in ks if 3 < k < ks[-1]]
                 or [k for k in ks if k < ks[-1]])
    k_kill = resumable[len(resumable) // 2]
    log(f"{name}: the clean run checkpointed levels {ks}; kill at "
        f"level.{k_kill}")
    kill_wall = kill_child(name, in_dir, kill_dir, min_support,
                           f"level.{k_kill}", env=env, extra_args=extra_args)
    require_checkpoint(name, kill_dir, clean_dir, k_kill)
    out = {}
    if api_resume:
        api_name = f"{name} resumed, tail fold off"
        launches, fields, _ = api_run(
            api_name, in_dir, kill_dir + "_api", min_support,
            ("level_counts",), resume_from=kill_dir, tail_fuse_rows=0)
        require_resumed(api_name, fields, launches, k_kill,
                        ran=("level_counts",))
        out["api_resumed_launches"] = launches
    launches, fields = cli_path(
        f"{name} resumed", in_dir, kill_dir, min_support, digests, env=env,
        extra_args=(*(args if resume_checkpointed else extra_args),
                    "--resume-from", kill_dir + "/"))
    require_resumed(f"{name} resumed", fields, launches, k_kill,
                    ran=resumed_ran)
    if resume_checkpointed and not any(
            v.get("checkpoint_segment") for k, v in fields.items()
            if k.startswith("tail_fuse")):
        raise SystemExit(f"{name} resumed: no checkpoint segment ran")
    return {
        "checkpoint_ms": {k: v for k, v in clean["walls"].items()
                          if k.startswith("checkpoint")},
        "checkpointed_cli_s": clean["cli_wall_s"],
        "killed_child_s": kill_wall, "killed_at": k_kill,
        "resumed_cli_s": fields["cli_wall_s"],
        "resumed_launches": launches, **out,
    }


def api_run(name: str, in_dir: str, out_dir: str, min_support: str,
            ran, resume_from=None, **knobs) -> tuple:
    """Phase 9 (a) and (e): T10 through the API on the level engine with
    ``knobs``, seeded from the checkpoint under ``resume_from`` when
    given, written by the CLI's writers: the JAX digests, an empty
    ledger, and the mine's kernel launches (the counts set to 0 just
    before it and read just after) as its own level events count them,
    each kernel of ``ran`` at least once.  Returns ``(launches, fields,
    walls)``."""
    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.io.checkpoint import load_checkpoint
    from fastapriori_tpu_torch.io.reader import read_dat
    from fastapriori_tpu_torch.io.writer import (
        save_freq_itemsets_levels,
        save_recommends,
    )
    from fastapriori_tpu_torch.models.apriori import FastApriori
    from fastapriori_tpu_torch.models.recommender import AssociationRules
    from fastapriori_tpu_torch.reliability import ledger

    ledger.reset()
    cfg = MinerConfig(min_support=float(min_support), retain_csr=False,
                      engine="level", **knobs)
    miner = FastApriori(config=cfg)
    if resume_from is not None:
        miner.set_resume_levels(*load_checkpoint(resume_from + "/"),
                                label=resume_from)
    kernels = kernel_launches()
    for fn in kernels.values():
        fn.launches = 0
    levels, data = miner.run_file_raw(os.path.join(in_dir, "D.dat"))
    launches = {n: fn.launches for n, fn in kernels.items()}
    os.makedirs(out_dir, exist_ok=True)
    save_freq_itemsets_levels(out_dir + "/", levels, data.freq_items)
    rec = AssociationRules([], data.freq_items, data.item_to_rank,
                           levels=levels,
                           item_counts=data.item_counts, config=cfg)
    save_recommends(out_dir + "/", rec.run(read_dat(
        os.path.join(in_dir, "U.dat"))))
    check_digests(name, out_dir,
                  {"freqItemset": FREQ_SHA256, "recommends": REC_SHA256})
    if ledger.summary():
        raise SystemExit(f"{name}: degraded {ledger.snapshot()}")
    fields = record_fields(miner.metrics.records)
    walls = phase_metrics("\n".join(json.dumps(r) for r in
                                    miner.metrics.records))[0]
    require_launches(name, launches, fields, ran)
    return launches, fields, walls


def budget_run(in_dir: str, out_dir: str, min_support: str,
               budget: int) -> dict:
    """Phase 9 (e): :func:`api_run` with ``pending_fetch_budget_bytes =
    budget`` (the level engine, which auto picks on T10, phase 3):
    ``counts_drain`` events and the JAX digests.  Returns the drains'
    and the resolve's walls."""
    _, fields, walls = api_run("budget run", in_dir, out_dir, min_support,
                               ("level_counts",),
                               pending_fetch_budget_bytes=budget)
    drains = {k: v for k, v in walls.items() if k.startswith("counts_")}
    if not any(k.startswith("counts_drain") for k in fields):
        raise SystemExit(f"budget run: no counts_drain at {budget} bytes")
    log(f"budget run ({budget} bytes): drains and resolve (wall ms) "
        f"{json.dumps(drains)}; " + json.dumps(
            {k: v for k, v in fields.items() if k.startswith("counts_")}))
    return drains


def reliability_phases(in_dir: str, k_in: str, main_fields: dict,
                       vert_fields: dict) -> dict:
    """Phase 9: kill-and-resume on each layout and on the fused engine's
    checkpoint segments, the phase-1 resume, the deferred counts' resolve
    and drains, and one absorbed transient.  Returns the walls."""
    digests = {"freqItemset": FREQ_SHA256, "recommends": REC_SHA256}
    kdigests = {"freqItemset": KOSARAK["freq_sha256"],
                "recommends": KOSARAK["rec_sha256"]}
    # (e) The zero-flag runs resolved their deferred counts in one
    # dispatch after the loop.
    for name, fields in (("main path", main_fields),
                         ("vertical path", vert_fields)):
        res = fields.get("counts_resolve", {})
        if res.get("dispatches") != 1:
            raise SystemExit(f"{name}: counts_resolve {res}, expected one "
                             f"dispatch")
        log(f"{name}: counts_resolve {json.dumps(res)}, wall "
            f"{fields['walls'].get('counts_resolve')} ms")
    out = {
        "main_counts_resolve_ms": main_fields["walls"].get("counts_resolve"),
        "vertical_counts_resolve_ms":
            vert_fields["walls"].get("counts_resolve"),
        "main_cli_s": main_fields["cli_wall_s"],
        "vertical_cli_s": vert_fields["cli_wall_s"],
    }
    # (a) T10, zero flags, K1; (b) kosarak, vertical, K3; (c) the fused
    # engine's checkpoint segments.
    out["t10"] = kill_and_resume("t10 kill", in_dir, MIN_SUPPORT, digests,
                                 api_resume=True)
    out["kosarak_vertical"] = kill_and_resume(
        "kosarak vertical kill", k_in, KOSARAK["min_support"], kdigests,
        env={"FA_MINE_ENGINE": "vertical"},
        resumed_ran=("vertical_counts", "first_match"))
    out["t10_fused_segments"] = kill_and_resume(
        "t10 fused segments kill", in_dir, MIN_SUPPORT, digests,
        extra_args=("--engine", "fused", "--checkpoint-cadence", "2"),
        resume_checkpointed=True)
    # (d) --save-counts, then the recommend phase alone from phase 1.
    p1 = os.path.join(WORK, "phase1")
    cli_path("save counts", in_dir, p1, MIN_SUPPORT, digests,
             extra_args=("--save-counts",))
    rec_dir = os.path.join(WORK, "phase1_rec")
    launches, fields = cli_path(
        "phase-1 resume", in_dir, rec_dir, MIN_SUPPORT,
        {"recommends": REC_SHA256}, ingest=False,
        extra_args=("--resume-from", p1 + "/"))
    if (launches["first_match"] != 1 or launches["level_counts"]
            or launches["vertical_counts"]
            or any(k.startswith(("preprocess", "level k=")) for k in fields)):
        raise SystemExit(f"phase-1 resume: launches {launches}, events "
                         f"{sorted(fields)}: expected K2 once and no mining")
    out["phase1_resume_cli_s"] = fields["cli_wall_s"]
    # (e) A small pending budget: drains, the same digests.
    out["budget_drains_ms"] = budget_run(in_dir, os.path.join(WORK, "budget"),
                                         MIN_SUPPORT, 1)
    # (f) One injected transient, absorbed.
    launches, fields = cli_path(
        "injected transient", in_dir, os.path.join(WORK, "out_retry"),
        MIN_SUPPORT, digests, injected=("fetch.level_bits", "oom*1"))
    require_launches("injected transient", launches, fields,
                     ran=("level_counts", "first_match"))
    out["injected_cli_s"] = fields["cli_wall_s"]
    log("reliability summary: " + json.dumps(out))
    return out


# Phase 10: each hand kernel's symbol in the device trace (the name
# torch.profiler reports holds it) and the launch counter it must equal.
KERNEL_SYMBOLS = {"level_counts": "level_counts_packed",
                  "first_match": "first_match_kernel",
                  "vertical_counts": "vertical_counts_kernel"}


def traced_kernel_calls(summary: dict) -> dict:
    """Launches of each hand kernel in a ``kernel_summary``."""
    return {name: sum(r["calls"] for r in summary["kernels"]
                      if sym in r["name"])
            for name, sym in KERNEL_SYMBOLS.items()}


def profiled_run(name: str, in_dir: str, min_support: str, digests: dict,
                 env=None, trace_path=None) -> tuple:
    """Phase 10: the CLI with ``--profile-dir`` (and ``--trace`` with
    ``trace_path``), retaken up to three times while the device trace
    lacks a launch the counters saw (torch.profiler has returned an empty
    device trace once after full ones): each hand kernel's launches in
    the trace must equal its counter, else the phase fails.  Returns
    ``(launches, fields, kernel_summary)``."""
    from fastapriori_tpu_torch.obs import device_trace, trace

    for attempt in range(3):
        prof = os.path.join(WORK, f"prof_{name.replace(' ', '_')}_{attempt}")
        extra = ["--profile-dir", prof]
        if trace_path:
            extra += ["--trace", trace_path]
        launches, fields = cli_path(
            f"{name} (attempt {attempt + 1})", in_dir,
            os.path.join(WORK, "out_prof"), min_support, digests, env=env,
            extra_args=extra, allowed=("device_trace_unavailable",),
            verbose=attempt == 0)
        trace.TRACER.disable()
        summary = device_trace.kernel_summary(prof)
        traced = traced_kernel_calls(summary)
        if traced == launches:
            log(f"{name}: device trace {summary['trace']}: hand kernels "
                f"{traced}, equal to the launch counters")
            return launches, fields, summary
        log(f"{name}: the device trace holds {traced}, the counters "
            f"{launches} (capture {attempt + 1} of 3)")
    raise SystemExit(f"{name}: after three captures the device trace still "
                     f"lacks launches the counters saw")


def log_device_stages(name: str, summary: dict, card: str) -> dict:
    """One line of per-stage device time and one of the heaviest kernel
    rows (names cut to 120 characters) from a ``kernel_summary``."""
    stages = {k: round(v / 1e3, 4) for k, v in summary["by_stage"].items()}
    log(f"{name}: device time by stage (ms; {card}): {json.dumps(stages)}")
    top = [{"name": r["name"][:120], "stage": r["stage"],
            "calls": r["calls"], "ms": round(r["total_us"] / 1e3, 4)}
           for r in summary["kernels"][:8]]
    log(f"{name}: heaviest device events: {json.dumps(top)}")
    return stages


def require_span_tree(name: str, trace_path: str, fields: dict) -> int:
    """The ``--trace`` artifact of a run: a valid Chrome trace whose
    spans nest run -> phase -> mine -> level, with one ``level`` span per
    ``level`` event of the run.  Returns its event count."""
    from fastapriori_tpu_torch.obs.trace import validate_chrome_trace

    with open(trace_path) as f:
        doc = json.load(f)
    problems = validate_chrome_trace(doc)
    if problems:
        raise SystemExit(f"{name}: invalid Chrome trace: {problems[:5]}")
    spans = {e["args"]["sid"]: e for e in doc["traceEvents"]
             if e["ph"] == "X"}
    for sid in ("main:run#0", "main:run#0/phase#0", "main:run#0/phase#1",
                "main:run#0/phase#0/mine#0"):
        if sid not in spans:
            raise SystemExit(f"{name}: the trace lacks span {sid}")
    ks = sorted(e["args"]["k"] for e in spans.values()
                if e["name"] == "level"
                and e["args"]["sid"].startswith("main:run#0/phase#0/mine#0/"))
    want = sorted(int(key.split("=")[1].split()[0]) for key in fields
                  if key.startswith("level k="))
    if ks != want:
        raise SystemExit(f"{name}: level spans k {ks}, level events {want}")
    log(f"{name}: trace {len(doc['traceEvents'])} events, valid, run -> "
        f"phase -> mine -> level k = {ks}")
    return len(doc["traceEvents"])


def observability_phase(in_dir: str, k_in: str, card: str) -> dict:
    """Phase 10: the traced and profiled CLI (the module docstring).
    Returns the walls and the per-stage device times."""
    from fastapriori_tpu_torch.obs import trace

    digests = {"freqItemset": FREQ_SHA256, "recommends": REC_SHA256}
    kdigests = {"freqItemset": KOSARAK["freq_sha256"],
                "recommends": KOSARAK["rec_sha256"]}
    trace.TRACER.disable()
    out: dict = {"card": card}
    # (a) The warm T10 zero-flag wall: plain, --trace, --profile-dir, in
    # turns, four runs each after one untimed round (the process's first
    # profiler start is logged there: it is not a warm run's).
    walls = {"plain": [], "trace": [], "profile": []}
    for i in range(-1, 4):
        for kind in walls:
            extra = ()
            if kind == "trace":
                extra = ("--trace", os.path.join(WORK, f"wall_{i}.json"))
            elif kind == "profile":
                extra = ("--profile-dir", os.path.join(WORK, f"wall_{i}"))
            launches, fields = cli_path(
                f"wall {kind} {i + 1}", in_dir, os.path.join(WORK, "out_obs"),
                MIN_SUPPORT, digests, extra_args=extra,
                allowed=("device_trace_unavailable",), verbose=False)
            trace.TRACER.disable()
            require_launches(f"wall {kind} {i + 1}", launches, fields,
                             ran=("level_counts", "first_match"))
            if i < 0:
                out[f"t10_{kind}_first_cli_s"] = fields["cli_wall_s"]
            else:
                walls[kind].append(fields["cli_wall_s"])
    for kind, ws in walls.items():
        ws = sorted(ws)
        out[f"t10_{kind}_cli_s"] = ws
        log(f"observability wall, T10 zero flags {kind} ({card}): median "
            f"{(ws[1] + ws[2]) / 2:.4f} s, min {ws[0]:.4f}, max {ws[-1]:.4f} "
            f"over {len(ws)} warm runs")
    # (b) --trace and --profile-dir together: the span tree, and K1 x 7
    # and K2 x 1 in the device trace.
    path = os.path.join(WORK, "t10.trace.json")
    launches, fields, summary = profiled_run(
        "traced main path", in_dir, MIN_SUPPORT, digests, trace_path=path)
    require_launches("traced main path", launches, fields,
                     ran=("level_counts", "first_match"))
    if (launches["level_counts"], launches["first_match"]) != (7, 1):
        raise SystemExit(f"traced main path: launches {launches}, expected "
                         f"K1 x 7 and K2 x 1")
    out["t10_trace_events"] = require_span_tree("traced main path", path,
                                                fields)
    out["t10_device_ms_by_stage"] = log_device_stages("traced main path",
                                                      summary, card)
    # (c) kosarak vertical with --profile-dir: K3 x 6.
    launches, fields, summary = profiled_run(
        "profiled vertical path", k_in, KOSARAK["min_support"], kdigests,
        env={"FA_MINE_ENGINE": "vertical"})
    require_launches("profiled vertical path", launches, fields,
                     ran=("vertical_counts", "first_match"))
    if launches["vertical_counts"] != 6:
        raise SystemExit(f"profiled vertical path: launches {launches}, "
                         f"expected K3 x 6")
    out["kosarak_device_ms_by_stage"] = log_device_stages(
        "profiled vertical path", summary, card)
    # (d) FA_NO_PALLAS=1: the plain versions on the card, no hand kernel,
    # one pallas_disabled event, the JAX digests.
    launches, fields = cli_path(
        "FA_NO_PALLAS path", in_dir, os.path.join(WORK, "out_plain"),
        MIN_SUPPORT, digests, env={"FA_NO_PALLAS": "1"},
        ledgered={"pallas_disabled": 1})
    if any(launches.values()):
        raise SystemExit(f"FA_NO_PALLAS path: hand kernels launched "
                         f"{launches}")
    plain = [k for k, v in fields.items()
             if isinstance(v, dict) and v.get("plain_kernels")]
    if "first_match" not in plain or not any(k.startswith("level k=")
                                             for k in plain):
        raise SystemExit(f"FA_NO_PALLAS path: events with plain_kernels "
                         f"{plain}")
    out["t10_no_pallas_cli_s"] = fields["cli_wall_s"]
    log(f"FA_NO_PALLAS path: no hand kernel launched, plain versions in "
        f"{plain} ({card})")
    log("observability summary: " + json.dumps(out))
    return out


# Phase 11: requests of the sustained open-loop run, of the overload run
# and of the recovery run after it (U.dat's 10,000 lines cycled).
SERVE_SUSTAINED_N = 20_000
SERVE_OVERLOAD_N = 80_000
SERVE_RECOVERY_N = 5_000


def require_served(name: str, fields: dict, n: int) -> dict:
    """A serve CLI run's ``serve`` metrics event (the server's stats):
    every one of the ``n`` requests served, none shed or failed, no
    ``serve_error``.  Returns the stats."""
    st = fields.get("serve")
    if st is None:
        raise SystemExit(f"{name}: no serve metrics event")
    got = (st["served"], st["shed"], st.get("failed"), st.get("errors"))
    if got != (n, 0, 0, 0):
        raise SystemExit(f"{name}: served, shed, failed, errors = {got}, "
                         f"expected ({n}, 0, 0, 0)")
    return st


def serve_dispatches(st: dict) -> int:
    """K2 launches a serve run's states counted (each host's on a mesh)."""
    hosts = st.get("per_host") or [st]
    return sum(h["model"]["scan_dispatches"] for h in hosts)


def zero_launches() -> dict:
    """Every kernel's launch count set to 0; the kernels by name, for
    :func:`read_launches` just after the run they count."""
    kernels = kernel_launches()
    for fn in kernels.values():
        fn.launches = 0
    return kernels


def read_launches(kernels: dict) -> dict:
    return {n: fn.launches for n, fn in kernels.items()}


def require_scan_launches(name: str, launches: dict, dispatched: int,
                          kernel: bool = True, mined: bool = False) -> None:
    """K2 launched once per scan dispatch the serving states counted
    (none with ``kernel`` False: the plain version ran); unless the run
    ``mined`` its model, K1 and K3 launched no time."""
    want = dispatched if kernel else 0
    bad = launches["first_match"] != want or (kernel and want < 2)
    if not mined:
        bad = bad or launches["level_counts"] or launches["vertical_counts"]
    if bad:
        raise SystemExit(f"{name}: launches {launches}, the states counted "
                         f"{dispatched} scan dispatches"
                         + ("" if mined else "; K1 and K3 must not launch"))


def require_serve_launches(name: str, launches: dict, st: dict,
                           kernel: bool = True, mined: bool = False) -> None:
    """:func:`require_scan_launches` for a serve CLI run: K2 against the
    scan dispatches of every host's state, the warm probe included."""
    require_scan_launches(name, launches, serve_dispatches(st), kernel, mined)
    log(f"{name}: K2 launches {launches['first_match']} = the states' scan "
        f"dispatches (the warm probe included); {st['batches']} batches, "
        f"avg {st.get('avg_batch')} rows")


def serve_cli_runs(in_dir: str, main_launches: dict) -> tuple:
    """Phase 11 (a)-(c), (f) and (g): the serve CLI in-process (the
    module docstring).  Returns ``(walls and facts, K2 and K1 launches by
    run)``."""
    from fastapriori_tpu_torch.obs import trace

    digests = {"recommends": REC_SHA256}
    n_users = T10["n_users"]
    out: dict = {}
    launches_by: dict = {}
    # (a) T10 closed loop, the model mined here, traced and dumped.
    out_a = os.path.join(WORK, "out_serve")
    trace_path = os.path.join(WORK, "serve.trace.json")
    dump = os.path.join(WORK, "serve.metrics.prom")
    launches, fields = cli_path(
        "serve T10", in_dir, out_a, MIN_SUPPORT, digests,
        extra_args=("--save-serving", "--trace", trace_path,
                    "--metrics-dump", dump),
        allowed=("serve_engine",), serve=True)
    trace.TRACER.disable()
    trace.TRACER.reset()
    st = require_served("serve T10", fields, n_users)
    model = st["model"]
    if (model["engine"], model.get("resident_table"),
            model["rule_table_host_bytes"]) != ("device", False, 0):
        raise SystemExit(f"serve T10: model {model}: expected the device "
                         f"engine on the host-built table, 0 table bytes "
                         f"over the link")
    require_serve_launches("serve T10", launches, st, mined=True)
    if launches["level_counts"] != main_launches["level_counts"]:
        raise SystemExit(f"serve T10: the model build launched K1 "
                         f"{launches['level_counts']} times, the batch CLI "
                         f"{main_launches['level_counts']}")
    with open(trace_path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    missing = {"serve.batch", "serve.scan", "fetch.serve_match"} - names
    if missing:
        raise SystemExit(f"serve T10: the trace lacks {sorted(missing)}")
    with open(dump) as f:
        if f"fa_serve_served_total {n_users}\n" not in f.read():
            raise SystemExit(f"serve T10: the metrics dump does not count "
                             f"{n_users} served")
    out["t10"] = {"cli_s": fields["cli_wall_s"],
                  "mount_ms": fields["walls"].get("serve model mount"),
                  "serve_ms": fields["walls"].get("serve"),
                  "batches": st["batches"], "avg_batch": st["avg_batch"],
                  "warm_ms": model["warm_ms"],
                  "table_bytes": model["table_bytes"]}
    launches_by["t10i4d100k_serve_cli"] = launches
    # (b) Warm restart from (a)'s artifact.
    launches, fields = cli_path(
        "serve T10 restart", in_dir, os.path.join(WORK, "out_serve_restart"),
        MIN_SUPPORT, digests, extra_args=("--from-serving", out_a + "/"),
        ingest=False, ledgered={"serving_restart": 1},
        allowed=("serve_engine",), serve=True)
    st = require_served("serve T10 restart", fields, n_users)
    require_serve_launches("serve T10 restart", launches, st)
    out["t10_restart"] = {"cli_s": fields["cli_wall_s"],
                          "mount_ms": fields["walls"].get("serve model mount"),
                          "warm_ms": st["model"]["warm_ms"]}
    launches_by["t10i4d100k_serve_restart_cli"] = launches
    # (c) The large model: auto takes the device rule engine, the scan
    # mounts the table built on the device; the batch CLI's bytes.
    out_c = os.path.join(WORK, "out_serve_big")
    # The mine at this support outgrows the pair program's budgets
    # (recorded overflows, phase 8's lattice).
    big_allowed = ("serve_engine", "pair_cap_overflow", "pair_l3_overflow")
    launches, fields = cli_path(
        "serve T10 big", in_dir, out_c, BIG_MIN_SUPPORT, {},
        extra_args=("--save-serving",), allowed=big_allowed, serve=True)
    st = require_served("serve T10 big", fields, n_users)
    model = st["model"]
    if (model["engine"], model.get("resident_table"),
            model["rule_table_host_bytes"],
            fields.get("rule_gen_engine", {}).get("engine")) != (
                "device", True, 0, "device"):
        raise SystemExit(f"serve T10 big: model {model}, rule engine "
                         f"{fields.get('rule_gen_engine')}: expected the "
                         f"device rule engine and the resident table")
    require_serve_launches("serve T10 big", launches, st, mined=True)
    launches_by[f"t10i4d100k_{BIG_MIN_SUPPORT}_serve_cli"] = launches
    out_bb = os.path.join(WORK, "out_batch_big")
    launches, fields_bb = cli_path("batch T10 big", in_dir, out_bb,
                                   BIG_MIN_SUPPORT, {}, allowed=big_allowed)
    launches_by[f"t10i4d100k_{BIG_MIN_SUPPORT}_batch_cli"] = launches
    got, want = (sha256(os.path.join(d, "recommends"))
                 for d in (out_c, out_bb))
    if got != want:
        raise SystemExit(f"serve T10 big: recommends {got} != the batch "
                         f"CLI's {want}")
    log(f"serve T10 big: recommends equal the batch CLI's at "
        f"{BIG_MIN_SUPPORT} ({got}); {model['n_rules']} rules, table "
        f"{model['table_bytes']} bytes, resident")
    out["t10_big"] = {"cli_s": fields["cli_wall_s"],
                      "mount_ms": fields["walls"].get("serve model mount"),
                      "batch_cli_s": fields_bb["cli_wall_s"],
                      "n_rules": model["n_rules"],
                      "table_bytes": model["table_bytes"]}
    # (f) Two in-process hosts behind the router, from (b)'s artifact.
    launches, fields = cli_path(
        "serve T10 hosts 2", in_dir, os.path.join(WORK, "out_serve_hosts"),
        MIN_SUPPORT, digests,
        extra_args=("--from-serving", out_a + "/", "--hosts", "2"),
        ingest=False, ledgered={"serving_restart": 2},
        allowed=("serve_engine",), serve=True)
    st = require_served("serve T10 hosts 2", fields, n_users)
    require_serve_launches("serve T10 hosts 2", launches, st)
    per_host = {h["host"]: {k: h[k] for k in ("served", "batches",
                                              "avg_batch")}
                for h in st["per_host"]}
    if st["hosts"] != 2 or any(h["served"] <= 0 for h in per_host.values()):
        raise SystemExit(f"serve T10 hosts 2: per host {per_host}")
    log(f"serve T10 hosts 2: per host {json.dumps(per_host)}")
    out["t10_hosts2"] = {"cli_s": fields["cli_wall_s"], "per_host": per_host}
    launches_by["t10i4d100k_serve_hosts2_cli"] = launches
    # (g) FA_NO_PALLAS=1: K2's plain version on the card.
    launches, fields = cli_path(
        "serve T10 FA_NO_PALLAS", in_dir,
        os.path.join(WORK, "out_serve_plain"), MIN_SUPPORT, digests,
        env={"FA_NO_PALLAS": "1"},
        extra_args=("--from-serving", out_a + "/"), ingest=False,
        ledgered={"pallas_disabled": 1, "serving_restart": 1},
        allowed=("serve_engine",), serve=True)
    st = require_served("serve T10 FA_NO_PALLAS", fields, n_users)
    require_serve_launches("serve T10 FA_NO_PALLAS", launches, st,
                           kernel=False)
    if st["model"].get("kernel") is not False:
        raise SystemExit(f"serve T10 FA_NO_PALLAS: model {st['model']}")
    out["t10_no_pallas"] = {"cli_s": fields["cli_wall_s"]}
    launches_by["t10i4d100k_serve_no_pallas_cli"] = launches
    return out, launches_by


def answers_of(out_dir: str) -> list:
    with open(os.path.join(out_dir, "recommends")) as f:
        return f.read().splitlines()


def require_answers(name: str, reqs, answers: dict, n_lines: int) -> None:
    """Every served request's answer is the batch answer of its row under
    the model whose signature it carries (``answers``: signature -> the
    recommends lines)."""
    for i, r in enumerate(reqs):
        if r.error is not None:
            raise SystemExit(f"{name}: request {i} failed: {r.error}")
        if r.shed:
            continue
        want = answers.get(r.model)
        if want is None or r.item != want[i % n_lines]:
            raise SystemExit(f"{name}: request {i} answered {r.item!r} "
                             f"under model {r.model}")


def open_loop_runs(in_dir: str, device, card: str) -> tuple:
    """Phase 11 (d): closed-batch capacity, a sustained open-loop run at
    0.9x of it and an overload at 3x with the queue bounded at one
    micro-batch, then a recovery run at 0.5x, at pipeline depths 2 and
    0, through the API on (a)'s model; each batch's upload, launch and
    fetch issue under ``set_sync_debug_mode("error")``.  Returns
    ``(records, launches by depth, K2 at the serving shapes)``."""
    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.io.reader import read_dat
    from fastapriori_tpu_torch.reliability import ledger
    from fastapriori_tpu_torch.serve import (
        RecommendServer,
        ServingState,
        run_open_loop,
    )

    u_lines = read_dat(os.path.join(in_dir, "U.dat"))
    n = len(u_lines)
    out_a = os.path.join(WORK, "out_serve")
    state = ServingState.load(out_a + "/", config=MinerConfig(
        min_support=float(MIN_SUPPORT)), device=device)
    state.warm()
    state.ctx.sync_check = True
    answers = {state.signature: answers_of(out_a)}
    records: dict = {}
    launches_by: dict = {}
    for depth in (2, 0):
        kernels = zero_launches()
        d0 = state.scan_dispatches
        server = RecommendServer(state, pipeline_depth=depth).start()
        # The closed batch four times: the first (allocator and pinned
        # memory first use at these shapes) untimed, the median of the
        # other three the capacity.
        walls = []
        for i in range(4):
            before = server.stats()["batches"]
            t0 = time.perf_counter()
            reqs = [server.submit_wait(t, timeout_s=60.0) for t in u_lines]
            if not server.wait_for(reqs, timeout_s=120.0):
                raise SystemExit(f"serve depth {depth}: the closed batch "
                                 f"did not drain")
            if i:
                walls.append(time.perf_counter() - t0)
            require_answers(f"serve depth {depth} closed", reqs, answers, n)
        capacity = n / sorted(walls)[1]
        closed = server.stats()
        closed["batches"] -= before
        reqs = []
        sustained = run_open_loop(
            server, u_lines, rate_rps=0.9 * capacity,
            n_requests=SERVE_SUSTAINED_N, seed=11, drain_timeout_s=120.0,
            label="sustained", requests_out=reqs)
        require_answers(f"serve depth {depth} sustained", reqs, answers, n)
        if not server.stop():
            raise SystemExit(f"serve depth {depth}: the server did not stop")
        ledger.reset()
        rows = state.batch_rows()
        server = RecommendServer(state, pipeline_depth=depth,
                                 queue_depth=rows).start()
        reqs = []
        over = run_open_loop(
            server, u_lines, rate_rps=3 * capacity,
            n_requests=SERVE_OVERLOAD_N, seed=12, drain_timeout_s=120.0,
            label="overload", requests_out=reqs)
        require_answers(f"serve depth {depth} overload", reqs, answers, n)
        cascades = [e for e in ledger.snapshot() if e["kind"] == "cascade"
                    and e.get("chain") == "serving"]
        if not (over["drained"] and over["shed"] > 0 and cascades
                and over["max_queue"] <= rows):
            raise SystemExit(f"serve depth {depth} overload: {over}, "
                             f"{len(cascades)} serving cascade events: "
                             f"expected sheds, recorded, the queue within "
                             f"{rows}")
        recovery = run_open_loop(
            server, u_lines, rate_rps=0.5 * capacity,
            n_requests=SERVE_RECOVERY_N, seed=13, drain_timeout_s=120.0,
            label="recovery")
        if not (recovery["drained"] and recovery["shed"] == 0):
            raise SystemExit(f"serve depth {depth}: no recovery after the "
                             f"overload: {recovery}")
        if not server.stop():
            raise SystemExit(f"serve depth {depth}: the server did not stop")
        launches = read_launches(kernels)
        require_scan_launches(f"serve depth {depth}", launches,
                              state.scan_dispatches - d0)
        launched = launches["first_match"]
        ledger.reset()
        rec = {"capacity_rps": capacity,
               "closed_walls_s": walls,
               "closed_batches": closed["batches"],
               "sustained": sustained, "overload": over,
               "recovery": recovery, "k2_launches": launched}
        for key in ("sustained", "overload", "recovery"):
            r = rec[key]
            log(f"serve depth {depth} {key} ({card}): offered "
                f"{r['offered_rps']} rps, achieved {r['achieved_rps']}, "
                f"p50/p95/p99 {r['p50_ms']}/{r['p95_ms']}/{r['p99_ms']} ms, "
                f"served {r['served']}, shed {r['shed']}, max queue "
                f"{r['max_queue']}, avg batch {r['avg_batch']}")
        log(f"serve depth {depth} ({card}): closed-batch capacity "
            f"{capacity:.1f} users/s (median of 3 warm passes of {n}: "
            f"{', '.join(f'{w * 1e3:.3f}' for w in walls)} ms; the last "
            f"in {closed['batches']} batches); K2 launches {launched} = "
            f"scan dispatches")
        records[f"depth{depth}"] = rec
        launches_by[f"t10i4d100k_serve_api_depth{depth}"] = launches
    state.ctx.sync_check = False
    serve_k2 = serve_block_measure(state, u_lines, device)
    state.release()
    return records, launches_by, serve_k2


def serve_block_measure(state, u_lines, device) -> dict:
    """K2 at the serving blocks' shapes on (a)'s table: a full
    4,096-row block of distinct baskets against the plain version, and
    one basket's round trip (upload, K2, select, fetch) padded to 32 rows
    (the port's choice: the next power of two of the real rows) against
    the same basket padded to the full 4,096 rows (the JAX package's
    fixed shape)."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.ops.bitmap import build_bitmap
    from fastapriori_tpu_torch.ops.match_kernel import (
        NO_MATCH,
        first_match,
        first_match_plain,
    )
    from fastapriori_tpu_torch.preprocess import dedup_user_baskets

    h = state._handle
    rec = state._rec
    ant, size, cons = rec.table()
    baskets, _, _ = dedup_user_baskets(u_lines, state.item_to_rank)
    rows = state.batch_rows()
    bm, blen = state._pack_blocks(baskets[:rows])[0][2:]
    args = (torch.from_numpy(bm).to(device),
            torch.from_numpy(blen).to(device), ant, size, cons)
    got = first_match(*args)
    err = require_equal("first_match serving block", got,
                        first_match_plain(*args))
    ms = time_ms(lambda: first_match(*args), iters=20)
    plain_ms = time_ms(lambda: first_match_plain(*args), iters=2, warmup=1)
    mb, f = bm.shape
    r, k = ant.shape
    scanned = torch.where(got < NO_MATCH, got.long() + 1,
                          torch.full_like(got, rec.n_rules, dtype=torch.long))
    scanned = torch.where(args[1] > 0, scanned, torch.zeros_like(scanned))
    n_ops = 2 * f * int(scanned.sum().item())
    n_bytes = mb * f + 4 * mb + 4 * r * k + 8 * r + 4 * mb
    bound_ms, bound_by = bound(n_bytes, n_ops)
    one = [baskets[0]]
    small = state._pack_blocks(one)[0][2:]
    full_bm = build_bitmap(one, len(state.freq_items), rows,
                           state.config.item_tile)
    full_blen = np.zeros(rows, dtype=np.int32)
    full_blen[0] = len(one[0])

    # Each round trip ends in a host wait, so host time is its time: the
    # median of 200 calls of each form, in turns.
    times: dict = {"small": [], "full": []}
    blocks = {"small": small, "full": (full_bm, full_blen)}
    for i in range(404):
        key = ("small", "full")[i % 2]
        t0 = time.perf_counter()
        h.scan(*blocks[key])[1].cpu()
        if i >= 4:
            times[key].append((time.perf_counter() - t0) * 1e3)
    small_ms, full_ms = (sorted(times[key])[len(times[key]) // 2]
                         for key in ("small", "full"))
    log(f"K2 serving block MB={mb} F={f} R={r} K={k}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"one basket's round trip (median of 200, host clock): "
        f"{small_ms:.4f} ms at 32 rows, {full_ms:.4f} ms at {rows} rows")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "mb": mb, "one_basket_round_trip_ms": {
                "32_rows": small_ms, f"{rows}_rows": full_ms}}


def hot_swap_run(in_dir: str, device, capacity: float) -> tuple:
    """Phase 11 (e): an open-loop run at half the capacity on (a)'s model,
    swapped for (c)'s mid-run: every response carries its model's
    signature and that model's batch answer for its row; the device
    memory the scan thread holds drops at the barrier by at least the
    old table's bytes.  The launch counts are set to 0 just before the
    incoming table's readiness probe and read just after the server
    stops.  Returns ``(record, launches)``."""
    import torch

    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.io.reader import read_dat
    from fastapriori_tpu_torch.serve import (
        RecommendServer,
        ServingState,
        run_open_loop,
    )

    u_lines = read_dat(os.path.join(in_dir, "U.dat"))
    n = len(u_lines)
    out_a = os.path.join(WORK, "out_serve")
    out_c = os.path.join(WORK, "out_serve_big")
    state_a = ServingState.load(out_a + "/", config=MinerConfig(
        min_support=float(MIN_SUPPORT)), device=device)
    state_b = ServingState.load(out_c + "/", config=MinerConfig(
        min_support=float(BIG_MIN_SUPPORT)), device=device)
    kernels = zero_launches()
    t0 = time.perf_counter()
    state_b.device_ready()  # the incoming table mounted and proven
    ready_ms = (time.perf_counter() - t0) * 1e3
    answers = {state_a.signature: answers_of(out_a),
               state_b.signature: answers_of(out_c)}
    server = RecommendServer(state_a).start()
    table_a = state_a.describe()["table_bytes"]
    mem: dict = {}
    real_release = state_a.release

    def release() -> None:
        mem["before"] = torch.cuda.memory_allocated(device)
        real_release()
        mem["after"] = torch.cuda.memory_allocated(device)

    state_a.release = release
    reqs: list = []
    result: dict = {}
    loader = threading.Thread(target=lambda: result.update(run_open_loop(
        server, u_lines, rate_rps=0.5 * capacity,
        n_requests=SERVE_SUSTAINED_N, seed=21, drain_timeout_s=120.0,
        label="hot_swap", requests_out=reqs)), daemon=True)
    loader.start()
    deadline = time.monotonic() + 60.0
    while (server.stats()["submitted"] < SERVE_SUSTAINED_N // 2
           and time.monotonic() < deadline):
        time.sleep(0.001)
    t_swap = time.perf_counter()
    if not server.swap(state_b).wait(60.0):
        raise SystemExit("serve hot swap: the barrier did not commit")
    barrier_ms = (time.perf_counter() - t_swap) * 1e3
    loader.join(180.0)
    if loader.is_alive() or not result.get("drained"):
        raise SystemExit(f"serve hot swap: the run did not drain: {result}")
    if not server.stop():
        raise SystemExit("serve hot swap: the server did not stop")
    launches = read_launches(kernels)
    require_scan_launches("serve hot swap", launches,
                          state_a.scan_dispatches + state_b.scan_dispatches)
    require_answers("serve hot swap", reqs, answers, n)
    by_model = {sig: sum(1 for r in reqs if r.model == sig)
                for sig in answers}
    if min(by_model.values()) <= 0:
        raise SystemExit(f"serve hot swap: responses by model {by_model}")
    drop = mem["before"] - mem["after"]
    if drop < table_a:
        raise SystemExit(f"serve hot swap: device memory dropped {drop} "
                         f"bytes at the barrier, less than the old table's "
                         f"{table_a}")
    rec = {"responses_by_model": by_model, "memory_drop_bytes": drop,
           "old_table_bytes": table_a, "barrier_ms": barrier_ms,
           "incoming_ready_ms": ready_ms,
           "incoming_table_bytes": state_b.describe()["table_bytes"],
           "run": result}
    log(f"serve hot swap: {json.dumps(rec)}")
    state_b.release()
    return rec, launches


def serving_phase(in_dir: str, device, card: str,
                  main_launches: dict) -> tuple:
    """Phase 11 (the module docstring).  Returns ``(walls and records,
    launches by run, K2 at the serving shapes)``."""
    t0 = time.perf_counter()
    out, launches_by = serve_cli_runs(in_dir, main_launches)
    records, api_launches, serve_k2 = open_loop_runs(in_dir, device, card)
    out["open_loop"] = records
    # (h)'s workers start up while (e) runs, on (a)'s model.
    model, big = (os.path.join(WORK, name) + "/"
                  for name in ("out_serve", "out_serve_big"))
    box = start_proc_hosts(model)
    swap, swap_launches = hot_swap_run(
        in_dir, device, records["depth2"]["capacity_rps"])
    out["hot_swap"] = swap
    launches_by.update(api_launches)
    launches_by["t10i4d100k_serve_hot_swap_api"] = swap_launches
    out["proc_host"], proc_launches = proc_host_run(
        box, model, big, in_dir, device, card)
    launches_by.update(proc_launches)
    by_kernel = {kernel: {path: launches[kernel]
                          for path, launches in launches_by.items()}
                 for kernel in kernel_launches()}
    out["wall_s"] = time.perf_counter() - t0
    log(f"serving phase ({card}): {out['wall_s']:.3f} s")
    log("serving summary: " + json.dumps(out))
    return out, by_kernel, serve_k2


# Phase 11 (h): the worker-process hosts' queue bound, far above a
# burst, so a run sheds only when a host dies; every started host, for
# the script's end to stop.
PROC_QUEUE_DEPTH = 1 << 15
PROC_HOST_BOXES: list = []


def start_proc_hosts(prefix: str, cards: int = 1) -> dict:
    """Phase 11 (h)'s two ``ProcHost`` workers on ``prefix``'s model,
    started in a thread (each worker's start-up, torch's import and the
    model's mount overlap the parent's work): worker 0's scan slowed 5 ms
    a batch (its share is in flight when it is killed); worker i on card
    i when ``cards`` > 1, else both on cuda:0."""
    from fastapriori_tpu_torch.serve import ProcHost

    box: dict = {}
    PROC_HOST_BOXES.append(box)

    def start(i: int) -> None:
        env = {"FA_FAILPOINTS": "fetch.serve_match:delay@5" if i == 0
               else ""}
        if cards > 1:
            env["CUDA_VISIBLE_DEVICES"] = str(i)
        try:
            box[i] = ProcHost(f"proc{i}", os.path.join(WORK, f"proc{i}"),
                              prefix, batch_rows=256,
                              queue_depth=PROC_QUEUE_DEPTH,
                              start_timeout_s=180.0, env=env)
        except BaseException as exc:  # reported by proc_host_run
            box[i] = exc

    for i in range(2):
        shutil.rmtree(os.path.join(WORK, f"proc{i}"), ignore_errors=True)
    threads = [threading.Thread(target=start, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    box["threads"] = threads
    box["t0"] = time.perf_counter()
    return box


def local_answers(prefix: str, u_lines, device) -> tuple:
    """The LocalHost run: two in-process hosts on ``device`` serving
    ``prefix``'s model behind the router; ``(answers, signature)``."""
    from fastapriori_tpu_torch.serve import (
        LocalHost,
        MeshRouter,
        RecommendServer,
        ServingState,
    )

    states = [ServingState.load(prefix, device=device) for _ in range(2)]
    mesh = MeshRouter([LocalHost(f"local{i}", RecommendServer(
        st, batch_rows=256, queue_depth=PROC_QUEUE_DEPTH).start())
        for i, st in enumerate(states)])
    reqs = [mesh.submit(t) for t in u_lines]
    if not mesh.wait_for(reqs, timeout_s=120.0) or any(r.shed for r in reqs):
        raise SystemExit(f"LocalHost run on {prefix}: unanswered or shed")
    mesh.stop()
    for st in states:
        st.release()
    return [r.item for r in reqs], states[0].signature


def proc_host_run(box: dict, prefix: str, big_prefix: str, in_dir: str,
                  device, card: str, cards: int = 1) -> tuple:
    """Phase 11 (h) (the module docstring): the ``ProcHost`` mesh against
    the LocalHost run, a swap to ``big_prefix``'s model across both
    hosts, worker 0 killed mid-burst.  Returns ``(record, {path:
    launches})``, each worker's launches from its ``stats.json``."""
    from fastapriori_tpu_torch.io.reader import read_dat
    from fastapriori_tpu_torch.serve import MeshRouter

    u_lines = read_dat(os.path.join(in_dir, "U.dat"))
    want, sig = local_answers(prefix, u_lines, device)
    want_big, big_sig = local_answers(big_prefix, u_lines, device)
    for t in box["threads"]:
        t.join(300.0)
    hosts = [box.get(i) for i in range(2)]
    for i, h in enumerate(hosts):
        if not hasattr(h, "signature"):
            raise SystemExit(f"ProcHost proc{i}: {h!r}")
    start_s = time.perf_counter() - box["t0"]
    kernels = zero_launches()
    mesh = MeshRouter(hosts)
    try:
        rec = proc_host_checks(mesh, hosts, u_lines, want, sig, want_big,
                               big_sig, big_prefix)
    except SystemExit as exc:
        # Each worker's exit code, stats and last stderr lines.
        why = "; ".join(f"{h.name}: exit {h.proc.poll()}, stats "
                        f"{h.stats()}, log {h._log_tail()}" for h in hosts)
        raise SystemExit(f"{exc} ({why})") from None
    finally:
        mesh.stop()
    rec.update(start_s=start_s, cards=cards)
    parent = read_launches(kernels)
    if any(parent.values()):
        raise SystemExit(f"ProcHost: the router process launched {parent}")
    launches_by = {}
    rec["hosts"] = {}
    for h, row in zip(hosts, mesh.stats()["per_host"]):
        # From each worker's stats.json: the survivor's final one (K2 =
        # the scan dispatches of both models it mounted, the warm probes
        # included), the killed worker's last heartbeat's.
        got = row.get("launches", {})
        want_k2 = row.get("scan_dispatches_total", -1)
        bad = (got.get("first_match", 0) < 2 or got.get("level_counts")
               or got.get("vertical_counts"))
        if h is hosts[1]:
            bad = bad or got.get("first_match") != want_k2
        if bad:
            raise SystemExit(f"ProcHost {h.name}: launches {got}, scan "
                             f"dispatches {want_k2}")
        launches_by[f"t10i4d100k_proc_host_{h.name}"] = {
            k: got.get(k, 0) for k in kernel_launches()}
        rec["hosts"][h.name] = {"served": row.get("served"),
                                "launches": got,
                                "scan_dispatches_total": want_k2}
    where = "one worker per card" if cards > 1 else "two workers on cuda:0"
    log(f"serve ProcHost ({card}, {where}): answers equal the LocalHost "
        f"run's, swap to {big_sig[:16]} in {rec['swap_s']:.3f} s, worker 0 "
        f"killed mid-burst: {rec['lost_shed']} in-flight requests answered "
        f"0 as sheds; {json.dumps(rec)}")
    return rec, launches_by


def proc_host_checks(mesh, hosts, u_lines, want, sig, want_big, big_sig,
                     big_prefix) -> dict:
    """:func:`proc_host_run`'s three runs on the started mesh, checked;
    returns their walls and shed counts."""
    rec = {}
    if {h.signature for h in hosts} != {sig}:
        raise SystemExit(f"ProcHost: ready signatures "
                         f"{[h.signature for h in hosts]} != {sig}")
    t0 = time.perf_counter()
    reqs = [mesh.submit(t) for t in u_lines]
    if not mesh.wait_for(reqs, timeout_s=120.0):
        raise SystemExit("ProcHost: requests unanswered in 120 s")
    rec["serve_s"] = time.perf_counter() - t0
    if [r.item for r in reqs] != want or any(r.shed for r in reqs):
        bad = sum(r.item != w for r, w in zip(reqs, want))
        raise SystemExit(f"ProcHost: {bad} answers differ from the "
                         f"LocalHost run's, {sum(r.shed for r in reqs)} "
                         f"shed; {mesh.stats()}")
    t0 = time.perf_counter()
    if not mesh.swap([big_prefix, big_prefix], timeout_s=120.0):
        raise SystemExit("ProcHost: the swap did not commit")
    rec["swap_s"] = time.perf_counter() - t0
    after = [mesh.submit(t) for t in u_lines]
    if not mesh.wait_for(after, timeout_s=120.0):
        raise SystemExit("ProcHost: requests after the swap unanswered")
    if ({r.model for r in after} != {big_sig}
            or [r.item for r in after] != want_big):
        raise SystemExit("ProcHost: answers after the swap differ from "
                         "the LocalHost run's on the swapped model")
    # Worker 0 killed mid-burst: its in-flight requests are answered "0"
    # and counted as sheds; every other answer is the model's.
    burst = u_lines * 2
    t0 = time.perf_counter()
    killed = []
    for i, t in enumerate(burst):
        killed.append(mesh.submit(t))
        if i == len(burst) // 4:
            hosts[0].kill()
    if not mesh.wait_for(killed, timeout_s=120.0):
        raise SystemExit("ProcHost: the burst was not answered after the "
                         "kill")
    rec["kill_burst_s"] = time.perf_counter() - t0
    for i, r in enumerate(killed):
        if r.item != ("0" if r.shed else want_big[i % len(u_lines)]):
            raise SystemExit(f"ProcHost: burst request {i} answered "
                             f"{r.item!r} (shed {r.shed})")
    st = mesh.stats()
    if st["hosts_lost"] != 1 or st["lost_shed"] < 1 or st["shed"] != sum(
            r.shed for r in killed):
        raise SystemExit(f"ProcHost: after the kill {st}")
    rec.update(lost_shed=st["lost_shed"], shed=st["shed"],
               submitted=st["submitted"])
    return rec


# Phase 12: the one-process device mesh, S transaction shards on the one
# card (a DeviceContext whose device list names cuda:0 S times).  Ledger
# kinds a mesh run may record: the reduction and exchange choices, the
# tiny-candidate fallback, a union overflow and its cascade walk.
MESH_ALLOWED = ("count_reduce_engine", "exchange_engine",
                "count_reduce_fallback", "count_sparse_overflow", "cascade")
# A union budget T10's reductions outgrow (FA_COUNT_SPARSE_CAP).
MESH_SMALL_CAP = "64"
# The cards a mesh's shards spread over (``--cards``; 1: every shard on
# cuda:0).
MESH_CARDS = 1


def mesh_context(n: int, cand: int = 1):
    from fastapriori_tpu_torch.device import DeviceContext

    return DeviceContext(devices=[f"cuda:{i % MESH_CARDS}"
                                  for i in range(n)], cand_devices=cand)


def mesh_bytes(fields: dict) -> dict:
    """The reductions' payloads of a mesh run, summed over its level,
    tail-fold and fused events, with the largest sparse union and the
    reductions and exchanges named."""
    out = {"psum_bytes": 0, "gather_bytes": 0, "intra_bytes": 0,
           "inter_bytes": 0, "n_union": 0}
    reduce, exchange = set(), set()
    for key, v in fields.items():
        if not key.startswith(("level k=", "tail_fuse", "fused_mine")):
            continue
        for b in ("psum_bytes", "gather_bytes", "intra_bytes",
                  "inter_bytes"):
            out[b] += int(v.get(b, 0))
        out["n_union"] = max(out["n_union"], int(v.get("n_union", 0)))
        if "reduce" in v:
            reduce.add(v["reduce"])
        if "exchange" in v:
            exchange.add(v["exchange"])
    out["reduce"] = sorted(reduce)
    out["exchange"] = sorted(exchange)
    return out


def mesh_runs(in_dir: str, k_in: str, card: str) -> tuple:
    """Phase 12's counted runs (the module docstring): each through the
    CLI's ``_run`` (``_run_serve``) on a mesh of cuda:0 named S times,
    the launch counts set to 0 just before and read just after, the JAX
    digests, the launches the run's own events count, and the
    reduction the JAX package chooses.  Returns ``({path: record},
    {path: launches})``."""
    import torch

    from fastapriori_tpu_torch.reliability import ledger

    t10 = {"freqItemset": FREQ_SHA256, "recommends": REC_SHA256}
    kos = {"freqItemset": KOSARAK["freq_sha256"],
           "recommends": KOSARAK["rec_sha256"]}
    big = {"freqItemset": BIG_FREQ_SHA256, "recommends": BIG_REC_SHA256}
    # (path, corpus, support, digests, shards, cand, env, args, serve)
    runs = [
        ("t10i4d100k_mesh_s2", in_dir, MIN_SUPPORT, t10, 2, 1, {}, (), False),
        ("t10i4d100k_mesh_s4", in_dir, MIN_SUPPORT, t10, 4, 1, {}, (), False),
        ("t10i4d100k_mesh_s8", in_dir, MIN_SUPPORT, t10, 8, 1, {}, (), False),
        ("t10i4d100k_mesh_4x2", in_dir, MIN_SUPPORT, t10, 4, 2, {}, (),
         False),
        ("t10i4d100k_fused_mesh_s2", in_dir, MIN_SUPPORT, t10, 2, 1, {},
         ("--engine", "fused"), False),
        ("t10i4d100k_mesh_s2_overflow", in_dir, MIN_SUPPORT, t10, 2, 1,
         {"FA_COUNT_SPARSE_CAP": MESH_SMALL_CAP}, (), False),
        ("kosarak_vertical_mesh_s2", k_in, KOSARAK["min_support"], kos, 2, 1,
         {"FA_MINE_ENGINE": "vertical"}, (), False),
        ("t10i4d100k_serve_mesh_s2", in_dir, MIN_SUPPORT,
         {"recommends": REC_SHA256}, 2, 1, {}, (), True),
        # The sharded rule join and K2's rank-strided form: forced at
        # 0.0025, auto's own choice at 0.0007.
        ("t10i4d100k_device_rules_mesh_s2", in_dir, MIN_SUPPORT, t10, 2, 1,
         {"FA_RULE_ENGINE": "device"}, (), False),
        (f"t10i4d100k_{BIG_MIN_SUPPORT}_mesh_s2", in_dir, BIG_MIN_SUPPORT,
         big, 2, 1, {}, (), False),
        (f"t10i4d100k_{BIG_MIN_SUPPORT}_mesh_s4", in_dir, BIG_MIN_SUPPORT,
         big, 4, 1, {}, (), False),
    ]
    records, launches_by = {}, {}
    for path, d, ms, digests, n, cand, env, args, serve in runs:
        ctx = mesh_context(n, cand)
        launches, fields = cli_path(
            path, d, os.path.join(WORK, "out_" + path), ms, digests, env=env,
            extra_args=args, ingest=False, verbose=False, serve=serve,
            allowed=MESH_ALLOWED + (("serve_engine",) if serve else ())
            # At 0.0007 the pairs outgrow their first budget (phase 8).
            + (("pair_cap_overflow",) if ms == BIG_MIN_SUPPORT else ()),
            context=ctx)
        events = ledger.snapshot()
        kinds = ledger.summary()
        shards = n // cand
        if serve:
            st = require_served(path, fields, T10["n_users"])
            require_serve_launches(path, launches, st, mined=True)
            # The host-built table (the host rule engine at T10's
            # support): blocks split over the S shards, and the JAX
            # handle's scan_shards is 1 (S for the strided table).
            if st["model"].get("scan_shards") != 1 or (
                    st["model"].get("resident_table")):
                raise SystemExit(f"{path}: the state scanned on "
                                 f"{st['model'].get('scan_shards')} shards, "
                                 f"resident {st['model'].get('resident_table')}")
            if launches["level_counts"] <= 0:
                raise SystemExit(f"{path}: the model build ran no K1")
        else:
            vertical = "arena_build" in fields
            ran = ("vertical_counts" if vertical else "level_counts",
                   "first_match")
            require_launches(path, launches, fields,
                             ran=ran[1:] if "fused" in path else ran)
            if fields.get("first_match", {}).get("shards") != shards:
                raise SystemExit(f"{path}: K2 ran on "
                                 f"{fields.get('first_match')}")
        rules = None
        if "device_rules" in path or BIG_MIN_SUPPORT in path:
            rules = require_sharded_rules(path, fields, shards)
        if "fused" in path:
            fused = [v for k, v in fields.items()
                     if k.startswith("fused_mine")]
            reduce = fused[0].get("reduce")
            if fused[-1].get("incomplete") is not False:
                raise SystemExit(f"{path}: the fused loop did not complete")
        else:
            reduce = fields.get("count_reduce", {}).get("engine")
        want_reduce = "dense" if cand > 1 else "sparse"
        if reduce != want_reduce:
            raise SystemExit(f"{path}: count reduction {reduce}, the JAX "
                             f"package's choice is {want_reduce}")
        spec = [(e["engine"], e["groups"], e["per_group"]) for e in events
                if e["kind"] == "exchange_engine"]
        want_spec = ([("hier", 2, 4)] if n == 8 else
                     [] if cand > 1 else [("flat", 1, n)])
        if spec != want_spec:
            raise SystemExit(f"{path}: exchange {spec}, expected "
                             f"{want_spec}")
        overflowed = "count_sparse_overflow" in kinds
        if path.endswith("_overflow") and not overflowed:
            raise SystemExit(f"{path}: FA_COUNT_SPARSE_CAP={MESH_SMALL_CAP} "
                             f"did not overflow a union")
        b = mesh_bytes(fields)
        rec = {"shards": shards, "cand": cand, "cli_s": fields["cli_wall_s"],
               "walls_ms": {k: fields["walls"][k] for k in (
                   "get freqItemsets", "get recommends", "serve model mount",
                   "serve") if k in fields["walls"]},
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches, "overflow": overflowed,
               "ledger": kinds, **b}
        if rules is not None:
            rec["rules"] = rules
        log(f"mesh run {path} ({card}): wall {fields['cli_wall_s']:.3f} s, "
            f"peak device memory {rec['peak_device_bytes']} bytes, "
            f"reductions {json.dumps(b)}, ledger {json.dumps(kinds)}")
        records[path] = rec
        launches_by[path] = launches
    return records, launches_by


def require_sharded_rules(path: str, fields: dict, shards: int) -> dict:
    """A mesh run's rule phase took the sharded join over all ``shards``
    (the JAX package's auto choice, or the forced device engine) and K2
    scanned the rank-strided table: each shard's slice 1/S of the
    one-shard table's rows.  Returns the join's walls and bytes."""
    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.models.recommender import scan_table_rows

    eng = fields.get("rule_gen_engine", {})
    dev = fields.get("rule_gen_device", {})
    fm = fields.get("first_match", {})
    if (eng.get("engine"), eng.get("shards"), dev.get("shards")) != (
            "device", shards, shards):
        raise SystemExit(f"{path}: rule engine {eng}, join {dev}: expected "
                         f"the device join on {shards} shards")
    chunk = MinerConfig().rule_chunk
    one = scan_table_rows(fm.get("rules", 0), 1, chunk)
    if (not fm.get("resident_table") or fm.get("shards") != shards
            or fm.get("table_rows") != scan_table_rows(
                fm["rules"], shards, chunk) // shards
            or fm["table_rows"] * shards != one):
        raise SystemExit(f"{path}: first_match {fm}: expected K2 on the "
                         f"rank-strided table, {one // shards} rows a shard")
    out = {"shards": shards, "wall_ms": fields["walls"]["rule_gen_device"],
           "table_rows_per_shard": fm["table_rows"],
           "one_shard_table_rows": one,
           "table_build_ms": fm.get("table_build_ms"),
           **{k: dev[k] for k in ("gather_bytes", "psum_bytes", "exchange",
                                  "raw_rules", "survivors")},
           "intra_bytes": sum(c["intra_bytes"] for c in dev["comms"]),
           "inter_bytes": sum(c["inter_bytes"] for c in dev["comms"])}
    log(f"{path}: sharded rule join {json.dumps(out)}")
    return out


def strided_k2_bound(args, kw, got) -> tuple:
    """The bound of one strided K2 launch on its shard's slice, as
    :func:`k2_measure` counts it: each real basket checks this slice's
    rows up to its first local match (local row ``(rank - s) / S``), or
    every real rule of the slice (padding rules have a size above F)."""
    import torch

    from fastapriori_tpu_torch.ops.match_kernel import NO_MATCH

    bm, blen, ant, size = args[:4]
    mb, f = bm.shape
    r, k = ant.shape
    real = int((size <= f).sum().item())
    rows = torch.where(got < NO_MATCH,
                       (got.long() - kw["shard"]) // kw["n_shards"] + 1,
                       torch.full_like(got, real, dtype=torch.long))
    rows = torch.where(blen > 0, rows, torch.zeros_like(rows))
    n_ops = 2 * f * int(rows.sum().item())
    n_bytes = mb * f + 4 * mb + 4 * r * k + 8 * r + 4 * mb
    return bound(n_bytes, n_ops)


def mesh_kernel_measure(in_dir: str, k_in: str) -> dict:
    """K1 and K2 on T10 (the level engine, the fold off so K1 counts
    every level, then the device recommend scan) and K3 on kosarak, at
    S = 2 through the API: every launch recorded with its per-shard
    inputs, held against the plain version (equal exactly) and timed
    (CUDA events on the launch's card, 10 calls).  Returns per kernel
    the per-launch times and shapes."""
    import torch

    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.io.reader import read_dat
    from fastapriori_tpu_torch.models import apriori, recommender
    from fastapriori_tpu_torch.models.apriori import FastApriori
    from fastapriori_tpu_torch.ops.level_kernel import (
        level_counts,
        level_counts_plain,
    )
    from fastapriori_tpu_torch.ops.match_kernel import (
        first_match,
        first_match_plain,
    )
    from fastapriori_tpu_torch.ops.vertical_kernel import (
        vertical_counts,
        vertical_counts_plain,
    )

    # kernel -> (module attribute the engine calls, wrapper, plain
    # version, the shapes of one launch's inputs)
    kernels = {
        "level_counts": (apriori, "level_counts", level_counts,
                         level_counts_plain,
                         lambda a: [list(a[0].shape), list(a[2].shape)]),
        "first_match": (recommender, "first_match", first_match,
                        first_match_plain,
                        lambda a: [list(a[0].shape), list(a[2].shape)]),
        "vertical_counts": (apriori, "vertical_level_local",
                            vertical_counts, vertical_counts_plain,
                            lambda a: [list(a[0].shape), list(a[3].shape),
                                       int(a[4].shape[0])]),
    }
    # K2's strided launches (n_shards > 1), by the run that made them.
    strided_runs = ("first_match_strided", "first_match_strided_big")
    calls = {name: [] for name in (*kernels, *strided_runs)}
    # Where strided K2 launches go; the 0.0007 run records only those.
    into_strided = ["first_match_strided"]

    def recorder(name, real):
        def recorded(*args, **kw):
            got = real(*args, **kw)
            if kw.get("n_shards", 1) > 1:
                calls[into_strided[0]].append((args, kw, got))
            elif into_strided[0] == "first_match_strided":
                calls[name].append((args, kw, got))
            return got
        return recorded

    for name, (module, attr, real, _, _) in kernels.items():
        setattr(module, attr, recorder(name, real))
    try:
        ctx = mesh_context(2)
        miner = FastApriori(config=MinerConfig(
            min_support=float(MIN_SUPPORT), engine="level",
            tail_fuse_rows=0), context=ctx)
        levels, data = miner.run_file_raw(os.path.join(in_dir, "D.dat"))
        users = read_dat(os.path.join(in_dir, "U.dat"))
        recommender.AssociationRules(
            [], data.freq_items, data.item_to_rank,
            levels=levels, item_counts=data.item_counts,
            config=miner.config, context=ctx).run(users, use_device=True)
        # The device rule join, then K2 on the rank-strided table.
        recommender.AssociationRules(
            [], data.freq_items, data.item_to_rank,
            levels=levels, item_counts=data.item_counts,
            config=MinerConfig(min_support=float(MIN_SUPPORT),
                               rule_engine="device"),
            context=ctx).run(users, use_device=True)
        FastApriori(config=MinerConfig(
            min_support=float(KOSARAK["min_support"]),
            mine_engine="vertical"), context=mesh_context(2)).run_file_raw(
                os.path.join(k_in, "D.dat"))
        # Auto's own sharded join at 0.0007 (2,097,152 table rows).
        into_strided[0] = "first_match_strided_big"
        big = FastApriori(config=MinerConfig(
            min_support=float(BIG_MIN_SUPPORT)), context=mesh_context(2))
        blevels, bdata = big.run_file_raw(os.path.join(in_dir, "D.dat"))
        recommender.AssociationRules(
            [], bdata.freq_items, bdata.item_to_rank, levels=blevels,
            item_counts=bdata.item_counts, config=big.config,
            context=big.ctx).run(users, use_device=True)
        del blevels, bdata, big
    finally:
        for module, attr, real, _, _ in kernels.values():
            setattr(module, attr, real)
    out = {}
    for name in calls:
        _, _, real, plain, shapes_of = kernels[name.split("_strided")[0]]
        if not calls[name]:
            raise SystemExit(f"{name}: the mesh API runs launched nothing")
        per, shapes, err, bounds = [], [], 0, []
        for args, kw, got in calls[name]:
            err = max(err, require_equal(f"{name} mesh launch", got,
                                         plain(*args, **kw)))
            with torch.cuda.device(args[0].device):
                per.append(round(time_ms(lambda a=args, k=kw: real(*a, **k),
                                         10), 4))
            shapes.append(shapes_of(args) + [kw] if kw else shapes_of(args))
            if kw:
                bounds.append(strided_k2_bound(args, kw, got))
        out[name] = {"launches": len(calls[name]), "max_abs_err": err,
                     "per_launch_ms": per,
                     "ms_all_launches": round(sum(per), 4),
                     "shapes": shapes}
        if bounds:
            out[name]["bound_ms_per_launch"] = [b for b, _ in bounds]
            out[name]["bound_by"] = sorted({by for _, by in bounds})
        log(f"{name} at S=2 per-shard shapes: {len(calls[name])} launches "
            f"equal to the plain version, {sum(per):.4f} ms in all; "
            f"{json.dumps(out[name])}")
    for name in strided_runs:
        shards = sorted({kw["shard"] for _, kw, _ in calls[name]})
        if shards != [0, 1]:
            raise SystemExit(f"{name}: strided K2 launched for shards "
                             f"{shards}, expected both of S = 2")
    return out


def mesh_phase(in_dir: str, k_in: str, card: str) -> tuple:
    """Phase 12 (the module docstring).  Returns ``(records, launches by
    kernel and path, per-shard kernel measurements)``."""
    t0 = time.perf_counter()
    records, launches_by = mesh_runs(in_dir, k_in, card)
    measured = mesh_kernel_measure(in_dir, k_in)
    by_kernel = {kernel: {path: launches[kernel]
                          for path, launches in launches_by.items()}
                 for kernel in kernel_launches()}
    wall = time.perf_counter() - t0
    log(f"mesh phase ({card}): {wall:.3f} s")
    log("mesh summary: " + json.dumps(records))
    return {"wall_s": wall, "runs": records}, by_kernel, measured


# Phase 13: one rank of a two-process ``--distributed`` world, serving
# one CLI run per request (the request's environment holds the env://
# variables and the run's knobs; null unsets a variable), with its
# launch counts set to 0 just before the run and read just after, and
# its peak device memory.
RANK_WORKER = """
import contextlib, io, json, os, sys, time
import torch
from fastapriori_tpu_torch import cli
from fastapriori_tpu_torch.ops.level_kernel import level_counts
from fastapriori_tpu_torch.ops.match_kernel import first_match
from fastapriori_tpu_torch.ops.vertical_kernel import vertical_counts
kernels = {"level_counts": level_counts, "first_match": first_match,
           "vertical_counts": vertical_counts}
for line in sys.stdin:
    req = json.loads(line)
    saved = dict(os.environ)
    for key, value in req["env"].items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    for fn in kernels.values():
        fn.launches = 0
    # This rank's card, cuda:(LOCAL_RANK mod visible), set up first.
    card = int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count()
    torch.zeros(1, device=f"cuda:{card}")
    torch.cuda.reset_peak_memory_stats(card)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(err):
        rc = cli.main(req["argv"])
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak = {card: torch.cuda.max_memory_allocated(card)}
    os.environ.clear()
    os.environ.update(saved)
    print("REPLY " + json.dumps({"rc": rc, "wall_s": wall,
                                 "launches": launches, "peak": peak,
                                 "stderr": err.getvalue()}), flush=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def world_phase(in_dir: str, k_in: str, card: str, cards: int = 1) -> tuple:
    """Phase 13 (the module docstring): each case through two rank
    workers of one ``--distributed`` world (gloo, both ranks on cuda:0;
    with ``cards`` > 1 NCCL, rank r on card r).  Returns ``({case:
    record}, {kernel: {path: launches summed over the ranks}})``."""
    t10 = {"freqItemset": FREQ_SHA256, "recommends": REC_SHA256}
    kos = {"freqItemset": KOSARAK["freq_sha256"],
           "recommends": KOSARAK["rec_sha256"]}
    backend = "nccl" if cards > 1 else "gloo"
    ranks = [CHILDREN[f"rank worker {r}"] for r in range(2)]
    t0 = time.perf_counter()
    records, launches_by = {}, {k: {} for k in kernel_launches()}
    for case, d, ms, digests, env, args in (
        ("t10i4d100k_world2", in_dir, MIN_SUPPORT, t10, {}, ()),
        ("t10i4d100k_fused_world2", in_dir, MIN_SUPPORT, t10, {},
         ("--engine", "fused")),
        ("kosarak_vertical_world2", k_in, KOSARAK["min_support"], kos,
         {"FA_MINE_ENGINE": "vertical"}, ()),
    ):
        port = str(free_port())
        outs = [os.path.join(WORK, f"out_{case}_rank{r}") for r in range(2)]
        for r, child in enumerate(ranks):
            shutil.rmtree(outs[r], ignore_errors=True)
            os.makedirs(outs[r])
            child.send({
                "env": {**{key: None for key in CLI_ENV}, **env,
                        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                        "RANK": str(r), "WORLD_SIZE": "2",
                        "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "2",
                        "FA_QUORUM_TIMEOUT_S": "60"},
                "argv": [d + "/", outs[r] + "/", "--min-support", ms,
                         "--metrics", "--distributed", *args]})
        replies = [child.reply(timeout=300) for child in ranks]
        rec = {"ranks": []}
        for r, rep in enumerate(replies):
            if rep["rc"] != 0:
                raise SystemExit(f"{case} rank {r}: exit {rep['rc']}: "
                                 f"{rep['stderr'][-3000:]}")
            walls, fields = phase_metrics(rep["stderr"])
            ev = fields.get("distributed", {})
            want_dev = f"cuda:{r if cards > 1 else 0}"
            if (ev.get("backend"), ev.get("world"), ev.get("rank"),
                    ev.get("device")) != (backend, 2, r, want_dev):
                raise SystemExit(f"{case} rank {r}: distributed event {ev}, "
                                 f"expected {backend} on {want_dev}")
            for phase in ("get freqItemsets", "get recommends"):
                if f"==== Total time for {phase}" not in rep["stderr"]:
                    raise SystemExit(f"{case} rank {r}: no '{phase}' line")
            ran = ("vertical_counts" if "vertical" in case else
                   "level_counts", "first_match")
            require_launches(f"{case} rank {r}", rep["launches"], fields,
                             ran=ran[1:] if "fused" in case else ran)
            peak = max(int(v) for v in rep["peak"].values())
            log(f"{case} rank {r} ({card}, {backend}): wall "
                f"{rep['wall_s']:.3f} s, peak device memory {peak} bytes, "
                f"launches {rep['launches']}")
            rec["ranks"].append({
                "wall_s": round(rep["wall_s"], 3), "peak_device_bytes": peak,
                "launches": rep["launches"],
                "walls_ms": {k: walls[k] for k in (
                    "get freqItemsets", "get recommends") if k in walls}})
            for k, n in rep["launches"].items():
                launches_by[k][f"{case}_rank{r}"] = n
        check_digests(case, outs[0], digests)
        if os.listdir(outs[1]):
            raise SystemExit(f"{case}: rank 1 wrote {os.listdir(outs[1])}")
        log(f"{case}: rank 1 wrote nothing")
        records[case] = rec
    wall = time.perf_counter() - t0
    log(f"world phase ({card}, {backend}, 2 ranks): {wall:.3f} s")
    log("world summary: " + json.dumps(records))
    return {"wall_s": wall, "backend": backend, "runs": records}, launches_by


# Phase 14's rank processes (:func:`quorum_phase`): per request the
# port's CLI with the request's environment (null unsets a variable;
# FA_FAILPOINTS re-read), its stderr to the request's log file, then one
# REPLY line with the exit code, wall, launches, peak device memory and
# the flight recorder's note kinds; an os._exit (a lost world) replies
# first.
QUORUM_WORKER = """
import contextlib, json, os, sys, time
import torch
from fastapriori_tpu_torch import cli
from fastapriori_tpu_torch.obs import flight
from fastapriori_tpu_torch.ops.level_kernel import level_counts
from fastapriori_tpu_torch.ops.match_kernel import first_match
from fastapriori_tpu_torch.ops.vertical_kernel import vertical_counts
from fastapriori_tpu_torch.reliability import failpoints, ledger
kernels = {"level_counts": level_counts, "first_match": first_match,
           "vertical_counts": vertical_counts}
torch.zeros(1, device="cuda:0")
state = {}
def reply(rc):
    print("REPLY " + json.dumps({
        "rc": rc, "wall_s": time.perf_counter() - state["t0"],
        "t_end": time.time(),
        "launches": {n: fn.launches for n, fn in kernels.items()},
        "peak": torch.cuda.max_memory_allocated(state["card"]),
        "notes": [e["kind"] for e in flight.snapshot()]}),
        file=sys.__stdout__, flush=True)
real_exit = os._exit
def exit_after_reply(code):
    sys.stderr.flush()
    reply(code)
    real_exit(code)
os._exit = exit_after_reply
for line in sys.stdin:
    req = json.loads(line)
    saved = dict(os.environ)
    for key, value in req["env"].items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    failpoints.reload_from_env()
    ledger.reset()
    for fn in kernels.values():
        fn.launches = 0
    # A world's rank r runs on card r mod the visible cards.
    state["card"] = (int(os.environ.get("LOCAL_RANK", "0"))
                     % torch.cuda.device_count())
    torch.cuda.set_device(state["card"])
    torch.cuda.reset_peak_memory_stats(state["card"])
    state["t0"] = time.perf_counter()
    with open(req["log"], "w") as err:
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(err):
            rc = cli.main(req["argv"])
    reply(rc)
    failpoints.disarm_all()
    os.environ.clear()
    os.environ.update(saved)
"""

QUORUM_WORKERS = ("quorum rank 0", "quorum rank 1", "quorum kill rank 0",
                  "quorum kill rank 1")


def start_quorum_workers() -> None:
    """Phase 14's rank processes: a pair for every case but the killed
    world, whose rank 0 ends with ``os._exit``, and that case's pair."""
    for name in QUORUM_WORKERS:
        CHILDREN[name] = Child(name, QUORUM_WORKER)


# Every phase-14 run: the CLI's knobs unset, a quorum bound of 5 s, a
# 100 ms heartbeat, retries without backoff.
QUORUM_ENV = {**{key: None for key in CLI_ENV}, "FA_FAILPOINTS": None,
              "FA_QUORUM_DIR": None, "FA_QUORUM_RANK": None,
              "FA_QUORUM_PROCS": None, "FA_EPOCH_RETRY_MAX": None,
              "MASTER_ADDR": None, "MASTER_PORT": None, "RANK": None,
              "WORLD_SIZE": None, "LOCAL_RANK": None,
              "LOCAL_WORLD_SIZE": None, "FA_QUORUM_TIMEOUT_S": "5",
              "FA_HEARTBEAT_MS": "100", "FA_RETRY_BACKOFF_MS": "0"}


def quorum_pair(case: str, in_dir: str, min_support: str, args=(),
                env=None, rank_env=None, world: bool = False,
                qdir=True, workers=("quorum rank 0", "quorum rank 1"),
                outs=None, resume_from=None) -> list:
    """One phase-14 run: two ranks of the CLI in ``workers``, a file
    domain under ``WORK/q14/<case>.q`` (``qdir``; a path reuses one), a
    gloo world on cuda:0 (``world``) or both.  Returns per rank ``{"rc",
    "wall_s", "t_end", "launches", "peak", "notes", "stderr", "fields",
    "walls", "out"}`` (``t_end``: the rank's end on the host's clock)."""
    base = os.path.join(WORK, "q14")
    if qdir is True:
        qdir = os.path.join(base, case + ".q")
        shutil.rmtree(qdir, ignore_errors=True)
    port = str(free_port())
    if outs is None:
        outs = [os.path.join(base, f"{case}_rank{r}") for r in range(2)]
        for out in outs:
            shutil.rmtree(out, ignore_errors=True)
            os.makedirs(out)
    for r, name in enumerate(workers):
        env_r = dict(QUORUM_ENV, **(env or {}))
        if qdir:
            env_r.update(FA_QUORUM_DIR=qdir, FA_QUORUM_RANK=str(r),
                         FA_QUORUM_PROCS="2")
        if world:
            env_r.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                         RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                         LOCAL_WORLD_SIZE="2")
        env_r.update((rank_env or {}).get(r, {}))
        argv = [in_dir + "/", outs[r] + "/", "--min-support", min_support,
                "--metrics", *(("--distributed",) if world else ()), *args]
        if resume_from:
            argv += ["--resume-from", resume_from + "/"]
        CHILDREN[name].send({"env": env_r, "argv": argv,
                             "log": os.path.join(base,
                                                 f"{case}_rank{r}.err")})
    ranks = []
    for r, name in enumerate(workers):
        rep = CHILDREN[name].reply(timeout=120)
        with open(os.path.join(base, f"{case}_rank{r}.err")) as f:
            rep["stderr"] = f.read()
        rep["walls"], rep["fields"] = phase_metrics("\n".join(
            ln for ln in rep["stderr"].splitlines()
            if not ln.startswith("{") or ln.startswith('{"event"')))
        rep["out"] = outs[r]
        ranks.append(rep)
    return ranks


def degraded_events(rep: dict, kind: str) -> list:
    """A rank's ledger events of ``kind`` (its ``degraded`` metrics
    lines)."""
    out = []
    for line in rep["stderr"].splitlines():
        if line.startswith('{"event": "degraded"'):
            ev = json.loads(line)
            if ev.get("kind") == kind:
                out.append(ev)
    return out


def quorum_event(case: str, rep: dict) -> dict:
    """The run's closing ``quorum`` metrics event (one per rank)."""
    evs = [json.loads(ln) for ln in rep["stderr"].splitlines()
           if ln.startswith('{"event": "quorum"')]
    if len(evs) != 1:
        raise SystemExit(f"{case}: {len(evs)} quorum events")
    return evs[0]


def mixed_launches(fields: dict) -> dict:
    """K1, K3 and K2 launches as the run's events count them, each
    level event by its own engine (a vertical mine clamped to the bitmap
    layout counts both)."""
    k1 = k3 = 0
    for key, v in fields.items():
        if key.startswith("level k=") and not v.get("plain_kernels"):
            if v.get("engine") == "vertical":
                k3 += v.get("launches", 0)
            else:
                k1 += v.get("launches", 0)
    fm = fields.get("first_match", {})
    return {"level_counts": k1, "vertical_counts": k3,
            "first_match": fm.get("launches", 0) if fm.get("device") else 0}


def require_clamped_launches(name: str, got: dict, fields: dict,
                             failed_level: bool) -> None:
    """A vertical mine that went on in the bitmap layout: K3 and then K1
    launched, each as often as the run's level events say; with
    ``failed_level`` the level whose fetch gave up launched K3 before
    it did, and its event ended without its launches."""
    want = mixed_launches(fields)
    exact = got == want if not failed_level else (
        got["level_counts"] == want["level_counts"]
        and got["first_match"] == want["first_match"]
        and got["vertical_counts"] > want["vertical_counts"])
    if not exact or got["vertical_counts"] < 1 or got["level_counts"] < 1:
        raise SystemExit(f"{name}: launches {got}, events {want}")
    log(f"{name}: launches {got}, events {want}")


def quorum_line(case: str, ranks: list, card: str, extra: str = "") -> dict:
    """One line per case: each rank's wall, peak device memory, launches
    and exit code, with the mesh epoch and fence its quorum event gave."""
    rec = {"ranks": []}
    parts = []
    for r, rep in enumerate(ranks):
        q = [json.loads(ln) for ln in rep["stderr"].splitlines()
             if ln.startswith('{"event": "quorum"')]
        q = q[0] if q else {}
        row = {"rc": rep["rc"], "wall_s": round(rep["wall_s"], 3),
               "peak_device_bytes": rep["peak"],
               "launches": rep["launches"],
               "mesh_epoch": q.get("mesh_epoch"), "fence": q.get("fence")}
        rec["ranks"].append(row)
        parts.append(f"rank {r}: rc {row['rc']}, wall {row['wall_s']:.3f} s, "
                     f"peak device memory {row['peak_device_bytes']} bytes, "
                     f"launches {row['launches']}, mesh epoch "
                     f"{row['mesh_epoch']}, fence {row['fence']}")
    log(f"quorum {case} ({card}): " + "; ".join(parts) + extra)
    return rec


def quorum_phase(in_dir: str, k_in: str, card: str,
                 main_fields: dict, cards: int = 1) -> tuple:
    """Phase 14 (the module docstring): the quorum domain, two ranks on
    cuda:0; with ``cards`` > 1 only the torch-transport cases (a) and
    (b), a world over NCCL with rank r on card r.  Returns ``({case:
    record}, {kernel: {case_rank: launches}})``."""
    t10 = {"freqItemset": FREQ_SHA256, "recommends": REC_SHA256}
    kos = {"freqItemset": KOSARAK["freq_sha256"],
           "recommends": KOSARAK["rec_sha256"]}
    t0 = time.perf_counter()
    records, launches_by = {}, {k: {} for k in kernel_launches()}

    def note(case, ranks):
        for r, rep in enumerate(ranks):
            for k, n in rep["launches"].items():
                launches_by[k][f"{case}_rank{r}"] = n

    def ok(case, ranks, digests=None, writers=(0,)):
        for r, rep in enumerate(ranks):
            if rep["rc"] != 0:
                raise SystemExit(f"{case} rank {r}: exit {rep['rc']}: "
                                 f"{rep['stderr'][-3000:]}")
        for r in writers:
            check_digests(f"{case} rank {r}", ranks[r]["out"], digests)

    # (a) A world over the torch transport, zero flags.
    case = "a_world_torch"
    ranks = quorum_pair(case, in_dir, MIN_SUPPORT, world=True, qdir=False)
    ok(case, ranks, t10)
    for r, rep in enumerate(ranks):
        q = quorum_event(case, rep)
        sites = [e["site"] for e in q["epoch_trail"]]
        if q["transport"] != "torch" or sites != [
                "run.start", "mine.end", "rules.start", "run.end"]:
            raise SystemExit(f"{case} rank {r}: quorum event {q}")
        ev = rep["fields"].get("distributed", {})
        want = ("nccl", f"cuda:{r}") if cards > 1 else ("gloo", "cuda:0")
        if (ev.get("backend"), ev.get("device")) != want:
            raise SystemExit(f"{case} rank {r}: distributed event {ev}, "
                             f"expected {want}")
        require_launches(f"{case} rank {r}", rep["launches"], rep["fields"],
                         ran=("level_counts", "first_match"))
    if os.listdir(ranks[1]["out"]):
        raise SystemExit(f"{case}: rank 1 wrote {os.listdir(ranks[1]['out'])}")
    note(case, ranks)
    records[case] = quorum_line(case, ranks, card,
                                "; epoch trail run.start, mine.end, "
                                "rules.start, run.end on both ranks")

    # (b) The same world fenced: a file domain and per-level checkpoints,
    # then rank 1 killed at a middle checkpointed level, then a resume at
    # world 2 from rank 0's checkpoint.
    import numpy as np

    case = "b_world_fenced"
    ck = ("--checkpoint-every-level",)
    ranks = quorum_pair(case, in_dir, MIN_SUPPORT, ck, world=True)
    ok(case, ranks, t10)
    out0 = ranks[0]["out"] + "/"
    with np.load(out0 + "checkpoint.npz") as z:
        meta_fence = int(z["meta"][4])
    with open(out0 + "MANIFEST.json") as f:
        man_fence = json.load(f).get("fence")
    if meta_fence < 1 or meta_fence != man_fence:
        raise SystemExit(f"{case}: checkpoint fence {meta_fence}, manifest "
                         f"fence {man_fence}")
    for r, rep in enumerate(ranks):
        require_launches(f"{case} rank {r}", rep["launches"], rep["fields"],
                         ran=("level_counts", "first_match"))
    ks = checkpoint_ks(ranks[0]["fields"])
    k_kill = 5 if 5 in ks[1:-1] else ks[len(ks) // 2]
    note(case, ranks)
    records[case] = quorum_line(case, ranks, card,
                                f"; checkpoint meta fence {meta_fence} = "
                                f"manifest fence {man_fence}, levels {ks}")

    case = "b_world_kill"
    qk = os.path.join(WORK, "q14", case + ".q")
    shutil.rmtree(qk, ignore_errors=True)
    ranks = quorum_pair(case, in_dir, MIN_SUPPORT, ck, world=True, qdir=qk,
                        workers=QUORUM_WORKERS[2:],
                        rank_env={1: {"FA_FAILPOINTS":
                                      f"level.{k_kill}:abort"}})
    r0, r1 = ranks
    lag = r0["t_end"] - r1["t_end"]
    if r1["rc"] != 1 or f"level.{k_kill}" not in r1["stderr"]:
        raise SystemExit(f"{case} rank 1: exit {r1['rc']}: "
                         f"{r1['stderr'][-2000:]}")
    if (r0["rc"] != 3 or "quorum peer rank 1 lost" not in r0["stderr"]
            or lag > 3 * 5):
        raise SystemExit(f"{case} rank 0: exit {r0['rc']} {lag:.3f} s after "
                         f"rank 1: {r0['stderr'][-2000:]}")
    killed0 = r0["out"]
    with np.load(killed0 + "/checkpoint.npz") as z:
        got_ks = [2 + i for i in range(int(z["meta"][0]))]
        kill_fence = int(z["meta"][4])
    if got_ks[-1] != k_kill or kill_fence < 1:
        raise SystemExit(f"{case}: checkpoint levels {got_ks}, fence "
                         f"{kill_fence}")
    note(case, ranks)
    records[case] = quorum_line(
        case, ranks, card, f"; rank 1 aborted at level.{k_kill}, rank 0 "
        f"exit 3 naming rank 1 {lag:.3f} s later (bound 15 s)")

    case = "b_world_resume"
    for name in os.listdir(qk):
        if name != "FENCE":
            os.unlink(os.path.join(qk, name))
    ranks = quorum_pair(case, in_dir, MIN_SUPPORT, world=True, qdir=qk,
                        resume_from=killed0)
    ok(case, ranks, t10)
    for r, rep in enumerate(ranks):
        require_resumed(f"{case} rank {r}", rep["fields"], rep["launches"],
                        k_kill, ran=("first_match",))
    with open(ranks[0]["out"] + "/MANIFEST.json") as f:
        res_fence = json.load(f).get("fence")
    if res_fence != kill_fence + 1:
        raise SystemExit(f"{case}: resumed manifest fence {res_fence}, "
                         f"checkpoint fence {kill_fence}")
    note(case, ranks)
    records[case] = quorum_line(case, ranks, card,
                                f"; level_resume from k = {k_kill + 1}, "
                                f"manifest fence {res_fence}")
    if cards > 1:
        return quorum_done(t0, card, records, launches_by, cards)

    # (c) A file domain of two one-process ranks, lockstep degradation.
    case = "c_file_fused_lockstep"
    ranks = quorum_pair(case, in_dir, MIN_SUPPORT, ("--engine", "fused"),
                        rank_env={1: {"FA_FAILPOINTS": "fetch.fused:oom*3"}})
    ok(case, ranks, t10, writers=(0, 1))
    adopt = [e for e in degraded_events(ranks[0], "quorum_adopt")
             if e["chain"] == "engine"]
    walked = [e for e in degraded_events(ranks[1], "cascade")
              if e["chain"] == "engine"
              and e["reason"] == "transient_exhausted"]
    if not adopt or adopt[0]["rank"] != 1 or not walked:
        raise SystemExit(f"{case}: rank 0 adoptions {adopt}, rank 1 walks "
                         f"{walked}")
    for r, rep in enumerate(ranks):
        require_launches(f"{case} rank {r}", rep["launches"], rep["fields"],
                         ran=("first_match",) if r == 0
                         else ("level_counts", "first_match"))
    note(case, ranks)
    records[case] = quorum_line(case, ranks, card,
                                f"; rank 0 adopted engine -> "
                                f"{adopt[0]['to']} from rank 1 at "
                                f"{adopt[0]['site']}")

    # Rank 1 is held 1.5 s after its level 2, so rank 0 launches K3 at
    # level 3 first; rank 0 is held 3 s after its level 3, so rank 1's
    # walk is there for rank 0's level.3 sync to adopt.
    case = "c_file_vertical_clamp"
    ranks = quorum_pair(
        case, k_in, KOSARAK["min_support"],
        env={"FA_MINE_ENGINE": "vertical"},
        rank_env={0: {"FA_FAILPOINTS": "level.3:delay@3000"},
                  1: {"FA_FAILPOINTS": "level.2:delay@1500,"
                                       "fetch.vlevel_bits:oom*3"}})
    ok(case, ranks, kos, writers=(0, 1))
    clamp = [e for e in degraded_events(ranks[0], "mine_engine_fallback")
             if e.get("reason") == "quorum" and "k" in e]
    if not clamp:
        raise SystemExit(f"{case}: rank 0 took no level-boundary clamp: "
                         f"{ranks[0]['stderr'][-3000:]}")
    for r, rep in enumerate(ranks):
        require_clamped_launches(f"{case} rank {r}", rep["launches"],
                                 rep["fields"], failed_level=r == 1)
    note(case, ranks)
    records[case] = quorum_line(case, ranks, card,
                                f"; rank 0 clamped vertical -> bitmap at "
                                f"k = {clamp[0]['k']}")

    # (d) Elastic continuation: rank 1 killed at level.5; rank 0, held 4 s
    # at level.6 (past the 2 s bound even if rank 1 dies up to 2 s
    # later), finds the loss there.
    case = "d_file_elastic"
    ranks = quorum_pair(
        case, in_dir, MIN_SUPPORT,
        env={"FA_EPOCH_RETRY_MAX": "1", "FA_QUORUM_TIMEOUT_S": "2"},
        rank_env={0: {"FA_FAILPOINTS": "level.6:delay@4000"},
                  1: {"FA_FAILPOINTS": "level.5:abort"}})
    r0, r1 = ranks
    if r1["rc"] != 1 or "level.5" not in r1["stderr"]:
        raise SystemExit(f"{case} rank 1: exit {r1['rc']}: "
                         f"{r1['stderr'][-2000:]}")
    ok(case, ranks[:1], t10)
    q = quorum_event(case, r0)
    if (q["mesh_epoch"], q["members"]) != (1, [0]) or (
            "mesh_epoch_reseed" not in r0["notes"]):
        raise SystemExit(f"{case} rank 0: quorum {q}, notes {r0['notes']}")
    require_launches(f"{case} rank 0", r0["launches"], r0["fields"],
                     ran=("level_counts", "first_match"))
    note(case, ranks)
    records[case] = quorum_line(
        case, ranks, card, "; rank 0 finished alone at mesh epoch 1, "
        "flight note mesh_epoch_reseed from k = "
        f"{r0['fields'].get('level_resume', {}).get('from_k')}")

    case = "d_file_exhaust"
    ranks = quorum_pair(
        case, in_dir, MIN_SUPPORT, env={"FA_EPOCH_RETRY_MAX": "0"},
        rank_env={1: {"FA_FAILPOINTS": "level.5:abort"}})
    r0, r1 = ranks
    if r1["rc"] != 1 or r0["rc"] != 3 or (
            "quorum peer rank 1 lost" not in r0["stderr"]):
        raise SystemExit(f"{case}: exits {r0['rc']}, {r1['rc']}: "
                         f"{r0['stderr'][-2000:]}")
    note(case, ranks)
    records[case] = quorum_line(case, ranks, card,
                                "; rank 0 exit 3 naming rank 1")
    return quorum_done(t0, card, records, launches_by)


def quorum_done(t0: float, card: str, records: dict, launches_by: dict,
                cards: int = 1) -> tuple:
    wall = time.perf_counter() - t0
    where = ("rank r on card r over NCCL" if cards > 1
             else "2 ranks on cuda:0")
    log(f"quorum phase ({card}, {where}): {wall:.3f} s")
    log("quorum summary: " + json.dumps(records))
    return {"wall_s": wall, "cases": records,
            "backend": "nccl" if cards > 1 else "gloo"}, launches_by


def movielens_phase(device, card: str) -> tuple:
    """Phase 15 (the module docstring): the object-form library API at
    the MovieLens shape.  Returns ``(walls and facts, launches, K1
    replayed, K2 replayed)``."""
    import torch

    from fastapriori_tpu_torch import AssociationRules, FastApriori
    from fastapriori_tpu_torch.io.reader import read_dat
    from fastapriori_tpu_torch.io.writer import (
        save_freq_itemsets,
        save_recommends,
    )
    from fastapriori_tpu_torch.preprocess import dedup_user_baskets

    spec = MOVIELENS
    gen = CHILDREN["prep"].reply(timeout=600)
    for name in ("d_sha256", "u_sha256"):
        if gen[name] != spec[name]:
            raise SystemExit(f"movielens: {name} {gen[name]} != the JAX "
                             f"generator's {spec[name]}")
    log(f"movielens corpus (prep child): {gen['wall_s']:.3f} s, D.dat and "
        f"U.dat equal the JAX generators' files")
    d_path = os.path.join(MOVIELENS_DIR, "D.dat")
    out_dir = os.path.join(WORK, "mlout")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels = zero_launches()
    t0 = time.perf_counter()
    miner = FastApriori(float(spec["min_support"]))
    # The level matrices and the ingest under run_file, kept for the
    # kernels' replay (run_file is run_file_raw, then _decode_levels).
    kept = {}
    run_file_raw = miner.run_file_raw

    def keep(path):
        kept["levels"], kept["data"] = run_file_raw(path)
        return kept["levels"], kept["data"]

    miner.run_file_raw = keep
    itemsets, item_to_rank, freq_items = miner.run_file(d_path)
    t_mine = time.perf_counter()
    rec = AssociationRules(itemsets, freq_items, item_to_rank)
    rec.rule_arrays()
    t_rules = time.perf_counter()
    u_lines = read_dat(os.path.join(MOVIELENS_DIR, "U.dat"))
    recs = rec.run(u_lines, use_device=True)
    t_scan = time.perf_counter()
    save_freq_itemsets(out_dir + "/", itemsets, freq_items)
    save_recommends(out_dir + "/", recs)
    t_end = time.perf_counter()
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated(device)
    check_digests("movielens", out_dir, {
        "freqItemset": spec["freq_sha256"],
        "recommends": spec["rec_sha256"]})
    walls, fields = phase_metrics("\n".join(
        json.dumps(r) for r in miner.metrics.records + rec.metrics.records))
    require_launches("movielens", launches, fields,
                     ran=("level_counts", "first_match"))
    levels, data = kept["levels"], kept["data"]
    n_levels = len(levels)
    out = {
        "generate_s": gen["wall_s"], "mine_s": t_mine - t0,
        "decode_ms": walls.get("decode"), "rules_s": t_rules - t_mine, "scan_s": t_scan - t_rules,
        "write_s": t_end - t_scan, "wall_s": t_end - t0,
        "f": data.num_items, "levels": n_levels, "k_max": n_levels + 1,
        "itemsets": len(itemsets), "rules": rec.n_rules,
        "users": len(u_lines),
        "distinct_baskets": fields.get("user_dedup", {}).get("distinct"),
        "peak_device_bytes": peak, "launches": launches,
        "engine": fields.get("engine_auto", {}).get("choice"),
        "tail_fuse": [v.get("k0") for k, v in fields.items()
                      if k.startswith("tail_fuse")],
    }
    log(f"movielens API ({card}): F = {out['f']}, levels 2..{n_levels + 1}, "
        f"{out['itemsets']} itemsets, {out['rules']} rules, "
        f"{out['distinct_baskets']} distinct baskets of {out['users']}; "
        f"walls: generation {out['generate_s']:.3f} s, mine "
        f"{out['mine_s']:.3f} s (decode {out['decode_ms']} ms), rules "
        f"{out['rules_s']:.3f} s, scan {out['scan_s']:.3f} s, writes "
        f"{out['write_s']:.3f} s; peak device memory {peak} bytes; "
        f"launches {launches}; the JAX digests")
    # One launch of each kernel replayed against its plain version: K1's
    # launches at the run's own shapes (the same ingest and levels), K2
    # at the object-form table's scan block.
    k1 = k1_measure(miner.config, data, levels, device, fields)
    require_replayed("K1 movielens", k1, launches["level_counts"])
    baskets, _, _ = dedup_user_baskets(u_lines, item_to_rank)
    k2 = k2_replay("movielens", rec, baskets, device)
    del miner, rec, itemsets, kept, levels, data
    return out, launches, k1, k2


def require_replayed(name: str, measured: dict, counted: int) -> None:
    """Phase 5's replay of a path must launch a kernel as often as the
    counted CLI run did, or its per-launch times are not the path's."""
    n = len(measured["per_launch_ms"])
    if n != counted:
        raise SystemExit(f"{name}: the replay made {n} launches, the "
                         f"counted run {counted}")


# The children started at once (:func:`start_children`), by name.
CHILDREN: dict = {}


def start_children() -> None:
    """Start every child process of the run before anything else: the
    prep child (:data:`PREP`), the fresh processes of the cold
    measurements (phases 6 and 8), which touch CUDA only once handed
    their arguments, and phase 9's kill worker."""
    CHILDREN["prep"] = Child("prep", PREP)
    for name, _ in ENGINES_COMPARED:
        CHILDREN[f"cold mine {name}"] = Child(f"cold mine {name}",
                                              COLD_MINE)
    for name in ("t10i4d100k", "kosarak_vertical",
                 f"t10i4d100k_{BIG_MIN_SUPPORT}"):
        CHILDREN[f"cold rules {name}"] = Child(f"cold rules {name}",
                                               COLD_RULES)
    CHILDREN["kill worker"] = Child("kill worker", KILL_WORKER)
    start_rank_workers()


def start_rank_workers() -> None:
    """Phase 13's two rank workers (:data:`RANK_WORKER`)."""
    for r in range(2):
        CHILDREN[f"rank worker {r}"] = Child(f"rank worker {r}", RANK_WORKER)


def main() -> int:
    args = sys.argv[1:]
    if args and (len(args) != 2 or args[0] != "--cards"
                 or not args[1].isdigit() or int(args[1]) < 2):
        print("usage: chip_smoke.py [--cards N], N >= 2", file=sys.stderr)
        return 2
    cards = int(args[1]) if args else 1
    try:
        # Where nvidia-smi says a card may be there, the children start
        # first: their start-up then overlaps this process's own import
        # of torch and leaves the build alone.
        if shutil.which("nvidia-smi"):
            if cards > 1:
                CHILDREN["prep"] = Child("prep", PREP)
                start_rank_workers()
                start_quorum_workers()
            else:
                start_children()
        import torch

        t_start = time.perf_counter()
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (torch.cuda.is_available() "
                  "is false)", file=sys.stderr)
            return 1
        return run(t_start) if cards == 1 else run_cards(t_start, cards)
    finally:
        Child.stop_all()
        for box in PROC_HOST_BOXES:
            for t in box.get("threads", ()):
                t.join(200.0)
            for i in range(2):
                proc = getattr(box.get(i), "proc", None)
                if proc is not None and proc.poll() is None:
                    proc.kill()
                if proc is not None:
                    proc.wait()


def serving_models(in_dir: str, device) -> tuple:
    """Phase 11 (a)'s and (c)'s models for ``--cards N``, which runs no
    serve CLI: T10 at ``MIN_SUPPORT`` and at ``BIG_MIN_SUPPORT`` mined
    and saved as ``serving.npz`` prefixes."""
    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.serve import ServingState

    out = []
    for name, ms in (("out_serve", MIN_SUPPORT),
                     ("out_serve_big", BIG_MIN_SUPPORT)):
        prefix = os.path.join(WORK, name) + "/"
        shutil.rmtree(prefix, ignore_errors=True)
        state = ServingState.from_mine(
            os.path.join(in_dir, "D.dat"),
            MinerConfig(min_support=float(ms)), device=device)
        state.save(prefix)
        state.release()
        out.append(prefix)
    return tuple(out)


def run_cards(t_start: float, cards: int) -> int:
    """``--cards N`` (the module docstring): phases 1, 2, 12 and 13, the
    mesh's shards and the world's ranks spread over N cards, then phase
    11 (h) with worker i on card i and phase 14's torch-transport cases
    over NCCL, rank r on card r."""
    import torch

    from fastapriori_tpu_torch.ops import build

    global MESH_CARDS
    if torch.cuda.device_count() < cards:
        raise SystemExit(f"--cards {cards}: {torch.cuda.device_count()} "
                         f"cards visible")
    MESH_CARDS = cards
    if not CHILDREN:
        CHILDREN["prep"] = Child("prep", PREP)
    card = card_line()
    log(f"card: {card} (x{cards})")
    t0 = time.perf_counter()
    report = build.build()
    log(f"build: {time.perf_counter() - t0:.3f} s {json.dumps(report)}")
    # From cuda:0, so each wrapper makes its tensors' card current.
    for i in range(cards):
        quick_checks(torch.device("cuda", i))
    log(f"quick checks on {cards} cards: the three kernels equal their "
        f"plain versions")
    (_, in_dir, _, _), (_, k_in, _, _) = corpora()
    log(f"datagen in the prep child (s): "
        f"{json.dumps(CHILDREN['prep'].reply())}")
    mesh, mesh_launches, mesh_measured = mesh_phase(in_dir, k_in, card)
    log(f"mesh per-shard kernels over {cards} cards: "
        f"{json.dumps(mesh_measured)}")
    if "rank worker 0" not in CHILDREN:
        start_rank_workers()
    if "quorum rank 0" not in CHILDREN:
        start_quorum_workers()
    model, big = serving_models(in_dir, torch.device("cuda", 0))
    box = start_proc_hosts(model, cards)
    world, world_launches = world_phase(in_dir, k_in, card, cards)
    proc, proc_launches = proc_host_run(box, model, big, in_dir,
                                        torch.device("cuda", 0), card, cards)
    quorum, quorum_launches = quorum_phase(in_dir, k_in, card, {}, cards)
    log(f"chip_smoke wall: {time.perf_counter() - t_start:.3f} s after "
        f"torch's import")
    print(json.dumps({"mesh_cards": cards, "mesh": mesh, "world": world,
                      "proc_host": proc, "quorum": quorum,
                      "launches_by_path": mesh_launches,
                      "world_launches_by_path": world_launches,
                      "proc_host_launches_by_path": proc_launches,
                      "quorum_launches_by_path": quorum_launches}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def run(t_start: float) -> int:
    """Phases 1-14 (the module docstring); returns 0 when all passed."""
    import torch

    from fastapriori_tpu_torch.ops import build

    if not CHILDREN:
        start_children()
    prep = CHILDREN["prep"]
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"host: {host_line()}")
    clock = sm_clock_mhz()
    log(f"max SM clock: {clock:.0f} MHz")
    t0 = time.perf_counter()
    report = build.build()
    log(f"build: {time.perf_counter() - t0:.3f} s {json.dumps(report)}")
    quick_checks(device)
    log("quick checks: the three kernels equal their plain versions")

    (_, in_dir, _, _), (_, k_in, _, _) = corpora()
    out_dir = os.path.join(WORK, "out")
    log(f"datagen in the prep child (s): {json.dumps(prep.reply())}")
    python_ingest = prep.reply()
    digests = {"freqItemset": FREQ_SHA256, "recommends": REC_SHA256}
    main_launches, main_fields = cli_path(
        "main path", in_dir, out_dir, MIN_SUPPORT, digests)
    require_launches("main path", main_launches, main_fields,
                     ran=("level_counts", "first_match"))
    require_auto_main(main_fields)
    require_rule_engine("main path", main_fields, device=False)
    rules_launches, rules_fields = cli_path(
        "device rules path", in_dir, os.path.join(WORK, "out_rules"),
        MIN_SUPPORT, digests, env={"FA_RULE_ENGINE": "device"})
    require_launches("device rules path", rules_launches, rules_fields,
                     ran=("level_counts", "first_match"))
    require_rule_engine("device rules path", rules_fields, device=True)
    fused_launches, fused_fields = cli_path(
        "fused path", in_dir, os.path.join(WORK, "out_fused"), MIN_SUPPORT,
        digests, extra_args=("--engine", "fused"))
    require_launches("fused path", fused_launches, fused_fields,
                     ran=("first_match",))
    require_fused_path(fused_fields)
    require_rule_engine("fused path", fused_fields, device=False)

    k_out = os.path.join(WORK, "kout")
    vert_launches, vert_fields = cli_path(
        "vertical path", k_in, k_out, KOSARAK["min_support"],
        {"freqItemset": KOSARAK["freq_sha256"],
         "recommends": KOSARAK["rec_sha256"]},
        env={"FA_MINE_ENGINE": "vertical"})
    require_launches("vertical path", vert_launches, vert_fields,
                     ran=("vertical_counts", "first_match"))
    require_rule_engine("vertical path", vert_fields, device=False)
    vrules_launches, vrules_fields = cli_path(
        "vertical device rules path", k_in, os.path.join(WORK, "kout_rules"),
        KOSARAK["min_support"],
        {"freqItemset": KOSARAK["freq_sha256"],
         "recommends": KOSARAK["rec_sha256"]},
        env={"FA_MINE_ENGINE": "vertical", "FA_RULE_ENGINE": "device"})
    require_launches("vertical device rules path", vrules_launches,
                     vrules_fields, ran=("vertical_counts", "first_match"))
    require_rule_engine("vertical device rules path", vrules_fields,
                        device=True)
    reliability = reliability_phases(in_dir, k_in, main_fields, vert_fields)
    observability = observability_phase(in_dir, k_in, card)
    serving, serving_launches, serve_k2 = serving_phase(
        in_dir, device, card, main_launches)
    # Phase 14's rank processes start now: their start-up overlaps
    # phases 12 and 13.
    start_quorum_workers()
    mesh, mesh_launches, mesh_measured = mesh_phase(in_dir, k_in, card)
    world, world_launches = world_phase(in_dir, k_in, card)
    quorum, quorum_launches = quorum_phase(in_dir, k_in, card, main_fields)
    movielens, ml_launches, ml_k1, ml_k2 = movielens_phase(device, card)
    for name, path, _, min_support in corpora():
        ingest_compare(name, path, min_support, python_ingest[name])

    capture_compare(in_dir, device, MIN_SUPPORT)

    cfg, data, levels, api_k1, api_fields = level_api_path(
        in_dir, device, MIN_SUPPORT)
    compared = fused_compare(in_dir, device, MIN_SUPPORT, card, cfg, data,
                             levels)
    k1 = k1_measure(cfg, data, levels, device, main_fields)
    require_replayed("K1 main path", k1, main_launches["level_counts"])
    if api_k1 != main_launches["level_counts"]:
        raise SystemExit(f"K1: the level API path launched {api_k1} times, "
                         f"the main path {main_launches['level_counts']}")
    k2 = k2_measure("t10i4d100k", in_dir, data, levels, device)
    require_replayed("K2 main path", k2, main_launches["first_match"])
    built = {"t10i4d100k": rule_compare("t10i4d100k", in_dir, MIN_SUPPORT,
                                        {}, data, levels, device)}
    del cfg, data, levels
    kcfg, kdata, klevels, _ = mine(k_in, device, KOSARAK["min_support"],
                                   "vertical")
    k2v = k2_measure("kosarak_vertical", k_in, kdata, klevels, device)
    require_replayed("K2 vertical path", k2v, vert_launches["first_match"])
    built["kosarak_vertical"] = rule_compare(
        "kosarak_vertical", k_in, KOSARAK["min_support"],
        {"mine_engine": "vertical"}, kdata, klevels, device)
    k3 = k3_measure(kcfg, kdata, klevels, device, clock)
    require_replayed("K3 vertical path", k3, vert_launches["vertical_counts"])
    del kcfg, kdata, klevels

    # Phase 8: a lattice above the auto floor, where auto itself takes
    # the device rule engine.
    _, bdata, blevels, _ = mine(in_dir, device, BIG_MIN_SUPPORT)
    big = f"t10i4d100k_{BIG_MIN_SUPPORT}"
    built[big] = rule_compare(big, in_dir, BIG_MIN_SUPPORT, {}, bdata,
                              blevels, device, reps=1)
    if built[big]["raw_rules"] < 1 << 21:
        raise SystemExit(f"{big}: {built[big]['raw_rules']} raw rules, "
                         f"below 2^21")
    del bdata, blevels

    def by_path(name):
        return {"t10i4d100k": main_launches[name],
                "t10i4d100k_device_rules_cli": rules_launches[name],
                "t10i4d100k_fused_cli": fused_launches[name],
                "t10i4d100k_level_api": api_k1 if name == "level_counts"
                else 0,
                "kosarak_vertical": vert_launches[name],
                "kosarak_vertical_device_rules_cli": vrules_launches[name],
                **serving_launches.get(name, {}),
                **mesh_launches.get(name, {}),
                **world_launches.get(name, {}),
                **quorum_launches.get(name, {}),
                "movielens_api": ml_launches[name]}

    # Top-level numbers: the first path in "measured_by_path".
    kernels = [
        {"name": "level_counts", "route": "cuda",
         "source": "fastapriori_tpu_torch/csrc/level_counts.cu",
         "replaces": "fastapriori_tpu/ops/pallas_level.py:57",
         "launches": main_launches["level_counts"], "path": "t10i4d100k",
         "launches_by_path": by_path("level_counts"), **k1,
         "measured_by_path": {
             "t10i4d100k": k1,
             "t10i4d100k_mesh_s2_api": mesh_measured["level_counts"],
             "movielens_api": ml_k1}},
        {"name": "first_match", "route": "cuda",
         "source": "fastapriori_tpu_torch/csrc/first_match.cu",
         "replaces": "fastapriori_tpu/ops/pallas_vertical.py:210",
         "launches": main_launches["first_match"], "path": "t10i4d100k",
         "launches_by_path": by_path("first_match"), **k2,
         "measured_by_path": {"t10i4d100k": k2, "kosarak_vertical": k2v,
                              "movielens_api": ml_k2,
                              "t10i4d100k_serving_block": serve_k2,
                              "t10i4d100k_mesh_s2_api":
                                  mesh_measured["first_match"],
                              "t10i4d100k_mesh_s2_strided_api":
                                  mesh_measured["first_match_strided"],
                              f"t10i4d100k_{BIG_MIN_SUPPORT}_mesh_s2_"
                              "strided_api":
                                  mesh_measured["first_match_strided_big"]},
         "device_built_table": {
             path: {key: m[key] for key in (
                 "ms", "device_ms", "max_abs_err", "table_rows", "k",
                 "raw_rules", "survivors")}
             for path, m in built.items()}},
        {"name": "vertical_counts", "route": "cuda",
         "source": "fastapriori_tpu_torch/csrc/vertical_counts.cu",
         "replaces": "fastapriori_tpu/ops/pallas_vertical.py:88",
         "launches": vert_launches["vertical_counts"],
         "path": "kosarak_vertical",
         "launches_by_path": by_path("vertical_counts"), **k3,
         "measured_by_path": {
             "kosarak_vertical": k3,
             "kosarak_vertical_mesh_s2_api":
                 mesh_measured["vertical_counts"]}},
    ]
    log(f"fused compare summary: {json.dumps(compared)}")
    log("rule crossover summary: " + json.dumps(
        {path: m["rule_crossover"] for path, m in built.items()}))
    log("reliability walls: " + json.dumps(reliability))
    log("observability walls: " + json.dumps(observability))
    log("serving walls: " + json.dumps(serving))
    log("mesh walls: " + json.dumps(mesh))
    log("world walls: " + json.dumps(world))
    log("quorum walls: " + json.dumps(quorum))
    log("movielens walls: " + json.dumps(movielens))
    log(f"chip_smoke wall: {time.perf_counter() - t_start:.3f} s after "
        f"torch's import, {time.perf_counter() - T_START:.3f} s from the "
        f"script's start")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
