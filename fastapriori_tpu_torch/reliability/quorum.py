"""The multi-process fault domain: cascade consensus, peer-death
detection, fenced checkpoints and elastic continuation (counterpart:
fastapriori_tpu/reliability/quorum.py, with its semantics, its wire
vector and its on-disk files).

A walk down a chain that shapes the mesh's collectives (engine fused ->
level, mine_engine vertical -> bitmap, count_reduce sparse -> dense,
rule_engine, exchange hier -> flat) is decided by one process: one
rank's fetch used up its retries.  If its peers did not walk too, the
ranks would issue collectives of different shapes or counts and the
mesh would hang.  This module makes that impossible:

**Cascade consensus.**  reliability/watchdog.py ``downgrade`` proposes
every local walk of a chain in :data:`CONSENSUS_CHAINS` here the moment
it happens, and every sync point (mine start, level boundaries, rule
start, run start and end) exchanges the small position vector: every
rank adopts the most degraded position, recorded as ``quorum_adopt``
(with the originating rank) and as a ``cascade`` event with reason
``quorum``.  Positions only move forward, like the cascade.

**Peer death.**  Every exchange and rendezvous waits at most
``FA_QUORUM_TIMEOUT_S``, under the bounded retry of reliability/retry.py
(site ``quorum.<site>``), and a file transport's ranks publish a
heartbeat every ``FA_HEARTBEAT_MS``: a dead or wedged peer becomes a
:class:`PeerLost` naming its rank, never a hang.

**Divergence.**  A domain built with ``consensus=False`` models the raw
mesh: a rendezvous compares each rank's digest of its positions and
raises :class:`MeshDivergence` when they differ.

**Fenced checkpoints.**  The domain owns a monotonic fence epoch
(``<dir>/FENCE``, incremented under an exclusive lock).  The writer (the
lowest surviving rank) acquires one per run and stamps it into the
checkpoint meta and ``MANIFEST.json``; a writer whose fence was
superseded is refused at commit and a stale artifact is refused at
resume (:class:`StaleFenceError`).

**Elastic continuation.**  With ``FA_EPOCH_RETRY_MAX`` > 0 a file
domain absorbs a lost peer: the survivors abort the level in flight,
meet again under the next mesh epoch without the dead ranks, re-derive
the fence, and the level loop goes on from its last complete level
(models/apriori.py).

**Transports.**  No domain in one process: every hook is one memoized
read.  :class:`FileTransport` (``FA_QUORUM_DIR``, ``FA_QUORUM_RANK``,
``FA_QUORUM_PROCS``) writes the JAX package's files, so a JAX rank and a
port rank can share one directory.  :class:`TorchTransport` (a
``--distributed`` world of more than one process, parallel/mesh.py)
gathers the same vector through the process group; it exchanges only at
the rendezvous every rank passes once, and has no fence and no elastic
continuation (the ranks' rows cannot move to a survivor).
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.reliability import failpoints, ledger
from fastapriori_tpu_torch.utils.env import env_float, env_int, env_str

# The chains whose position shapes the mesh's collectives, in the order
# of the exchanged vector: the wire format, the JAX package's (appended
# only at the end).
CONSENSUS_CHAINS: Tuple[str, ...] = (
    "engine",
    "mine_engine",
    "count_reduce",
    "rule_engine",
    "exchange",
    "elastic",
    "vertical_kernel",
)

FENCE_NAME = "FENCE"


class PeerLost(RuntimeError):
    """A peer rank died or wedged: no heartbeat, no arrival at a
    rendezvous, or a failed collective within the bound.  The message
    leads with ``UNAVAILABLE``, so retry.classify sees a transient and a
    flapping peer gets its retry; ``rank`` is the lost rank or -1."""

    def __init__(self, rank: int, site: str, detail: str):
        self.rank = rank
        self.site = site
        super().__init__(
            f"UNAVAILABLE: quorum peer rank {rank} lost at {site!r} — "
            f"{detail}")


class MeshDivergence(RuntimeError):
    """Ranks that would issue collectives of different shapes, found at
    a rendezvous (``consensus=False``, or divergent weight totals).  The
    message leads with ``ABORTED`` (a transient: the bounded retry looks
    again)."""


class MeshEpochAbort(RuntimeError):
    """A peer advanced the mesh epoch past this rank's: the level in
    flight must abort and meet again under ``target_epoch``.  No
    transient status word, so it escapes the bounded retry at once: it
    is the elastic arm's signal, not a failure."""

    def __init__(self, target_epoch: int, dead, site: str, detail: str):
        self.target_epoch = int(target_epoch)
        self.dead = sorted(int(d) for d in dead)
        self.site = site
        super().__init__(
            f"mesh epoch superseded at {site!r}: {detail} — abort the "
            f"in-flight level and re-rendezvous at epoch {target_epoch}")


class StaleFenceError(InputError):
    """A checkpoint commit or resume under a superseded fence epoch (a
    split-brain writer)."""


def quorum_timeout_s() -> float:
    """``FA_QUORUM_TIMEOUT_S``: the bound, in seconds, on one exchange or
    rendezvous wait, on a collective of ``--distributed`` and on a
    serving mesh's swap (strict; default 30)."""
    return env_float("FA_QUORUM_TIMEOUT_S", 30.0, minimum=0.1)


def heartbeat_ms() -> float:
    """``FA_HEARTBEAT_MS``: the heartbeat interval in milliseconds
    (strict; default 200), well under the quorum timeout that judges a
    heartbeat's age; also the serving router's poll interval."""
    return env_float("FA_HEARTBEAT_MS", 200.0, minimum=1.0)


def epoch_retry_max() -> int:
    """``FA_EPOCH_RETRY_MAX``: the highest mesh epoch elastic
    continuation may reach (strict; default 0: off, a lost peer stays a
    PeerLost).  Each shrink of the survivor set takes one epoch."""
    return env_int("FA_EPOCH_RETRY_MAX", 0, minimum=0)


def _site_slug(site: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in site)


# ---------------------------------------------------------------------------
# Transports.


class FileTransport:
    """The shared-directory transport, file for file the JAX package's:
    ``state.<r>`` (positions, seq, time, mesh epoch), ``hb.<r>`` (the
    heartbeat a daemon thread rewrites), ``mark.<site>.<r>`` (rendezvous
    and exchange markers), ``exit.<r>`` (a rank that ended) and
    ``FENCE`` (the fence epoch, under ``FENCE.lock``).  Every write is a
    temporary file and a rename: a reader never sees a torn file."""

    def __init__(self, root: str, rank: int, nprocs: int):
        self.root = root
        self.rank = rank
        self.nprocs = nprocs
        os.makedirs(root, exist_ok=True)
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    def _write_json(self, name: str, doc: dict) -> None:
        path = os.path.join(self.root, name)
        tmp = path + f".tmp{self.rank}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def _read_json(self, name: str) -> Optional[dict]:
        try:
            with open(os.path.join(self.root, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            # Absent, or replaced mid-read on a filesystem without an
            # atomic rename: the caller polls, and a file that never
            # parses is a missing peer (bounded: PeerLost).
            return None

    def start_heartbeat(self) -> None:
        if self._hb_thread is not None:
            return
        interval = heartbeat_ms() / 1e3

        def beat() -> None:
            while not self._hb_stop.wait(interval):
                failpoints.fire("quorum.heartbeat")
                self._write_json(f"hb.{self.rank}", {"t": time.time()})

        self._write_json(f"hb.{self.rank}", {"t": time.time()})
        t = threading.Thread(target=beat, name=f"fa-quorum-hb:{self.rank}",
                             daemon=True)
        t.start()
        self._hb_thread = t

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()

    def heartbeat_age(self, rank: int) -> Optional[float]:
        """Seconds since ``rank``'s last heartbeat; None when it has
        published none."""
        doc = self._read_json(f"hb.{rank}")
        if doc is None:
            return None
        return max(0.0, time.time() - float(doc.get("t", 0.0)))

    def publish_state(self, doc: dict) -> None:
        self._write_json(f"state.{self.rank}", doc)

    def peer_state(self, rank: int) -> Optional[dict]:
        return self._read_json(f"state.{rank}")

    def post_marker(self, site: str, doc: dict) -> None:
        self._write_json(f"mark.{_site_slug(site)}.{self.rank}", doc)

    def peer_marker(self, site: str, rank: int) -> Optional[dict]:
        return self._read_json(f"mark.{_site_slug(site)}.{rank}")

    def post_exit(self, status: str) -> None:
        self._write_json(f"exit.{self.rank}",
                         {"status": status, "t": time.time()})

    def peer_exit(self, rank: int) -> Optional[dict]:
        return self._read_json(f"exit.{rank}")

    def _fence_lock(self, bound_s: float) -> str:
        """The exclusive-create lock of the fence.  A lock older than the
        bound belongs to a dead writer and is broken by an atomic rename
        aside, which one breaker alone wins, so two writers never both
        hold it."""
        path = os.path.join(self.root, FENCE_NAME + ".lock")
        t0 = time.monotonic()
        while True:
            try:
                os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
                return path
            except FileExistsError:
                try:
                    stale = time.time() - os.path.getmtime(path) > bound_s
                except FileNotFoundError:
                    continue  # released while we looked: create again
                if stale:
                    aside = path + f".broken.{self.rank}.{os.getpid()}"
                    try:
                        os.rename(path, aside)
                        os.unlink(aside)
                    except FileNotFoundError:
                        pass  # another breaker won the rename
                    continue
                if time.monotonic() - t0 > bound_s:
                    raise PeerLost(-1, "fence.lock",
                                   f"fence lock held past {bound_s}s") from None
                time.sleep(0.005)

    def current_fence(self) -> int:
        doc = self._read_json(FENCE_NAME)
        return int(doc["fence"]) if doc else 0

    def acquire_fence(self) -> int:
        """Increment and return the fence epoch, atomically across every
        writer that shares the directory."""
        lock = self._fence_lock(quorum_timeout_s())
        try:
            fence = self.current_fence() + 1
            self._write_json(FENCE_NAME, {"fence": fence})
            return fence
        finally:
            # A holder past the bound may have had its lock broken.
            with contextlib.suppress(FileNotFoundError):
                os.unlink(lock)


class TorchTransport:
    """The transport of a ``--distributed`` world: a rank-prefixed vector
    gathered from every rank through the process group
    (parallel/mesh.py ``world_all_gather``, each wait polled against
    ``FA_QUORUM_TIMEOUT_S``); a failed or late collective raises
    :class:`PeerLost` naming the lost rank (or -1).  A collective in its
    own right: every rank must call it as often, so it runs only at the
    rendezvous every rank passes once."""

    def __init__(self, rank: int, nprocs: int):
        self.rank = rank
        self.nprocs = nprocs

    def exchange(self, vec: List[int], site: str, int64: bool = False):
        import torch

        from fastapriori_tpu_torch.parallel import mesh

        # Position vectors are small int32; the weight totals are int64
        # sums that an int32 cast would wrap on every rank alike.
        x = torch.tensor(vec, dtype=torch.int64 if int64 else torch.int32)
        return [row.tolist() for row in
                mesh.world_all_gather(x, f"quorum.{site}")]


# ---------------------------------------------------------------------------
# The domain.


class QuorumDomain:
    """This process's membership in a multi-process fault domain (module
    docstring).  Thread-safe; one per process (:func:`active`), or built
    directly by tests."""

    def __init__(self, transport, rank: int, nprocs: int,
                 consensus: bool = True):
        if nprocs < 1 or not 0 <= rank < nprocs:
            raise InputError(
                f"quorum domain needs 0 <= rank < nprocs, got rank={rank} "
                f"nprocs={nprocs}")
        self.transport = transport
        self.rank = rank
        self.nprocs = nprocs
        self.consensus = consensus
        # The mesh epoch every round is stamped with, and the ranks still
        # in the domain (the dead leave at each elastic rejoin).
        self.mesh_epoch = 0
        self.members: List[int] = list(range(nprocs))
        self._lock = threading.Lock()
        self._seq = 0
        self._xseq: Dict[str, int] = {}  # exchange rounds per site
        # Per chain, the agreed stage index (0 = most capable).
        self._pos: Dict[str, int] = {c: 0 for c in CONSENSUS_CHAINS}
        self._fence: Optional[int] = None
        self._epoch_trail: List[Dict[str, Any]] = []
        # Callbacks run after every rejoin: the miner's checkpoint writer
        # re-commits its last levels under the re-derived fence.
        self._rejoin_hooks: List[Any] = []
        self._closed = False
        if self._file():
            transport.start_heartbeat()
            self._publish("init")

    def _file(self) -> bool:
        return isinstance(self.transport, FileTransport)

    # -- positions --------------------------------------------------------
    @staticmethod
    def _chain_order(chain: str) -> Tuple[str, ...]:
        from fastapriori_tpu_torch.reliability import watchdog

        return watchdog.CHAINS[chain]

    def position(self, chain: str) -> int:
        with self._lock:
            return self._pos[chain]

    def floor_stage(self, chain: str) -> str:
        """The agreed most degraded stage of ``chain``."""
        return self._chain_order(chain)[self.position(chain)]

    def stage_allowed(self, chain: str, stage: str) -> bool:
        """True when ``stage`` is at or past the agreed floor: this rank
        may still run it."""
        return self._chain_order(chain).index(stage) >= self.position(chain)

    def propose(self, chain: str, stage: str, reason: str = "") -> None:
        """Move this rank's position of ``chain`` to ``stage`` and publish
        it at once (peers see it before their next exchange).  A stage at
        or before the current position is a no-op: never a backward walk;
        a chain outside the consensus set is ignored."""
        if chain not in self._pos:
            return
        idx = self._chain_order(chain).index(stage)
        with self._lock:
            if idx <= self._pos[chain]:
                return
            self._pos[chain] = idx
        self._publish(f"propose:{chain}:{reason}")

    def _vector(self) -> List[int]:
        with self._lock:
            return [self._pos[c] for c in CONSENSUS_CHAINS]

    def _publish(self, site: str) -> None:
        if not self._file():
            return
        with self._lock:
            self._seq += 1
            doc = {"seq": self._seq, "site": site,
                   "pos": [self._pos[c] for c in CONSENSUS_CHAINS],
                   "t": time.time(),
                   # The elastic abort's broadcast: a peer that sees a
                   # later epoch aborts its own level in flight.
                   "mesh_epoch": self.mesh_epoch}
        self.transport.publish_state(doc)

    def _esite(self, site: str) -> str:
        """``site`` in the current mesh epoch's namespace, so a meeting
        after an abort never pairs with a marker from before it."""
        return f"e{self.mesh_epoch}.{site}"

    def _peer_epoch_check(self, rank: int, site: str) -> None:
        """MeshEpochAbort when ``rank`` published a later mesh epoch (it
        aborted and waits under the new epoch's markers)."""
        st = self.transport.peer_state(rank)
        if st is None:
            return
        pe = int(st.get("mesh_epoch", 0))
        if pe > self.mesh_epoch:
            raise MeshEpochAbort(
                pe, (), site, f"peer rank {rank} published mesh epoch {pe} "
                f"while this rank is at {self.mesh_epoch}")

    def _adopt(self, peer_vecs: Dict[int, List[int]], site: str) -> None:
        """The elementwise most degraded position wins; each adoption a
        peer forced is a ``quorum_adopt`` ledger event naming the
        originating rank, and a ``cascade`` walk with reason ``quorum``."""
        from fastapriori_tpu_torch.reliability import watchdog

        for ci, chain in enumerate(CONSENSUS_CHAINS):
            best_rank, best = None, self.position(chain)
            for r, vec in peer_vecs.items():
                if len(vec) == len(CONSENSUS_CHAINS) and vec[ci] > best:
                    best, best_rank = vec[ci], r
            if best_rank is None:
                continue
            order = self._chain_order(chain)
            frm = order[self.position(chain)]
            to_idx = min(best, len(order) - 1)
            to = order[to_idx]
            with self._lock:
                self._pos[chain] = to_idx
            ledger.record("quorum_adopt", once_key=f"{chain}:{to}",
                          chain=chain, frm=frm, to=to, rank=best_rank,
                          site=site, epoch=self._seq)
            # "rank" is the cascade event's stage index; the originating
            # process is src_rank.
            watchdog.downgrade(chain, frm, to, reason="quorum",
                               once_key=f"quorum:{chain}:{to}",
                               src_rank=best_rank, site=site)
        self._publish(f"adopt:{site}")

    # -- liveness ---------------------------------------------------------
    def _check_peer_alive(self, rank: int, site: str, waited_s: float,
                          bound_s: float) -> None:
        """PeerLost when ``rank`` is demonstrably gone: an exit marker,
        or a heartbeat older than the bound; a peer that has not started
        yet gets the whole bound (start-up skew is not death)."""
        t = self.transport
        ex = t.peer_exit(rank)
        if ex is not None:
            raise PeerLost(rank, site,
                           f"peer exited ({ex.get('status', '?')}) before "
                           "reaching this point")
        age = t.heartbeat_age(rank)
        if age is not None and age > bound_s:
            raise PeerLost(rank, site,
                           f"no heartbeat for {age:.1f}s (bound {bound_s}s, "
                           "FA_QUORUM_TIMEOUT_S)")
        if age is None and waited_s > bound_s:
            raise PeerLost(rank, site,
                           f"never published a heartbeat within {bound_s}s")

    # -- sync -------------------------------------------------------------
    def sync(self, site: str, wait: bool = False) -> None:
        """The consensus exchange at ``site``.  Without ``wait``: publish
        this rank's positions, read every peer's current state, adopt the
        most degraded and check heartbeats: one poll.  With ``wait``: a
        rendezvous that returns once every peer posted this site's
        marker (bounded), comparing digests when ``consensus`` is off.
        Runs under the bounded retry at site ``quorum.<site>``; a
        PeerLost or MeshDivergence that escapes it is a ledger event and
        a flight dump carrying the epoch trail.  On a torch transport
        only the ``wait`` form exchanges: the others would be
        collectives that ranks which walked a chain call a different
        number of times."""
        if self.nprocs == 1 or len(self.members) == 1:
            return  # alone (or the last survivor): nobody to meet
        torch_t = isinstance(self.transport, TorchTransport)
        if torch_t and not wait:
            return
        from fastapriori_tpu_torch.obs import flight
        from fastapriori_tpu_torch.reliability import retry

        def attempt() -> None:
            if torch_t:
                self._sync_torch(site)
            else:
                self._sync_file(site, wait)

        try:
            retry.call_with_retries(attempt, f"quorum.{_site_slug(site)}")
        except (PeerLost, MeshDivergence) as exc:
            ledger.record(
                "peer_lost" if isinstance(exc, PeerLost)
                else "mesh_divergence",
                site=site, rank=getattr(exc, "rank", -1),
                error=str(exc)[:200])
            flight.auto_dump(type(exc).__name__, extra={
                "site": site, "rank": self.rank,
                "epoch_trail": self.epoch_trail()})
            raise
        with self._lock:
            self._epoch_trail.append({
                "epoch": self._seq, "site": site,
                "pos": [self._pos[c] for c in CONSENSUS_CHAINS]})
            entry = dict(self._epoch_trail[-1])
        flight.note("quorum", **entry)

    def _sync_torch(self, site: str) -> None:
        rows = self.transport.exchange([self.rank] + self._vector(),
                                       _site_slug(site))
        peer_vecs = {int(row[0]): [int(x) for x in row[1:]]
                     for row in rows if int(row[0]) != self.rank}
        if self.consensus:
            self._adopt(peer_vecs, site)

    def _sync_file(self, site: str, wait: bool) -> None:
        t = self.transport
        bound = quorum_timeout_s()
        my_vec = self._vector()
        esite = self._esite(site)
        digest = f"{_site_slug(esite)}|" + ",".join(map(str, my_vec))
        meet = wait or not self.consensus
        self._publish(f"sync:{site}")
        if meet:
            t.post_marker(esite, {"pos": my_vec, "digest": digest})
        peers = [r for r in self.members if r != self.rank]
        peer_vecs: Dict[int, List[int]] = {}
        t0 = time.monotonic()
        pending = list(peers)
        while True:
            still: List[int] = []
            for r in pending:
                if meet:
                    doc = t.peer_marker(esite, r)
                else:
                    doc = t.peer_state(r)
                    if doc is not None and int(
                            doc.get("mesh_epoch", 0)) > self.mesh_epoch:
                        pe = int(doc["mesh_epoch"])
                        raise MeshEpochAbort(
                            pe, (), site, f"peer rank {r} published mesh "
                            f"epoch {pe} while this rank is at "
                            f"{self.mesh_epoch}")
                if doc is None:
                    # A marker missing at our epoch may mean the peer
                    # already aborted to a later one.
                    if meet:
                        self._peer_epoch_check(r, site)
                    still.append(r)
                    continue
                peer_vecs[r] = list(doc.get("pos", []))
                if (not self.consensus and "digest" in doc
                        and doc["digest"] != digest):
                    raise MeshDivergence(
                        f"ABORTED: mesh divergence at {site!r}: rank "
                        f"{self.rank} would issue {digest!r} while rank {r} "
                        f"issues {doc['digest']!r} — without cascade "
                        "consensus these collectives can never match (the "
                        "raw mesh hangs here; this bound is the watchdog)")
            waited = time.monotonic() - t0
            if not meet or not still:
                break  # a poll sees whoever published; a meeting is full
            for r in still:
                self._check_peer_alive(r, site, waited, bound)
            if waited > bound:
                raise PeerLost(still[0], site,
                               f"rendezvous incomplete after {bound}s "
                               f"(waiting on ranks {still})")
            pending = still
            time.sleep(min(0.005, bound / 10))
        # Liveness on every path: a peer met this round is judged by its
        # heartbeat's age alone (it may exit right after a last meeting);
        # one not seen gets the whole check.
        waited = time.monotonic() - t0
        for r in peers:
            if r in peer_vecs:
                age = t.heartbeat_age(r)
                if age is not None and age > bound:
                    raise PeerLost(r, site,
                                   f"no heartbeat for {age:.1f}s (bound "
                                   f"{bound}s, FA_QUORUM_TIMEOUT_S)")
            else:
                self._check_peer_alive(r, site, waited, bound)
        if self.consensus:
            self._adopt(peer_vecs, site)

    # -- payload exchange -------------------------------------------------
    def exchange(self, site: str, payload: List[int]) -> Dict[int, List[int]]:
        """Every rank's integer vector at ``site`` (a rendezvous, with the
        liveness rules of ``sync(wait=True)``): ``{rank: payload}``, this
        rank's included.  On the file transport each call at a site is
        its own round in the current epoch's namespace, so a later mine
        never pairs with an earlier round's marker; on the torch
        transport the vectors must have one length on every rank."""
        if self.nprocs == 1 or len(self.members) == 1:
            return {self.rank: list(payload)}
        from fastapriori_tpu_torch.obs import flight
        from fastapriori_tpu_torch.reliability import retry

        box: Dict[int, List[int]] = {}
        with self._lock:
            ekey = f"e{self.mesh_epoch}.{site}"
            self._xseq[ekey] = self._xseq.get(ekey, 0) + 1
            round_site = f"{ekey}.r{self._xseq[ekey]}"

        def attempt() -> None:
            box.clear()
            if isinstance(self.transport, TorchTransport):
                rows = self.transport.exchange(
                    [self.rank] + [int(v) for v in payload],
                    _site_slug(site), int64=True)
                for row in rows:
                    box[int(row[0])] = [int(x) for x in row[1:]]
            else:
                box.update(self._exchange_file(round_site, payload))

        try:
            retry.call_with_retries(attempt, f"quorum.{_site_slug(site)}")
        except PeerLost as exc:
            ledger.record("peer_lost", site=site, rank=exc.rank,
                          error=str(exc)[:200])
            flight.auto_dump("PeerLost", extra={
                "site": site, "rank": self.rank,
                "epoch_trail": self.epoch_trail()})
            raise
        return box

    def _exchange_file(self, site: str,
                       payload: List[int]) -> Dict[int, List[int]]:
        t = self.transport
        bound = quorum_timeout_s()
        t.post_marker(site, {"payload": [int(v) for v in payload]})
        out: Dict[int, List[int]] = {self.rank: list(payload)}
        pending = [r for r in self.members if r != self.rank]
        t0 = time.monotonic()
        while pending:
            still: List[int] = []
            for r in pending:
                doc = t.peer_marker(site, r)
                if doc is None:
                    self._peer_epoch_check(r, site)
                    still.append(r)
                    continue
                out[r] = [int(v) for v in doc.get("payload", [])]
            waited = time.monotonic() - t0
            for r in still:
                self._check_peer_alive(r, site, waited, bound)
            if still and waited > bound:
                raise PeerLost(still[0], site,
                               f"exchange incomplete after {bound}s "
                               f"(waiting on ranks {still})")
            pending = still
            if pending:
                time.sleep(min(0.005, bound / 10))
        return out

    def epoch_trail(self) -> List[Dict[str, Any]]:
        """Every sync this domain completed (epoch, site, positions): the
        history a fault-domain flight dump carries."""
        with self._lock:
            return [dict(e) for e in self._epoch_trail]

    # -- elastic continuation ---------------------------------------------
    def elastic_rejoin(self, exc: BaseException) -> None:
        """Absorb a :class:`PeerLost` or :class:`MeshEpochAbort`: the
        survivors meet again under the next mesh epoch without the dead
        ranks, or ``exc`` re-raises, classified, when continuation is off
        (``FA_EPOCH_RETRY_MAX=0``), its budget is spent, the consensus
        chain ``elastic`` was clamped to ``abort``, or the transport
        cannot shrink (a torch world, whose ranks hold rows no survivor
        has).  On return the member set has shrunk, the fence is
        re-derived, and the caller re-seeds its level loop."""
        from fastapriori_tpu_torch.parallel import mesh
        from fastapriori_tpu_torch.reliability import watchdog

        if not isinstance(exc, (PeerLost, MeshEpochAbort)):
            raise exc
        if not self._file() or self.nprocs == 1 or mesh.process_count() > 1:
            raise exc
        budget = epoch_retry_max()
        dead: set = set()
        original = exc
        while True:
            if isinstance(exc, MeshEpochAbort):
                target = max(self.mesh_epoch + 1, exc.target_epoch)
                dead.update(exc.dead)
            else:
                target = self.mesh_epoch + 1
                if exc.rank >= 0:
                    dead.add(exc.rank)
            if (budget <= 0 or target > budget
                    or not self.stage_allowed("elastic", "continue")):
                if budget > 0 and self.stage_allowed("elastic", "continue"):
                    # The walk clamps continue -> abort for the whole
                    # domain (peers adopt it); the stage test keeps a
                    # second exhaustion from walking again.
                    watchdog.downgrade("elastic", "continue", "abort",
                                       reason="epoch_retry_exhausted",
                                       once_key="elastic:abort",
                                       epoch=target)
                if isinstance(original, PeerLost):
                    raise original
                raise PeerLost(
                    min(dead) if dead else -1,
                    getattr(original, "site", "elastic.join"),
                    "mesh-epoch retry budget exhausted "
                    f"(FA_EPOCH_RETRY_MAX={budget}, target epoch {target})",
                ) from original
            try:
                self._abort_and_rendezvous(target, dead, type(exc).__name__)
                return
            except (PeerLost, MeshEpochAbort) as nxt:
                # Another death or abort during the rejoin: each pass
                # raises the target epoch, so the budget bounds them all.
                exc = nxt

    def _abort_and_rendezvous(self, target: int, dead: set,
                              reason: str) -> None:
        """Meet the survivors at mesh epoch ``target``.  ``dead`` (updated
        in place) is the union of every joiner's lost ranks: each posts
        its set in the join marker and folds in the others', so a death
        one survivor saw is excluded by all, and a death seen during the
        rejoin is folded in instead of failing it."""
        from fastapriori_tpu_torch.obs import flight

        t = self.transport
        bound = quorum_timeout_s()
        with self._lock:
            from_epoch = self.mesh_epoch
            self.mesh_epoch = target
            members = list(self.members)
        # Publishing the new epoch is the abort broadcast.
        self._publish(f"elastic.abort:{target}")
        site = "elastic.join"
        esite = self._esite(site)

        def post_join() -> None:
            t.post_marker(esite, {"dead": sorted(dead),
                                  "from_epoch": from_epoch})

        post_join()
        collected: set = set()
        t0 = time.monotonic()
        while True:
            grew = False
            still: List[int] = []
            for r in members:
                if r == self.rank or r in dead or r in collected:
                    continue
                doc = t.peer_marker(esite, r)
                if doc is None:
                    st = t.peer_state(r)
                    pe = int(st.get("mesh_epoch", 0)) if st else 0
                    if pe > target:
                        raise MeshEpochAbort(
                            pe, sorted(dead), site, f"peer rank {r} aborted "
                            f"again past epoch {target} mid-rejoin")
                    still.append(r)
                    continue
                collected.add(r)
                for d in doc.get("dead", ()):
                    if int(d) not in dead:
                        dead.add(int(d))
                        grew = True
            if self.rank in dead:
                raise StaleFenceError(
                    f"mesh epoch {target} fenced this rank out: the "
                    f"survivors re-rendezvoused declaring rank {self.rank} "
                    "dead — this straggler's view of the domain is "
                    "superseded; refusing to rejoin or commit")
            waited = time.monotonic() - t0
            if grew:
                post_join()
                continue
            if not still:
                break
            for r in still:
                try:
                    self._check_peer_alive(r, site, waited, bound)
                except PeerLost:
                    dead.add(r)
                    grew = True
            if grew:
                post_join()
                continue
            if waited > bound:
                raise PeerLost(still[0], site,
                               f"elastic re-rendezvous at epoch {target} "
                               f"incomplete after {bound}s (waiting on "
                               f"ranks {still})")
            time.sleep(min(0.005, bound / 10))
        survivors = [r for r in members if r not in dead]
        removed = sorted(dead)
        with self._lock:
            self.members = survivors
            # Writership may have moved to the lowest survivor, and the
            # old writer must never commit a pre-abort artifact.
            self._fence = None
        ledger.record("mesh_epoch", once_key=f"epoch:{target}",
                      epoch=target, from_epoch=from_epoch, dead=removed,
                      members=survivors, reason=reason)
        self._publish(f"elastic.join:{target}")
        with self._lock:
            self._epoch_trail.append({
                "epoch": self._seq, "site": site,
                "pos": [self._pos[c] for c in CONSENSUS_CHAINS],
                "mesh_epoch": target, "dead": removed})
        flight.note("mesh_epoch", mesh_epoch=target, from_epoch=from_epoch,
                    dead=removed, members=survivors, reason=reason)
        if self.is_writer():
            # The eager re-acquire turns every pre-abort artifact stale
            # and fences a superseded writer out of its next commit.
            self.checkpoint_fence()
        for fn in list(self._rejoin_hooks):
            fn()

    def add_rejoin_hook(self, fn: Any) -> None:
        """Run ``fn`` after every completed rejoin, once the survivor set
        and the fence are re-derived (the checkpoint writer re-commits
        its levels under the new fence, so no artifact is left at the
        old one)."""
        with self._lock:
            if fn not in self._rejoin_hooks:
                self._rejoin_hooks.append(fn)

    # -- fences -----------------------------------------------------------
    def is_writer(self) -> bool:
        """The lowest surviving rank writes (rank 0 until a rejoin
        removes it)."""
        return self.rank == min(self.members)

    def checkpoint_fence(self) -> int:
        """The fence this writer's commits carry: acquired once per run,
        then checked against the domain's ``FENCE`` at every commit (a
        superseded writer raises :class:`StaleFenceError`).  0 on a
        transport without a fence."""
        if not self._file():
            return 0
        with self._lock:
            if self._fence is None:
                self._fence = self.transport.acquire_fence()
            fence = self._fence
        current = self.transport.current_fence()
        if current > fence:
            raise StaleFenceError(
                f"stale checkpoint fence: this writer holds fence {fence} "
                f"but the domain has advanced to {current} — a newer "
                "coordinator owns the checkpoint; refusing the split-brain "
                "commit")
        return fence

    def validate_resume_fence(self, fence: Optional[int]) -> None:
        """Refuse a resume from an artifact stamped with a fence older
        than the domain's current one (a superseded writer's)."""
        if not self._file() or fence is None:
            return
        current = self.transport.current_fence()
        if current and fence < current:
            raise StaleFenceError(
                f"stale checkpoint fence {fence}: the domain's fence has "
                f"advanced to {current} — this checkpoint was written by a "
                "superseded coordinator (split-brain); resume from the "
                "current writer's checkpoint")

    def close(self, status: str = "done") -> None:
        """Leave the domain: a file transport posts this rank's exit
        marker (peers then see the loss at once) and stops its
        heartbeat.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._file():
            self.transport.post_exit(status)
            self.transport.stop_heartbeat()


# ---------------------------------------------------------------------------
# The process-wide domain (memoized: one attribute read per hook without
# one).

_domain: Optional[QuorumDomain] = None
_resolved = False
_resolve_lock = threading.Lock()


def _resolve() -> Optional[QuorumDomain]:
    from fastapriori_tpu_torch.parallel import mesh

    root = env_str("FA_QUORUM_DIR")
    if root:
        nprocs = env_int("FA_QUORUM_PROCS", 1, minimum=1)
        rank = env_int("FA_QUORUM_RANK", 0, minimum=0)
        if rank >= nprocs:
            raise InputError(
                f"FA_QUORUM_RANK={rank} is out of range for "
                f"FA_QUORUM_PROCS={nprocs} (ranks are 0-based)")
        dom = QuorumDomain(FileTransport(root, rank, nprocs), rank, nprocs)
        atexit.register(dom.close, "atexit")
        return dom
    n = mesh.process_count()
    if n > 1:
        r = mesh.process_index()
        return QuorumDomain(TorchTransport(r, n), r, n)
    return None


def active() -> Optional[QuorumDomain]:
    """The process's domain, or None (one process: the fast path)."""
    global _domain, _resolved
    if _resolved:
        return _domain
    with _resolve_lock:
        if not _resolved:
            _domain = _resolve()
            _resolved = True
    return _domain


def set_domain(domain: Optional[QuorumDomain]) -> None:
    """Install a domain explicitly (tests)."""
    global _domain, _resolved
    _domain = domain
    _resolved = True


def shutdown(status: str = "done") -> None:
    """Close the process's domain with ``status`` and forget it: the next
    hook resolves again (the CLI at the end of every run, and when a
    ``--distributed`` world starts or ends)."""
    global _domain, _resolved
    with _resolve_lock:
        dom, _domain, _resolved = _domain, None, False
    if dom is not None:
        dom.close(status)


def reload_from_env() -> None:
    """Close and forget the domain, so ``FA_QUORUM_*`` is read again."""
    shutdown("reload")


# -- the hooks (no-ops without a domain) -----------------------------------


def propose(chain: str, stage: str, reason: str = "") -> None:
    dom = active()
    if dom is not None:
        dom.propose(chain, stage, reason)


def sync(site: str, wait: bool = False) -> None:
    dom = active()
    if dom is not None:
        dom.sync(site, wait=wait)


def stage_allowed(chain: str, stage: str) -> bool:
    dom = active()
    return dom is None or dom.stage_allowed(chain, stage)


def elastic_enabled() -> bool:
    """True when the domain can absorb a lost peer: a file domain of more
    than one rank, one process per rank, ``FA_EPOCH_RETRY_MAX`` > 0."""
    from fastapriori_tpu_torch.parallel import mesh

    dom = active()
    return (dom is not None and dom._file() and dom.nprocs > 1
            and mesh.process_count() == 1 and epoch_retry_max() > 0)


def elastic_rejoin(exc: BaseException) -> None:
    """The domain's :meth:`QuorumDomain.elastic_rejoin`, or ``exc``
    re-raised without a domain."""
    dom = active()
    if dom is None:
        raise exc
    dom.elastic_rejoin(exc)


def sync_or_rejoin(site: str, wait: bool = False) -> None:
    """:func:`sync` inside the elastic arm, for the rendezvous outside the
    level loop (run.start, mine.end, rules.start, run.end): a rank that
    waits here while a peer aborts the mesh meets it under the new epoch
    instead of calling it lost.  Without continuation, ``sync``."""
    while True:
        try:
            sync(site, wait=wait)
            return
        except (PeerLost, MeshEpochAbort) as exc:
            elastic_rejoin(exc)


def mesh_epoch() -> int:
    dom = active()
    return 0 if dom is None else dom.mesh_epoch


def mesh_members() -> Optional[List[int]]:
    dom = active()
    return None if dom is None else list(dom.members)


def exchange(site: str, payload) -> Optional[Dict[int, List[int]]]:
    """The domain's :meth:`QuorumDomain.exchange`; None without a domain
    (the caller takes its own channel)."""
    dom = active()
    return None if dom is None else dom.exchange(site, list(payload))


def floor_stage(chain: str) -> Optional[str]:
    dom = active()
    return None if dom is None else dom.floor_stage(chain)


def is_writer() -> bool:
    """True on the process that owns the checkpoint: the domain's lowest
    surviving rank; without a domain, rank 0 of the world (every process
    of a one-process run)."""
    dom = active()
    if dom is None:
        from fastapriori_tpu_torch.parallel import mesh

        return mesh.process_index() == 0
    return dom.is_writer()


def checkpoint_fence() -> int:
    dom = active()
    return 0 if dom is None else dom.checkpoint_fence()


def writer_fence() -> Optional[int]:
    """The fence to stamp into a manifest, or None where the fence must
    not be touched: no domain, a transport without a fence, or a rank
    that does not write (acquiring there would fence the writer out)."""
    dom = active()
    if dom is None or not dom.is_writer():
        return None
    return dom.checkpoint_fence() or None


def validate_resume_fence(fence: Optional[int]) -> None:
    dom = active()
    if dom is not None:
        dom.validate_resume_fence(fence)


def rank_suffix() -> str:
    """``".rank<r>"`` in a domain (or a world) of more than one process,
    so per-process trace and flight artifacts do not clobber each other;
    else ``""``."""
    dom = active()
    if dom is None:
        from fastapriori_tpu_torch.parallel import mesh

        n, r = mesh.process_count(), mesh.process_index()
    else:
        n, r = dom.nprocs, dom.rank
    return "" if n == 1 else f".rank{r}"


def rank_path(path: str) -> str:
    """Insert the rank suffix before ``path``'s final extension (or
    append it when there is none): ``out.trace.json`` ->
    ``out.trace.rank1.json``."""
    suffix = rank_suffix()
    if not suffix:
        return path
    base, dot, ext = path.rpartition(".")
    if dot and "/" not in ext and os.sep not in ext:
        return f"{base}{suffix}.{ext}"
    return path + suffix
