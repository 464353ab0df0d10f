"""Association-rule generation with the reference's dominance prune
(counterpart: fastapriori_tpu/rules/gen.py host engine —
``gen_rule_arrays_levels``, ``_rule_arrays_host``, ``sort_rule_arrays``,
``_consequent_priority``; reference C11, AssociationRules.scala:122-188).

1. For every frequent itemset S with |S| >= 2 and every item i in S, a raw
   rule ``(S - {i}) → i`` with confidence ``count(S)/count(S - {i})``
   (:129-145).  Size-1 antecedents divide by the raw occurrence count
   from phase C3 (:130).
2. Level-wise prune (:147-182): every rule at the minimum antecedent size
   survives; a rule at antecedent size i survives iff for EACH element e
   of its antecedent A, the rule ``(A - {e}) → consequent`` survived
   level i-1 with strictly lower confidence (:168, :173).

Confidence is an IEEE double division of two ints, identical on the JVM,
so the comparisons agree bit for bit with the reference.

The object form (counterpart: the JAX package's ``Rule``, ``gen_rules``,
``gen_rules_levels``, ``rule_objects_from_arrays`` and ``sort_rules``)
takes ``(rank frozenset, count)`` itemsets and returns ``(antecedent
frozenset, consequent, confidence)`` tuples from the same host engine;
:func:`rule_arrays_from_objects` turns a sorted object list back into
the arrays the recommender's scans read.

Two engines compute the same arrays (counterpart also: the JAX package's
``_rule_arrays_device``, ``resolve_rule_shards``, ``_pick_rule_engine``,
``rule_engine_from_env``, ``DeviceRuleState``): the numpy engine, and the
device engine, which runs the joins and the prune level by level on the
device (ops/contain.py ``rule_level_shard_kernel``, over the S
transaction shards of a one-process mesh or on shard 0) and fetches
only the survivor masks and the survivors' denominators; the host then
divides the same integers.  The device engine can leave its per-level
state on the device for the recommender's scan table
(``DeviceRuleState``).  A forced device engine that falls back, and a
device engine whose fetches failed past their retries
(reliability/retry.py: transient errors only), walk the cascade's
``rule_engine`` chain (sharded or device -> host) with a ledger event.
In a quorum domain (reliability/quorum.py) phase 2 starts with the
``rules.start`` rendezvous and both choices honour the domain's
``rule_engine`` floor.
"""

from __future__ import annotations

import time
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.obs import trace
from fastapriori_tpu_torch.ops.bitmap import next_pow2
from fastapriori_tpu_torch.ops.bitmap import pad_axis
from fastapriori_tpu_torch.ops.contain import (
    rule_key_bits,
    rule_level_shard_kernel,
    rule_shard_bytes,
    rule_shard_stage_bytes,
)
from fastapriori_tpu_torch.parallel import hier, mesh
from fastapriori_tpu_torch.reliability import ledger, quorum, retry, watchdog
from fastapriori_tpu_torch.utils.env import env_choice, env_int
from fastapriori_tpu_torch.utils.order import consequent_key

RuleArrays = Tuple[np.ndarray, np.ndarray, np.ndarray]  # ant [N,w], cons, conf
Rule = Tuple[FrozenSet[int], int, float]  # (antecedent, consequent, conf)

_RULE_ENGINES = ("auto", "host", "device")

# The device engine compares confidences as exact 48-bit cross products,
# which order them as the host's doubles do only while every count is
# < 2^24 (ops/contain.py ``frac_less24``).
_DEVICE_COUNT_CAP = 1 << 24


def rule_engine_from_env() -> Optional[str]:
    """``FA_RULE_ENGINE`` (auto/host/device), strictly parsed: a value it
    does not know raises InputError.  None when unset: the config
    decides."""
    return env_choice("FA_RULE_ENGINE", _RULE_ENGINES)


class DeviceRuleState:
    """The device engine's per-level state, left on the device for the
    recommender's scan table (ops/contain.py ``rule_scan_build``): per
    level the padded ``(mat, cnts, d_flat, surv_flat)`` tensors (whole
    tables, on shard 0's device), with the level sizes, each level's
    emission offset, the survivor total, the join's shard count and its
    exchanges' bytes."""

    def __init__(self):
        self.ready = False
        self.shards = 1
        self.ks: List[int] = []
        self.arrays: list = []
        self.offsets: List[int] = []
        self.total = 0
        self.gather_bytes = 0
        self.psum_bytes = 0

    def populate(self, ks, arrays, offsets, total, shards=1, gather_bytes=0,
                 psum_bytes=0) -> None:
        self.shards = int(shards)
        self.ks = list(ks)
        self.arrays = list(arrays)
        self.offsets = list(offsets)
        self.total = int(total)
        self.gather_bytes = int(gather_bytes)
        self.psum_bytes = int(psum_bytes)
        self.ready = True

    def release(self) -> None:
        """Drop the device tensors (the scan table, once built, is their
        only consumer)."""
        self.arrays = []
        self.ready = False

    def device_bytes(self) -> int:
        """Bytes of the tensors still held (0 after :meth:`release`)."""
        return sum(int(t.nbytes) for level in self.arrays for t in level)


def _raw_rule_count(mats: Dict[int, Tuple[np.ndarray, np.ndarray]]) -> int:
    """Raw (unpruned) rules: every k-itemset emits k."""
    return sum(k * mat.shape[0] for k, (mat, _) in mats.items() if k >= 2)


def _max_count(mats: Dict[int, Tuple[np.ndarray, np.ndarray]]) -> int:
    return max((int(c.max()) for _, c in mats.values() if c.size), default=0)


def resolve_rule_shards(context, config) -> int:
    """Shards of the device rule join (counterpart: the JAX package's
    ``resolve_rule_shards``): ``FA_RULE_SHARDS`` (strictly parsed) over
    ``config.rule_shards``, 0 = auto.  Auto takes the whole transaction
    axis on an eligible mesh (one process, no cand axis: the sharded
    join's exchanges run over the transaction shards of one process) and
    1 elsewhere; 1 pins the join to shard 0's device; any other value
    must be the mesh's transaction shard count on an eligible mesh
    (InputError otherwise: the join shards over the existing mesh, it
    cannot carve a sub-mesh).  Under the quorum domain's ``rule_engine``
    floor past "sharded" it is 1 (a ``rule_gen_fallback`` event when a
    sharded join was asked for)."""
    req = env_int("FA_RULE_SHARDS", 0, minimum=0)
    src = "FA_RULE_SHARDS"
    if req == 0:
        src = "MinerConfig.rule_shards"
        req = int(getattr(config, "rule_shards", 0) or 0) if config else 0
        if req < 0:
            raise InputError(
                f"MinerConfig.rule_shards={req} is out of range: use 0 "
                "(auto), 1 (single-device), or the mesh's txn shard count"
            )
    eligible = (context is not None and context.world == 1
                and context.cand_shards == 1)
    # The quorum floor, judged apart from the mesh's eligibility: once a
    # rank walked rule_engine past "sharded", the join's exchanges are
    # off for the whole domain, and a valid request degrades with it.
    quorum_ok = quorum.stage_allowed("rule_engine", "sharded")
    if req == 0:
        return context.txn_shards if eligible and quorum_ok else 1
    if req == 1:
        return 1
    if not eligible:
        raise InputError(
            f"{src}={req} needs a single-process 1-D txn mesh "
            "(multi-process rule generation and cand meshes run the "
            "device-0 engine; use 0/1 or unset)"
        )
    if req != context.txn_shards:
        raise InputError(
            f"{src}={req} does not match the mesh's txn axis "
            f"({context.txn_shards} shards): phase 2 shards over the "
            "existing mesh, it cannot carve a sub-mesh"
        )
    if not quorum_ok:
        # The adoption recorded the cascade walk; this is its local
        # consequence.
        ledger.record("rule_gen_fallback", once_key="quorum_shards",
                      reason="quorum", requested_shards=req)
        return 1
    return req


def _pick_rule_engine(mats, context, config, metrics=None) -> str:
    """"host" or "device", from ``FA_RULE_ENGINE`` over
    ``config.rule_engine``: the device engine needs a context and counts
    below 2^24, and under "auto" also a raw rule count of at least
    ``config.rule_device_min_rules`` and a device that is not the CPU.
    A forced device engine that falls back, and every device choice, is
    a metrics event (``rule_gen_fallback``, ``rule_gen_engine``; on a
    mesh of more than one transaction shard the latter adds the join's
    ``shards`` from :func:`resolve_rule_shards`, which parses its knobs
    on every run)."""
    shards = resolve_rule_shards(context, config)
    engine = rule_engine_from_env()
    if engine is None:
        engine = config.rule_engine if config is not None else "auto"
        if engine not in _RULE_ENGINES:
            raise InputError(
                f"unrecognized MinerConfig.rule_engine value {engine!r}: "
                f"use one of {'/'.join(_RULE_ENGINES)}"
            )
    if engine == "host":
        return "host"
    raw = _raw_rule_count(mats)
    if not quorum.stage_allowed("rule_engine", "device"):
        # A peer walked phase 2 to the host engine: the device joins
        # would issue collectives it never matches.
        if engine == "device":
            ledger.record("rule_gen_fallback", reason="quorum",
                          raw_rules=raw)
            watchdog.downgrade("rule_engine", "device", "host",
                               reason="quorum")
        return "host"

    def fallback(reason: str) -> str:
        if engine == "device":
            if metrics is not None:
                metrics.emit("rule_gen_fallback", reason=reason,
                             raw_rules=raw)
            ledger.record("rule_gen_fallback", reason=reason, raw_rules=raw)
            watchdog.downgrade("rule_engine", "device", "host",
                               reason=reason)
        return "host"

    if context is None:
        return fallback("no_device_context")
    if _max_count(mats) >= _DEVICE_COUNT_CAP:
        return fallback("counts_exceed_2^24")
    if engine == "auto":
        floor = config.rule_device_min_rules if config is not None else 1 << 21
        if raw < floor or context.platform == "cpu":
            return "host"
    if metrics is not None:
        # On a mesh the event names the join's shards.
        extra = ({"shards": shards}
                 if context is not None and context.txn_shards > 1 else {})
        metrics.emit("rule_gen_engine", engine="device", requested=engine,
                     raw_rules=raw, **extra)
    return "device"


def _lookup_rows(
    sorted_keys: np.ndarray, order: np.ndarray, keys: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(position-in-original-order, found) for each key."""
    pos = np.searchsorted(sorted_keys, keys)
    found = np.zeros(len(keys), dtype=bool)
    inb = pos < len(sorted_keys)
    found[inb] = sorted_keys[pos[inb]] == keys[inb]
    safe = np.minimum(pos, max(len(sorted_keys) - 1, 0))
    return (order[safe] if len(order) else safe), found


def _key_table(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(sorted keys, order)`` for :func:`_lookup_rows`."""
    order = np.argsort(keys)
    return keys[order], order


def _level_tables(
    levels, item_counts
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Size-grouped itemset tables: the 1-itemsets (every rank, raw
    occurrence counts) plus every non-empty level matrix."""
    mats: Dict[int, Tuple[np.ndarray, np.ndarray]] = {
        1: (
            np.arange(len(item_counts), dtype=np.int32)[:, None],
            np.asarray(item_counts, dtype=np.int64),
        )
    }
    for mat, cnts in levels:
        if mat.shape[0]:
            mats[mat.shape[1]] = (mat, np.asarray(cnts, dtype=np.int64))
    return mats


def _closure_error(k: int) -> InputError:
    return InputError(
        f"itemset table is not downward-closed: {k}-itemsets are "
        f"present but no {k - 1}-itemsets exist to serve as rule "
        "antecedents — the mining output is incomplete"
    )


def _rule_arrays_host(
    mats: Dict[int, Tuple[np.ndarray, np.ndarray]],
    stats: Optional[dict] = None,
) -> List[RuleArrays]:
    """Raw rule generation + dominance prune over the size-grouped tables;
    survivors per antecedent size as ``(ant int32 [N, w], cons int32 [N],
    conf f64 [N])``.  ``stats``, when given, receives ``key_searches``:
    the rows searched over all levels, the prefix chains included.

    Each row R of the j-itemset table has one integer key built from the
    level below, ``key(R) = id(R[:j-1]) * f + R[j-1]``, where ``id`` is a
    row's index in its own table and the empty prefix's id is 0.  A key
    is below ``N_{j-1} * f < 2^62``, so one int64 search serves every
    width and every f.  For a k-itemset S, the prefix ``S[:k-1]`` is
    found by a chain of searches from level 1; the antecedent ``S -
    {S[e]}``, e < k-1, has the prefix ``S[:k-1] - {S[e]}``, whose row the
    level below already found for deleting column e of ``S[:k-1]``."""
    f = 1 + max(
        (int(mat.max()) for mat, _ in mats.values() if mat.size), default=0
    )
    # Raw generation keeps, per k-itemset and deleted column e, the ROW
    # INDEX of S - {e} in the (k-1)-itemset table, so the prune addresses
    # each parent rule in O(1): raw rules of one antecedent size are
    # concatenated consequent-position-major.
    raw: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    parent_rows: Dict[int, np.ndarray] = {}  # k -> int32 [k, N_k]
    n_sets: Dict[int, int] = {}
    tables: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}  # j -> sorted keys
    if 1 in mats:
        tables[1] = _key_table(mats[1][0][:, 0].astype(np.int64))
    searches = 0

    def find(j: int, keys: np.ndarray, mat: np.ndarray, cols) -> np.ndarray:
        # The rows of the j-itemset table holding ``keys``; a miss is the
        # missing subset ``mat[:, cols]`` of a k-itemset.
        nonlocal searches
        searches += keys.size
        idx, found = _lookup_rows(*tables[j], keys)
        if not found.all():
            bad = mat[int(np.argmin(found))][cols].tolist()
            raise InputError(
                f"itemset table is not downward-closed: {sorted(bad)} "
                f"(ranks), a subset of a {mat.shape[1]}-itemset, is "
                "missing from the table — the mining output is incomplete"
            )
        return idx

    for k in sorted(mats):
        if k < 2:
            continue
        if k - 1 not in mats:
            raise _closure_error(k)
        mat, cnts = mats[k]
        pcnts = mats[k - 1][1]
        n = mat.shape[0]
        n_sets[k] = n
        n_sets[k - 1] = mats[k - 1][0].shape[0]
        m64 = mat.astype(np.int64)
        cols = np.arange(k)
        rows_e = np.empty((k, n), dtype=np.int32)
        pid = np.zeros(n, dtype=np.int64)
        for j in range(1, k):
            pid = find(j, pid * f + m64[:, j - 1], mat, cols[:j])
        rows_e[k - 1] = pid
        for e in range(k - 1):
            pre = (parent_rows[k - 1][e, pid].astype(np.int64) if k > 2
                   else np.zeros(n, dtype=np.int64))
            rows_e[e] = find(k - 1, pre * f + m64[:, k - 1], mat,
                             np.delete(cols, e))
        if k + 1 in mats:
            tables[k] = _key_table(pid * f + m64[:, k - 1])
        ants, conss, confs = [], [], []
        for j in range(k):
            ants.append(np.delete(mat, j, axis=1))  # sorted rows stay sorted
            conss.append(mat[:, j])
            confs.append(cnts / pcnts[rows_e[j]].astype(np.float64))
        raw[k - 1] = (
            np.concatenate(ants),
            np.concatenate(conss),
            np.concatenate(confs),
        )
        parent_rows[k] = rows_e
    if stats is not None:
        stats["key_searches"] = searches

    if not raw:
        return []

    min_len = min(raw)
    max_len = max(raw)
    out: List[RuleArrays] = []
    surv_ant, surv_cons, surv_conf = raw[min_len]
    out.append((surv_ant, surv_cons, surv_conf))
    prev_surv = np.ones(len(surv_cons), dtype=bool)
    prev_conf = surv_conf
    for i in range(min_len + 1, max_len + 1):
        if i not in raw:
            prev_surv = np.zeros(0, dtype=bool)
            prev_conf = np.zeros(0)
            continue
        ant, cons, conf = raw[i]
        k = i + 1  # these rules come from k-itemsets
        n_k = n_sets[k]
        n_prev = n_sets[k - 1]
        rows_e = parent_rows[k]
        if prev_surv.size == 0 and n_prev > 0:
            # After a level gap no parent survived: prune everything.
            out.append((np.zeros((0, i), np.int32), np.zeros(0, np.int32),
                        np.zeros(0)))
            prev_surv = np.zeros(len(cons), dtype=bool)
            prev_conf = conf
            continue
        ok = np.ones(len(cons), dtype=bool)
        for j_pos in range(k):
            sl = slice(j_pos * n_k, (j_pos + 1) * n_k)
            conf_j = conf[sl]
            ok_j = ok[sl]
            for e_pos in range(k):
                if e_pos == j_pos:
                    continue
                # Parent rule (S - {e_pos}) -> S[j_pos]: the consequent
                # position shifts down when the deleted column precedes
                # it.  Survive iff the parent survived with strictly
                # lower confidence (AssociationRules.scala:168,173).
                jp = j_pos - (e_pos < j_pos)
                pidx = jp * n_prev + rows_e[e_pos]
                ok_j &= prev_surv[pidx] & (prev_conf[pidx] < conf_j)
        out.append((ant[ok], cons[ok], conf[ok]))
        prev_surv = ok
        prev_conf = conf
    return out


def rule_arrays_from_tables(
    mats: Dict[int, Tuple[np.ndarray, np.ndarray]],
    context=None,
    config=None,
    metrics=None,
    scan_state: Optional[DeviceRuleState] = None,
) -> List[RuleArrays]:
    """Survivor rule arrays per antecedent size, ``(ant int32 [N, w],
    cons int32 [N], conf f64 [N])``, from the size-grouped tables, by the
    engine :func:`_pick_rule_engine` picks (both give the same arrays);
    a ``context`` (device.py ``DeviceContext``) makes the device engine
    eligible, and ``scan_state`` keeps its per-level state on the device
    for the recommender's scan table.  Whenever the host engine runs
    (chosen, or the device engine's fallback) ``metrics`` gets one
    ``rule_gen_host`` event: levels, raw rules, survivors, the key
    searches of :func:`_rule_arrays_host` and its wall time.

    First the ``rules.start`` rendezvous of the quorum domain (a no-op
    without one): positions a peer walked while mining are adopted
    before the engine is picked, so phase 2's first collective is the
    same on every rank."""
    quorum.sync_or_rejoin("rules.start", wait=True)
    if _pick_rule_engine(mats, context, config, metrics) == "device":
        shards = resolve_rule_shards(context, config)
        spec = None
        if shards > 1:
            # The exchange topology of the sharded join, resolved as the
            # mine's (FA_EXCHANGE_GROUPS over config.exchange_groups).
            spec = hier.resolve_active_spec(shards, config)
        if shards != context.txn_shards:
            # The sharded scan table is cut over the whole transaction
            # axis: a join pinned to shard 0 of a larger mesh leaves no
            # state, and the recommender scans the host-built table.
            scan_state = None
        try:
            return _rule_arrays_device(mats, context, metrics, scan_state,
                                       shards=shards, spec=spec)
        except Exception as exc:
            # A transient at the joins' fetches that outlasted its
            # retries walks to the host engine (the same arrays).
            if not retry.exhausted(exc):
                raise
            watchdog.downgrade("rule_engine",
                               "sharded" if shards > 1 else "device", "host",
                               reason="transient_exhausted",
                               error=f"{type(exc).__name__}: {exc}"[:200])
            if scan_state is not None:
                scan_state.release()
    t0 = time.perf_counter()
    stats: dict = {}
    out = _rule_arrays_host(mats, stats)
    if metrics is not None:
        metrics.emit(
            "rule_gen_host",
            levels=sum(1 for k in mats if k >= 2),
            raw_rules=_raw_rule_count(mats),
            survivors=sum(len(c) for _, c, _ in out),
            key_searches=stats["key_searches"],
            wall_ms=round((time.perf_counter() - t0) * 1e3, 3),
        )
    return out


def _rule_arrays_device(
    mats: Dict[int, Tuple[np.ndarray, np.ndarray]],
    ctx,
    metrics=None,
    state: Optional[DeviceRuleState] = None,
    shards: int = 1,
    spec: hier.GroupSpec = None,
) -> List[RuleArrays]:
    """The device engine: each level's table goes up once and one join
    (ops/contain.py ``rule_level_shard_kernel``) per level finds the
    rules and prunes them against the previous level's state, which
    stays on the device.  The join runs over the first ``shards``
    transaction shards: its rows padded to a multiple of ``8·shards``
    and split over them, the parent state copied to each shard's device,
    the exchanges through ``spec``; at ``shards > 1`` each level's
    payload bytes from the byte models are on the ``rule_gen_device``
    event.  Every join is launched before any result is read; each
    level's packed survivor mask comes back by a non-blocking fetch, and
    the survivors' denominators by one gather and one fetch
    (``gather_level_counts_start``, 3 bytes each: counts are < 2^24).
    The confidences are then the host engine's own float64 divisions of
    the same integers.  With ``ctx.sync_check`` the joins run under
    ``ctx.sync_free()``: nothing in them may wait for the device."""
    t0 = time.perf_counter()
    f = 1 + max(
        (int(mat.max()) for mat, _ in mats.values() if mat.size), default=0
    )
    bits = rule_key_bits(f)
    ks = sorted(k for k in mats if k >= 2)
    if not ks:
        return []
    for k in ks:
        if k - 1 not in mats:
            raise _closure_error(k)
    p1 = np.asarray(mats[1][1], dtype=np.int32)
    if f > p1.size:
        # A rank past the 1-itemset table: the host engine finds no
        # antecedent row for it (the k = 2 join reads the rank as its
        # row, so it is checked here).
        raise InputError(
            f"itemset table is not downward-closed: rank {f - 1} has no "
            "1-itemset — the mining output is incomplete"
        )
    devs = ctx.mesh.txn_devices()[:shards]

    def per_shard(x):
        # The next level's parent state, one copy per shard.
        if x is None:
            return [None] * shards
        if isinstance(x, tuple):
            return list(zip(*(mesh.broadcast(c, devs) for c in x)))
        return mesh.broadcast(x, devs)

    per_level: List[dict] = []
    comms: List[dict] = []
    with ctx.sync_free():
        pcnts = ctx.replicate_rule_table(p1, shards)
        psorted = porder = prev_surv = prev_d = None
        prev_n = 0
        for k in ks:
            mat, cnts = mats[k]
            n = mat.shape[0]
            # Rows a multiple of 8·S, so each shard's survivor block packs
            # to whole bytes.
            n_pad = pad_axis(next_pow2(max(n, 8)), 8 * shards)
            mat_p = np.zeros((n_pad, k), np.int32)
            mat_p[:n] = mat
            cnts_p = np.ones(n_pad, np.int32)
            cnts_p[:n] = cnts
            mat_dev = ctx.shard_rule_rows(mat_p, shards)
            cnts_dev = ctx.shard_rule_rows(cnts_p, shards)
            # One span per join, under the recommender's gen_rules span;
            # the masks' fetches are spans of their own when read below.
            with trace.span("rules.level", k=k, n=n, shards=shards):
                (packed, skeys, order, d_flat, surv_flat, mat_full,
                 cnts_full) = rule_level_shard_kernel(
                    mat_dev, cnts_dev, n, per_shard(psorted),
                    per_shard(porder), pcnts, prev_n, per_shard(prev_surv),
                    per_shard(prev_d), k=k, bits=bits, first=k == 2,
                    spec=spec,
                )
            # One fetch site at every shard count (the JAX package names a
            # rule_mask_shard site outside its span census).
            fetch = ctx.fetch_async(packed, "rule_mask")
            if shards > 1:
                g_b, p_b = rule_shard_bytes(k, n_pad, shards, spec)
                i_b, e_b, msgs = rule_shard_stage_bytes(k, n_pad, shards,
                                                        spec)
                comms.append({
                    "k": k, "gather_bytes": g_b, "psum_bytes": p_b,
                    "exchange": hier.describe_spec(spec).split("(")[0],
                    "intra_bytes": i_b, "inter_bytes": e_b,
                    "inter_msgs": msgs,
                })
            pcnts = per_shard(cnts_full)
            per_level.append({
                "k": k, "n": n, "n_pad": n_pad, "mat": mat, "cnts": cnts,
                "arrays": (mat_full, cnts_full, d_flat, surv_flat),
                "fetch": fetch,
            })
            psorted, porder = skeys, order
            prev_surv, prev_d, prev_n = surv_flat, d_flat, n
    dispatch_ms = (time.perf_counter() - t0) * 1e3

    # The masks (fetched while later joins ran), then each survivor's
    # flat position for the one denominator gather.
    pend, offsets, total = [], [], 0
    for lv in per_level:
        out_b = lv["fetch"].result()
        miss = int.from_bytes(out_b[-4:].tobytes(), "little")
        if miss:
            raise InputError(
                f"itemset table is not downward-closed: {miss} "
                f"antecedent(s) of the {lv['k']}-itemsets are missing "
                "from the table — the mining output is incomplete"
            )
        surv = (np.unpackbits(out_b[:-4])
                .reshape(lv["k"], lv["n_pad"])[:, : lv["n"]].astype(bool))
        lv["rows"] = [np.flatnonzero(surv[j]) for j in range(lv["k"])]
        offsets.append(total)
        total += int(surv.sum())
        pos = np.concatenate(
            [j * lv["n_pad"] + r for j, r in enumerate(lv["rows"])])
        pend.append((lv["arrays"][2], pos))
    have = [(d, p) for d, p in pend if p.size]
    den = (ctx.finish_level_counts(
        ctx.gather_level_counts_start(have, u24=True, site="rule_counts"))
        if have else np.empty(0, np.int64))

    out: List[RuleArrays] = []
    off = 0
    for lv in per_level:
        k, mat, cnts = lv["k"], lv["mat"], lv["cnts"]
        cols = np.arange(k)
        ants, conss, confs = [], [], []
        for j, rows_j in enumerate(lv["rows"]):
            d_j = den[off : off + rows_j.size].astype(np.float64)
            off += rows_j.size
            ants.append(mat[np.ix_(rows_j, np.delete(cols, j))])
            conss.append(mat[rows_j, j])
            # The host engine's float64 division of the same ints.
            confs.append(cnts[rows_j] / d_j)
        out.append((np.concatenate(ants), np.concatenate(conss),
                    np.concatenate(confs)))
    gather_total = sum(c["gather_bytes"] for c in comms)
    psum_total = sum(c["psum_bytes"] for c in comms)
    if state is not None:
        state.populate([lv["k"] for lv in per_level],
                       [lv["arrays"] for lv in per_level], offsets, total,
                       shards=shards, gather_bytes=gather_total,
                       psum_bytes=psum_total)
    if metrics is not None:
        # Sharded: the joins' shards and exchange payloads per level
        # (the byte models).
        extra = ({"shards": shards, "gather_bytes": gather_total,
                  "psum_bytes": psum_total,
                  "exchange": comms[0]["exchange"], "comms": comms}
                 if comms else {})
        metrics.emit(
            "rule_gen_device",
            levels=len(per_level),
            dispatches=len(per_level) + (1 if have else 0),
            raw_rules=_raw_rule_count(mats),
            survivors=total,
            dispatch_ms=round(dispatch_ms, 3),
            wall_ms=round((time.perf_counter() - t0) * 1e3, 3),
            **extra,
        )
    return out


def gen_rule_arrays_levels(
    levels, item_counts, context=None, config=None, metrics=None,
    scan_state: Optional[DeviceRuleState] = None,
) -> List[RuleArrays]:
    """Survivor rule arrays from the miner's level matrices and the
    per-rank raw occurrence counts (the size-1 rule denominators);
    ``context`` and the rest as for :func:`rule_arrays_from_tables`."""
    return rule_arrays_from_tables(
        _level_tables(levels, item_counts), context=context, config=config,
        metrics=metrics, scan_state=scan_state,
    )


def _consequent_priority(freq_items: Sequence[str]) -> np.ndarray:
    """Per-rank position under the reference's consequent tie order."""
    order = sorted(
        range(len(freq_items)), key=lambda r: consequent_key(freq_items[r])
    )
    pr = np.empty(len(freq_items), dtype=np.int64)
    pr[order] = np.arange(len(freq_items))
    return pr


def sort_rule_arrays(
    survivors: Sequence[RuleArrays], freq_items: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Global recommendation priority order — ``(ant int32 [R, k_max]
    (0-padded; read lens), lens int32 [R], cons int32 [R], conf f64 [R])``
    ordered by confidence desc, consequent priority asc, original order on
    full ties (np.lexsort is stable)."""
    blocks = [s for s in survivors if len(s[1])]
    if not blocks:
        z = np.zeros(0, np.int32)
        return np.zeros((0, 1), np.int32), z, z, np.zeros(0)
    r_total = sum(len(c) for _, c, _ in blocks)
    k_max = max(a.shape[1] for a, _, _ in blocks)
    ant = np.zeros((r_total, k_max), dtype=np.int32)
    lens = np.empty(r_total, dtype=np.int32)
    cons = np.empty(r_total, dtype=np.int32)
    conf = np.empty(r_total, dtype=np.float64)
    at = 0
    for a, c, cf in blocks:
        n, w = a.shape
        ant[at : at + n, :w] = a
        lens[at : at + n] = w
        cons[at : at + n] = c
        conf[at : at + n] = cf
        at += n
    pr = _consequent_priority(freq_items)
    order = np.lexsort((pr[cons], -conf))
    return ant[order], lens[order], cons[order], conf[order]


def _rules_from_tables(
    mats: Dict[int, Tuple[np.ndarray, np.ndarray]]
) -> List[Rule]:
    out: List[Rule] = []
    for ant, cons, conf in rule_arrays_from_tables(mats):
        out.extend(
            (frozenset(a), int(c), float(cf))
            for a, c, cf in zip(ant.tolist(), cons.tolist(), conf.tolist())
        )
    return out


def gen_rules(
    freq_itemsets: Sequence[Tuple[FrozenSet[int], int]]
) -> List[Rule]:
    """Surviving rules from ``(rank frozenset, count)`` itemsets (the
    1-itemsets' counts are the size-1 denominators), grouped by size
    into sorted-row tables for the host engine."""
    by_len: Dict[int, List[Tuple[FrozenSet[int], int]]] = {}
    for s, c in freq_itemsets:
        by_len.setdefault(len(s), []).append((s, c))
    mats: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for k, entries in by_len.items():
        if k == 0:
            continue
        mat = np.fromiter(
            (r for s, _ in entries for r in sorted(s)), np.int32,
            len(entries) * k,
        ).reshape(-1, k)
        cnts = np.fromiter((c for _, c in entries), np.int64, len(entries))
        mats[k] = (mat, cnts)
    return _rules_from_tables(mats)


def gen_rules_levels(levels, item_counts) -> List[Rule]:
    """:func:`gen_rules` from the miner's level matrices and per-rank raw
    occurrence counts."""
    return _rules_from_tables(_level_tables(levels, item_counts))


def rule_objects_from_arrays(
    ant: np.ndarray, lens: np.ndarray, cons: np.ndarray, conf: np.ndarray
) -> List[Rule]:
    """The object form of (already sorted) rule arrays."""
    return [
        (frozenset(a[:n]), int(c), float(cf))
        for a, n, c, cf in zip(
            ant.tolist(), lens.tolist(), cons.tolist(), conf.tolist()
        )
    ]


def rule_arrays_from_objects(
    rules: Sequence[Rule],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The inverse of :func:`rule_objects_from_arrays`, order kept:
    ``(ant int32 [R, k_max] (0-padded, each row ascending), lens, cons,
    conf)`` as :func:`sort_rule_arrays` returns them."""
    r = len(rules)
    lens = np.fromiter((len(a) for a, _, _ in rules), np.int32, r)
    ant = np.zeros((r, max(int(lens.max()) if r else 1, 1)), np.int32)
    if r:
        rows = np.repeat(np.arange(r), lens)
        cols = np.arange(rows.size) - np.repeat(
            np.cumsum(lens) - lens, lens)
        ant[rows, cols] = np.fromiter(
            (x for a, _, _ in rules for x in sorted(a)), np.int32, rows.size)
    cons = np.fromiter((c for _, c, _ in rules), np.int32, r)
    conf = np.fromiter((cf for _, _, cf in rules), np.float64, r)
    return ant, lens, cons, conf


def sort_rules(rules: Sequence[Rule], freq_items: Sequence[str]) -> List[Rule]:
    """Recommendation priority order: confidence desc, then the
    consequent's tie order (AssociationRules.scala:116-120), original
    order on full ties."""
    return sorted(rules, key=lambda r: (-r[2], consequent_key(
        freq_items[r[1]])))
