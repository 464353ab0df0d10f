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
so the comparisons agree bit for bit with the reference.  The device
rule join of the reference package is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.utils.order import consequent_key

RuleArrays = Tuple[np.ndarray, np.ndarray, np.ndarray]  # ant [N,w], cons, conf


def _rows_view(m: np.ndarray) -> np.ndarray:
    """View an int32 [N, K] matrix as N comparable composite scalars."""
    m = np.ascontiguousarray(m)
    return m.view([("", m.dtype)] * m.shape[1]).ravel()


def _row_keys(m: np.ndarray, f: int) -> np.ndarray:
    """Sortable scalar key per row, ordered like lexicographic row order:
    packed into uint64 when the row fits 8 bytes at the item-axis byte
    width, else the structured-view fallback."""
    n, w = m.shape
    bits = 8 if f <= 256 else (16 if f <= 65536 else 32)
    if w * bits > 64:
        return _rows_view(m)
    shifts = ((w - 1 - np.arange(w, dtype=np.uint64)) * np.uint64(bits))
    return np.bitwise_or.reduce(
        m.astype(np.uint64) << shifts[None, :], axis=1
    )


def _deleted_row_keys(m: np.ndarray, f: int) -> Optional[np.ndarray]:
    """``out[:, e] == _row_keys(np.delete(m, e, axis=1), f)`` for every
    column e, in O(k) array passes: deleting column e shifts the packed
    fields before it down one slot and keeps the fields after it.  None
    when the (k-1)-wide rows don't fit uint64."""
    n, k = m.shape
    bits = 8 if f <= 256 else (16 if f <= 65536 else 32)
    if (k - 1) * bits > 64 or k < 2:
        return None
    b = np.uint64(bits)
    mu = m.astype(np.uint64)
    j = np.arange(k, dtype=np.uint64)
    a = mu[:, : k - 1] << ((np.uint64(k - 2) - j[: k - 1]) * b)[None, :]
    out = np.zeros((n, k), dtype=np.uint64)
    np.cumsum(a, axis=1, out=out[:, 1:])
    np.multiply(
        mu[:, 1:],
        np.uint64(1) << (((np.uint64(k - 1) - j[1:]) * b))[None, :],
        out=a,
    )
    del mu
    out[:, : k - 1] += np.cumsum(a[:, ::-1], axis=1)[:, ::-1]
    return out


def _lookup_rows(
    sorted_keys: np.ndarray, order: np.ndarray, keys: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(position-in-original-order, found) for each key row."""
    pos = np.searchsorted(sorted_keys, keys)
    found = np.zeros(len(keys), dtype=bool)
    inb = pos < len(sorted_keys)
    found[inb] = sorted_keys[pos[inb]] == keys[inb]
    safe = np.minimum(pos, max(len(sorted_keys) - 1, 0))
    return (order[safe] if len(order) else safe), found


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


def _rule_arrays_host(
    mats: Dict[int, Tuple[np.ndarray, np.ndarray]]
) -> List[RuleArrays]:
    """Raw rule generation + dominance prune over the size-grouped tables;
    survivors per antecedent size as ``(ant int32 [N, w], cons int32 [N],
    conf f64 [N])``."""
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
    for k in sorted(mats):
        if k < 2:
            continue
        if k - 1 not in mats:
            raise InputError(
                f"itemset table is not downward-closed: {k}-itemsets are "
                f"present but no {k - 1}-itemsets exist to serve as rule "
                "antecedents — the mining output is incomplete"
            )
        mat, cnts = mats[k]
        pmat, pcnts = mats[k - 1]
        n_sets[k] = mat.shape[0]
        n_sets[k - 1] = pmat.shape[0]
        pview = _row_keys(pmat, f)
        porder = np.argsort(pview)
        psorted = pview[porder]
        ants, conss, confs = [], [], []
        rows_e = np.empty((k, mat.shape[0]), dtype=np.int32)
        dk = _deleted_row_keys(mat, f)  # [N, k] or None (wide rows)
        for j in range(k):
            ant = np.delete(mat, j, axis=1)  # sorted rows stay sorted
            keys = dk[:, j] if dk is not None else _row_keys(ant, f)
            idx, found = _lookup_rows(psorted, porder, keys)
            if not found.all():
                bad = ant[int(np.argmin(found))].tolist()
                raise InputError(
                    f"itemset table is not downward-closed: antecedent "
                    f"{sorted(bad)} (ranks) of a {k}-itemset is missing "
                    "from the table — the mining output is incomplete"
                )
            ants.append(ant)
            conss.append(mat[:, j])
            confs.append(cnts / pcnts[idx].astype(np.float64))
            rows_e[j] = idx
        raw[k - 1] = (
            np.concatenate(ants),
            np.concatenate(conss),
            np.concatenate(confs),
        )
        parent_rows[k] = rows_e

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


def gen_rule_arrays_levels(levels, item_counts) -> List[RuleArrays]:
    """Survivor rule arrays from the miner's level matrices and the
    per-rank raw occurrence counts (the size-1 rule denominators)."""
    return _rule_arrays_host(_level_tables(levels, item_counts))


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
