"""The device rule join and the first-match rule scan around K2
(counterpart: fastapriori_tpu/ops/contain.py ``rule_key_bits``,
``pack_rank_keys``, ``lex_searchsorted``, ``frac_less24``,
``rule_level_kernel``, ``rule_level_shard_kernel``, ``rule_shard_bytes``,
``rule_shard_stage_bytes``, ``conf_sort_keys``, ``rule_scan_build``,
``local_strided_match_scan`` and ``_strided_merge``, plus the table
layout of fastapriori_tpu/models/recommender.py ``_rule_table_device``;
reference C11 + C12, AssociationRules.scala:88-188).

The rule join (:func:`rule_level_shard_kernel`, one call per level;
:func:`rule_level_kernel` is its one-shard form) finds each
raw rule's antecedent row in the previous level's table by a binary
search over packed row keys and runs the dominance prune as gathers into
the previous level's survival and denominator arrays, which stay on the
device; confidences are compared as exact 48-bit cross products.  The
JAX package packs keys into uint32 columns (its x64 is off); here each
int64 column holds ``63 // bits`` ranks, so every key is non-negative
and signed order is the unsigned lexicographic row order.  Nothing in a
join waits for the device: the row counts are host integers and every
index is in range by construction (clamped where the JAX package relies
on ``take``'s clamping).

Over S transaction shards each shard joins its block of the query rows
against the parent state every shard holds, and the survivor masks, the
denominators and the table cross the shards through parallel/mesh.py
(flat or two-level).

:func:`rule_scan_build` turns the joins' resident state into the
priority-sorted table K2 scans, rank-strided over S shards: shard s's
slice holds the ranks ``i·S + s`` (at one shard, the priority order
itself).  K2 returns each basket's best global rank on one shard's
slice; the consequent is selected outside it and the shards' minima
merge as ``_strided_merge`` does (:func:`strided_merge`).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fastapriori_tpu_torch.ops.bitmap import next_pow2, pad_axis
from fastapriori_tpu_torch.ops.count import pack_bits_msb, unpack_bits_msb
from fastapriori_tpu_torch.ops.match_kernel import NO_MATCH, first_match
from fastapriori_tpu_torch.parallel import hier, mesh


# Sorted key columns of a table's padding rows: above every real key (a
# column holds at most 63 bits of ranks).
KEY_PAD = 2**63 - 1


def rule_key_bits(f: int) -> int:
    """Bits per item rank in the device rule engine's packed row keys
    (:func:`pack_rank_keys`)."""
    return 8 if f <= 256 else (16 if f <= 65536 else 32)


def pack_rank_keys(mat: torch.Tensor, bits: int) -> List[torch.Tensor]:
    """Pack int32 ``[N, w]`` sorted-row ranks into ``ceil(w / (63 //
    bits))`` int64 key columns, left-aligned, so that lexicographic order
    over the column tuple is lexicographic row order."""
    per = 63 // bits
    m = mat.long()
    cols = []
    for c0 in range(0, mat.shape[1], per):
        acc = None
        for j in range(c0, min(c0 + per, mat.shape[1])):
            part = m[:, j] << ((per - 1 - (j - c0)) * bits)
            acc = part if acc is None else acc | part
        cols.append(acc)
    return cols


def lex_argsort(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """The permutation that sorts rows by the key columns
    lexicographically, ties in row order (stable sorts from the last
    column to the first: the JAX package's trailing-iota ``lax.sort``)."""
    order = None
    for c in reversed(cols):
        key = c if order is None else c[order]
        idx = torch.sort(key, stable=True).indices
        order = idx if order is None else order[idx]
    return order


def lex_searchsorted(
    sorted_cols: Sequence[torch.Tensor],
    n_real: int,
    query_cols: Sequence[torch.Tensor],
    n_iters: int,
) -> torch.Tensor:
    """Left insertion point of each query row among the first ``n_real``
    rows of a lexicographically sorted key table.  One column: the
    library's binary search (the padding rows hold :data:`KEY_PAD`, above
    every query, so the bound holds by itself).  More: a vectorised
    binary search of ``n_iters`` gather-and-compare rounds over all
    queries at once."""
    if len(sorted_cols) == 1:
        return torch.searchsorted(sorted_cols[0], query_cols[0])
    m = query_cols[0].shape[0]
    dev = query_cols[0].device
    top = max(sorted_cols[0].shape[0] - 1, 0)
    lo = torch.zeros(m, dtype=torch.int64, device=dev)
    hi = torch.full((m,), n_real, dtype=torch.int64, device=dev)
    for _ in range(n_iters):
        # A finished query (lo == hi) may point one past the table;
        # clamp so its (unused) gather stays in range.
        mid = ((lo + hi) // 2).clamp_(max=top)
        lt = torch.zeros(m, dtype=torch.bool, device=dev)
        eq = torch.ones(m, dtype=torch.bool, device=dev)
        for sc, qc in zip(sorted_cols, query_cols):
            v = sc[mid]
            lt |= eq & (v < qc)
            eq &= v == qc
        active = lo < hi
        lo = torch.where(active & lt, mid + 1, lo)
        hi = torch.where(active & ~lt, mid, hi)
    return lo


def frac_less24(pn, pd, cn, cd) -> torch.Tensor:
    """``pn/pd < cn/cd`` for positive counts < 2^24, exactly as the
    host's float64 comparison orders them: two distinct such fractions
    in (0, 1] differ by more than 2^-48 and doubles there are spaced at
    most 2^-53 apart, so the double order is the rational order, and the
    48-bit cross products compare it exactly in int64."""
    return pn.long() * cd.long() < cn.long() * pd.long()


def _join_prune(mat, cnts, valid, psorted, porder, pcnts, np_real,
                prev_surv, prev_d, *, k, bits, first):
    """The join and prune of the query rows ``mat`` (``valid`` marks the
    real ones) against the parent state: ``(d [k, N], miss, ok [k, N])``,
    each rule's denominator, the count of antecedents not found and the
    survivor flags (see :func:`rule_level_kernel`)."""
    n = mat.shape[0]
    if first:
        # k == 2: deleting column j leaves the other rank, which is the
        # parent row (rules/gen.py checks the ranks are in range).
        rows = torch.stack([mat[:, 1], mat[:, 0]]).long()
        found = valid[None, :].expand(k, n)
    else:
        np_pad = porder.shape[0]
        dels = [torch.cat([mat[:, :j], mat[:, j + 1 :]], dim=1)
                for j in range(k)]
        packed_q = [pack_rank_keys(d, bits) for d in dels]
        flat_q = [torch.cat([packed_q[j][ci] for j in range(k)])
                  for ci in range(len(packed_q[0]))]
        pos = lex_searchsorted(psorted, np_real, flat_q,
                               np_pad.bit_length() + 1)
        safe = pos.clamp(0, max(np_real - 1, 0))
        eq = pos < np_real
        for sc, qc in zip(psorted, flat_q):
            eq &= sc[safe] == qc
        found = eq.reshape(k, n) & valid[None, :]
        rows = porder[safe].reshape(k, n)
    # count(S - {S[e]}) per deleted column e: this rule's denominator and
    # each parent rule's numerator.
    d = pcnts[rows.reshape(-1)].reshape(k, n)
    miss = (valid[None, :] & ~found).sum()
    if first:
        return d, miss, found
    np_pad = porder.shape[0]
    oks = []
    for j in range(k):
        ok_j = found[j]
        for e in range(k):
            if e == j:
                continue
            # The consequent's column moves down one when the deleted
            # column precedes it.
            pidx = (j - (e < j)) * np_pad + rows[e]
            ok_j = (ok_j & prev_surv[pidx]
                    & frac_less24(d[e], prev_d[pidx], cnts, d[j]))
        oks.append(ok_j)
    return d, miss, torch.stack(oks)


def _pack_survivors(ok_flat: torch.Tensor, miss: torch.Tensor):
    """The host-bound array of a join: the survivor mask packed MSB
    first, then the miss count as 4 little-endian bytes."""
    return torch.cat([
        pack_bits_msb(ok_flat),
        torch.stack([(miss >> (8 * i)) & 0xFF for i in range(4)]).to(
            torch.uint8),
    ])


def _sorted_keys(mat: torch.Tensor, n_real: int, bits: int):
    """``(skeys, order)``: the sorted key columns of a table (its
    padding rows at :data:`KEY_PAD`, last) and the sorting order, the
    next level's parent state."""
    valid = torch.arange(mat.shape[0], device=mat.device) < n_real
    scols = [torch.where(valid, c, KEY_PAD) for c in pack_rank_keys(mat, bits)]
    order = lex_argsort(scols)
    return tuple(c[order] for c in scols), order


def rule_level_shard_kernel(
    mats: Sequence[torch.Tensor],  # per shard: [N_loc, k] int32 row block
    cnts: Sequence[torch.Tensor],  # per shard: [N_loc] int32 counts
    n_real: int,  # real rows (the rest is padding)
    psorted: Sequence[Optional[Sequence[torch.Tensor]]],  # per shard
    porder: Sequence[Optional[torch.Tensor]],  # per shard
    pcnts: Sequence[torch.Tensor],  # per shard
    np_real: int,  # real parent rows
    prev_surv: Sequence[Optional[torch.Tensor]],  # per shard
    prev_d: Sequence[Optional[torch.Tensor]],  # per shard
    *,
    k: int,
    bits: int,
    first: bool,
    spec: hier.GroupSpec = None,
):
    """One level's raw rules and dominance prune over S transaction
    shards, all k column deletions at once: each rule
    ``S - {S[j]} -> S[j]`` finds its antecedent's row in the parent table
    by a packed-key binary search; it survives iff each parent rule
    ``S - {S[e], S[j]} -> S[j]`` (e != j) survived with strictly lower
    confidence (AssociationRules.scala:147-182).  ``first`` marks the
    k = 2 base level: the parents are the 1-itemsets, whose row is the
    rank itself (no search; pass None for the parent tables), and every
    rule survives (:173).

    Shard s joins and prunes its block of ``N_loc`` query rows (global
    rows ``s·N_loc`` on, ``N_loc`` a multiple of 8) against the parent
    state it holds (each argument after ``n_real`` is a per-shard list of
    copies of one value); then the per-shard survivor blocks cross the
    shards bit-packed (they concatenate into the j-major mask of the
    whole table), the denominators as int32, the miss counts by a psum,
    and the table itself once, whose sort for the next level runs on the
    gathered table.  Every movement goes through parallel/mesh.py, flat
    or, with ``spec``, two-level, and stays inside the process (a
    world's ranks each join alone: rules/gen.py ``resolve_rule_shards``).
    One shard is the one-device join: its gathers are the block itself.

    Returns ``(packed, skeys, order, d_flat, surv_flat, mat_full,
    cnts_full)``, all on shard 0's device: ``packed``, the only array
    bound for the host, is the j-major survivor mask packed MSB first
    plus the 4-byte little-endian count of antecedents not found (a table
    that is not downward-closed); ``skeys`` and ``order`` (the table's
    sorted keys, the next level's parent), ``d_flat`` / ``surv_flat``
    (this level's rule denominators and survival, the next level's prune
    inputs) and the gathered table ``(mat_full, cnts_full)`` stay on the
    device (the caller copies what the next level needs to the other
    shards)."""
    n_loc = mats[0].shape[0]
    oks, ds, misses = [], [], []
    for s, (mat, cnt) in enumerate(zip(mats, cnts)):
        valid = (torch.arange(n_loc, device=mat.device) + s * n_loc) < n_real
        d, miss, ok = _join_prune(mat, cnt, valid, psorted[s], porder[s],
                                  pcnts[s], np_real, prev_surv[s], prev_d[s],
                                  k=k, bits=bits, first=first)
        oks.append(pack_bits_msb(ok.reshape(-1)).reshape(k, n_loc // 8))
        ds.append(d)
        misses.append(miss.reshape(1))
    gather = functools.partial(mesh.tiled_all_gather, spec=spec, local=True)
    packed_full = gather(oks, axis=1)
    d_full = gather(ds, axis=1)
    miss = mesh.psum(misses, spec=spec, local=True)[0]
    mat_full = gather(list(mats), axis=0)
    cnts_full = gather(list(cnts), axis=0)
    surv_flat = unpack_bits_msb(packed_full.reshape(-1))
    skeys, order = _sorted_keys(mat_full, n_real, bits)
    return (_pack_survivors(surv_flat, miss), skeys, order,
            d_full.reshape(-1), surv_flat, mat_full, cnts_full)


def rule_level_kernel(mat, cnts, n_real, psorted, porder, pcnts, np_real,
                      prev_surv, prev_d, *, k, bits, first):
    """The one-device join: :func:`rule_level_shard_kernel` at one shard
    (``mat`` ``[N_pad, k]``, ``N_pad`` a multiple of 8), returning
    ``(packed, skeys, order, d_flat, surv_flat)``."""
    return rule_level_shard_kernel(
        [mat], [cnts], n_real, [psorted], [porder], [pcnts], np_real,
        [prev_surv], [prev_d], k=k, bits=bits, first=first)[:5]


def rule_shard_bytes(k: int, n_pad: int, n_shards: int,
                     groups: hier.GroupSpec = None) -> Tuple[int, int]:
    """``(gather_bytes, psum_bytes)`` of one sharded join (the JAX
    package's payload model): the packed survivor mask, the denominators
    and the table (rows and counts) reach every shard, ``S x`` their
    payload, whatever the topology; the miss count is one int32 psum."""
    mask_b = k * (n_pad // 8)
    den_b = 4 * k * n_pad
    table_b = 4 * n_pad * k + 4 * n_pad
    return n_shards * (mask_b + den_b + table_b), 4 * n_shards


def rule_shard_stage_bytes(k: int, n_pad: int, n_shards: int,
                           groups: hier.GroupSpec = None
                           ) -> Tuple[int, int, int]:
    """Per shard ``(intra_bytes, inter_bytes, inter_msgs)`` of
    :func:`rule_shard_bytes`' gather: flat, every block on the one tier
    in ``3·(S - 1)`` messages; two-level, the group chunks assemble
    inside the groups first and the inter tier moves ``groups`` chunks in
    ``3·(groups - 1)`` messages."""
    per_shard = (k * (n_pad // 8) + 4 * k * n_pad + 4 * n_pad * k
                 + 4 * n_pad) // n_shards
    intra, inter = hier.gather_stage_bytes(per_shard, n_shards, groups)
    msgs = 3 * ((groups[0] if groups else n_shards) - 1)
    return intra, inter, msgs


def conf_sort_keys(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """The exact 49-bit order key ``floor(num · 2^48 / den)`` of the
    confidence ``num/den`` (positive counts < 2^24, num <= den) by long
    division in int64: the integer part, then two 24-bit digits (each
    ``r << 24`` < 2^48).  Distinct such fractions differ by more than
    2^-48, so their keys differ and the key order is the host's float64
    order (the :func:`frac_less24` argument); the JAX package returns the
    same bits as a (hi, lo) uint32 pair, ``key = hi << 24 | lo``."""
    n = num.long()
    d = den.long().clamp(min=1)
    q0 = n // d
    r = (n - q0 * d) << 24
    q1 = r // d
    r = (r - q1 * d) << 24
    return (q0 << 48) | (q1 << 24) | (r // d)


def rule_scan_build(
    level_arrays,  # per level: (mat, cnts, d_flat, surv_flat) on the device
    offsets: Sequence[int],  # emission offset of each level's survivors
    pr: torch.Tensor,  # [F] int32 consequent tie priority per rank
    *,
    ks: Sequence[int],
    r_pad: int,
    k_max: int,
    zcol: int,
    n_shards: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The priority-sorted rule table K2 scans, built on the device from
    the joins' resident state: each level's j-major survivors go to
    their emission slots (a cumsum over the survivor flags: the slot is
    the host pipeline's emission ordinal, np.lexsort's tie-break), each
    rule's antecedent, size, consequent, numerator and denominator come
    from the resident tables, and one sort orders the rules by
    (confidence descending through :func:`conf_sort_keys`, consequent
    priority, emission ordinal): ``sort_rule_arrays``' order.  The table
    comes out shard-major and rank-strided over ``n_shards``: row
    ``s·R/S + i`` holds sorted rank ``i·S + s``, so slice s
    (:func:`strided_slices`) is what shard s scans (``r_pad`` a multiple
    of ``n_shards``; at one shard, the sorted order itself).

    Returns ``(ant int32 [r_pad, k_max], size int32 [r_pad], consequent
    int32 [r_pad])``: antecedent padding at column ``zcol``, padding
    rules of size ``zcol + 2`` (above any basket length) and consequent
    0, sorted after every rule.  Non-survivors are written to one spare
    row past ``r_pad``, which is cut off (the JAX package drops them as
    out-of-range scatters)."""
    dev = pr.device
    ant = torch.full((r_pad + 1, k_max), zcol, dtype=torch.int32, device=dev)
    size = torch.full((r_pad + 1,), zcol + 2, dtype=torch.int32, device=dev)
    cons = torch.zeros(r_pad + 1, dtype=torch.int32, device=dev)
    num = torch.zeros(r_pad + 1, dtype=torch.int64, device=dev)
    den = torch.ones(r_pad + 1, dtype=torch.int64, device=dev)
    for off, k, (mat, cnts, d_flat, surv) in zip(offsets, ks, level_arrays):
        n_pad = mat.shape[0]
        slot = torch.where(surv, off + torch.cumsum(surv, 0) - 1, r_pad)
        flat = torch.arange(k * n_pad, device=dev)
        j, rr = flat // n_pad, flat % n_pad
        ccols = torch.arange(k - 1, device=dev)
        gcols = ccols[None, :] + (ccols[None, :] >= j[:, None]).long()
        ant[slot, : k - 1] = mat[rr[:, None], gcols]
        size[slot] = k - 1
        cons[slot] = mat[rr, j]
        num[slot] = cnts[rr].long()
        den[slot] = d_flat.long()
    ant, size, cons = ant[:r_pad], size[:r_pad], cons[:r_pad]
    # Padding rows (0/1) get key 0, below every real key (>= 2^24), so
    # they sort last; the secondary key (priority, ordinal) is unique.
    desc = (1 << 48) - conf_sort_keys(num[:r_pad], den[:r_pad])
    second = pr[cons].long() * r_pad + torch.arange(r_pad, device=dev)
    perm = lex_argsort([desc, second])
    if n_shards > 1:
        # Shard-major rank interleave: out[s·R/S + i] = sorted[i·S + s].
        perm = perm.reshape(r_pad // n_shards, n_shards).T.reshape(-1)
    return ant[perm], size[perm], cons[perm]


def strided_slices(table: Sequence[torch.Tensor], n_shards: int):
    """Shard s's ``R/S`` rows of each tensor of a rank-strided table, in
    shard order: ``[(ant, size, consequent), ...]`` views."""
    r_loc = table[0].shape[0] // n_shards
    return [tuple(x[s * r_loc : (s + 1) * r_loc] for x in table)
            for s in range(n_shards)]


def rule_table(
    ant0: np.ndarray,  # [R, k_max] int32, 0-padded (read lens)
    lens: np.ndarray,  # [R] antecedent sizes
    cons: np.ndarray,  # [R] consequent ranks
    num_items: int,
    f_pad: int,
    rule_chunk: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padded device layout of the priority-sorted rules: ``(ant int32
    [R_pad, k_max], size int32 [R_pad], consequent int32 [R_pad])``.
    Antecedent padding positions point at the all-zero basket column
    ``f_pad - 1``; padding rules have size ``num_items + 1`` (> any basket
    length) and consequent 0.  R_pad is a power-of-two number of
    ``chunk``-row chunks, the chunk scaled so a full table walk is about
    256 chunks (the reference package's bucketing)."""
    r = len(cons)
    chunk = min(next_pow2(max(1, rule_chunk, -(-r // 256))), 1 << 16)
    chunk = pad_axis(chunk, 128)
    r_pad = chunk * next_pow2(max(-(-r // chunk), 1))
    k_max = ant0.shape[1] if r else 1
    ant = np.full((r_pad, k_max), f_pad - 1, dtype=np.int32)
    if r > 0:
        mask = np.arange(k_max)[None, :] < lens[:, None]
        ant[:r][mask] = ant0[mask]
    size = np.full(r_pad, num_items + 1, dtype=np.int32)
    size[:r] = lens
    consequent = np.zeros(r_pad, dtype=np.int32)
    consequent[:r] = cons
    return ant, size, consequent


def strided_match_scan(
    baskets: torch.Tensor,  # [mb, F] int8 micro-batch
    basket_len: torch.Tensor,  # [mb] int32 (0 on padding rows)
    ant: torch.Tensor,  # [R, K] int32
    size: torch.Tensor,  # [R] int32
    consequent: torch.Tensor,  # [R] int32
    match_fn=first_match,
    shard: int = 0,
    n_shards: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First match on one shard's slice of a rank-strided table (row r =
    global rank ``r·n_shards + shard``; the whole table at one shard):
    ``(best global rank [mb], its consequent or -1 [mb])`` — K2 for the
    rank (``match_fn``: K2's wrapper, or its plain version where the
    caller chose it, ``FA_NO_PALLAS``), then the owner-row consequent
    select of ``_strided_merge``."""
    # One shard: K2's default stride (rank == row).
    stride = {"shard": shard, "n_shards": n_shards} if n_shards > 1 else {}
    best = match_fn(baskets, basket_len, ant, size, consequent, **stride)
    row = ((best - shard) // n_shards).clamp(0, ant.shape[0] - 1).long()
    found = best < NO_MATCH
    cons = torch.where(found, consequent[row], torch.full_like(best, -1))
    return best, cons


def strided_merge(bests: Sequence[torch.Tensor],
                  conss: Sequence[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-shard merge of ``_strided_merge``: the smallest global
    rank over the shards, then the consequent of the one shard that owns
    it (ranks are unique across shards, so a masked maximum selects it
    exactly), both on shard 0's device, through parallel/mesh.py's
    ``all_gather``."""
    if len(bests) == 1:
        return bests[0], conss[0]
    best_g = mesh.all_gather(bests).min(dim=0).values
    owned = [torch.where(b == best_g.to(b.device, non_blocking=True), c,
                         torch.full_like(c, -1))
             for b, c in zip(bests, conss)]
    return best_g, mesh.all_gather(owned).max(dim=0).values


def local_strided_match_scan(
    baskets: Sequence[torch.Tensor],  # per shard: the [mb, F] micro-batch
    basket_len: Sequence[torch.Tensor],  # per shard: [mb] int32
    tables: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    match_fn=first_match,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded first match over a rank-strided table: every shard
    scans the whole micro-batch (replicated) against its ``R/S`` rows
    with K2 at ``shard = s``, then :func:`strided_merge`.  Returns
    ``(best global rank [mb], consequent or -1 [mb])`` on shard 0's
    device."""
    n = len(tables)
    bests, conss = [], []
    for s, (bm, bl, (ant, size, cons)) in enumerate(
            zip(baskets, basket_len, tables)):
        b, c = strided_match_scan(bm, bl, ant, size, cons, match_fn,
                                  shard=s, n_shards=n)
        bests.append(b)
        conss.append(c)
    return strided_merge(bests, conss)
