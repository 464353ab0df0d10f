"""The device rule join and the first-match rule scan around K2
(counterpart: fastapriori_tpu/ops/contain.py ``rule_key_bits``,
``pack_rank_keys``, ``lex_searchsorted``, ``frac_less24``,
``rule_level_kernel``, ``conf_sort_keys``, ``rule_scan_build``,
``local_strided_match_scan`` and ``_strided_merge`` at one shard, plus
the table layout of fastapriori_tpu/models/recommender.py
``_rule_table_device``; reference C11 + C12, AssociationRules.scala:
88-188).

The rule join (:func:`rule_level_kernel`, one call per level) finds each
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

:func:`rule_scan_build` turns the joins' resident state into the
priority-sorted table K2 scans.  At one shard the rank-strided table is
the priority order itself: local row i holds global rank i.  The kernel
returns each basket's best rank; the consequent is selected outside it,
as ``_strided_merge`` does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fastapriori_tpu_torch.ops.bitmap import next_pow2, pad_axis
from fastapriori_tpu_torch.ops.match_kernel import NO_MATCH, first_match


# Sorted key columns of a table's padding rows: above every real key (a
# column holds at most 63 bits of ranks).
KEY_PAD = 2**63 - 1


def rule_key_bits(f: int) -> int:
    """Bits per item rank in the packed row keys (rules/gen.py
    ``_row_keys`` packs its host keys at the same widths)."""
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


def pack_bits_msb(mask: torch.Tensor) -> torch.Tensor:
    """Bool ``[C]`` (C a multiple of 8) -> uint8 ``[C // 8]``, MSB first
    (``numpy.packbits``'s layout)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=mask.device)
    return (mask.reshape(-1, 8).to(torch.int32) << shifts).sum(1).to(
        torch.uint8)


def rule_level_kernel(
    mat: torch.Tensor,  # [N_pad, k] int32 lex-sorted k-itemset rows
    cnts: torch.Tensor,  # [N_pad] int32 itemset counts (< 2^24)
    n_real: int,  # real rows (the rest is pow2 padding)
    psorted: Optional[Sequence[torch.Tensor]],  # parent sorted key columns
    porder: Optional[torch.Tensor],  # [Np_pad] parent sort order
    pcnts: torch.Tensor,  # [Np_pad] int32 (k-1)-itemset counts
    np_real: int,  # real parent rows
    prev_surv: Optional[torch.Tensor],  # [(k-1)*Np_pad] parent-rule survival
    prev_d: Optional[torch.Tensor],  # [(k-1)*Np_pad] int32 parent denominators
    *,
    k: int,
    bits: int,
    first: bool,
):
    """One level's raw rules and dominance prune, all k column deletions
    at once: each rule ``S - {S[j]} -> S[j]`` finds its antecedent's row
    in the parent table by a packed-key binary search; it survives iff
    each parent rule ``S - {S[e], S[j]} -> S[j]`` (e != j) survived with
    strictly lower confidence (AssociationRules.scala:147-182).
    ``first`` marks the k = 2 base level: the parents are the 1-itemsets,
    whose row is the rank itself (no search; pass None for the parent
    tables), and every rule survives (:173).

    Returns ``(packed, skeys, order, d_flat, surv_flat)``: ``packed``, the
    only array bound for the host, is the j-major survivor mask packed
    MSB first plus the 4-byte little-endian count of antecedents not
    found (a table that is not downward-closed); ``skeys`` and ``order``
    (this table's sorted keys, the next level's parent) and ``d_flat`` /
    ``surv_flat`` (this level's rule denominators and survival, the next
    level's prune inputs) stay on the device."""
    n_pad = mat.shape[0]
    dev = mat.device
    valid = torch.arange(n_pad, device=dev) < n_real
    if first:
        # k == 2: deleting column j leaves the other rank, which is the
        # parent row (rules/gen.py checks the ranks are in range).
        rows = torch.stack([mat[:, 1], mat[:, 0]]).long()
        found = valid[None, :].expand(k, n_pad)
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
        found = eq.reshape(k, n_pad) & valid[None, :]
        rows = porder[safe].reshape(k, n_pad)
    # count(S - {S[e]}) per deleted column e: this rule's denominator and
    # each parent rule's numerator.
    d = pcnts[rows.reshape(-1)].reshape(k, n_pad)
    miss = (valid[None, :] & ~found).sum()
    if first:
        ok = found
    else:
        oks = []
        for j in range(k):
            ok_j = found[j]
            for e in range(k):
                if e == j:
                    continue
                # The consequent's column moves down one when the
                # deleted column precedes it.
                pidx = (j - (e < j)) * np_pad + rows[e]
                ok_j = (ok_j & prev_surv[pidx]
                        & frac_less24(d[e], prev_d[pidx], cnts, d[j]))
            oks.append(ok_j)
        ok = torch.stack(oks)
    surv_flat = ok.reshape(-1)
    packed = torch.cat([
        pack_bits_msb(surv_flat),
        torch.stack([(miss >> (8 * i)) & 0xFF for i in range(4)]).to(
            torch.uint8),
    ])
    scols = [torch.where(valid, c, KEY_PAD) for c in pack_rank_keys(mat, bits)]
    order = lex_argsort(scols)
    skeys = tuple(c[order] for c in scols)
    return packed, skeys, order, d.reshape(-1), surv_flat


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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The priority-sorted rule table K2 scans, built on the device from
    the joins' resident state: each level's j-major survivors go to
    their emission slots (a cumsum over the survivor flags: the slot is
    the host pipeline's emission ordinal, np.lexsort's tie-break), each
    rule's antecedent, size, consequent, numerator and denominator come
    from the resident tables, and one sort orders the rules by
    (confidence descending through :func:`conf_sort_keys`, consequent
    priority, emission ordinal): ``sort_rule_arrays``' order.

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
    return ant[perm], size[perm], cons[perm]


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shard first-match: ``(best rank [mb], consequent or -1 [mb])``
    — K2 for the rank (``match_fn``: K2's wrapper, or its plain version
    where the caller chose it, ``FA_NO_PALLAS``), then the owner-row
    consequent select of ``_strided_merge`` at S=1 (rank == row)."""
    best = match_fn(baskets, basket_len, ant, size, consequent)
    row = best.clamp(0, ant.shape[0] - 1).long()
    found = best < NO_MATCH
    cons = torch.where(found, consequent[row], torch.full_like(best, -1))
    return best, cons
