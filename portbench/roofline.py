"""The least time the card could take for the work a cell asks for, from
the problem and never from the program: the reference's own per-level
candidates and contained (prefix, basket) pairs, and its first-match
positions.  Each input byte is read once and each output byte written
once; the operations run at the card's published peak.

Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W: HBM 3.35 TB/s, int8
1,979 TOP/s.  The counting work is charged as the int8 product it is in
the port's K1 form (2 F operations per contained pair), which is the
least of the port's designs (K3's ANDs and popcounts over transaction
lanes come to more), so a share stays a lower bound of how close the
card came.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def least_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS_PER_S)


def count_least_s(mined) -> float:
    """One mine's counting work, level by level (each level waits for the
    one before): the distinct baskets as bitsets and their multiplicities
    read, each candidate's items read and its count written; 2 F
    operations per contained (prefix, basket) pair."""
    f = mined.n_freq
    nb = mined.n_baskets
    total = 0.0
    for w in mined.work:
        n_bytes = nb * -(-f // 8) + 4 * nb + w["candidates"] * (4 * w["k"] + 4)
        total += least_s(n_bytes, 2.0 * f * w["pairs"])
    return total


def rule_bytes(rules) -> float:
    """The rule table: each antecedent item and the consequent, 4 bytes."""
    return 4.0 * (float((rules.ant >= 0).sum()) + len(rules))


def scanned(ref) -> np.ndarray:
    """Rules a first match reads for each distinct basket that holds a
    frequent item: up to its first match, or all of them."""
    n = len(ref.rules)
    return np.where(ref.first_pos < n, ref.first_pos + 1, n)


def scan_least_s(ref) -> float:
    """First-match work: each distinct basket's bitset read and its answer
    written, the rule table read once, 2 F operations per rule scanned."""
    f = ref.mined.n_freq
    per = scanned(ref)
    n, work = per.size, float(per.sum())
    n_bytes = n * (-(-f // 8) + 4) + rule_bytes(ref.rules)
    return least_s(n_bytes, 2.0 * f * work)
