"""Plain NumPy reference of the batch job: Apriori, the rule join with its
dominance prune, the priority sort and the first-match recommendation,
writing ``freqItemset`` and ``recommends`` in the CLI's byte format.

It follows the reference system's semantics (FastApriori.scala,
AssociationRules.scala, Utils.scala) as the repository's pure-Python
oracle states them, vectorised so that it runs at the benchmark's sizes:

- min count ``ceil(min_support * N)`` in double precision; item counts
  count every occurrence; ranks by count descending, ties by the item's
  integer value;
- transactions reduced to their frequent items, those of one item or
  none dropped, identical ones merged with their multiplicity;
- level k's candidates: a frequent (k-1)-itemset extended by a larger
  item such that every (k-1)-subset is frequent; a candidate is frequent
  at ``support >= min count``;
- a rule per frequent itemset (k >= 2) and item, confidence
  ``count / count(antecedent)`` in float64 (Java's double); a rule of antecedent size i >= 2 survives when every rule
  with one antecedent item fewer and the same consequent survived and
  has a strictly lower confidence;
- rules ordered by confidence descending, then the consequent's integer
  value ascending; a basket's recommendation is the consequent of the
  first rule whose antecedent it holds and whose consequent it lacks,
  else ``0``; a basket with no frequent item gets ``0``.

It imports nothing but NumPy and takes only the input files.
``precision`` below ``"float64"`` gives the controls: the same work with
the confidences computed in float32 or bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

_DIGIT0, _SPACE, _NL = 48, 32, 10


def parse_dat(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """``*.dat`` bytes as (flat item ids, items per line).  Accepts the
    benchmark's own format only: positive integer tokens without leading
    zeros, one space between tokens, one newline after every line, no
    empty line."""
    b = np.frombuffer(data, dtype=np.uint8)
    if b.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    digit = (b >= _DIGIT0) & (b <= _DIGIT0 + 9)
    sep = (b == _SPACE) | (b == _NL)
    if not np.all(digit | sep) or b[-1] != _NL:
        raise ValueError("input holds bytes other than digits, one space "
                         "and newline, or lacks its last newline")
    # A separator follows a digit, and a digit starts the file and follows
    # each separator: no empty token, no empty line.
    if not digit[0] or np.any(sep[1:] & sep[:-1]):
        raise ValueError("input has an empty token or an empty line")
    start = np.flatnonzero(digit & np.concatenate([[True], sep[:-1]]))
    end = np.flatnonzero(sep)  # one past each token's last digit
    if np.any(b[start] == _DIGIT0):
        raise ValueError("input has a token with a leading zero")
    ndig = end - start
    if ndig.max() > 15:
        raise ValueError("input has a token of more than 15 digits")
    vals = np.zeros(start.size, dtype=np.int64)
    for d in range(int(ndig.max())):
        has = ndig > d
        vals[has] = vals[has] * 10 + (b[start[has] + d] - _DIGIT0)
    line_end = b[end] == _NL
    tok_line = np.concatenate([[0], np.cumsum(line_end)[:-1]])
    lens = np.bincount(tok_line, minlength=int(line_end.sum()))
    return vals, lens


def _bitsets(flat: np.ndarray, lens: np.ndarray, rank: np.ndarray,
             words: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each line's set of frequent items (``rank`` >= 0) as a bitset over
    ranks, and the set's size."""
    n = int(lens.shape[0])
    row = np.repeat(np.arange(n, dtype=np.int64), lens)
    r = rank[flat]
    keep = r >= 0
    key = np.unique(row[keep] * np.int64(64 * words) + r[keep])
    row, r = key // (64 * words), key % (64 * words)
    size = np.bincount(row, minlength=n)
    # A set's bits are distinct, so OR is a sum: per 32-bit half, exact in
    # float64.
    slot = row * words + r // 64
    bit = r % 64
    halves = []
    for lo in (0, 32):
        sel = (bit >= lo) & (bit < lo + 32)
        halves.append(np.bincount(
            slot[sel], weights=np.ldexp(1.0, (bit[sel] - lo).astype(np.int32)),
            minlength=n * words).astype(np.uint64))
    bits = (halves[0] | (halves[1] << np.uint64(32))).reshape(n, words)
    return bits, size


def _rows_void(a: np.ndarray) -> np.ndarray:
    """Rows of a 2-D int array as one opaque value each (equality and a
    consistent order, for sort and search)."""
    a = np.ascontiguousarray(a)
    return a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1]))).ravel()


def _lookup(table: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Index of each row of ``keys`` in the rows of ``table`` (both 2-D,
    one dtype), -1 where absent."""
    if table.shape[0] == 0:
        return np.full(keys.shape[0], -1, np.int64)
    tv, kv = _rows_void(table), _rows_void(keys)
    order = np.argsort(tv, kind="stable")
    pos = np.searchsorted(tv[order], kv)
    pos = np.minimum(pos, table.shape[0] - 1)
    hit = tv[order][pos] == kv
    return np.where(hit, order[pos], -1)


class Mined:
    """What the mine gives the rules and the recommender: frequent items
    (ids, in rank order), per level the itemsets as ascending rank rows
    with their counts, and the work it took."""

    def __init__(self):
        self.n_txns = 0
        self.min_count = 0
        self.items: np.ndarray = np.zeros(0, np.int64)
        self.item_counts: np.ndarray = np.zeros(0, np.int64)
        self.levels: List[Tuple[np.ndarray, np.ndarray]] = []
        # Per level k >= 2: candidates, and contained (prefix, distinct
        # basket) pairs of the prefixes that have candidates.
        self.work: List[dict] = []
        self.n_baskets = 0

    @property
    def n_freq(self) -> int:
        return int(self.items.shape[0])


def mine(flat: np.ndarray, lens: np.ndarray, min_support: float) -> Mined:
    """Frequent itemsets of the transactions ``(flat, lens)``."""
    out = Mined()
    n = int(lens.shape[0])
    out.n_txns = n
    out.min_count = math.ceil(min_support * n)
    counts = np.bincount(flat) if flat.size else np.zeros(1, np.int64)
    ids = np.flatnonzero(counts >= out.min_count)
    ids = ids[counts[ids] > 0]
    ids = ids[np.lexsort((ids, -counts[ids]))]
    out.items, out.item_counts = ids, counts[ids]
    f = ids.shape[0]
    if f < 2:
        return out
    rank = np.full(counts.shape[0], -1, np.int64)
    rank[ids] = np.arange(f)
    # Transactions as bitsets of their frequent items, merged when equal.
    words = -(-f // 64)
    bits, size = _bitsets(flat, lens, rank, words)
    bits = bits[size > 1]
    uniq, weight = np.unique(bits, axis=0, return_counts=True)
    weight = weight.astype(np.int64)
    out.n_baskets = int(uniq.shape[0])
    # Each item's distinct baskets as bitsets, split by multiplicity: the
    # baskets seen once (a popcount counts them) and the rest, whose
    # multiplicities are summed by bit plane.
    member = np.zeros((f, uniq.shape[0]), dtype=bool)
    for w in range(words):
        word = uniq[:, w]
        for j in range(min(64, f - 64 * w)):
            member[64 * w + j] = (word >> np.uint64(j)) & np.uint64(1)
    once = weight == 1
    item_once = _pack(member[:, once])
    item_more = _pack(member[:, ~once])
    w_more = weight[~once]
    planes = _pack(np.stack([(w_more >> j) & 1 == 1 for j in range(
        int(w_more.max(initial=1)).bit_length())]))
    plane_value = np.int64(1) << np.arange(planes.shape[0], dtype=np.int64)
    del member
    prefixes = np.arange(f, dtype=np.int64)[:, None]
    sets = (item_once, item_more)
    k = 2
    while True:
        exts = _extensions(prefixes)
        rows_out, cnt_out, once_out, more_out = [], [], [], []
        n_cand, pairs = 0, 0
        for g in range(prefixes.shape[0]):
            ext = exts[g]
            if ext.size == 0:
                continue
            n_cand += ext.size
            pairs += _popcount(sets[0][g]) + _popcount(sets[1][g])
            a1 = sets[0][g][None, :] & item_once[ext]
            am = sets[1][g][None, :] & item_more[ext]
            c = _popcount(a1, axis=1) + _popcount(
                am[:, None, :] & planes[None, :, :], axis=2) @ plane_value
            hit = np.flatnonzero(c >= out.min_count)
            if hit.size == 0:
                continue
            rows_out.append(np.concatenate([
                np.repeat(prefixes[g][None, :], hit.size, axis=0),
                ext[hit][:, None]], axis=1))
            cnt_out.append(c[hit])
            once_out.append(a1[hit])
            more_out.append(am[hit])
        out.work.append({"k": k, "candidates": n_cand, "pairs": pairs})
        if not rows_out:
            break
        level = np.concatenate(rows_out)
        out.levels.append((level, np.concatenate(cnt_out)))
        if level.shape[0] < k + 1:
            break  # the reference stops once fewer than k + 1 itemsets
        prefixes = level
        sets = (np.concatenate(once_out), np.concatenate(more_out))
        k += 1
    return out


def _pack(rows: np.ndarray) -> np.ndarray:
    """Bool rows as bitsets of uint64 words (zero padded)."""
    packed = np.packbits(rows, axis=1, bitorder="little")
    pad = (-packed.shape[1]) % 8
    if pad or packed.shape[1] == 0:
        packed = np.pad(packed, ((0, 0), (0, pad or 8)))
    return np.ascontiguousarray(packed).view(np.uint64)


_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def _popcount(a: np.ndarray, axis=None):
    """Set bits of a uint64 array, summed over ``axis`` (all: an int)."""
    if hasattr(np, "bitwise_count"):
        bits = np.bitwise_count(a)
    else:
        bits = _POP8[a.view(np.uint8)].reshape(a.shape + (8,)).sum(-1)
    if axis is None:
        return int(bits.sum(dtype=np.int64))
    return bits.sum(axis=axis, dtype=np.int64)


def _extensions(level: np.ndarray) -> List[np.ndarray]:
    """For each frequent itemset (ascending rank rows, in lexicographic
    order), the items that extend it to a candidate: larger than its last
    item, with every subset of the extension frequent."""
    n, k1 = level.shape
    lv = level.astype(np.int32)
    # Rows sharing the first k1 - 1 items are one join group; row i joins
    # each later row j of its group with item level[j, -1].
    head = lv[:, :-1]
    new_group = np.ones(n, dtype=bool)
    new_group[1:] = np.any(head[1:] != head[:-1], axis=1)
    gid = np.cumsum(new_group) - 1
    gend = np.flatnonzero(np.concatenate([new_group[1:], [True]])) + 1
    span = gend[gid] - np.arange(n) - 1
    src = np.repeat(np.arange(n), span)
    first = np.concatenate([[0], np.cumsum(span)[:-1]])
    dst = np.arange(src.size) - np.repeat(first, span) + src + 1
    ext = lv[dst, -1]
    ok = np.ones(src.size, dtype=bool)
    # Drop each of the first k1 - 1 items of the joined row: the rest has
    # to be a frequent itemset (the other two subsets are the joined rows).
    for d in range(k1 - 1):
        sub = np.concatenate([np.delete(lv[src], d, axis=1), ext[:, None]],
                             axis=1)
        ok &= _lookup(lv, sub) >= 0
    src, ext = src[ok], ext[ok]
    bounds = np.searchsorted(src, np.arange(n + 1))
    return [ext[bounds[i]:bounds[i + 1]].astype(np.int64) for i in range(n)]


class Rules:
    """Surviving rules in priority order: antecedents as ascending rank
    rows padded with -1, consequent ranks, confidences."""

    def __init__(self, ant: np.ndarray, cons: np.ndarray, conf: np.ndarray):
        self.ant, self.cons, self.conf = ant, cons, conf

    def __len__(self) -> int:
        return int(self.cons.shape[0])


def _bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), kept
    in float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def confidence(c: np.ndarray, a: np.ndarray, precision: str) -> np.ndarray:
    """``c / a`` in ``precision``: float64 (the configuration's), float32,
    or bfloat16 (operands and quotient rounded to it)."""
    if precision == "float64":
        return c.astype(np.float64) / a.astype(np.float64)
    if precision == "float32":
        return c.astype(np.float32) / a.astype(np.float32)
    if precision == "bfloat16":
        return _bfloat16(_bfloat16(c.astype(np.float32))
                         / _bfloat16(a.astype(np.float32)))
    raise ValueError(f"unknown precision {precision!r}")


def gen_rules(m: Mined, precision: str = "float64") -> Rules:
    """The rule join, the dominance prune and the priority sort."""
    f = m.n_freq
    counts_by_len: Dict[int, Tuple[np.ndarray, np.ndarray]] = {
        1: (np.arange(f, dtype=np.int64)[:, None], m.item_counts)}
    for lv, c in m.levels:
        counts_by_len[lv.shape[1]] = (lv, c)
    # Raw rules per antecedent size i (from the itemsets of size i + 1).
    raw = {}
    for size in sorted(counts_by_len):
        if size < 2:
            continue
        lv, c = counts_by_len[size]
        a_rows, a_cnt = counts_by_len[size - 1]
        ants, conss, confs = [], [], []
        for drop in range(size):
            ant = np.delete(lv, drop, axis=1)
            at = _lookup(a_rows, ant)
            if np.any(at < 0):
                raise AssertionError("an antecedent is not frequent")
            ants.append(ant)
            conss.append(lv[:, drop])
            confs.append(confidence(c, a_cnt[at], precision))
        raw[size - 1] = (np.concatenate(ants), np.concatenate(conss),
                         np.concatenate(confs))
    if not raw:
        return Rules(np.zeros((0, 1), np.int64), np.zeros(0, np.int64),
                     np.zeros(0, np.float64))
    sizes = sorted(raw)
    kept = [raw[sizes[0]]]
    low = raw[sizes[0]]
    for i in sizes[1:]:
        ant, cons, conf = raw[i]
        low_key = np.concatenate([low[0], low[1][:, None]], axis=1)
        ok = np.ones(cons.shape[0], dtype=bool)
        for drop in range(i):
            key = np.concatenate([np.delete(ant, drop, axis=1),
                                  cons[:, None]], axis=1)
            at = _lookup(low_key, key)
            prev = (low[2][np.maximum(at, 0)] if low[2].size
                    else np.zeros(at.shape, conf.dtype))
            ok &= (at >= 0) & (prev < conf)
        low = (ant[ok], cons[ok], conf[ok])
        kept.append(low)
    width = max(a.shape[1] for a, _, _ in kept)
    ant = np.concatenate([
        np.pad(a, ((0, 0), (0, width - a.shape[1])), constant_values=-1)
        for a, _, _ in kept])
    cons = np.concatenate([c for _, c, _ in kept])
    conf = np.concatenate([c for _, _, c in kept])
    order = np.lexsort((m.items[cons], -conf.astype(np.float64)))
    return Rules(ant[order], cons[order], conf[order])


def first_match(m: Mined, rules: Rules, flat: np.ndarray,
                lens: np.ndarray) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Each user basket's recommendation, and for the distinct baskets
    holding a frequent item the position of their first matching rule
    (``len(rules)`` when none matches) and each one's line indexes.

    Returns (item per line, first-match position per distinct basket,
    distinct basket of each line, -1 for a basket with no frequent
    item)."""
    f, n = m.n_freq, int(lens.shape[0])
    rank = np.full(max(int(flat.max(initial=0)), int(m.items.max(initial=0)))
                   + 1, -1, np.int64)
    rank[m.items] = np.arange(f)
    words = max(-(-f // 64), 1)
    bits, size = _bitsets(flat, lens, rank, words)
    has = size > 0
    line_basket = np.full(n, -1, np.int64)
    uniq, inv = np.unique(bits[has], axis=0, return_inverse=True)
    line_basket[has] = inv.ravel()
    nb, nr = uniq.shape[0], len(rules)
    best = np.full(nb, nr, np.int64)
    if nb and nr:
        member = np.zeros((nb, f), dtype=bool)
        for w in range(words):
            for j in range(min(64, f - 64 * w)):
                member[:, 64 * w + j] = (uniq[:, w] >> np.uint64(j)) & 1
        # Each rule is tried only on the baskets that hold its rarest
        # antecedent item; then the rest of the antecedent and the
        # consequent decide.
        post_len = member.sum(axis=0)
        post = [np.flatnonzero(member[:, i]) for i in range(f)]
        ant = rules.ant
        valid = ant >= 0
        plen = np.where(valid, post_len[np.maximum(ant, 0)], nb + 1)
        pivot = ant[np.arange(nr), np.argmin(plen, axis=1)]
        ant_bits = np.zeros((nr, words), np.uint64)
        for c in range(ant.shape[1]):
            v = valid[:, c]
            np.bitwise_or.at(ant_bits, (np.flatnonzero(v), ant[v, c] // 64),
                             np.left_shift(np.uint64(1), (ant[v, c] % 64)
                                           .astype(np.uint64)))
        order = np.argsort(pivot, kind="stable")
        bounds = np.searchsorted(pivot[order], np.arange(f + 1))
        for i in range(f):
            rr = order[bounds[i]:bounds[i + 1]]
            bb = post[i]
            if rr.size == 0 or bb.size == 0:
                continue
            for c0 in range(0, rr.size, max(1, 1_000_000 // bb.size)):
                rc = rr[c0:c0 + max(1, 1_000_000 // bb.size)]
                held = np.all((ant_bits[rc][:, None, :]
                               & ~uniq[bb][None, :, :]) == 0, axis=2)
                held &= ~member[bb][:, rules.cons[rc]].T
                ri, bi = np.nonzero(held)
                np.minimum.at(best, bb[bi], rc[ri])
    items = np.where(best < nr, m.items[rules.cons[np.minimum(best, nr - 1)]]
                     if nr else 0, 0)
    rec = np.where(line_basket >= 0, items[np.maximum(line_basket, 0)], 0)
    return [str(x) for x in rec.tolist()], best, line_basket


def freq_itemset_bytes(m: Mined) -> bytes:
    """``freqItemset``: each itemset's ids in descending rank order, one
    space apart; the lines sorted; 1-itemsets included."""
    tok = np.array([str(x) for x in m.items.tolist()], dtype=object)
    lines = tok.tolist()
    for lv, _ in m.levels:
        for row in tok[lv[:, ::-1]].tolist():
            lines.append(" ".join(row))
    lines.sort()
    return "".join(line + "\n" for line in lines).encode()


def recommends_bytes(items: List[str]) -> bytes:
    """``recommends``: one item (or ``0``) per user line, in line order."""
    return "".join(x + "\n" for x in items).encode()


class Result:
    """The reference's two files for one input, and what a roofline needs
    of the problem: the mine's per-level work and the first-match
    positions."""

    def __init__(self, d: bytes, u: bytes, min_support: float,
                 precision: str = "float64"):
        self.mined = mine(*parse_dat(d), min_support)
        self.rules = gen_rules(self.mined, precision)
        uflat, ulens = parse_dat(u)
        self.recs, self.first_pos, self.line_basket = first_match(
            self.mined, self.rules, uflat, ulens)
        self.freq_itemset = freq_itemset_bytes(self.mined)
        self.recommends = recommends_bytes(self.recs)
