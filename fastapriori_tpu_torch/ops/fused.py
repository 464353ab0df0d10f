"""Whole-loop mining on the device (counterpart: fastapriori_tpu/ops/fused.py
``make_fused_miner`` / ``make_tail_miner`` over the transaction shards,
with the dense or the threshold-sparse count reduction; reference
C6+C7+C8+C9, FastApriori.scala:88-241, without a host round trip per
level for the candidates).

The bitmap (and its weights) arrive as the list of per-shard row blocks,
in transaction-shard order (one block on one shard).  Each shard counts
its own rows; the per-level ``[m, F]`` (and level 2's ``[F, F]``) partial
counts cross the shards through ops/count.py ``dense_psum`` or, with
``sparse_caps`` / ``sparse_cap``, ``local_sparse_psum`` restricted to the
level's candidates (a union past the budget marks the result unusable:
the fused loop stops with its sparse-overflow flag, the tail fold with
its sentinel, and the host reruns dense).  The candidate products run
once, on shard 0's device, and the set matrix goes to the other shards'
devices through parallel/mesh.py ``broadcast``.

Each level k is mined from the frequent (k-1)-set matrix ``S ∈
{0,1}^{m_cap×F}`` (one row per frequent set, zero rows past the level's
count) with matrix products only:

- candidates (:func:`gen_candidates_matmul`): ``(x, y)`` with ``y >
  max(x)`` is a candidate iff all k-1 of the (k-1)-subsets of ``x ∪ {y}``
  that hold y are frequent, i.e. with ``D = S Sᵀ`` and ``E = (D == k-2)``,
  ``(E S)[x, y] == k-1``;
- support (:func:`weighted_counts`): ``commonᵀ = (S Bᵀ == k-1)`` marks the
  transactions holding each prefix, ``counts = Σ_d 128^d commonᵀ (B ⊙
  w_d)`` weighs every extension at once;
- survivors: ``torch.nonzero_static(..., fill_value=0)`` at the static row
  budget, row-major like ``jnp.nonzero(size=, fill_value=0)``, become the
  next level's S.

The reference runs the loop as one ``lax.while_loop``.  Here a host loop
issues each level's device work at static shapes and reads one small
array between levels (the survivor count and the stop flags, through
pinned memory and an event): nothing inside a level waits for the
device, and the loop stops exactly where the reference's does, so the
results, packed as the reference packs them, are equal element for
element.

Every product is exact: int8 operands with int32 accumulation
(``torch._int_mm``; on CUDA its shape rules are met by zero padding when
a shape breaks them), or float32 where the caller proves every value
below 2^24 (``fast_f32``, the reference's CPU choice; TF32 stays off).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fastapriori_tpu_torch.device import DeviceContext
from fastapriori_tpu_torch.ops.bitmap import unpack_bitmap
from fastapriori_tpu_torch.ops.count import (
    TRI_F_CAP,
    _pair_triangles,
    dense_psum,
    heavy_level_correction,
    local_sparse_psum,
)
from fastapriori_tpu_torch.parallel import mesh

Region = Callable[[], contextlib.AbstractContextManager]


def exact_mm(a: torch.Tensor, b_t: torch.Tensor, f32: bool = False):
    """``a @ b_t.T`` as int32 for non-negative integer operands ``a [m,
    k]`` and ``b_t [n, k]``: int8 operands with int32 accumulation
    (``torch._int_mm``, both operands contiguous along k), or float32
    products when ``f32`` (the caller proves every value < 2^24)."""
    if f32:
        return (a.to(torch.float32) @ b_t.to(torch.float32).T).to(
            torch.int32)
    a = a.to(torch.int8).contiguous()
    b_t = b_t.to(torch.int8).contiguous()
    m, k = a.shape
    n = b_t.shape[0]
    if a.is_cuda and (m <= 16 or k % 8 or n % 8):
        # cuBLASLt's int8 rules: more than 16 rows, k and n multiples of
        # 8.  Zero rows and columns add nothing to the products.
        pk = -k % 8
        a = F.pad(a, (0, pk, 0, max(32 - m, 0)))
        b_t = F.pad(b_t, (0, pk, 0, -n % 8))
        return torch._int_mm(a, b_t.t())[:m, :n]
    return torch._int_mm(a, b_t.t())


def one_hot_rows(cols: torch.Tensor, f: int) -> torch.Tensor:
    """int8 ``[n, f]`` rows with a 1 at each row's column."""
    out = torch.zeros((cols.shape[0], f), dtype=torch.int8,
                      device=cols.device)
    return out.scatter_(1, cols.long()[:, None], 1)


def extend_rows(s: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """The next level's set matrix: ``(s[rows] | one_hot(cols)) *
    valid``."""
    nxt = s.index_select(0, rows).scatter_(1, cols.long()[:, None], 1)
    return nxt * valid[:, None].to(torch.int8)


def gen_candidates_matmul(
    s: torch.Tensor,  # [M, F] int8 0/1
    k: int,
    col_ids: torch.Tensor,  # [F] int
    valid_row: torch.Tensor,  # [M, 1] bool
    row_chunks: int = 1,
    f32: bool = False,
    num_items: Optional[int] = None,
) -> torch.Tensor:
    """Candidate generation as products (module docstring): the bool
    ``[M, F]`` mask of extensions ``y`` of each frequent (k-1)-set row x
    whose k-1 subsets holding y are all frequent, with ``y > max(x)``
    and ``y < num_items`` (the real item columns; None: all F).
    ``row_chunks`` cuts the ``[M, M]`` intersection matrix into row
    blocks of M / row_chunks, bounding its peak to 5·M²/row_chunks bytes
    (int32 D plus the bool E).  Every value is an intersection size or a
    vote count, at most max(F, M) < 2^24, so ``f32`` is exact too."""
    rowmax = torch.where(s > 0, col_ids[None, :], -1).amax(dim=1)
    s_t = s.t().contiguous()

    def blk(s_blk):
        d = exact_mm(s_blk, s, f32)  # [mb, M] intersection sizes
        e = d == k - 2
        del d
        return exact_mm(e.view(torch.int8), s_t, f32)  # [mb, F] votes

    if row_chunks <= 1:
        cand_cnt = blk(s)
    else:
        m = s.shape[0]
        assert m % row_chunks == 0, (m, row_chunks)
        mb = m // row_chunks
        cand_cnt = torch.cat([blk(s[i : i + mb]) for i in range(0, m, mb)])
    real = col_ids < (col_ids.shape[0] if num_items is None else num_items)
    return ((cand_cnt == k - 1) & (col_ids[None, :] > rowmax[:, None])
            & real[None, :] & valid_row)


def weighted_digit_counts(
    common_t: torch.Tensor,  # [M, T] 0/1
    bitmap: torch.Tensor,  # [T, F] int8 0/1
    w_digits: Sequence[torch.Tensor],  # per digit [T] int8 in [0, 128)
    scales: Sequence[int],
    f32: bool = False,
) -> torch.Tensor:
    """``out[m, f] = Σ_d scales[d] Σ_t common_t[m, t] w_d[t] bitmap[t,
    f]``, int32: the weights scale the F-wide bitmap side (the
    reference's regrouping), each digit's product exact."""
    total = None
    for wd, scale in zip(w_digits, scales):
        bw_t = (bitmap * wd.to(torch.int8)[:, None]).t()  # [F, T]
        part = exact_mm(common_t, bw_t, f32)
        part = part if scale == 1 else part * scale
        total = part if total is None else total + part
    return total


def weighted_counts(
    common_t: torch.Tensor,  # [M, T] 0/1
    bitmap: torch.Tensor,  # [T, F] int8 0/1
    w: torch.Tensor,  # [T] int32 raw weights
    n_digits: int,
    fast_f32: bool,
) -> torch.Tensor:
    """``counts[m, f] = Σ_t w_t common_t[m, t] bitmap[t, f]`` (the
    reference's ``_weighted_counts`` with its first operand transposed,
    so that both operands of every product run along T) through
    base-128 weight digits.  ``fast_f32``: float32 products, exact when
    the caller proves ``127 · T < 2^24``."""
    digits = [(w // (128**d)) % 128 for d in range(n_digits)]
    return weighted_digit_counts(common_t, bitmap, digits,
                                 [128**d for d in range(n_digits)], fast_f32)


def _chunks(bitmap, w, n_chunks: int, packed_input: bool):
    """The transaction chunks ``(bitmap [t_c, F] int8, w [t_c])``; a
    packed bitmap is unpacked chunk by chunk."""
    t_c = bitmap.shape[0] // n_chunks
    for c in range(n_chunks):
        part = bitmap[c * t_c : (c + 1) * t_c]
        yield (unpack_bitmap(part) if packed_input else part,
               w[c * t_c : (c + 1) * t_c])


def _as_parts(x) -> list:
    """A per-shard list (a lone tensor is one shard's)."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _reducer(cap: Optional[int], thrs, groups):
    """The per-level count reduction over per-shard partial counts:
    ``reduce(parts, valid) -> (counts on shard 0, n_union or None)``,
    dense without ``cap``."""
    if cap is None:
        return lambda parts, valid: (dense_psum(parts), None)
    return lambda parts, valid: local_sparse_psum(
        parts, thrs, cap, valid=valid, groups=groups)


def fused_mine(
    bitmap,  # per-shard [T_s, F // 8] uint8, or [T_s, F] int8 unpacked
    w,  # per-shard [T_s] int32 raw weights
    min_count: int,
    *,
    m_cap: int,
    l_max: int,
    n_digits: int,
    n_chunks: int = 1,
    fast_f32: bool = False,
    packed_input: bool = True,
    region: Optional[Region] = None,
    sparse_caps: Optional[Tuple[int, int]] = None,
    sparse_thr: Optional[Sequence[int]] = None,
    groups: Optional[Tuple[int, int]] = None,
    num_items: Optional[int] = None,
) -> torch.Tensor:
    """The whole level loop from level 2 (the reference's
    ``_fused_mine_local``); only the first ``num_items`` columns are real
    items (None: all F).  ``bitmap`` and ``w`` are per-shard lists (a
    lone tensor is one shard); ``n_chunks`` chunks each shard's rows.
    Returns the reference's packed int32 ``[3·l_max + 1, m_cap]`` on
    shard 0's device: rows, cols and counts per level (level k at slot k
    - 2), then a meta row with the true survivor count per level, the
    incomplete flag at slot ``l_max`` (overflow, or the l_max bound
    stopped a live loop), the overflow flags at ``l_max + 1`` (bit 0 the
    row budget, bit 1 the sparse union) and the largest union census at
    ``l_max + 2`` (0 under the dense reduction).  ``sparse_caps = (pair
    cap, level cap)`` with ``sparse_thr`` (one threshold per shard) runs
    both reductions sparse.  ``region``: a context manager factory
    entered around each level's device work (device.py
    ``sync_free``)."""
    assert m_cap > l_max + 1, (m_cap, l_max)
    region = region or contextlib.nullcontext
    bitmaps, ws = _as_parts(bitmap), _as_parts(w)
    devs = [b.device for b in bitmaps]
    dev = devs[0]
    f = bitmaps[0].shape[1] * 8 if packed_input else bitmaps[0].shape[1]
    num_items = f if num_items is None else num_items
    for b in bitmaps:
        assert b.shape[0] % n_chunks == 0, (b.shape[0], n_chunks)
    col_ids = torch.arange(f, device=dev)
    slots = torch.arange(m_cap, device=dev)
    out = torch.zeros((3 * l_max + 1, m_cap), dtype=torch.int32, device=dev)
    meta = out[3 * l_max]
    cap2, capk = sparse_caps if sparse_caps is not None else (None, None)
    reduce2 = _reducer(cap2, sparse_thr, groups)
    reducek = _reducer(capk, sparse_thr, groups)

    def scan_counts(project, out_dim):
        # Each shard's partial counts over its own row chunks.
        parts = []
        for sh, (bm, wv) in enumerate(zip(bitmaps, ws)):
            acc = torch.zeros((out_dim, f), dtype=torch.int32,
                              device=bm.device)
            for b, wk in _chunks(bm, wv, n_chunks, packed_input):
                acc += weighted_counts(project(sh, b), b, wk, n_digits,
                                       fast_f32)
            parts.append(acc)
        return parts

    def store(idx, rows, cols, counts, n, valid):
        out[idx] = rows
        out[l_max + idx] = cols
        out[2 * l_max + idx] = counts.reshape(-1).index_select(
            0, rows * f + cols) * valid
        meta[idx] = n

    def read(n, nu):
        """The host's one small read per level: the survivor count and,
        under the sparse reduction, the union census."""
        x = n if nu is None else torch.stack([n, nu])
        got = DeviceContext.fetch_async(x, "fused").result()
        return (int(got), 0) if nu is None else (int(got[0]), int(got[1]))

    with region():
        # Level 2: the weighted Gram product.  The padded columns count
        # 0, which passes a min_count <= 0: only real columns may pair.
        upper2 = ((col_ids[None, :] > col_ids[:, None])
                  & (col_ids[None, :] < num_items))
        pair, nu = reduce2(scan_counts(lambda sh, b: b.t(), f), upper2)
        mask = (pair >= min_count) & upper2
        n = mask.sum(dtype=torch.int32)
        rc = torch.nonzero_static(mask, size=m_cap, fill_value=0)
        valid = slots < n
        s = (one_hot_rows(rc[:, 0], f) | one_hot_rows(rc[:, 1], f)) * \
            valid[:, None].to(torch.int8)
        store(0, rc[:, 0], rc[:, 1], pair, n, valid)
        del pair, mask
    m, snu = read(n, nu)
    sparse_ovf = cap2 is not None and snu > cap2
    overflow = m > m_cap
    k = 3
    while not overflow and not sparse_ovf and m >= k and k <= l_max + 1:
        with region():
            cand = gen_candidates_matmul(
                s, k, col_ids, (slots < m)[:, None], f32=fast_f32,
                num_items=num_items)
            s_sh = mesh.broadcast(s, devs)

            def contains_prefix(sh, b, k=k):
                return (exact_mm(s_sh[sh], b, fast_f32) == k - 1).view(
                    torch.int8)

            counts, nu = reducek(scan_counts(contains_prefix, m_cap), cand)
            surv = cand & (counts >= min_count)
            del cand, s_sh
            n = surv.sum(dtype=torch.int32)
            rc = torch.nonzero_static(surv, size=m_cap, fill_value=0)
            del surv
            valid = slots < n
            rows, cols = rc[:, 0], rc[:, 1]
            s = extend_rows(s, rows, cols, valid)
            store(k - 2, rows, cols, counts, n, valid)
            del counts
        m, lvl_nu = read(n, nu)
        snu = max(snu, lvl_nu)
        sparse_ovf = capk is not None and lvl_nu > capk
        overflow = m > m_cap
        k += 1
    incomplete = overflow or (m >= k and k > l_max + 1)
    meta[l_max] = int(incomplete)
    meta[l_max + 1] = int(overflow) + 2 * int(sparse_ovf)
    if m_cap > l_max + 2:
        meta[l_max + 2] = snu
    return out


def make_fused_miner(
    m_cap: int,
    l_max: int,
    n_digits: int,
    n_chunks: int = 1,
    fast_f32: bool = False,
    packed_input: bool = True,
    sparse_caps: Optional[Tuple[int, int]] = None,
    groups: Optional[Tuple[int, int]] = None,
):
    """The fused miner at one static configuration (the reference's
    ``make_fused_miner``): ``fn(bitmap, w, min_count, sparse_thr=None,
    region=None)`` -> the packed ``[3·l_max + 1, m_cap]`` int32 result
    (:func:`fused_mine`).  ``packed_input=False`` takes the resident
    unpacked int8 bitmap.  ``sparse_caps`` (pair cap, level cap) runs
    both count reductions through the threshold-sparse exchange, over
    ``groups`` when given; the call then passes ``sparse_thr``.
    ``num_items``: the real item columns (:func:`fused_mine`)."""
    assert m_cap > l_max + 1, (m_cap, l_max)

    def run(bitmap, w, min_count, sparse_thr=None, region=None,
            num_items=None):
        return fused_mine(
            bitmap, w, int(min_count), m_cap=m_cap, l_max=l_max,
            n_digits=n_digits, n_chunks=n_chunks, fast_f32=fast_f32,
            packed_input=packed_input, region=region,
            sparse_caps=sparse_caps, sparse_thr=sparse_thr, groups=groups,
            num_items=num_items)

    return run


def make_pair_counter(n_digits: int, n_chunks: int = 1,
                      fast_f32: bool = False):
    """The fused engine's sizing pre-pass over the packed bitmap (per-shard
    lists, the pair counts summed by the dense psum):
    ``fn(packed, w, min_count, num_items=None) -> (n2, tri)`` int32 device
    scalars, the frequent-pair count over the first ``num_items`` columns
    (None: all) and the level-3 candidate census (-1 when F_pad exceeds
    ``TRI_F_CAP``)."""

    def run(packed, w, min_count, num_items=None):
        parts = []
        for pk, wv in zip(_as_parts(packed), _as_parts(w)):
            acc = torch.zeros((pk.shape[1] * 8,) * 2, dtype=torch.int32,
                              device=pk.device)
            for b, wk in _chunks(pk, wv, n_chunks, True):
                acc += weighted_counts(b.t(), b, wk, n_digits, fast_f32)
            parts.append(acc)
        pair = dense_psum(parts)
        f, dev = pair.shape[0], pair.device
        col = torch.arange(f, device=dev)
        # Padded item columns count 0, which passes a min_count <= 0: the
        # real-item bound keeps them out.
        real = col < (f if num_items is None else num_items)
        mask = ((pair >= int(min_count)) & (col[None, :] > col[:, None])
                & real[None, :])
        n2 = mask.sum(dtype=torch.int32)
        tri = (_pair_triangles(mask) if f <= TRI_F_CAP
               else torch.full((), -1, dtype=torch.int32, device=dev))
        return n2, tri

    return run


def tail_mine(
    bitmap,  # per-shard [T_s, F] int8, the level engine's bitmap
    w_digits,  # per-shard [D, T_s] int8 base-128 weight digits
    seed_cols: torch.Tensor,  # [m_cap, k0] int, the seed level padded
    n0: int,  # real seed rows
    min_count: int,
    heavy_b: Optional[torch.Tensor],  # [Th, F] int8
    heavy_w: Optional[torch.Tensor],  # [Th] int32
    *,
    scales: Sequence[int],
    k0: int,
    m_cap: int,
    p_cap: int,
    l_max: int,
    n_chunks: int,
    slot_caps: Sequence[int],
    cand_row_chunks: int = 1,
    region: Optional[Region] = None,
    resolve: Optional[tuple] = None,
    sparse_cap: Optional[int] = None,
    sparse_thr: Optional[Sequence[int]] = None,
    groups: Optional[Tuple[int, int]] = None,
    num_items: Optional[int] = None,
):
    """The shallow-tail fold (the reference's ``_tail_mine_local``): the
    levels after ``k0`` from the seed level, in one device loop.
    Against :func:`fused_mine`: seeded from an index table, only the
    ``p_cap`` prefix rows that have a candidate go through the counting
    products (prefix compaction), counts use the level engine's weight
    digits and heavy-row correction (shard 0 adds it: the heavy arrays
    are whole, not sharded), slot i keeps ``slot_caps[i]`` rows, and a
    level whose prefixes exceed ``p_cap``, survivors its slot cap, or
    sparse union ``sparse_cap`` stores the sentinel ``m_cap + 1`` as its
    count and stops the loop (the host resumes the level engine from the
    last complete level).  ``bitmap`` and ``w_digits`` are per-shard
    lists (a lone tensor is one shard); each shard's ``[p_cap, F]``
    partial counts cross through the dense psum or, with ``sparse_cap``
    and ``sparse_thr``, the threshold-sparse exchange restricted to the
    iteration's candidates.

    Returns the reference's 1-D int32 layout: per slot i ``rows[:cap_i] |
    cols[:cap_i] | counts[:cap_i]``, then ``n_per_level[l_max] |
    incomplete | largest union census`` (:func:`unpack_tail_result`).

    ``resolve = (pending, u24)``: the level loop's deferred survivor
    counts (``[(counts_dev, flat positions)]``) are gathered inside the
    same program, issued before its first level, and fetched while it
    runs (the reference's ``tail_miner_with_resolve``); the return is
    then ``(result, PendingCounts)`` with the fetch under
    ``fetch.counts_resolve``."""
    assert m_cap > l_max + 1, (m_cap, l_max)
    region = region or contextlib.nullcontext
    bitmaps, wds = _as_parts(bitmap), _as_parts(w_digits)
    devs = [b.device for b in bitmaps]
    dev = devs[0]
    f = bitmaps[0].shape[1]
    for b in bitmaps:
        assert b.shape[0] % n_chunks == 0, (b.shape[0], n_chunks)
    col_ids = torch.arange(f, device=dev)
    slots = torch.arange(m_cap, device=dev)
    p_slots = torch.arange(p_cap, device=dev)
    offs = np.concatenate([[0], np.cumsum([3 * c for c in slot_caps])])
    base = int(offs[-1])
    out = torch.zeros(base + l_max + 2, dtype=torch.int32, device=dev)
    n_out = out[base : base + l_max]
    reduce = _reducer(sparse_cap, sparse_thr, groups)
    handle = (DeviceContext.gather_level_counts_start(
        resolve[0], resolve[1], "counts_resolve")
              if resolve is not None else None)

    with region():
        s = torch.zeros((m_cap, f), dtype=torch.int8, device=dev)
        s.scatter_(1, seed_cols.long(), 1)
        s *= (slots < n0)[:, None].to(torch.int8)
    m, k, stop, snu = n0, k0 + 1, False, 0
    while not stop and m >= k and k <= k0 + l_max:
        idx = k - k0 - 1
        cap = slot_caps[idx]
        with region():
            cand = gen_candidates_matmul(
                s, k, col_ids, (slots < m)[:, None],
                row_chunks=cand_row_chunks, num_items=num_items)
            has = cand.any(dim=1)
            n_pref = has.sum(dtype=torch.int32)
            pr = torch.nonzero_static(has, size=p_cap, fill_value=0)[:, 0]
            valid_p = p_slots < n_pref
            s_p = s.index_select(0, pr) * valid_p[:, None].to(torch.int8)
            parts = []
            for sh, (bm, wd, s_ps) in enumerate(
                    zip(bitmaps, wds, mesh.broadcast(s_p, devs))):
                t_c = bm.shape[0] // n_chunks
                acc = torch.zeros((p_cap, f), dtype=torch.int32,
                                  device=bm.device)
                for c in range(n_chunks):
                    b = bm[c * t_c : (c + 1) * t_c]
                    common_t = (exact_mm(s_ps, b) == k - 1).view(torch.int8)
                    acc += weighted_digit_counts(
                        common_t, b, [d[c * t_c : (c + 1) * t_c]
                                      for d in wd], scales)
                if heavy_b is not None and sh == 0:
                    acc += heavy_level_correction(s_ps, k - 1, heavy_b,
                                                  heavy_w)
                parts.append(acc)
            cand_p = cand.index_select(0, pr) & valid_p[:, None]
            del cand
            counts_p, nu = reduce(parts, cand_p)
            del parts
            surv = cand_p & (counts_p >= min_count)
            n = surv.sum(dtype=torch.int32)
            rc = torch.nonzero_static(surv, size=m_cap, fill_value=0)
            valid = slots < n
            rows_p, cols = rc[:, 0], rc[:, 1]
            rows = pr.index_select(0, rows_p)
            level_counts = counts_p.reshape(-1).index_select(
                0, rows_p * f + cols) * valid
            s = extend_rows(s, rows, cols, valid)
            bad = (n_pref > p_cap) | (n > cap)
            if nu is not None:
                bad = bad | (nu > sparse_cap)
            o = int(offs[idx])
            out[o : o + cap] = rows[:cap]
            out[o + cap : o + 2 * cap] = cols[:cap]
            out[o + 2 * cap : o + 3 * cap] = level_counts[:cap]
            n_out[idx] = torch.where(bad, m_cap + 1, n)
            flags = torch.stack([n, bad.to(torch.int32)]
                                + ([nu] if nu is not None else []))
        got = [int(x) for x in
               DeviceContext.fetch_async(flags, "tail").result()]
        m, stop = got[0], bool(got[1])
        if len(got) > 2:
            snu = max(snu, got[2])
        k += 1
    out[base + l_max] = int(stop or (m >= k and k > k0 + l_max))
    out[base + l_max + 1] = snu
    return out if handle is None else (out, handle)


def tail_slot_caps(m_cap: int, l_max: int,
                   flat: bool = False) -> Tuple[int, ...]:
    """Descending per-level row caps of the tail fold: slot i keeps
    ``m_cap >> i`` rows, at least 4,096 and at most m_cap (a fold's
    levels shrink; a level that does not trips the fold's sentinel and
    the host resumes per level, exact either way).  ``flat``: every slot
    keeps m_cap rows, the fused engine's checkpoint segment (seeded
    mid-lattice, where levels may still grow)."""
    if flat:
        return tuple(m_cap for _ in range(l_max))
    return tuple(min(m_cap, max(m_cap >> i, 4096)) for i in range(l_max))


def tail_cand_row_chunks(m_cap: int) -> int:
    """Row blocks of the fold's ``[M, M]`` candidate products: the
    smallest power of two keeping 8·M·(M / blocks) <= 512 MiB."""
    rc = 1
    while 8 * m_cap * (m_cap // rc) > (512 << 20):
        rc *= 2
    return rc


def make_tail_miner(
    scales: Sequence[int],
    k0: int,
    m_cap: int,
    p_cap: int,
    l_max: int,
    n_chunks: int,
    has_heavy: bool,
    flat_caps: bool = False,
    sparse_cap: Optional[int] = None,
    groups: Optional[Tuple[int, int]] = None,
):
    """The tail fold at one static configuration (the reference's
    ``make_tail_miner``): ``fn(bitmap, w_digits, seed_cols, n0,
    min_count[, heavy_b, heavy_w], sparse_thr=None, region=None,
    resolve=None)`` -> the 1-D int32 result of :func:`tail_mine`, or
    ``(result, PendingCounts)`` with ``resolve`` (the pending-count
    gather folded into the program: the reference's
    ``tail_miner_with_resolve``).  ``flat_caps``: the checkpoint
    segment's slot caps (:func:`tail_slot_caps`); ``sparse_cap``: the
    per-iteration reduction through the threshold-sparse exchange (over
    ``groups`` when given; the call then passes ``sparse_thr``);
    ``num_items``: the real item columns (None: all F)."""
    assert m_cap > l_max + 1, (m_cap, l_max)
    caps = tail_slot_caps(m_cap, l_max, flat=flat_caps)
    row_chunks = tail_cand_row_chunks(m_cap)

    def run(bitmap, w_digits, seed_cols, n0, min_count, *heavy,
            sparse_thr=None, region=None, resolve=None, num_items=None):
        hb, hw = heavy if has_heavy else (None, None)
        return tail_mine(
            bitmap, w_digits, seed_cols, int(n0), int(min_count), hb, hw,
            scales=tuple(scales), k0=k0, m_cap=m_cap, p_cap=p_cap,
            l_max=l_max, n_chunks=n_chunks, slot_caps=caps,
            cand_row_chunks=row_chunks, region=region, resolve=resolve,
            sparse_cap=sparse_cap, sparse_thr=sparse_thr, groups=groups,
            num_items=num_items)

    return run


def unpack_tail_result(packed: np.ndarray, m_cap: int, l_max: int,
                       flat: bool = False):
    """Split the tail fold's 1-D result into ``(rows_list, cols_list,
    counts_list, n_per_level, incomplete, census)``: per-slot arrays
    sized by :func:`tail_slot_caps` (``flat`` as built; decode them with
    ``max_rows`` = the slot caps); the census is the largest sparse union
    (0 under the dense reduction)."""
    rows, cols, counts = [], [], []
    off = 0
    for c in tail_slot_caps(m_cap, l_max, flat=flat):
        rows.append(packed[off : off + c])
        cols.append(packed[off + c : off + 2 * c])
        counts.append(packed[off + 2 * c : off + 3 * c])
        off += 3 * c
    snu = int(packed[off + l_max + 1]) if packed.shape[0] > off + l_max + 1 \
        else 0
    return rows, cols, counts, packed[off : off + l_max], \
        bool(packed[off + l_max]), snu


def unpack_fused_result(packed: np.ndarray, l_max: int):
    """Split the fused miner's ``[3·l_max + 1, m_cap]`` result into
    ``(rows, cols, counts, n_per_level, incomplete, overflow,
    sparse_overflow, census)`` (the last two are 0 under the dense
    reduction)."""
    meta = packed[3 * l_max]
    return (
        packed[:l_max],
        packed[l_max : 2 * l_max],
        packed[2 * l_max : 3 * l_max],
        meta[:l_max],
        bool(meta[l_max]),
        bool(meta[l_max + 1] & 1),
        bool(meta[l_max + 1] >> 1),
        int(meta[l_max + 2]) if meta.shape[0] > l_max + 2 else 0,
    )


def decode_level_matrices(
    out_rows,
    out_cols,
    out_counts,
    out_n: np.ndarray,
    max_rows=None,
    prev: Optional[np.ndarray] = None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Chain complete levels into ``[(int32[N, k] member matrix, int64[N]
    counts), ...]``, lex-sorted by construction (survivors come out
    row-major over a lex-sorted previous level, and the extension is the
    largest member).  ``max_rows`` (the row budget, or the tail fold's
    per-slot caps) stops before the first level whose true survivor count
    exceeded it: its stored rows are truncated.  ``prev``: the seed
    matrix that slot 0's row indexes point into (the tail fold)."""
    out = []
    for lvl in range(len(out_n)):
        n = int(out_n[lvl])
        cap = max_rows[lvl] if isinstance(max_rows, (list, tuple)) \
            else max_rows
        if n == 0 or (cap is not None and n > cap):
            break
        rows = np.asarray(out_rows[lvl][:n], dtype=np.int32)
        cols = np.asarray(out_cols[lvl][:n], dtype=np.int32)
        if prev is None:
            cur = np.stack([rows, cols], axis=1)
        else:
            cur = np.concatenate([prev[rows], cols[:, None]], axis=1)
        out.append((cur, np.asarray(out_counts[lvl][:n]).astype(np.int64)))
        prev = cur
    return out
