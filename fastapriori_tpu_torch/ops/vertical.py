"""Vertical (Eclat-style) mining on one device: per-item tid lists as
packed 32-bit lanes, level-k support by lane-wise AND + popcount
(counterpart: fastapriori_tpu/ops/vertical.py at ``axis_name=None``, with
the dense count reduction only).

Item ``f`` owns the packed bitset of the transactions that hold it (32
tids per lane, LSB first, ``NL = T_pad / 32`` lanes); the arena
``[f_pad + 1, NL]`` adds the all-ones row ``f_pad`` as the AND identity
for padded prefix positions.  Multiplicity weights enter as base-2
bit-planes packed the same way, ``w_t = Σ_b 2^b · bit_b``, so a weighted
support is ``Σ_b 2^b · popcount(inter & plane_b)``: exact for any weight,
with no digit split and no heavy-row correction.

On the host the arena and the planes are ``uint32`` arrays, word for word
the JAX package's; on the device they are ``int32`` tensors with the
same bits (torch's unsigned 32-bit type lacks the operations needed).

- k = 2: every pair is a candidate, so the pair phase is a Gram product
  over lane chunks unpacked to 0/1 bits (:func:`vertical_pair_local`).
- k >= 3: only the actual candidates are counted, by K3
  (ops/vertical_kernel.py, which also holds the JAX module's
  ``_prefix_and`` and ``_popcount_weighted`` beside K3's plain version).

The arena build's reduce pass can be split over host threads
(:func:`build_tid_arena_csr` ``n_threads``, the ingest's thread count).
On a CUDA device the engine builds the same arena on the card instead
(ops/vertical_kernel.py ``build_arena``, at :func:`arena_shape`'s shape).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from fastapriori_tpu_torch.ops.bitmap import next_pow2, pad_axis
from fastapriori_tpu_torch.ops.vertical_kernel import vertical_counts

ONES_WORD = np.uint32(0xFFFFFFFF)

# Transactions per chunk of the pair phase's unpacked [f_pad, chunk] bit
# matrix (the JAX package's level_txn_chunk default).
PAIR_TXN_CHUNK = 1 << 14


# ---------------------------------------------------------------------------
# host-side arena construction


def weight_bit_planes(
    weights: np.ndarray, t_pad: int, min_planes: int = 1
) -> Tuple[np.ndarray, List[int]]:
    """Base-2 bit-planes of the multiplicity weights, packed along the
    tid axis into uint32 lanes (LSB first, the arena's bit order).
    Returns ``(planes uint32[B, t_pad // 32], scales)`` with
    ``weights == Σ_b scales[b] · bit_b`` and ``scales[b] = 2**b``; B = 1
    for weightless corpora, where plane 0 is the row-validity mask; at
    least ``min_planes`` (a sharded ingest: the global largest weight's
    bit length)."""
    if t_pad % 32:
        raise ValueError(f"t_pad must be a multiple of 32, got {t_pad}")
    w = np.zeros(t_pad, dtype=np.int64)
    w[: len(weights)] = weights
    b_planes = max(int(w.max()).bit_length(), min_planes, 1)
    shifts = np.arange(32, dtype=np.uint32)
    planes = np.zeros((b_planes, t_pad // 32), dtype=np.uint32)
    for b in range(b_planes):
        bits = ((w >> b) & 1).astype(np.uint32).reshape(-1, 32)
        planes[b] = (bits << shifts[None, :]).sum(axis=1, dtype=np.uint64)
    return planes, [1 << b for b in range(b_planes)]


# Below this many (item, lane) runs the thread-pool split of the
# reduceat pass costs more in pool setup than it saves.
_ARENA_THREAD_MIN_RUNS = 1 << 16


def arena_shape(t: int, num_items: int, txn_multiple: int = 32,
                item_multiple: int = 128) -> Tuple[int, int]:
    """``(f_pad, t_pad)`` of the arena over ``t`` transactions and
    ``num_items`` items: ``t_pad = pad_axis(t, lcm(txn_multiple, 32))``
    and ``f_pad = pad_axis(num_items + 1, item_multiple)``, so row
    ``f_pad - 1`` is always an all-zero item row."""
    mult = txn_multiple * 32 // math.gcd(txn_multiple, 32)
    return pad_axis(num_items + 1, item_multiple), pad_axis(t, mult)


def build_tid_arena_csr(
    indices: np.ndarray,
    offsets: np.ndarray,
    num_items: int,
    txn_multiple: int = 32,
    item_multiple: int = 128,
    n_threads: int = 1,
) -> Tuple[np.ndarray, int, int]:
    """The dense tid-lane arena from the basket CSR: returns
    ``(arena uint32[f_pad+1, NL], f_pad, t_pad)`` at
    :func:`arena_shape`'s shape, with row ``f_pad`` all ones.  One
    sorted segment-reduce (``np.bitwise_or.reduceat`` over the (item,
    lane) runs) builds every item's lanes.

    ``n_threads > 1`` splits the reduceat pass over a thread pool from
    :data:`_ARENA_THREAD_MIN_RUNS` runs on: runs are independent and
    write disjoint arena slots, so the split is a run-aligned partition
    of the sorted stream, with identical output (each run stays whole)."""
    t = len(offsets) - 1
    f_pad, t_pad = arena_shape(t, num_items, txn_multiple, item_multiple)
    nl = t_pad // 32
    arena = np.zeros((f_pad + 1, nl), dtype=np.uint32)
    if t > 0 and len(indices) > 0:
        rows = np.repeat(
            np.arange(t, dtype=np.int64), np.diff(offsets).astype(np.int64)
        )
        word = rows // 32
        bit = (np.uint32(1) << (rows % 32).astype(np.uint32)).astype(
            np.uint32
        )
        key = indices.astype(np.int64) * nl + word
        order = np.argsort(key, kind="stable")
        skey = key[order]
        bit_sorted = bit[order]
        uniq, start = np.unique(skey, return_index=True)
        flat = arena.reshape(-1)
        n_runs = len(uniq)
        if n_threads > 1 and n_runs >= _ARENA_THREAD_MIN_RUNS:
            from concurrent.futures import ThreadPoolExecutor

            # Thread j owns runs [lo, hi): its reduceat sees every element
            # of its runs (the next thread's first run starts at
            # start[hi]) and its scatter targets are its own uniq slots.
            bounds = [(n_runs * j) // n_threads for j in range(n_threads + 1)]
            end = np.concatenate(
                [start[1:], np.asarray([len(skey)], dtype=start.dtype)]
            )

            def _reduce(j):
                lo, hi = bounds[j], bounds[j + 1]
                if lo >= hi:
                    return
                base = start[lo]
                flat[uniq[lo:hi]] = np.bitwise_or.reduceat(
                    bit_sorted[base : end[hi - 1]], start[lo:hi] - base
                )

            with ThreadPoolExecutor(n_threads,
                                    thread_name_prefix="fa-arena") as pool:
                list(pool.map(_reduce, range(n_threads)))
        else:
            flat[uniq] = np.bitwise_or.reduceat(bit_sorted, start)
    arena[f_pad, :] = ONES_WORD
    return arena, f_pad, t_pad


def compress_arena(
    arena: np.ndarray, f_pad: int, build: bool = True
) -> Tuple[list, int, dict]:
    """Index-compressed, pow2-bucketed form of the arena's item rows:
    items grouped by the pow2 bucket of their non-empty lane count, each
    bucket ``(item_ids int32[nb'], seg_idx int32[nb', S_b], words
    uint32[nb', S_b])`` with ``nb'`` pow2-padded (padding rows target the
    identity row ``f_pad`` at segment 0 with word 0, and a row's unused
    slots hold segment 0 with word 0).  Returns ``(buckets,
    payload_bytes, stats)``; ``build=False`` returns the payload estimate
    and stats without filling the buckets, so the caller can decide
    dense-vs-compressed first."""
    nl = arena.shape[1]
    if build:
        items, segs = np.nonzero(arena[:f_pad])
        counts = np.bincount(items, minlength=f_pad)
        n_active = int(items.size)
    else:
        counts = np.count_nonzero(arena[:f_pad], axis=1)
        n_active = int(counts.sum())
    stats = {
        "active_lanes": n_active,
        "occupancy": round(float(n_active) / max(f_pad * nl, 1), 6),
        "max_item_lanes": int(counts.max()) if counts.size else 0,
    }
    buckets = []
    active = np.flatnonzero(counts)
    if active.size == 0:
        return buckets, 0, stats
    pows = np.array([next_pow2(int(c)) for c in counts[active]])
    sizes = sorted(set(pows.tolist()))
    # Per bucket: nb' int32 ids + nb'·S_b (int32 seg_idx + uint32 word).
    payload = sum(
        next_pow2(int((pows == s_b).sum())) * (4 + 8 * s_b)
        for s_b in sizes
    )
    if not build:
        return buckets, payload, stats
    run_start = np.concatenate([[0], np.cumsum(counts[active])[:-1]])
    for s_b in sizes:
        sel = np.flatnonzero(pows == s_b)
        nb = next_pow2(sel.size)
        ids = np.full(nb, f_pad, dtype=np.int32)
        seg_idx = np.zeros((nb, s_b), dtype=np.int32)
        words = np.zeros((nb, s_b), dtype=np.uint32)
        for j, ai in enumerate(sel):
            item = int(active[ai])
            lo = run_start[ai]
            n = counts[item]
            ids[j] = item
            seg_idx[j, :n] = segs[lo : lo + n]
            words[j, :n] = arena[item, segs[lo : lo + n]]
        buckets.append((ids, seg_idx, words))
    return buckets, payload, stats


def assemble_arena(buckets, f_pad: int, nl: int, device) -> torch.Tensor:
    """Device-side inverse of :func:`compress_arena` over uploaded
    buckets ``(ids int32, seg_idx int32, words int32)``: the dense int32
    ``[f_pad+1, NL]`` arena.  Each real (item, segment) pair appears once
    and has a non-zero word, so writing exactly the non-zero words by
    plain assignment lands every lane (a max-scatter, as the JAX package
    does, would drop words with the top bit set, which read as negative
    in int32); the identity row is set to all ones last."""
    arena = torch.zeros((f_pad + 1, nl), dtype=torch.int32, device=device)
    for ids, seg_idx, words in buckets:
        real = words != 0
        rows = ids[:, None].expand_as(seg_idx)
        arena[rows[real].long(), seg_idx[real].long()] = words[real]
    arena[f_pad] = -1
    return arena


# ---------------------------------------------------------------------------
# device kernels


def _unpack_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """int32 [..., L] -> int8 0/1 [..., L * 32], LSB first per lane (the
    arena and plane bit order; the arithmetic shift of a negative word
    leaves the low bit right)."""
    shifts = torch.arange(32, dtype=torch.int32, device=lanes.device)
    bits = (lanes[..., :, None] >> shifts) & 1
    return bits.reshape(*lanes.shape[:-1], lanes.shape[-1] * 32).to(
        torch.int8
    )


def vertical_pair_local(
    arena: torch.Tensor,  # [f_pad+1, NL] int32
    w_planes: torch.Tensor,  # [B, NL] int32
    scales: Sequence[int],
    n_chunks: int,
    fast_f32: bool = False,
) -> torch.Tensor:
    """C6, vertical-arena form: ``G = Σ_b 2^b · (A ⊙ plane_b) Aᵀ`` with
    ``A`` the arena's item rows as a 0/1 bit matrix, summed over
    ``n_chunks`` lane chunks unpacked on the fly (zero lanes pad the last
    chunk and add nothing).  Returns the int32 [f_pad, f_pad] count
    matrix the bitmap engine's pair phase produces; callers read its
    upper triangle.

    ``fast_f32``: one float32 product per chunk with the reassembled
    weights folded in, exact when the caller proves every count < 2^24
    (counts are bounded by the raw transaction total).  Otherwise one
    product per plane of 0/1 operands, in float64 (exact below 2^53, the
    port's stand-in for the JAX package's int8 x int8 -> int32 product),
    each scaled by its plane's 2^b in int32."""
    f_pad = arena.shape[0] - 1
    nl = arena.shape[1]
    lc = -(-nl // n_chunks)
    acc = torch.zeros((f_pad, f_pad), dtype=torch.int32, device=arena.device)
    for l0 in range(0, nl, lc):
        bits = _unpack_lanes(arena[:f_pad, l0 : l0 + lc])
        planes = [_unpack_lanes(w_planes[b, l0 : l0 + lc])
                  for b in range(len(scales))]
        if fast_f32:
            b32 = bits.to(torch.float32)
            w = None
            for plane, scale in zip(planes, scales):
                part = plane.to(torch.float32) * scale
                w = part if w is None else w + part
            acc += ((b32 * w[None, :]) @ b32.T).to(torch.int32)
            continue
        b64 = bits.to(torch.float64)
        for plane, scale in zip(planes, scales):
            part = ((b64 * plane.to(torch.float64)[None, :]) @ b64.T).to(
                torch.int32
            )
            acc += part if scale == 1 else part * scale
    return acc


# C8, vertical form, under the JAX module's name: K3 itself (the CUDA
# kernel on a CUDA tensor, its plain version on a CPU tensor).
vertical_level_local = vertical_counts


def vertical_level_word_ops(
    nb: int, p_cap: int, k_pad: int, c_cap: int, n_planes: int, nl: int
) -> int:
    """32-bit word operations of one vertical level launch (the metrics
    field ``vops``, counterpart: fastapriori_tpu/ops/vertical.py): per
    block, K gather-ANDs over the [P, NL] prefix lanes plus ``1 + B``
    AND+popcount passes over the [C, NL] candidate intersections."""
    return nb * (k_pad * p_cap + (1 + n_planes) * c_cap) * nl


def vertical_member_bytes(nb: int, p_cap: int, nl: int) -> int:
    """Device-memory bytes of the [P, NL] prefix-AND intermediate of one
    level launch, one 32-bit write and one read (the metrics field
    ``member_bytes_saved``): the traffic K3, which keeps each prefix
    AND in shared memory, does not pay, and K3's plain version does."""
    return nb * 2 * 4 * p_cap * nl
