"""Support counting (counterpart: fastapriori_tpu/ops/count.py
``local_pair_counts``, ``heavy_pair_correction``,
``heavy_level_correction``, ``frequent_pair_mask``, the level gather's
survivor bitmask (:func:`survivor_bits`),
``pair_threshold_pack``, ``l3_threshold_pack``, ``local_pair_regather``
and ``local_level_gather`` per shard; the count reductions across
transaction shards: ``_psum_if`` (:func:`dense_psum`),
``local_sparse_psum``, ``sparse_union_cap`` and the payload models
``sparse_psum_bytes`` / ``sparse_stage_bytes``; reference C6/C8).

- Pair counts (C6): ``C2[f, g] = Σ_t w_t B[t, f] B[t, g]``, the Gram
  matrix Bᵀ(w ⊙ B).  The reference package leaves it to XLA outside any
  Pallas kernel; here it is one ``torch.matmul`` in float32 when the
  caller proves every count < 2^24 (``fast_f32``: counts are bounded by
  the raw transaction total, the reference's ``_fast_f32`` gate), else in
  float64 (exact below 2^53).  Every term and partial sum is a
  non-negative integer under that bound, so any summation order is exact
  (TF32 is kept off — device.py).
- Level-k counts (C8): per prefix row, the one-hot row S, then K1
  (ops/level_kernel.py) for ``counts[p, f] = Σ_t w_t [t ⊇ prefix p]
  B[t, f]`` for every extension f at once, then the gather at the
  candidates' flat indexes.

- The pair phase's device tail (:func:`pair_threshold_pack`): threshold,
  survivor extraction at a static budget and the level-3 census, packed
  into one int32 array so that one fetch carries level 2; with
  :func:`l3_threshold_pack` the same array also carries level 3.  The
  survivor extraction is ``torch.nonzero_static`` (static size), so
  nothing between the Gram and the fetch waits for the device.  The
  tail uses few distinct PyTorch kernels (no ``==``, no integer
  division, no scans or scatters): a fresh process loads each kernel's
  module at its first launch, about 10-60 ms apiece on the H100.

Weights enter the int8 kernel as base-128 digits (ops/bitmap.py).  The
engine runs the single low digit ``w % 128`` for every row and adds the
exact remainder of the few rows with multiplicity >= 128 through the
heavy-row corrections (float64 matmuls over those rows only).  The pair
program's level 3 (:func:`l3_threshold_pack`) runs before the host has
split the weights: it launches K1 once per digit of the raw weights.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from fastapriori_tpu_torch.ops.level_kernel import level_counts


def _weights(w_digits: torch.Tensor, scales: Sequence[int], dtype):
    """Per-transaction weights reassembled from their base-128 digits."""
    w = None
    for d, scale in enumerate(scales):
        part = w_digits[d].to(dtype) * scale
        w = part if w is None else w + part
    return w


def local_pair_counts(
    bitmap: torch.Tensor,  # [T, F] int8
    w_digits: torch.Tensor,  # [D, T] int8
    scales: Sequence[int],
    fast_f32: bool = False,
) -> torch.Tensor:
    """C6: weighted co-occurrence counts of all item pairs, int32 [F, F]
    (diagonal = weighted item support over size>=2 baskets; callers read
    the upper triangle)."""
    dtype = torch.float32 if fast_f32 else torch.float64
    b = bitmap.to(dtype)
    w = _weights(w_digits, scales, dtype)
    return (b.T @ (b * w[:, None])).to(torch.int32)


def heavy_pair_correction(
    heavy_b: torch.Tensor,  # [Th, F] int8 (zero rows when unused)
    heavy_w: torch.Tensor,  # [Th] int32 = w - (w % 128) (0 on padding)
) -> torch.Tensor:
    """The heavy rows' remainder contribution to the pair Gram matrix."""
    hb = heavy_b.to(torch.float64)
    return (hb.T @ (hb * heavy_w.to(torch.float64)[:, None])).to(torch.int32)


def heavy_level_correction(
    onehot: torch.Tensor,  # [P, F] prefix one-hot int8
    k1: int,
    heavy_b: torch.Tensor,  # [Th, F] int8
    heavy_w: torch.Tensor,  # [Th] int32
) -> torch.Tensor:
    """The heavy rows' remainder contribution to one level's [P, F]
    count matrix: membership + weighted counting over just those rows."""
    hb = heavy_b.to(torch.float64)
    member = hb @ onehot.to(torch.float64).T  # [Th, P]
    common = (member == k1).to(torch.float64) * heavy_w.to(torch.float64)[
        :, None
    ]
    return (common.T @ hb).to(torch.int32)


def frequent_pair_mask(
    counts: torch.Tensor,  # [F, F] int32
    min_count: int,
    num_items: int,
) -> torch.Tensor:
    """The one definition of the frequent-pair mask (upper triangle,
    real-item columns, count threshold), shared by the pair packing, the
    overflow regather and the level-3 fold's candidate prune: the fold
    indexes pair survivor slots extracted from this same mask, so a
    second copy could let its candidates drift from those slots."""
    iu = torch.arange(counts.shape[0], device=counts.device)
    upper = (iu[None, :] > iu[:, None]) & (iu[None, :] < num_items)
    return upper & (counts >= min_count)


# Item-axis bound of the level-3 census: its [F, F] product is about
# 2·F³ operations, and the sparse wide-item corpora above this bound never
# need the figure.
TRI_F_CAP = 4096

def _first_set(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Coordinates of the first ``cap`` true entries of a 2-D bool tensor
    in row-major order, zero-filled past the last one: int64 ``[cap,
    2]`` (jax's ``jnp.nonzero(..., size=cap, fill_value=0)``).
    ``torch.nonzero_static`` has a static output size, so unlike
    ``torch.nonzero`` and boolean indexing it does not wait for the
    device."""
    return torch.nonzero_static(mask, size=cap, fill_value=0)


def _flat(xy: torch.Tensor, width: int) -> torch.Tensor:
    """int64 row-major flat indexes ``x * width + y`` of ``[n, 2]``
    coordinates."""
    return xy[:, 0] * width + xy[:, 1]


def _pair_triangles(mask: torch.Tensor) -> torch.Tensor:
    """Level-3 candidate census from the frequent-pair mask: the ordered
    triples ``x < y < z`` whose three pairs are all frequent, i.e. the
    k = 3 Apriori candidates after the full subset prune.  With ``U`` the
    upper-triangle adjacency, ``(U Uᵀ)[x, y]`` counts the common larger
    neighbours z of x and y, so the census is ``Σ_{(x,y) frequent}
    (U Uᵀ)[x, y]``.  The product's entries are at most F < 2^24 (exact
    in float32), the sum runs in int64 and the total saturates at 2^30,
    as the reference's does.  Returns an int32 scalar tensor."""
    u = mask.to(torch.float32)
    total = ((u @ u.T) * u).to(torch.int64).sum()
    return total.clamp(max=2**30).to(torch.int32)


def pair_threshold_pack(
    counts: torch.Tensor,  # [F, F] int32 pair counts
    min_count: int,
    num_items: int,
    cap: int,
    census: bool,
) -> torch.Tensor:
    """The pair phase's device tail: threshold (:func:`frequent_pair_mask`,
    the one mask definition), the first ``cap`` survivors in row-major
    order and the level-3 census, packed as int32 ``[flat_idx[cap] |
    counts[cap] | n2 | tri]`` (``flat_idx = x * F + y``, so F² < 2^31;
    ``tri`` = -1 without the census).  The survivors are valid only when
    ``n2 <= cap``: the caller checks after the fetch and re-extracts with
    :func:`local_pair_regather`."""
    mask = frequent_pair_mask(counts, min_count, num_items)
    flat_idx, cnt, n2 = _survivors(counts, mask, cap)
    tri = (
        _pair_triangles(mask)
        if census
        else torch.full((), -1, dtype=torch.int32, device=counts.device)
    )
    return torch.cat([flat_idx.to(torch.int32), cnt, torch.stack([n2, tri])])


def l3_threshold_pack(
    bitmap: torch.Tensor,  # [T, F] int8 0/1
    w: torch.Tensor,  # [T] int32 raw weights
    mask: torch.Tensor,  # [F, F] bool frequent-pair mask
    n2: torch.Tensor,  # () int32 true survivor count
    min_count: int,
    num_items: int,
    p3: int,  # pair slots counted as prefixes
    cap3: int,  # level-3 survivor budget
    n_digits: int,  # base-128 digits of the largest weight
    count_fn: Callable[..., torch.Tensor],  # K1: (bitmap, wb, s_mat, k1)
) -> torch.Tensor:
    """Level 3 inside the pair program.  The first ``p3`` pair survivors
    of ``mask`` (the slots :func:`pair_threshold_pack` extracts, in the
    same row-major order) are prefix rows of two items, and K1
    (``count_fn``: ops/level_kernel.py ``level_counts`` with its form, or
    its plain version) counts every extension z of each at once, one
    launch per base-128 digit of the weights, summed ``128^d · counts_d``
    in int32 (exact: every count is below the caller's ``n_raw < 2^24``
    gate).  Slots past ``n2`` are zero rows, which K1 takes as padding:
    its device-side tile list drops the tiles made only of them, with no
    host read of ``n2``.  Candidates need z > y with (x, z) and (y, z)
    frequent: the prefix join and the subset prune.  The survivors come
    out row-major in (pair slot, z), which over a lex-sorted pair level
    is lex order in (x, y, z).

    Returns int32 ``[flat3[cap3] | counts3[cap3] | n3]`` with ``flat3 =
    pair_slot * F + z``, valid only when ``n2 <= p3`` and ``n3 <= cap3``:
    the caller checks both after the fetch and counts level 3 with the
    level loop otherwise."""
    f = bitmap.shape[1]
    dev = bitmap.device
    xy = _first_set(mask, p3)
    x, y = xy[:, 0], xy[:, 1]
    slot_valid = torch.arange(p3, device=dev) < n2
    # Pair one-hot rows (rows of the identity, x < y); slots past n2 are
    # zero rows.
    eye = torch.eye(f, dtype=torch.int8, device=dev)
    s2 = (eye.index_select(0, x) + eye.index_select(0, y)) * slot_valid[
        :, None]
    counts3 = None
    for d in range(n_digits):
        digit = (w if d == 0 else w >> (7 * d)) & 127
        part = count_fn(bitmap, bitmap * digit.to(torch.int8)[:, None], s2,
                        2)
        counts3 = part if d == 0 else counts3 + part * 128**d
    col = torch.arange(f, device=dev)
    cand = (
        mask.index_select(0, x)  # (x, z) frequent
        & mask.index_select(0, y)  # (y, z) frequent
        & (col[None, :] > y[:, None])
        & (col[None, :] < num_items)
        & slot_valid[:, None]
    )
    surv = cand & (counts3 >= min_count)
    n3 = surv.sum(dtype=torch.int32)
    flat3 = _flat(_first_set(surv, cap3), f)
    return torch.cat([
        flat3.to(torch.int32),
        counts3.reshape(-1).index_select(0, flat3),
        n3[None],
    ])


def local_pair_regather(
    counts: torch.Tensor,  # [F, F] int32 resident pair counts
    min_count: int,
    num_items: int,
    cap: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first ``cap`` frequent pairs of the resident pair count
    matrix, row-major (also the overflow path of
    :func:`pair_threshold_pack`: no Gram re-run).  Returns ``(flat_idx
    int64[cap], counts int32[cap], n2)``."""
    return _survivors(
        counts, frequent_pair_mask(counts, min_count, num_items), cap)


def _survivors(counts: torch.Tensor, mask: torch.Tensor, cap: int):
    """``(flat_idx int64[cap], counts int32[cap], n2)`` of the first
    ``cap`` true entries of ``mask`` over ``counts``."""
    flat_idx = _flat(_first_set(mask, cap), counts.shape[1])
    return (flat_idx, counts.reshape(-1).index_select(0, flat_idx),
            mask.sum(dtype=torch.int32))


def pack_bits_msb(mask: torch.Tensor) -> torch.Tensor:
    """A 1-D bool mask bit-packed in ``np.packbits``' order (big-endian
    within each byte, zero-padded to whole bytes), uint8."""
    m = mask.to(torch.int32)
    pad = (-m.numel()) % 8
    if pad:
        m = torch.cat([m, m.new_zeros(pad)])
    w = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=m.device)
    return (m.view(-1, 8) * w).sum(dim=1, dtype=torch.int32).to(torch.uint8)


def unpack_bits_msb(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``[n // 8]`` -> bool ``[n]``, the inverse of
    :func:`pack_bits_msb`."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & 1).reshape(-1).to(torch.bool)


def survivor_bits(counts: torch.Tensor, min_count: int) -> torch.Tensor:
    """The survivor mask ``counts >= min_count`` of a 1-D count tensor,
    bit-packed on the device (:func:`pack_bits_msb`): what crosses to the
    host per level when the counts themselves stay on the device."""
    return pack_bits_msb(counts >= min_count)


# ---------------------------------------------------------------------------
# The count reductions across transaction shards (the JAX module's
# ``_psum_if`` and ``local_sparse_psum``), over the per-shard tensors
# through parallel/mesh.py's collectives.


def sparse_union_cap(n_valid: int, override: Optional[int] = None) -> int:
    """Union-compaction slot budget of :func:`local_sparse_psum`:
    ``n_valid / 16`` in a pow2 bucket, floor 1,024, never above the
    candidate count's own bucket; ``override`` (``count_sparse_cap`` /
    ``FA_COUNT_SPARSE_CAP``) is bucketed and clamped the same way."""
    from fastapriori_tpu_torch.ops.bitmap import next_pow2

    ceiling = next_pow2(max(n_valid, 8))
    if override is not None and override > 0:
        return min(next_pow2(override), ceiling)
    return min(next_pow2(max(n_valid // 16, 1024)), ceiling)


def dense_psum(parts: Sequence[torch.Tensor], groups=None) -> torch.Tensor:
    """The dense reduction: the per-shard partial counts summed onto
    shard 0 (the tensor itself on one shard)."""
    from fastapriori_tpu_torch.parallel import mesh

    return mesh.psum(parts, groups)


def local_sparse_psum(
    parts: Sequence[torch.Tensor],  # per-shard int32 partial counts
    thrs: Sequence[int],  # each shard's local-prune threshold
    cap: int,  # union-compaction slot budget
    valid: Optional[torch.Tensor] = None,  # bool candidate mask
    groups=None,  # (groups, per_group) two-level grid, or None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threshold-sparse replacement for the dense psum (the JAX
    module's ``local_sparse_psum``; *Sparse Allreduce*, arxiv
    1312.3020), in three steps:

    1. local prune: shard s keeps the candidates whose local count
       reaches ``thrs[s]``, its weighted-pigeonhole threshold
       ``max(1, ceil(min_count · W_s / W))``: a candidate below every
       shard's threshold sums below min_count, so the union of the
       survivor sets holds every frequent candidate;
    2. the union: the survivor masks, bit-packed, OR-ed across the
       shards (parallel/mesh.py ``union_packed``, two-level with
       ``groups``);
    3. the compact psum: each shard's own counts at the first ``cap``
       union positions, summed across the shards (``psum``) and
       scattered back onto zeros, so the result has the input's shape,
       exact at every union position and 0 elsewhere.

    Returns ``(counts, n_union)`` on shard 0's device (``n_union`` an
    int32 scalar tensor: the host reads it with the level's fetch);
    ``n_union > cap`` means the compaction truncated and the counts are
    unusable.  Nothing here waits for the device."""
    from fastapriori_tpu_torch.parallel import mesh

    flats = [p.reshape(-1) for p in parts]
    n = flats[0].numel()
    assert n % 8 == 0, n
    packed = []
    for fl, thr in zip(flats, thrs):
        keep = fl >= int(thr)
        if valid is not None:
            keep &= valid.reshape(-1).to(fl.device, non_blocking=True)
        packed.append(pack_bits_msb(keep))
    union = unpack_bits_msb(mesh.union_packed(packed, groups))
    n_union = union.sum(dtype=torch.int32)
    upos = torch.nonzero_static(union, size=cap, fill_value=0)[:, 0]
    slot_ok = torch.arange(cap, device=union.device) < n_union
    comps = [
        torch.where(ok, fl.index_select(0, up), 0)
        for fl, up, ok in zip(
            flats, mesh.broadcast(upos, [f.device for f in flats]),
            mesh.broadcast(slot_ok, [f.device for f in flats]))
    ]
    summed = mesh.psum(comps, groups)
    # Overflow fill slots point at position 0 with a 0 contribution, so a
    # real union member at position 0 keeps its exact sum.
    counts = torch.zeros_like(flats[0]).index_add_(
        0, upos, torch.where(slot_ok, summed, 0))
    return counts.reshape(parts[0].shape), n_union


def sparse_psum_bytes(n_valid: int, cap: int, n_shards: int,
                      groups=None) -> Tuple[int, int]:
    """``(gather_bytes, psum_bytes)`` of one :func:`local_sparse_psum`
    (the JAX package's payload model): the mask gather lands S·n/8 bytes
    per shard, ``(per_group + groups)·n/8`` under the two-level
    exchange; the compact psum moves 4·cap (+4 for the union census)."""
    if groups is not None:
        g, per = groups
        return (g + per) * (n_valid // 8), 4 * cap + 4
    return n_shards * (n_valid // 8), 4 * cap + 4


def sparse_stage_bytes(n_valid: int, cap: int, n_shards: int,
                       groups=None) -> Tuple[int, int]:
    """Per-shard ``(intra_bytes, inter_bytes)`` of the payload
    :func:`sparse_psum_bytes` totals: flat, all of it on the one tier;
    two-level, ``per_group`` mask payloads intra, ``groups`` aggregates
    plus the compact psum inter."""
    from fastapriori_tpu_torch.parallel.hier import union_stage_bytes

    intra, inter = union_stage_bytes(n_valid // 8, n_shards, groups)
    return intra, inter + 4 * cap + 4


def prefix_onehot(prefix_cols: torch.Tensor, f_pad: int) -> torch.Tensor:
    """[P, K] column indexes -> [P, F_pad] int8 one-hot rows (padding
    positions point at the all-zero column, which then holds a 1 that
    never overlaps a bitmap row)."""
    p = prefix_cols.shape[0]
    onehot = torch.zeros((p, f_pad), dtype=torch.int8,
                         device=prefix_cols.device)
    onehot.scatter_(1, prefix_cols.long(), 1)
    return onehot


def local_level_gather(
    bitmap: torch.Tensor,  # [T, F] int8
    w_digits: torch.Tensor,  # [D, T] int8
    scales: Sequence[int],
    prefix_cols: torch.Tensor,  # [P, K] int; padding -> zero column
    k1: int,  # real prefix width
    cand_idx: torch.Tensor,  # [C] flat indexes row * F + y
    heavy_b: Optional[torch.Tensor] = None,  # [Th, F] int8
    heavy_w: Optional[torch.Tensor] = None,  # [Th] int32
    count_fn=level_counts,
) -> torch.Tensor:
    """C8 for one prefix chunk: returns the candidates' int32 counts [C].

    One K1 launch per weight digit (a single digit on every real corpus
    after the weight split), each digit's counts scaled by 128^d; then
    the heavy-row remainder; then the gather.  Padded prefix rows point
    at the all-zero column, so their overlap is 0 and they never match a
    k1 >= 1.  ``count_fn``: K1's wrapper, or its plain version where the
    caller chose it (``FA_NO_PALLAS``)."""
    onehot = prefix_onehot(prefix_cols, bitmap.shape[1])
    counts = None
    for d, scale in enumerate(scales):
        wb = bitmap * w_digits[d][:, None]  # int8 in [0, 127]
        part = count_fn(bitmap, wb, onehot, k1)
        part = part if scale == 1 else part * scale
        counts = part if counts is None else counts + part
    if heavy_b is not None:
        counts = counts + heavy_level_correction(onehot, k1, heavy_b, heavy_w)
    return counts.reshape(-1)[cand_idx.long()]
