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

On the host the planes are ``uint32`` arrays, word for word the JAX
package's; on the device the arena and the planes are ``int32`` tensors
with the same bits (torch's unsigned 32-bit type lacks the operations
needed).

- k = 2: every pair is a candidate, so the pair phase is a Gram product
  over lane chunks unpacked to 0/1 bits (:func:`vertical_pair_local`).
- k >= 3: only the actual candidates are counted, by K3
  (ops/vertical_kernel.py, which also holds the JAX module's
  ``_prefix_and`` and ``_popcount_weighted`` beside K3's plain version).

The arena is built on the device from the basket CSR, at
:func:`arena_shape`'s shape (ops/vertical_kernel.py ``build_arena``: the
CUDA kernel on a card, its plain version on the CPU), with the words of
the JAX package's host builder.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from fastapriori_tpu_torch.ops.bitmap import pad_axis
from fastapriori_tpu_torch.ops.vertical_kernel import vertical_counts

# Transactions per chunk of the pair phase's unpacked [f_pad, chunk] bit
# matrix (the JAX package's level_txn_chunk default).
PAIR_TXN_CHUNK = 1 << 14


# ---------------------------------------------------------------------------
# host-side shapes and planes


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


def arena_shape(t: int, num_items: int, txn_multiple: int = 32,
                item_multiple: int = 128) -> Tuple[int, int]:
    """``(f_pad, t_pad)`` of the arena over ``t`` transactions and
    ``num_items`` items: ``t_pad = pad_axis(t, lcm(txn_multiple, 32))``
    and ``f_pad = pad_axis(num_items + 1, item_multiple)``, so row
    ``f_pad - 1`` is always an all-zero item row."""
    mult = txn_multiple * 32 // math.gcd(txn_multiple, 32)
    return pad_axis(num_items + 1, item_multiple), pad_axis(t, mult)


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
