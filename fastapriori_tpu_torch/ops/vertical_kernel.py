"""K3: the vertical engine's level-k support count by lane-wise AND +
popcount.

Replaces the Pallas TPU kernel ``_vertical_kernel`` of
fastapriori_tpu/ops/pallas_vertical.py (launched through
``vertical_counts_pallas``); the CUDA source is
``fastapriori_tpu_torch/csrc/vertical_counts.cu``, whose header says what
bounds the kernel on an H100 and what its design does about it.

    count[c] = Σ_b 2^b · popcount(AND_k arena[prefix_cols[row, k]]
                                  & arena[y] & planes[b])

summed over all lanes, with ``c = row · f_pad + y`` the flat candidate
index and ``f_pad = arena.shape[0] - 1``.  ``arena`` int32 [f_pad+1, NL]
holds each item's packed tid lanes (bit-identical to the JAX package's
uint32 arena; row ``f_pad`` is the all-ones AND identity), ``planes``
int32 [B, NL] the weight bit-planes with ``scales[b] == 2^b``,
``prefix_cols`` int32 [P, K] the prefix rows (an entry equal to
``f_pad - 1``, the all-zero column, means "no item" and ANDs as row
``f_pad``), ``cand_idx`` int32 [C].  Returns int32 [C].

The input contract, which models/apriori.py ``level_chunks`` meets:
prefix entries lie in [0, f_pad], candidates in [0, P · f_pad), and
candidates come in whole runs per prefix row (``cand_idx // f_pad`` does
not decrease).  :func:`vertical_counts` raises ValueError for an input
that breaks it on the CPU; on the card the kernel's device-side assert
fails the launch (a CUDA error at the next synchronisation).

:func:`vertical_counts` launches the kernel for CUDA tensors and runs
:func:`vertical_counts_plain` only for CPU tensors; its ``launches``
attribute counts kernel launches.  The kernel reads plane words only
where :func:`lane_plane_mask` says a plane is non-zero, a mask derived on
the device once per planes upload; the run starts of the candidates are
derived by the launch itself.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Sequence

import torch

from fastapriori_tpu_torch.ops import build

# csrc/vertical_counts.cu kMaxPlanes: weight bit-planes (weights < 2^31).
MAX_PLANES = 31
_LOW32 = 0xFFFFFFFF


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit word of an int32 tensor, as int64 (SWAR on
    int64: torch has no popcount, and its int32 shifts are arithmetic)."""
    x = x.to(torch.int64) & _LOW32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _LOW32) >> 24


def _popcount_weighted(
    inter: torch.Tensor,  # [C, NL] int32 intersection lanes
    w_planes: torch.Tensor,  # [B, NL] int32 weight bit-planes
    scales: Sequence[int],
) -> torch.Tensor:
    """``counts[c] = Σ_t w_t · [t ∈ inter_c]`` via per-plane popcounts
    (counterpart: fastapriori_tpu/ops/vertical.py ``_popcount_weighted``);
    int32 [C]."""
    total = None
    for b, scale in enumerate(scales):
        part = _popcount32(inter & w_planes[b][None, :]).sum(dim=1) * scale
        total = part if total is None else total + part
    return total.to(torch.int32)


def _prefix_and(arena: torch.Tensor, prefix_cols: torch.Tensor) -> torch.Tensor:
    """AND of each prefix row's member lanes, [P, NL] int32 (counterpart:
    fastapriori_tpu/ops/vertical.py ``_prefix_and``): entries equal to the
    all-zero column ``f_pad - 1`` remap to the all-ones row ``f_pad``."""
    f_pad = arena.shape[0] - 1
    cols = prefix_cols.long()
    cols = torch.where(cols == f_pad - 1, f_pad, cols)
    acc = arena[cols[:, 0]]
    for i in range(1, cols.shape[1]):
        acc = acc & arena[cols[:, i]]
    return acc


def vertical_counts_plain(
    arena: torch.Tensor,
    w_planes: torch.Tensor,
    scales: Sequence[int],
    prefix_cols: torch.Tensor,
    cand_idx: torch.Tensor,
    cand_chunk: int = 1 << 12,
) -> torch.Tensor:
    """The same function in plain PyTorch (the JAX package's XLA path,
    ops/vertical.py ``_chunked_candidate_counts``): the [P, NL] prefix
    ANDs, then candidates in chunks of ``cand_chunk``, which bounds the
    [chunk, NL] intersection intermediate."""
    f_pad = arena.shape[0] - 1
    pref = _prefix_and(arena, prefix_cols)
    out = torch.empty(cand_idx.shape[0], dtype=torch.int32,
                      device=arena.device)
    for c0 in range(0, cand_idx.shape[0], cand_chunk):
        ix = cand_idx[c0 : c0 + cand_chunk].long()
        inter = pref[ix // f_pad] & arena[ix % f_pad]
        out[c0 : c0 + ix.shape[0]] = _popcount_weighted(inter, w_planes,
                                                        scales)
    return out


def _check(arena, w_planes, scales, prefix_cols, cand_idx) -> None:
    for name, x, dim in (("arena", arena, 2), ("w_planes", w_planes, 2),
                         ("prefix_cols", prefix_cols, 2),
                         ("cand_idx", cand_idx, 1)):
        if x.dtype != torch.int32 or x.dim() != dim:
            raise ValueError(f"{name} must be a {dim}-D int32 tensor, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != arena.device:
            raise ValueError(f"{name} is on {x.device}, arena on "
                             f"{arena.device}")
    b = w_planes.shape[0]
    if w_planes.shape[1] != arena.shape[1] or not 1 <= b <= MAX_PLANES:
        raise ValueError(f"w_planes {tuple(w_planes.shape)} must be [B, NL] "
                         f"with 1 <= B <= {MAX_PLANES}, arena "
                         f"{tuple(arena.shape)}")
    if list(scales) != [1 << i for i in range(b)]:
        raise ValueError(f"scales must be the powers of two 2^0..2^{b - 1}, "
                         f"got {list(scales)}")
    if arena.shape[0] < 2 or prefix_cols.shape[1] < 1:
        raise ValueError(f"arena {tuple(arena.shape)} needs at least one "
                         f"item row, prefix_cols {tuple(prefix_cols.shape)} "
                         f"at least one column")
    if prefix_cols.shape[0] * (arena.shape[0] - 1) >= 2**31:
        raise ValueError("P * f_pad must stay below 2^31 (int32 candidate "
                         "indexes)")


def _check_contract(arena, prefix_cols, cand_idx) -> None:
    """The input contract on the host (the kernel asserts it on the
    device, so a CUDA launch pays no host round trip for it)."""
    f_pad = arena.shape[0] - 1
    p = prefix_cols.shape[0]
    if prefix_cols.numel() and not (
        (prefix_cols >= 0) & (prefix_cols <= f_pad)
    ).all():
        raise ValueError(f"prefix_cols entries must lie in [0, {f_pad}]")
    if cand_idx.numel():
        rows = cand_idx.long() // f_pad
        if not ((cand_idx >= 0) & (rows < p)).all():
            raise ValueError(f"cand_idx entries must lie in [0, P * f_pad) "
                             f"= [0, {p * f_pad})")
        if not (rows[1:] >= rows[:-1]).all():
            raise ValueError("cand_idx must come in whole runs per prefix "
                             "row (cand_idx // f_pad non-decreasing)")


# (weak reference to the planes tensor, its version, its lane mask) of the
# last lane_plane_mask call.
_last_mask: list = [None, None, None]


def lane_plane_mask(w_planes: torch.Tensor) -> torch.Tensor:
    """int32 [NL]: bit ``b`` set where plane ``b`` is non-zero in that
    lane, the planes the kernel reads for a non-zero intersection word
    there (a zero plane word adds nothing).  Cached for the last planes
    tensor seen (and its in-place version), so the vertical engine derives
    it once per upload (device.py ``upload_lane_planes``)."""
    ref, version, mask = _last_mask
    if ref is not None and ref() is w_planes and version == w_planes._version:
        return mask
    bits = torch.arange(w_planes.shape[0], dtype=torch.int32,
                        device=w_planes.device)
    mask = ((w_planes != 0).to(torch.int32) << bits[:, None]).sum(
        dim=0, dtype=torch.int32)
    _last_mask[:] = [weakref.ref(w_planes), w_planes._version, mask]
    return mask


def _kernel_fn():
    fn = build.load("vertical_counts").fa_vertical_counts
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


def vertical_counts(
    arena: torch.Tensor,
    w_planes: torch.Tensor,
    scales: Sequence[int],
    prefix_cols: torch.Tensor,
    cand_idx: torch.Tensor,
    cand_chunk: int = 1 << 12,
) -> torch.Tensor:
    """K3 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version (over ``cand_chunk`` candidates at a time) for CPU
    tensors."""
    _check(arena, w_planes, scales, prefix_cols, cand_idx)
    if arena.device.type == "cpu":
        _check_contract(arena, prefix_cols, cand_idx)
        return vertical_counts_plain(arena, w_planes, scales, prefix_cols,
                                     cand_idx, cand_chunk)
    if arena.device.type != "cuda":
        raise ValueError(f"K3 runs on cuda or cpu, not {arena.device}")
    f_pad = arena.shape[0] - 1
    nl = arena.shape[1]
    p, k = prefix_cols.shape
    c = cand_idx.shape[0]
    arena, w_planes, prefix_cols, cand_idx = (
        x.contiguous() for x in (arena, w_planes, prefix_cols, cand_idx)
    )
    out = torch.zeros(c, dtype=torch.int32, device=arena.device)
    if c == 0 or nl == 0:
        return out
    if p == 0:
        raise ValueError("cand_idx holds candidates but prefix_cols no row")
    mask = lane_plane_mask(w_planes)
    # The work counter (8 bytes) and the run starts [P + 1], written by
    # the kernel's first pass.
    scratch = torch.empty(p + 3, dtype=torch.int32, device=arena.device)
    stream = torch.cuda.current_stream(arena.device).cuda_stream
    err = _kernel_fn()(
        arena.data_ptr(), w_planes.data_ptr(), mask.data_ptr(),
        prefix_cols.data_ptr(), cand_idx.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), f_pad, nl, w_planes.shape[0], p, k, c, stream,
    )
    if err != 0:
        raise RuntimeError(f"vertical_counts kernel launch failed: CUDA "
                           f"error {err}")
    vertical_counts.launches += 1
    return out


vertical_counts.launches = 0
