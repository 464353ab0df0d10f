"""K2: first-match recommend scan over the priority-sorted rule table.

Replaces the Pallas TPU kernel ``_match_kernel`` of
fastapriori_tpu/ops/pallas_vertical.py (launched through
``strided_best_rank_pallas``) at one shard, where a rule's global rank is
its row; the CUDA source is ``fastapriori_tpu_torch/csrc/first_match.cu``,
whose header says what bounds the kernel on an H100 and what its design
does about it.

    best[b] = min{r : Σ_k baskets[b, ant[r, k]] == size[r],
                      size[r] <= len[b], baskets[b, cons[r]] == 0}

or ``NO_MATCH`` (2^31 - 1) when no rule fires.  ``baskets`` [MB, F]
int8, ``basket_len`` [MB] int32, ``ant`` [R, K] int32 whose padding
positions point at an all-zero basket column, ``size`` and ``cons`` [R]
int32 (padding rules have size > F, so they never fire).  Returns int32
[MB].

The input contract, which ops/contain.py ``rule_table`` and ops/bitmap.py
``build_bitmap`` meet: baskets are 0/1, every column index lies in
[0, F), ``size >= 1``, and the positions ``k >= size[r]`` of ``ant[r]``
point at a column that is zero in every basket.  The kernel tests the
first ``size[r]`` positions as bits, which equals the sum under that
contract.  :func:`first_match` raises ValueError for an input that breaks
it on the CPU; on the card nothing checks it.  Any F is taken;
:func:`check_limits` holds the remaining limits on MB and R.

:func:`first_match` launches the kernel for CUDA tensors and runs
:func:`first_match_plain` only for CPU tensors; its ``launches``
attribute counts kernel launches (one per call: the packing pass and the
match kernel of csrc/first_match.cu).  :func:`work_plan` cuts the work
into (basket group, rule range) items.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from fastapriori_tpu_torch.ops import build

NO_MATCH = 2**31 - 1
# csrc/first_match.cu kG (baskets per group) and kRT (rules per tile).
GROUP = 64
RULE_TILE = 256
# Work items (basket group, rule range) per persistent block.
ITEMS_PER_BLOCK = 16
# Ranks and tile offsets stay below NO_MATCH, basket rows in int32.
MAX_RULES = 2**31 - RULE_TILE
MAX_BASKETS = 2**31 - GROUP


def first_match_plain(
    baskets: torch.Tensor,
    basket_len: torch.Tensor,
    ant: torch.Tensor,
    size: torch.Tensor,
    cons: torch.Tensor,
    rule_chunk: int = 4096,
) -> torch.Tensor:
    """The same function in plain PyTorch: gather, compare and a running
    minimum over rule chunks (bounding the [MB, chunk, K] gather)."""
    mb = baskets.shape[0]
    r, k = ant.shape
    b32 = baskets.to(torch.int32)
    best = torch.full((mb,), NO_MATCH, dtype=torch.int32,
                      device=baskets.device)
    for r0 in range(0, r, rule_chunk):
        a = ant[r0 : r0 + rule_chunk].long()
        rc = a.shape[0]
        overlap = b32[:, a.reshape(-1)].reshape(mb, rc, k).sum(dim=2)
        sz = size[r0 : r0 + rc]
        eligible = (
            (overlap == sz[None, :])
            & (sz[None, :] <= basket_len[:, None])
            & (b32[:, cons[r0 : r0 + rc].long()] == 0)
        )
        ranks = torch.arange(r0, r0 + rc, dtype=torch.int32,
                             device=baskets.device)
        hit = torch.where(eligible, ranks[None, :],
                          torch.full_like(ranks, NO_MATCH)[None, :])
        best = torch.minimum(best, hit.min(dim=1).values)
    return best


def check_limits(mb: int, f: int, r: int, k: int) -> None:
    """The kernel's limits on its shapes, which no F reaches: raises
    ValueError outside them."""
    if f < 1 or k < 1:
        raise ValueError(f"K2 needs F >= 1 and K >= 1; got F={f} K={k}")
    if mb > MAX_BASKETS or r > MAX_RULES:
        raise ValueError(f"K2 takes MB <= {MAX_BASKETS} and R <= "
                         f"{MAX_RULES}; got MB={mb} R={r}")


def work_plan(mb: int, r: int, blocks: int) -> Tuple[int, int, int]:
    """``(groups, tiles_per_range, ranges)``: the kernel's work items are
    every (group of ``GROUP`` baskets, range of ``tiles_per_range``
    ``RULE_TILE``-rule tiles) pair, about ``ITEMS_PER_BLOCK`` per block of
    a ``blocks``-block wave, so a table is split across the card when
    there are few baskets."""
    groups = -(-mb // GROUP)
    tiles = -(-r // RULE_TILE)
    ranges = min(tiles, max(1, -(-ITEMS_PER_BLOCK * blocks // groups)))
    per_range = -(-tiles // ranges)
    return groups, per_range, -(-tiles // per_range)


def _check(baskets, basket_len, ant, size, cons) -> None:
    if baskets.dtype != torch.int8 or baskets.dim() != 2:
        raise ValueError(f"baskets must be a 2-D int8 tensor, got "
                         f"{baskets.dtype} {tuple(baskets.shape)}")
    mb = baskets.shape[0]
    r = ant.shape[0] if ant.dim() == 2 else -1
    for name, x, shape in (
        ("basket_len", basket_len, (mb,)),
        ("ant", ant, (r, ant.shape[-1])),
        ("size", size, (r,)),
        ("cons", cons, (r,)),
    ):
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be int32 of shape {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != baskets.device:
            raise ValueError(f"{name} is on {x.device}, baskets on "
                             f"{baskets.device}")


def _check_contract(baskets, ant, size, cons) -> None:
    """The input contract on the host (unchecked on the card, so a CUDA
    launch pays no host round trip for it)."""
    f = baskets.shape[1]
    if baskets.numel() and not ((baskets == 0) | (baskets == 1)).all():
        raise ValueError("baskets must be 0/1")
    for name, x in (("ant", ant), ("cons", cons)):
        if x.numel() and not ((x >= 0) & (x < f)).all():
            raise ValueError(f"{name} entries must lie in [0, {f})")
    if size.numel() and not (size >= 1).all():
        raise ValueError("size entries must be >= 1")
    present = (baskets != 0).any(dim=0)
    past = (torch.arange(ant.shape[1], device=ant.device)[None, :]
            >= size[:, None])
    if present[ant.long()][past].any():
        raise ValueError("ant positions k >= size[r] must point at a column "
                         "that is zero in every basket")


def _kernel_fns():
    lib = build.load("first_match")
    fn, blocks = lib.fa_first_match, lib.fa_first_match_blocks
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        blocks.argtypes = [ctypes.c_int, ctypes.c_int]
        blocks.restype = ctypes.c_int
    return fn, blocks


# (device index, F, K) -> blocks of one wave of the match kernel.
_WAVE: Dict[Tuple[int, int, int], int] = {}


def _wave_blocks(device: torch.device, f: int, k: int) -> int:
    key = (device.index or 0, f, k)
    if key not in _WAVE:
        with torch.cuda.device(device):
            n = _kernel_fns()[1](f, k)
        if n <= 0:
            raise RuntimeError(f"first_match occupancy query failed: CUDA "
                               f"error {-n}")
        _WAVE[key] = n
    return _WAVE[key]


def first_match(
    baskets: torch.Tensor,
    basket_len: torch.Tensor,
    ant: torch.Tensor,
    size: torch.Tensor,
    cons: torch.Tensor,
) -> torch.Tensor:
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    _check(baskets, basket_len, ant, size, cons)
    mb, f = baskets.shape
    r, k = ant.shape
    check_limits(mb, f, r, k)
    if baskets.device.type == "cpu":
        _check_contract(baskets, ant, size, cons)
        return first_match_plain(baskets, basket_len, ant, size, cons)
    if baskets.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu, not {baskets.device}")
    # The library reads the current card and launches there: make that
    # the tensors' card, which a mesh shard need not share with the
    # caller.
    with torch.cuda.device(baskets.device):
        if mb == 0 or r == 0:
            return torch.full((mb,), NO_MATCH, dtype=torch.int32,
                              device=baskets.device)
        baskets, basket_len, ant, size, cons = (
            x.contiguous() for x in (baskets, basket_len, ant, size, cons)
        )
        blocks = _wave_blocks(baskets.device, f, k)
        groups, per_range, _ = work_plan(mb, r, blocks)
        # The packed baskets, then the 8-byte work counter.
        scratch = torch.empty(groups * GROUP * -(-f // 32) + 2,
                              dtype=torch.int32, device=baskets.device)
        best = torch.empty(mb, dtype=torch.int32, device=baskets.device)
        stream = torch.cuda.current_stream(baskets.device).cuda_stream
        err = _kernel_fns()[0](
            baskets.data_ptr(), basket_len.data_ptr(), ant.data_ptr(),
            size.data_ptr(), cons.data_ptr(), scratch.data_ptr(),
            best.data_ptr(), mb, f, r, k, groups, per_range, blocks, stream,
        )
    if err != 0:
        raise RuntimeError(f"first_match kernel launch failed: CUDA error "
                           f"{err}")
    first_match.launches += 1
    return best


first_match.launches = 0
