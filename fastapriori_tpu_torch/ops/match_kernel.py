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
int32 (padding rules have size > F, so they never fire).  Every column
index must lie in [0, F).  Returns int32 [MB].

:func:`first_match` launches the kernel for CUDA tensors and runs
:func:`first_match_plain` only for CPU tensors; its ``launches``
attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from fastapriori_tpu_torch.ops import build

NO_MATCH = 2**31 - 1
# csrc/first_match.cu kMaxF ([F][32] bytes of shared memory) and
# kRulesPerBlock (rule ranges on a grid axis of at most 65535 blocks).
MAX_F = 7168
MAX_RULES = 2048 * 65535


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


def _kernel_fn():
    fn = build.load("first_match").fa_first_match
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


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
    if baskets.device.type == "cpu":
        return first_match_plain(baskets, basket_len, ant, size, cons)
    if baskets.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu, not {baskets.device}")
    mb, f = baskets.shape
    r, k = ant.shape
    if f > MAX_F or r > MAX_RULES or mb >= 2**31:
        raise ValueError(f"K2 takes F <= {MAX_F} and R <= {MAX_RULES}; "
                         f"got MB={mb} F={f} R={r}")
    baskets, basket_len, ant, size, cons = (
        x.contiguous() for x in (baskets, basket_len, ant, size, cons)
    )
    best = torch.full((mb,), NO_MATCH, dtype=torch.int32,
                      device=baskets.device)
    if mb == 0 or r == 0:
        return best
    stream = torch.cuda.current_stream(baskets.device).cuda_stream
    err = _kernel_fn()(
        baskets.data_ptr(), basket_len.data_ptr(), ant.data_ptr(),
        size.data_ptr(), cons.data_ptr(), best.data_ptr(), mb, f, r, k,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"first_match kernel launch failed: CUDA error "
                           f"{err}")
    first_match.launches += 1
    return best


first_match.launches = 0
