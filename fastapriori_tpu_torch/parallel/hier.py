"""Two-level exchange over the transaction shards (counterpart:
fastapriori_tpu/parallel/hier.py).

The S transaction shards are viewed as a ``(groups, per_group)`` grid of
contiguous rank ranges.  A two-level collective runs first inside each
group (stage 1, the intra tier), then once across the groups (stage 2,
the inter tier).  For the reductions (the OR-union of packed survivor
masks, the compact int32 psum) the intra stage folds ``per_group``
payloads into one group aggregate, so the inter stage moves ``groups``
aggregates instead of S payloads: per shard ``(per_group + groups)·b``
bytes instead of ``S·b``.  For the tiled all-gather the bytes received
are the same; the inter stage moves whole group chunks.

The topology and byte models are the JAX module's, copied (the port
imports nothing of the JAX package).  The three primitives take the list
of per-shard tensors, in shard order, and return the one result on shard
0's device: every shard of the JAX form ends holding that same value.
They are bit-exact twins of the flat forms in parallel/mesh.py (OR and
int32 addition are associative and commutative; groups are contiguous
rank ranges, so group-major concatenation is shard order).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from fastapriori_tpu_torch.errors import InputError

# A resolved topology: (groups, per_group), groups * per_group == S, both
# > 1.  None is the flat single-level exchange.
GroupSpec = Optional[Tuple[int, int]]


def index_groups(spec: Tuple[int, int]):
    """The two partitions of a ``(groups, per_group)`` grid over shard
    indexes ``0..S-1``: ``intra``, one contiguous rank range per group,
    and ``inter``, one column per position inside a group (rank ``g·per
    + c`` of every group g)."""
    groups, per = spec
    intra = [[g * per + i for i in range(per)] for g in range(groups)]
    inter = [[g * per + i for g in range(groups)] for i in range(per)]
    return intra, inter


def auto_group_count(n_shards: int, n_procs: int = 1) -> int:
    """The group count of the automatic topology: the process count when
    it divides the shards, else the divisor of S nearest below √S; 1
    (flat) when no grid strictly beats the flat exchange (fewer than 8
    shards, or S prime)."""
    if n_shards < 8 and not (1 < n_procs < n_shards):
        return 1
    if 1 < n_procs < n_shards and n_shards % n_procs == 0:
        return n_procs
    best = 1
    for g in range(int(math.isqrt(n_shards)), 1, -1):
        if n_shards % g == 0:
            best = g
            break
    if best == 1 or best + n_shards // best >= n_shards:
        return 1
    return best


def resolve_spec(n_shards: int, requested: int,
                 n_procs: int = 1) -> GroupSpec:
    """The grid for a group-count request: 0 = automatic
    (:func:`auto_group_count`), 1 or ``n_shards`` = flat (None), any
    other value must divide ``n_shards`` (InputError otherwise)."""
    if requested < 0:
        raise InputError(
            f"exchange_groups must be >= 0 (0 = auto, 1 = flat), got "
            f"{requested}")
    if requested == 0:
        requested = auto_group_count(n_shards, n_procs)
    if requested in (1, n_shards):
        return None
    if n_shards % requested != 0:
        raise InputError(
            f"exchange_groups={requested} does not divide the txn mesh "
            f"axis ({n_shards} shards): use a divisor, 1 (flat), or 0 "
            "(auto)")
    return (requested, n_shards // requested)


def resolve_active_spec(n_shards: int, config=None, n_procs: int = 1,
                        unclamped: bool = False) -> GroupSpec:
    """The mine's topology: ``FA_EXCHANGE_GROUPS`` (strictly parsed: a
    value that is not an integer >= 0 is an InputError) over
    ``config.exchange_groups``, through :func:`resolve_spec` for
    ``n_procs`` processes (auto: a group per process), then the quorum
    domain's floor: once any rank walked ``exchange`` hier -> flat,
    every rank issues the flat collectives.  ``unclamped`` skips the
    floor (the caller that records the clamp)."""
    from fastapriori_tpu_torch.reliability import quorum
    from fastapriori_tpu_torch.utils.env import env_int

    req = env_int("FA_EXCHANGE_GROUPS", -1, minimum=0)
    if req < 0:
        req = getattr(config, "exchange_groups", 0) if config else 0
    spec = resolve_spec(n_shards, req, n_procs)
    if (spec is not None and not unclamped
            and not quorum.stage_allowed("exchange", "hier")):
        return None
    return spec


def describe_spec(spec: GroupSpec) -> str:
    """``"hier(GxP)"`` or ``"flat"``."""
    if spec is None:
        return "flat"
    return f"hier({spec[0]}x{spec[1]})"


def spill_order(primary: int, n_hosts: int, groups: int = 0) -> list:
    """The hosts a serving request tries, primary first: the primary's
    group of the :func:`resolve_spec` grid in ring order, then the other
    hosts in ring order (the plain ring when there is no grid)."""
    if not 0 <= primary < n_hosts:
        raise InputError(
            f"spill_order: primary {primary} outside 0..{n_hosts - 1}")
    spec = resolve_spec(n_hosts, groups)
    ring = [(primary + k) % n_hosts for k in range(n_hosts)]
    if spec is None:
        return ring
    _g, per = spec
    pod = primary // per
    return ([h for h in ring if h // per == pod]
            + [h for h in ring if h // per != pod])


# ---------------------------------------------------------------------------
# The two-level primitives over lists of per-shard tensors.


def _stage(xs: Sequence, spec: Tuple[int, int], combine) -> List:
    """Stage 1 of a two-level collective: ``combine`` over each group's
    tensors, onto the group's first shard's device."""
    intra, _ = index_groups(spec)
    return [combine([xs[i] for i in grp]) for grp in intra]


def hier_union_packed(xs: Sequence, spec: Tuple[int, int]):
    """Two-level OR-union of per-shard bit-packed masks: each group's
    union, then the union of the group aggregates."""
    from fastapriori_tpu_torch.parallel.mesh import flat_union_packed

    return flat_union_packed(_stage(xs, spec, flat_union_packed))


def hier_psum(xs: Sequence, spec: Tuple[int, int]):
    """Two-level integer sum: each group's sum, then the sum of the group
    aggregates."""
    from fastapriori_tpu_torch.parallel.mesh import flat_psum

    return flat_psum(_stage(xs, spec, flat_psum))


def hier_tiled_all_gather(xs: Sequence, axis: int, spec: Tuple[int, int]):
    """Two-level concatenation of per-shard blocks along ``axis`` in
    shard order: each group's contiguous chunk, then the group chunks in
    group order."""
    from fastapriori_tpu_torch.parallel.mesh import flat_tiled_all_gather

    return flat_tiled_all_gather(
        _stage(xs, spec, lambda g: flat_tiled_all_gather(g, axis)), axis)


# ---------------------------------------------------------------------------
# Byte models (host arithmetic; the level events cite them).


def union_stage_bytes(n_bytes: int, n_shards: int,
                      spec: GroupSpec) -> Tuple[int, int]:
    """Per-shard ``(intra, inter)`` bytes received by one mask union of
    ``n_bytes`` per shard: flat, all on the one tier; two-level,
    ``per·b`` intra and ``groups·b`` inter."""
    if spec is None:
        return 0, n_shards * n_bytes
    groups, per = spec
    return per * n_bytes, groups * n_bytes


def gather_stage_bytes(n_bytes: int, n_shards: int,
                       spec: GroupSpec) -> Tuple[int, int]:
    """Per-shard ``(intra, inter)`` bytes received by one tiled
    all-gather of ``n_bytes`` per shard (the total, S·b, does not
    change; the inter stage moves whole group chunks)."""
    if spec is None:
        return 0, n_shards * n_bytes
    groups, per = spec
    return per * n_bytes, groups * per * n_bytes
