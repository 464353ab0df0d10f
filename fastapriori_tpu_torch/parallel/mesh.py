"""The one-process device mesh (counterpart: the single-process part of
fastapriori_tpu/parallel/mesh.py ``DeviceContext``: its ``(txn, cand)``
device grid and the collectives its ``shard_map`` programs issue).

A :class:`Mesh` is an explicit list of shard devices shaped
``(txn_shards, cand_shards)``, txn-major: position ``t·C + c`` holds
transaction shard t (its contiguous block of bitmap rows, or of arena
lanes) and candidate block c.  The list may name one device more than
once: S transaction shards on one card do the same work and the same
reductions as S cards, one after another.

Every cross-shard movement goes through the functions below, over the
list of per-shard tensors in shard order:

- :func:`psum`: the integer sum;
- :func:`all_gather`: the per-shard tensors stacked;
- :func:`union_packed`: the OR of bit-packed masks;
- :func:`tiled_all_gather`: the per-shard blocks concatenated;
- :func:`broadcast`: one tensor onto every shard's device.

The reductions return one tensor on shard 0's device, where the host
reads it (each shard of the JAX form holds the same value).  With a
``(groups, per_group)`` spec the three reductions stage through
parallel/hier.py; without, they are the flat forms.  The work of each
shard is issued in a plain loop on its device's current stream; an error
of any shard's launch propagates.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from fastapriori_tpu_torch.errors import InputError

Spec = Optional[Tuple[int, int]]


def resolve_devices(
    device: Optional[Union[str, torch.device]] = None,
    num_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> List[torch.device]:
    """The shard devices of a mesh.  ``devices``: an explicit list (it
    may repeat a device), cut to ``num_devices`` when that is given.
    Else from ``device``: the CPU gives ``num_devices`` CPU shards (1 by
    default); CUDA gives ``device``'s card for one shard, and cards
    ``0..S-1`` for S > 1.  With ``num_devices`` None, a named device is
    one shard and no device (the CLI's default platform) is every
    visible card.  Asking for more cards than are visible is an
    InputError: the JAX package would quietly take fewer."""
    from fastapriori_tpu_torch.device import resolve_device

    if num_devices is not None and num_devices < 1:
        raise InputError(f"num_devices must be >= 1, got {num_devices}")
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if num_devices is not None:
            if num_devices > len(devs):
                raise InputError(
                    f"num_devices={num_devices} exceeds the "
                    f"{len(devs)} devices given")
            devs = devs[:num_devices]
        if not devs:
            raise InputError("a mesh needs at least one device")
        return devs
    base = resolve_device(device)
    if base.type == "cpu":
        return [base] * (num_devices or 1)
    visible = torch.cuda.device_count()
    if num_devices is None and device is not None:
        return [base]
    n = visible if num_devices is None else num_devices
    if n > visible:
        raise InputError(
            f"--num-devices {n} exceeds the {visible} visible CUDA "
            f"device{'s' if visible != 1 else ''}")
    if n == 1:
        return [base]
    return [resolve_device(f"cuda:{i}") for i in range(n)]


class Mesh:
    """``devices`` shaped ``(txn_shards, cand_shards)``, txn-major."""

    def __init__(self, devices: Sequence[torch.device],
                 cand_shards: int = 1):
        devs = list(devices)
        if cand_shards < 1 or len(devs) % cand_shards != 0:
            raise InputError(
                f"cand_devices={cand_shards} must be >= 1 and divide the "
                f"device count ({len(devs)}); with --platform cpu, pass "
                "--num-devices to provision that many CPU shards")
        self.devices = devs
        self.n_devices = len(devs)
        self.cand_shards = cand_shards
        self.txn_shards = len(devs) // cand_shards

    def device(self, t: int, c: int = 0) -> torch.device:
        """The device of transaction shard ``t``, candidate block ``c``."""
        return self.devices[t * self.cand_shards + c]

    def txn_devices(self, c: int = 0) -> List[torch.device]:
        """The devices of candidate block ``c``, in transaction-shard
        order."""
        return [self.device(t, c) for t in range(self.txn_shards)]

    def txn_shards_per_device(self) -> int:
        """The most transaction shards of one candidate block that share
        one device: the multiple of one shard's buffers that device
        holds."""
        devs = self.txn_devices()
        return max(devs.count(d) for d in devs)

    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


# ---------------------------------------------------------------------------
# Flat collectives (the single-level exchange; parallel/hier.py stages
# the same operations in two levels).


def flat_psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ of the per-shard tensors on ``xs[0]``'s device (the tensor itself
    for one shard)."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x.to(acc.device, non_blocking=True)
    return acc


def all_gather(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The per-shard tensors stacked ``[S, ...]`` on shard 0's device."""
    dst = xs[0].device
    return torch.stack([x.to(dst, non_blocking=True) for x in xs])


def flat_union_packed(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The OR of bit-packed uint8 masks: :func:`all_gather`, then the OR
    over the shard axis."""
    if len(xs) == 1:
        return xs[0]
    g = all_gather(xs)
    out = g[0].clone()
    for i in range(1, g.shape[0]):
        out |= g[i]
    return out


def flat_tiled_all_gather(xs: Sequence[torch.Tensor],
                          axis: int = 0) -> torch.Tensor:
    """The per-shard blocks concatenated along ``axis`` in shard order,
    on shard 0's device."""
    if len(xs) == 1:
        return xs[0]
    dst = xs[0].device
    return torch.cat([x.to(dst, non_blocking=True) for x in xs], dim=axis)


def psum(xs: Sequence[torch.Tensor], spec: Spec = None) -> torch.Tensor:
    """The integer sum of the per-shard tensors, flat or two-level."""
    if spec is None:
        return flat_psum(xs)
    from fastapriori_tpu_torch.parallel.hier import hier_psum

    return hier_psum(xs, spec)


def union_packed(xs: Sequence[torch.Tensor],
                 spec: Spec = None) -> torch.Tensor:
    """The OR-union of per-shard bit-packed masks, flat or two-level."""
    if spec is None:
        return flat_union_packed(xs)
    from fastapriori_tpu_torch.parallel.hier import hier_union_packed

    return hier_union_packed(xs, spec)


def tiled_all_gather(xs: Sequence[torch.Tensor], axis: int = 0,
                     spec: Spec = None) -> torch.Tensor:
    """The per-shard blocks concatenated in shard order, flat or
    two-level."""
    if spec is None:
        return flat_tiled_all_gather(xs, axis)
    from fastapriori_tpu_torch.parallel.hier import hier_tiled_all_gather

    return hier_tiled_all_gather(xs, axis, spec)


def broadcast(x: torch.Tensor,
              devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` on each of ``devices``: one copy per distinct device (``x``
    itself on its own device)."""
    copies = {x.device: x}
    out = []
    for d in devices:
        if d not in copies:
            copies[d] = x.to(d, non_blocking=True)
        out.append(copies[d])
    return out
