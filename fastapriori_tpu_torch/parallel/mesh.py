"""The device mesh (counterpart: fastapriori_tpu/parallel/mesh.py
``DeviceContext``'s ``(txn, cand)`` device grid, the collectives its
``shard_map`` programs issue, and ``initialize_distributed`` /
``allgather_bytes`` for a multi-process world).

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

A multi-process world (``--distributed``: :func:`initialize_distributed`
over ``torch.distributed``'s ``env://``) is process-major, as the JAX
package's: the global transaction shard ``p·L + t`` is local shard t of
process p, each process holding L shards, and the lists above hold a
process's own shards.  Each reduction then first folds the process's
shards, then makes one process-group call (all-reduce or all-gather in
rank order), so every rank ends with the same value, as every shard of
the JAX form does; at that width the two-level staging is exactly that
(the process's shards, then the processes), whatever the spec.  The
backend is NCCL when every rank has a card of its own, else gloo (the
CPU, or ranks sharing one card; NCCL refuses two ranks on one card),
under which CUDA tensors cross through pinned host memory.
"""

from __future__ import annotations

import datetime
import os
import time
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
    """``devices`` shaped ``(txn_shards, cand_shards)``, txn-major: this
    process's shards.  ``world`` and ``rank``: the processes of a
    ``--distributed`` world (1 and 0 in one process), each holding a
    mesh of this shape; the global mesh is process-major."""

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
        self.world = process_count()
        self.rank = process_index()
        if self.world > 1 and cand_shards != 1:
            raise InputError(
                "a multi-process world shards the transactions only: "
                "--cand-devices must be 1 with --distributed")

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
    """The per-shard tensors stacked ``[S, ...]`` on shard 0's device (in
    a multi-process world, every process's shards in rank order)."""
    local = _local_all_gather(xs)
    if _WORLD is None:
        return local
    return torch.cat(_pg_all_gather(local, "all_gather"))


def _local_all_gather(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    dst = xs[0].device
    return torch.stack([x.to(dst, non_blocking=True) for x in xs])


def flat_union_packed(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The OR of bit-packed uint8 masks: :func:`all_gather`, then the OR
    over the shard axis."""
    if len(xs) == 1:
        return xs[0]
    g = _local_all_gather(xs)
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


def psum(xs: Sequence[torch.Tensor], spec: Spec = None,
         local: bool = False) -> torch.Tensor:
    """The integer sum of the per-shard tensors, flat or two-level; in a
    multi-process world, over every process's shards (with ``local``,
    this process's only)."""
    if _WORLD is not None and not local:
        return _pg_sum(flat_psum(xs), "psum")
    if spec is None:
        return flat_psum(xs)
    from fastapriori_tpu_torch.parallel.hier import hier_psum

    return hier_psum(xs, spec)


def union_packed(xs: Sequence[torch.Tensor],
                 spec: Spec = None) -> torch.Tensor:
    """The OR-union of per-shard bit-packed masks, flat or two-level; in
    a multi-process world, over every process's shards."""
    if _WORLD is not None:
        out = flat_union_packed(xs).clone()
        for other in _pg_all_gather(out, "union_packed"):
            out |= other
        return out
    if spec is None:
        return flat_union_packed(xs)
    from fastapriori_tpu_torch.parallel.hier import hier_union_packed

    return hier_union_packed(xs, spec)


def tiled_all_gather(xs: Sequence[torch.Tensor], axis: int = 0,
                     spec: Spec = None, local: bool = False) -> torch.Tensor:
    """The per-shard blocks concatenated in shard order, flat or
    two-level; in a multi-process world, every process's blocks in rank
    order (each process's blocks have one shape; with ``local``, this
    process's blocks only)."""
    if _WORLD is not None and not local:
        return torch.cat(_pg_all_gather(flat_tiled_all_gather(xs, axis),
                                        "tiled_all_gather"),
                         dim=axis)
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


# ---------------------------------------------------------------------------
# The multi-process world (``--distributed``).


class World:
    """This process's place in a ``--distributed`` world: ``rank`` of
    ``size`` processes, ``local_rank`` on its host, the process group's
    ``backend``, the ``device`` its collectives run on (CPU under gloo,
    this rank's card under NCCL) and ``timeout_s``, the most a
    collective waits for its peers.  ``lost``: a collective failed or
    timed out, and one may still be pending on a dead peer."""

    def __init__(self, rank: int, size: int, local_rank: int, backend: str,
                 device: torch.device, timeout_s: float):
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.backend = backend
        self.device = device
        self.timeout_s = timeout_s
        self.lost = False


# The process's world, set once by initialize_distributed (as
# torch.distributed's own process group is process-wide); None in a
# one-process run, where every collective above stays in the process.
_WORLD: Optional[World] = None

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def process_count() -> int:
    return 1 if _WORLD is None else _WORLD.size


def process_index() -> int:
    return 0 if _WORLD is None else _WORLD.rank


def rank_card() -> Optional[torch.device]:
    """This rank's card, ``cuda:(LOCAL_RANK mod visible)``; None without
    a world or a card."""
    if _WORLD is None or not torch.cuda.is_available():
        return None
    return torch.device("cuda", _WORLD.local_rank % torch.cuda.device_count())


def initialize_distributed(platform: str) -> Optional[World]:
    """Join the ``env://`` world (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``; ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    default to ``RANK`` and ``WORLD_SIZE``: one host).  The backend
    follows from the launch: NCCL when ``platform`` is ``cuda`` and every
    rank of the host has a card of its own, else gloo; a collective
    waits at most ``FA_QUORUM_TIMEOUT_S`` (the process group's own
    timeout, twice that, is the backstop).  Returns the world, or
    None for a world of one process.  Raises ValueError naming the
    missing variables (the caller runs one process), RuntimeError when
    the process group does not start."""
    global _WORLD
    import torch.distributed as dist

    from fastapriori_tpu_torch.reliability import quorum

    missing = [k for k in _ENV if not os.environ.get(k)]
    if missing:
        raise ValueError("the env:// variables " + ", ".join(missing)
                         + " are not set")
    try:
        rank = int(os.environ["RANK"])
        size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    except ValueError as e:
        raise InputError(f"--distributed: a malformed env:// variable: {e}")
    if size < 1 or not 0 <= rank < size or not 0 <= local_rank < local_size:
        raise InputError(f"--distributed: RANK={rank} LOCAL_RANK="
                         f"{local_rank} outside WORLD_SIZE={size} / "
                         f"LOCAL_WORLD_SIZE={local_size}")
    if size == 1:
        return None
    own_cards = (platform == "cuda" and torch.cuda.is_available()
                 and torch.cuda.device_count() >= local_size
                 and dist.is_nccl_available())
    backend = "nccl" if own_cards else "gloo"
    device = (torch.device("cuda", local_rank) if own_cards
              else torch.device("cpu"))
    if own_cards:
        torch.cuda.set_device(device)
    timeout_s = quorum.quorum_timeout_s()
    timeout = datetime.timedelta(seconds=2 * timeout_s)
    try:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=size, timeout=timeout)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(f"the {backend} process group did not start: "
                           f"{e}") from e
    _WORLD = World(rank, size, local_rank, backend, device, timeout_s)
    # The quorum domain follows the world: the next hook resolves the
    # world's torch domain (or the file domain of FA_QUORUM_DIR).
    quorum.shutdown("reload")
    return _WORLD


def shutdown_distributed() -> None:
    """Leave the world (tests and the CLI's end) and forget its quorum
    domain.  A lost world is left as it is, process group included:
    tearing it down would wait on the collective still pending on the
    dead peer (the CLI then ends the process)."""
    global _WORLD
    if _WORLD is None or _WORLD.lost:
        # A lost world stays: the process is about to end without
        # waiting on its pending collective (cli.py ``main``).
        return
    import torch.distributed as dist

    from fastapriori_tpu_torch.reliability import quorum

    _WORLD = None
    quorum.shutdown("reload")
    if dist.is_initialized():
        dist.destroy_process_group()


def _to_group(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the process group's device: under gloo a CUDA tensor is
    staged through pinned host memory."""
    if x.device == _WORLD.device:
        return x.contiguous()
    if x.device.type == "cuda":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x.to(_WORLD.device).contiguous()


# How often a pending collective's completion is polled.
_POLL_S = 1e-4


def _lost(site: str, detail: str):
    """The quorum domain's :class:`PeerLost` for a failed collective at
    ``site``: the lost rank is the other one in a world of two, else
    unknown (-1)."""
    from fastapriori_tpu_torch.reliability.quorum import PeerLost

    peer = 1 - _WORLD.rank if _WORLD.size == 2 else -1
    return PeerLost(peer, site,
                    f"rank {_WORLD.rank}: a collective of the "
                    f"{_WORLD.size}-process world failed (a peer died or did "
                    f"not arrive within FA_QUORUM_TIMEOUT_S): {detail}")


def _collective(fn, *args, site: str) -> None:
    """One process-group call at ``site`` (the collective's name, which
    a ``PeerLost`` names), waited for at most the world's
    ``timeout_s``: a peer that died or never arrives raises the quorum
    domain's ``PeerLost`` within the bound under either backend (NCCL
    does not notice a dead peer by itself; gloo raises when its
    connection closes).  Once a collective failed, every later one
    raises at once: the failed one may still be pending, and a new one
    would pair with a peer's later call."""
    if _WORLD.lost:
        raise _lost(site, "the world was lost at an earlier collective")
    deadline = time.monotonic() + _WORLD.timeout_s
    try:
        work = fn(*args, async_op=True)
        while not work.is_completed():
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no result within {_WORLD.timeout_s:g} s")
            time.sleep(_POLL_S)
        work.wait()
    except RuntimeError as e:
        _WORLD.lost = True
        raise _lost(site, str(e)[:300]) from e


def _from_group(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A collective's result ``y`` back on ``like``'s device.  Onto the
    host the copy blocks until the result is there (a non-blocking copy
    from an NCCL result on the card would hand the host memory the copy
    has not filled yet); onto a card it is ordered on the stream."""
    return y.to(like.device, non_blocking=like.device.type == "cuda")


def _pg_sum(x: torch.Tensor, site: str) -> torch.Tensor:
    """The process group's all-reduce sum of ``x``, on ``x``'s device."""
    import torch.distributed as dist

    y = _to_group(x).clone()
    _collective(dist.all_reduce, y, dist.ReduceOp.SUM, site=site)
    return _from_group(y, x)


def _pg_all_gather(x: torch.Tensor, site: str) -> List[torch.Tensor]:
    """Every rank's ``x`` (one shape on every rank), in rank order, on
    ``x``'s device."""
    import torch.distributed as dist

    y = _to_group(x)
    outs = [torch.empty_like(y) for _ in range(_WORLD.size)]
    _collective(dist.all_gather, outs, y, site=site)
    return [_from_group(o, x) for o in outs]


def world_all_gather(x: torch.Tensor, site: str) -> List[torch.Tensor]:
    """Every rank's ``x``, in rank order (the quorum domain's torch
    transport); ``[x]`` in one process."""
    return [x] if _WORLD is None else _pg_all_gather(x, site)


def agree() -> None:
    """A rendezvous of every rank (an all-reduce of one integer, read on
    the host, so it returns only once every rank has arrived): the CLI's
    before each write, so a rank whose peer failed raises
    :class:`PeerLost` here instead of writing.  A no-op in one
    process."""
    if _WORLD is not None:
        n = int(_pg_sum(torch.ones(1, dtype=torch.int32), "agree").item())
        if n != _WORLD.size:
            raise _lost("agree", f"{n} of the {_WORLD.size} ranks agreed")


def allgather_bytes(blob: bytes) -> List[bytes]:
    """One bytes blob per process, in rank order (the ``allgather``
    failpoint site): the channel of the sharded ingest's small global
    tables; the bulk data never crosses processes.  ``[blob]`` in one
    process."""
    from fastapriori_tpu_torch.reliability import failpoints

    failpoints.fire("allgather")
    if _WORLD is None:
        return [blob]
    lens = [int(n) for n in _pg_all_gather(
        torch.tensor([len(blob)], dtype=torch.int64), "allgather")]
    buf = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    if blob:
        buf[: len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    return [bytes(g[:n].numpy().tobytes())
            for g, n in zip(_pg_all_gather(buf, "allgather"), lens)]
