"""The port's one-process device mesh (fastapriori_tpu_torch/parallel/,
ops/count.py's reductions) against the JAX package's host functions: the
two-level topology and its byte models, the sparse union budget and the
reduction's payload models, equal at every shard count and admissible
group count; the sparse reduction itself, flat and two-level, on seeded
numpy partial counts (exact at every union position, zero elsewhere, the
union counted as numpy counts it, an overflowing budget reported); the
collectives' two-level forms bit-identical to the flat ones; the mesh's
shape rules; and the strict parsing of the mesh's knobs.  Nothing here
runs the JAX package at more than one device."""

import numpy as np
import pytest
import torch

from fastapriori_tpu.ops import count as jcount
from fastapriori_tpu.parallel import hier as jhier
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.device import DeviceContext
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.ops import count as tcount
from fastapriori_tpu_torch.parallel import hier, mesh

SHARDS = (1, 2, 3, 4, 6, 8, 16)


def _group_counts(s):
    """Every group-count request resolve_spec admits at ``s`` shards."""
    return [0, 1] + [g for g in range(2, s + 1) if s % g == 0]


@pytest.mark.parametrize("s", SHARDS)
def test_topology_and_byte_models_equal_the_jax_packages(s):
    assert hier.auto_group_count(s) == jhier.auto_group_count(s)
    for procs in (1, 2, 4):
        assert (hier.auto_group_count(s, procs)
                == jhier.auto_group_count(s, procs))
    for g in _group_counts(s):
        spec = hier.resolve_spec(s, g)
        assert spec == jhier.resolve_spec(s, g)
        assert hier.describe_spec(spec) == jhier.describe_spec(spec)
        if spec is not None:
            assert hier.index_groups(spec) == jhier.index_groups(spec)
        for nbytes in (1, 96, 4096):
            assert (hier.union_stage_bytes(nbytes, s, spec)
                    == jhier.union_stage_bytes(nbytes, s, spec))
            assert (hier.gather_stage_bytes(nbytes, s, spec)
                    == jhier.gather_stage_bytes(nbytes, s, spec))
        for n_valid, cap in ((16384, 1024), (147456, 9216), (4096, 4096)):
            assert (tcount.sparse_psum_bytes(n_valid, cap, s, spec)
                    == jcount.sparse_psum_bytes(n_valid, cap, s, spec))
            assert (tcount.sparse_stage_bytes(n_valid, cap, s, spec)
                    == jcount.sparse_stage_bytes(n_valid, cap, s, spec))
    for bad in (g for g in range(2, s) if s % g):
        with pytest.raises(InputError, match="does not divide"):
            hier.resolve_spec(s, bad)
    with pytest.raises(InputError):
        hier.resolve_spec(s, -1)


@pytest.mark.parametrize("n_valid", [1, 8, 100, 4096, 16384, 147456,
                                     1 << 20, 3 << 20])
def test_sparse_union_cap_equals_the_jax_packages(n_valid):
    for override in (None, 0, 1, 5, 1000, 1 << 14, 1 << 30):
        assert (tcount.sparse_union_cap(n_valid, override)
                == jcount.sparse_union_cap(n_valid, override))


def _partials(seed, s, n, hot=0.05):
    """Per-shard int32 partial counts: mostly small, a few hot
    positions (power-law supports)."""
    rng = np.random.default_rng(seed)
    parts = rng.integers(0, 4, size=(s, n)).astype(np.int32)
    hot_pos = rng.choice(n, size=max(1, int(hot * n)), replace=False)
    parts[:, hot_pos] += rng.integers(5, 60, size=(s, hot_pos.size),
                                      dtype=np.int32)
    return parts


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("exchange", ["flat", "hier"])
def test_sparse_reduction_is_exact_on_the_union(s, exchange):
    groups = None if exchange == "flat" else (2, s // 2)
    n = 8 * 125
    parts = _partials(s, s, n)
    thrs = [int(x) for x in np.random.default_rng(s + 1).integers(
        4, 12, size=s)]
    valid = np.random.default_rng(s + 2).random(n) < 0.9
    union = np.zeros(n, bool)
    for p, t in zip(parts, thrs):
        union |= (p >= t) & valid
    dense = parts.astype(np.int64).sum(axis=0)
    cap = 1 << int(np.ceil(np.log2(max(union.sum(), 1))))
    counts, nu = tcount.local_sparse_psum(
        [torch.from_numpy(p) for p in parts], thrs, cap,
        valid=torch.from_numpy(valid), groups=groups)
    got = counts.numpy()
    assert int(nu) == int(union.sum())
    assert np.array_equal(got[union], dense[union])
    assert not got[~union].any()
    # The flat and the two-level forms agree bit for bit.
    flat, nu_flat = tcount.local_sparse_psum(
        [torch.from_numpy(p) for p in parts], thrs, cap,
        valid=torch.from_numpy(valid))
    assert torch.equal(flat, counts) and int(nu_flat) == int(nu)
    # A budget below the union reports the overflow: n_union > cap.
    small = cap // 4
    _, nu_small = tcount.local_sparse_psum(
        [torch.from_numpy(p) for p in parts], thrs, small, groups=groups,
        valid=torch.from_numpy(valid))
    assert int(nu_small) == int(union.sum()) > small


@pytest.mark.parametrize("s,spec", [(4, (2, 2)), (6, (2, 3)), (6, (3, 2)),
                                    (8, (2, 4)), (8, (4, 2))])
def test_two_level_collectives_equal_the_flat_forms(s, spec):
    rng = np.random.default_rng(s * 10 + spec[0])
    ints = [torch.from_numpy(rng.integers(-50, 50, (3, 5)).astype(np.int32))
            for _ in range(s)]
    masks = [torch.from_numpy(rng.integers(0, 256, 16).astype(np.uint8))
             for _ in range(s)]
    assert torch.equal(mesh.psum(ints, spec=spec), mesh.psum(ints))
    assert torch.equal(mesh.psum(ints), torch.stack(ints).sum(0))
    want = masks[0].clone()
    for m in masks[1:]:
        want |= m
    assert torch.equal(mesh.union_packed(masks, spec), want)
    assert torch.equal(mesh.union_packed(masks), want)
    for axis in (0, 1):
        flat = mesh.tiled_all_gather(ints, axis)
        assert torch.equal(flat, torch.cat(ints, dim=axis))
        assert torch.equal(mesh.tiled_all_gather(ints, axis, spec), flat)
    assert torch.equal(mesh.all_gather(ints), torch.stack(ints))
    assert all(t is ints[0] for t in mesh.broadcast(ints[0], ["cpu"] * 3))


def test_pack_bits_msb_matches_numpy_packbits():
    mask = np.random.default_rng(0).random(77) < 0.4
    got = tcount.pack_bits_msb(torch.from_numpy(mask)).numpy()
    assert np.array_equal(got, np.packbits(mask))
    back = tcount.unpack_bits_msb(torch.from_numpy(got)).numpy()
    assert np.array_equal(back[:77], mask) and not back[77:].any()


def test_mesh_shapes_and_placements():
    ctx = DeviceContext("cpu", num_devices=4, cand_devices=2)
    assert (ctx.n_devices, ctx.txn_shards, ctx.cand_shards) == (4, 2, 2)
    x = np.arange(24).reshape(8, 3)
    rows = ctx.shard_rows(x)
    assert [r.tolist() for r in rows] == [
        x[:4].tolist(), x[:4].tolist(), x[4:].tolist(), x[4:].tolist()]
    assert [r.tolist() for r in ctx.shard_rows(x, txn_only=True)] == [
        x[:4].tolist(), x[4:].tolist()]
    cols = ctx.shard_rows(x.T.copy(), axis=-1)
    assert cols[2].tolist() == x[4:].T.tolist()
    lanes = ctx.shard_lanes(torch.from_numpy(x.T.copy()))
    assert [t.tolist() for t in ctx.txn_parts(lanes)] == [
        x[:4].T.tolist(), x[4:].T.tolist()]
    # One shard: the default, and the tensor itself.
    one = DeviceContext("cpu")
    assert (one.n_devices, one.txn_shards) == (1, 1)
    t = torch.zeros(3, 8)
    assert one.shard_lanes(t)[0] is t
    # An explicit device list may name one device more than once.
    rep = DeviceContext(devices=["cpu"] * 3)
    assert rep.txn_shards == 3 and rep.mesh.distinct_devices() == [
        torch.device("cpu")]


def test_mesh_shape_errors(monkeypatch):
    with pytest.raises(InputError, match="cand_devices"):
        DeviceContext("cpu", num_devices=4, cand_devices=3)
    with pytest.raises(InputError, match="cand_devices"):
        DeviceContext("cpu", num_devices=2, cand_devices=0)
    with pytest.raises(InputError, match="num_devices"):
        DeviceContext("cpu", num_devices=0)
    # More CUDA shards than visible cards is an error (the JAX package
    # would take fewer devices quietly).
    from fastapriori_tpu_torch import device as tdevice

    monkeypatch.setattr(tdevice, "resolve_device",
                        lambda d=None: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(InputError, match="exceeds the 1 visible CUDA"):
        mesh.resolve_devices("cuda", 2)
    assert mesh.resolve_devices("cuda", 1) == [torch.device("cuda", 0)]


def test_a_named_card_is_one_shard_unless_more_are_asked_for(monkeypatch):
    from fastapriori_tpu_torch import device as tdevice

    def fake_resolve(d=None):
        d = torch.device("cuda" if d is None else d)
        return torch.device("cuda", 0) if d.index is None else d

    monkeypatch.setattr(tdevice, "resolve_device", fake_resolve)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    # No device and no count (the CLI's default platform): every card.
    assert mesh.resolve_devices() == cards
    # A named card without a count stays one shard on that card.
    assert mesh.resolve_devices("cuda:1") == [torch.device("cuda", 1)]
    assert mesh.resolve_devices("cuda") == [torch.device("cuda", 0)]
    assert mesh.resolve_devices("cuda:1", 1) == [torch.device("cuda", 1)]
    assert mesh.resolve_devices("cuda:1", 2) == cards[:2]


def test_fused_budget_counts_the_shards_that_share_a_card(monkeypatch):
    """The fused row budget fits the busiest card: two shards on one card
    hold twice one shard's buffers there, two on two cards one each."""
    from fastapriori_tpu_torch import device as tdevice
    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.models import apriori as tapriori

    monkeypatch.setattr(tdevice, "resolve_device", torch.device)
    t_pad, f_pad, n_chunks = 1 << 14, 256, 1
    fixed, at = tapriori.fused_bytes(MinerConfig(), t_pad // 2, f_pad,
                                     n_chunks)
    # Room for 2^12 rows on one shard's buffers, so 2^11 for two.
    budget = fixed + at(1 << 12)
    cfg = MinerConfig(fused_hbm_budget_bytes=budget,
                      fused_m_cap_max=1 << 16)
    shared = DeviceContext(devices=["cuda:0"] * 2)
    apart = DeviceContext(devices=["cuda:0", "cuda:1"])
    assert shared.mesh.txn_shards_per_device() == 2
    assert apart.mesh.txn_shards_per_device() == 1
    assert DeviceContext("cpu", num_devices=4,
                         cand_devices=2).mesh.txn_shards_per_device() == 2
    limit = {name: tapriori.fused_m_cap_memory_limit(
        cfg, ctx, t_pad, f_pad, n_chunks)
        for name, ctx in (("shared", shared), ("apart", apart))}
    assert limit == {"shared": 1 << 11, "apart": 1 << 12}
    card_fixed, card_at = tapriori.fused_card_bytes(cfg, shared, t_pad,
                                                    f_pad, n_chunks)
    assert card_fixed + card_at(1 << 11) == 2 * (fixed + at(1 << 11))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports the second card as its device: enough
    for a wrapper's checks, up to the device guard of its launch."""

    @property
    def device(self):
        return torch.device("cuda", 1)


class _Guarded(Exception):
    pass


def _on_card(x):
    return torch.Tensor._make_subclass(_OnCard, x)


def _k1_args():
    z = torch.zeros(32, 8, dtype=torch.int8)
    return (z, z, torch.zeros(4, 8, dtype=torch.int8), 2)


def _k2_args():
    return (torch.zeros(32, 8, dtype=torch.int8),
            torch.zeros(32, dtype=torch.int32),
            torch.zeros(4, 2, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32))


def _k3_args():
    return (torch.zeros(9, 4, dtype=torch.int32),
            torch.zeros(1, 4, dtype=torch.int32), [1],
            torch.zeros(2, 1, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_each_kernel_launches_under_its_tensors_card(kernel, monkeypatch):
    """A shard's launch makes its tensors' card the current one before
    it allocates scratch or calls the library (which reads the current
    card's properties and issues there), whatever card the caller has
    current."""
    from fastapriori_tpu_torch.ops import (
        level_kernel,
        match_kernel,
        vertical_kernel,
    )

    fn, args = {
        "K1": (level_kernel.level_counts, _k1_args()),
        "K2": (match_kernel.first_match, _k2_args()),
        "K3": (vertical_kernel.vertical_counts, _k3_args()),
    }[kernel]
    entered = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)
            raise _Guarded

        def __exit__(self, *exc):
            return False

    def no_launch(*_a, **_k):
        raise AssertionError("reached the library outside the guard")

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(level_kernel, "_lib", no_launch)
    monkeypatch.setattr(match_kernel, "_kernel_fns", no_launch)
    monkeypatch.setattr(vertical_kernel, "_kernel_fn", no_launch)
    args = [_on_card(a) if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(_Guarded):
        fn(*args)
    assert entered == [torch.device("cuda", 1)]


def _tiny_inputs(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    (d / "D.dat").write_text("1 2 3\n1 2\n2 3\n1 3\n1 2 3 4\n" * 6)
    (d / "U.dat").write_text("1\n2 3\n")
    out = tmp_path / "out"
    out.mkdir()
    return str(d) + "/", str(out) + "/"


@pytest.mark.parametrize("env,value,flags", [
    ("FA_COUNT_SPARSE_CAP", "abc", ()),
    ("FA_COUNT_SPARSE_CAP", "-1", ()),
    ("FA_COUNT_SPARSE_CAP", "abc", ("--num-devices", "1")),
    ("FA_EXCHANGE_GROUPS", "two", ()),
    ("FA_EXCHANGE_GROUPS", "two", ("--num-devices", "1")),
    ("FA_EXCHANGE_GROUPS", "3", ("--num-devices", "8")),
    ("FA_RULE_SHARDS", "x", ()),
    ("FA_RULE_SHARDS", "2", ()),
    ("FA_RULE_SHARDS", "2", ("--num-devices", "2")),
])
def test_mesh_knobs_are_strict(env, value, flags, tmp_path, monkeypatch,
                               capsys):
    inp, out = _tiny_inputs(tmp_path)
    monkeypatch.setenv(env, value)
    rc = torch_main([inp, out, "--min-support", "0.1", "--platform", "cpu",
                     "--num-devices", "2", *flags])
    assert rc == 2
    assert env[3:].lower() in capsys.readouterr().err.lower()


def test_rule_shards_above_one_names_the_roadmap():
    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.rules.gen import resolve_rule_shards

    ctx = DeviceContext("cpu", num_devices=4)
    with pytest.raises(InputError, match="ROADMAP Queue 1"):
        resolve_rule_shards(ctx, MinerConfig(rule_shards=4))
    assert resolve_rule_shards(ctx, MinerConfig()) == (
        1, "sharded_join_not_ported")
    assert resolve_rule_shards(ctx, MinerConfig(rule_shards=1)) == (1, None)
    assert resolve_rule_shards(DeviceContext("cpu"), MinerConfig()) == (
        1, None)
    two_d = DeviceContext("cpu", num_devices=4, cand_devices=2)
    assert resolve_rule_shards(two_d, MinerConfig()) == (1, None)
