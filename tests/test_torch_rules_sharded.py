"""The port's sharded rule join and rank-strided scan on S CPU shards of
the one-process mesh (ops/contain.py ``rule_level_shard_kernel``,
``rule_shard_bytes``, ``rule_shard_stage_bytes``, ``rule_scan_build(...,
n_shards=S)``, ``local_strided_match_scan``; rules/gen.py's sharded
branch; K2's ``shard``/``n_shards``), held to the JAX package: its
``rule_level_shard_kernel`` under ``jax.vmap`` with a named axis (the
collectives run there on jax 0.9.0, where ``shard_map`` refuses the
kernel), its byte models, its ``rule_scan_build`` and
``strided_best_rank_pallas`` in interpret mode, its host engine and CLI
at one device, and ``fastapriori_tpu/oracle.py``."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dataset, tokenized
from fastapriori_tpu import oracle
from fastapriori_tpu.cli import main as jax_main
from fastapriori_tpu.ops import contain as jcontain
from fastapriori_tpu.ops.pallas_vertical import strided_best_rank_pallas
from fastapriori_tpu.parallel import hier as jhier
from fastapriori_tpu.rules import gen as jgen
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.device import DeviceContext
from fastapriori_tpu_torch.models.recommender import AssociationRules
from fastapriori_tpu_torch.ops import contain as tcontain
from fastapriori_tpu_torch.ops.bitmap import next_pow2, pad_axis
from fastapriori_tpu_torch.ops.match_kernel import (
    NO_MATCH,
    check_limits,
    first_match,
    first_match_plain,
)
from fastapriori_tpu_torch.parallel import hier as thier
from fastapriori_tpu_torch.rules import gen as tgen
from fastapriori_tpu_torch.utils.datagen import (
    generate_transactions,
    generate_user_baskets,
)
from fastapriori_tpu_torch.utils.logging import MetricsLogger
from test_torch_rules_device import CASES, _bits, _mined

DEVICE = MinerConfig(rule_engine="device")
SHARDS = (2, 4, 8)


def _levels_padded(mats, s):
    """``(k, n, n_pad, mat_p, cnts_p)`` per level, padded as the sharded
    engine pads (a multiple of 8·S)."""
    out = []
    for k in sorted(k for k in mats if k >= 2):
        mat, cnts = mats[k]
        n = mat.shape[0]
        n_pad = pad_axis(next_pow2(max(n, 8)), 8 * s)
        mat_p = np.zeros((n_pad, k), np.int32)
        mat_p[:n] = mat
        cnts_p = np.ones(n_pad, np.int32)
        cnts_p[:n] = cnts
        out.append((k, n, n_pad, mat_p, cnts_p))
    return out


@functools.lru_cache(maxsize=None)
def _jax_vmap_join(k, bits, first, s):
    """JAX ``rule_level_shard_kernel`` over S shards under ``jax.vmap``
    with the kernel's axis name: query rows split, parent state
    replicated."""
    fn = functools.partial(jcontain.rule_level_shard_kernel, k=k, bits=bits,
                           first=first, axis_name="txn", n_shards=s)
    return jax.jit(jax.vmap(fn, in_axes=(0, 0) + (None,) * 7,
                            axis_name="txn"))


def _torch_chain(mats, s):
    """The port's sharded join level by level on S CPU shards."""
    bits = _bits(mats)
    p1 = torch.from_numpy(np.asarray(mats[1][1], np.int32))
    prev = (None, None, p1, 0, None, None)
    outs = []
    for k, n, _, mat_p, cnts_p in _levels_padded(mats, s):
        ps, po, pc, np_real, surv, d = prev
        mats_l = list(torch.from_numpy(mat_p).chunk(s))
        cnts_l = list(torch.from_numpy(cnts_p).chunk(s))
        out = tcontain.rule_level_shard_kernel(
            mats_l, cnts_l, n, [ps] * s, [po] * s, [pc] * s, np_real,
            [surv] * s, [d] * s, k=k, bits=bits, first=k == 2)
        outs.append(out)
        prev = (out[1], out[2], out[6], n, out[4], out[3])
    return outs


def _jax_chain(mats, s):
    bits = _bits(mats)
    prev = ((jnp.zeros(1, jnp.uint32),), jnp.zeros(1, jnp.int32),
            jnp.asarray(np.asarray(mats[1][1], np.int32)), 0,
            jnp.zeros(1, bool), jnp.zeros(1, jnp.int32))
    outs = []
    for k, n, n_pad, mat_p, cnts_p in _levels_padded(mats, s):
        ps, po, pc, np_real, surv, d = prev
        out = _jax_vmap_join(k, bits, k == 2, s)(
            jnp.asarray(mat_p.reshape(s, n_pad // s, k)),
            jnp.asarray(cnts_p.reshape(s, n_pad // s)), jnp.int32(n), ps,
            po, pc, jnp.int32(np_real), surv, d)
        # Every shard ends holding the same value: take shard 0's.
        out = jax.tree_util.tree_map(lambda x: x[0], out)
        outs.append(out)
        prev = (out[1], out[2], out[6], n, out[4], out[3])
    return outs


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("case", ["s0", "deep", "bits16"])
def test_shard_join_matches_jax_under_vmap(case, s):
    mats = CASES[case]()
    for got, want in zip(_torch_chain(mats, s), _jax_chain(mats, s)):
        packed, _, order, d_flat, surv, mat_full, cnts_full = got
        assert np.array_equal(packed.numpy(), np.asarray(want[0]))
        assert np.array_equal(order.numpy(), np.asarray(want[2]))
        assert np.array_equal(d_flat.numpy(), np.asarray(want[3]))
        assert np.array_equal(surv.numpy(), np.asarray(want[4]))
        assert np.array_equal(mat_full.numpy(), np.asarray(want[5]))
        assert np.array_equal(cnts_full.numpy(), np.asarray(want[6]))


@pytest.mark.parametrize("s", SHARDS)
def test_shard_join_equals_the_one_shard_join(s):
    """The gathered state equals the one-shard join's on the same padded
    table, level by level, with the two-level exchange too."""
    mats = CASES["s6"]()
    bits = _bits(mats)
    spec = thier.resolve_spec(s, 2) if s > 2 else None
    p1 = torch.from_numpy(np.asarray(mats[1][1], np.int32))
    one = sh = (None, None, p1, 0, None, None)
    for k, n, _, mat_p, cnts_p in _levels_padded(mats, s):
        mat, cnts = torch.from_numpy(mat_p), torch.from_numpy(cnts_p)
        o1 = tcontain.rule_level_kernel(
            mat, cnts, n, one[0], one[1], one[2], one[3], one[4], one[5],
            k=k, bits=bits, first=k == 2)
        osh = tcontain.rule_level_shard_kernel(
            list(mat.chunk(s)), list(cnts.chunk(s)), n, [sh[0]] * s,
            [sh[1]] * s, [sh[2]] * s, sh[3], [sh[4]] * s, [sh[5]] * s, k=k,
            bits=bits, first=k == 2, spec=spec)
        for a, b in zip(o1[:5], osh[:5]):
            if isinstance(a, tuple):
                assert all(torch.equal(x, y) for x, y in zip(a, b))
            else:
                assert torch.equal(a, b)
        one = (o1[1], o1[2], cnts, n, o1[4], o1[3])
        sh = (osh[1], osh[2], osh[6], n, osh[4], osh[3])


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("case", ["s0", "s6", "deep", "bits32"])
def test_sharded_rule_arrays_match_host_and_jax(case, s):
    mats = CASES[case]()
    m = MetricsLogger()
    got = tgen.rule_arrays_from_tables(
        mats, context=DeviceContext("cpu", num_devices=s), config=DEVICE,
        metrics=m)
    for want in (tgen._rule_arrays_host(mats), jgen._rule_arrays_host(mats)):
        assert len(got) == len(want)
        for (ga, gc, gf), (wa, wc, wf) in zip(got, want):
            assert np.array_equal(ga, wa) and np.array_equal(gc, wc)
            assert gf.tobytes() == wf.tobytes()
    # The JAX automatic topology: two-level from S = 8.
    spec = jhier.resolve_spec(s, 0)
    (dev,) = [r for r in m.records if r["event"] == "rule_gen_device"]
    assert dev["shards"] == s
    assert dev["exchange"] == ("flat" if spec is None else "hier")
    n_pads = [n_pad for _, _, n_pad, _, _ in _levels_padded(mats, s)]
    assert [c["k"] for c in dev["comms"]] == sorted(
        k for k in mats if k >= 2)
    for c, n_pad in zip(dev["comms"], n_pads):
        g, p = jcontain.rule_shard_bytes(c["k"], n_pad, s, spec)
        i, e, msgs = jcontain.rule_shard_stage_bytes(c["k"], n_pad, s, spec)
        assert (c["gather_bytes"], c["psum_bytes"]) == (g, p)
        assert (c["intra_bytes"], c["inter_bytes"], c["inter_msgs"]) == (
            i, e, msgs)
    assert dev["gather_bytes"] == sum(c["gather_bytes"] for c in dev["comms"])


def _admissible_groups(s):
    return [None] + [(g, s // g) for g in range(2, s) if s % g == 0]


@pytest.mark.parametrize("s", (2, 4, 6, 8, 16))
def test_rule_byte_models_match_jax(s):
    for spec in _admissible_groups(s):
        for k in (2, 3, 5, 9):
            for n_pad in (8 * s, 64 * s, 1024 * s):
                assert tcontain.rule_shard_bytes(k, n_pad, s, spec) == \
                    jcontain.rule_shard_bytes(k, n_pad, s, spec)
                assert tcontain.rule_shard_stage_bytes(k, n_pad, s, spec) \
                    == jcontain.rule_shard_stage_bytes(k, n_pad, s, spec)
        if spec is not None:
            assert thier.resolve_spec(s, spec[0]) == jhier.resolve_spec(
                s, spec[0])


def _rec(case, s):
    mats, data = {"s0": _mined(0, 0.05), "s6": _mined(6, 0.05),
                  "deep": _mined(0, 0.05, deep=True)}[case]
    levels = [(m, c) for k, (m, c) in sorted(mats.items()) if k >= 2]
    rec = AssociationRules([], data.freq_items, data.item_to_rank,
                           levels=levels,
                           item_counts=data.item_counts, config=DEVICE,
                           context=DeviceContext("cpu", num_devices=s))
    return rec, mats, data


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("case", ["s0", "deep"])
def test_strided_scan_table_matches_jax(case, s):
    rec, mats, data = _rec(case, s)
    rec.rule_arrays()
    assert rec._scan_state is not None and rec._scan_state.shards == s
    slices, _ = rec.scan_table()
    # The whole table is the shards' slices in shard order.
    ant, size, cons = (torch.cat([sl[i] for sl in slices]) for i in range(3))
    r_pad, k_max = ant.shape
    f_pad = pad_axis(len(data.freq_items) + 1, 128)
    arrays, offsets, total = [], [], 0
    for out in _jax_chain(mats, s):
        arrays.append((out[5], out[6], out[3], out[4]))
        offsets.append(total)
        total += int(np.asarray(out[4]).sum())
    pr = jnp.asarray(jgen._consequent_priority(data.freq_items)
                     .astype(np.int32))
    want = jcontain.rule_scan_build(
        tuple(arrays), jnp.asarray(offsets, jnp.int32), pr,
        ks=tuple(sorted(k for k in mats if k >= 2)), r_pad=r_pad,
        k_max=k_max, zcol=f_pad - 1, n_shards=s)
    for got, w in zip((ant, size, cons), want):
        assert np.array_equal(got.numpy(), np.asarray(w))
    # Shard t holds its R/S rows: sorted ranks t, t + S, t + 2S, ...
    r_loc = r_pad // s
    assert len(slices) == s
    for t, sl in enumerate(slices):
        for x, whole in zip(sl, (ant, size, cons)):
            assert x.shape[0] == r_loc
            assert torch.equal(x, whole[t * r_loc : (t + 1) * r_loc])
    one, _, _ = _rec(case, 1)
    one.rule_arrays()
    (a1, s1, c1), = one.scan_table()[0]
    if a1.shape[0] == r_pad:
        for x, y in zip((ant, size, cons), (a1, s1, c1)):
            assert torch.equal(
                x.reshape(s, r_loc, -1).transpose(0, 1).reshape(y.shape), y)


def _rules(rng, r, f, k):
    """A table of ``r`` rules over ``f - 1`` items whose antecedent
    padding points at the zero column ``f - 1``."""
    size = rng.integers(1, k + 1, size=r).astype(np.int32)
    ant = np.full((r, k), f - 1, np.int32)
    for i in range(r):
        ant[i, : size[i]] = rng.choice(f - 1, size=size[i], replace=False)
    cons = rng.integers(0, f - 1, size=r).astype(np.int32)
    return ant, size, cons


def _baskets(rng, mb, f):
    b = (rng.random((mb, f)) < 0.35).astype(np.int8)
    b[:, f - 1] = 0
    blen = b.sum(axis=1).astype(np.int32)
    blen[-3:] = 0  # padding rows
    b[-3:] = 0
    return b, blen


@pytest.mark.parametrize("s", (1, 2, 3, 4, 8))
def test_strided_plain_k2_matches_pallas_interpret(s):
    rng = np.random.default_rng(40 + s)
    f, k, tile = 24, 3, 128
    b, blen = _baskets(rng, 37, f)
    for shard in range(s):
        ant, size, cons = _rules(rng, 2 * tile, f, k)
        want = strided_best_rank_pallas(
            jnp.asarray(b), jnp.asarray(blen), jnp.asarray(ant),
            jnp.asarray(size), jnp.asarray(cons), jnp.int32(shard),
            n_shards=s, rule_tile=tile, no_match=NO_MATCH, interpret=True)
        args = [torch.from_numpy(x) for x in (b, blen, ant, size, cons)]
        got = first_match_plain(*args, shard=shard, n_shards=s)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
        # The wrapper takes the plain version for CPU tensors.
        assert torch.equal(first_match(*args, shard=shard, n_shards=s), got)
        assert ((got == NO_MATCH) | (got % s == shard)).all()


def test_strided_k2_limits():
    check_limits(64, 8, 2**30 - 1, 3, shard=1, n_shards=2)
    with pytest.raises(ValueError, match="NO_MATCH"):
        check_limits(64, 8, 2**30, 3, shard=0, n_shards=3)
    for shard, n in ((2, 2), (-1, 2), (0, 0)):
        with pytest.raises(ValueError, match="shard"):
            check_limits(64, 8, 16, 3, shard=shard, n_shards=n)


@pytest.mark.parametrize("s", SHARDS)
def test_merged_scan_equals_the_one_shard_scan(s):
    rng = np.random.default_rng(7 * s)
    f, k = 30, 4
    ant, size, cons = _rules(rng, 512, f, k)
    b, blen = _baskets(rng, 64, f)
    args = [torch.from_numpy(x) for x in (b, blen)]
    table = [torch.from_numpy(x) for x in (ant, size, cons)]
    best1, cons1 = tcontain.strided_match_scan(*args, *table)
    # The same priority order, rank-strided over S shards.
    perm = torch.arange(512).reshape(512 // s, s).T.reshape(-1)
    strided = [x[perm] for x in table]
    slices = tcontain.strided_slices(strided, s)
    best, cons_g = tcontain.local_strided_match_scan(
        [args[0]] * s, [args[1]] * s, slices)
    assert torch.equal(best, best1) and torch.equal(cons_g, cons1)
    assert (cons1 >= 0).any() and (best1 == NO_MATCH).any()


@pytest.mark.parametrize("s", SHARDS)
def test_resident_strided_scan_answers_as_the_host_scan(s):
    rec, _, data = _rec("s6", s)
    users = tokenized(random_dataset(60, n_txns=200))
    host = AssociationRules([], data.freq_items, data.item_to_rank,
                            levels=rec._levels, item_counts=data.item_counts,
                            device="cpu")
    want = host.run(users, use_device=False)
    assert rec.run(users, use_device=True) == want
    (fm,) = [r for r in rec.metrics.records if r["event"] == "first_match"]
    assert fm["resident_table"] is True and fm["shards"] == s
    slices, _ = rec.scan_table()
    assert len(slices) == s
    assert fm["launches"] % s == 0 and fm["table_rows"] * s == \
        sum(int(sl[0].shape[0]) for sl in slices)
    h = rec.serve_scan()
    assert h.shards == h.launches == s and h.row_multiple == 1
    assert h.table_bytes * s == sum(
        int(x.nbytes) for sl in slices for x in sl)
    assert all(h.table_rows == sl[0].shape[0] for sl in slices)


def test_rule_shards_pinned_to_one_scans_the_host_built_table():
    rec, mats, data = _rec("s6", 4)
    rec.config = MinerConfig(rule_engine="device", rule_shards=1)
    rec.rule_arrays()
    assert rec._scan_state is None
    h = rec.serve_scan()
    assert not h.resident and h.shards == 1 and h.launches == 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("rules_sharded")
    lines = (["3 5 8 13 21 34"] * 60
             + generate_transactions(n_txns=540, n_items=40, seed=17))
    (d / "D.dat").write_text("".join(x + "\n" for x in lines))
    (d / "U.dat").write_text("".join(
        x + "\n" for x in generate_user_baskets(n_users=120, n_items=40,
                                                seed=18)))
    return str(d) + "/"


@pytest.mark.parametrize("s", SHARDS)
def test_cli_with_device_rules_on_shards_writes_the_jax_bytes(
        s, corpus, tmp_path, monkeypatch, capsys):
    outs = {name: str(tmp_path / name) + "/" for name in ("torch", "jax")}
    for out in outs.values():
        os.makedirs(out)
    assert jax_main([corpus, outs["jax"], "--min-support", "0.05",
                     "--platform", "cpu", "--engine", "level",
                     "--num-devices", "1"]) == 0
    monkeypatch.setenv("FA_RULE_ENGINE", "device")
    assert torch_main([corpus, outs["torch"], "--min-support", "0.05",
                       "--platform", "cpu", "--num-devices", str(s),
                       "--metrics"]) == 0
    err = capsys.readouterr().err
    assert f'"event": "rule_gen_engine"' in err and f'"shards": {s}' in err
    assert '"resident_table": true' in err
    exp_freq, exp_rec = oracle.run_pipeline(
        oracle.read_lines(corpus + "D.dat"),
        oracle.read_lines(corpus + "U.dat"), 0.05)
    for name, exp in (("freqItemset", exp_freq), ("recommends", exp_rec)):
        with open(outs["torch"] + name, "rb") as f:
            got = f.read()
        with open(outs["jax"] + name, "rb") as f:
            assert got == f.read()
        assert got == exp.encode("utf-8")
