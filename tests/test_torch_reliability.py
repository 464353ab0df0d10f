"""The port's reliability core against the JAX package's, on the CPU:
failpoint grammar, retry classification (with the CUDA rules: a sticky
CUDA error and an injected abort are fatal, a CUDA OOM is transient),
the bounded retry policy and its strict environment knobs, the
degradation ledger, the dispatch watchdog, the cascade's chain table,
atomic artifact writes, every one-device fetch site of the JAX
package's inventory armed and retried through the port's production
path, and the level loop's deferred survivor counts (one survivor-mask
read per level, one resolve, mid-loop drains, the resolve folded into a
tail fold) holding the same levels as the eager loop and the JAX
package, on the bitmap and the vertical layout."""

import errno
import os
import time

import numpy as np
import pytest
import torch

from conftest import random_dataset
from fastapriori_tpu.config import MinerConfig as JaxConfig
from fastapriori_tpu.models.apriori import FastApriori as JaxApriori
from fastapriori_tpu.reliability import watchdog as jax_watchdog
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.io import resume as resume_io
from fastapriori_tpu_torch.io import writer
from fastapriori_tpu_torch.io.reader import read_dat
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.models.recommender import AssociationRules
from fastapriori_tpu_torch.native import loader
from fastapriori_tpu_torch.reliability import (
    failpoints,
    ledger,
    retry,
    watchdog,
)
from fastapriori_tpu_torch.utils.logging import MetricsLogger


@pytest.fixture(autouse=True)
def _clean_reliability_state():
    def clean():
        failpoints.disarm_all()
        ledger.reset()
        watchdog.reload_from_env()
        watchdog.reset_abandoned()
        retry.reload_policy_from_env()

    clean()
    yield
    clean()


# ---------------------------------------------------------------------------
# failpoints


def test_failpoint_spec_parsing():
    specs = failpoints.parse_spec(
        "fetch.pair:oom*1,write.freqItems:truncate@17,x.y:delay@5")
    assert specs["fetch.pair"].kind == "oom"
    assert specs["fetch.pair"].remaining == 1
    assert specs["write.freqItems"].arg == 17
    assert specs["x.y"].kind == "delay"


@pytest.mark.parametrize("bad", [
    "nocolon", "site:unknownkind", "site:oom*notanint", "site:truncate@NaN",
    "site:truncate", "site:delay",
])
def test_failpoint_malformed_specs_raise(bad):
    with pytest.raises(InputError):
        failpoints.parse_spec(bad)


def test_failpoint_oom_fires_then_exhausts():
    failpoints.arm("fetch.test", "oom*2")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="^RESOURCE_EXHAUSTED:") as e:
            failpoints.fire("fetch.test")
        # An injected OOM is told apart from a real one by its type.
        assert not isinstance(e.value, torch.cuda.OutOfMemoryError)
    failpoints.fire("fetch.test")  # exhausted: a no-op


def test_failpoint_kinds():
    failpoints.arm("a", "io")
    with pytest.raises(OSError):
        failpoints.fire("a")
    failpoints.arm("b", "abort")
    with pytest.raises(failpoints.InjectedAbort, match="'b'"):
        failpoints.fire("b")
    assert not issubclass(failpoints.InjectedAbort, Exception)
    failpoints.arm("c", "delay@30")
    t0 = time.perf_counter()
    failpoints.fire("c")
    assert time.perf_counter() - t0 >= 0.025
    failpoints.arm("d", "truncate@3")
    failpoints.fire("d")  # truncate never fires; the writer consumes it
    assert failpoints.truncation("d") == 3
    failpoints.fire("unarmed.site")


def test_failpoint_env_reload(monkeypatch):
    monkeypatch.setenv("FA_FAILPOINTS", "x.y:io*1")
    failpoints.reload_from_env()
    assert failpoints.active() == {"x.y": "io"}
    monkeypatch.delenv("FA_FAILPOINTS")
    failpoints.reload_from_env()
    assert failpoints.active() == {}


# ---------------------------------------------------------------------------
# retry classification and policy


@pytest.mark.parametrize("exc,kind", [
    (InputError("x"), "user"),
    (FileNotFoundError(2, "x"), "user"),
    (OSError(errno.EIO, "flaky"), "transient"),
    (OSError(errno.ETIMEDOUT, "slow"), "transient"),
    (OSError(errno.EPERM, "denied"), "fatal"),
    (RuntimeError("RESOURCE_EXHAUSTED: oom"), "transient"),
    (RuntimeError("UNAVAILABLE: link down"), "transient"),
    (RuntimeError("INVALID_ARGUMENT: shape"), "fatal"),
    (ValueError("nope"), "fatal"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), "transient"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "fatal"),
    (RuntimeError("CUDA error: unspecified launch failure"), "fatal"),
    (RuntimeError("CUDA error: device-side assert triggered"), "fatal"),
    (RuntimeError("CUDA error: the launch timed out and was terminated "
                  "(cudaErrorLaunchTimeout) INTERNAL"), "fatal"),
    (RuntimeError("CUDA error: misaligned address"), "fatal"),
    (failpoints.InjectedAbort("injected failpoint 'level.3'"), "fatal"),
])
def test_classify(exc, kind):
    assert retry.classify(exc) == kind


def test_classify_agrees_with_the_jax_package_off_cuda():
    from fastapriori_tpu.reliability import retry as jax_retry

    for exc in (OSError(errno.EIO, "x"), OSError(errno.EPERM, "x"),
                RuntimeError("ABORTED: x"), RuntimeError("plain"),
                TypeError("t"), FileNotFoundError(2, "x")):
        assert retry.classify(exc) == jax_retry.classify(exc)


def test_retry_absorbs_transient_and_records():
    failpoints.arm("fetch.t", "oom*1")
    calls = []
    out = retry.call_with_retries(lambda: calls.append(1) or 42, "fetch.t",
                                  sleep=lambda s: None)
    assert out == 42 and calls == [1]
    (ev,) = ledger.snapshot()
    assert ev["kind"] == "retry" and ev["site"] == "fetch.t"


def test_retry_gives_up_after_policy_bound():
    failpoints.arm("fetch.t", "oom")
    policy = retry.RetryPolicy(max_attempts=3, base_delay_s=0.0)
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        retry.call_with_retries(lambda: 1, "fetch.t", policy=policy,
                                sleep=lambda s: None)
    assert len(ledger.snapshot()) == 2  # attempts 1 and 2 were retried


def test_retry_fatal_user_and_abort_not_retried():
    failpoints.arm("w.t", "io")  # an OSError without an errno: fatal
    with pytest.raises(OSError):
        retry.call_with_retries(lambda: 1, "w.t", sleep=lambda s: None)

    def raiser(exc):
        def thunk():
            raise exc
        return thunk

    for exc in (InputError("user problem"),
                RuntimeError("CUDA error: an illegal memory access was "
                             "encountered")):
        with pytest.raises(type(exc)):
            retry.call_with_retries(raiser(exc), "other.site",
                                    sleep=lambda s: None)
    failpoints.arm("x.abort", "abort")
    with pytest.raises(failpoints.InjectedAbort):
        retry.call_with_retries(lambda: 1, "x.abort", sleep=lambda s: None)
    assert ledger.snapshot() == []


def test_retry_empties_the_cache_after_a_real_cuda_oom(monkeypatch):
    emptied = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: emptied.append(1))
    calls = []

    def thunk():
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return "ok"

    assert retry.call_with_retries(thunk, "fetch.t",
                                   sleep=lambda s: None) == "ok"
    assert emptied == [1] and len(calls) == 2
    # An injected OOM is not a real one: the cache is left alone.
    failpoints.arm("fetch.u", "oom*1")
    retry.call_with_retries(lambda: 1, "fetch.u", sleep=lambda s: None)
    assert emptied == [1]


def test_retry_exhaustion_tags_only_the_audited_site():
    """Only a transient that outlasted an audited call's retries carries
    its site: the predicate of every chain walk."""
    policy = retry.RetryPolicy(max_attempts=2, base_delay_s=0.0)

    def oom():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        retry.call_with_retries(oom, "fetch.level_bits", policy)
    assert retry.exhausted(ei.value) == "fetch.level_bits"
    bare = torch.cuda.OutOfMemoryError("CUDA out of memory")
    assert watchdog.transient(bare) and retry.exhausted(bare) is None
    fatal = RuntimeError("shape mismatch")
    with pytest.raises(RuntimeError):
        retry.call_with_retries(lambda: (_ for _ in ()).throw(fatal),
                                "fetch.tail", policy)
    assert retry.exhausted(fatal) is None


def test_retry_backoff_is_bounded():
    p = retry.RetryPolicy(max_attempts=5, base_delay_s=0.1, factor=4.0,
                          max_delay_s=0.5)
    assert [p.delay(i) for i in range(4)] == [0.1, 0.4, 0.5, 0.5]


def test_retry_policy_env_defaults(monkeypatch):
    monkeypatch.delenv("FA_RETRY_MAX", raising=False)
    monkeypatch.delenv("FA_RETRY_BACKOFF_MS", raising=False)
    retry.reload_policy_from_env()
    assert retry.policy_from_env() is retry.DEFAULT_POLICY


def test_retry_policy_env_knobs_apply(monkeypatch):
    monkeypatch.setenv("FA_RETRY_MAX", "5")
    monkeypatch.setenv("FA_RETRY_BACKOFF_MS", "12.5")
    retry.reload_policy_from_env()
    pol = retry.policy_from_env()
    assert pol.max_attempts == 5 and pol.base_delay_s == 0.0125
    failpoints.arm("knob.site", "oom*4")
    sleeps = []
    assert retry.call_with_retries(lambda: "ok", "knob.site",
                                   sleep=sleeps.append) == "ok"
    assert len(sleeps) == 4 and sleeps[0] == pytest.approx(0.0125)


@pytest.mark.parametrize("var,val", [
    ("FA_RETRY_MAX", "three"), ("FA_RETRY_MAX", "0"),
    ("FA_RETRY_BACKOFF_MS", "fast"), ("FA_RETRY_BACKOFF_MS", "-1"),
])
def test_retry_policy_env_strictly_parsed(monkeypatch, var, val):
    monkeypatch.setenv(var, val)
    retry.reload_policy_from_env()
    with pytest.raises(InputError, match=var):
        retry.policy_from_env()


def test_async_fetch_is_audited_and_memoized():
    failpoints.arm("fetch.level_bits", "oom*1")
    handle = retry.fetch_async(torch.arange(5), "level_bits",
                               retry.RetryPolicy(base_delay_s=0.0))
    assert handle.result().tolist() == [0, 1, 2, 3, 4]
    assert handle.result() is handle.result()
    assert [e["site"] for e in ledger.snapshot()] == ["fetch.level_bits"]


# ---------------------------------------------------------------------------
# ledger


def test_ledger_records_and_forwards_to_metrics():
    m = MetricsLogger()
    ledger.attach_metrics(m)
    ledger.record("pair_cap_overflow", n2=9, cap=8)
    ledger.record("pair_cap_overflow", n2=9, cap=8)
    assert ledger.summary() == {"pair_cap_overflow": 2}
    degraded = [r for r in m.records if r["event"] == "degraded"]
    assert len(degraded) == 2 and degraded[0]["kind"] == "pair_cap_overflow"


def test_ledger_warns_once_per_key(capsys):
    ledger.record("retry", once_key="a", site="fetch.x")
    ledger.record("retry", once_key="a", site="fetch.x")
    ledger.record("retry", once_key="b", site="fetch.y")
    assert capsys.readouterr().err.count("degraded: retry") == 2


# ---------------------------------------------------------------------------
# watchdog and cascade


def test_watchdog_disabled_is_passthrough(monkeypatch):
    monkeypatch.delenv("FA_DISPATCH_TIMEOUT_S", raising=False)
    watchdog.reload_from_env()
    assert watchdog.dispatch_timeout_s() == 0.0
    assert watchdog.guard(lambda: 5, "fetch.x") == 5


def test_watchdog_timeout_classified_transient_and_recorded():
    with pytest.raises(watchdog.DispatchTimeout) as ei:
        watchdog.guard(lambda: time.sleep(1.0), "fetch.slow", timeout_s=0.05)
    assert retry.classify(ei.value) == "transient"
    (ev,) = ledger.snapshot()
    assert ev["kind"] == "watchdog_timeout" and ev["site"] == "fetch.slow"
    assert ev["abandoned_live"] >= 1


def test_watchdog_propagates_thunk_errors():
    def boom():
        raise ValueError("inner")

    with pytest.raises(ValueError, match="inner"):
        watchdog.guard(boom, "fetch.x", timeout_s=1.0)
    assert watchdog.guard(lambda: 3, "fetch.x", timeout_s=1.0) == 3


@pytest.mark.parametrize("var,val", [
    ("FA_DISPATCH_TIMEOUT_S", "soon"), ("FA_DISPATCH_TIMEOUT_S", "-1"),
    ("FA_DISPATCH_MAX_ABANDONED", "many"),
    ("FA_DISPATCH_MAX_ABANDONED", "-2"),
])
def test_watchdog_env_strictly_parsed(monkeypatch, var, val):
    monkeypatch.setenv(var, val)
    watchdog.reload_from_env()
    with pytest.raises(InputError, match=var):
        watchdog.dispatch_timeout_s()
        watchdog.max_abandoned()


def test_watchdog_bounds_a_retried_fetch_end_to_end(monkeypatch):
    monkeypatch.setenv("FA_DISPATCH_TIMEOUT_S", "0.05")
    watchdog.reload_from_env()
    calls = []

    def thunk():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(0.5)  # the first attempt hangs past the bound
        return "landed"

    assert retry.call_with_retries(thunk, "fetch.hang",
                                   sleep=lambda s: None) == "landed"
    kinds = [e["kind"] for e in ledger.snapshot()]
    assert kinds == ["watchdog_timeout", "retry"]


def test_watchdog_abandoned_cap_trips_fatal(monkeypatch):
    monkeypatch.setenv("FA_DISPATCH_MAX_ABANDONED", "1")
    watchdog.reload_from_env()
    gate = []
    for i in range(2):
        try:
            watchdog.guard(lambda: gate or time.sleep(1.0), f"fetch.w{i}",
                           timeout_s=0.02)
        except watchdog.DispatchTimeout:
            assert i == 0
        except watchdog.AbandonedThreadCap as e:
            assert i == 1 and retry.classify(e) == "fatal"
    assert watchdog.abandoned_live() == 2


def test_cascade_chains_match_the_jax_package():
    assert set(watchdog.CHAINS) == set(jax_watchdog.CHAINS)
    for chain, stages in watchdog.CHAINS.items():
        if chain in ("vertical_kernel", "serve_scan"):
            # Kernel tiers: named, never walked (a hand kernel's failure
            # stays an error in the port).
            assert stages == ("cuda", "torch")
        else:
            assert stages == jax_watchdog.CHAINS[chain], chain
    assert watchdog.chain_rank("engine", "level") == 2


def test_cascade_forward_only_and_event_shape():
    m = MetricsLogger()
    ledger.attach_metrics(m)
    watchdog.downgrade("engine", "fused", "level", reason="test", k=4)
    assert ledger.snapshot() == [{
        "kind": "cascade", "chain": "engine", "frm": "fused", "to": "level",
        "rank": 2, "reason": "test", "k": 4}]
    assert [r["chain"] for r in m.records if r["event"] == "degraded"] \
        == ["engine"]
    with pytest.raises(ValueError, match="backward"):
        watchdog.downgrade("engine", "level", "fused", reason="up")
    with pytest.raises(ValueError, match="unknown cascade chain"):
        watchdog.downgrade("nope", "a", "b", reason="x")


# ---------------------------------------------------------------------------
# atomic writes


def test_write_artifact_atomic_and_manifest(tmp_path):
    path = str(tmp_path / "out" / "freqItemset")
    manifest = {}
    writer.write_artifact(path, ["a\n", "b\n"], "freqItemset", manifest)
    assert open(path).read() == "a\nb\n"
    assert not os.path.exists(path + ".tmp")
    assert manifest["freqItemset"]["bytes"] == 4
    resume_io.validate_artifact_bytes(str(tmp_path / "out") + "/",
                                      "freqItemset", b"a\nb\n", manifest)


def test_write_artifact_injected_io_error_leaves_no_torn_file(tmp_path):
    path = str(tmp_path / "freqItemset")
    failpoints.arm("write.freqItemset", "io")
    with pytest.raises(OSError):
        writer.write_artifact(path, ["a\n"], "freqItemset")
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")


def test_write_manifest_merges_and_keeps_the_fence(tmp_path):
    prefix = str(tmp_path) + "/"
    writer.write_manifest(prefix, {"a": {"bytes": 1, "sha256": "x"}},
                          fence=3)
    writer.write_manifest(prefix, {"b": {"bytes": 2, "sha256": "y"}},
                          fence=2)
    assert set(resume_io.load_manifest(prefix)) == {"a", "b"}
    assert resume_io.manifest_fence(prefix) == 3  # never lowered


# ---------------------------------------------------------------------------
# engine integration: shared corpus and helpers

MIN_SUPPORT = 0.08


def _deep_lines():
    """A lattice reaching k = 6 (a planted 6-itemset) plus noise."""
    return ["1 2 3 4 5 6"] * 50 + random_dataset(5, n_txns=110)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("reliability")
    (d / "D.dat").write_text("".join(x + "\n" for x in _deep_lines()))
    (d / "U.dat").write_text(
        "".join(x + "\n" for x in random_dataset(13, n_txns=30)))
    return str(d) + "/"


def _mine(corpus, **knobs):
    cfg = MinerConfig(min_support=MIN_SUPPORT, **knobs)
    miner = FastApriori(config=cfg, device="cpu")
    levels, data = miner.run_file_raw(corpus + "D.dat")
    return levels, data, miner


def _jax_levels(corpus, **knobs):
    cfg = JaxConfig(min_support=MIN_SUPPORT, engine="level", num_devices=1,
                    **knobs)
    return JaxApriori(config=cfg).run_file_raw(corpus + "D.dat")[0]


def _levels_equal(got, want):
    assert len(got) == len(want)
    for (gm, gc), (wm, wc) in zip(got, want):
        assert np.array_equal(gm, wm)
        assert gc.dtype == np.int64 and np.array_equal(gc, wc)


def _events(miner, name):
    return [r for r in miner.metrics.records if r["event"] == name]


def _recommend(corpus, levels, data, **knobs):
    rec = AssociationRules(
        data.freq_items, data.item_to_rank, levels, data.item_counts,
        config=MinerConfig(min_support=MIN_SUPPORT, **knobs), device="cpu")
    return rec.run(read_dat(corpus + "U.dat"), use_device=True)


# Each one-process fetch site of the JAX package's inventory
# (tests/test_reliability.py FETCH_SITE_INVENTORY) with the port's
# production path that reaches it: (miner knobs, recommend knobs or None).
_SPARSE = {"ingest_pipeline_blocks": 1, "num_devices": 2,
           "count_sparse_cap": 1 << 20, "count_sparse_min": 8}
FETCH_SITES = {
    "pair": ({"engine": "level", "ingest_pipeline_blocks": 1}, None),
    "pair_pre": ({"engine": "level"}, None),
    "pair_regather": ({"engine": "level", "pair_cap": 1}, None),
    "fused": ({"engine": "fused"}, None),
    "tail": ({"engine": "level", "tail_fuse_rows": 1 << 16}, None),
    "counts": ({"engine": "level"}, None),
    "counts_drain": ({"engine": "level", "pending_fetch_budget_bytes": 1},
                     None),
    "counts_resolve": ({"engine": "level", "ingest_pipeline_blocks": 1,
                        "tail_fuse_rows": 1 << 16}, None),
    "level_bits": ({"engine": "level"}, None),
    "level_counts": ({"engine": "level", "checkpoint_prefix": True}, None),
    "rule_mask": ({"engine": "level"}, {"rule_engine": "device"}),
    "rule_counts": ({"engine": "level"}, {"rule_engine": "device"}),
    "rec_match": ({"engine": "level"}, {}),
    "vpair": ({"mine_engine": "vertical"}, None),
    "vlevel_bits": ({"mine_engine": "vertical"}, None),
    # Two CPU shards, the sparse reduction at every level and a union
    # budget no union can pass.
    "pair_sparse": ({**_SPARSE, "engine": "level"}, None),
    "level_bits_sparse": ({**_SPARSE, "engine": "level"}, None),
    "vpair_sparse": ({**_SPARSE, "mine_engine": "vertical"}, None),
    "vlevel_bits_sparse": ({**_SPARSE, "mine_engine": "vertical"}, None),
}


@pytest.mark.parametrize("site", sorted(FETCH_SITES))
def test_every_one_device_fetch_site_is_armable_and_retried(
        site, corpus, tmp_path):
    knobs, rec_knobs = FETCH_SITES[site]
    knobs = dict(knobs)
    if knobs.get("checkpoint_prefix"):
        knobs["checkpoint_prefix"] = str(tmp_path) + "/"
    clean, data, _ = _mine(corpus, **knobs)
    clean_rec = (_recommend(corpus, clean, data, **rec_knobs)
                 if rec_knobs is not None else None)
    ledger.reset()
    failpoints.arm("fetch." + site, "oom*1")
    got, data, miner = _mine(corpus, **knobs)
    if rec_knobs is not None:
        assert _recommend(corpus, got, data, **rec_knobs) == clean_rec
    _levels_equal(got, clean)
    retries = [e for e in ledger.snapshot() if e["kind"] == "retry"]
    assert [e["site"] for e in retries] == ["fetch." + site]
    assert "cascade" not in ledger.summary()  # nothing walked a chain
    # The retry reached the --metrics stream of the run.
    assert [r["site"] for r in _events(miner, "degraded")
            if r["kind"] == "retry"] == ["fetch." + site]


# ---------------------------------------------------------------------------
# deferred survivor counts


@pytest.mark.parametrize("layout", ["bitmap", "vertical"])
def test_deferred_counts_equal_eager_and_the_jax_package(
        layout, corpus, tmp_path, monkeypatch):
    """Several launches per level (a 4-prefix budget): every chunk is
    issued, then one survivor-mask read per level; the counts stay on
    the device and resolve in one gather after the loop.  The levels
    equal the eager (checkpointed) loop's and the JAX package's."""
    knobs = dict(engine="level", mine_engine=layout, level_prefix_cap=4,
                 min_prefix_bucket=1, ingest_pipeline_blocks=1)
    bit_reads = []
    real = retry.fetch_async

    def counting(x, site, policy=None):
        bit_reads.append(site)
        return real(x, site, policy)

    monkeypatch.setattr(retry, "fetch_async", counting)
    deferred, _, miner = _mine(corpus, **knobs)
    site = "vlevel_bits" if layout == "vertical" else "level_bits"
    levels_k = [r for r in _events(miner, "level") if r["k"] >= 3]
    assert bit_reads.count(site) == len(levels_k)
    assert sum(r["launches"] for r in levels_k) > len(levels_k)
    (res,) = _events(miner, "counts_resolve")
    assert res["dispatches"] == 1 and res["drains"] == 0
    eager, _, eager_miner = _mine(corpus, checkpoint_prefix=str(tmp_path)
                                  + "/", **knobs)
    assert not _events(eager_miner, "counts_resolve")
    _levels_equal(deferred, eager)
    jax_knobs = {"mine_engine": layout} if layout == "vertical" else {}
    monkeypatch.undo()
    _levels_equal(deferred, _jax_levels(corpus, **jax_knobs))
    assert ledger.summary() == {}


@pytest.mark.parametrize("layout", ["bitmap", "vertical"])
def test_small_pending_budget_drains_and_keeps_the_levels(layout, corpus):
    clean, _, _ = _mine(corpus, engine="level", mine_engine=layout)
    got, _, miner = _mine(corpus, engine="level", mine_engine=layout,
                          pending_fetch_budget_bytes=1)
    drains = _events(miner, "counts_drain")
    assert drains and all(r["dispatches"] == 1 for r in drains)
    (res,) = _events(miner, "counts_resolve")
    assert res["drains"] == len(drains)
    _levels_equal(got, clean)


def test_drain_async_fetch_transient_retried(corpus):
    clean, _, _ = _mine(corpus, engine="level")
    failpoints.arm("fetch.counts_drain", "oom*1")
    got, _, _ = _mine(corpus, engine="level", pending_fetch_budget_bytes=1)
    _levels_equal(got, clean)
    assert [e["site"] for e in ledger.snapshot()] == ["fetch.counts_drain"]


def test_drain_delay_failpoint_only_slows(corpus):
    clean, _, _ = _mine(corpus, engine="level")
    failpoints.arm("drain.counts", "delay@30")
    got, _, _ = _mine(corpus, engine="level", pending_fetch_budget_bytes=1)
    _levels_equal(got, clean)


def test_tail_fold_resolves_the_pending_counts_in_its_program(corpus):
    """Level 3 counted by K1's plain version (deferred), then a forced
    fold from level 3 that ends the mine: the fold's program gathers the
    pending counts, and no resolve gather is left after the loop."""
    knobs = dict(engine="level", ingest_pipeline_blocks=1)
    clean, _, _ = _mine(corpus, **knobs)
    got, _, miner = _mine(corpus, tail_fuse_rows=1 << 16, **knobs)
    folds = _events(miner, "tail_fuse")
    assert folds and folds[0]["resolve_folded"] is True
    assert folds[-1]["incomplete"] is False
    (res,) = _events(miner, "counts_resolve")
    assert res["dispatches"] == 0 and res["drains"] == 1
    _levels_equal(got, clean)


# ---------------------------------------------------------------------------
# the cascade's walks on transients that outlasted their retries


def _cascades():
    return [(e["chain"], e["frm"], e["to"], e["reason"])
            for e in ledger.snapshot() if e["kind"] == "cascade"]


@pytest.mark.parametrize("site,knobs,walk", [
    ("fetch.fused", {"engine": "fused"}, ("engine", "fused", "level")),
    ("fetch.tail", {"engine": "level", "tail_fuse_rows": 1 << 16},
     ("engine", "tail", "level")),
    ("fetch.vlevel_bits", {"mine_engine": "vertical"},
     ("mine_engine", "vertical", "bitmap")),
])
def test_transient_exhaustion_walks_the_chain(site, knobs, walk, corpus):
    clean, _, _ = _mine(corpus, engine="level")
    failpoints.arm(site, "oom")  # every attempt
    got, _, _ = _mine(corpus, **knobs)
    _levels_equal(got, clean)
    assert walk + ("transient_exhausted",) in _cascades()


@pytest.mark.parametrize("site,rec_knobs,walk", [
    ("fetch.rule_mask", {"rule_engine": "device"},
     ("rule_engine", "device", "host")),
    ("fetch.rec_match", {}, ("rule_scan", "device", "host")),
])
def test_phase_two_transient_exhaustion_walks_the_chain(
        site, rec_knobs, walk, corpus):
    """The device rule join walks to the host engine.  The ``rule_scan``
    chain is named only: K2's scan never moves to the host, so an
    exhausted ``rec_match`` fetch raises and nothing is walked."""
    levels, data, _ = _mine(corpus, engine="level")
    clean = _recommend(corpus, levels, data, **rec_knobs)
    ledger.reset()
    failpoints.arm(site, "oom")
    if walk[0] == "rule_scan":
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED") as ei:
            _recommend(corpus, levels, data, **rec_knobs)
        assert retry.exhausted(ei.value) == site
        assert _cascades() == []
        return
    assert _recommend(corpus, levels, data, **rec_knobs) == clean
    assert walk + ("transient_exhausted",) in _cascades()


def _raise_cuda_oom(*a, **k):
    raise torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")


@pytest.mark.parametrize("layout,wrapper", [
    ("bitmap", "local_level_gather"),
    ("vertical", "vertical_level_local"),
])
def test_kernel_oom_at_launch_is_never_walked_around(
        layout, wrapper, corpus, monkeypatch):
    """A real CUDA OOM is transient, but raised at a K1 or K3 launch
    (not at an audited fetch) it propagates: no walk to the other
    layout, no retry."""
    from fastapriori_tpu_torch.models import apriori

    monkeypatch.setattr(apriori, wrapper, _raise_cuda_oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _mine(corpus, engine="level", mine_engine=layout)
    assert ledger.snapshot() == []


def test_oom_inside_strided_match_scan_propagates(corpus, monkeypatch):
    """An OOM raised inside K2's wrapper ends the recommend phase: the
    host scan never takes over K2's work."""
    from fastapriori_tpu_torch.models import recommender

    levels, data, _ = _mine(corpus, engine="level")
    scanned = []
    monkeypatch.setattr(AssociationRules, "_host_first_match",
                        lambda self, b: scanned.append(b) or [])
    monkeypatch.setattr(recommender, "strided_match_scan", _raise_cuda_oom)
    ledger.reset()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _recommend(corpus, levels, data)
    assert scanned == [] and ledger.snapshot() == []


def test_kernel_failure_is_never_walked_around(corpus, monkeypatch):
    """A fatal error inside the level kernel's path propagates: no chain
    walks from a hand kernel to its plain version."""
    from fastapriori_tpu_torch.models import apriori

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(apriori, "local_level_gather", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _mine(corpus, engine="level")
    assert _cascades() == []


def test_native_load_failpoint_degrades_to_python_ingest(corpus,
                                                         monkeypatch):
    if loader.get_lib() is None:
        pytest.skip("native library unavailable on this host")
    clean, _, _ = _mine(corpus, engine="level")
    monkeypatch.setattr(loader, "_LIBS", {})
    failpoints.arm("native.load", "io")
    got, _, miner = _mine(corpus, engine="level")
    (pre,) = _events(miner, "preprocess")
    assert pre["native"] is False and "load failed" in pre["native_reason"]
    assert set(ledger.summary()) == {"native_unavailable"}
    _levels_equal(got, clean)
    failpoints.disarm_all()
    assert loader.get_lib() is not None  # an injected failure is not kept


def test_native_blocks_failpoint_raises(corpus):
    failpoints.arm("native.blocks", "io*1")
    with pytest.raises(OSError, match="native.blocks"):
        _mine(corpus, engine="level")
