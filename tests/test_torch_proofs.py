"""The port's read lane against the JAX package's (tests/test_proofs.py):
its scheduler and `MerkleWorkClass(device="cpu")` (plain K19, K20 + K21),
its copies of the fault plan, retry, breaker and metrics, its proof cache
and proof service.

The same seeded batches go through both packages' schedulers and must give
the same branches and roots, the same breaker states and the same counters,
chaos schedules included; the acceptance scenario runs both packages from
one state (the port's `ResidentEpochLoop(device="cpu")` beside the JAX
package's `ResidentEpochEngine`). Besides: a kernel error is never retried
and never degraded, an "xla" fault is a TransientFault, flight dumps go
only where OBS_FLIGHT_DIR points, and the scheduler's bucketing is the one
copy in utils/."""
import dataclasses

import numpy as np
import pytest
import torch

from consensus_specs_tpu import proofs as jproofs
from consensus_specs_tpu import sched as jsched
from consensus_specs_tpu.obs import metrics as jmetrics
from consensus_specs_tpu.robustness import faults as jfaults
from consensus_specs_tpu.robustness.retry import RetryPolicy as JRetryPolicy
from consensus_specs_tpu_torch.kernels import build
from consensus_specs_tpu_torch.obs import flight as tflight
from consensus_specs_tpu_torch.obs import metrics as tmetrics
from consensus_specs_tpu_torch.proofs import (
    ProofCache,
    ProofService,
    leaf_gindex,
    u64_column_chunks,
)
from consensus_specs_tpu_torch.robustness import breaker as tbreaker
from consensus_specs_tpu_torch.robustness import faults as tfaults
from consensus_specs_tpu_torch.robustness import retry as tretry
from consensus_specs_tpu_torch.sched import MerkleWorkClass, Request, Scheduler
from consensus_specs_tpu_torch.ssz.merkle import merkleize_chunks
from consensus_specs_tpu_torch.ssz.proofs import build_chunk_proof

FAST = dict(max_attempts=4, base_delay=0.0, backoff=1.0, max_delay=0.0, jitter=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rand_chunks(rng, n):
    return [rng.randint(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n)]


def _mixed(rng, counts):
    """tests/test_proofs.py's `_mixed_requests` workload as (kind, payload)
    pairs: tree_root and multiproof requests over random trees in several
    leaf-count buckets, odd query counts forcing pad queries."""
    items = []
    for i, n in enumerate(counts):
        chunks = _rand_chunks(rng, n)
        c_full = 1 if n <= 1 else 1 << (n - 1).bit_length()
        if i % 3 == 2:
            items.append(("tree_root", (chunks,)))
        for _ in range(int(rng.randint(1, 4))):
            items.append(("multiproof", (chunks, int(rng.randint(1, 2 * c_full)))))
    return items


def _oracle(items):
    return [bytes(merkleize_chunks(p[0])) if kind == "tree_root"
            else tuple(build_chunk_proof(*p)) for kind, p in items]


def _port_sched(**kw):
    kw.setdefault("retry_policy", tretry.RetryPolicy(**FAST))
    kw.setdefault("registry", tmetrics.MetricsRegistry())
    return Scheduler(classes=[MerkleWorkClass(device="cpu")], **kw)


def _jax_sched(**kw):
    kw.setdefault("retry_policy", JRetryPolicy(**FAST))
    kw.setdefault("registry", jmetrics.MetricsRegistry())
    return jsched.Scheduler(classes=[jsched.MerkleWorkClass()], **kw)


def _run(sch, request_cls, items):
    handles = [sch.submit(request_cls(work_class="merkle", kind=k, payload=p))
               for k, p in items]
    sch.drain()
    return [h.result() for h in handles]


def _counters(reg):
    snap = reg.snapshot()
    return {k: v for k, v in snap["counters"].items()
            if k.startswith(("sched_", "retries_", "fault_fires"))}


@pytest.mark.parametrize("counts", [(1, 3, 8, 5, 16, 2, 3), (4, 4, 7), (1,), (6, 6)])
def test_port_scheduler_matches_jax_scheduler(counts):
    items = _mixed(np.random.RandomState(42 + len(counts)), counts)
    ours, theirs = _port_sched(), _jax_sched()
    got = _run(ours, Request, items)
    assert got == _run(theirs, jsched.Request, items) == _oracle(items)
    assert _counters(ours.registry) == _counters(theirs.registry)


def test_port_degraded_path_matches_device_path():
    items = _mixed(np.random.RandomState(9), (3, 8, 2))
    reqs = [Request(work_class="merkle", kind=k, payload=p) for k, p in items]
    cls = MerkleWorkClass(device="cpu")
    device = [cls.to_result(row) for row in cls.execute(reqs)]
    degraded = [cls.to_result(row) for row in cls.execute_degraded(reqs)]
    assert device == degraded == _oracle(items)


@pytest.mark.parametrize("bad", [0, -3, 8, 100])
def test_port_rejects_bad_gindex(bad):
    chunks = _rand_chunks(np.random.RandomState(0), 4)
    h = _port_sched().submit(Request(work_class="merkle", kind="multiproof",
                                     payload=(chunks, bad)))
    with pytest.raises(ValueError):
        h.result()


CHAOS = [
    dict(kind="raise", at_calls=(1, 2), exc="transient"),
    dict(kind="raise", at_calls=(1,), exc="xla"),
    dict(kind="corrupt", at_calls=(1,), corruption="nan"),
    dict(kind="corrupt", at_calls=(1,), corruption="truncate"),
]


@pytest.mark.parametrize("spec", CHAOS)
def test_chaos_schedules_match_jax(spec):
    """tests/test_proofs.py's four chaos schedules at sched.dispatch, on both
    packages: the same branches, the breaker closed in both, the same fires
    and the same scheduler counters."""
    items = _mixed(np.random.RandomState(1234), (1, 3, 8, 5, 2))
    results = []
    for pkg_faults, make, request_cls in ((tfaults, _port_sched, Request),
                                          (jfaults, _jax_sched, jsched.Request)):
        plan = pkg_faults.FaultPlan(seed=15,
                                    sites={"sched.dispatch": pkg_faults.FaultSpec(**spec)})
        sch = make()
        with plan.active():
            got = _run(sch, request_cls, items)
        results.append((got, sch.breaker("merkle").state, plan.fired_sites(),
                        [(e.call_index, e.action) for e in plan.events],
                        _counters(sch.registry)))
    assert results[0] == results[1]
    assert results[0][0] == _oracle(items) and results[0][1] == "closed"
    assert results[0][2] == {"sched.dispatch"}


def test_hard_down_degrades_to_host_as_jax():
    items = _mixed(np.random.RandomState(5150), (3, 8, 2))
    outs = []
    for pkg_faults, make, request_cls in ((tfaults, _port_sched, Request),
                                          (jfaults, _jax_sched, jsched.Request)):
        sch = make(failure_threshold=1)
        plan = pkg_faults.FaultPlan(seed=5, sites={"sched.dispatch": pkg_faults.FaultSpec(
            kind="raise", rate=1.0, max_fires=FAST["max_attempts"], exc="transient")})
        with plan.active():
            got = _run(sch, request_cls, items)
        outs.append((got, sch.breaker("merkle").state, _counters(sch.registry)))
    assert outs[0] == outs[1]
    assert outs[0][0] == _oracle(items) and outs[0][1] == "open"
    assert outs[0][2]['sched_degraded_total{work_class="merkle"}'] == 1


def test_xla_fault_is_transient():
    plan = tfaults.FaultPlan(seed=1, sites={"s": tfaults.FaultSpec(kind="raise", at_calls=(1,),
                                                                   exc="xla")})
    with plan.active(), pytest.raises(tfaults.TransientFault):
        tfaults.fire("s")


def test_kernel_error_is_never_retried_nor_degraded():
    """A kernel that does not build, load or launch fails the flush: no
    retry, no host degrade, the breaker closed, every handle failed. An
    OSError (what a failed library load raises before it is wrapped) would
    have been retried and degraded."""
    err = build.KernelError("multiproof_heap: CUDA error 700")
    assert not tretry.is_retryable(err) and not tretry.is_device_failure(err)
    assert tretry.is_retryable(OSError("load")) and tretry.is_device_failure(OSError("load"))

    class Broken(MerkleWorkClass):
        calls = 0

        def execute(self, requests):
            Broken.calls += 1
            raise build.KernelError("multiproof_heap: CUDA error 700")

    reg = tmetrics.MetricsRegistry()
    sch = Scheduler(classes=[Broken(device="cpu")], registry=reg,
                    retry_policy=tretry.RetryPolicy(**FAST), failure_threshold=1)
    chunks = _rand_chunks(np.random.RandomState(3), 4)
    handles = [sch.submit(Request(work_class="merkle", kind="multiproof", payload=(chunks, g)))
               for g in (4, 5)]
    with pytest.raises(build.KernelError):
        sch.flush("merkle")
    assert Broken.calls == 1
    for h in handles:
        with pytest.raises(build.KernelError):
            h.result()
    assert sch.breaker("merkle").state == "closed"
    assert reg.counter_value("sched_degraded_total", work_class="merkle") == 0


def test_kernel_build_and_load_failures_raise_kernel_error(tmp_path, monkeypatch):
    with pytest.raises(build.KernelError):
        build.check(700, "multiproof_siblings")
    bad = tmp_path / "multiproof-broken.so"
    bad.write_bytes(b"not a shared library")
    monkeypatch.setattr(build, "library_path", lambda name: bad)
    build.library.cache_clear()
    try:
        with pytest.raises(build.KernelError):
            build.library("multiproof")
    finally:
        build.library.cache_clear()
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(build.KernelError):
        build.nvcc()


def _popen_denied(*args, **kwargs):
    raise PermissionError(13, "Permission denied", "nvcc")


def _source_unreadable(name):
    raise OSError(5, "Input/output error", f"{name}.cu")


@pytest.mark.parametrize("failure", ["popen", "mkdir", "read_source"])
def test_kernel_build_oserror_fails_the_flush_without_degrading(failure, tmp_path, monkeypatch):
    """A build that fails with an OSError (an nvcc that cannot run, a build
    directory that cannot be made, a source that cannot be read) reaches the
    scheduler as a KernelError: the multiproof flush fails its handles once,
    nothing is retried, nothing is served from the host. The wrapper is made
    to take its kernel branch (`is_cpu` reads False), so the flush goes
    through build.library as it does on the card."""
    from consensus_specs_tpu_torch.ops import multiproof as tmp

    monkeypatch.setattr(tmp, "is_cpu", lambda t: False)
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "torch_kernels")
    if failure == "popen":
        monkeypatch.setattr(build.subprocess, "Popen", _popen_denied)
    elif failure == "mkdir":
        (tmp_path / "ro").write_bytes(b"")
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "ro" / "torch_kernels")
    else:
        monkeypatch.setattr(build, "library_path", _source_unreadable)
    build.library.cache_clear()
    build.entry.cache_clear()
    reg = tmetrics.MetricsRegistry()
    sch = _port_sched(registry=reg, failure_threshold=1)
    chunks = _rand_chunks(np.random.RandomState(3), 4)
    try:
        handles = [sch.submit(Request(work_class="merkle", kind="multiproof",
                                      payload=(chunks, g))) for g in (4, 5)]
        with pytest.raises(build.KernelError):
            sch.flush("merkle")
    finally:
        build.library.cache_clear()
        build.entry.cache_clear()
    for h in handles:
        with pytest.raises(build.KernelError):
            h.result()
    assert sch.breaker("merkle").state == "closed"
    assert reg.counter_value("sched_degraded_total", work_class="merkle") == 0
    assert not any(k.startswith("retries_") for k in _counters(reg))


def test_flight_dumps_only_where_obs_flight_dir_points(tmp_path, monkeypatch):
    monkeypatch.delenv("OBS_FLIGHT_DIR", raising=False)
    brk = tbreaker.CircuitBreaker(failure_threshold=1, name="t-off")
    brk.record_failure()
    assert brk.state == "open" and not list(tmp_path.iterdir())
    monkeypatch.setenv("OBS_FLIGHT_DIR", str(tmp_path))
    brk = tbreaker.CircuitBreaker(failure_threshold=1, name="t-on")
    brk.record_failure()
    dumps = list(tmp_path.glob("flight_*.json"))
    assert len(dumps) == 1 and "breaker_open" in dumps[0].name
    assert tflight.current_recorder() is not None


def test_sched_bucketing_is_the_one_copy():
    from consensus_specs_tpu_torch.sched import bucketing as sb
    from consensus_specs_tpu_torch.utils import bucketing as ub

    assert sb.pow2_bucket is ub.pow2_bucket and sb.grouped_plan is ub.grouped_plan


def test_u64_column_chunks_of_a_tensor_match_numpy():
    col = np.array([0, 1, 2**63, 2**64 - 1, 5], dtype=np.uint64)
    assert u64_column_chunks(torch.from_numpy(col.view(np.int64))) == u64_column_chunks(col)
    assert u64_column_chunks(col) == jproofs.u64_column_chunks(col)
    assert leaf_gindex(3, 10) == jproofs.leaf_gindex(3, 10) == 19


# --- the proof cache and the proof service (tests/test_proofs.py:312-384) ---


def test_proof_cache_hit_miss_and_gauges():
    reg = tmetrics.MetricsRegistry()
    cache = ProofCache(registry=reg)
    assert cache.lookup("balances", 9) is None
    cache.store("balances", 9, (b"\x01" * 32, b"\x02" * 32))
    assert cache.lookup("balances", 9) == (b"\x01" * 32, b"\x02" * 32)
    assert reg.counter_value("proof_cache_misses_total", column="balances") == 1
    assert reg.counter_value("proof_cache_hits_total", column="balances") == 1
    assert reg.gauge_value("proof_cache_hit_ratio") == 0.5
    assert reg.gauge_value("proof_cache_entries") == 1
    assert cache.size() == 1


def test_proof_cache_exact_single_column_invalidation():
    """Two columns, one mutated between epochs, on both packages: exactly the
    mutated column's entries drop, the clean one answers from the cache, and
    the branches and counters agree between the packages."""
    data = {"balances": np.arange(40, dtype=np.uint64) * 11,
            "inactivity_scores": np.arange(40, dtype=np.uint64) * 3}
    services = []
    for pkg, reg, sch in (
            ("port", tmetrics.MetricsRegistry(), None),
            ("jax", jmetrics.MetricsRegistry(), None)):
        if pkg == "port":
            svc = ProofService(scheduler=_port_sched(registry=reg), registry=reg)
        else:
            svc = jproofs.ProofService(scheduler=_jax_sched(registry=reg), registry=reg)
        for name in data:
            svc.register_column(name, lambda name=name: u64_column_chunks(data[name]))
        services.append((svc, reg))
    n_chunks = len(u64_column_chunks(data["balances"]))  # 10 -> c_full 16
    queries = [(name, leaf_gindex(i, n_chunks)) for name in data for i in (0, 4, 9)]
    first = [svc.prove_many(queries) for svc, _ in services]
    assert first[0] == first[1]
    for (name, g), branch in zip(queries, first[0]):
        assert list(branch) == build_chunk_proof(u64_column_chunks(data[name]), g)

    data["balances"] = data["balances"].copy()
    data["balances"][7] += 1_000_000
    dirty = {"balances": True, "inactivity_scores": False}
    assert [svc.note_epoch(dirty) for svc, _ in services] == [3, 3]
    for svc, reg in services:
        assert svc.cache.entries("balances") == {}
        assert len(svc.cache.entries("inactivity_scores")) == 3
        assert reg.counter_value("proof_cache_invalidated_total", column="balances") == 3
        assert reg.counter_value("proof_cache_invalidated_total",
                                 column="inactivity_scores") == 0
    second = [svc.prove_many(queries) for svc, _ in services]
    assert second[0] == second[1]
    for (name, g), branch, old in zip(queries, second[0], first[0]):
        assert list(branch) == build_chunk_proof(u64_column_chunks(data[name]), g)
        if name == "inactivity_scores":
            assert branch == old
    for name in data:
        assert (services[0][1].counter_value("proof_cache_hits_total", column=name)
                == services[1][1].counter_value("proof_cache_hits_total", column=name)
                == (3 if name == "inactivity_scores" else 0))


def test_proof_service_unregistered_column_raises():
    svc = ProofService(registry=tmetrics.MetricsRegistry())
    with pytest.raises(KeyError):
        svc.prove("no_such_column", 1)


def test_proof_service_latency_histogram_observes_per_query():
    reg = tmetrics.MetricsRegistry()
    svc = ProofService(scheduler=_port_sched(registry=reg), registry=reg)
    col = np.arange(8, dtype=np.uint64)
    svc.register_column("c", lambda: u64_column_chunks(col))
    svc.prove_many([("c", leaf_gindex(i, 2)) for i in range(2)])
    hist = reg.snapshot()["histograms"]["proof_request_latency_seconds"]
    assert hist["count"] == 2
    assert reg.counter_value("proof_requests_total") == 2


def test_proof_service_prove_host_matches_prove():
    reg = tmetrics.MetricsRegistry()
    svc = ProofService(scheduler=_port_sched(registry=reg), registry=reg)
    col = torch.arange(21, dtype=torch.int64) * 5
    svc.register_column("c", lambda: u64_column_chunks(col))
    for g in (1, 3, 8, 13):
        assert svc.prove_host("c", g) == svc.prove("c", g)
    assert reg.counter_value("proof_degraded_reads_total") == 4


def test_read_lane_beside_resident_loop_matches_jax():
    """The acceptance scenario of tests/test_proofs.py:386 on both packages
    from one state: the JAX package's ResidentEpochEngine and the port's
    ResidentEpochLoop(device="cpu") over the same columns give equal
    dirty_columns(), equal branches before and after 3 epochs (each equal
    to build_chunk_proof over the current columns), and equal hit and
    invalidation counters."""
    from consensus_specs_tpu.compiler import get_spec
    from consensus_specs_tpu.crypto import bls
    from consensus_specs_tpu.engine.resident import ResidentEpochEngine
    from consensus_specs_tpu.testlib.state import prepared_epoch_state
    from consensus_specs_tpu_torch.engine.convert import (
        epoch_config_from_dict,
        epoch_state_from_numpy,
    )
    from consensus_specs_tpu_torch.engine.resident import ResidentEpochLoop

    spec = get_spec("altair", "minimal")
    was = bls.bls_active
    bls.bls_active = False
    try:
        st = prepared_epoch_state(spec, start_epoch=6, seed=21)
        eng = ResidentEpochEngine(spec, st)
        leaves = {f.name: np.array(getattr(eng.dev, f.name))
                  for f in dataclasses.fields(eng.dev)}
        loop = ResidentEpochLoop(epoch_config_from_dict(dataclasses.asdict(eng.cfg)),
                                 epoch_state_from_numpy(leaves, "cpu"), device="cpu")
        cols = ("balances", "activation_epoch", "activation_eligibility_epoch")
        jreg, treg = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
        jsvc = jproofs.ProofService(scheduler=_jax_sched(registry=jreg), registry=jreg)
        tsvc = ProofService(scheduler=_port_sched(registry=treg), registry=treg)

        def jchunks(name):
            return u64_column_chunks(np.asarray(getattr(eng.dev, name)))

        def tchunks(name):
            return u64_column_chunks(getattr(loop.state, name))

        for name in cols:
            jsvc.register_column(name, lambda name=name: jchunks(name))
            tsvc.register_column(name, lambda name=name: tchunks(name))
        n_chunks = len(tchunks("balances"))
        queries = [(name, leaf_gindex(i, n_chunks)) for name in cols
                   for i in range(min(4, n_chunks))]
        per_col = len(queries) // len(cols)
        before = tsvc.prove_many(queries)
        assert before == jsvc.prove_many(queries)
        for (name, g), branch in zip(queries, before):
            assert list(branch) == build_chunk_proof(tchunks(name), g)

        eng.run_epochs(3)
        loop.run_epochs(3)
        loop.flush()
        dirty = loop.dirty_columns()
        assert dirty == eng.dirty_columns()
        assert dirty["balances"] and not all(dirty[c] for c in cols)
        assert tsvc.note_epoch(dirty) == jsvc.note_epoch(eng.dirty_columns())
        for name in cols:
            assert len(tsvc.cache.entries(name)) == (0 if dirty[name] else per_col)
        after = tsvc.prove_many(queries)
        assert after == jsvc.prove_many(queries)
        for (name, g), branch, old in zip(queries, after, before):
            assert list(branch) == build_chunk_proof(tchunks(name), g)
            assert list(branch) == build_chunk_proof(jchunks(name), g)
            if not dirty[name]:
                assert branch == old
        for name in cols:
            for series in ("proof_cache_hits_total", "proof_cache_invalidated_total"):
                assert (treg.counter_value(series, column=name)
                        == jreg.counter_value(series, column=name))
            assert treg.counter_value("proof_cache_hits_total", column=name) == (
                0 if dirty[name] else per_col)
    finally:
        bls.bls_active = was


def test_lane_queries_are_proof_bench_queries():
    """chip_smoke.py's phase 5f takes its queries from the JAX package's
    benches/proof_bench.py recipe (RandomState(2302), round-robin)."""
    from benches.proof_bench import _build_queries
    from consensus_specs_tpu_torch.proofs import lane

    for n_chunks in (64, 1 << 18):
        assert lane.build_queries(n_chunks, 2048) == _build_queries({"queries": 2048}, n_chunks)


def test_equal_trees_share_one_device_slot(monkeypatch):
    """Queries over equal chunk lists (distinct objects) and over one list
    object fold in one tree slot; a different tree takes a second."""
    from consensus_specs_tpu_torch.engine import state_root as troot

    shapes = []
    real = troot.multiproof_batch

    def spy(words, tree_ids, gidx, device="cuda"):
        shapes.append((words.shape[0], sorted(set(tree_ids.tolist()))))
        return real(words, tree_ids, gidx, device=device)

    monkeypatch.setattr(troot, "multiproof_batch", spy)
    rng = np.random.RandomState(11)
    a, b = _rand_chunks(rng, 8), _rand_chunks(rng, 8)
    items = [("multiproof", (a, 9)), ("multiproof", (list(a), 12)),
             ("multiproof", (a, 3)), ("multiproof", (b, 15))]
    assert _run(_port_sched(), Request, items) == _oracle(items)
    assert shapes == [(2, [0, 1])]
