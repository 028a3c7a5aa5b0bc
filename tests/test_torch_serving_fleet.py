"""Twins of tests/test_serving_fleet.py on the port, on the CPU: the
registry and its checkpoint lineage, routing and spread over thread
replicas, failover when a replica dies (a stopped server and a SIGKILLed
worker process), health-sweep eject and re-admit, rollout under load, A/B,
and PS-backed CTR serving bitwise equal to the local-table Predictor while
each replica holds only its row cache. The models are the JAX test's,
saved by the JAX package; "correct" is within rtol 1e-5, atol 1e-6 of the
port's own unbatched Predictor, as in the JAX test. Replicas serve on the
CPU (``device="cpu"``; a process replica's worker gets ``--device cpu``).
(`test_serving_bench_slo_gate_exit_codes` has its twin in
tests/test_torch_load_tools.py.)"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import inference

from _torch_twin import cpu_config, fresh_observability, fresh_port_state
from test_serving_fleet import (BUCKETS, CAP, F, V, _FakeReplica, _matches,
                                _packed_table, _rows, _save_ctr, _save_mlp)

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


@pytest.fixture(autouse=True)
def _fresh_observability():
    yield from fresh_observability()


@pytest.fixture(scope="module")
def two_models(tmp_path_factory):
    from paddle_tpu.core import program as prog_mod
    from paddle_tpu.core import scope as scope_mod

    old = (prog_mod._main_program, prog_mod._startup_program,
           scope_mod._global_scope, scope_mod._current_scope)
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    scope_mod._global_scope = scope_mod.Scope()
    scope_mod._current_scope = scope_mod._global_scope
    try:
        root = tmp_path_factory.mktemp("tfleet_models")
        d1 = _save_mlp(str(root / "v1"), seed=1)
        d2 = _save_mlp(str(root / "v2"), seed=2)
    finally:
        (prog_mod._main_program, prog_mod._startup_program,
         scope_mod._global_scope, scope_mod._current_scope) = old
    return {
        "v1": d1, "v2": d2,
        "ref1": inference.create_predictor(cpu_config(d1)),
        "ref2": inference.create_predictor(cpu_config(d2)),
    }


# -- registry ----------------------------------------------------------------

def test_registry_basics(two_models, tmp_path):
    from paddle_tpu_torch.serving import fleet

    reg = fleet.ModelRegistry()
    mv = reg.register("v1", two_models["v1"], precision="f32", note="first")
    assert mv.meta["note"] == "first"
    reg.register("v2", two_models["v2"])
    assert reg.versions() == ["v1", "v2"]
    assert reg.latest() == "v2"
    assert "v1" in reg and len(reg) == 2
    assert reg.resolve("v1").model_dir == two_models["v1"]
    with pytest.raises(ValueError, match="already registered"):
        reg.register("v1", two_models["v2"])
    with pytest.raises(KeyError, match="unknown version"):
        reg.resolve("v9")
    with pytest.raises(ValueError, match="does not exist"):
        reg.register("bad", str(tmp_path / "nope"))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="__model__"):
        reg.register("bad", str(empty))


def test_registry_checkpoint_lineage(two_models, tmp_path):
    """Only verified training checkpoints (the port's Checkpointer) can be
    promoted to serving."""
    import json

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import Checkpointer
    from paddle_tpu_torch.serving import fleet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [6])
        fluid.layers.fc(x, 4)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        ck = Checkpointer(str(tmp_path / "ck"))
        ck.save(1, program=main)
        ck.save(2, program=main)
        ck.wait()
    assert sorted(ck.verified_steps()) == [1, 2]

    ckdir = tmp_path / "ck"
    manifest = next(f for f in os.listdir(ckdir)
                    if f.startswith("ckpt-2.manifest-"))
    with open(ckdir / manifest) as f:
        victim = sorted(json.load(f)["files"])[0]
    with open(ckdir / victim, "ab") as f:
        f.write(b"\0torn")
    assert ck.verified_steps() == [1]

    reg = fleet.ModelRegistry()
    mv = reg.register("good", two_models["v1"], checkpointer=ck)
    assert mv.meta["checkpoint_step"] == 1
    with pytest.raises(ValueError, match="not verified"):
        reg.register("bad", two_models["v1"], checkpointer=ck, step=2)


# -- thread fleet: routing, failover, rollout, A/B ---------------------------

def _fleet(two_models, version="v1", n=3, **kw):
    from paddle_tpu_torch.serving import fleet

    reg = fleet.ModelRegistry()
    reg.register("v1", two_models["v1"])
    reg.register("v2", two_models["v2"])
    kw.setdefault("server_kwargs", {"max_batch_delay_ms": 1.0})
    kw.setdefault("health_interval_s", 0.1)
    return fleet.ServingFleet(reg, version, replicas=n, buckets=BUCKETS,
                              device="cpu", **kw)


def test_thread_fleet_routes_and_spreads(two_models):
    fl = _fleet(two_models, policy="round_robin")
    feeds = [_rows(1 + i % 3, seed=i) for i in range(12)]
    refs = [two_models["ref1"].run({"x": f})[0] for f in feeds]
    with fl:
        outs = [fl.infer({"x": f})[0] for f in feeds]
        served = [r._server.metrics.snapshot()["serving/requests"]
                  for r in fl.replicas]
    for got, ref in zip(outs, refs):
        assert _matches(got, ref)
    assert sum(served) == 12
    assert all(c >= 1 for c in served), served


def test_thread_fleet_survives_replica_kill(two_models):
    fl = _fleet(two_models)
    with fl:
        assert _matches(fl.infer({"x": _rows(2)})[0],
                        two_models["ref1"].run({"x": _rows(2)})[0])
        victim = fl.replicas[1]
        victim.kill()
        for i in range(10):
            f = _rows(1 + i % 3, seed=50 + i)
            assert _matches(fl.infer({"x": f})[0],
                            two_models["ref1"].run({"x": f})[0])
        fl.router.sweep()
        st = fl.router.stats()
        assert st["replicas"][victim.name]["ejected"]
        assert not st["replicas"][victim.name]["alive"]
        assert st["metrics"]["fleet/ejections"] >= 1
        assert fl.versions_live() == {"v1": 2}


def _closed_loop(fl, feeds, refs1, refs2, errors, mismatches, done,
                 served=None):
    def client(k):
        i = 0
        while not done.is_set():
            j = (k + i) % len(feeds)
            try:
                out = fl.infer({"x": feeds[j]})[0]
            except Exception as e:
                errors.append(repr(e))
                return
            if not (_matches(out, refs1[j]) or _matches(out, refs2[j])):
                mismatches.append(j)
            if served is not None:
                served[0] += 1
            i += 1
    return client


def test_rollout_under_load_drops_nothing(two_models):
    fl = _fleet(two_models)
    feeds = [_rows(1 + i % 4, seed=100 + i) for i in range(6)]
    refs1 = [two_models["ref1"].run({"x": f})[0] for f in feeds]
    refs2 = [two_models["ref2"].run({"x": f})[0] for f in feeds]
    assert not _matches(refs1[0], refs2[0])
    errors, mismatches = [], []
    done = threading.Event()
    client = _closed_loop(fl, feeds, refs1, refs2, errors, mismatches, done)
    with fl:
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in clients:
            t.start()
        time.sleep(0.1)
        report = fl.rollout("v2")
        time.sleep(0.1)
        done.set()
        for t in clients:
            t.join()
        assert errors == []
        assert mismatches == []
        for name, rep in report["replicas"].items():
            assert rep["version"] == "v2", (name, rep)
            assert rep["drained"]["rejected"] == 0, (name, rep)
        assert fl.versions_live() == {"v2": 3}
        for j, f in enumerate(feeds):
            assert _matches(fl.infer({"x": f})[0], refs2[j])


def test_ab_split_serves_both_versions(two_models):
    fl = _fleet(two_models, policy="round_robin")
    f = _rows(2, seed=7)
    ref1 = two_models["ref1"].run({"x": f})[0]
    ref2 = two_models["ref2"].run({"x": f})[0]
    with fl:
        rep = fl.ab_split("v2", weight_b=0.5, count=1)
        assert all("error" not in r for r in rep["replicas"].values())
        assert fl.versions_live() == {"v1": 2, "v2": 1}
        hits = {"v1": 0, "v2": 0}
        for _ in range(40):
            out = fl.infer({"x": f})[0]
            if _matches(out, ref1):
                hits["v1"] += 1
            elif _matches(out, ref2):
                hits["v2"] += 1
            else:
                pytest.fail("output matches neither version")
        assert hits["v1"] >= 5 and hits["v2"] >= 5, hits
        fl.router.set_version_weights(None)


# -- router unit surface (the JAX test's fake replicas) ----------------------

def _router(*replicas, **kw):
    from paddle_tpu_torch.serving.fleet import FleetRouter
    from paddle_tpu_torch.serving.metrics import Metrics

    kw.setdefault("metrics", Metrics(attach=False))
    return FleetRouter(replicas, **kw)


def test_router_eject_and_readmit():
    a, b = _FakeReplica("a"), _FakeReplica("b")
    rt = _router(a, b)
    b.set_health("failing", "serving")
    rt.sweep()
    st = rt.stats()["replicas"]
    assert st["b"]["ejected"] and not st["b"]["eligible"]
    assert rt.metrics.counter("fleet/ejections").value == 1
    assert [rt.infer({})[0] for _ in range(3)] == ["a", "a", "a"]

    b.set_health("ok", "serving")
    rt.sweep()
    st = rt.stats()["replicas"]
    assert not st["b"]["ejected"] and st["b"]["eligible"]
    assert rt.metrics.counter("fleet/readmissions").value == 1

    b.set_health("degraded", "draining")
    rt.sweep()
    st = rt.stats()["replicas"]
    assert not st["b"]["eligible"] and not st["b"]["ejected"]
    assert rt.metrics.counter("fleet/ejections").value == 1


def test_router_deprioritizes_degraded():
    a, b = _FakeReplica("a"), _FakeReplica("b")
    rt = _router(a, b)
    a.set_health("degraded", "serving")
    rt.sweep()
    assert [rt.infer({})[0] for _ in range(5)] == ["b"] * 5
    b.set_health("failing", "serving")
    rt.sweep()
    assert rt.infer({})[0] == "a"


def test_router_failover_replays_on_other_replica():
    from paddle_tpu_torch.ps.transport import TransportError
    from paddle_tpu_torch.serving.fleet import ReplicaDeadError

    a, b = _FakeReplica("a"), _FakeReplica("b")
    rt = _router(a, b, policy="round_robin")
    a.raise_on_submit = ReplicaDeadError("gone")
    b.fail_future_with = None
    outs = {rt.infer({})[0] for _ in range(4)}
    assert outs == {"b"}
    assert rt.metrics.counter("fleet/retries").value >= 1
    assert not rt.stats()["replicas"]["a"]["eligible"]

    a.raise_on_submit = None
    b.fail_future_with = TransportError("conn reset", transient=True)
    rt.sweep()
    assert rt.infer({})[0] == "a"


def test_router_surfaces_non_replica_errors_and_exhaustion():
    from paddle_tpu_torch.serving import QueueFullError
    from paddle_tpu_torch.serving.fleet import NoReplicaAvailableError

    a, b = _FakeReplica("a"), _FakeReplica("b")
    rt = _router(a, b)
    a.fail_future_with = ValueError("bad feed")
    b.fail_future_with = ValueError("bad feed")
    with pytest.raises(ValueError, match="bad feed"):
        rt.infer({})
    assert rt.metrics.counter("fleet/retries").value == 0

    a.fail_future_with = b.fail_future_with = None
    a.raise_on_submit = QueueFullError("full")
    b.raise_on_submit = QueueFullError("full")
    with pytest.raises(QueueFullError):
        rt.infer({})
    st = rt.stats()["replicas"]
    assert st["a"]["eligible"] and st["b"]["eligible"]

    a.set_health("failing", "dead")
    b.set_health("failing", "dead")
    rt.sweep()
    with pytest.raises(NoReplicaAvailableError):
        rt.infer({})


# -- process fleet: the SIGKILL acceptance drill -----------------------------

def test_process_fleet_sigkill_failover(two_models):
    """N=3 worker processes (fresh interpreters serving with --device cpu)
    under closed-loop load, one SIGKILLed mid-flight: zero client-visible
    errors, every response correct, the corpse ejected."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    fl = _fleet(two_models, mode="process", env=env,
                server_kwargs={"max_batch_delay_ms": 1.0})
    feeds = [_rows(1 + i % 2, seed=200 + i) for i in range(4)]
    refs = [two_models["ref1"].run({"x": f})[0] for f in feeds]
    errors, bad = [], []

    def client(k):
        for i in range(8):
            j = (k + i) % len(feeds)
            try:
                out = fl.infer({"x": feeds[j]})[0]
            except Exception as e:
                errors.append(repr(e))
                return
            if not _matches(out, refs[j]):
                bad.append(j)

    with fl:
        assert all(r.kind == "process" for r in fl.replicas)
        victim = fl.replicas[1]
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(3)]
        for t in clients:
            t.start()
        time.sleep(0.05)
        victim.kill()
        for t in clients:
            t.join()
        assert errors == [], errors
        assert bad == []
        fl.router.sweep()
        st = fl.router.stats()
        assert not st["replicas"][victim.name]["alive"]
        assert st["replicas"][victim.name]["ejected"]
        assert fl.versions_live() == {"v1": 2}
        assert _matches(fl.infer({"x": feeds[0]})[0], refs[0])


# -- PS-backed CTR serving ---------------------------------------------------

def test_ps_lookup_bitwise_identical_with_bounded_footprint(tmp_path):
    from paddle_tpu_torch.ps import RangeSpec, ShardedTable

    packed = _packed_table()
    dense = _save_ctr(str(tmp_path / "local"), V, packed=packed)
    _save_ctr(str(tmp_path / "ps"), CAP, dense=dense)

    ref = inference.create_predictor(cpu_config(str(tmp_path / "local")))
    table = ShardedTable.build_in_process(
        "tb", RangeSpec.even(V, 3), full_rows=packed)
    try:
        base = inference.create_predictor(cpu_config(str(tmp_path / "ps")))
        ps = inference.PsLookupPredictor(
            base, [inference.PsLookupBinding("tb", table, ["ids"])],
            cache_rows_per_table=32)
        rng = np.random.RandomState(3)
        for i in range(12):
            b = int(rng.randint(1, 5))
            ids = rng.randint(0, V, size=(b, F)).astype(np.int64)
            o_ref = ref.run_padded({"ids": ids}, 4)
            o_ps = ps.run_padded({"ids": ids}, 4)
            assert len(o_ref) == len(o_ps)
            for x, y in zip(o_ref, o_ps):
                np.testing.assert_array_equal(x, y)
        st = ps.stats()["tb"]
        assert st["hits"] > 0 and st["misses"] > 0 and st["evictions"] > 0
        assert ps.resident_table_bytes() * 4 <= packed.nbytes, (
            ps.resident_table_bytes(), packed.nbytes)
        # the cache table lives where the predictor serves
        assert ps._pred._state["tb"].device == ps._device
    finally:
        table.close()


def test_fleet_serves_ps_backed_ctr(tmp_path, two_models):
    from paddle_tpu_torch.ps import RangeSpec, ShardedTable
    from paddle_tpu_torch.serving import fleet

    packed = _packed_table()
    dense = _save_ctr(str(tmp_path / "local"), V, packed=packed)
    _save_ctr(str(tmp_path / "ps"), CAP, dense=dense)
    ref = inference.create_predictor(cpu_config(str(tmp_path / "local")))
    table = ShardedTable.build_in_process(
        "tb", RangeSpec.even(V, 2), full_rows=packed)
    wrappers = []

    def factory(model):
        base = inference.create_predictor(cpu_config(model.model_dir))
        ps = inference.PsLookupPredictor(
            base, [inference.PsLookupBinding("tb", table, ["ids"])],
            cache_rows_per_table=32)
        wrappers.append(ps)
        return ps

    reg = fleet.ModelRegistry()
    reg.register("ctr-v1", str(tmp_path / "ps"))
    rng = np.random.RandomState(5)
    example = {"ids": rng.randint(0, V, size=(1, F)).astype(np.int64)}
    fl = fleet.ServingFleet(
        reg, "ctr-v1", replicas=2, buckets=(1, 2, 4),
        predictor_factory=factory, example_feed=example,
        server_kwargs={"max_batch_delay_ms": 1.0}, health_interval_s=0.2)
    try:
        with fl:
            for _ in range(10):
                b = int(rng.randint(1, 5))
                ids = rng.randint(0, V, size=(b, F)).astype(np.int64)
                out = fl.infer({"ids": ids})[0]
                np.testing.assert_array_equal(out, ref.run({"ids": ids})[0])
        assert len(wrappers) == 2
        for w in wrappers:
            assert w.resident_table_bytes() * 4 <= packed.nbytes
    finally:
        table.close()


def test_worker_ps_endpoints_serve_from_a_live_shard_server(tmp_path,
                                                           two_models):
    """A process replica whose worker (``--device cpu --ps-endpoints``)
    reads its embedding rows from a live port ShardServer over the socket
    transport answers bitwise like a thread replica whose
    PsLookupPredictor reads an in-process table with the same bytes."""
    from paddle_tpu_torch.ps import (EmbeddingShard, RangeSpec, ShardServer,
                                     ShardedTable)
    from paddle_tpu_torch.serving.fleet import ModelRegistry
    from paddle_tpu_torch.serving.fleet.replica import (ProcessReplica,
                                                        ThreadReplica)

    packed = _packed_table()
    dense = _save_ctr(str(tmp_path / "local"), V, packed=packed)
    _save_ctr(str(tmp_path / "ps"), CAP, dense=dense)
    mv = ModelRegistry().register("ctr-v1", str(tmp_path / "ps"))
    srv = ShardServer([EmbeddingShard("tb", 0, V, rows=packed.copy())])
    srv.serve_in_thread()
    table = ShardedTable.build_in_process("tb", RangeSpec.even(V, 1),
                                          full_rows=packed)

    def factory(model):
        base = inference.create_predictor(cpu_config(model.model_dir))
        return inference.PsLookupPredictor(
            base, [inference.PsLookupBinding("tb", table, ["ids"])],
            cache_rows_per_table=32)

    proc = thread = None
    try:
        proc = ProcessReplica(
            "p0", mv, buckets=(1, 2, 4), device="cpu",
            env=dict(os.environ, OMP_NUM_THREADS="1"),
            extra_args=["--ps-endpoints", srv.endpoint,
                        "--ps-table", f"tb=tb:{V}",
                        "--ps-cache-rows", "32"],
            server_kwargs={"max_batch_delay_ms": 1.0})
        thread = ThreadReplica("t0", mv, buckets=(1, 2, 4),
                               predictor_factory=factory,
                               server_kwargs={"max_batch_delay_ms": 1.0})
        rng = np.random.RandomState(7)
        for _ in range(8):
            b = int(rng.randint(1, 5))
            ids = rng.randint(0, V, size=(b, F)).astype(np.int64)
            got = proc.submit({"ids": ids}).result(timeout=120)
            want = thread.submit({"ids": ids}).result(timeout=120)
            assert len(got) == len(want)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
        served = {s["labels"].get("op"): s["value"]
                  for s in _srv_series(srv) if s["name"] ==
                  "ps/server_requests"}
        assert served.get("pull", 0) > 0
    finally:
        for r in (proc, thread):
            if r is not None:
                r.stop()
        table.close()
        srv.stop()


def _srv_series(srv):
    """The series a ShardServer's process exposes (its `metrics` op)."""
    from paddle_tpu_torch.ps import SocketClient
    c = SocketClient(srv.endpoint, retries=0)
    try:
        return c.metrics()
    finally:
        c.close()


@pytest.mark.slow
def test_rollout_soak_alternating_versions(two_models):
    fl = _fleet(two_models)
    feeds = [_rows(1 + i % 4, seed=300 + i) for i in range(8)]
    refs1 = [two_models["ref1"].run({"x": f})[0] for f in feeds]
    refs2 = [two_models["ref2"].run({"x": f})[0] for f in feeds]
    errors, mismatches, served = [], [], [0]
    done = threading.Event()
    client = _closed_loop(fl, feeds, refs1, refs2, errors, mismatches, done,
                          served)
    with fl:
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in clients:
            t.start()
        reports = []
        for v in ("v2", "v1", "v2", "v1", "v2", "v1"):
            time.sleep(0.3)
            reports.append(fl.rollout(v))
        time.sleep(0.3)
        done.set()
        for t in clients:
            t.join()
        assert errors == []
        assert mismatches == []
        assert served[0] > 100
        for rep in reports:
            for name, r in rep["replicas"].items():
                assert r["drained"]["rejected"] == 0, (name, r)
        assert fl.versions_live() == {"v1": 3}
