"""Fleet and cluster in the port, held to the JAX package:

- the top-level namespace: every name ``paddle_tpu/__init__.py`` exports
  that the port has ported resolves in both packages (the 17 names of
  the first open fault, ``fleet`` and the modules of this slice);
- the fleet API and role makers: tests/test_parallel.py's
  test_fleet_api_single_process (the loss equal to the JAX package's,
  rtol 1e-6) and the four fleet tests of tests/test_ps_embedding.py
  (the role makers read the same env in both packages);
- the cross-trainer shuffle: tests/test_datasets.py's
  test_global_shuffle_routes_disjointly (the port's buckets equal the JAX
  package's, record for record) and test_global_shuffle_crosses_trainers
  (two port trainers through ``distributed.launch``; each trainer's
  records the set the JAX package's routing gives it);
- tests/test_dist_cluster.py's test_two_process_cluster_loss_equality
  through the port's launcher and fleet (the ranks bitwise equal to each
  other, within rtol 2e-4, atol 1e-5 of the JAX package's one-process run,
  the JAX test's tolerance, and rtol 1e-6 of the port's);
- tests/test_sparse_row_updates.py's
  test_deferred_fold_fires_under_compiled_program on a 4-rank gloo world
  (bb = 8, two rows a rank; the table's visible columns drawn as the JAX
  test draws them, its Adagrad state columns kept at the startup's, see
  ``torch_cluster_runner.deferred_table``): the losses across three fold
  boundaries
  within rtol 1e-5, atol 1e-7 of the JAX package's plain run (the JAX
  test's tolerance), through ``run``, ``run_batched`` and
  ``train_scanned``, and the log count 0 after the last fold;
- remat ``saveable_names``: gradients bitwise those of no remat, the named
  values kept (their aten ops are not run again in the backward) and the
  rest of each unit recomputed (the recomputed aten ops counted).
"""
import json
import os
import socket

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
import torch_cluster_runner as C
import torch_dist_mlp_runner as M
import torch_dist_runner as R
from paddle_tpu.core import unique_name as jnames
from paddle_tpu_torch.core import unique_name as tnames

torch.set_num_threads(1)

N = 4
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cluster_world")
    live = {}

    def get():
        w = live.get("w")
        if w is None or not w.alive:
            w = live["w"] = R.World(N, tmp, cases="torch_cluster_runner")
        return w

    yield get
    if "w" in live:
        live["w"].close()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    from paddle_tpu_torch.core import program as prog_mod
    from paddle_tpu_torch.core import scope as scope_mod

    old = (prog_mod._main_program, prog_mod._startup_program,
           scope_mod._global_scope, scope_mod._current_scope)
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    scope_mod._global_scope = scope_mod._current_scope = scope_mod.Scope()
    with tnames.guard():
        yield
    (prog_mod._main_program, prog_mod._startup_program,
     scope_mod._global_scope, scope_mod._current_scope) = old


# -- the top-level namespace ---------------------------------------------------

FAULT_1_NAMES = ["DatasetFactory", "DeviceLoader", "FetchHandle", "Evaluator",
                 "WeightedAverage", "WeightNormParamAttr",
                 "monkey_patch_variable", "CUDAPinnedPlace", "backward",
                 "compiler", "executor", "framework", "profiler",
                 "learning_rate_scheduler", "data_generator", "serving",
                 "py_reader_module"]


@pytest.mark.parametrize("name", FAULT_1_NAMES + [
    "fleet", "planner", "incubate", "faults", "observability"])
def test_top_level_name_resolves_in_both_packages(name):
    j, t = getattr(jfluid, name), getattr(tfluid, name)
    assert type(j).__name__ == type(t).__name__ or (
        callable(j) and callable(t)), (name, j, t)


def test_namespace_module_aliases():
    """``from paddle_tpu_torch.framework import ...`` and ``.executor``
    resolve as the JAX package's do; ``fluid.compiler`` is the compiler's
    surface; ``fluid.backward`` is a namespace of the autodiff functions;
    CUDAPinnedPlace is the CPU place, as in the JAX package."""
    from paddle_tpu_torch.executor import Executor
    from paddle_tpu_torch.framework import Program, Variable

    assert Executor is tfluid.Executor and Program is tfluid.Program
    assert Variable is tfluid.Variable
    assert tfluid.compiler.CompiledProgram is tfluid.CompiledProgram
    assert sorted(tfluid.compiler.__all__) == sorted(jfluid.compiler.__all__)
    for fn in ("append_backward", "calc_gradient", "gradients"):
        assert callable(getattr(tfluid.backward, fn))
        assert callable(getattr(jfluid.backward, fn))
    assert tfluid.CUDAPinnedPlace() == tfluid.CPUPlace()
    assert tfluid.learning_rate_scheduler.exponential_decay
    assert tfluid.py_reader_module.PyReader is tfluid.PyReader


# -- the fleet and the role makers --------------------------------------------

def test_fleet_api_single_process():
    from paddle_tpu.parallel.fleet import Fleet as JFleet
    from paddle_tpu.parallel.fleet import UserDefinedRoleMaker as JRole
    from paddle_tpu.parallel.mesh import DistributedStrategy as JStrategy
    from paddle_tpu_torch.parallel.fleet import Fleet, UserDefinedRoleMaker
    from paddle_tpu_torch.parallel.mesh import DistributedStrategy

    x_np = np.ones((8, 8), "float32")
    got = {}
    for pkg, fl, role, strat, names in (
            ("jax", JFleet, JRole, JStrategy, jnames),
            ("torch", Fleet, UserDefinedRoleMaker, DistributedStrategy,
             tnames)):
        fluid = jfluid if pkg == "jax" else tfluid
        f = fl()
        f.init(role(current_id=0, worker_num=1))
        assert f.is_worker() and f.is_first_worker()
        assert f.worker_num() == 1
        with names.guard():
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                x = fluid.layers.data("x", [8])
                y = fluid.layers.fc(x, 1, param_attr=fluid.ParamAttr(
                    name="fw", initializer=fluid.initializer.
                    NumpyArrayInitializer(np.full((8, 1), 0.25, "float32"))))
                loss = fluid.layers.mean(y)
                opt = f.distributed_optimizer(fluid.optimizer.SGD(0.1),
                                              strat())
                opt.minimize(loss)
                assert f.main_program is not None
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            got[pkg] = [np.asarray(exe.run(f.main_program, feed={"x": x_np},
                                           fetch_list=[loss])[0])
                        for _ in range(2)]
    assert np.isfinite(got["torch"]).all()
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-6)


def _roles(monkeypatch, env, drop=()):
    for k in drop:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    from paddle_tpu.incubate.fleet.base import role_maker as jrm
    from paddle_tpu_torch.incubate.fleet.base import role_maker as trm
    out = []
    for rm in (jrm.PaddleCloudRoleMaker(), trm.PaddleCloudRoleMaker()):
        rm.generate_role()
        out.append((rm.is_server(), rm.is_worker(), rm.server_num(),
                    rm.server_index(), rm.server_endpoints()))
    return out


def test_pserver_role_from_env(monkeypatch):
    eps = "10.0.0.1:6000,10.0.0.2:6000"
    j, t = _roles(monkeypatch, {"TRAINING_ROLE": "PSERVER",
                                "PADDLE_PSERVER_ENDPOINTS": eps,
                                "PADDLE_PSERVER_ID": "1"})
    assert t == j == (True, False, 2, 1, eps.split(","))


def test_pserver_role_resolved_from_pod_ip(monkeypatch):
    j, t = _roles(monkeypatch, {
        "TRAINING_ROLE": "PSERVER",
        "PADDLE_PSERVERS_IP_PORT_LIST": "10.0.0.1:6000,10.0.0.2:6001",
        "POD_IP": "10.0.0.2", "PADDLE_PORT": "6001"},
        drop=("PADDLE_PSERVER_ENDPOINTS", "PADDLE_PSERVER_ID"))
    assert t == j and t[0] and t[3] == 1


def test_pserver_role_env_errors(monkeypatch):
    from paddle_tpu.parallel.fleet import PaddleCloudRoleMaker as J
    from paddle_tpu_torch.parallel.fleet import PaddleCloudRoleMaker as T

    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.delenv("PADDLE_PSERVER_ENDPOINTS", raising=False)
    monkeypatch.delenv("PADDLE_PSERVERS_IP_PORT_LIST", raising=False)
    for rm in (J, T):
        with pytest.raises(ValueError, match="PSERVER"):
            rm().generate_role()
    monkeypatch.setenv("PADDLE_PSERVER_ENDPOINTS", "10.0.0.1:6000")
    monkeypatch.setenv("PADDLE_PSERVER_ID", "5")
    for rm in (J, T):
        with pytest.raises(ValueError, match="out of range"):
            rm().generate_role()
    # a server role makes no process group (and takes no card)
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_fleet_server_lifecycle():
    """fleet.init_server + run_server serve real shards; the rows pulled
    through the port's socket client are the rows the JAX package's
    server serves from the same shard."""
    import threading

    from paddle_tpu.ps import EmbeddingShard as JShard
    from paddle_tpu.ps.transport import SocketClient as JClient
    from paddle_tpu_torch.parallel.fleet import (Fleet, Role,
                                                 UserDefinedRoleMaker)
    from paddle_tpu_torch.ps import EmbeddingShard
    from paddle_tpu_torch.ps.transport import SocketClient

    v = 50
    rows = np.random.RandomState(11).randint(0, 2 ** 16, (v, 128)).astype(
        np.uint16)
    f = Fleet()
    f.init(UserDefinedRoleMaker(current_id=0, role=Role.SERVER,
                                server_endpoints=["127.0.0.1:0"]))
    assert f.is_server() and not f.is_worker()
    assert f.server_num() == 1 and f.server_index() == 0
    srv = f.init_server(shards=[EmbeddingShard("tb", 0, v, rows=rows.copy())])
    t = threading.Thread(target=f.run_server, daemon=True)
    t.start()
    from paddle_tpu.parallel.fleet import Fleet as JFleet
    from paddle_tpu.parallel.fleet import Role as JRole
    from paddle_tpu.parallel.fleet import UserDefinedRoleMaker as JRm
    jf = JFleet()
    jf.init(JRm(current_id=0, role=JRole.SERVER,
                server_endpoints=["127.0.0.1:0"]))
    jsrv = jf.init_server(shards=[JShard("tb", 0, v, rows=rows.copy())])
    jt = threading.Thread(target=jf.run_server, daemon=True)
    jt.start()
    try:
        ids = np.array([0, 7, v - 1], dtype=np.int64)
        c = SocketClient(srv.endpoint)
        assert c.ping()
        got = c.pull("tb", ids)
        c.close()
        jc = JClient(jsrv.endpoint)
        want = jc.pull("tb", ids)
        jc.close()
        np.testing.assert_array_equal(got, rows[ids])
        np.testing.assert_array_equal(got, want)
    finally:
        f.stop_server()
        jf.stop_server()
        t.join(timeout=5.0)
        jt.join(timeout=5.0)
    with pytest.raises(RuntimeError, match="init_server"):
        f.run_server()


# -- the cross-trainer shuffle ---------------------------------------------------

def _buckets(pkg, records, rank, nranks, monkeypatch):
    """The records `pkg`'s global_shuffle routes to each trainer from rank
    `rank` (its exchange captured, no network)."""
    seen = {}

    def capture(buckets, r, n, timeout=120.0):
        seen["b"] = [list(b) for b in buckets]
        return list(buckets[r])

    if pkg == "jax":
        import jax

        from paddle_tpu.dataset import factory, shuffle_service
        monkeypatch.setattr(jax, "process_count", lambda: nranks)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
    else:
        import torch.distributed as dist

        from paddle_tpu_torch.dataset import factory, shuffle_service
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda *a: nranks)
        monkeypatch.setattr(dist, "get_rank", lambda *a: rank)
    monkeypatch.setattr(shuffle_service, "exchange_records", capture)
    ds = factory.InMemoryDataset()
    ds._memory = list(records)
    ds.global_shuffle()
    monkeypatch.undo()
    return seen["b"]


def test_global_shuffle_routes_disjointly(monkeypatch):
    """The routing behind the cross-trainer exchange, in both packages:
    each trainer's buckets hold the same records in both, and over the
    trainers the buckets of the global record set are disjoint, complete
    and roughly balanced."""
    n, nranks = 120, 4
    records = [([float(i)], [i]) for i in range(n)]
    per = n // nranks
    dest = [[] for _ in range(nranks)]
    for r in range(nranks):
        mine = records[r * per:(r + 1) * per]
        jb = _buckets("jax", mine, r, nranks, monkeypatch)
        tb = _buckets("torch", mine, r, nranks, monkeypatch)
        assert tb == jb
        for d in range(nranks):
            dest[d] += [int(rec[1][0]) for rec in tb[d]]
    allv = [v for b in dest for v in b]
    assert sorted(allv) == list(range(n))        # disjoint + complete
    sizes = [len(b) for b in dest]
    assert max(sizes) - min(sizes) < n // 2      # no degenerate bucket


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, args):
    """Two port trainers of torch_dist_mlp_runner through the port's
    launcher; each rank's last JSON line."""
    from paddle_tpu_torch.distributed import launch

    env_backup = dict(os.environ)
    for k in list(os.environ):
        if k.startswith(("PADDLE_", "XLA_", "JAX_")):
            del os.environ[k]
    try:
        procs, fds = launch.start_procs(
            2, os.path.join(HERE, "torch_dist_mlp_runner.py"), args,
            started_port=_free_port(), log_dir=str(tmp_path))
        rc = launch.wait_procs(procs, fds)
    finally:
        os.environ.clear()
        os.environ.update(env_backup)
    out = {}
    for rank in range(2):
        text = (tmp_path / f"workerlog.{rank}").read_text()
        assert rc == 0, f"rank{rank} log:\n{text[-2000:]}"
        line = [ln for ln in text.splitlines() if ln.startswith("{")][-1]
        out[rank] = json.loads(line)
    return out


def test_global_shuffle_crosses_trainers(tmp_path, monkeypatch):
    """Two port trainers: disjoint per-rank records are hash-routed
    between them (union preserved, no duplicates, both directions moved),
    and each trainer ends with the records the JAX package's routing
    sends it."""
    got = _launch(tmp_path, ["--shuffle"])
    want = [set(), set()]
    for r in range(2):
        recs = [(f"rec-{i}", i) for i in range(r * 40, r * 40 + 40)]
        for d, b in enumerate(_buckets("jax", recs, r, 2, monkeypatch)):
            want[d] |= {i for _, i in b}
    assert sorted(got[0]["ids"] + got[1]["ids"]) == list(range(80))
    assert any(i >= 40 for i in got[0]["ids"])
    assert any(i < 40 for i in got[1]["ids"])
    for r in range(2):
        assert set(got[r]["ids"]) == want[r]


def test_two_process_cluster_loss_equality(tmp_path):
    """The JAX test's two-trainer cluster in the port: ``distributed.launch``
    sets the env, ``fleet.init(PaddleCloudRoleMaker(device="cpu"))`` joins
    a gloo group, ``fleet.distributed_optimizer(...).minimize`` builds
    ``fleet.main_program``; with the batch duplicated on the two ranks the
    global loss equals the one-process run."""
    got = _launch(tmp_path, [])
    assert got[0]["rank"] == 0 and got[1]["rank"] == 1
    assert got[0]["losses"] == got[1]["losses"]
    with jnames.guard():
        jlocal = M.local_losses(jfluid)
    tlocal = M.local_losses(tfluid)
    np.testing.assert_allclose(got[0]["losses"], jlocal, rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got[0]["losses"], tlocal, rtol=1e-6)
    assert got[0]["losses"][-1] < got[0]["losses"][0]


# -- the deferred fold on a mesh -------------------------------------------------

def _jax_deferred():
    with jnames.guard():
        main, startup, loss = C.build_deferred(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    out = []
    with jfluid.scope_guard(scope):
        exe.run(startup)
        import jax.numpy as jnp
        scope.set_var("tb", jnp.asarray(C.deferred_table(
            np.asarray(scope.find_var("tb")))))
        for f in C.deferred_feeds():
            out.append(float(np.asarray(exe.run(main, feed=f,
                                                fetch_list=[loss])[0])))
        cnt = int(np.asarray(scope.find_var("tb@log_count")).ravel()[0])
    assert cnt == 0
    return np.array(out)


@pytest.mark.parametrize("how", ["run", "batched", "scanned"])
def test_deferred_fold_fires_under_compiled_program(world, how):
    """Maintenance epilogues fire on the CompiledProgram path on a mesh:
    each epilogue runs through the same mesh on every rank, the deferred
    ops see the global rows (gathered whole in rank order), so every rank
    holds the same log and table, and the losses match the JAX package's
    plain run across fold boundaries."""
    got = world().run("deferred", dict(feeds=C.deferred_feeds(), how=how))
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
        np.testing.assert_array_equal(r["table"], got[0]["table"])
    assert all(r["count"] == 0 for r in got), "fold never fired"
    assert np.isfinite(got[0]["losses"]).all()
    np.testing.assert_allclose(got[0]["losses"], _jax_deferred(), rtol=1e-5,
                               atol=1e-7)


# -- remat saveable_names --------------------------------------------------------

def _saveable_run(names, policy):
    """tests/test_torch_remat.py's unit MLP: one Adam step's loss and
    gradients, and how many times each aten op ran (forward, backward and
    recompute)."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    import test_torch_remat as TR

    with tnames.guard():  # the same names in every run
        main, startup, feed, loss = TR._unit_mlp()
    grads = [v.name + "@GRAD" for v in main.list_vars()
             if getattr(v, "trainable", False)]
    counts = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[str(func.overloadpacket).split(".")[-1]] += 1
            return func(*args, **(kwargs or {}))

    exe = tfluid.Executor(tfluid.CPUPlace())
    bs = tfluid.BuildStrategy()
    bs.remat_policy = policy
    bs.remat_saveable_names = names
    prog = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        with Count():
            out = exe.run(prog, feed=feed, fetch_list=[loss] + grads)
    return [np.asarray(o).tobytes() for o in out], counts, main


def test_remat_saveable_names_keeps_the_named_values():
    """The units' pre-activations named (each unit is mul, elementwise_add,
    tanh): the gradients are bitwise those of no remat; a "full" unit
    recomputes its matmul, its add and its tanh in the backward, the named
    run its matmul and tanh only — the add's results are kept."""
    units = lambda unit: "full"  # noqa: E731  (checkpoint the units only)
    none_out, none_counts, main = _saveable_run(None, "none")
    full_out, full_counts, _ = _saveable_run(None, units)
    adds = [op.output_names()[0] for op in main.global_block().ops
            if op.type == "elementwise_add"
            and op.attrs.get("__remat_unit__")]
    assert len(adds) == 3
    named_out, named_counts, _ = _saveable_run(adds, units)
    assert full_out == none_out
    assert named_out == none_out

    def extra(counts):
        return {k: counts[k] - none_counts[k] for k in ("mm", "add", "tanh")}

    assert extra(full_counts) == {"mm": 3, "add": 3, "tanh": 3}, \
        extra(full_counts)
    assert extra(named_counts) == {"mm": 3, "add": 0, "tanh": 3}, \
        extra(named_counts)
