"""The port's sharded parameter-server tier (``paddle_tpu_torch.ps``)
against the JAX package's: twins of ``tests/test_ps_embedding.py`` (all
but its role-maker and fleet-server tests, which wait for the port's fleet
role makers).

Same numpy inputs through both packages. The range spec, shards, the
socket transport and the checkpoint files are compared exactly (the
frames and files are the same bytes: a port client reads a JAX server, a
JAX client reads a port server, and either package restores the other's
PS checkpoint). Training: the port's tier is bitwise equal to the port's
single-table packed run (the JAX test's claim, "bitwise"), and the final
tables of the two packages agree as ``tests/test_torch_sparse_adagrad.py``
holds the Adagrad update (``_torch_ps_twin.assert_tables_close``: the
accumulator within 2 ulp, the parameter within 2 units)."""
import json
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.ps as jps
from _torch_ps_twin import (CAP, LANES, SPECS, V, assert_tables_close,
                            build_program, feeds, in_process_table,
                            init_packed, packed_baseline, ps_run, rand_rows,
                            tiny_program)
from _torch_twin import alarm_timeout
from paddle_tpu.parallel import Checkpointer as JCheckpointer
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.parallel import Checkpointer
import paddle_tpu_torch.ps as tps
from paddle_tpu_torch.ps import (PsEmbeddingTier, PsTableBinding, RangeSpec,
                                 ShardServer, ShardedTable, SocketClient,
                                 make_shards)

import test_ps_embedding as tpe

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _time_limit():
    yield from alarm_timeout(120)


# ------------------------------------------------------------ range spec

def test_range_spec_even_and_boundaries():
    spec, jspec = RangeSpec.even(10, 3), jps.RangeSpec.even(10, 3)
    assert spec.num_shards == 3
    assert [spec.bounds(i) for i in range(3)] == [(0, 4), (4, 7), (7, 10)]
    assert spec.to_dict() == jspec.to_dict()
    ids = np.array([0, 3, 4, 6, 7, 9])
    assert spec.shard_of(ids).tolist() == jspec.shard_of(ids).tolist() == \
        [0, 0, 1, 1, 2, 2]
    cuts = np.array([0, 3, 4, 8, 9])
    assert spec.cuts_into(cuts).tolist() == jspec.cuts_into(cuts).tolist() \
        == [0, 2, 3, 5]
    assert RangeSpec.from_dict(jspec.to_dict()) == spec


def test_range_spec_uneven_and_validation():
    spec = RangeSpec(V, [0, 17, 40, V])
    assert spec.num_shards == 3 and spec.bounds(1) == (17, 40)
    ids = np.array([16, 17, 39, 40])
    assert spec.shard_of(ids).tolist() == \
        jps.RangeSpec(V, [0, 17, 40, V]).shard_of(ids).tolist()
    for bad in ([0, 40, 17, V], [1, 17, V], [0, 17, V + 1]):
        with pytest.raises(ValueError):
            RangeSpec(V, bad)
        with pytest.raises(ValueError):
            jps.RangeSpec(V, bad)


# ------------------------------------------------------- shard + transport

def test_shard_pull_push_roundtrip():
    rows = rand_rows(V)
    new = rand_rows(3, seed=9)
    ids = np.array([17, 20, 39], dtype=np.int64)  # global ids, incl. lo
    out = []
    for mod in (jps, tps):
        sh = mod.EmbeddingShard("tb", 17, 40, rows=rows[17:40].copy())
        np.testing.assert_array_equal(sh.pull(ids), rows[ids])
        sh.push(ids, new)
        np.testing.assert_array_equal(sh.pull(ids), new)
        out.append(sh.dump())
    assert out[1].shape == (23, LANES)
    np.testing.assert_array_equal(out[0], out[1])


def test_socket_transport_roundtrip():
    rows = rand_rows(V)
    spec = RangeSpec.even(V, 2)
    shards = make_shards("tb", spec, full_rows=rows)
    servers = [ShardServer([s]).serve_in_thread() for s in shards]
    try:
        clients = [SocketClient(s.endpoint) for s in servers]
        assert all(c.ping() for c in clients)
        meta = clients[0].meta()
        assert meta["tb"]["lo"] == 0 and meta["tb"]["lanes"] == LANES
        table = ShardedTable("tb", spec, clients)
        ids = np.array([0, 24, 25, 49], dtype=np.int64)  # spans the cut
        np.testing.assert_array_equal(table.pull(ids), rows[ids])
        new = rand_rows(4, seed=3)
        table.push(ids, new)
        np.testing.assert_array_equal(table.pull(ids), new)
        assert table.dump_full().shape == (V, LANES)
        table.load_full(rows)
        np.testing.assert_array_equal(table.dump_full(), rows)
        # restore-then-train: rows arrive server-side as read-only
        # np.frombuffer views; a push after load must not hit a
        # read-only destination
        new2 = rand_rows(4, seed=5)
        table.push(ids, new2)
        np.testing.assert_array_equal(table.pull(ids), new2)
        # server-side errors come back as exceptions, connection survives
        with pytest.raises(RuntimeError):
            clients[0].pull("nope", np.array([0], dtype=np.int64))
        assert clients[0].ping()
    finally:
        for s in servers:
            s.stop()


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("jax", "port"), ("port", "jax")])
def test_socket_transport_interoperates_across_packages(server_pkg,
                                                        client_pkg):
    """A port client against a JAX ShardServer and a JAX client against a
    port ShardServer: the frames are the same bytes, so pull, push, dump,
    load, meta, stats and metrics all agree with the in-process rows."""
    smod = jps if server_pkg == "jax" else tps
    cmod = jps if client_pkg == "jax" else tps
    rows = rand_rows(V, seed=41)
    spec = RangeSpec.even(V, 2)
    servers = [smod.ShardServer([smod.EmbeddingShard(
        "tb", lo, hi, rows=rows[lo:hi].copy())]).serve_in_thread()
        for lo, hi in (spec.bounds(0), spec.bounds(1))]
    try:
        clients = [cmod.SocketClient(s.endpoint) for s in servers]
        table = cmod.ShardedTable("tb", cmod.RangeSpec.even(V, 2), clients)
        ids = np.array([1, 24, 25, 48], dtype=np.int64)
        np.testing.assert_array_equal(table.pull(ids), rows[ids])
        new = rand_rows(4, seed=42)
        table.push(ids, new)
        want = rows.copy()
        want[ids] = new
        np.testing.assert_array_equal(table.dump_full(), want)
        table.load_full(rows)
        np.testing.assert_array_equal(table.dump_full(), rows)
        assert clients[1].meta() == {"tb": {"lo": 25, "hi": V,
                                            "lanes": LANES}}
        assert clients[0].stats()["tb"]["rows"] == 25
        assert isinstance(clients[0].metrics(), list)
        assert cmod.probe(servers[0].endpoint)
        for c in clients:
            c.close()
    finally:
        for s in servers:
            s.stop()


def test_transport_wire_format_roundtrip_and_hostile_frames():
    """The socket protocol is JSON + raw blobs, not pickle: decoding
    untrusted bytes can yield dicts/lists/scalars/ndarrays or a protocol
    error — never code execution. The port encodes the JAX package's
    bytes."""
    from paddle_tpu.ps.transport import _pack_msg as jpack
    from paddle_tpu_torch.ps.transport import _pack_msg, _unpack_msg

    msg = {"op": "push", "name": "tb",
           "ids": np.array([1, 2], dtype=np.int64),
           "rows": np.zeros((2, 8), np.uint16),
           "meta": {"n": 3, "ok": True, "f": 1.5, "none": None,
                    "l": [1, "x"]}}
    assert _pack_msg(msg) == jpack(msg)
    rt = _unpack_msg(_pack_msg(msg))
    np.testing.assert_array_equal(rt["ids"], msg["ids"])
    np.testing.assert_array_equal(rt["rows"], msg["rows"])
    assert rt["meta"] == msg["meta"]
    empty = _unpack_msg(_pack_msg(
        {"ids": np.zeros((0,), np.int64)}))["ids"]
    assert empty.shape == (0,) and empty.dtype == np.int64
    bad_heads = [
        b"\xff\xfe",                                        # not JSON
        json.dumps({"__nd__": ["object", [1], 0, 8]}).encode(),   # O dtype
        json.dumps({"__nd__": ["int64", [100], 0, 800]}).encode(),  # OOB
        json.dumps({"__nd__": ["int64", [-1], 0, 8]}).encode(),   # neg dim
    ]
    for head in bad_heads:
        with pytest.raises(ConnectionError):
            _unpack_msg(struct.pack("<I", len(head)) + head)


def test_sharded_table_reassembly_matches_fancy_index():
    rows = rand_rows(V, seed=4)
    spec = RangeSpec(V, [0, 17, 40, V])
    table = ShardedTable.build_in_process("tb", spec, full_rows=rows)
    ids = np.array([0, 5, 16, 17, 18, 39, 40, 49], dtype=np.int64)
    np.testing.assert_array_equal(table.pull(ids), rows[ids])
    st = table.stats()
    assert [s["rows"] for s in st["shards"]] == [17, 23, 10]
    assert sum(s["bytes_pulled"] for s in st["shards"]) == ids.size * 256
    # unsorted ids would silently reassemble rows in the wrong order
    with pytest.raises(ValueError, match="ascending"):
        table.pull(np.array([40, 5], dtype=np.int64))


# --------------------------------------------- bitwise training exactness

@pytest.fixture(scope="module")
def ref():
    """(feeds, port baseline losses and table, JAX baseline table)."""
    fd = feeds()
    losses, final = packed_baseline(fd)
    _, jfinal = tpe._packed_baseline(fd)
    return fd, losses, final, jfinal


@pytest.mark.parametrize("pull_ahead,push_depth", [(0, 0), (1, 0), (2, 1)])
def test_sharded_training_bitwise_exact(ref, pull_ahead, push_depth):
    """Every shard count × uneven ranges × boundary-id batch: losses and
    the final packed table bit-identical to the port's single-table run,
    and close to the JAX package's (``assert_tables_close``)."""
    fd, ref_losses, ref_final, jfinal = ref
    assert_tables_close(ref_final, jfinal)
    for spec in SPECS:
        losses, final = ps_run(fd, in_process_table(spec), pull_ahead,
                               push_depth)
        assert losses == ref_losses, (spec.to_dict(), pull_ahead, push_depth)
        np.testing.assert_array_equal(final, ref_final)


def test_sharded_training_over_socket_shards_bitwise(ref):
    """The same run over two socket ShardServers (prefetch 2, async push
    depth 1): bitwise equal to the single-table run."""
    fd, ref_losses, ref_final, _ = ref
    spec = RangeSpec.even(V, 2)
    shards = make_shards("tb", spec, full_rows=init_packed())
    servers = [ShardServer([s]).serve_in_thread() for s in shards]
    try:
        table = ShardedTable("tb", spec,
                             [SocketClient(s.endpoint) for s in servers])
        losses, final = ps_run(fd, table, 2, 1)
    finally:
        for s in servers:
            s.stop()
    assert losses == ref_losses
    np.testing.assert_array_equal(final, ref_final)


def test_cache_overflow_raises():
    """A batch touching more uniques than the cache param holds is a
    build-time sizing error, reported as such."""
    main, startup, loss = build_program(CAP)
    table = in_process_table(RangeSpec.even(V, 2))
    tier = PsEmbeddingTier(main, [PsTableBinding("tb", table, ["ids"])],
                           pull_ahead=0, push_depth=0,
                           place=tfluid.CPUPlace())
    try:
        too_many = np.arange(CAP + 1, dtype=np.int64)
        with pytest.raises(ValueError, match="cache"):
            tier._pull_cache(tier.bindings[0], too_many, 0)
    finally:
        tier.close()


def test_push_failure_surfaces_on_flush():
    from paddle_tpu_torch.ps.tier import _Pusher

    class _BadTable:
        name = "tb"

        def push(self, uids, rows):
            raise OSError("shard down")

    p = _Pusher(_BadTable(), depth=1, window=3)
    try:
        p.submit(np.array([1], dtype=np.int64),
                 torch.zeros((1, LANES), dtype=torch.int16))
        with pytest.raises(RuntimeError, match="push to table"):
            p.flush()
        # a dropped batch poisons the pusher permanently: a retried
        # flush or a fresh submit must NOT report success over the
        # missing rows
        with pytest.raises(RuntimeError, match="poisoned"):
            p.flush()
        with pytest.raises(RuntimeError, match="poisoned"):
            p.submit(np.array([2], dtype=np.int64),
                     torch.zeros((1, LANES), dtype=torch.int16))
    finally:
        p.close()


# ------------------------------------------------------------- checkpoints

def test_checkpoint_roundtrip_onto_different_shard_count(tmp_path):
    rows = rand_rows(V, seed=21)
    main, startup = tiny_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    ck = Checkpointer(str(tmp_path / "ck"))
    table4 = ShardedTable.build_in_process("emb", RangeSpec.even(V, 4),
                                           full_rows=rows)
    sc = tfluid.Scope()
    exe.run(startup, scope=sc)
    ck.save(1, program=main, scope=sc, ps_tables={"emb": table4})
    ck.wait()
    # restore onto THREE uneven shards — re-partitioned by the live spec
    table3 = ShardedTable.build_in_process("emb",
                                           RangeSpec(V, [0, 17, 40, V]))
    sc2 = tfluid.Scope()
    exe.run(startup, scope=sc2)
    assert ck.restore(program=main, scope=sc2, ps_tables={"emb": table3},
                      place=tfluid.CPUPlace()) == 1
    np.testing.assert_array_equal(table3.dump_full(), rows)
    np.testing.assert_array_equal(sc2.find_np("w"), sc.find_np("w"))


def test_checkpoint_detects_corrupt_ps_shard(tmp_path):
    rows = rand_rows(V, seed=22)
    main, startup = tiny_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    ck = Checkpointer(str(tmp_path / "ck"))
    table = ShardedTable.build_in_process("emb", RangeSpec.even(V, 2),
                                          full_rows=rows)
    sc = tfluid.Scope()
    exe.run(startup, scope=sc)
    ck.save(1, program=main, scope=sc, ps_tables={"emb": table})
    ck.wait()
    # flip one byte in the largest payload file (the PS shard bytes
    # dominate the tiny fc program) — the SHA-256 manifest must catch it
    files = sorted((p for p in (tmp_path / "ck").rglob("*") if p.is_file()
                    and "manifest" not in p.name),
                   key=lambda p: p.stat().st_size)
    victim = files[-1]
    assert ".shards-" in victim.name
    raw = bytearray(victim.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    victim.write_bytes(bytes(raw))
    fresh = ShardedTable.build_in_process("emb", RangeSpec.even(V, 2))
    with pytest.raises(RuntimeError):
        ck.restore(program=main, scope=sc, ps_tables={"emb": fresh},
                   place=tfluid.CPUPlace())


def test_checkpoint_missing_ps_table_fails_before_mutation(tmp_path):
    main, startup = tiny_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    ck = Checkpointer(str(tmp_path / "ck"))
    sc = tfluid.Scope()
    exe.run(startup, scope=sc)
    ck.save(1, program=main, scope=sc)  # no PS tables in this checkpoint
    ck.wait()
    sentinel = rand_rows(V, seed=23)
    table = ShardedTable.build_in_process("emb", RangeSpec.even(V, 2),
                                          full_rows=sentinel)
    with pytest.raises(RuntimeError):
        ck.restore(program=main, scope=sc, ps_tables={"emb": table},
                   place=tfluid.CPUPlace())
    # the failed restore must not have touched the live shards
    np.testing.assert_array_equal(table.dump_full(), sentinel)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ps_checkpoint_files_cross_packages(tmp_path, writer):
    """A PS checkpoint (full save + a delta) written by one package
    restores bitwise in the other, onto another shard count, and
    ``load_ps_table`` returns the same rows and journal mark."""
    rows = rand_rows(V, seed=24)
    ids = np.array([3, 30, 44], np.int64)
    new = rand_rows(3, seed=25)
    d = str(tmp_path / "ck")
    if writer == "jax":
        jmain = jfluid.Program()
        t = jps.ShardedTable.build_in_process("emb", jps.RangeSpec.even(V, 2),
                                              full_rows=rows)
        ck = JCheckpointer(d)
        with jfluid.scope_guard(jfluid.Scope()):
            ck.save(1, program=jmain, ps_tables={"emb": t}, blocking=True)
    else:
        t = ShardedTable.build_in_process("emb", RangeSpec.even(V, 2),
                                          full_rows=rows)
        ck = Checkpointer(d)
        ck.save(1, program=tfluid.Program(), scope=tfluid.Scope(),
                ps_tables={"emb": t}, blocking=True)
    t.push(ids, new)
    ck.save_delta(2, {"emb": t}, blocking=True)
    want = t.dump_full()
    if writer == "jax":
        reader = Checkpointer(d)
        dst = ShardedTable.build_in_process("emb", RangeSpec(V, [0, 7, V]))
        assert reader.restore(program=tfluid.Program(), scope=tfluid.Scope(),
                              ps_tables={"emb": dst},
                              place=tfluid.CPUPlace()) == 1
    else:
        reader = JCheckpointer(d)
        dst = jps.ShardedTable.build_in_process("emb",
                                                jps.RangeSpec(V, [0, 7, V]))
        with jfluid.scope_guard(jfluid.Scope()):
            assert reader.restore(program=jfluid.Program(),
                                  ps_tables={"emb": dst}) == 1
    np.testing.assert_array_equal(dst.dump_full(), want)
    full, mark, step = reader.load_ps_table("emb")
    assert (mark, step) == (t.journal_mark(), 1)
    np.testing.assert_array_equal(full, want)
