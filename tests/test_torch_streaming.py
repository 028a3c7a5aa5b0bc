"""Streaming online learning in the port (``paddle_tpu_torch.streaming``,
``ps.dynamic`` and the PS half of ``parallel.checkpoint``): twins of
``tests/test_streaming.py``.

The same numpy inputs go through both packages where the result is
deterministic: dynamic shards (init-on-pull, growth, eviction, dump/load)
give the same bytes and counts, delta checkpoints restore bitwise across
the packages in both directions (full save + a delta chain), the
streaming dataset and data generator give the same batches and text, and
the delta publisher ships the same coalesced rows. The online smoke trains
the port on the CPU and checks what the JAX test checks (AUC through the
serving predictor improves, serving rows bitwise-fresh after ``finish``).
The SIGKILL cell launches the port's pserver runner. The soak keeps the
JAX file's ``slow`` mark."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.ps as jps
import paddle_tpu.streaming as jstreaming
from _torch_ps_twin import (B, CAP, D, F, LANES, MULT, V, fast_retry, feeds,
                            launch_pserver, packed_baseline, ps_run,
                            rand_rows, stop_all, tiny_program, init_packed)
from _torch_twin import alarm_timeout, fresh_observability
from paddle_tpu.parallel.checkpoint import Checkpointer as JCheckpointer
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.ps as tps
from paddle_tpu_torch.observability.registry import get_registry
from paddle_tpu_torch.parallel.checkpoint import Checkpointer
from paddle_tpu_torch.ps import (DynamicEmbeddingShard, EmbeddingShard,
                                 InProcessClient, PsEmbeddingTier,
                                 PsTableBinding, RangeSpec, ShardServer,
                                 ShardedTable, SocketClient,
                                 make_dynamic_shards)
from paddle_tpu_torch.streaming import (DeltaPublisher, OnlineTrainer,
                                        StreamingDataset, auc)
from paddle_tpu_torch.streaming.dataset import parse_multislot_line
from paddle_tpu_torch.streaming.trainer import eval_auc

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_observability():
    yield from fresh_observability()


@pytest.fixture(autouse=True)
def _time_limit():
    yield from alarm_timeout(240)


# ===================================================== dynamic vocab shards

def test_dynamic_init_on_pull_is_deterministic():
    """A never-seen id pulls the deterministic init row and materializes
    exactly once; a repeat pull re-reads the same slot. The JAX shard
    gives the same rows and counts."""
    for mod in (jps, tps):
        sh = mod.DynamicEmbeddingShard("tb", 0, 1000, capacity=4)
        ids = np.array([7, 500], np.int64)
        np.testing.assert_array_equal(sh.pull(ids),
                                      np.zeros((2, LANES), np.uint16))
        st = sh.stats()
        assert st["dynamic"] and st["live_rows"] == 2
        assert st["materialized"] == 2
        sh.pull(ids)
        assert sh.stats()["materialized"] == 2  # no re-materialization

    def init_fn(gids):
        out = np.zeros((gids.shape[0], LANES), np.uint16)
        out[:, 0] = gids % 65536
        return out

    sh2 = DynamicEmbeddingShard("tb", 100, 1000, capacity=4,
                                init_row_fn=init_fn)
    got = sh2.pull(np.array([100, 777], np.int64))
    assert got[0, 0] == 100 and got[1, 0] == 777
    assert not got[:, 1:].any()


def test_evicted_id_reinitializes_never_stale_bytes():
    init = np.full((1, LANES), 7, np.uint16)
    sh = DynamicEmbeddingShard(
        "tb", 0, 100, capacity=2,
        init_row_fn=lambda g: np.full((g.shape[0], LANES), 7, np.uint16))
    np.testing.assert_array_equal(sh.pull(np.array([5], np.int64)), init)
    sh.push(np.array([5], np.int64), rand_rows(1, seed=49))
    sh.pull(np.array([6], np.int64))
    sh.pull(np.array([7], np.int64))   # slab full: evicts coldest (5)
    assert sh.stats()["evicted"] >= 1
    np.testing.assert_array_equal(sh.pull(np.array([5], np.int64)), init)


def test_vocab_grows_past_provisioned_within_bounded_slab():
    """1000 distinct ids stream through a 32-row slab: the table keeps
    growing while memory stays fixed — the same counts as the JAX
    shard's."""
    stats = []
    for mod in (jps, tps):
        sh = mod.DynamicEmbeddingShard("tb", 0, 10_000, capacity=32)
        for k in range(0, 1000, 8):
            sh.pull(np.arange(k, k + 8, dtype=np.int64))
        st = sh.stats()
        stats.append({k: st[k] for k in ("materialized", "live_rows",
                                         "slab_bytes", "evicted")})
    assert stats[0] == stats[1]
    st = stats[1]
    assert st["materialized"] == 1000 and st["live_rows"] <= 32
    assert st["slab_bytes"] == 32 * LANES * 2
    assert st["evicted"] >= 1000 - 32
    text = get_registry().prometheus_text()
    assert "ps_materialized_rows" in text and "ps_evicted_rows" in text
    assert "ps_vocab_rows" in text and "ps_vocab_capacity" in text


def test_ttl_sweep_evicts_cold_rows_over_socket_table():
    sh = DynamicEmbeddingShard("tb", 0, 200, capacity=8, ttl_s=0.05)
    srv = ShardServer([sh]).serve_in_thread()
    try:
        c = SocketClient(srv.endpoint)
        table = ShardedTable("tb", RangeSpec(200, [0, 200]), [c])
        ids = np.arange(4, dtype=np.int64)
        np.testing.assert_array_equal(table.pull(ids),
                                      np.zeros((4, LANES), np.uint16))
        rows = rand_rows(4, seed=47)
        table.push(ids, rows)
        np.testing.assert_array_equal(table.pull(ids), rows)
        time.sleep(0.1)
        assert table.sweep() == 4
        np.testing.assert_array_equal(table.pull(ids),
                                      np.zeros((4, LANES), np.uint16))
        st = c.stats()["tb"]
        assert st["dynamic"] and st["evicted"] >= 4
        table.close()
    finally:
        srv.stop()


def test_static_table_sweep_is_noop():
    table = ShardedTable.build_in_process(
        "tb", RangeSpec.even(V, 2), full_rows=rand_rows(V))
    assert table.sweep() == 0


def test_watermark_sweep_gives_frequent_ids_a_second_chance():
    out = []
    for mod in (jps, tps):
        sh = mod.DynamicEmbeddingShard("tb", 0, 1000, capacity=10,
                                       high_watermark=0.5,
                                       low_watermark=0.2, keep_freq=4)
        for _ in range(6):
            sh.pull(np.array([1], np.int64))   # sketch: uid 1 is frequent
        sh.pull(np.arange(2, 8, dtype=np.int64))
        evicted = sh.sweep()
        assert evicted > 0
        assert sh._slots.get(1) is not None    # spared by frequency
        assert sh.stats()["live_rows"] <= 2    # low watermark reached
        out.append((evicted, sh.dump()[:10].tobytes()))
    assert out[0] == out[1]


def test_materialize_at_capacity_never_evicts_an_id_of_the_same_call():
    """A full slab, a call with a resident id that is the coldest and an
    absent one: the absent id's materialization evicts another row, never
    the resident id the call is reading (its slot would be handed over
    while it is read, and the LRU would keep a ghost that a later sweep
    trips on). The JAX package's shard materializes before it touches and
    so evicts the cold resident id of the same call; the port touches
    first (ROADMAP C)."""
    rows = rand_rows(3, seed=71)
    sh = DynamicEmbeddingShard("tb", 0, 100, capacity=3,
                               high_watermark=0.5, low_watermark=0.3,
                               keep_freq=0)
    sh.push(np.array([0, 1, 2], np.int64), rows)   # 0 is the coldest
    got = sh.pull(np.array([0, 5, 5], np.int64))
    np.testing.assert_array_equal(got[0], rows[0])
    np.testing.assert_array_equal(got[1], got[2])  # one materialization
    res = sorted(sh._slots.residents()[0].tolist())
    assert res == [0, 2, 5] and sorted(sh._lru._od) == res
    assert sh.stats()["materialized"] == 4
    assert sh.sweep() == 3          # down to the low mark: int(0.3 * 3) = 0
    with pytest.raises(RuntimeError, match="distinct ids"):
        sh.pull(np.arange(10, 14, dtype=np.int64))


def test_pins_block_eviction_until_unpinned():
    sh = DynamicEmbeddingShard("tb", 0, 100, capacity=4, ttl_s=0.0)
    ids = np.arange(4, dtype=np.int64)
    rows = rand_rows(4, seed=48)
    sh.push(ids, rows)
    sh.pin(np.array([0, 1], np.int64))
    assert sh.sweep() == 2                  # ttl 0: all expired, pins spare 2
    np.testing.assert_array_equal(sh.pull(np.array([0, 1], np.int64)),
                                  rows[:2])
    sh.unpin(np.array([0, 1], np.int64))
    assert sh.sweep() == 2

    sh2 = DynamicEmbeddingShard("tb", 0, 100, capacity=2)
    sh2.pull(np.array([0, 1], np.int64))
    sh2.pin(np.array([0, 1], np.int64))
    with pytest.raises(RuntimeError, match="pinned"):
        sh2.pull(np.array([2], np.int64))
    sh2.unpin(np.array([0], np.int64))
    sh2.pull(np.array([2], np.int64))       # admits by evicting unpinned 0
    assert sh2.stats()["live_rows"] == 2


def test_sweep_excludes_inflight_push_via_mutation_lock():
    sh = DynamicEmbeddingShard("tb", 0, 100, capacity=8, ttl_s=0.0)
    sh.push(np.arange(4, dtype=np.int64), rand_rows(4))
    done = threading.Event()
    out = {}

    def _sweep():
        out["evicted"] = sh.sweep()
        done.set()

    sh._lock.acquire()
    try:
        t = threading.Thread(target=_sweep, daemon=True)
        t.start()
        assert not done.wait(0.15)          # blocked behind the push lock
    finally:
        sh._lock.release()
    assert done.wait(5.0)
    assert out["evicted"] == 4


def test_dynamic_dump_load_bitwise_and_size_guard(monkeypatch):
    sh = DynamicEmbeddingShard("tb", 0, V, capacity=8)
    ids = np.array([3, 17, 44], np.int64)
    rows = rand_rows(3, seed=50)
    sh.push(ids, rows)
    dense = sh.dump()
    assert dense.shape == (V, LANES)
    np.testing.assert_array_equal(dense[ids], rows)

    # a dump either package wrote loads in the other
    jsh = jps.DynamicEmbeddingShard("tb", 0, V, capacity=8)
    jsh.load(dense)
    np.testing.assert_array_equal(jsh.dump(), dense)
    sh2 = DynamicEmbeddingShard("tb", 0, V, capacity=8)
    sh2.load(jsh.dump())
    np.testing.assert_array_equal(sh2.dump(), dense)
    assert sh2.stats()["live_rows"] == 3    # init-equal rows stay virtual

    sh3 = DynamicEmbeddingShard("tb", 0, V, capacity=2)
    with pytest.raises(ValueError, match="capacity"):
        sh3.load(dense)                     # 3 trained rows > 2 slots

    monkeypatch.setenv("PDTPU_PS_DYNAMIC_DUMP_MAX_MB", "0")
    with pytest.raises(RuntimeError, match="save_delta"):
        sh.dump()


def test_make_dynamic_shards_table_sweep_fans_out():
    spec = RangeSpec.even(200, 2)
    shards = make_dynamic_shards("tb", spec, capacity_per_shard=8,
                                 ttl_s=0.01)
    table = ShardedTable("tb", spec, [InProcessClient([s]) for s in shards])
    ids = np.array([0, 50, 120, 199], np.int64)   # both ranges
    table.push(ids, rand_rows(4, seed=51))
    time.sleep(0.05)
    assert table.sweep() == 4               # fan-out sums both shards


# ============================================ incremental (delta) checkpoints

def test_save_delta_validation(tmp_path):
    ck = Checkpointer(str(tmp_path))
    table = ShardedTable.build_in_process("tb", RangeSpec.even(V, 2),
                                          full_rows=rand_rows(V))
    with pytest.raises(ValueError, match="ps_tables"):
        ck.save_delta(1, {})
    with pytest.raises(RuntimeError, match="full checkpoint"):
        ck.save_delta(1, {"tb": table})


def _started_scope():
    main, startup = tiny_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    sc = tfluid.Scope()
    exe.run(startup, scope=sc)
    return main, sc


def test_delta_chain_restore_is_bitwise_and_truncates_journal(tmp_path):
    """full@1 → delta@2 → delta@3: each delta persists only the rows
    pushed since the chain head and truncates the client journal;
    restore and load_ps_table both see full ∘ delta2 ∘ delta3, bitwise,
    discarding the uncommitted tail."""
    main, sc = _started_scope()
    rows0 = rand_rows(V, seed=31)
    table = ShardedTable.build_in_process("tb", RangeSpec.even(V, 2),
                                          full_rows=rows0)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, program=main, scope=sc, blocking=True,
            ps_tables={"tb": table})
    table.push(np.array([0, 7, 25, 49], np.int64), rand_rows(4, seed=32))
    ck.save_delta(2, {"tb": table}, blocking=True)
    assert table.stats()["journal"]["entries"] == 0  # truncated at commit
    state2 = table.dump_full()
    table.push(np.array([3, 25, 30], np.int64), rand_rows(3, seed=33))
    ck.save_delta(3, {"tb": table}, blocking=True)
    assert table.stats()["journal"]["entries"] == 0
    state3 = table.dump_full()
    assert not np.array_equal(state2, state3)
    table.push(np.array([1], np.int64), rand_rows(1, seed=34))

    assert ck.delta_steps(1) == [2, 3]
    assert ck.verify_delta(1, 2) == [] and ck.verify_delta(1, 3) == []
    dsize = os.path.getsize(ck._delta_path(1, 3))
    assert dsize < rows0.nbytes / 4

    assert ck.restore(program=main, scope=sc, ps_tables={"tb": table},
                      place=tfluid.CPUPlace()) == 1
    np.testing.assert_array_equal(table.dump_full(), state3)
    assert table.stats()["journal"]["entries"] == 0

    full, mark, st = ck.load_ps_table("tb")
    assert st == 1
    np.testing.assert_array_equal(full, state3)

    table.push(np.array([11, 40], np.int64), rand_rows(2, seed=35))
    assert table.journal_mark() > mark
    ck.save_delta(4, {"tb": table}, blocking=True)
    state4 = table.dump_full()
    full2, _, _ = ck.load_ps_table("tb")
    np.testing.assert_array_equal(full2, state4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_delta_chain_restores_bitwise_across_packages(tmp_path, writer):
    """A PS checkpoint written by one package's Checkpointer — a full
    save and a chain of two deltas — restores in the other bitwise, onto
    another shard count; the reader's ``load_ps_table`` composes the same
    chain."""
    rows0 = rand_rows(V, seed=61)
    pushes = [(np.array([0, 7, 25, 49], np.int64), rand_rows(4, seed=62)),
              (np.array([3, 25, 30], np.int64), rand_rows(3, seed=63))]
    d = str(tmp_path / "ck")
    if writer == "jax":
        t = jps.ShardedTable.build_in_process("tb", jps.RangeSpec.even(V, 2),
                                              full_rows=rows0)
        ck = JCheckpointer(d)
        with jfluid.scope_guard(jfluid.Scope()):
            ck.save(1, program=jfluid.Program(), ps_tables={"tb": t},
                    blocking=True)
    else:
        t = ShardedTable.build_in_process("tb", RangeSpec.even(V, 2),
                                          full_rows=rows0)
        ck = Checkpointer(d)
        ck.save(1, program=tfluid.Program(), scope=tfluid.Scope(),
                ps_tables={"tb": t}, blocking=True)
    for k, (ids, rows) in enumerate(pushes):
        t.push(ids, rows)
        ck.save_delta(2 + k, {"tb": t}, blocking=True)
    want = t.dump_full()
    if writer == "jax":
        reader = Checkpointer(d)
        dst = ShardedTable.build_in_process("tb", RangeSpec(V, [0, 17, V]))
        assert reader.restore(program=tfluid.Program(), scope=tfluid.Scope(),
                              ps_tables={"tb": dst},
                              place=tfluid.CPUPlace()) == 1
    else:
        reader = JCheckpointer(d)
        dst = jps.ShardedTable.build_in_process("tb",
                                                jps.RangeSpec(V, [0, 17, V]))
        with jfluid.scope_guard(jfluid.Scope()):
            assert reader.restore(program=jfluid.Program(),
                                  ps_tables={"tb": dst}) == 1
    assert reader.delta_steps(1) == [2, 3]
    np.testing.assert_array_equal(dst.dump_full(), want)
    full, mark, step = reader.load_ps_table("tb")
    assert step == 1 and mark == t.journal_mark()
    np.testing.assert_array_equal(full, want)


def test_delta_chain_stops_at_corruption(tmp_path):
    main, sc = _started_scope()
    table = ShardedTable.build_in_process("tb", RangeSpec.even(V, 2),
                                          full_rows=rand_rows(V, seed=36))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, program=main, scope=sc, blocking=True,
            ps_tables={"tb": table})
    table.push(np.array([2, 9], np.int64), rand_rows(2, seed=37))
    ck.save_delta(2, {"tb": table}, blocking=True)
    state2 = table.dump_full()
    table.push(np.array([30], np.int64), rand_rows(1, seed=38))
    ck.save_delta(3, {"tb": table}, blocking=True)

    victim = ck._delta_path(1, 3)
    raw = bytearray(open(victim, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    assert ck.verify_delta(1, 3) != []

    with pytest.warns(RuntimeWarning, match="delta checkpoint 1->3"):
        assert ck.restore(program=main, scope=sc, ps_tables={"tb": table},
                          place=tfluid.CPUPlace()) == 1
    np.testing.assert_array_equal(table.dump_full(), state2)


def test_gc_reaps_delta_files_with_their_base(tmp_path):
    main, sc = _started_scope()
    table = ShardedTable.build_in_process("tb", RangeSpec.even(V, 2),
                                          full_rows=rand_rows(V, seed=39))
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, program=main, scope=sc, blocking=True,
            ps_tables={"tb": table})
    table.push(np.array([4], np.int64), rand_rows(1, seed=40))
    ck.save_delta(2, {"tb": table}, blocking=True)
    old_delta = ck._delta_path(1, 2)
    assert os.path.exists(old_delta)
    ck.save(5, program=main, scope=sc, blocking=True,
            ps_tables={"tb": table})   # keep=1: step-1 bundle GC'd
    assert not os.path.exists(old_delta)


def test_sigkill_pserver_delta_recovery_bitwise(tmp_path, monkeypatch):
    """Kill a runner pserver AFTER a save_delta truncated the journal.
    Recovery must compose the delta into the base (the truncated entries
    exist nowhere else) and replay only the tail — losses and final bytes
    bitwise vs the uninterrupted run."""
    fast_retry(monkeypatch)
    fd = feeds()
    ref_losses, ref_final = packed_baseline(fd)
    spec = RangeSpec.even(V, 2)
    procs, eps = [], []
    for i in range(2):
        lo, hi = spec.bounds(i)
        p, ep = launch_pserver([f"tb:{lo}:{hi}"])
        procs.append(p)
        eps.append(ep)
    table = ShardedTable("tb", spec, [SocketClient(ep) for ep in eps])
    ck = Checkpointer(str(tmp_path / "ck"))
    threads = []

    def on_step(step):
        if step == 3:
            ck.save_delta(1, {"tb": table}, blocking=True)
            assert table.stats()["journal"]["entries"] == 0
        if step == 5:
            procs[1].kill()
            procs[1].wait(timeout=30)
            lo1, hi1 = spec.bounds(1)
            port1 = int(eps[1].rsplit(":", 1)[1])

            def _restart():
                time.sleep(0.3)
                procs.append(launch_pserver([f"tb:{lo1}:{hi1}"],
                                            port=port1)[0])

            t = threading.Thread(target=_restart, daemon=True)
            t.start()
            threads.append(t)

    try:
        table.load_full(init_packed())
        losses, final = ps_run(fd, table, 1, 0, on_step=on_step, ck=ck,
                               save_base=True)
    finally:
        for t in threads:
            t.join(timeout=10.0)
        stop_all(procs)
    assert losses == ref_losses
    np.testing.assert_array_equal(final, ref_final)


# ======================================================= streaming ingestion

def test_parse_multislot_line_roundtrip_and_framing_errors():
    line = "3 5 6 7 1 1.5"
    pairs = parse_multislot_line(line, ["ids", "lbl"], "if")
    assert pairs == [("ids", [5, 6, 7]), ("lbl", [1.5])]
    assert pairs == jstreaming.dataset.parse_multislot_line(
        line, ["ids", "lbl"], "if")
    with pytest.raises(ValueError, match="trailing"):
        parse_multislot_line("1 5 99", ["ids"])
    with pytest.raises(ValueError, match="ends before"):
        parse_multislot_line("1 5", ["ids", "lbl"])
    with pytest.raises(ValueError, match="claims"):
        parse_multislot_line("4 1 2 3", ["ids"])


def _dict_source(n):
    def gen():
        for i in range(n):
            yield {"ids": np.array([i % 7, (i + 1) % 7, (i + 2) % 7],
                                   np.int64),
                   "lbl": np.array([float(i % 2)], np.float32)}
    return gen


def _drains(cls):
    """The JAX test's drain sequence: (batches, stats) at each stage."""
    ds = cls(_dict_source(23), batch_size=4, held_out_every=5,
             max_batches=3)
    first = list(ds.batches())
    s1 = (ds.stats()["samples"], ds.eval_size)
    ds.max_batches = None
    more = list(ds.batches())
    ev = list(ds.eval_batches())
    st = ds.stats()
    ds.set_drop_last(False)
    ragged = list(ds.batches())
    return first, s1, more, ev, (st["samples"], st["eval_window"]), ragged


def test_streaming_dataset_batches_heldout_and_bounds():
    first, s1, more, ev, s2, ragged = _drains(StreamingDataset)
    assert len(first) == 3                  # bounded drain
    assert first[0]["ids"].shape == (4, 3)
    assert first[0]["lbl"].shape == (4, 1)
    assert s1 == (14, 2)                    # 12 trained + #5, #10 held
    assert len(more) == 4                   # 23 - 5 held out = 18 -> 4 full
    assert ev and ev[0]["ids"].shape[1] == 3
    assert s2 == (37, 7)
    assert len(ragged) == 5 and ragged[-1]["ids"].shape[0] == 2
    # the JAX package's dataset gives the same batches from the source
    j = _drains(jstreaming.StreamingDataset)
    for got, want in zip((first, more, ev, ragged), (j[0], j[2], j[3], j[5])):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]))
    assert (s1, s2) == (j[1], j[4])


def test_streaming_dataset_text_lines_and_use_var_filter():
    lines = ["3 1 2 3 1 1", "3 4 5 6 1 0"]
    ds = StreamingDataset(lines, slots=["ids", "lbl"], slot_types="if",
                          batch_size=2)
    [b] = list(ds.batches())
    np.testing.assert_array_equal(b["ids"], [[1, 2, 3], [4, 5, 6]])
    np.testing.assert_array_equal(np.asarray(b["lbl"]).ravel(), [1.0, 0.0])

    ids_var = type("V", (), {"name": "ids"})()
    ds2 = StreamingDataset(_dict_source(4), batch_size=2)
    ds2.set_use_var([ids_var])
    [b2, _] = list(ds2.batches())
    assert set(b2) == {"ids"}               # lbl filtered out

    ds3 = StreamingDataset(iter([{"ids": [1, 2, 3]},
                                 {"lbl": [1.0]}]), batch_size=2)
    with pytest.raises(ValueError, match="every sample"):
        list(ds3.batches())

    with pytest.raises(ValueError, match="slots"):
        list(StreamingDataset(["1 5"], batch_size=1).batches())


def test_data_generator_feeds_streaming_dataset():
    """A reference-style DataGenerator plugs into the streaming path via
    iter_samples, and its text is the JAX package's text."""
    from paddle_tpu import data_generator as jdg
    from paddle_tpu_torch.data_generator import (MultiSlotDataGenerator,
                                                 MultiSlotStringDataGenerator)

    def make(base):
        class Gen(base):
            def generate_sample(self, line):
                def reader():
                    toks = line.split(",")
                    yield [("ids", [int(t) for t in toks[:3]]),
                           ("lbl", [int(toks[3])])]
                return reader
        g = Gen()
        g.set_batch(1)
        return g

    g, jg = make(MultiSlotDataGenerator), make(jdg.MultiSlotDataGenerator)
    lines = ["1,2,3,1", "4,5,6,0"]
    samples = list(g.iter_samples(lines))
    assert samples == list(jg.iter_samples(lines))
    assert samples[0] == [("ids", [1, 2, 3]), ("lbl", [1])]

    ds = StreamingDataset(lambda: g.iter_samples(lines), batch_size=2)
    [b] = list(ds.batches())
    np.testing.assert_array_equal(b["ids"], [[1, 2, 3], [4, 5, 6]])

    text = g._gen_str(samples[0])
    assert text == jg._gen_str(samples[0])
    assert parse_multislot_line(text.strip(), ["ids", "lbl"]) == \
        [("ids", [1, 2, 3]), ("lbl", [1])]
    with pytest.raises(ValueError):
        g._gen_str([])                      # empty sample mis-frames
    with pytest.raises(ValueError):
        g._gen_str([("ids", [])])           # empty slot mis-frames

    gs = MultiSlotStringDataGenerator()
    assert gs._gen_str([("ids", ["1", "2"]), ("lbl", ["0"])]) \
        == "2 1 2 1 0\n"
    with pytest.raises(ValueError):
        gs._gen_str([("ids", [])])


def test_train_from_dataset_accepts_streaming_dataset():
    """StreamingDataset speaks the DatasetBase protocol end-to-end:
    Executor.train_from_dataset drains it like a QueueDataset."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [4])
        y = tfluid.layers.data("y", [1])
        pred = tfluid.layers.fc(x, 1, bias_attr=False,
                                param_attr=tfluid.ParamAttr(name="w"))
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
        tfluid.optimizer.SGD(0.05).minimize(loss)

    rng = np.random.RandomState(5)

    def src():
        for _ in range(32):
            xv = rng.uniform(-1, 1, 4).astype(np.float32)
            yield {"x": xv, "y": np.array([xv.sum()], np.float32)}

    ds = StreamingDataset(src, batch_size=8)
    ds.set_use_var([main.global_block().var("x"),
                    main.global_block().var("y")])
    exe = tfluid.Executor(tfluid.CPUPlace())
    sc = tfluid.Scope()
    exe.run(startup, scope=sc)
    w0 = sc.find_np("w").copy()
    out = exe.train_from_dataset(main, ds, scope=sc, fetch_list=[loss])
    assert out is not None and np.isfinite(np.asarray(out[0])).all()
    assert not np.array_equal(sc.find_np("w"), w0)


# ============================================================== delta push

def _publisher_run(mod, pub_cls, table_cls):
    table = table_cls.build_in_process(
        "tb", mod.RangeSpec.even(V, 2), full_rows=rand_rows(V, seed=41))
    got, tail = [], []
    pub = pub_cls(table, staleness_s=5.0, start=False)
    pub.subscribe(lambda name, uids, rows: got.append(
        (name, uids.copy(), rows.copy())))

    def sick(name, uids, rows):
        raise RuntimeError("replica down")
    pub.subscribe(sick)
    pub.subscribe(lambda name, uids, rows: tail.append(uids.size))
    r1 = rand_rows(2, seed=42)
    r2 = rand_rows(1, seed=43)
    table.push(np.array([5, 30], np.int64), r1)
    table.push(np.array([5], np.int64), r2)      # newer bytes for uid 5
    n = pub.flush()
    return pub, table, got, tail, n, (r1, r2)


def test_delta_publisher_coalesces_last_write_wins():
    err = get_registry().counter("stream/subscriber_errors", table="tb")
    err0 = err.value
    pub, table, got, tail, n, (r1, r2) = _publisher_run(
        tps, DeltaPublisher,
        ShardedTable)
    assert n == 2
    name, uids, rows = got[-1]
    assert name == "tb" and uids.tolist() == [5, 30]
    np.testing.assert_array_equal(rows[0], r2[0])  # last write wins
    np.testing.assert_array_equal(rows[1], r1[1])
    assert tail == [2]
    assert err.value == err0 + 1
    assert pub.flush() == 0                      # drained
    p = pub.staleness_percentiles()
    assert p["p50"] is not None and p["p99"] >= p["p50"]
    pub.close()                                  # detaches the listener
    table.push(np.array([7], np.int64), rand_rows(1, seed=44))
    assert pub.flush() == 0
    # the JAX publisher ships the same coalesced rows
    jpub, _, jgot, _, jn, _ = _publisher_run(jps, jstreaming.DeltaPublisher,
                                             jps.ShardedTable)
    jpub.close()
    assert jn == n and jgot[-1][1].tolist() == uids.tolist()
    np.testing.assert_array_equal(jgot[-1][2], rows)


def test_delta_publisher_background_flush_within_budget():
    table = ShardedTable.build_in_process(
        "tb", RangeSpec.even(V, 2), full_rows=rand_rows(V, seed=45))
    seen = threading.Event()
    with DeltaPublisher(table, staleness_s=0.2) as pub:
        pub.subscribe(lambda *a: seen.set())
        table.push(np.array([3], np.int64), rand_rows(1, seed=46))
        assert seen.wait(5.0)                    # contract: ~0.2 s
        p = pub.staleness_percentiles()
        assert p["max"] is not None and p["max"] < 5000.0


def test_row_cache_update_refreshes_residents_only():
    from paddle_tpu_torch.inference.ps_lookup import RowCache
    c = RowCache(4, LANES)
    first = rand_rows(2, seed=52)
    c.insert(np.array([3, 9], np.int64), first)
    fresh = rand_rows(3, seed=53)
    n = c.update(np.array([3, 7, 9], np.int64), fresh)
    assert n == 2 and len(c) == 2                # 7 skipped, never inserted
    got, miss = c.lookup(np.array([3, 9], np.int64))
    assert not miss.any()
    np.testing.assert_array_equal(got[0], fresh[0])
    np.testing.assert_array_equal(got[1], fresh[2])


def test_hot_cache_drop_rows_spares_dirty_rows():
    """attach_hot_cache semantics for a foreign tier's slab: clean
    residents drop (next touch re-pulls fresh bytes), dirty rows keep
    their pending write-back; the JAX cache drops the same rows."""
    from paddle_tpu.ps.hot_cache import HotRowCache as JHotRowCache
    from paddle_tpu_torch.ps.hot_cache import HotRowCache
    kept = []
    for cls in (JHotRowCache, HotRowCache):
        hc = cls(capacity=8, step_rows=4, lanes=LANES, vocab=100,
                 min_freq=1)
        plan = hc.plan(np.array([1, 2, 3], np.int64), np.array([1, 1, 1]))
        hc.commit(plan)
        assert hc.drop_rows(np.array([1, 2, 3], np.int64)) == 0
        u, _ = hc.flush_rows()                   # write-back: rows clean
        assert u.tolist() == [1, 2, 3]
        s2 = hc._slots.get(2)
        hc._dirty[s2] = True                     # a newer local update
        assert hc.drop_rows(np.array([1, 2, 3], np.int64)) == 2
        assert hc._slots.get(2) is not None      # dirty survived
        assert hc._slots.get(1) is None and hc._slots.get(3) is None
        kept.append(sorted(hc._slots.residents()[0].tolist()))
    assert kept[0] == kept[1] == [2]


def test_hot_cache_drop_rows_spares_inflight_and_pending_victims():
    """A row referenced by a planned, uncommitted step and a pending
    eviction victim are both kept."""
    from paddle_tpu_torch.ps.hot_cache import HotRowCache
    hc = HotRowCache(capacity=2, step_rows=4, lanes=LANES, vocab=100,
                     min_freq=1, sample=4)
    hc.commit(hc.plan(np.array([1, 2], np.int64), np.array([1, 1])))
    hc.flush_rows()                              # 1, 2 resident, clean
    for _ in range(16):                          # 3 grows frequent
        p = hc.plan(np.array([1, 3], np.int64), np.array([1, 1]))
        if p.evict_uids.size:
            break
        hc.commit(p)
        hc.flush_rows()
    assert p.evict_uids.tolist() == [2]
    # 1 is in flight, 2 is the pending victim: neither drops
    assert hc.drop_rows(np.array([1, 2], np.int64)) == 0
    hc.commit(p)
    hc.flush_rows()
    assert hc.drop_rows(np.array([1], np.int64)) == 1


# ============================================================ ps_admin vocab

def test_ps_admin_vocab_fields_aggregation_and_near_cap():
    from paddle_tpu.tools import ps_admin as jadmin
    from paddle_tpu_torch.tools import ps_admin
    sh = DynamicEmbeddingShard("tb", 0, 100, capacity=10)
    sh.pull(np.arange(10, dtype=np.int64))       # 100% occupancy
    payloads = [("h1:1", {"tb": sh.stats()}), ("h2:2", None)]
    v = ps_admin.vocab_fields(payloads)
    t = v["tables"]["tb"]
    assert t["live_rows"] == 10 and t["provisioned_rows"] == 10
    assert t["utilization"] == 1.0
    assert v["near_cap"] and v["near_cap"][0]["endpoint"] == "h1:1"
    jv = jadmin.vocab_fields(payloads)
    jv["tables"]["tb"].pop("oldest_row_age_s")
    v["tables"]["tb"].pop("oldest_row_age_s")
    assert v == jv

    static = EmbeddingShard("tb", 0, 5, rows=np.zeros((5, LANES), np.uint16))
    assert ps_admin.vocab_fields([("h", {"tb": static.stats()})]) is None


def test_ps_admin_dump_health_flags_near_cap_as_degraded(capsys):
    from paddle_tpu_torch.tools import ps_admin
    sh = DynamicEmbeddingShard("tb", 0, 100, capacity=10)
    sh.pull(np.arange(10, dtype=np.int64))
    srv = ShardServer([sh]).serve_in_thread()
    try:
        rc = ps_admin.main(["dump-health", "--endpoints", srv.endpoint,
                            "--json"])
        assert rc == 0                           # up (degraded != down)
        doc = json.loads(capsys.readouterr().out)
        assert doc["status"] == "degraded"
        assert "row cap" in doc["detail"]
        assert doc["shards"][0]["near_cap"] is True
        assert doc["vocab"]["tables"]["tb"]["live_rows"] == 10
    finally:
        srv.stop()


def test_ps_admin_stats_includes_vocab_block(capsys):
    from paddle_tpu_torch.tools import ps_admin
    sh = DynamicEmbeddingShard("tb", 0, 100, capacity=100)
    sh.pull(np.arange(5, dtype=np.int64))
    srv = ShardServer([sh]).serve_in_thread()
    try:
        rc = ps_admin.main(["stats", "--endpoints", srv.endpoint, "--json"])
        assert rc == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["vocab"]["tables"]["tb"]["live_rows"] == 5
        assert doc["vocab"]["near_cap"] == []
    finally:
        srv.stop()


# ======================================================== online smoke + soak

def _online_program(vocab_rows):
    """The JAX test's CTR-style model: score = sum of the ids' visible
    embedding columns, regressed onto the click label."""
    main, startup = tfluid.Program(), tfluid.Program()
    L = tfluid.layers
    with tfluid.program_guard(main, startup):
        ids = L.data("ids", [F], dtype="int64")
        lbl = L.data("lbl", [1], dtype="float32")
        emb = L.embedding(
            ids, [vocab_rows, D * MULT], is_sparse=True, row_pack=True,
            param_attr=tfluid.ParamAttr(
                name="tb", initializer=tfluid.initializer.RowPackInitializer(
                    D, D * MULT, -0.01, 0.01)))
        emb = L.slice(emb, axes=[2], starts=[0], ends=[D])
        score = L.reshape(L.reduce_sum(emb, dim=[1, 2]), [-1, 1])
        loss = L.mean(L.square_error_cost(score, lbl))
        tfluid.optimizer.Adagrad(
            0.1, packed_rows={"rows_per_step": CAP}).minimize(loss)
    return main, startup, loss


def _save_online_model(model_dir, vocab_rows):
    main, startup = tfluid.Program(), tfluid.Program()
    L = tfluid.layers
    with tfluid.program_guard(main, startup):
        ids = L.data("ids", [F], dtype="int64")
        emb = L.embedding(
            ids, [vocab_rows, D * MULT], is_sparse=True, row_pack=True,
            param_attr=tfluid.ParamAttr(
                name="tb", initializer=tfluid.initializer.RowPackInitializer(
                    D, D * MULT, -0.01, 0.01)))
        emb = L.slice(emb, axes=[2], starts=[0], ends=[D])
        score = L.reshape(L.reduce_sum(emb, dim=[1, 2]), [-1, 1])
    exe = tfluid.Executor(tfluid.CPUPlace())
    sc = tfluid.Scope()
    exe.run(startup, scope=sc)
    with tfluid.scope_guard(sc):
        tfluid.io.save_inference_model(model_dir, ["ids"], [score], exe,
                                       main)


def _ctr_source(vocab, seed=11, cfg=None):
    """The JAX test's endless labelled stream (same RNG draws)."""
    rng = np.random.RandomState(seed)
    w = rng.uniform(-1.0, 1.0, vocab)
    cfg = cfg if cfg is not None else {}

    def gen():
        while True:
            hf = cfg.get("hot_frac", 0.0)
            if hf and rng.uniform() < hf:
                ids = rng.randint(0, cfg["hot_ids"], F)
            else:
                ids = rng.randint(0, vocab, F)
            lbl = 1.0 if w[ids].sum() > 0 else 0.0
            yield {"ids": ids.astype(np.int64),
                   "lbl": np.array([lbl], np.float32)}
    return gen


def _auc_readings(trainer):
    return [v for _, v in trainer.history["eval"] if not np.isnan(v)]


def _serving_predictor(tmp_path, table, cache_rows):
    from paddle_tpu_torch import inference
    _save_online_model(str(tmp_path / "m"), CAP)
    cfg = inference.Config(str(tmp_path / "m"))
    cfg.disable_gpu()
    base = inference.create_predictor(cfg)
    return inference.PsLookupPredictor(
        base, [inference.PsLookupBinding("tb", table, ["ids"])],
        cache_rows_per_table=cache_rows)


def _assert_serving_fresh(ps, table, nonempty=True):
    cache = ps._caches["tb"]
    res_uids, _ = cache._slots.residents()
    if nonempty:
        assert res_uids.size > 0
    uids = np.sort(res_uids.astype(np.int64))
    if uids.size:
        got, miss = cache.lookup(uids)
        assert not miss.any()
        np.testing.assert_array_equal(got, table.pull(uids))


def test_auc_matches_the_jax_package():
    rng = np.random.RandomState(3)
    s = np.round(rng.uniform(size=200), 2)      # ties
    y = (rng.uniform(size=200) > 0.4).astype(np.float32)
    assert auc(s, y) == jstreaming.auc(s, y)
    assert np.isnan(auc(s, np.ones(200)))


def test_online_smoke_auc_improves_and_serving_is_fresh(tmp_path):
    """One process trains a dynamic-vocab PS table from an endless stream
    while a PsLookupPredictor serves lookups against the SAME table —
    eval AUC (scored through the predictor, i.e. through serving bytes)
    improves, delta checkpoints land on the cadence, and after the final
    publisher flush every row resident in the serving cache is
    bitwise-fresh vs the shards."""
    vocab = 60
    spec = RangeSpec.even(vocab, 2)
    shards = make_dynamic_shards("tb", spec, capacity_per_shard=vocab)
    table = ShardedTable("tb", spec, [InProcessClient([s]) for s in shards])
    ps = _serving_predictor(tmp_path, table, vocab)
    pub = DeltaPublisher(table, staleness_s=0.5)
    pub.attach_predictor(ps)

    ds = StreamingDataset(_ctr_source(vocab), batch_size=B,
                          held_out_every=5, eval_window=160)
    main, startup, loss = _online_program(CAP)
    exe = tfluid.Executor(tfluid.CPUPlace())
    sc = tfluid.Scope()
    exe.run(startup, scope=sc)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(0, program=main, scope=sc, blocking=True,
            ps_tables={"tb": table})
    tier = PsEmbeddingTier(main, [PsTableBinding("tb", table, ["ids"])],
                           pull_ahead=1, push_depth=0,
                           place=tfluid.CPUPlace())

    def score_fn(feed):
        return ps.run({"ids": feed["ids"]})[0]

    trainer = OnlineTrainer(
        exe, main, tier, ds, fetch_list=[loss], scope=sc,
        ps_tables={"tb": table}, checkpointer=ck, publishers=[pub],
        sweep_every=50, delta_every=25, compact_every=4,
        eval_every=20, eval_fn=lambda: eval_auc(ds, score_fn, "lbl"))
    try:
        assert trainer.run(max_steps=200) == 200
        trainer.finish()
        _assert_serving_fresh(ps, table)
        e2e = ps.staleness_e2e_percentiles()
        assert e2e["p50"] is not None and e2e["p99"] >= e2e["p50"]
        series = get_registry().series()
        (h,) = [s for s in series if s["name"] == "staleness/e2e_ms"
                and s["labels"].get("table") == "tb"]
        assert h["summary"]["count"] > 0
        (clk,) = [s for s in series
                  if s["name"] == "staleness/last_visible_ts"
                  and s["labels"].get("table") == "tb"]
        assert 0.0 <= time.time() - clk["value"] < 60.0
    finally:
        tier.close()
        pub.close()

    aucs = _auc_readings(trainer)
    assert len(aucs) >= 3
    assert aucs[-1] > 0.75, aucs
    assert aucs[-1] > aucs[0] + 0.05, aucs
    deltas = ck.delta_steps(0)
    assert deltas and all(ck.verify_delta(0, d) == [] for d in deltas)
    losses = trainer.history["loss"]
    assert np.mean(losses[-20:]) < np.mean(losses[:20])


@pytest.mark.slow
def test_online_soak_growth_eviction_staleness_and_midrun_restore(tmp_path):
    """A longer skewed stream over a dynamic table whose slab is ~8x
    smaller than the id space: AUC keeps improving, the vocab grows past
    the provisioned rows while live rows stay capped, delta-push
    staleness holds p99 within budget, and a mid-run delta checkpoint
    restores bitwise."""
    vocab, hot_ids, cap_per_shard = 4000, 120, 256
    spec = RangeSpec.even(vocab, 2)
    shards = make_dynamic_shards("tb", spec, capacity_per_shard=cap_per_shard,
                                 high_watermark=0.9, low_watermark=0.7,
                                 keep_freq=3)
    table = ShardedTable("tb", spec, [InProcessClient([s]) for s in shards])
    ps = _serving_predictor(tmp_path, table, 512)
    staleness_s = 1.0
    pub = DeltaPublisher(table, staleness_s=staleness_s)
    pub.attach_predictor(ps)

    cfg = {"hot_frac": 0.9, "hot_ids": hot_ids}
    ds = StreamingDataset(_ctr_source(vocab, cfg=cfg),
                          batch_size=B, held_out_every=5, eval_window=240)
    main, startup, loss = _online_program(CAP)
    exe = tfluid.Executor(tfluid.CPUPlace())
    sc = tfluid.Scope()
    exe.run(startup, scope=sc)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(0, program=main, scope=sc, blocking=True,
            ps_tables={"tb": table})
    tier = PsEmbeddingTier(main, [PsTableBinding("tb", table, ["ids"])],
                           pull_ahead=1, push_depth=0,
                           place=tfluid.CPUPlace())

    def score_fn(feed):
        return ps.run({"ids": feed["ids"]})[0]

    trainer = OnlineTrainer(
        exe, main, tier, ds, fetch_list=[loss], scope=sc,
        ps_tables={"tb": table}, checkpointer=ck, publishers=[pub],
        sweep_every=40, delta_every=0, compact_every=0,
        eval_every=40, eval_fn=lambda: eval_auc(ds, score_fn, "lbl"))
    try:
        trainer.run(max_steps=400)
        st = [s.stats() for s in shards]
        assert sum(s["materialized"] for s in st) > 2 * cap_per_shard
        assert all(s["live_rows"] <= cap_per_shard for s in st)
        assert sum(s["evicted"] for s in st) > 0
        assert all(s["slab_bytes"] == cap_per_shard * LANES * 2
                   for s in st)

        tier.flush()
        ck.save(trainer.step, program=main, scope=sc, blocking=True,
                ps_tables={"tb": table})
        cfg["hot_frac"] = 1.0
        trainer.sweep_every = 0
        eval_every, trainer.eval_every = trainer.eval_every, 0
        trainer.run(max_steps=60)
        tier.flush()
        ck.save_delta(trainer.step + 1, {"tb": table}, blocking=True)
        expected = table.dump_full()
        restored, _, _ = ck.load_ps_table("tb")
        np.testing.assert_array_equal(restored, expected)

        cfg["hot_frac"] = 0.9
        trainer.sweep_every = 40
        trainer.eval_every = eval_every
        trainer.run(max_steps=120)
        trainer.finish()
        _assert_serving_fresh(ps, table, nonempty=False)
    finally:
        tier.close()
        pub.close()

    aucs = _auc_readings(trainer)
    assert len(aucs) >= 5
    assert aucs[-1] > 0.70, aucs
    assert aucs[-1] > aucs[0], aucs
    p = pub.staleness_percentiles()
    assert p["p99"] is not None
    assert p["p99"] <= staleness_s * 1e3 * 1.5, p   # budget + CI slack
