"""The port's PS embedding tier and device-resident hot-row cache
(``paddle_tpu_torch.ps``) on the CPU.

Twins of the JAX package's ``tests/test_ps_hot_cache.py`` (slab bookkeeping,
plan/commit rules, the row kernels through the cache) and of the bitwise
training matrix: over four shard layouts × synchronous and depth-1 async
push × a hot cache smaller and larger than the working set (and the uncached
tier), the tier's losses are ``==`` and its final shard bytes equal to the
port's single-table packed baseline, with pulls inline (``pull_ahead=0``)
and prefetched on a ``DeviceLoader`` worker (``pull_ahead`` 1 and 2, the
JAX matrix's overlapped cell). The baseline itself agrees with the JAX
package's within rtol 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from _torch_twin import alarm_timeout
from paddle_tpu.ops.pallas_kernels import sparse_adagrad as jfsa
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.ops.kernels import sparse_adagrad as fsa
from paddle_tpu_torch.ps import (FreqSketch, HotRowCache, LruOrder,
                                 PsEmbeddingTier, PsTableBinding, RangeSpec,
                                 ShardedTable, SlotMap)

torch.set_num_threads(1)

V, D, B, F = 50, 4, 4, 3
MULT = 2          # adagrad: param + g2sum in-row
CAP = B * F       # cache rows = max uniques per step
LANES = 128
SPECS = [RangeSpec.even(V, 1), RangeSpec.even(V, 2), RangeSpec.even(V, 4),
         RangeSpec(V, [0, 17, 40, V])]


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, scope and unique names of the port."""
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


@pytest.fixture(autouse=True)
def _time_limit():
    """The prefetched cells start loader and pusher threads: a hang fails
    the test."""
    yield from alarm_timeout(120)


# ------------------------------------------------------------- slab core

def test_slotmap_dict_and_dense_modes_agree():
    for vocab in (None, 100):
        m = SlotMap(3, vocab=vocab)
        s0, s1 = m.assign(10), m.assign(20)
        assert (m.get(10), m.get(20), m.get(30)) == (s0, s1, None)
        assert m.get_many(np.array([10, 30, 20])).tolist() == [s0, -1, s1]
        assert 10 in m and 30 not in m
        assert len(m) == 2 and m.free_slots == 1
        assert m.uid_of(s0) == 10
        assert m.uids_at(np.array([s1]))[0] == 20
        assert m.pop(10) == s0 and m.get(10) is None
        assert m.assign(99) == s0          # LIFO slot recycle
        uids, slots = m.residents()
        assert sorted(uids.tolist()) == [20, 99] and slots.size == 2
        m.clear()
        assert len(m) == 0 and m.get(99) is None and m.free_slots == 3
    full = SlotMap(1)
    full.assign(1)
    with pytest.raises(RuntimeError, match="full"):
        full.assign(2)


def test_lru_order_coldest_pops_first():
    lru = LruOrder()
    for u in (1, 2, 3):
        lru.touch(u)
    lru.touch(1)
    assert lru.pop_coldest() == 2
    lru.discard(3)
    assert lru.pop_coldest() == 1
    assert len(lru) == 0


def test_freq_sketch_overcounts_only_and_decays():
    sk = FreqSketch(width=1 << 10, depth=4, decay_every=10_000)
    sk.observe(np.full(50, 7, np.int64))
    sk.observe(np.array([3], np.int64))
    est = sk.estimate(np.array([7, 3, 999], np.int64))
    assert int(est[0]) >= 50 and int(est[1]) >= 1 and int(est[2]) <= 1
    sk2 = FreqSketch(width=1 << 10, decay_every=64)
    sk2.observe(np.full(64, 5, np.int64))
    assert int(sk2.estimate(np.array([5], np.int64))[0]) == 32
    with pytest.raises(ValueError, match="power of two"):
        FreqSketch(width=100)


# --------------------------------------------------- HotRowCache planning

def _mk_cache(capacity=4, step_rows=8, min_freq=2, **kw):
    return HotRowCache(capacity, step_rows, lanes=LANES, vocab=V,
                       min_freq=min_freq, **kw)


def test_one_touch_ids_bypass_then_admit_then_hit():
    hc = _mk_cache()
    u = np.array([1, 2, 3], np.int64)
    p1 = hc.plan(u)
    assert p1.n_hit == 0 and p1.n_admit == 0
    assert (p1.slots >= hc.capacity).all()
    assert p1.bypass_uids.tolist() == [1, 2, 3]
    hc.commit(p1)
    p2 = hc.plan(u)
    assert p2.n_admit == 3 and p2.n_hit == 0
    assert (p2.slots < hc.capacity).all() and p2.bypass_uids.size == 0
    hc.commit(p2)
    p3 = hc.plan(u)
    assert p3.n_hit == 3 and p3.miss_uids.size == 0
    hc.commit(p3)
    st = hc.stats()
    assert st["resident"] == 3 and st["hits"] == 3 and st["misses"] == 6
    assert st["admitted"] == 3 and st["bypass"] == 3


def test_occurrence_weighted_lookup_hit_rate():
    hc = _mk_cache(min_freq=1)
    u = np.array([1, 2], np.int64)
    hc.commit(hc.plan(u, np.array([5, 1], np.int64)))
    hc.commit(hc.plan(u, np.array([10, 2], np.int64)))
    st = hc.stats()
    assert st["hits"] == 2 and st["misses"] == 2 and st["hit_rate"] == 0.5
    assert st["lookup_hits"] == 12 and st["lookup_misses"] == 6
    assert st["lookup_hit_rate"] == 12 / 18


def test_step_rows_overflow_is_a_sizing_error():
    hc = _mk_cache(capacity=2, step_rows=4)
    with pytest.raises(ValueError, match="staging"):
        hc.plan(np.arange(5, dtype=np.int64))
    with pytest.raises(ValueError):
        HotRowCache(0, 4, lanes=LANES, vocab=V)


def test_sampled_lfu_evicts_cold_and_reuses_the_slot():
    hc = _mk_cache(capacity=2, step_rows=8, min_freq=1)
    hc.commit(hc.plan(np.array([10, 11], np.int64)))
    for _ in range(4):
        hc._sketch.observe(np.array([20], np.int64))
    p2 = hc.plan(np.array([20], np.int64))
    assert p2.n_admit == 1 and p2.evict_uids.size == 1
    assert int(p2.evict_uids[0]) in (10, 11)
    assert int(p2.slots[0]) == int(p2.evict_slots[0])
    hc.commit(p2)


def test_eviction_tie_keeps_incumbent():
    hc = _mk_cache(capacity=1, step_rows=8, min_freq=1)
    hc.commit(hc.plan(np.array([5], np.int64)))
    p2 = hc.plan(np.array([6], np.int64))
    assert p2.n_admit == 0 and p2.evict_uids.size == 0
    assert p2.bypass_uids.tolist() == [6]
    hc.commit(p2)


def test_inflight_slots_are_never_victims():
    hc = _mk_cache(capacity=2, step_rows=8, min_freq=1)
    pinned = hc.plan(np.array([1, 2], np.int64))
    hc._sketch.observe(np.full(8, 30, np.int64))
    p = hc.plan(np.array([30], np.int64))
    assert p.n_admit == 0 and p.bypass_uids.tolist() == [30]
    hc.commit(p)
    hc.commit(pinned)


def test_flush_rows_dirty_at_commit_plus_pending_evicts():
    hc = _mk_cache(capacity=2, step_rows=8, min_freq=1)
    p = hc.plan(np.array([3, 4], np.int64))
    assert hc.flush_rows()[0].size == 0
    hc.commit(p)
    u, s = hc.flush_rows()
    assert u.tolist() == [3, 4] and s.size == 2
    assert hc.flush_rows()[0].size == 0
    hc._sketch.observe(np.full(8, 9, np.int64))
    p2 = hc.plan(np.array([9], np.int64))
    assert p2.evict_uids.size == 1
    vu, vs = int(p2.evict_uids[0]), int(p2.evict_slots[0])
    u, s = hc.flush_rows()
    assert u.tolist() == [vu] and s.tolist() == [vs]
    hc.commit(p2)


# ------------------------------------------- row kernels through the cache

@pytest.mark.parametrize("switch", ["1", "0"])
def test_hot_cache_device_ops_roundtrip(monkeypatch, switch):
    """insert_rows / take_rows through the row wrappers (their plain
    versions on the CPU) or, with PDTPU_FUSED_SPARSE=0, the plain versions
    bound directly: the same bytes, padded to a power-of-two bucket that
    repeats the last row."""
    monkeypatch.setenv("PDTPU_FUSED_SPARSE", switch)
    assert fsa.rows_enabled(LANES) == (switch == "1")
    hc = _mk_cache(capacity=4, step_rows=4)
    rows = np.random.RandomState(2).randint(
        0, 2 ** 16, (3, LANES)).astype(np.uint16)
    hc.insert_rows(np.array([1, 3, 6]),
                   torch.from_numpy(rows.view(np.int16)).view(torch.uint16))
    got = fsa.i16(hc.take_rows(np.array([1, 3, 6]))).numpy().view(np.uint16)
    assert got.shape == (4, LANES)
    np.testing.assert_array_equal(got[:3], rows)
    np.testing.assert_array_equal(got[3], got[2])
    slab = fsa.i16(hc.slab).numpy()
    assert not slab[[0, 2, 4, 5, 7]].any()


# -------------------------------------------------- bitwise training matrix

def _feeds():
    rng = np.random.RandomState(1)
    out = [{"ids": rng.randint(0, V, (B, F)).astype("int64")}
           for _ in range(12)]
    # one batch of ALL-duplicate ids sitting exactly on an uneven-spec cut
    out[3] = {"ids": np.full((B, F), 17, dtype="int64")}
    return out


def _build_program(fluid, vocab_rows):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", [F], dtype="int64")
        emb = fluid.layers.embedding(
            ids, [vocab_rows, D * MULT], is_sparse=True, row_pack=True,
            param_attr=fluid.ParamAttr(
                name="tb", initializer=fluid.initializer.RowPackInitializer(
                    D, D * MULT, -1.0, 1.0)))
        emb = fluid.layers.slice(emb, axes=[2], starts=[0], ends=[D])
        loss = fluid.layers.reduce_sum(fluid.layers.square(emb))
        fluid.optimizer.Adagrad(
            0.1, packed_rows={"rows_per_step": CAP}).minimize(loss)
    return main, startup, loss


def _init_packed():
    """Deterministic full packed table: visible cols from one RNG, zero
    optimizer state."""
    vis = np.random.RandomState(7).uniform(-1, 1, (V, D)).astype("float32")
    rows = np.zeros((V, D * MULT), "float32")
    rows[:, :D] = vis
    return fsa.i16(fsa.pack_rows(torch.from_numpy(rows))).numpy().view(
        np.uint16)


@pytest.fixture(scope="module")
def ref():
    """(feeds, baseline losses, baseline final table) of the port's
    single-table packed run."""
    feeds = _feeds()
    main, startup, loss = _build_program(tfluid, V)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.io.load_params_from_numpy({"tb": _init_packed()}, scope=scope)
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    return feeds, losses, scope.find_np("tb")


def _tier_run(feeds, spec, push_depth, hot_rows, pull_ahead=0):
    main, startup, loss = _build_program(tfluid, hot_rows + CAP)
    table = ShardedTable.build_in_process("tb", spec,
                                          full_rows=_init_packed())
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tier = PsEmbeddingTier(main, [PsTableBinding("tb", table, ["ids"])],
                           pull_ahead=pull_ahead, push_depth=push_depth,
                           hot_rows=hot_rows, place=tfluid.CPUPlace())
    losses = []
    try:
        for prep in tier.steps(lambda: iter(feeds)):
            (lv,) = tier.run_step(exe, prep, fetch_list=[loss], scope=scope)
            losses.append(float(lv))
        tier.flush()
        stats = tier.stats()["tb"].get("hot_cache")
        final = table.dump_full()
    finally:
        tier.close()
    return losses, final, stats


@pytest.mark.parametrize("push_depth", [0, 1])
@pytest.mark.parametrize("hot_rows,min_freq", [(8, None), (64, 1)])
def test_hot_training_bitwise_exact(monkeypatch, ref, push_depth, hot_rows,
                                    min_freq):
    """Shard counts 1/2/4 + uneven ranges × synchronous and async push × a
    cache smaller than the working set (admissions, evictions and
    write-backs all fire) and one larger than it: losses and final shard
    bytes bitwise equal to the packed baseline."""
    if min_freq is not None:
        monkeypatch.setenv("PDTPU_PS_ADMIT_MIN_FREQ", str(min_freq))
    feeds, ref_losses, ref_final = ref
    for spec in SPECS:
        losses, final, st = _tier_run(feeds, spec, push_depth, hot_rows)
        assert losses == ref_losses, (spec.to_dict(), push_depth, hot_rows)
        np.testing.assert_array_equal(final, ref_final)
        if hot_rows < V:
            assert st["evictions"] > 0 and st["writeback_bytes"] > 0
        else:
            assert st["evictions"] == 0
            assert st["hit_rate"] is not None and st["hit_rate"] > 0.5


@pytest.mark.parametrize("pull_ahead,push_depth", [(1, 0), (1, 1), (2, 1)])
@pytest.mark.parametrize("hot_rows,min_freq", [(8, None), (64, 1)])
def test_hot_training_bitwise_exact_prefetched(monkeypatch, ref, pull_ahead,
                                               push_depth, hot_rows,
                                               min_freq):
    """The same matrix with the pulls prefetched `pull_ahead` batches
    ahead on a DeviceLoader worker (the JAX matrix's (2, 1) cell among
    them): the read-your-writes patching and the hot cache's in-flight
    slots keep it bitwise equal to the packed baseline."""
    if min_freq is not None:
        monkeypatch.setenv("PDTPU_PS_ADMIT_MIN_FREQ", str(min_freq))
    feeds, ref_losses, ref_final = ref
    for spec in SPECS:
        losses, final, st = _tier_run(feeds, spec, push_depth, hot_rows,
                                      pull_ahead)
        assert losses == ref_losses, (spec.to_dict(), pull_ahead,
                                      push_depth, hot_rows)
        np.testing.assert_array_equal(final, ref_final)
        if hot_rows < V:
            assert st["evictions"] > 0 and st["writeback_bytes"] > 0
        else:
            assert st["evictions"] == 0


@pytest.mark.parametrize("pull_ahead,push_depth", [(1, 0), (2, 1)])
def test_sharded_training_bitwise_exact_prefetched(ref, pull_ahead,
                                                   push_depth):
    """The uncached tier with prefetched pulls, every shard layout."""
    feeds, ref_losses, ref_final = ref
    for spec in SPECS:
        losses, final, st = _tier_run(feeds, spec, push_depth, 0,
                                      pull_ahead)
        assert st is None
        assert losses == ref_losses, (spec.to_dict(), pull_ahead)
        np.testing.assert_array_equal(final, ref_final)


@pytest.mark.parametrize("push_depth", [0, 1])
def test_sharded_training_bitwise_exact(ref, push_depth):
    """The uncached tier (hot_rows=0): every shard layout, bitwise."""
    feeds, ref_losses, ref_final = ref
    for spec in SPECS:
        losses, final, st = _tier_run(feeds, spec, push_depth, 0)
        assert st is None
        assert losses == ref_losses, (spec.to_dict(), push_depth)
        np.testing.assert_array_equal(final, ref_final)


def test_baseline_matches_jax(ref):
    """The port's single-table baseline against the JAX package's, from
    the same packed table (the JAX run takes its Pallas kernel under the
    interpreter)."""
    feeds, losses, final = ref
    old = jfsa.FORCE_PALLAS_INTERPRET
    jfsa.FORCE_PALLAS_INTERPRET = True
    try:
        from paddle_tpu.core import unique_name as jnames
        with jnames.guard():
            main, startup, loss = _build_program(jfluid, V)
        exe = jfluid.Executor(jfluid.CPUPlace())
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe.run(startup)
            scope.set_var("tb", jnp.asarray(_init_packed()))
            jl = [float(exe.run(main, feed=f, fetch_list=[loss])[0])
                  for f in feeds]
    finally:
        jfsa.FORCE_PALLAS_INTERPRET = old
    np.testing.assert_allclose(losses, jl, rtol=1e-6)


def test_tier_refuses_what_is_not_ported():
    main, startup, loss = _build_program(tfluid, CAP)
    table = ShardedTable.build_in_process("tb", RangeSpec.even(V, 2))
    tier = PsEmbeddingTier(main, [PsTableBinding("tb", table, ["ids"])],
                           place=tfluid.CPUPlace())
    assert tier.pull_ahead == 1  # the JAX package's default
    try:
        with pytest.raises(ValueError, match="cache"):
            tier._pull_cache(tier.bindings[0],
                             np.arange(CAP + 1, dtype=np.int64), 0)
    finally:
        tier.close()
    from paddle_tpu_torch.ps import SocketClient, connect
    with pytest.raises(NotImplementedError, match="A8"):
        SocketClient("localhost:1")
    with pytest.raises(NotImplementedError, match="A8"):
        connect("localhost:1")


# ------------------------------------------ journal, fault probes, tracing

@pytest.mark.parametrize("cap_mb,entries,nbytes,evicted", [
    (None, 0, 0, [2, 2]),           # the port's default: no journal
    ("1", 4, 2 * 792, [0, 0]),      # both pushes kept
    ("0.001", 2, 792, [1, 1]),      # 1048 B: the first push evicted
])
def test_push_journal(monkeypatch, cap_mb, entries, nbytes, evicted):
    """The push journal keeps each push per shard (3 ids of 8 B and rows
    of 256 B a push) up to PDTPU_PS_JOURNAL_MAX_MB, oldest out first; at 0
    (the default) it copies nothing and only the seq and the eviction
    horizon move. truncate and reset drop what a checkpoint holds."""
    if cap_mb is None:
        monkeypatch.delenv("PDTPU_PS_JOURNAL_MAX_MB", raising=False)
    else:
        monkeypatch.setenv("PDTPU_PS_JOURNAL_MAX_MB", cap_mb)
    table = ShardedTable.build_in_process("tb", RangeSpec.even(V, 2))
    ids = np.array([1, 2, 30], np.int64)
    rows = np.random.RandomState(3).randint(
        0, 2 ** 16, (3, LANES)).astype(np.uint16)
    try:
        for _ in range(2):
            table.push(ids, rows)
        j = table.stats()["journal"]
        assert (j["entries"], j["bytes"], j["seq"]) == (entries, nbytes, 2)
        assert j["evicted_upto"] == evicted
        assert table.journal_mark() == 2
        np.testing.assert_array_equal(table.pull(ids), rows)
        table.journal_truncate(1)
        assert table.journal_bytes() == min(nbytes, 792)
        table.journal_reset(5)
        j = table.stats()["journal"]
        assert (j["entries"], j["bytes"], j["seq"]) == (0, 0, 5)
    finally:
        table.close()


@pytest.mark.parametrize("site,push_depth", [
    ("ps.pull", 0), ("ps.push", 0), ("ps.push", 1)])
def test_fault_probes_in_the_tier(ref, site, push_depth):
    """An armed ``raise`` at a tier probe fails that step's pull or push
    (a depth-1 pusher is poisoned and says so at the next submit or
    flush); a ``delay_ms`` rule only slows the steps. Each firing counts
    on faults/injected{site,action}."""
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.observability import get_registry

    feeds, ref_losses, _ = ref
    fired = get_registry().counter("faults/injected", site=site,
                                   action="raise")
    before = fired.value
    faults.install(site, "raise", count=2)
    try:
        with pytest.raises((faults.InjectedFault, RuntimeError)) as ei:
            _tier_run(feeds, SPECS[1], push_depth, 0)
    finally:
        faults.clear()
    err = ei.value
    assert isinstance(err, faults.InjectedFault) or isinstance(
        err.__cause__, faults.InjectedFault)
    assert fired.value == before + 1
    delayed = get_registry().counter("faults/injected", site=site,
                                     action="delay_ms")
    before = delayed.value
    faults.install(site, "delay_ms", 1)
    try:
        losses, _, _ = _tier_run(feeds, SPECS[1], push_depth, 0)
    finally:
        faults.clear()
    assert losses == ref_losses
    assert delayed.value - before >= len(feeds)
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.install(site, "crash")


def test_tracer_off_by_default_exports_step_spans_when_on(ref):
    """The host tracer records nothing until it is turned on; then every
    tier step is a ps/train_step span rooting its own trace, exported as
    chrome-trace JSON."""
    from paddle_tpu_torch.observability.tracer import get_tracer

    feeds, ref_losses, _ = ref
    tracer = get_tracer()
    tracer.clear()
    assert not tracer.enabled
    _tier_run(feeds[:2], SPECS[0], 0, 8)
    assert len(tracer) == 0
    tracer.enabled = True
    try:
        losses, _, _ = _tier_run(feeds, SPECS[0], 0, 8)
        trace = tracer.export_chrome_trace()
    finally:
        tracer.enabled = False
        tracer.clear()
    assert losses == ref_losses
    steps = [e for e in trace["traceEvents"] if e["name"] == "ps/train_step"]
    begins = [e for e in steps if e["ph"] == "B"]
    assert len(begins) == len(feeds) and len(steps) == 2 * len(feeds)
    ids = {e["args"]["trace_id"] for e in begins}
    assert len(ids) == len(feeds)
    assert all("parent_id" not in e["args"] for e in begins)
    assert trace["traceEvents"][0]["ph"] == "M"
