"""Chaos matrix of the port's fault-tolerant PS tier: twins of
``tests/test_ps_faults.py``.

A pserver can die — SIGKILL, RST'd connections, dropped requests, torn
reply frames, stalls — and single-worker training at staleness 0 finishes
with losses and final table bytes BITWISE identical to an uninterrupted
run of the port (the JAX test's claim), with no worker crash. Recovery is
the newest verified checkpoint slice + push-journal replay
(``ShardedTable.recover_shard``), orchestrated by
``PsEmbeddingTier.attach_checkpointer``. The pservers are the port's
runner (``tests/torch_ps_server_runner.py``), fresh interpreters that load
neither torch nor JAX. The fault grammar and the journal's replay and
eviction are held to the JAX package's on the same inputs.

The slow soak variants keep the JAX file's ``slow`` mark."""
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.ps as jps
from _torch_ps_twin import (LANES, V, fast_retry, feeds, in_process_table,
                            init_packed, launch_pserver, packed_baseline,
                            ps_run, rand_rows, stop_all, tiny_program)
from _torch_twin import alarm_timeout, fresh_observability
from paddle_tpu import faults as jfaults
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import faults
from paddle_tpu_torch.observability.http import run_health_checks
from paddle_tpu_torch.observability.registry import get_registry
from paddle_tpu_torch.parallel.checkpoint import Checkpointer
from paddle_tpu_torch.ps import (EmbeddingShard, RangeSpec, ShardMonitor,
                                 ShardServer, ShardedTable, SocketClient,
                                 TransportError, make_shards)
from paddle_tpu_torch.ps.transport import _recv_exact

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(autouse=True)
def _fresh_observability():
    yield from fresh_observability()


@pytest.fixture(autouse=True)
def _time_limit():
    yield from alarm_timeout(150)


# ------------------------------------------------------- fault-spec grammar

def test_parse_spec_network_actions():
    spec = "ps.rpc:drop@2,ps.rpc:reset,s.x:delay_ms=5"
    got = [(r.site, r.action, r.count) for r in faults.parse_spec(spec)]
    assert got == [(r.site, r.action, r.count)
                   for r in jfaults.parse_spec(spec)]
    assert got == [("ps.rpc", "drop", 2), ("ps.rpc", "reset", None),
                   ("s.x", "delay_ms", None)]
    with pytest.raises(ValueError, match="unknown action"):
        faults.parse_spec("ps.rpc:fizzle")


def test_injected_network_fault_carries_kind():
    faults.install("t.net", "reset", count=1)
    with pytest.raises(faults.InjectedNetworkFault) as ei:
        faults.fault_point("t.net")
    assert ei.value.kind == "reset"
    # still an InjectedFault/OSError: at a non-transport site it behaves
    # exactly like the `raise` action
    assert isinstance(ei.value, faults.InjectedFault)
    faults.install("t.net2", "drop")
    with pytest.raises(faults.InjectedNetworkFault) as ei:
        faults.fault_point("t.net2")
    assert ei.value.kind == "drop"


# ------------------------------------------------------ transport taxonomy

def test_recv_exact_short_read_is_transient_with_context():
    a, b = socket.socketpair()
    try:
        a.sendall(b"abc")
        a.close()
        with pytest.raises(TransportError) as ei:
            _recv_exact(b, 10)
        assert ei.value.transient
        assert "expected 10 bytes" in str(ei.value)
        assert "got 3" in str(ei.value)
    finally:
        b.close()


def test_retry_exhaustion_surfaces_transient_error(monkeypatch):
    monkeypatch.setenv("PDTPU_PS_RETRIES", "2")
    monkeypatch.setenv("PDTPU_PS_RETRY_BACKOFF_MS", "1")
    retries0 = get_registry().counter("ps/rpc_retries").value
    c = SocketClient("127.0.0.1:1")  # nothing listens on port 1
    with pytest.raises(TransportError) as ei:
        c.ping()
    assert ei.value.transient and "3 attempts" in str(ei.value)
    assert get_registry().counter("ps/rpc_retries").value == retries0 + 2
    c.close()


def _served_table(rows, num_shards=2):
    spec = RangeSpec.even(V, num_shards)
    shards = make_shards("tb", spec, full_rows=rows)
    servers = [ShardServer([s]).serve_in_thread() for s in shards]
    clients = [SocketClient(s.endpoint) for s in servers]
    return spec, servers, clients


@pytest.mark.parametrize("action", ["drop", "reset"])
def test_client_retries_through_injected_rpc_fault(action, monkeypatch):
    """`drop` (request swallowed, silent close) and `reset` (RST) both
    surface as transient failures the client retries through — the pull
    succeeds and returns correct rows."""
    fast_retry(monkeypatch)
    rows = rand_rows(V, seed=13)
    spec, servers, clients = _served_table(rows, num_shards=1)
    try:
        assert clients[0].ping()          # connection sane (pre-install)
        faults.install("ps.rpc", action, count=1)  # fires on next rpc
        retries0 = get_registry().counter("ps/rpc_retries").value
        ids = np.array([0, V - 1], dtype=np.int64)
        got = clients[0].pull("tb", ids)  # hit 1 fires, retry hit 2 lands
        np.testing.assert_array_equal(got, rows[ids])
        assert get_registry().counter("ps/rpc_retries").value > retries0
    finally:
        for s in servers:
            s.stop()


def test_slow_shard_delay_injection(monkeypatch):
    fast_retry(monkeypatch)
    rows = rand_rows(V, seed=14)
    spec, servers, clients = _served_table(rows, num_shards=1)
    try:
        faults.install("ps.rpc", "delay_ms", value=120.0, count=1)
        t0 = time.perf_counter()
        ids = np.array([3], dtype=np.int64)
        np.testing.assert_array_equal(clients[0].pull("tb", ids), rows[ids])
        assert time.perf_counter() - t0 >= 0.12
    finally:
        for s in servers:
            s.stop()


def test_server_stop_closes_live_connections_and_joins():
    """stop() must unblock per-connection handler threads stuck in recv()
    and join them (bounded) — no daemon threads holding sockets leak into
    the next test case."""
    srv = ShardServer([EmbeddingShard("tb", 0, V)]).serve_in_thread()
    c = SocketClient(srv.endpoint, retries=0)
    assert c.ping()  # persistent connection now parked in server recv()
    with srv._conn_lock:
        assert len(srv._conns) == 1
    srv.stop()
    with srv._conn_lock:
        assert not srv._conns
    assert not any(t.name.startswith(f"ps-server@{srv.endpoint}")
                   for t in threading.enumerate())
    with pytest.raises(TransportError):
        c.ping()
    c.close()


# ------------------------------------------------------------ torn replies

class _TearingProxy(threading.Thread):
    """TCP proxy that truncates the first reply frame mid-payload and
    closes — the torn-response cell."""

    def __init__(self, upstream: str):
        super().__init__(daemon=True)
        self._up_addr = upstream
        self._lsock = socket.socket()
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(4)
        self.endpoint = "127.0.0.1:%d" % self._lsock.getsockname()[1]
        self.tears_left = 1
        self._stop = False

    def _frame(self, sock: socket.socket) -> bytes:
        hdr = _recv_exact(sock, 4)
        (n,) = struct.unpack("<I", hdr)
        return hdr + _recv_exact(sock, n)

    def run(self):
        while not self._stop:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            host, port = self._up_addr.rsplit(":", 1)
            up = socket.create_connection((host, int(port)))
            try:
                while True:
                    up.sendall(self._frame(conn))     # request through
                    reply = self._frame(up)
                    if self.tears_left > 0:
                        self.tears_left -= 1
                        conn.sendall(reply[:len(reply) // 2])
                        break  # close both: torn frame + dead peer
                    conn.sendall(reply)
            except (ConnectionError, OSError):
                pass
            finally:
                up.close()
                conn.close()

    def stop(self):
        self._stop = True
        try:
            self._lsock.close()
        except OSError:
            pass


def test_torn_reply_frame_resynchronizes(monkeypatch):
    """A reply cut mid-frame is a transient short-read; the client drops
    the dirty connection, reconnects, and re-sends — the pull comes back
    whole and correct."""
    fast_retry(monkeypatch)
    rows = rand_rows(V, seed=15)
    srv = ShardServer(make_shards(
        "tb", RangeSpec.even(V, 1), full_rows=rows)).serve_in_thread()
    proxy = _TearingProxy(srv.endpoint)
    proxy.start()
    c = SocketClient(proxy.endpoint)
    try:
        retries0 = get_registry().counter("ps/rpc_retries").value
        ids = np.array([1, 7, V - 1], dtype=np.int64)
        np.testing.assert_array_equal(c.pull("tb", ids), rows[ids])
        assert proxy.tears_left == 0
        assert get_registry().counter("ps/rpc_retries").value > retries0
    finally:
        c.close()
        proxy.stop()
        srv.stop()


# ------------------------------------------------------------ shard health

def test_shard_monitor_healthz_transitions(monkeypatch):
    """/healthz `ps/shards`: ok → degraded within one sweep of a shard
    dying, failing once down past PDTPU_WEDGE_TIMEOUT, ok again within
    one sweep of recovery; ps/shard_up gauges track it."""
    srv = ShardServer([EmbeddingShard("tb", 0, V)]).serve_in_thread()
    host, port = srv.endpoint.rsplit(":", 1)
    mon = ShardMonitor.for_endpoints([srv.endpoint])
    with mon:  # registers the health check; thread runs but we poll_now
        assert mon.poll_now() == [True]
        overall, checks = run_health_checks()
        assert checks["ps/shards"]["status"] == "ok"
        assert get_registry().gauge("ps/shard_up", shard="0").value == 1.0

        srv.stop()  # shard dies
        assert mon.poll_now() == [False]
        overall, checks = run_health_checks()
        assert overall == "degraded"
        assert checks["ps/shards"]["status"] == "degraded"
        assert "shard 0" in checks["ps/shards"]["detail"]
        assert get_registry().gauge("ps/shard_up", shard="0").value == 0.0

        monkeypatch.setenv("PDTPU_WEDGE_TIMEOUT", "0.05")
        time.sleep(0.1)
        mon.poll_now()
        overall, checks = run_health_checks()
        assert checks["ps/shards"]["status"] == "failing"
        monkeypatch.delenv("PDTPU_WEDGE_TIMEOUT")

        # shard restarts on the same endpoint: ok within one sweep
        srv2 = ShardServer([EmbeddingShard("tb", 0, V)],
                           host=host, port=int(port)).serve_in_thread()
        try:
            assert mon.poll_now() == [True]
            _, checks = run_health_checks()
            assert checks["ps/shards"]["status"] == "ok"
            st = mon.status()
            assert st["status"] == "ok" and st["shards"][0]["up"]
        finally:
            srv2.stop()
    # context exit unregisters the check
    _, checks = run_health_checks()
    assert "ps/shards" not in checks


# --------------------------------------------------------- journal/recovery

def test_recover_shard_replays_journal_in_process():
    """The replay math alone (no sockets): wipe a shard to zeros (what a
    restarted-empty pserver holds), recover from base rows + journal —
    bytes match the never-wiped table, and the JAX package's table given
    the same pushes."""
    rows0 = rand_rows(V, seed=21)
    spec = RangeSpec(V, [0, 17, V])
    table = ShardedTable.build_in_process("tb", spec, full_rows=rows0)
    jtable = jps.ShardedTable.build_in_process(
        "tb", jps.RangeSpec(V, [0, 17, V]), full_rows=rows0)
    mark = table.journal_mark()
    rng = np.random.RandomState(3)
    for seed in (1, 2, 3):
        ids = np.unique(rng.randint(0, V, 6)).astype(np.int64)
        new = rand_rows(ids.size, seed=100 + seed)
        table.push(ids, new)
        jtable.push(ids, new)
    expect = table.dump_full()
    assert table.journal_bytes() == jtable.journal_bytes() > 0
    lo, hi = spec.bounds(1)
    table.clients[1].load("tb", np.zeros((hi - lo, LANES), np.uint16))
    jtable.clients[1].load("tb", np.zeros((hi - lo, LANES), np.uint16))
    assert not np.array_equal(table.dump_full(), expect)
    replayed = table.recover_shard(1, rows0, mark)
    assert replayed >= 1
    assert replayed == jtable.recover_shard(1, rows0, mark)
    np.testing.assert_array_equal(table.dump_full(), expect)
    np.testing.assert_array_equal(jtable.dump_full(), expect)


def test_journal_eviction_blocks_stale_recovery(monkeypatch):
    """Past the size cap the journal evicts oldest entries; a recovery
    whose checkpoint mark predates the eviction horizon must fail loudly
    instead of rebuilding a silently stale shard. The horizon is the JAX
    package's."""
    monkeypatch.setenv("PDTPU_PS_JOURNAL_MAX_MB", "0.002")  # ~2 KiB
    rows0 = rand_rows(V, seed=22)
    table = ShardedTable.build_in_process("tb", RangeSpec.even(V, 1),
                                          full_rows=rows0)
    jtable = jps.ShardedTable.build_in_process("tb", jps.RangeSpec.even(V, 1),
                                               full_rows=rows0)
    for seed in range(6):  # each batch ~4 KiB >> cap: eviction every push
        ids = np.arange(16, dtype=np.int64)
        table.push(ids, rand_rows(16, seed=seed))
        jtable.push(ids, rand_rows(16, seed=seed))
    horizon = table.stats()["journal"]["evicted_upto"]
    assert horizon == jtable.stats()["journal"]["evicted_upto"]
    assert horizon[0] > 0
    with pytest.raises(RuntimeError, match="evicted"):
        table.recover_shard(0, rows0, 0)


def test_checkpoint_commit_truncates_journal(tmp_path):
    """Durability contract: journal entries survive until the checkpoint
    containing them COMMITS, then truncate; restore re-anchors the
    journal at the checkpoint's mark."""
    main, startup = tiny_program()
    rows0 = rand_rows(V, seed=23)
    table = ShardedTable.build_in_process("tb", RangeSpec.even(V, 2),
                                          full_rows=rows0)
    exe = tfluid.Executor(tfluid.CPUPlace())
    sc = tfluid.Scope()
    exe.run(startup, scope=sc)
    ids = np.array([0, 30], dtype=np.int64)
    table.push(ids, rand_rows(2, seed=5))
    assert table.stats()["journal"]["entries"] == 2  # one per shard
    ck = Checkpointer(str(tmp_path))
    ck.save(1, program=main, scope=sc, blocking=True,
            ps_tables={"tb": table})
    assert table.stats()["journal"]["entries"] == 0  # commit truncated
    saved = table.dump_full()
    mark = table.journal_mark()
    table.push(ids, rand_rows(2, seed=6))
    assert table.stats()["journal"]["entries"] == 2
    assert ck.restore(program=main, scope=sc, ps_tables={"tb": table},
                      place=tfluid.CPUPlace()) == 1
    st = table.stats()["journal"]
    assert st["entries"] == 0 and table.journal_mark() >= mark
    # and the shard bytes are back to the checkpointed state
    np.testing.assert_array_equal(table.dump_full(), saved)
    # load_ps_table: the recovery read path sees the same bytes + mark
    full, rmark, step = ck.load_ps_table("tb")
    assert step == 1 and rmark == 1
    np.testing.assert_array_equal(full, table.dump_full())


# --------------------------------------------------- SIGKILL chaos (flagship)

def run_chaos_training(tmp_path, feeds_, kill_step, pull_ahead, push_depth,
                       delay_ms=0.0, hot_rows=0):
    """Training over two runner pservers that SIGKILLs shard 1 before
    step `kill_step` and restarts it (same port) 0.3 s later. Returns
    (losses, final rows, recoveries)."""
    spec = RangeSpec.even(V, 2)
    procs, eps = [], []
    for i in range(2):
        lo, hi = spec.bounds(i)
        p, ep = launch_pserver([f"tb:{lo}:{hi}"], delay_ms=delay_ms)
        procs.append(p)
        eps.append(ep)
    table = ShardedTable("tb", spec, [SocketClient(ep) for ep in eps])
    reg = get_registry()
    recov0 = reg.counter("ps/recoveries").value
    restarter = []

    def on_step(step):
        if step != kill_step:
            return
        procs[1].kill()   # SIGKILL: a real preemption
        procs[1].wait(timeout=30)
        lo1, hi1 = spec.bounds(1)
        port1 = int(eps[1].rsplit(":", 1)[1])

        def _restart():
            time.sleep(0.3)
            p, _ = launch_pserver([f"tb:{lo1}:{hi1}"], port=port1,
                                  delay_ms=delay_ms)
            procs.append(p)

        t = threading.Thread(target=_restart, daemon=True)
        t.start()
        restarter.append(t)

    try:
        table.load_full(init_packed())
        ck = Checkpointer(str(tmp_path / "ck"))
        losses, final = ps_run(feeds_, table, pull_ahead, push_depth,
                               hot_rows=hot_rows, on_step=on_step, ck=ck,
                               save_base=True)
        return losses, final, reg.counter("ps/recoveries").value - recov0
    finally:
        for t in restarter:
            t.join(timeout=10.0)
        stop_all(procs)


@pytest.fixture(scope="module")
def ref():
    fd = feeds()
    losses, final = packed_baseline(fd)
    return fd, losses, final


def test_sigkill_pserver_recovery_bitwise(tmp_path, monkeypatch, ref):
    """The acceptance cell: SIGKILL one socket pserver mid-run at
    staleness 0, let the tier recover (checkpoint slice + journal
    replay), finish — losses AND final table bytes bitwise-identical to
    the uninterrupted run, no worker crash, >= 1 recovery counted, and
    the fault-tier metrics visible in /metrics."""
    fast_retry(monkeypatch)
    fd, ref_losses, ref_final = ref
    losses, final, recoveries = run_chaos_training(
        tmp_path, fd, kill_step=5, pull_ahead=1, push_depth=0)
    assert losses == ref_losses
    np.testing.assert_array_equal(final, ref_final)
    assert recoveries >= 1
    text = get_registry().prometheus_text()
    for metric in ("ps_rpc_retries", "ps_recoveries", "ps_recovered_batches",
                   "ps_journal_bytes"):
        assert metric in text, f"{metric} missing from /metrics"


@pytest.mark.slow
def test_sigkill_recovery_with_async_push_and_rtt(tmp_path, monkeypatch,
                                                  ref):
    """Soak variant: same kill, but with the async pusher (push_depth 1),
    deeper prefetch, and simulated per-request RTT."""
    fast_retry(monkeypatch)
    fd, ref_losses, ref_final = ref
    losses, final, recoveries = run_chaos_training(
        tmp_path, fd, kill_step=4, pull_ahead=2, push_depth=1,
        delay_ms=2.0)
    assert losses == ref_losses
    np.testing.assert_array_equal(final, ref_final)
    assert recoveries >= 1


@pytest.mark.slow
@pytest.mark.parametrize("spec_str", ["ps.rpc:drop@7", "ps.rpc:reset@11",
                                      "ps.rpc:delay_ms=40@5"])
def test_injected_rpc_chaos_training_bitwise(spec_str, monkeypatch, ref):
    """Soak variant: socket training with server-side ps.rpc injections
    at fixed hit counts — every cell finishes bitwise equal to the
    single-table run (transport retries alone carry it)."""
    fast_retry(monkeypatch)
    fd, ref_losses, ref_final = ref
    for rule in faults.parse_spec(spec_str):
        faults.install(rule.site, rule.action, rule.value, rule.count)
    spec = RangeSpec.even(V, 2)
    shards = make_shards("tb", spec, full_rows=init_packed())
    servers = [ShardServer([s]).serve_in_thread() for s in shards]
    table = ShardedTable("tb", spec,
                         [SocketClient(s.endpoint) for s in servers])
    try:
        losses, final = ps_run(fd, table, 1, 0)
    finally:
        for s in servers:
            s.stop()
    assert losses == ref_losses
    np.testing.assert_array_equal(final, ref_final)


def test_in_process_recovery_reads_a_checkpoint_the_jax_package_wrote(
        tmp_path, ref):
    """The recovery base may come from either package: a shard wiped
    mid-run (in-process) is rebuilt from a JAX-written full save plus the
    port's journal, and the run stays bitwise."""
    from paddle_tpu.parallel import Checkpointer as JCheckpointer
    import paddle_tpu as jfluid

    fd, ref_losses, ref_final = ref
    table = in_process_table(RangeSpec.even(V, 2))
    jt = jps.ShardedTable.build_in_process("tb", jps.RangeSpec.even(V, 2),
                                           full_rows=init_packed())
    with jfluid.scope_guard(jfluid.Scope()):
        JCheckpointer(str(tmp_path)).save(0, program=jfluid.Program(),
                                          ps_tables={"tb": jt},
                                          blocking=True)
    ck = Checkpointer(str(tmp_path))
    lo, hi = table.spec.bounds(1)

    def on_step(step):
        if step == 6:
            table.clients[1].load("tb", np.zeros((hi - lo, LANES),
                                                 np.uint16))
            full, mark, _ = ck.load_ps_table("tb")
            assert mark == 0
            table.recover_shard(1, full, mark)

    losses, final = ps_run(fd, table, 0, 0, on_step=on_step)
    assert losses == ref_losses
    np.testing.assert_array_equal(final, ref_final)
