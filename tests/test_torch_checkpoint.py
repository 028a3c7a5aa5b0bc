"""The port's checkpoints (``paddle_tpu_torch.parallel.Checkpointer``) on the
CPU: twins of ``tests/test_checkpoint.py`` that need no mesh, checkpoints
crossing between the two packages bitwise (both directions, both bundle
backends, an f32 and a bf16 variable), a JAX mesh run's two-rank shard
layout restored by the port, the generator rules of ``@rng@`` and the
snapshot isolation that in-place updates require.

The mesh tests of the JAX file (``test_save_dp8_restore_dp4tp2_loss_
continuity``, ``test_shard_parallel_checkpoint_across_process_counts``)
need a multi-device mesh: they come with ROADMAP A9."""
import os
import pickle
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from _torch_twin import alarm_timeout, fresh_port_state
from paddle_tpu.parallel import Checkpointer as JCheckpointer
from paddle_tpu_torch import faults, native
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.parallel import (Checkpointer, load_checkpoint,
                                       save_checkpoint)

torch.set_num_threads(1)
CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


@pytest.fixture(autouse=True)
def _time_limit():
    """The checkpointer writes on a thread: a hang fails the test."""
    yield from alarm_timeout(60)


def _build():
    from paddle_tpu_torch.initializer import NumpyArrayInitializer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1], dtype="int64")
        w0 = np.random.RandomState(5).rand(16, 8).astype("float32") * 0.1
        h = fluid.layers.fc(
            x, 8, act="relu", bias_attr=False,
            param_attr=fluid.ParamAttr(name="w0",
                                       initializer=NumpyArrayInitializer(w0)))
        w1 = np.random.RandomState(6).rand(8, 4).astype("float32") * 0.1
        logits = fluid.layers.fc(
            h, 4, bias_attr=False,
            param_attr=fluid.ParamAttr(name="w1",
                                       initializer=NumpyArrayInitializer(w1)))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(0.05).minimize(loss)
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.randint(0, 4, (32, 1)).astype("int64")}
    return main, startup, feed, loss


def _w0():
    return fluid.global_scope().find_np("w0")


def test_async_save_preemption_safe(tmp_path):
    """The latest marker only moves once the bundle is durable; repeated
    saves keep at most `keep` bundles."""
    main, startup, feed, loss = _build()
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        for s in range(1, 5):
            exe.run(main, feed=feed, fetch_list=[loss])
            ck.save(s, program=main)   # async — overlaps next step
        ck.wait()
    assert ck.latest_step() == 4
    assert sorted(ck.all_steps()) == [3, 4]
    assert not any(f.name.endswith(".tmp") for f in (tmp_path / "ck").iterdir())


def test_functional_roundtrip(tmp_path):
    main, startup, feed, loss = _build()
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        save_checkpoint(str(tmp_path / "f"), 1, program=main)
        w_saved = _w0()
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        step = load_checkpoint(str(tmp_path / "f"), program=main, place=CPU)
        assert step == 1
        np.testing.assert_array_equal(_w0(), w_saved)


def test_checkpoint_resumes_rng_stream(tmp_path):
    """Dropout after restore continues the saved stream of the port's own
    generator (``@rng_impl@`` torch:cpu), bitwise the uninterrupted run."""
    def build():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            main.random_seed = startup.random_seed = 5
            x = fluid.layers.data("x", [8])
            h = fluid.layers.dropout(
                x, 0.5, dropout_implementation="upscale_in_train")
            loss = fluid.layers.reduce_mean(h)
        return main, startup, loss

    feed = {"x": np.ones((4, 8), "float32")}
    main, startup, loss = build()
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        ref = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
               for _ in range(6)]

    ck = Checkpointer(str(tmp_path / "rng"))
    main, startup, loss = build()
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        got_a = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                 for _ in range(3)]
        ck.save(3, program=main, blocking=True)
    main2, startup2, loss2 = build()
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup2)
        ck.restore(program=main2, place=CPU)
        got_b = [float(exe.run(main2, feed=feed, fetch_list=[loss2])[0])
                 for _ in range(3)]
    assert got_a + got_b == ref
    assert len(set(ref)) > 1  # the masks differ step to step


def test_native_bundle_backend(tmp_path):
    """Checkpoints ride the port's own g++-built bundle writer: .ptck files
    on disk, identical restore semantics, pickle interop preserved."""
    assert native.available(), native.build_error()
    main, startup, feed, loss = _build()
    ck = Checkpointer(str(tmp_path / "nk"))
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        ck.save(3, program=main, blocking=True)
        l1 = float(exe.run(main, feed=feed, fetch_list=[loss])[0])
    assert "ckpt-3.ptck" in os.listdir(tmp_path / "nk")

    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        assert ck.restore(program=main, place=CPU) == 3
        l1b = float(exe.run(main, feed=feed, fetch_list=[loss])[0])
    assert l1b == l1

    # a legacy pickle checkpoint in the same dir still restores
    w = np.random.RandomState(0).rand(16, 8).astype("float32")
    with open(tmp_path / "nk" / "ckpt-9.pkl", "wb") as f:
        pickle.dump({"step": 9, "vars": {"w0": w}}, f)
    (tmp_path / "nk" / "latest").write_text("9")
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        assert ck.restore(program=main, place=CPU) == 9
        np.testing.assert_array_equal(_w0(), w)


def _jax_shard_layout(dirname, step, w_full, w1):
    """A JAX mesh run's two-rank layout of `w0` (rows split across ranks)
    written through the JAX package's own writer from numpy shard records:
    rank 1's shard file first, then rank 0's with the bundle, its manifest
    naming the sharded var, and the marker."""
    ck = JCheckpointer(dirname)
    half = w_full.shape[0] // 2
    shape = tuple(w_full.shape)
    recs = [("w0", ((0, half), (0, shape[1])), shape, "float32",
             w_full[:half]),
            ("w0", ((half, shape[0]), (0, shape[1])), shape, "float32",
             w_full[half:])]
    ck._write_impl(step, {}, [recs[1]], 1)
    ck._write_impl(step, {"w1": w1,
                          "@shard_manifest@": np.asarray("w0")},
                   [recs[0]], 0)
    return ck


def test_two_rank_shard_layout_restores(tmp_path):
    """A checkpoint a JAX mesh run wrote (per-rank shard files and index
    JSON) assembles into the full tensor in the port."""
    main, startup, feed, loss = _build()
    w_full = np.random.RandomState(1).randn(16, 8).astype("float32")
    w1 = np.random.RandomState(2).randn(8, 4).astype("float32")
    _jax_shard_layout(str(tmp_path / "sh"), 5, w_full, w1)
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        assert Checkpointer(str(tmp_path / "sh")).restore(
            program=main, place=CPU) == 5
        np.testing.assert_array_equal(_w0(), w_full)
        np.testing.assert_array_equal(
            fluid.global_scope().find_np("w1"), w1)


def test_restore_raises_on_missing_rank_shard_files(tmp_path):
    """A var whose shard/index files are entirely missing fails restore
    loudly (manifest check), not silently keeping its init values."""
    main, startup, feed, loss = _build()
    w_full = np.random.RandomState(1).randn(16, 8).astype("float32")
    w1 = np.random.RandomState(2).randn(8, 4).astype("float32")
    _jax_shard_layout(str(tmp_path / "mk"), 5, w_full, w1)
    removed = 0
    for f in os.listdir(tmp_path / "mk"):
        if ".shards-" in f or ".index-" in f:
            os.remove(tmp_path / "mk" / f)
            removed += 1
    assert removed >= 2  # shard pkl + index json existed
    ck = Checkpointer(str(tmp_path / "mk"))
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        with pytest.raises(RuntimeError, match="manifest"), \
                pytest.warns(RuntimeWarning):
            ck.restore(program=main, place=CPU)


def test_latest_step_tolerates_torn_marker(tmp_path):
    main, startup, feed, loss = _build()
    ck = Checkpointer(str(tmp_path / "tm"))
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        ck.save(3, program=main, blocking=True)

    marker = tmp_path / "tm" / "latest"
    marker.write_text("")  # torn: zero bytes made it durable
    assert ck.latest_step() == 3
    marker.write_text("4x7\x00")  # garbled
    assert ck.latest_step() == 3
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        assert ck.restore(program=main, place=CPU) == 3


def test_corrupt_bundle_falls_back_with_warning_and_counter(tmp_path):
    main, startup, feed, loss = _build()
    ck = Checkpointer(str(tmp_path / "cb"))
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        ck.save(2, program=main, blocking=True)
        w_at_2 = _w0()
        exe.run(main, feed=feed, fetch_list=[loss])
        ck.save(4, program=main, blocking=True)

    bundle = ck._existing_path(4)
    with open(bundle, "r+b") as f:
        f.seek(os.path.getsize(bundle) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))

    fallback = get_registry().counter("checkpoint/fallback_steps")
    before = fallback.value
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        with pytest.warns(RuntimeWarning, match="ckpt-4"):
            assert ck.restore(program=main, place=CPU) == 2
        np.testing.assert_array_equal(_w0(), w_at_2)
    assert fallback.value == before + 1

    # an explicitly requested corrupt step is NEVER silently substituted
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        with pytest.raises(RuntimeError, match="sha256 mismatch"), \
                pytest.warns(RuntimeWarning):
            ck.restore(step=4, program=main, place=CPU)


def test_writer_retries_transient_io_failure(tmp_path, monkeypatch):
    monkeypatch.setenv("PDTPU_CKPT_RETRY_BACKOFF_MS", "1")
    retries = get_registry().counter("checkpoint/write_retries")
    before = retries.value
    main, startup, feed, loss = _build()
    ck = Checkpointer(str(tmp_path / "rt"))
    faults.clear()
    faults.install("ckpt.bundle_write", "raise", count=1)
    try:
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(CPU)
            exe.run(startup)
            exe.run(main, feed=feed, fetch_list=[loss])
            ck.save(3, program=main, blocking=True)  # wait() must NOT raise
    finally:
        faults.clear()
    assert retries.value == before + 1
    assert ck.latest_step() == 3
    assert ck.verify(3) == []
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        assert ck.restore(program=main, place=CPU) == 3


def test_wait_error_names_step_and_path(tmp_path, monkeypatch):
    monkeypatch.setenv("PDTPU_CKPT_RETRIES", "1")
    monkeypatch.setenv("PDTPU_CKPT_RETRY_BACKOFF_MS", "1")
    main, startup, feed, loss = _build()
    ck = Checkpointer(str(tmp_path / "we"))
    faults.clear()
    faults.install("ckpt.bundle_write", "raise")  # persistent: every attempt
    try:
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(CPU)
            exe.run(startup)
            exe.run(main, feed=feed, fetch_list=[loss])
            with pytest.raises(
                    RuntimeError,
                    match=r"step 7 .*ckpt-7.* after 2 attempts") as ei:
                ck.save(7, program=main, blocking=True)
            assert isinstance(ei.value.__cause__, faults.InjectedFault)
    finally:
        faults.clear()


def test_fault_point_takes_a_path_and_fires_a_raise_rule(tmp_path):
    """The port's probe takes the JAX package's signature,
    ``fault_point(site, path=None)``; a ``raise`` rule fires through it."""
    faults.clear()
    faults.install("ckpt.marker", "raise", count=2)
    try:
        faults.fault_point("ckpt.marker", path=str(tmp_path / "latest.tmp"))
        with pytest.raises(faults.InjectedFault, match="ckpt.marker"):
            faults.fault_point("ckpt.marker",
                               path=str(tmp_path / "latest.tmp"))
        faults.fault_point("ckpt.marker")  # one shot: spent
    finally:
        faults.clear()


# -- across the two packages ---------------------------------------------

W = np.random.RandomState(3).randn(6, 5).astype("float32")
E = np.random.RandomState(4).randn(4, 8).astype("float32").astype(
    ml_dtypes.bfloat16)


def _vars_program(pkg):
    prog = pkg.Program()
    blk = prog.global_block()
    blk.create_var(name="w", shape=[6, 5], dtype="float32", persistable=True)
    blk.create_var(name="e", shape=[4, 8], dtype="bfloat16",
                   persistable=True)
    return prog


def _backend(monkeypatch, ptck):
    """Both packages' writers pick .ptck when their native library is
    available, else pickle."""
    if not ptck:
        import paddle_tpu.native as jnative
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("ptck", [True, False], ids=["ptck", "pickle"])
def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path, monkeypatch,
                                                     ptck):
    _backend(monkeypatch, ptck)
    prog = _vars_program(jfluid)
    sc = jfluid.Scope()
    sc.set_var("w", jnp.asarray(W))
    sc.set_var("e", jnp.asarray(E))
    JCheckpointer(str(tmp_path / "x")).save(2, program=prog, scope=sc,
                                            blocking=True)
    assert any(f.endswith(".ptck" if ptck else ".pkl")
               for f in os.listdir(tmp_path / "x"))
    tsc = fluid.Scope()
    got = Checkpointer(str(tmp_path / "x")).restore(
        program=_vars_program(fluid), scope=tsc, place=CPU)
    assert got == 2
    assert tsc.find_var("e").dtype == torch.bfloat16
    np.testing.assert_array_equal(tsc.find_np("w"), W)
    np.testing.assert_array_equal(_bits(tsc.find_np("e")), _bits(E))


@pytest.mark.parametrize("ptck", [True, False], ids=["ptck", "pickle"])
def test_port_checkpoint_restores_in_jax_bitwise(tmp_path, monkeypatch,
                                                 ptck):
    _backend(monkeypatch, ptck)
    tsc = fluid.Scope()
    tsc.set_var("w", torch.from_numpy(W.copy()))
    tsc.set_var("e", torch.from_numpy(E.view(np.uint16).copy()).view(
        torch.bfloat16))
    Checkpointer(str(tmp_path / "y")).save(3, program=_vars_program(fluid),
                                           scope=tsc, blocking=True)
    assert any(f.endswith(".ptck" if ptck else ".pkl")
               for f in os.listdir(tmp_path / "y"))
    sc = jfluid.Scope()
    got = JCheckpointer(str(tmp_path / "y")).restore(
        program=_vars_program(jfluid), scope=sc)
    assert got == 3
    np.testing.assert_array_equal(np.asarray(sc.find_var("w")), W)
    e = np.asarray(sc.find_var("e"))
    assert e.dtype.name == "bfloat16"
    np.testing.assert_array_equal(_bits(e), _bits(E))


def test_jax_key_in_rng_warns_and_keeps_the_port_generator(tmp_path):
    prog = _vars_program(jfluid)
    sc = jfluid.Scope()
    sc.set_var("w", jnp.asarray(W))
    sc.set_var("e", jnp.asarray(E))
    sc.set_var("@RNG_STATE@", jax.random.key(7))
    JCheckpointer(str(tmp_path / "k")).save(1, program=prog, scope=sc,
                                            blocking=True)
    tsc = fluid.Scope()
    gen = torch.Generator("cpu").manual_seed(11)
    tsc.set_var("@RNG_STATE@", gen)
    state = gen.get_state().clone()
    with pytest.warns(RuntimeWarning, match="threefry.*torch:cpu") as rec:
        Checkpointer(str(tmp_path / "k")).restore(
            program=_vars_program(fluid), scope=tsc, place=CPU)
    assert len([w for w in rec if "random state" in str(w.message)]) == 1
    assert tsc.find_var("@RNG_STATE@") is gen
    assert torch.equal(gen.get_state(), state)
    np.testing.assert_array_equal(tsc.find_np("w"), W)  # vars still load


def test_snapshot_isolation_under_in_place_updates(tmp_path):
    """save(), then an in-place update of the scope's tensors (as the
    port's optimizers make), then wait(): the bundle holds the values from
    before the update."""
    main, startup, feed, loss = _build()
    ck = Checkpointer(str(tmp_path / "iso"))
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        before = {n: fluid.global_scope().find_np(n) for n in ("w0", "w1")}
        ck.save(1, program=main)
        with torch.no_grad():
            for n in ("w0", "w1"):
                fluid.global_scope().find_var(n).add_(1.0)
        ck.wait()
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        ck.restore(program=main, place=CPU)
        for n, v in before.items():
            np.testing.assert_array_equal(fluid.global_scope().find_np(n), v)


def test_restore_takes_the_bytes_in_place_and_keeps_extra(tmp_path):
    """A value already in the scope with the same shape and dtype takes
    the restored bytes in place; ``@dataio@*`` extras come back in
    ``last_extra``."""
    main, startup, feed, loss = _build()
    ck = Checkpointer(str(tmp_path / "ip"))
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        saved = _w0()
        ck.save(2, program=main, blocking=True,
                extra={"@dataio@epoch": 1, "@dataio@cursor": 5})
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        live = fluid.global_scope().find_var("w0")
        ck.restore(program=main, place=CPU)
        assert fluid.global_scope().find_var("w0") is live
        np.testing.assert_array_equal(live.numpy(), saved)
    assert {k: int(np.asarray(v).reshape(-1)[0])
            for k, v in ck.last_extra.items()} == {
                "@dataio@epoch": 1, "@dataio@cursor": 5}


def test_restore_with_no_gpu_and_no_place_raises(tmp_path, monkeypatch):
    main, startup, feed, loss = _build()
    ck = Checkpointer(str(tmp_path / "ng"))
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        ck.save(1, program=main, blocking=True)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            ck.restore(program=main)


def test_ps_table_checkpoints_roundtrip_with_the_jax_files(tmp_path):
    """``save(ps_tables=)``, ``save_delta`` and ``restore(ps_tables=)``:
    the port writes the JAX package's PS files (the JAX Checkpointer
    restores them bitwise onto another shard count), reads them back
    itself, and ``load_ps_table`` composes the full save with its delta.
    With no checkpoint at all, a restore returns None without a
    warning."""
    import paddle_tpu.ps as jps
    from paddle_tpu.parallel import Checkpointer as JCheckpointer
    from paddle_tpu_torch.ps import RangeSpec, ShardedTable

    ck = Checkpointer(str(tmp_path / "ps"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ck.restore(program=fluid.Program(), place=CPU) is None
    rows = np.random.RandomState(9).randint(
        0, 2 ** 16, (40, 128)).astype(np.uint16)
    t = ShardedTable.build_in_process("t", RangeSpec.even(40, 2),
                                      full_rows=rows)
    ck.save(1, program=fluid.Program(), scope=fluid.Scope(),
            ps_tables={"t": t}, blocking=True)
    t.push(np.array([2, 33], np.int64), rows[[5, 6]])
    ck.save_delta(2, {"t": t}, blocking=True)
    want = t.dump_full()
    back = ShardedTable.build_in_process("t", RangeSpec.even(40, 3))
    assert ck.restore(program=fluid.Program(), scope=fluid.Scope(),
                      ps_tables={"t": back}, place=CPU) == 1
    np.testing.assert_array_equal(back.dump_full(), want)
    full, mark, step = ck.load_ps_table("t")
    assert (mark, step) == (t.journal_mark(), 1)
    np.testing.assert_array_equal(full, want)
    jt = jps.ShardedTable.build_in_process("t", jps.RangeSpec(40, [0, 9, 40]))
    import paddle_tpu as jfluid
    with jfluid.scope_guard(jfluid.Scope()):
        assert JCheckpointer(str(tmp_path / "ps")).restore(
            program=jfluid.Program(), ps_tables={"t": jt}) == 1
    np.testing.assert_array_equal(jt.dump_full(), want)
