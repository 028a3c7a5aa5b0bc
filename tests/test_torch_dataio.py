"""The port's input pipeline on the CPU: twins of ``tests/test_dataio.py``'s
``TestDeviceLoader``, ``TestTrainFromDataset``, ``TestPyReader`` and
``TestDeviceLoaderResume`` over ``paddle_tpu_torch.dataio.DeviceLoader``
(``CPUPlace()``: CPU tensors, no stream), and the rule that a loader, a
double-buffered PyReader and the drivers raise where there is no GPU and
no place. ``TestFetchHandle``, ``TestCheckNanInf`` and the flags twin live
in ``test_torch_fetch_handle.py`` and ``test_torch_flags.py``; the two
compile-cache tests wait for ROADMAP A2 item 2."""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from _torch_twin import alarm_timeout, fresh_port_state
from paddle_tpu_torch.dataio import DeviceLoader
from paddle_tpu_torch.observability import get_registry

torch.set_num_threads(1)
CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


@pytest.fixture(autouse=True)
def _time_limit():
    """Every test here starts a loader thread: a hang fails the test."""
    yield from alarm_timeout(60)


def _batches(n, batch=2, dim=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(batch, dim).astype("float32")} for _ in range(n)]


def _no_loader_threads():
    return [t for t in threading.enumerate() if t.name.startswith("pdtpu-")
            and t.name != "pdtpu-ckpt-writer"]


def _build_sgd(dim=4):
    x = fluid.layers.data("x", [dim])
    h = fluid.layers.fc(x, 8, act="relu")
    loss = fluid.layers.mean(fluid.layers.fc(h, 3))
    fluid.optimizer.SGD(0.1).minimize(loss)
    return loss


def _loader(reader, capacity=2, **kw):
    return DeviceLoader(reader, capacity=capacity, place=CPU, **kw)


class TestDeviceLoader:
    def test_prefetch_preserves_order(self):
        data = [{"x": np.full((2, 4), i, "float32")} for i in range(20)]

        def jittery():
            rng = np.random.RandomState(3)
            for b in data:
                time.sleep(float(rng.uniform(0, 0.002)))
                yield b

        got = [float(b["x"].mean()) for b in _loader(jittery, 3)]
        assert got == [float(i) for i in range(20)]

    def test_yields_device_arrays(self):
        feeds = _batches(2)
        got = list(_loader(lambda: iter(feeds)))
        for b, want in zip(got, feeds):
            assert isinstance(b["x"], torch.Tensor)
            assert b["x"].device.type == "cpu"
            np.testing.assert_array_equal(b["x"].numpy(), want["x"])

    def test_reader_exception_reraises_in_consumer(self):
        def bad():
            yield {"x": np.zeros((2, 4), "float32")}
            yield {"x": np.zeros((2, 4), "float32")}
            raise ValueError("reader blew up")

        loader = _loader(bad)
        seen = 0
        with pytest.raises(ValueError, match="reader blew up"):
            for _ in loader:
                seen += 1
        assert seen == 2
        assert not loader.running
        assert _no_loader_threads() == []

    def test_exhaustion_leaves_no_threads(self):
        list(_loader(lambda: iter(_batches(5))))
        assert _no_loader_threads() == []

    def test_midepoch_break_then_close(self):
        def slow():
            for b in _batches(100):
                time.sleep(0.001)
                yield b

        loader = _loader(slow)
        for i, _ in enumerate(loader):
            if i == 3:
                break
        loader.close()
        loader.close()  # idempotent
        assert not loader.running
        assert _no_loader_threads() == []

    def test_reiteration_is_a_fresh_epoch(self):
        loader = _loader(lambda: iter(_batches(4)))
        assert len(list(loader)) == 4
        assert len(list(loader)) == 4

    def test_close_from_other_thread_unblocks_consumer(self):
        def endless():
            i = 0
            while True:
                yield {"x": np.full((1,), i, "float32")}
                i += 1

        loader = _loader(endless)
        it = iter(loader)
        next(it)
        threading.Timer(0.05, loader.close).start()
        for _ in it:
            pass
        assert not loader.running

    def test_capacity_validation(self):
        with pytest.raises(ValueError, match="capacity"):
            _loader(lambda: iter([]), capacity=0)

    def test_feed_validation_applies_in_worker(self):
        fluid.layers.data("x", [4])
        prog = fluid.default_main_program()
        loader = _loader(lambda: iter([{"x": np.zeros((2, 5), "float32")}]),
                         program=prog)
        with pytest.raises(ValueError, match="shape mismatch"):
            list(loader)

    def test_declared_dtype_applies_in_worker(self):
        """The worker converts each feed to its declared dtype on the
        host, as a synchronous run does."""
        fluid.layers.data("ids", [3], dtype="int64")
        prog = fluid.default_main_program()
        ids = np.arange(6, dtype="int32").reshape(2, 3)
        (b,) = list(_loader(lambda: iter([{"ids": ids}]), program=prog))
        assert b["ids"].dtype == torch.int64
        np.testing.assert_array_equal(b["ids"].numpy(), ids)

    def test_telemetry_populated(self):
        list(_loader(lambda: iter(_batches(3))))
        snap = get_registry().snapshot()
        assert snap["dataio/batches"] >= 3
        assert snap["dataio/h2d_ms"]["count"] >= 3
        assert "dataio/last_h2d_ms" in snap
        assert "dataio/prefetch_queue_depth" in snap

    def test_loader_next_probe_fires_in_the_worker(self):
        from paddle_tpu_torch import faults
        faults.clear()
        faults.install("loader.next", "raise", count=2)
        try:
            loader = _loader(lambda: iter(_batches(4)))
            got = 0
            with pytest.raises(faults.InjectedFault, match="loader.next"):
                for _ in loader:
                    got += 1
            assert got == 1
        finally:
            faults.clear()


class _FakeDataset:
    """Anything with batches()/set_thread() drives train_from_dataset."""

    def __init__(self, data):
        self.data = data

    def set_thread(self, n):
        pass

    def batches(self):
        for b in self.data:
            # extra key not declared by the program must be filtered out
            yield dict(b, junk=np.zeros(3))


class TestTrainFromDataset:
    def test_inflight_2_matches_inflight_1(self):
        loss = _build_sgd()
        exe = fluid.Executor(CPU)
        data = _batches(7, seed=11)

        def arm(inflight):
            old = fluid.get_flags("max_inflight_steps")
            fluid.set_flags({"max_inflight_steps": inflight})
            try:
                with fluid.scope_guard(fluid.Scope()):
                    exe.run(fluid.default_startup_program())
                    out = exe.train_from_dataset(
                        dataset=_FakeDataset(data), fetch_list=[loss])
                    return out, fluid.global_scope().find_np(
                        fluid.default_main_program().all_parameters()[0].name)
            finally:
                fluid.set_flags(old)

        (a, wa), (b, wb) = arm(1), arm(2)
        assert np.array_equal(a[0], b[0])
        assert np.array_equal(wa, wb)
        assert _no_loader_threads() == []

    def test_matches_plain_runs(self):
        """The loader-fed loop is bitwise the plain loop on numpy feeds."""
        loss = _build_sgd()
        exe = fluid.Executor(CPU)
        data = _batches(5, seed=4)
        main = fluid.default_main_program()
        with fluid.scope_guard(fluid.Scope()):
            exe.run(fluid.default_startup_program())
            for f in data:
                (want,) = exe.run(main, feed=f, fetch_list=[loss])
        with fluid.scope_guard(fluid.Scope()):
            exe.run(fluid.default_startup_program())
            (got,) = exe.train_from_dataset(dataset=_FakeDataset(data),
                                            fetch_list=[loss])
        assert np.array_equal(got, want)

    def test_no_fetch_list(self):
        _build_sgd()
        exe = fluid.Executor(CPU)
        exe.run(fluid.default_startup_program())
        out = exe.train_from_dataset(dataset=_FakeDataset(_batches(3)))
        assert out == []

    def test_empty_dataset_returns_none(self):
        _build_sgd()
        exe = fluid.Executor(CPU)
        exe.run(fluid.default_startup_program())
        assert exe.train_from_dataset(dataset=_FakeDataset([])) is None

    def test_infer_from_dataset_runs_the_test_clone(self):
        """The same loop over ``program.clone(for_test=True)``: a forward
        program's last fetch equals a plain run of the last batch."""
        x = fluid.layers.data("x", [4])
        loss = fluid.layers.mean(fluid.layers.dropout(
            fluid.layers.fc(x, 3), 0.5))
        exe = fluid.Executor(CPU)
        exe.run(fluid.default_startup_program())
        data = _batches(3, seed=2)
        (got,) = exe.infer_from_dataset(dataset=_FakeDataset(data),
                                        fetch_list=[loss])
        test_prog = fluid.default_main_program().clone(for_test=True)
        (want,) = exe.run(test_prog, feed=data[-1], fetch_list=[loss])
        assert np.array_equal(got, want)

    def test_executor_close_sweeps_loaders(self):
        exe = fluid.Executor(CPU)
        loader = _loader(lambda: iter(_batches(50)))
        loader.start()
        exe._loaders.add(loader)
        assert loader.running
        exe.close()
        assert not loader.running


class TestPyReader:
    def _gen(self, n=5):
        def gen():
            for i in range(n):
                yield [(np.full(4, i, "float32"),) for _ in range(2)]
        return gen

    def test_double_buffer_yields_device_batches_in_order(self):
        x = fluid.layers.data("x", [4])
        r = fluid.PyReader(feed_list=[x], capacity=8, use_double_buffer=True,
                           place=CPU)
        r.decorate_sample_list_generator(self._gen())
        vals = []
        for feed in r():
            assert isinstance(feed["x"], torch.Tensor)
            vals.append(float(feed["x"].mean()))
        assert vals == [0.0, 1.0, 2.0, 3.0, 4.0]
        assert _no_loader_threads() == []

    def test_double_buffer_matches_plain(self):
        x = fluid.layers.data("x", [4])
        loss = fluid.layers.mean(fluid.layers.fc(x, 3))
        exe = fluid.Executor(CPU)

        def arm(db):
            r = fluid.PyReader(feed_list=[x], capacity=8,
                               use_double_buffer=db)
            r.decorate_sample_list_generator(self._gen(), places=[CPU])
            with fluid.scope_guard(fluid.Scope()):
                exe.run(fluid.default_startup_program())
                return [exe.run(feed=f, fetch_list=[loss])[0] for f in r()]

        a, b = arm(False), arm(True)
        assert len(a) == len(b) == 5
        for u, v in zip(a, b):
            assert np.array_equal(u, v)

    def test_reset_tears_down_prefetch_thread(self):
        x = fluid.layers.data("x", [4])
        r = fluid.PyReader(feed_list=[x], capacity=8, use_double_buffer=True,
                           place=CPU)
        r.decorate_sample_list_generator(self._gen(100))
        it = r()
        next(it)
        assert r._loader is not None and r._loader.running
        r.reset()
        r.reset()  # idempotent
        assert r._loader is None
        assert _no_loader_threads() == []

    def test_undecorated_reader_raises(self):
        r = fluid.PyReader(feed_list=[], capacity=4, place=CPU)
        with pytest.raises(RuntimeError, match="decorate"):
            r()

    def test_layers_py_reader_constructs(self):
        r = fluid.layers.py_reader(4, [[4]], ["float32"], place=CPU)
        assert isinstance(r, fluid.PyReader)
        r2 = fluid.layers.create_py_reader_by_data(
            4, [fluid.layers.data("x", [4])], place=CPU)
        assert r2._feed_names == ["x"]

    def test_layers_double_buffer_prefetches(self):
        def reader():
            for b in _batches(3):
                yield b

        db = fluid.layers.double_buffer(reader, place=CPU)
        out = list(db())
        assert len(out) == 3 and isinstance(out[0]["x"], torch.Tensor)


class TestNoGpuNoPlace:
    """With no GPU and no place, the entries that place batches raise;
    they never carry on on the CPU."""

    @pytest.fixture(autouse=True)
    def _hide_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_device_loader_raises(self):
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceLoader(lambda: iter(_batches(2)))
        assert _no_loader_threads() == []

    def test_double_buffered_py_reader_raises(self):
        x = fluid.layers.data("x", [4])
        r = fluid.PyReader(feed_list=[x], capacity=4, use_double_buffer=True)
        r.decorate_batch_generator(lambda: iter([[np.zeros((2, 4))]]))
        with pytest.raises(RuntimeError, match="CUDA"):
            r()
        assert r._loader is None
        with pytest.raises(RuntimeError, match="CUDA"):
            fluid.layers.double_buffer(lambda: iter(_batches(2)))
        # the host-only form needs no device
        h = fluid.PyReader(feed_list=[x], capacity=4, use_double_buffer=False)
        h.decorate_batch_generator(lambda: iter([[np.zeros((2, 4))]]))
        assert len(list(h())) == 1
        assert _no_loader_threads() == []

    def test_drivers_raise(self):
        with pytest.raises(RuntimeError, match="CUDA"):
            fluid.Executor()


class TestDeviceLoaderResume:
    @staticmethod
    def _epoch_reader(epoch):
        for b in range(4):
            yield {"x": np.full((2, 2), epoch * 10 + b, "float32")}

    @staticmethod
    def _vals(batches):
        return [int(b["x"][0, 0]) for b in batches]

    def test_mid_epoch_state_resume_replays_undelivered_batches(self):
        l1 = _loader(self._epoch_reader)
        it = iter(l1)
        got = [next(it) for _ in range(3)]
        assert self._vals(got) == [0, 1, 2]
        st = l1.state()
        l1.close()
        assert st == {"version": 1, "epoch": 0, "cursor": 3}
        l2 = _loader(self._epoch_reader)
        l2.restore_state(st)
        assert self._vals(list(l2)) == [3]
        assert self._vals(list(l2)) == [10, 11, 12, 13]

    def test_epoch_boundary_state(self):
        ld = _loader(self._epoch_reader)
        assert self._vals(list(ld)) == [0, 1, 2, 3]
        st = ld.state()
        assert st == {"version": 1, "epoch": 1, "cursor": 0}
        l2 = _loader(self._epoch_reader)
        l2.restore_state(st)
        assert self._vals(list(l2)) == [10, 11, 12, 13]

    def test_stateless_reader_still_resumes_by_skip(self):
        def reader():
            for b in range(5):
                yield {"x": np.full((1, 1), b, "float32")}

        l1 = _loader(reader)
        it = iter(l1)
        next(it), next(it)
        st = l1.state()
        l1.close()
        l2 = _loader(reader)
        l2.restore_state(st)
        assert self._vals(list(l2)) == [2, 3, 4]

    def test_restore_state_rejects_running_or_bad_state(self):
        ld = _loader(self._epoch_reader)
        it = iter(ld)
        next(it)
        with pytest.raises(RuntimeError, match="running"):
            ld.restore_state({"version": 1, "epoch": 0, "cursor": 1})
        ld.close()
        with pytest.raises(ValueError, match="version"):
            ld.restore_state({"version": 2, "epoch": 0, "cursor": 0})
        with pytest.raises(ValueError):
            ld.restore_state({"version": 1, "epoch": -1, "cursor": 0})

    def test_close_mid_epoch_does_not_advance_epoch(self):
        ld = _loader(self._epoch_reader)
        it = iter(ld)
        next(it)
        ld.close()
        assert ld.state() == {"version": 1, "epoch": 0, "cursor": 1}

    def test_state_rides_a_checkpoint(self, tmp_path):
        """The cursor saved as ``@dataio@*`` extras comes back through
        ``last_extra`` and resumes a fresh loader at the next batch."""
        from paddle_tpu_torch.parallel import Checkpointer

        l1 = _loader(self._epoch_reader)
        it = iter(l1)
        next(it), next(it)
        st = l1.state()
        l1.close()
        ck = Checkpointer(str(tmp_path / "c"))
        ck.save(1, program=fluid.Program(), scope=fluid.Scope(),
                blocking=True,
                extra={f"@dataio@{k}": v for k, v in st.items()})
        ck.restore(program=fluid.Program(), scope=fluid.Scope(), place=CPU)
        back = {k[len("@dataio@"):]: int(np.asarray(v).reshape(-1)[0])
                for k, v in ck.last_extra.items()}
        l2 = _loader(self._epoch_reader)
        l2.restore_state(back)
        assert self._vals(list(l2)) == [2, 3]
