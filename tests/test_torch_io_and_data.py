"""IO round-trips, the reader decorators, DataFeeder, the Dataset factory
and the port's own native library (built with g++ into
``paddle_tpu_torch/_build/`` at first use) on the CPU: twins of all seven
tests of ``tests/test_io_and_data.py``, plus the native bundle's bf16
path, which needs no ``ml_dtypes``."""
import ctypes
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from _torch_twin import alarm_timeout, fresh_port_state
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import native
from paddle_tpu_torch import reader as preader
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.dataset import DatasetFactory
from paddle_tpu_torch.native import NativeDataLoader

torch.set_num_threads(1)
CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


@pytest.fixture(autouse=True)
def _time_limit():
    """The native loader and the buffered readers run threads."""
    yield from alarm_timeout(120)


def _build_net():
    x = fluid.layers.data("x", [4])
    y = fluid.layers.fc(x, 2, param_attr="w", bias_attr="b")
    return x, y


def test_save_load_persistables(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        _build_net()
        exe = fluid.Executor(CPU)
        exe.run(startup)
        w0 = fluid.global_scope().find_np("w")
        fluid.io.save_persistables(exe, str(tmp_path / "ckpt"), main)
        fluid.global_scope().set_var("w", torch.zeros(w0.shape))
        missing = pio.load_persistables(exe, str(tmp_path / "ckpt"), main)
        w1 = fluid.global_scope().find_np("w")
    assert not missing
    np.testing.assert_array_equal(w0, w1)
    assert pio.save_params is pio.save_persistables
    assert pio.load_params is pio.load_persistables


def test_inference_model_roundtrip(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x, y = _build_net()
        exe = fluid.Executor(CPU)
        exe.run(startup)
        xv = np.random.rand(3, 4).astype("float32")
        (ref,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
        pio.save_inference_model(str(tmp_path / "model"), ["x"], [y], exe,
                                 main)
    with fluid.scope_guard(fluid.Scope()):
        exe2 = fluid.Executor(CPU)
        prog, feeds, fetches = pio.load_inference_model(
            str(tmp_path / "model"), exe2)
        (out,) = exe2.run(prog, feed={feeds[0]: xv}, fetch_list=fetches)
    np.testing.assert_array_equal(ref, out)


def test_reader_decorators():
    def raw():
        yield from range(10)

    batched = preader.batch(raw, 3)
    batches = list(batched())
    assert batches[0] == [0, 1, 2] and len(batches) == 4
    assert list(preader.firstn(raw, 4)()) == [0, 1, 2, 3]
    shuffled = list(preader.shuffle(raw, 5)())
    assert sorted(shuffled) == list(range(10))
    assert list(preader.buffered(raw, 2)()) == list(range(10))
    mapped = list(preader.map_readers(lambda a: a * 2, raw)())
    assert mapped == [0, 2, 4, 6, 8, 10, 12, 14, 16, 18]
    assert list(preader.xmap_readers(lambda a: a + 1, raw, 3, 4,
                                     order=True)()) == list(range(1, 11))
    assert list(preader.chain(raw, raw)()) == list(range(10)) * 2
    assert list(preader.cache(raw)()) == list(range(10))
    assert list(preader.Fake()(raw, 25)()) == (list(range(10)) * 3)[:25]
    assert list(preader.creator.np_array(np.arange(3))()) == [0, 1, 2]


def test_data_feeder_pads_ragged():
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        ids = fluid.layers.data("ids", [-1], dtype="int64",
                                append_batch_size=False)
        feeder = DataFeeder([ids])
        feed = feeder.feed([(np.array([1, 2, 3]),), (np.array([4]),)])
    assert feed["ids"].shape == (2, 3)
    np.testing.assert_array_equal(feed["ids_len"], [3, 1])


def test_native_loader_parses_multislot(tmp_path):
    assert native.available(), native.build_error()
    f1 = tmp_path / "part-0"
    f1.write_text("2 0.5 1.5 3 7 8 9\n2 2.5 3.5 1 42\n")
    f2 = tmp_path / "part-1"
    f2.write_text("2 9.0 10.0 2 1 2\n")
    loader = NativeDataLoader([str(f1), str(f2)], "fi", num_threads=2)
    samples = sorted(list(loader), key=lambda s: float(s[0][0]))
    loader.close()
    assert len(samples) == 3
    np.testing.assert_allclose(samples[0][0], [0.5, 1.5])
    np.testing.assert_array_equal(samples[0][1], [7, 8, 9])
    np.testing.assert_array_equal(samples[1][1], [42])


def test_dataset_batches(tmp_path):
    assert native.available(), native.build_error()
    f1 = tmp_path / "data.txt"
    f1.write_text("".join(f"3 {i}.0 {i}.5 {i}.25 1 {i}\n" for i in range(10)))
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        feats = fluid.layers.data("feats", [3])
        label = fluid.layers.data("label", [1], dtype="int64")
        ds = DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_filelist([str(f1)])
        ds.set_batch_size(4)
        ds.set_thread(2)
        ds.set_use_var([feats, label])
        assert ds._slot_types == "fi"
        ds.load_into_memory()
        ds.local_shuffle()
        batches = list(ds.batches())
    assert sum(b["feats"].shape[0] for b in batches) == 10
    assert batches[0]["feats"].shape[1] == 3
    labels = sorted(int(v) for b in batches for v in b["label"].ravel())
    assert labels == list(range(10))


def test_native_queue_roundtrip():
    lib = native._ensure_built()
    assert lib is not None, native.build_error()
    # the port's own library, never the JAX package's committed one
    assert os.path.dirname(lib._name) == native.BUILD_DIR
    q = lib.ptq_create(4)
    payload = np.arange(10, dtype=np.uint8)
    lib.ptq_push(q, payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                 10)
    buf = np.zeros(64, dtype=np.uint8)
    n = lib.ptq_pop(q, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    64)
    assert n == 10
    np.testing.assert_array_equal(buf[:10], payload)
    lib.ptq_close(q)
    lib.ptq_destroy(q)


def test_native_bundle_carries_bf16_without_ml_dtypes(tmp_path):
    """bf16 goes out under the ``bfloat16`` tag from a uint16 view and
    comes back as a torch.bfloat16 tensor, bit for bit; the JAX package's
    reader sees the same bytes as an ml_dtypes array."""
    from paddle_tpu import native as jnative

    e = torch.randn(3, 5).to(torch.bfloat16)
    w = np.random.RandomState(0).randn(2, 3).astype("float32")
    p = str(tmp_path / "b.ptck")
    assert native.write_bundle(p, {"e": e, "w": w, "s": np.asarray(7)})
    back = native.read_bundle(p)
    assert back["e"].dtype == torch.bfloat16
    assert torch.equal(back["e"].view(torch.int16), e.view(torch.int16))
    np.testing.assert_array_equal(back["w"], w)
    jback = jnative.read_bundle(p)
    assert jback["e"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(jback["e"].view(np.uint16),
                                  e.view(torch.int16).numpy().view(np.uint16))
