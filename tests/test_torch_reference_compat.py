"""Reference-artifact interop in the port (``paddle_tpu_torch.compat``) on
the CPU: twins of all ten tests of ``tests/test_reference_compat.py``.

The codec is the JAX package's wire code, so the port's bytes are held to
the JAX package's (and, where ``protoc`` and the reference schema exist,
to protobuf classes compiled from it); the checked-in reference MNIST
artifact predicts within 1e-5 of its recorded outputs in the port, and the
same as the JAX package."""
import os
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from _torch_twin import fresh_port_state
from paddle_tpu.compat import reference_format as jrf
from paddle_tpu_torch.compat import reference_format as rf

torch.set_num_threads(1)
CPU = fluid.CPUPlace()
DATA = os.path.join(os.path.dirname(__file__), "data", "ref_mnist_model")


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


def _reference_pb2(tmp_path):
    from test_reference_compat import _reference_pb2 as compile_pb2
    return compile_pb2(tmp_path)


def _sample_prog():
    return {"blocks": [{
        "idx": 0, "parent_idx": -1,
        "vars": {
            "x": {"name": "x", "type": rf.VT_LOD_TENSOR,
                  "dtype": "float32", "shape": [-1, 4],
                  "persistable": False, "lod_level": 0},
            "w": {"name": "w", "type": rf.VT_LOD_TENSOR,
                  "dtype": "float32", "shape": [4, 3],
                  "persistable": True, "lod_level": 0},
        },
        "ops": [{
            "type": "mul", "inputs": {"X": ["x"], "Y": ["w"]},
            "outputs": {"Out": ["y"]},
            "attrs": {"x_num_col_dims": 1, "scale": 0.5, "name": "m",
                      "shape": [2, -3], "ratios": [0.5, 2.0],
                      "names": ["a", "b"], "flag": True,
                      "flags": [True, False]},
        }],
    }]}


def test_program_desc_roundtrip():
    data = rf.serialize_program_desc(_sample_prog())
    assert data == jrf.serialize_program_desc(_sample_prog())
    back = rf.parse_program_desc(data)
    b0 = back["blocks"][0]
    assert b0["vars"]["w"]["persistable"] is True
    assert b0["vars"]["w"]["shape"] == [4, 3]
    assert b0["vars"]["x"]["shape"] == [-1, 4]
    op = b0["ops"][0]
    assert op["type"] == "mul"
    assert op["inputs"] == {"X": ["x"], "Y": ["w"]}
    assert op["attrs"]["x_num_col_dims"] == 1
    assert op["attrs"]["shape"] == [2, -3]
    np.testing.assert_allclose(op["attrs"]["ratios"], [0.5, 2.0])
    assert op["attrs"]["names"] == ["a", "b"]
    assert op["attrs"]["flag"] is True
    assert op["attrs"]["flags"] == [True, False]
    assert abs(op["attrs"]["scale"] - 0.5) < 1e-7


def test_wire_format_matches_reference_proto(tmp_path):
    framework_pb2 = _reference_pb2(tmp_path)
    desc = framework_pb2.ProgramDesc()
    desc.ParseFromString(rf.serialize_program_desc(_sample_prog()))
    blk = desc.blocks[0]
    assert {v.name for v in blk.vars} == {"x", "w"}
    w = [v for v in blk.vars if v.name == "w"][0]
    assert w.persistable
    assert list(w.type.lod_tensor.tensor.dims) == [4, 3]
    assert w.type.lod_tensor.tensor.data_type == 5  # FP32
    attrs = {a.name: a for a in blk.ops[0].attrs}
    assert attrs["x_num_col_dims"].i == 1
    assert list(attrs["shape"].ints) == [2, -3]
    assert attrs["flag"].b is True
    assert attrs["names"].strings == ["a", "b"]

    desc2 = framework_pb2.ProgramDesc()
    b = desc2.blocks.add()
    b.idx, b.parent_idx = 0, -1
    v = b.vars.add()
    v.name = "p"
    v.persistable = True
    v.type.type = 7  # LOD_TENSOR
    v.type.lod_tensor.tensor.data_type = 5
    v.type.lod_tensor.tensor.dims.extend([2, 3])
    o = b.ops.add()
    o.type = "scale"
    inp = o.inputs.add()
    inp.parameter = "X"
    inp.arguments.append("p")
    outp = o.outputs.add()
    outp.parameter = "Out"
    outp.arguments.append("q")
    a = o.attrs.add()
    a.name, a.type, a.f = "scale", 1, 2.0
    g0 = rf.parse_program_desc(desc2.SerializeToString())["blocks"][0]
    assert g0["vars"]["p"]["shape"] == [2, 3]
    assert g0["vars"]["p"]["persistable"] is True
    assert g0["ops"][0]["type"] == "scale"
    assert abs(g0["ops"][0]["attrs"]["scale"] - 2.0) < 1e-7


def test_lod_tensor_stream_roundtrip(tmp_path):
    arr = np.random.RandomState(0).randn(3, 4).astype("float32")
    p = tmp_path / "var"
    with open(p, "wb") as f:
        rf.write_lod_tensor_stream(f, arr, lod=[[0, 2, 3]])
    with open(p, "rb") as f:
        back, lod = rf.read_lod_tensor_stream(f)
    np.testing.assert_array_equal(back, arr)
    assert lod == [[0, 2, 3]]
    raw = open(p, "rb").read()
    assert struct.unpack("<I", raw[:4])[0] == 0
    assert struct.unpack("<Q", raw[4:12])[0] == 1
    with open(p, "rb") as f:  # the JAX package reads the same stream
        jback, jlod = jrf.read_lod_tensor_stream(f)
    np.testing.assert_array_equal(jback, arr)
    assert [list(map(int, lv)) for lv in jlod] == [[0, 2, 3]]


def test_checked_in_reference_mnist_loads_and_predicts():
    exp = np.load(os.path.join(DATA, "expected.npz"))
    sc = fluid.Scope()
    with fluid.scope_guard(sc):
        prog, feeds, fetches = rf.load_reference_inference_model(
            DATA, place=CPU)
        assert feeds == ["img"]
        assert fetches == ["prob"]
        w0 = fluid.global_scope().find_var("fc0.w")
        assert isinstance(w0, torch.Tensor) and tuple(w0.shape) == (784, 32)
        exe = fluid.Executor(CPU)
        (prob,) = exe.run(prog, feed={"img": exp["x"]}, fetch_list=fetches)
    np.testing.assert_allclose(prob, exp["prob"], rtol=1e-5, atol=1e-5)
    with jfluid.scope_guard(jfluid.Scope()):
        jprog, _, jfetch = jrf.load_reference_inference_model(DATA)
        (jprob,) = jfluid.Executor(jfluid.CPUPlace()).run(
            jprog, feed={"img": exp["x"]}, fetch_list=jfetch)
    np.testing.assert_allclose(prob, np.asarray(jprob), rtol=1e-6,
                               atol=1e-7)
    assert (prob.argmax(1) == np.asarray(jprob).argmax(1)).all()


def test_per_var_and_combined_params_agree(tmp_path):
    import tests.gen_ref_artifact as gen

    d1 = tmp_path / "pervar"
    gen.build(str(d1))
    with open(d1 / "__model__", "rb") as f:
        desc = rf.parse_program_desc(f.read())
    per_var = rf.load_reference_persistables(str(d1), desc)
    names = sorted(v["name"] for v in desc["blocks"][0]["vars"].values()
                   if v["persistable"] and v["name"] not in ("feed",
                                                             "fetch"))
    with open(tmp_path / "params", "wb") as f:
        for n in names:
            rf.write_lod_tensor_stream(f, per_var[n])
    combined = rf.load_reference_persistables(
        str(tmp_path), desc, params_filename="params")
    assert set(combined) == set(per_var)
    for n in per_var:
        np.testing.assert_array_equal(per_var[n], combined[n])


def test_loader_guards(tmp_path):
    prog = _sample_prog()
    prog["blocks"].append({"idx": 1, "parent_idx": 0, "vars": {},
                           "ops": []})
    data = rf.serialize_program_desc(prog)
    with pytest.raises(NotImplementedError, match="blocks"):
        rf._build_program(rf.parse_program_desc(data))

    one = _sample_prog()
    one["blocks"][0]["ops"][0]["attrs"] = {"paddings": []}
    back = rf.parse_program_desc(rf.serialize_program_desc(one))
    assert back["blocks"][0]["ops"][0]["attrs"]["paddings"] == []

    arr = np.arange(6, dtype=np.uint64).reshape(2, 3)
    p = tmp_path / "u64"
    with open(p, "wb") as f:
        rf.write_lod_tensor_stream(f, arr)
    with open(p, "rb") as f:
        back_arr, _ = rf.read_lod_tensor_stream(f)
    np.testing.assert_array_equal(back_arr, arr)


def _fc_model(hidden_act="relu"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [8])
        h = fluid.layers.fc(x, 16, act=hidden_act,
                            param_attr=fluid.ParamAttr(name="e.w1"),
                            bias_attr=fluid.ParamAttr(name="e.b1"))
        out = fluid.layers.fc(h, 3, param_attr=fluid.ParamAttr(name="e.w2"),
                              bias_attr=False)
        prob = fluid.layers.softmax(out)
    startup.random_seed = 5
    return main, startup, prob


def test_export_then_load_reference_roundtrip(tmp_path):
    import paddle_tpu_torch.compat as compat

    main, startup, prob = _fc_model()
    X = np.random.RandomState(0).rand(4, 8).astype("float32")
    exdir = tmp_path / "export"
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        (ref_out,) = exe.run(main, feed={"x": X}, fetch_list=[prob])
        compat.export_reference_inference_model(
            str(exdir), ["x"], [prob.name], main)
    assert (exdir / "__model__").exists()
    assert (exdir / "e.w1").exists()

    with fluid.scope_guard(fluid.Scope()):
        prog2, feeds, fetches = compat.load_reference_inference_model(
            str(exdir), place=CPU)
        assert feeds == ["x"] and fetches == [prob.name]
        (got,) = fluid.Executor(CPU).run(prog2, feed={"x": X},
                                         fetch_list=fetches)
    np.testing.assert_array_equal(got, ref_out)

    # the JAX package reads the port's export and predicts the same
    with jfluid.scope_guard(jfluid.Scope()):
        jprog, _, jfetch = jrf.load_reference_inference_model(str(exdir))
        (jgot,) = jfluid.Executor(jfluid.CPUPlace()).run(
            jprog, feed={"x": X}, fetch_list=jfetch)
    np.testing.assert_allclose(np.asarray(jgot), ref_out, rtol=1e-6,
                               atol=1e-7)


def test_export_parses_with_the_reference_schema(tmp_path):
    """The exported bytes parse through protobuf classes compiled from the
    reference's own schema (skips where protoc or the schema is absent,
    as the JAX package's test does)."""
    import paddle_tpu_torch.compat as compat

    framework_pb2 = _reference_pb2(tmp_path)
    main, startup, prob = _fc_model()
    exdir = tmp_path / "export"
    with fluid.scope_guard(fluid.Scope()):
        fluid.Executor(CPU).run(startup)
        compat.export_reference_inference_model(
            str(exdir), ["x"], [prob.name], main)
    desc = framework_pb2.ProgramDesc()
    desc.ParseFromString((exdir / "__model__").read_bytes())
    types = [o.type for o in desc.blocks[0].ops]
    assert types[0] == "feed" and types[-1] == "fetch"
    assert "mul" in types and "softmax" in types
    names = {v.name for v in desc.blocks[0].vars}
    assert {"feed", "fetch", "e.w1", "e.w2"} <= names


def test_export_guards(tmp_path):
    import paddle_tpu_torch.compat as compat

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4])
        out = fluid.layers.fc(x, 2, param_attr=fluid.ParamAttr(name="g.w"),
                              bias_attr=False)
    with fluid.scope_guard(fluid.Scope()):
        with pytest.raises(ValueError, match="no value in the scope"):
            compat.export_reference_inference_model(
                str(tmp_path / "g1"), ["x"], [out.name], main)
    with fluid.scope_guard(fluid.Scope()):
        fluid.Executor(CPU).run(startup)
        main.global_block().var("g.w").dtype = "bfloat16"
        with pytest.raises(ValueError, match="bf16|float32"):
            compat.export_reference_inference_model(
                str(tmp_path / "g2"), ["x"], [out.name], main)


def test_save_inference_model_reference_format(tmp_path):
    import paddle_tpu_torch.compat as compat

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [6])
        out = fluid.layers.fc(x, 2, act="tanh",
                              param_attr=fluid.ParamAttr(name="s.w"),
                              bias_attr=fluid.ParamAttr(name="s.b"))
    startup.random_seed = 4
    X = np.random.RandomState(1).rand(3, 6).astype("float32")
    d = tmp_path / "refout"
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        (ref,) = exe.run(main, feed={"x": X}, fetch_list=[out])
        fluid.io.save_inference_model(str(d), ["x"], [out], exe,
                                      main_program=main, format="reference")
        with pytest.raises(ValueError, match="unknown format"):
            fluid.io.save_inference_model(str(d), ["x"], [out], exe,
                                          main_program=main, format="onnx")
        with pytest.raises(ValueError, match="model_filename"):
            fluid.io.save_inference_model(str(d), ["x"], [out], exe,
                                          main_program=main,
                                          model_filename="m",
                                          format="reference")
    assert (d / "__model__").exists() and (d / "s.w").exists()
    with fluid.scope_guard(fluid.Scope()):
        prog2, feeds, fetches = compat.load_reference_inference_model(
            str(d), place=CPU)
        (got,) = fluid.Executor(CPU).run(prog2, feed={"x": X},
                                         fetch_list=fetches)
    np.testing.assert_array_equal(got, ref)
    # the JSON loader refuses the protobuf model and names the way in
    with pytest.raises(NotImplementedError,
                       match="load_reference_inference_model"):
        fluid.io.load_inference_model(str(d), fluid.Executor(CPU))


def test_predictor_serves_reference_format_dir(tmp_path):
    from paddle_tpu_torch import inference

    cfg = inference.Config(DATA)
    cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    assert pred.get_input_names() == ["img"]
    exp = np.load(os.path.join(DATA, "expected.npz"))
    (out,) = pred.run({"img": exp["x"]})
    np.testing.assert_allclose(out, exp["prob"], rtol=1e-5, atol=1e-5)
