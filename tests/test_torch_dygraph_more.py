"""The rest of the port's dygraph slice, held to the JAX package where it
computes a number (rtol 1e-5 plus atol 1e-6):

- gradient semantics on torch autograd, as the JAX package's tape shows
  them: an intermediate's gradient, the sum over two backward calls, a
  backward after the tape is freed (a no-op), ``stop_gradient`` and an
  op's ``nondiff_inputs``, ``minimize`` running the backward itself;
- in_dygraph_mode inside and outside a guard; ``guard()`` with no place
  is ``CUDAPlace(0)`` and raises where torch sees no GPU; every name
  ``paddle_tpu.dygraph`` exports;
- tests/test_api_parity.py's dygraph decays (all seven against the JAX
  package's values) and dygraph grad clips (all three);
- the optimizer's dygraph ``state_dict`` with Adam against the JAX
  package's, through a ``.pdopt`` file, and the step after loading it;
- ``ops/eager.py``: ``call`` against the JAX package's, its cache and
  ``set_eager_seed``;
- ``profiler.op_profiler``'s table and its ``eager/op_ms`` /
  ``eager/op_calls`` series; ``tools.op_bench.bench_dygraph_mlp``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.dygraph.tracer import trace_op as jtrace
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch.dygraph.tracer import trace_op as ttrace

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def both(run):
    """run(fluid, dy, trace, guard) in the JAX package and in the port
    (on the CPU): (jax result, port result)."""
    return (run(jfluid, jdy, jtrace, lambda **kw: jdy.guard(**kw)),
            run(tfluid, tdy, ttrace,
                lambda **kw: tdy.guard(tfluid.CPUPlace(), **kw)))


# -- gradient semantics ---------------------------------------------------------

XV = np.array([[1.0, -2.0, 3.0], [0.5, 4.0, -1.0]], np.float32)
WV = np.array([[0.2, -0.1], [0.4, 0.3], [-0.5, 0.6]], np.float32)


def _graph(dy, trace):
    """x (requires grad) → h = x·w (w stops gradient) → y = tanh(h) → loss
    = sum(y·y)."""
    x = dy.to_variable(XV)
    x.stop_gradient = False
    w = dy.to_variable(WV)
    h = trace("matmul", {"X": [x], "Y": [w]}, {})["Out"][0]
    y = trace("tanh", {"X": [h]}, {})["Out"][0]
    loss = trace("reduce_sum", {"X": [y * y]}, {"reduce_all": True})[
        "Out"][0]
    return x, w, h, y, loss


def test_intermediate_gradients_match_jax():
    def run(fluid, dy, trace, guard):
        with guard():
            x, w, h, y, loss = _graph(dy, trace)
            loss.backward()
            return x.gradient, w.gradient, h.gradient, y.gradient, \
                loss.gradient

    (jx, jw, jh, jy, jl), (tx, tw, th, ty, tl) = both(run)
    for got, want in ((tx, jx), (th, jh), (ty, jy)):
        assert got is not None
        close(got, want)
    # w stops gradient; the loss is no taped op's input
    assert tw is None and jw is None and tl is None and jl is None


def test_gradients_sum_over_two_backward_calls_and_the_freed_tape():
    def run(fluid, dy, trace, guard):
        with guard():
            x, _, h, _, loss = _graph(dy, trace)
            loss.backward()
            first = x.gradient
            loss.backward()   # the tape is freed: a no-op
            after_freed = x.gradient
            # a second graph on the same leaf adds into its gradient
            y2 = trace("reduce_sum", {"X": [x * x]}, {"reduce_all": True})[
                "Out"][0]
            y2.backward()
            summed = x.gradient
            x.clear_gradient()
            cleared = x.gradient
            return first, after_freed, summed, cleared

    (jf, ja, js, jc), (tf, ta, ts, tc) = both(run)
    close(ta, tf, rtol=0, atol=0)
    close(ts, tf + 2 * XV)
    for got, want in ((tf, jf), (ta, ja), (ts, js)):
        close(got, want)
    assert tc is None and jc is None


def test_retained_tape_sums_two_backward_calls():
    with tdy.guard(tfluid.CPUPlace()):
        x, _, _, _, loss = _graph(tdy, ttrace)
        tr = tdy.tracer._active_tracer()
        tr.run_backward(loss, retain_graph=True)
        once = x.gradient
        loss.backward()
        close(x.gradient, 2 * once)


def test_stop_gradient_and_nondiff_inputs():
    ids = np.array([[1], [3], [1]], np.int64)
    table = np.random.RandomState(0).rand(5, 4).astype(np.float32)

    def run(fluid, dy, trace, guard):
        with guard():
            w = dy.to_variable(table)
            w.stop_gradient = False
            i = dy.to_variable(ids)
            # Ids is lookup_table's nondiff input; the table gets the rows'
            # sums
            emb = trace("lookup_table", {"W": [w], "Ids": [i]}, {})["Out"][0]
            s = trace("reduce_sum", {"X": [emb * emb]}, {"reduce_all": True})[
                "Out"][0]
            # a leaf whose stop_gradient is set after use: no gradient
            frozen = dy.to_variable(table)
            frozen.stop_gradient = False
            t = trace("reduce_sum", {"X": [frozen]}, {"reduce_all": True})[
                "Out"][0]
            frozen.stop_gradient = True
            total = s + t
            total.backward()
            return w.gradient, i.gradient, frozen.gradient

    (jw, ji, jf), (tw, ti, tf) = both(run)
    close(tw, jw)
    assert ti is None and ji is None
    assert tf is None and jf is None


def test_minimize_runs_the_backward_itself():
    def run(fluid, dy, trace, guard):
        with guard():
            layer = dy.Linear(3, 2, bias_attr=False,
                              param_attr=fluid.ParamAttr(
                                  initializer=fluid.initializer
                                  .NumpyArrayInitializer(WV)))
            loss = trace("mean", {"X": [layer(dy.to_variable(XV))]}, {})[
                "Out"][0]
            fluid.optimizer.SGD(0.5).minimize(
                loss, parameter_list=layer.parameters())
            return layer.weight.numpy(), layer.weight.gradient

    (jw, jg), (tw, tg) = both(run)
    close(tw, jw)
    close(tg, jg)


def test_parameters_stay_the_same_leaf_through_updates():
    with tdy.guard(tfluid.CPUPlace()):
        layer = tdy.Linear(3, 2)
        leaf = layer.weight.value
        opt = tfluid.optimizer.Momentum(0.1, 0.9)
        for _ in range(2):
            loss = ttrace("mean", {"X": [layer(tdy.to_variable(XV))]}, {})[
                "Out"][0]
            loss.backward()
            opt.minimize(loss, parameter_list=layer.parameters())
            layer.clear_gradients()
        layer.set_dict(layer.state_dict())
        assert layer.weight.value is leaf
        assert leaf.is_leaf and leaf.requires_grad and leaf.grad is None


# -- the mode switch and the guard ---------------------------------------------

def test_in_dygraph_mode_inside_and_outside_guard():
    for fluid, dy, guard in (
            (jfluid, jdy, lambda: jdy.guard()),
            (tfluid, tdy, lambda: tdy.guard(tfluid.CPUPlace()))):
        assert not fluid.in_dygraph_mode() and not dy.enabled()
        with guard():
            assert fluid.in_dygraph_mode() and dy.enabled()
            with guard():
                assert fluid.in_dygraph_mode()
            assert fluid.in_dygraph_mode()
        assert not fluid.in_dygraph_mode()
    assert tfluid.core.program.in_dygraph_mode is tfluid.in_dygraph_mode


def test_guard_without_place_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU: guard() then raises")
    with pytest.raises(RuntimeError, match="CUDA device"):
        with tdy.guard():
            pass
    assert not tfluid.in_dygraph_mode()


def test_guard_places_tensors_on_its_device():
    with tdy.guard(tfluid.CPUPlace(), seed=4):
        v = tdy.to_variable(np.arange(3, dtype=np.int64))
        assert v.value.device.type == "cpu" and v.value.dtype == torch.int64
        f = tdy.to_variable(np.ones(2))          # float64 → float32
        assert f.value.dtype == torch.float32
        assert tdy.Linear(2, 2).weight.value.device.type == "cpu"


def test_dygraph_exports_every_jax_name():
    names = [n for n in dir(jdy) if not n.startswith("_")]
    missing = [n for n in names if not hasattr(tdy, n)]
    assert not missing, missing
    assert callable(tdy.start_gperf_profiler) and callable(
        tdy.stop_gperf_profiler)
    assert tdy.BackwardStrategy().sort_sum_gradient is False


# -- decays and grad clips (tests/test_api_parity.py) ---------------------------

DECAYS = [
    ("NoamDecay", dict(d_model=512, warmup_steps=10)),
    ("PiecewiseDecay", dict(boundaries=[5, 10], values=[1.0, 0.5, 0.1],
                            begin=0)),
    ("NaturalExpDecay", dict(learning_rate=0.5, decay_steps=3,
                             decay_rate=0.3, staircase=True)),
    ("ExponentialDecay", dict(learning_rate=0.5, decay_steps=4,
                              decay_rate=0.9)),
    ("InverseTimeDecay", dict(learning_rate=0.5, decay_steps=2,
                              decay_rate=0.5, staircase=True)),
    ("PolynomialDecay", dict(learning_rate=0.5, decay_steps=8, power=2.0,
                             cycle=True)),
    ("CosineDecay", dict(learning_rate=1.0, step_each_epoch=1, epochs=10)),
]


@pytest.mark.parametrize("name,kw", DECAYS, ids=[d[0] for d in DECAYS])
def test_dygraph_decay_matches_jax(name, kw):
    j, t = getattr(jdy, name)(**kw), getattr(tdy, name)(**kw)
    jl, tl = [j() for _ in range(20)], [t() for _ in range(20)]
    assert tl == jl
    if name == "NoamDecay":
        assert max(tl) == tl[9]  # peaks at the warmup boundary
    if name == "PiecewiseDecay":
        assert tl[0] == 1.0 and tl[6] == 0.5 and tl[11] == 0.1
    if name == "CosineDecay":
        assert abs(tl[0] - 1.0) < 1e-6


@pytest.mark.parametrize("clip", ["GradClipByValue", "GradClipByNorm",
                                  "GradClipByGlobalNorm"])
def test_dygraph_grad_clip_matches_jax(clip):
    import jax.numpy as jnp
    from paddle_tpu.dygraph.varbase import VarBase as JVar
    from paddle_tpu_torch.dygraph.varbase import VarBase as TVar

    arg = {"GradClipByValue": 2.5, "GradClipByNorm": 1.0,
           "GradClipByGlobalNorm": 1.0}[clip]
    gs = [np.array([3.0, -4.0], np.float32), np.array([0.5, 2.0, -3.0],
                                                     np.float32)]
    with jdy.guard():
        jout = getattr(jfluid.dygraph_grad_clip, clip)(arg)(
            [(JVar(jnp.zeros_like(jnp.asarray(g))), JVar(jnp.asarray(g)))
             for g in gs])
    with tdy.guard(tfluid.CPUPlace()):
        tout = getattr(tfluid.dygraph_grad_clip, clip)(arg)(
            [(TVar(np.zeros_like(g)), TVar(g)) for g in gs])
    for (_, jg), (_, tg) in zip(jout, tout):
        close(tg.numpy(), np.asarray(jg.value))
    if clip == "GradClipByGlobalNorm":
        norm = np.sqrt(sum((tg.numpy() ** 2).sum() for _, tg in tout))
        assert abs(norm - 1.0) < 1e-5


# -- the optimizer's dygraph state ----------------------------------------------

def test_adam_state_dict_round_trip_matches_jax(tmp_path):
    xv = np.random.RandomState(0).rand(4, 3).astype(np.float32)

    def train(fluid, dy, trace, guard, steps, state=None, path=None):
        with fluid.unique_name.guard(), guard(seed=1):
            layer = dy.Linear(3, 2, param_attr=fluid.ParamAttr(
                initializer=fluid.initializer.NumpyArrayInitializer(WV)))
            opt = fluid.optimizer.Adam(0.1)

            def step():
                loss = trace("mean", {"X": [layer(dy.to_variable(xv))]}, {})[
                    "Out"][0]
                loss.backward()
                opt.minimize(loss, parameter_list=layer.parameters())
                layer.clear_gradients()

            for _ in range(steps):
                step()
            if path is not None:
                dy.save_dygraph(opt.state_dict(), path)
                dy.save_dygraph(layer.state_dict(), path)
            if state is not None:
                para, opt_state = state
                layer.set_dict(para)
                opt.set_state_dict(opt_state)
                step()
            return opt.state_dict(), layer.state_dict()

    (jopt, jpar), (topt, tpar) = (
        train(jfluid, jdy, jtrace, lambda **kw: jdy.guard(**kw), 3),
        train(tfluid, tdy, ttrace,
              lambda **kw: tdy.guard(tfluid.CPUPlace(), **kw), 3,
              path=str(tmp_path / "port")))
    assert sorted(topt) == sorted(jopt)
    for k in jopt:
        close(topt[k], jopt[k], msg=k)
    # the JAX package reads the port's file; the port, after one step of
    # its own, loads it back and its next step is the JAX package's 4th
    para, opt_state = jdy.load_dygraph(str(tmp_path / "port"))
    assert sorted(opt_state) == sorted(topt)
    jopt4, jpar4 = train(jfluid, jdy, jtrace, lambda **kw: jdy.guard(**kw),
                         4)
    topt4, tpar4 = train(tfluid, tdy, ttrace,
                         lambda **kw: tdy.guard(tfluid.CPUPlace(), **kw), 1,
                         state=tdy.load_dygraph(str(tmp_path / "port")))
    for k in jpar4:
        close(tpar4[k], jpar4[k], msg=k)
    for k in jopt4:
        close(topt4[k], jopt4[k], msg=k)


def test_set_lr_in_dygraph():
    with tdy.guard(tfluid.CPUPlace()):
        layer = tdy.Linear(3, 2, bias_attr=False)
        opt = tfluid.optimizer.SGD(0.1)
        w0 = layer.weight.numpy()
        loss = ttrace("mean", {"X": [layer(tdy.to_variable(XV))]}, {})[
            "Out"][0]
        loss.backward()
        g = layer.weight.gradient
        opt.set_lr(0.0)
        opt.minimize(loss, parameter_list=layer.parameters())
        np.testing.assert_array_equal(layer.weight.numpy(), w0)  # lr 0
        opt.set_lr(0.5)
        opt.minimize(loss, parameter_list=layer.parameters())
        close(layer.weight.numpy(), w0 - 0.5 * g)


# -- op_profiler and the dygraph op_bench ---------------------------------------

def test_op_profiler_table_and_registry_series():
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability.registry import get_registry

    reg = get_registry()
    before = reg.counter("eager/op_calls", op="matmul").value
    with tdy.guard(tfluid.CPUPlace()):
        with profiler.op_profiler() as timer:
            for _ in range(3):
                _graph(tdy, ttrace)[-1].backward()
    assert timer.counts["matmul"] == 3 and timer.counts["tanh"] == 3
    assert timer.counts["reduce_sum"] == 3
    assert timer.counts["elementwise_mul"] == 3
    assert all(timer.times[k] > 0 for k in timer.counts)
    table = timer.summary()
    assert table.splitlines()[0].split() == ["op", "calls", "total_ms",
                                             "avg_ms"]
    assert any(line.split()[:2] == ["matmul", "3"]
               for line in table.splitlines()[1:])
    assert reg.counter("eager/op_calls", op="matmul").value - before == 3
    assert reg.gauge("eager/op_ms", op="matmul").value > 0
    # the tracer is restored on exit
    from paddle_tpu_torch.dygraph import tracer as tr_mod
    assert tr_mod.Tracer.trace_op.__name__ == "trace_op"


def test_bench_dygraph_mlp_returns_its_keys():
    from paddle_tpu_torch.tools import op_bench

    out = op_bench.bench_dygraph_mlp(steps=4, width=32, depth=2,
                                     device="cpu")
    assert set(out) >= {"bench", "steps", "cached_ms", "uncached_ms",
                        "cached_iqr_ms", "uncached_iqr_ms", "n_segments",
                        "speedup"}
    assert out["bench"] == "dygraph_mlp_step" and out["n_segments"] == 2
    assert out["cached_ms"] > 0 and out["uncached_ms"] > 0


# -- the eager op call ----------------------------------------------------------

def test_eager_call_matches_jax_and_caches(monkeypatch):
    from paddle_tpu.ops import eager as jeager
    from paddle_tpu_torch.ops import eager as teager

    monkeypatch.delenv("PDTPU_EAGER_JIT", raising=False)
    x = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    y = np.random.RandomState(1).rand(4, 2).astype(np.float32)
    want = jeager.call("matmul", {"X": [x], "Y": [y]}, {"transpose_X": False})
    teager._jit_cache.clear()
    got = teager.call("matmul", {"X": [torch.from_numpy(x)],
                                 "Y": [torch.from_numpy(y)]},
                      {"transpose_X": False})
    close(got["Out"][0].numpy(), np.asarray(want["Out"][0]))
    assert len(teager._jit_cache) == 1
    teager.call("matmul", {"X": [torch.from_numpy(x)],
                           "Y": [torch.from_numpy(y)]},
                {"transpose_X": False})
    assert len(teager._jit_cache) == 1          # the entry is reused
    # ops of _NO_JIT and non-scalar attrs take the direct path
    assert teager._prepare("conditional_block", {}, False) is None
    assert teager._prepare("matmul", {"alpha": [[1.0]]}, False) is None
    assert len(teager._jit_cache) == 1
    monkeypatch.setenv("PDTPU_EAGER_JIT", "0")
    teager.call("matmul", {"X": [torch.from_numpy(x)],
                           "Y": [torch.from_numpy(y)]}, {"transpose_Y": False})
    assert len(teager._jit_cache) == 1          # the direct path


def test_set_eager_seed_repeats_the_draws():
    from paddle_tpu_torch.ops import eager as teager

    x = torch.ones(64, 64)
    masks = []
    for _ in range(2):
        teager.set_eager_seed(11)
        out = teager.call("dropout", {"X": [x]},
                          {"dropout_prob": 0.5,
                           "dropout_implementation": "upscale_in_train"})
        masks.append(out["Out"][0])
    assert torch.equal(masks[0], masks[1])
    assert 0.3 < float((masks[0] == 0).float().mean()) < 0.7
    teager.set_eager_seed(12)
    other = teager.call("dropout", {"X": [x]},
                        {"dropout_prob": 0.5,
                         "dropout_implementation": "upscale_in_train"})
    assert not torch.equal(other["Out"][0], masks[0])
