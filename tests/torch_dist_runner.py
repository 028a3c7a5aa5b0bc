"""Rank helper of the port's multi-rank tests (``tests/test_torch_parallel.py``,
``tests/test_torch_zero_sharding.py``).

``World(n, tmpdir)`` spawns n processes (the ``spawn`` start method) that
join one gloo group through a ``FileStore`` file under `tmpdir` (never a
fixed port: the suite runs several files at once) and then serve cases:
``World.run(name, kwargs or [kwargs a rank])`` sends the case to every rank
and returns each rank's result. Every group has a timeout and every
receive waits a bounded time, so a hung rank fails its test, not the
suite; a world whose case failed is torn down.

Each rank pins ``torch.set_num_threads(1)`` and imports torch and the port
only, never jax or paddle_tpu: the JAX side of a twin runs in the test
process. The model builders take the package as an argument (``build_*
(fluid)``), so the test builds the same program with the JAX package.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import traceback
import warnings

import numpy as np

CASE_TIMEOUT = 240.0   # seconds a case may take on every rank
GROUP_TIMEOUT = 180.0  # seconds any collective of the group may wait


# -- model builders (either package) ------------------------------------------

def build_zero_mlp(fluid, opt="adam", seed=7):
    """tests/test_zero_sharding.py's `_build`: one dp-divisible weight, one
    13-row weight and 13- and 1-element biases. Returns (main, startup,
    loss name)."""
    from_np = fluid.initializer.NumpyArrayInitializer
    rng = np.random.RandomState(seed)

    def attr(name, shape):
        w = (rng.rand(*shape).astype("float32") - 0.5) * 0.2
        return fluid.ParamAttr(name=name, initializer=from_np(w))

    opts = {"sgd": lambda: fluid.optimizer.SGD(0.1),
            "momentum": lambda: fluid.optimizer.Momentum(0.1, momentum=0.9),
            "adam": lambda: fluid.optimizer.Adam(0.01),
            "adagrad": lambda: fluid.optimizer.Adagrad(0.1),
            "lamb": lambda: fluid.optimizer.Lamb(0.01)}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 32, act="relu",
                            param_attr=attr("zw0", (16, 32)),
                            bias_attr=attr("zb0", (32,)))
        h = fluid.layers.fc(h, 13, act="relu",
                            param_attr=attr("zw1", (32, 13)),
                            bias_attr=attr("zb1", (13,)))
        out = fluid.layers.fc(h, 1, param_attr=attr("zw2", (13, 1)),
                              bias_attr=attr("zb2", (1,)))
        loss = fluid.layers.mean(fluid.layers.square(out - y))
        opts[opt]().minimize(loss)
    return main, startup, loss.name


def build_unit_mlp(fluid, seed=3):
    """tests/test_stage3_sharding.py's `_unit_mlp`: a dropout-free MLP
    whose three hidden blocks are remat units. Returns (main, startup,
    loss name)."""
    rng = np.random.RandomState(seed)

    def attr(name, shape):
        w = (rng.rand(*shape).astype("float32") - 0.5) * 0.2
        return fluid.ParamAttr(
            name=name, initializer=fluid.initializer.NumpyArrayInitializer(w))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1])
        h = x
        for i in range(3):
            with fluid.remat_unit(f"blk_{i}"):
                h = fluid.layers.fc(h, 32, act="tanh",
                                    param_attr=attr(f"rw{i}",
                                                    (h.shape[-1], 32)),
                                    bias_attr=attr(f"rb{i}", (32,)))
        out = fluid.layers.fc(h, 1, param_attr=attr("rwo", (32, 1)),
                              bias_attr=attr("rbo", (1,)))
        loss = fluid.layers.mean(fluid.layers.square(out - y))
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss.name


def build_narrow(fluid):
    """fc 16 → 4 (a 4-element bias: one element a rank at dp=4) → fc 1,
    Adam: a leaf whose shard is as small as the optimizer's scalar state."""
    rng = np.random.RandomState(6)

    def attr(name, shape):
        w = (rng.rand(*shape).astype("float32") - 0.5) * 0.2
        return fluid.ParamAttr(
            name=name, initializer=fluid.initializer.NumpyArrayInitializer(w))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 4, act="tanh", param_attr=attr("nw0", (16, 4)),
                            bias_attr=attr("nb0", (4,)))
        out = fluid.layers.fc(h, 1, param_attr=attr("nw1", (4, 1)),
                              bias_attr=attr("nb1", (1,)))
        loss = fluid.layers.mean(fluid.layers.square(out - y))
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss.name


def unit_mlp_feed():
    rng = np.random.RandomState(5)
    return {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.rand(32, 1).astype("float32")}


def zero_mlp_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.rand(32, 1).astype("float32")}


def build_ce_fc(fluid):
    """tests/test_parallel.py's data-parallel model: fc → softmax CE →
    SGD."""
    w = np.random.RandomState(5).rand(16, 4).astype("float32") * 0.1
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1], dtype="int64")
        logits = fluid.layers.fc(
            x, 4, bias_attr=False,
            param_attr=fluid.ParamAttr(
                name="w", initializer=fluid.initializer.NumpyArrayInitializer(
                    w)))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss.name


def build_conv_bn(fluid):
    """A tiny conv + batch-norm (+ relu) net with a fused 1×1-conv+BN tail
    and accuracy: every batch reduction of the ResNet path."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [4, 8, 8])
        label = fluid.layers.data("label", [1], dtype="int64")
        h = fluid.layers.conv2d(img, 8, 3, padding=1, bias_attr=False)
        h = fluid.layers.batch_norm(h, act="relu")
        h = fluid.layers.fused_conv_bn(h, 16, act="relu") \
            if hasattr(fluid.layers, "fused_conv_bn") else h
        h = fluid.layers.pool2d(h, pool_type="avg", global_pooling=True)
        logits = fluid.layers.fc(h, 3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
        fluid.optimizer.Momentum(0.05, momentum=0.9).minimize(loss)
    return main, startup, loss.name, acc.name


def tiny_bert_cfg(fluid_bert, attn_dropout=0.0):
    return fluid_bert.BertConfig(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
        ffn_size=128, max_position=32, hidden_dropout=0.0,
        attn_dropout=attn_dropout)


def build_tiny_bert(fluid, bert_mod, batch, seq, attn_dropout=0.0):
    main, startup, _, loss = bert_mod.build_pretrain_program(
        tiny_bert_cfg(bert_mod, attn_dropout), batch, seq,
        optimizer_factory=lambda: fluid.optimizer.Adam(1e-3))
    return main, startup, loss.name


def bert_feed(batch, seq, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 128, (batch, seq, 1)).astype("int64")
    labels[rng.rand(batch, seq) < 0.5] = -100
    mask = np.ones((batch, seq), "float32")
    mask[:, seq - 3:] = 0.0
    return {"src_ids": rng.randint(0, 128, (batch, seq)).astype("int64"),
            "pos_ids": np.tile(np.arange(seq, dtype="int64"), (batch, 1)),
            "sent_ids": np.zeros((batch, seq), "int64"),
            "input_mask": mask, "mlm_labels": labels}


def rows(feed, rank, world):
    """This rank's rows of a global feed dict."""
    out = {}
    for k, v in feed.items():
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


# -- cases (run on every rank) ------------------------------------------------

def _port():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import unique_name

    return fluid, unique_name


def _state_info(main, scope):
    """name -> (local shape, global shape, shard axis or None) of every
    persistable in the scope."""
    from paddle_tpu_torch.core.mesh_step import is_dtensor

    info = {}
    for v in main.list_vars():
        if not v.persistable:
            continue
        val = scope.find_var(v.name)
        if val is None or not hasattr(val, "shape"):
            continue
        if is_dtensor(val):
            axes = [p.dim for p in val.placements if p.is_shard()]
            info[v.name] = (tuple(val.to_local().shape), tuple(val.shape),
                            axes[0] if axes else None)
        else:
            info[v.name] = (tuple(val.shape), tuple(val.shape), None)
    return info


def _whole_dtensors(main, scope):
    """name -> the whole (padded) value of every sharded persistable, as
    ``np.asarray`` of the JAX package's padded array reads it."""
    from paddle_tpu_torch.core.dtypes import to_numpy
    from paddle_tpu_torch.core.mesh_step import is_dtensor

    return {v.name: to_numpy(scope.find_var(v.name).full_tensor())
            for v in main.list_vars()
            if v.persistable and is_dtensor(scope.find_var(v.name))}


def _logical_state(main, scope, names=None):
    from paddle_tpu_torch.core.dtypes import to_numpy
    from paddle_tpu_torch.core.mesh_step import logical_value

    out = {}
    for v in main.list_vars():
        if not v.persistable or (names is not None and v.name not in names):
            continue
        val = scope.find_var(v.name)
        if val is None or not hasattr(val, "shape"):
            continue
        out[v.name] = to_numpy(logical_value(main, v.name, val))
    return out


def case_train(model, feed, steps=4, stage=0, state=None, opt="adam",
               data_parallel=True, env=None, remat=None, fetch_state=True):
    """Build `model`, load `state` (numpy, from the JAX startup) or run the
    port's startup, and run `steps` steps on this rank's `feed` rows
    through with_data_parallel at ZeRO `stage` (or the plain executor).
    Returns the fetches a step (bytes and arrays), the state layout, the
    final logical state and the state-bytes gauge."""
    fluid, names = _port()
    from paddle_tpu_torch.observability.registry import get_registry

    old_env = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        with names.guard():
            if model == "zero_mlp":
                main, startup, loss = build_zero_mlp(fluid, opt)
                fetch = [loss]
            elif model == "unit_mlp":
                main, startup, loss = build_unit_mlp(fluid)
                fetch = [loss]
            elif model == "narrow":
                main, startup, loss = build_narrow(fluid)
                fetch = [loss]
            elif model == "ce_fc":
                main, startup, loss = build_ce_fc(fluid)
                fetch = [loss]
            elif model == "conv_bn":
                main, startup, loss, acc = build_conv_bn(fluid)
                fetch = [loss, acc]
            elif model == "tiny_bert":
                from paddle_tpu_torch.models import bert

                b = feed["src_ids"].shape[0]
                main, startup, loss = build_tiny_bert(
                    fluid, bert, b, feed["src_ids"].shape[1],
                    attn_dropout=float((env or {}).get("ATTN_DROPOUT", 0)))
                fetch = [loss]
            else:
                raise ValueError(model)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            if state is not None:
                fluid.io.load_params_from_numpy(state, scope=scope)
            prog = main
            if data_parallel:
                bs = fluid.BuildStrategy()
                bs.sharding_strategy = stage
                if remat:
                    bs.remat_policy = remat
                prog = fluid.CompiledProgram(main).with_data_parallel(
                    loss_name=loss, build_strategy=bs)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                outs = []
                gauge = []
                for _ in range(steps):
                    outs.append(exe.run(prog, feed=feed, fetch_list=fetch))
                    gauge.append(get_registry().gauge(
                        "memory/state_bytes_per_device").value)
            result = {
                "warnings": [str(w.message) for w in caught],
                "gauge_steps": gauge,
                "whole": _whole_dtensors(main, scope),
                "losses": [np.asarray(o[0]).tobytes() for o in outs],
                "fetches": [[np.asarray(x) for x in o] for o in outs],
                "info": _state_info(main, scope),
                "padded": dict(getattr(main, "_zero_padded", {}) or {}),
                "state_bytes": get_registry().gauge(
                    "memory/state_bytes_per_device").value,
            }
            if fetch_state:
                result["state"] = _logical_state(main, scope)
        return result
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def case_collectives(x):
    """The array-level collectives on a dim-0 sharded DTensor of `x`."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from paddle_tpu_torch.parallel import (all_gather, all_reduce, all_to_all,
                                           broadcast, make_mesh,
                                           reduce_scatter)
    from paddle_tpu_torch.parallel import collective as C

    mesh = make_mesh({"dp": C.dist.get_world_size()})
    t = torch.from_numpy(np.asarray(x))
    xs = DTensor.from_local(t.chunk(mesh.size())[mesh.get_local_rank()],
                            mesh, [Shard(0)], run_check=False)
    ones = DTensor.from_local(torch.ones_like(t), mesh, [Replicate()],
                              run_check=False)
    a2a_in = DTensor.from_local(
        torch.arange(mesh.size() * 2, dtype=torch.float32).reshape(-1, 1)
        + 100 * mesh.get_local_rank(), mesh, [Shard(0)], run_check=False)
    out = {"all_reduce": all_reduce(xs, mesh, "dp").to_local().numpy(),
           "all_gather": all_gather(xs, mesh, "dp").to_local().numpy(),
           "broadcast": broadcast(xs, mesh, "dp", root=2).to_local().numpy(),
           "reduce_scatter": reduce_scatter(ones, mesh,
                                            "dp").full_tensor().numpy(),
           "all_to_all": all_to_all(a2a_in, mesh, "dp", 0,
                                    0).to_local().numpy(),
           "axis_index": C.axis_index((mesh, "dp"))}
    perm = [(i, (i + 1) % mesh.size()) for i in range(mesh.size())]
    out["ppermute"] = C.ppermute(t[:2] + mesh.get_local_rank(), (mesh, "dp"),
                                 perm).numpy()
    out["psum"] = C.psum(t[:2] * 0 + mesh.get_local_rank(),
                         (mesh, "dp")).numpy()
    C.barrier(mesh)
    return out


def case_ring(q, k, v, causal, impl="plain", grads=False, ulysses=False,
              sp=None):
    """This rank's sequence shard through ring (or Ulysses) attention on
    an `sp` mesh axis (the whole world, or a {"dp", "sp"} mesh when `sp`
    is smaller); with `grads` the gradients of sum(out²)."""
    from paddle_tpu_torch.parallel import (make_mesh, ring_self_attention,
                                           ulysses_attention)
    from paddle_tpu_torch.parallel import collective as C

    world = C.dist.get_world_size()
    sp = sp or world
    mesh = make_mesh({"sp": sp} if sp == world
                     else {"dp": world // sp, "sp": sp})
    from paddle_tpu_torch.core.dtypes import from_numpy

    qt, kt, vt = (from_numpy(a).requires_grad_(grads) for a in (q, k, v))
    if ulysses:
        out = ulysses_attention(qt, kt, vt, mesh, "sp", causal=causal)
    else:
        out = ring_self_attention(qt, kt, vt, mesh, "sp", causal=causal,
                                  impl=impl)
    res = {"out": out.detach().float().numpy()}
    if grads:
        (out.float() ** 2).sum().backward()
        res.update(dq=qt.grad.float().numpy(), dk=kt.grad.float().numpy(),
                   dv=vt.grad.float().numpy())
    return res


def case_mesh_shapes():
    from paddle_tpu_torch.parallel import auto_mesh, mesh_shape

    return [mesh_shape(auto_mesh(tp=2)), mesh_shape(auto_mesh(tp=2, pp=2))]


def case_surface():
    """What the mesh surface refuses, naming the item."""
    fluid, names = _port()
    from paddle_tpu_torch.parallel import DistributedStrategy, make_mesh
    from paddle_tpu_torch.parallel import collective as C

    world = C.dist.get_world_size()
    got = {}
    with names.guard():
        main, startup, loss = build_zero_mlp(fluid)
    for label, fn in (
            ("seq_axis", lambda: fluid.CompiledProgram(main).with_mesh(
                make_mesh({"dp": world}), seq_axis="sp")),
            ("tp", lambda: fluid.CompiledProgram(main).with_mesh(
                make_mesh({"dp": world // 2, "tp": 2}))),
            ("places", lambda: fluid.CompiledProgram(main).with_data_parallel(
                places=[fluid.CPUPlace()] * (world + 1))),
            ("gm", lambda: fluid.CompiledProgram(main).with_mesh(
                make_mesh({"dp": world}), strategy=_strategy(
                    DistributedStrategy, gradient_merge_steps=2)))):
        try:
            fn()
            got[label] = None
        except (NotImplementedError, RuntimeError, ValueError) as e:
            got[label] = f"{type(e).__name__}: {e}"
    return got


def _strategy(cls, **kw):
    s = cls()
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def case_with_mesh(feed, state, stage, steps=3):
    """with_mesh(make_mesh({"dp": N}), strategy=sharding_degree/stage)."""
    fluid, names = _port()
    from paddle_tpu_torch.parallel import DistributedStrategy, make_mesh
    from paddle_tpu_torch.parallel import collective as C

    with names.guard():
        main, startup, loss = build_zero_mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    st = _strategy(DistributedStrategy, sharding_degree=2 if stage else 1,
                   sharding_stage=max(stage, 1))
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.load_params_from_numpy(state, scope=scope)
        prog = fluid.CompiledProgram(main).with_mesh(
            make_mesh({"dp": C.dist.get_world_size()}), strategy=st)
        return [np.asarray(exe.run(prog, feed=feed, fetch_list=[loss])[0])
                .tobytes() for _ in range(steps)], _state_info(main, scope)


def case_parallel_executor(feed, state, stage):
    fluid, names = _port()
    from paddle_tpu_torch.observability.registry import get_registry

    with names.guard():
        main, startup, loss = build_zero_mlp(fluid, "sgd")
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
        fluid.io.load_params_from_numpy(state, scope=scope)
        bs = fluid.BuildStrategy()
        bs.sharding_strategy = stage
        pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss,
                                    main_program=main, build_strategy=bs)
        out = pe.run(fetch_list=[loss], feed=feed)
        return {"sharding_strategy": pe.sharding_strategy,
                "device_count": pe.device_count,
                "gauge": get_registry().gauge("executor/device_count").value,
                "loss": np.asarray(out[0])}


def case_run_batched(feed_list, state, stage):
    """run_batched and train_scanned (K = 2) on a CompiledProgram with a
    mesh: bitwise the plain runs of the same feeds."""
    fluid, names = _port()
    outs = []
    for batched in (False, True, "scanned"):
        with names.guard():
            main, startup, loss = build_zero_mlp(fluid)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            fluid.io.load_params_from_numpy(state, scope=scope)
            bs = fluid.BuildStrategy()
            bs.sharding_strategy = stage
            prog = fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss, build_strategy=bs)
            if batched == "scanned":
                outs.append(exe.train_scanned(
                    prog, reader=lambda: iter(feed_list), scan_steps=2,
                    fetch_list=[loss])[0])
            elif batched:
                outs.append(exe.run_batched(prog, feed_list,
                                            fetch_list=[loss])[0])
            else:
                outs.append(np.stack([exe.run(prog, feed=f,
                                              fetch_list=[loss])[0]
                                      for f in feed_list]))
    return [o.tobytes() for o in outs]


def case_amp_fp16(feed, stage, steps=3):
    """The ZeRO MLP under float16 AMP with dynamic loss scaling (its found-
    inf test before update_loss_scaling) at `stage`; returns the loss
    bytes, the loss-scaling state a step and the final parameters."""
    fluid, names = _port()
    from paddle_tpu_torch.contrib import mixed_precision

    with names.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [16])
            y = fluid.layers.data("y", [1])
            init = fluid.initializer.NumpyArrayInitializer
            rng = np.random.RandomState(3)
            h = fluid.layers.fc(x, 32, act="relu", param_attr=fluid.ParamAttr(
                name="aw0", initializer=init(
                    (rng.rand(16, 32).astype("float32") - 0.5) * 0.2)))
            out = fluid.layers.fc(h, 1, param_attr=fluid.ParamAttr(
                name="aw1", initializer=init(
                    (rng.rand(32, 1).astype("float32") - 0.5) * 0.2)))
            loss = fluid.layers.mean(fluid.layers.square(out - y))
            opt = mixed_precision.decorate(
                fluid.optimizer.Adam(0.01), dtype="float16",
                init_loss_scaling=2.0 ** 15, decr_every_n_nan_or_inf=1)
            opt.minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        bs = fluid.BuildStrategy()
        bs.sharding_strategy = stage
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
        losses, scales = [], []
        for i in range(steps):
            (lv,) = exe.run(prog, feed=feed[i], fetch_list=[loss])
            losses.append(np.asarray(lv).tobytes())
            scales.append(float(np.asarray(
                scope.find_var("loss_scaling").cpu()).reshape(-1)[0]))
        return {"losses": losses, "scales": scales,
                "params": _logical_state(main, scope, {"aw0", "aw1"})}


def case_ckpt_save(dirname, feed, state, stage, steps=2, drop_rng=False):
    """Train at `stage`, save with the Checkpointer (sharded state goes to
    the per-rank shard files), then one more step; returns that step's
    loss and the state saved. `drop_rng` leaves the torch generator out
    of the save (the JAX package cannot read one)."""
    fluid, names = _port()
    from paddle_tpu_torch.parallel import Checkpointer

    with names.guard():
        main, startup, loss = build_zero_mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        if state is not None:
            fluid.io.load_params_from_numpy(state, scope=scope)
        bs = fluid.BuildStrategy()
        bs.sharding_strategy = stage
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss, build_strategy=bs)
        for _ in range(steps):
            exe.run(prog, feed=feed, fetch_list=[loss])
        saved = _logical_state(main, scope)
        if drop_rng:
            from paddle_tpu_torch.core.executor import _RNG_STATE

            gen = scope.find_var(_RNG_STATE)
            scope.set_var(_RNG_STATE, None)
        ck = Checkpointer(dirname)
        ck.save(step=steps, program=main, scope=scope)
        ck.wait()
        if drop_rng:
            scope.set_var(_RNG_STATE, gen)
        nxt = np.asarray(exe.run(prog, feed=feed, fetch_list=[loss])[0])
        return {"next": nxt.tobytes(), "saved": saved,
                "info": _state_info(main, scope),
                "files": sorted(os.listdir(dirname))}


def case_ckpt_restore(dirname, feed, stage):
    """Restore the newest checkpoint into a fresh scope and run one step at
    `stage` on this world; returns the loss and the restored state."""
    fluid, names = _port()
    from paddle_tpu_torch.parallel import Checkpointer

    with names.guard():
        main, startup, loss = build_zero_mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        Checkpointer(dirname).restore(program=main, scope=scope,
                                      place=fluid.CPUPlace())
        restored = _logical_state(main, scope)
        bs = fluid.BuildStrategy()
        bs.sharding_strategy = stage
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss, build_strategy=bs)
        out = np.asarray(exe.run(prog, feed=feed, fetch_list=[loss])[0])
        return {"loss": out.tobytes(), "restored": restored}


def case_dropout_masks(feed, rate):
    """A tiny BERT at attention and hidden dropout `rate`, every rank fed
    the SAME rows; returns the global attention output of the first step
    (each rank draws its own masks)."""
    fluid, names = _port()
    from paddle_tpu_torch.models import bert

    with names.guard():
        cfg = bert.BertConfig(vocab_size=128, hidden_size=64, num_layers=1,
                              num_heads=2, ffn_size=128, max_position=32,
                              hidden_dropout=rate, attn_dropout=rate)
        main, startup, _, loss = bert.build_pretrain_program(
            cfg, feed["src_ids"].shape[0], feed["src_ids"].shape[1])
    seq = [v for v in main.global_block().ops
           if v.type == "flash_attention"][0].outputs["Out"][0]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        out = exe.run(prog, feed=feed, fetch_list=[seq])[0]
    return np.asarray(out)


def case_ragged_feed(feed, state, short_rows=None, short_step=1, steps=3):
    """The zero_mlp run at stage 0 on this rank's `feed`, cut to
    `short_rows` rows from step `short_step` on (a ragged last batch):
    returns the losses of the steps that ran and the error that stopped
    the run, if any."""
    fluid, names = _port()
    with names.guard():
        main, startup, loss = build_zero_mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    losses, error = [], None
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.load_params_from_numpy(state, scope=scope)
        prog = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss)
        short = {k: v[:short_rows] for k, v in feed.items()}
        try:
            for i in range(steps):
                fd = feed if i < short_step or short_rows is None else short
                losses.append(np.asarray(exe.run(
                    prog, feed=fd, fetch_list=[loss])[0]).tobytes())
        except ValueError as e:
            error = f"{type(e).__name__}: {e}"
    return losses, error


def case_across_batch(op):
    """One step of a program whose `op` works across the batch dim of a
    batch-sharded value: returns the error it raised, or None."""
    fluid, names = _port()
    with names.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [16])
            h = fluid.layers.fc(x, 8)
            if op == "matmul_transpose_x":   # hᵀh: a sum over the rows
                h = fluid.layers.matmul(h, h, transpose_x=True)
            elif op == "softmax_axis0":
                h = fluid.layers.softmax(h, axis=0)
            elif op == "transpose":
                h = fluid.layers.transpose(h, [1, 0])
            elif op == "sequence_pool":   # a LoD op: refused before it runs
                h = fluid.layers.sequence_pool(
                    fluid.layers.reshape(h, [-1, 2, 4]), "sum",
                    length=fluid.layers.data("len", [1], dtype="int64"))
            loss = fluid.layers.mean(h)
            fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        try:
            exe.run(prog, feed={"x": np.ones((4, 16), np.float32),
                                "len": np.full((4, 1), 2, np.int64)}
                    if op == "sequence_pool" else
                    {"x": np.ones((4, 16), np.float32)}, fetch_list=[loss])
        except NotImplementedError as e:
            return f"{type(e).__name__}: {e}"
    return None


CASES = {n[5:]: f for n, f in dict(globals()).items()
         if n.startswith("case_") and callable(f)}


# -- the world ----------------------------------------------------------------

def _serve(rank, world, store, conn):
    import torch

    torch.set_num_threads(1)
    from paddle_tpu_torch.parallel import init_parallel_env

    init_parallel_env(f"file://{store}", world, rank, device="cpu",
                      timeout=GROUP_TIMEOUT)
    import torch.distributed as dist

    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            name, kwargs = msg
            try:
                conn.send(("ok", CASES[name](**kwargs)))
            except Exception:  # reported to the test, which fails on it
                conn.send(("err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """n gloo ranks serving cases (see the module docstring)."""

    _count = 0

    def __init__(self, n: int, tmpdir: str):
        ctx = mp.get_context("spawn")
        # a new file for every world: a world started again after a failed
        # case must not meet the old world's addresses in its store
        World._count += 1
        store = os.path.join(str(tmpdir),
                             f"store-{n}-{os.getpid()}-{World._count}")
        self.n = n
        self.conns, self.procs = [], []
        for r in range(n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve, args=(r, n, store, child),
                            daemon=True)
            p.start()
            self.conns.append(parent)
            self.procs.append(p)

    def run(self, name, kwargs=None, timeout=CASE_TIMEOUT):
        """Run case `name` on every rank (`kwargs`: one dict for all, or a
        list with one a rank); returns the results in rank order."""
        per = kwargs if isinstance(kwargs, list) else [kwargs or {}] * self.n
        for c, kw in zip(self.conns, per):
            c.send((name, kw))
        out = []
        for r, c in enumerate(self.conns):
            if not c.poll(timeout):
                self.close()
                raise TimeoutError(f"rank {r} did not answer case {name!r} "
                                   f"within {timeout} s")
            status, val = c.recv()
            if status != "ok":
                self.close()
                raise RuntimeError(f"rank {r} failed case {name!r}:\n{val}")
            out.append(val)
        return out

    @property
    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def close(self):
        for c in self.conns:
            try:
                c.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(5)
