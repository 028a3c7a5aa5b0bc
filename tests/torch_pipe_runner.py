"""Rank helper of the port's pipeline and sequence-parallel tests
(``tests/test_torch_pipeline.py``, ``tests/test_torch_pipeline_composed.py``,
``tests/test_torch_seq_parallel.py``): model functions that take the package
(``build_*(fluid, ...)``, so a test builds the same program with the JAX
package) and the cases the ranks of a ``torch_dist_runner.World(n, tmp,
cases="torch_pipe_runner")`` serve. Each rank imports torch and the port
only, never jax or paddle_tpu.
"""
from __future__ import annotations

import hashlib
import importlib
import os

import numpy as np

# -- models (either package) --------------------------------------------------


def _bert(fluid):
    return importlib.import_module(fluid.__name__ + ".models.bert")


def build_pipe_bert(fluid, pp_cut=True, num_layers=2, micro=2,
                    pipe_data_axis=None, opt="sgd", lr=0.1, tp_axis=None,
                    drop=0.0, flash=False, seed=11, clip=None):
    """tests/test_pipeline_optimizer.py's `_build` (and, with `tp_axis`,
    tests/test_parallel.py's composed program): tiny BERT cut by layers;
    `clip`: the optimizer's GradientClipByGlobalNorm(clip). Returns (main,
    startup, loss name)."""
    bert = _bert(fluid)
    layers = fluid.layers
    cfg = bert.BertConfig(vocab_size=64, hidden_size=16,
                          num_layers=num_layers, num_heads=2, ffn_size=32,
                          max_position=16, hidden_dropout=drop,
                          attn_dropout=drop, use_flash_attention=flash,
                          tp_axis=tp_axis)
    T = 8
    kw = {}
    if clip is not None:
        kw["grad_clip"] = fluid.clip.GradientClipByGlobalNorm(clip)
    opts = {"sgd": lambda: fluid.optimizer.SGD(lr, **kw),
            "adam": lambda: fluid.optimizer.Adam(lr, **kw)}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        main.random_seed = startup.random_seed = seed
        src = layers.data("src_ids", [T], dtype="int64")
        pos = layers.data("pos_ids", [T], dtype="int64")
        sent = layers.data("sent_ids", [T], dtype="int64")
        mask = layers.data("input_mask", [T], dtype="float32")
        lab = layers.data("mlm_labels", [T, 1], dtype="int64")
        # mask built BEFORE the pipelined region so it's a stage capture
        neg = layers.scale(layers.elementwise_add(
            mask, layers.fill_constant([1], "float32", -1.0)), scale=10000.0)
        mask3 = layers.unsqueeze(neg, [1])
        emb = bert.embeddings(cfg, src, pos, sent, is_test=False)
        cuts = [emb]
        x = emb
        for i in range(cfg.num_layers):
            x = bert.encoder_layer(cfg, x, mask3, i, is_test=False)
            cuts.append(x)
        loss = bert.bert_pretrain_loss(cfg, x, lab, mask)
        inner = opts[opt]()
        if pp_cut:
            inner = fluid.optimizer.PipelineOptimizer(
                inner, cut_list=cuts, num_microbatches=micro,
                data_axis=pipe_data_axis)
        inner.minimize(loss)
    return main, startup, loss.name


def pipe_bert_feed(B=8, T=8):
    return {"src_ids": np.random.RandomState(0).randint(0, 64, (B, T))
            .astype("int64"),
            "pos_ids": np.tile(np.arange(T), (B, 1)).astype("int64"),
            "sent_ids": np.zeros((B, T), "int64"),
            "input_mask": np.ones((B, T), "float32"),
            "mlm_labels": np.random.RandomState(1).randint(0, 64, (B, T, 1))
            .astype("int64")}


def composed_feed(B=4, T=8):
    """tests/test_parallel.py's composed program's feed."""
    rng = np.random.RandomState(0)
    return {"src_ids": rng.randint(0, 64, (B, T)).astype("int64"),
            "pos_ids": np.tile(np.arange(T), (B, 1)).astype("int64"),
            "sent_ids": np.zeros((B, T), "int64"),
            "input_mask": np.ones((B, T), "float32"),
            "mlm_labels": rng.randint(0, 64, (B, T, 1)).astype("int64")}


def build_hetero_mlp(fluid, pp_cut=True):
    """tests/test_pipeline_optimizer.py's non-isomorphic program (8 → 24 →
    12 | 12 → 6, a 4-class head). Returns (main, startup, loss name)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        main.random_seed = startup.random_seed = 5
        x = layers.data("x", [8])
        lab = layers.data("label", [1], dtype="int64")
        h0 = layers.scale(x, scale=1.0)
        h = layers.fc(h0, 24, act="relu",
                      param_attr=fluid.ParamAttr(name="s1a.w"))
        h1 = layers.fc(h, 12, act="tanh",
                       param_attr=fluid.ParamAttr(name="s1b.w"))
        h2 = layers.fc(h1, 6, act="relu",
                       param_attr=fluid.ParamAttr(name="s2.w"))
        logits = layers.fc(h2, 4, param_attr=fluid.ParamAttr(name="head.w"))
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, lab))
        inner = fluid.optimizer.SGD(0.1)
        if pp_cut:
            inner = fluid.optimizer.PipelineOptimizer(
                inner, cut_list=[h0, h1, h2], num_microbatches=2)
        inner.minimize(loss)
    return main, startup, loss.name


def hetero_mlp_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(8, 8).astype("float32"),
            "label": rng.randint(0, 4, (8, 1)).astype("int64")}


def build_relu_tanh(fluid, pp_cut=True):
    """tests/test_pipeline_optimizer.py's two stages that differ in their
    activation (relu, tanh): the hetero lowering."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [4])
        h1 = layers.fc(x, 4, act="relu")
        h2 = layers.fc(h1, 4, act="tanh")
        loss = layers.reduce_mean(h2)
        inner = fluid.optimizer.SGD(0.1)
        if pp_cut:
            inner = fluid.optimizer.PipelineOptimizer(
                inner, cut_list=[x, h1, h2])
        inner.minimize(loss)
    return main, startup, loss.name


def build_fc_dropout(fluid, pp_cut=True):
    """tests/test_pipeline_optimizer.py's dropout program: two fc +
    dropout 0.5 stages, SGD(0) (any change of the loss is a new mask)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        main.random_seed = startup.random_seed = 3
        x = layers.data("x", [8])
        cuts = [x]
        h = x
        for i in range(2):
            h = layers.fc(h, 8, act="relu",
                          param_attr=fluid.ParamAttr(name=f"w{i}"),
                          bias_attr=fluid.ParamAttr(name=f"b{i}"))
            h = layers.dropout(h, 0.5,
                               dropout_implementation="upscale_in_train")
            cuts.append(h)
        loss = layers.reduce_mean(h)
        inner = fluid.optimizer.SGD(0.0)
        if pp_cut:
            inner = fluid.optimizer.PipelineOptimizer(
                inner, cut_list=cuts, num_microbatches=2)
        inner.minimize(loss)
    return main, startup, loss.name


def build_hetero_dropout(fluid, pp_cut=True):
    """The hetero program whose first stage is one dropout of a scaled
    all-ones input: a microbatch's output rows show its mask. Returns
    (main, startup, loss name, the name of h2)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        main.random_seed = startup.random_seed = 11
        x = layers.data("x", [64])
        h0 = layers.scale(x, scale=1.0)
        h1 = layers.dropout(h0, 0.5,
                            dropout_implementation="upscale_in_train")
        h2 = layers.scale(h1, scale=1.0)
        logits = layers.fc(h2, 4, param_attr=fluid.ParamAttr(name="hd.w"))
        lab = layers.data("label", [1], dtype="int64")
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, lab))
        inner = fluid.optimizer.SGD(0.1)
        if pp_cut:
            inner = fluid.optimizer.PipelineOptimizer(
                inner, cut_list=[h0, h1, h2], num_microbatches=2)
        inner.minimize(loss)
    return main, startup, loss.name, h2.name


def build_iso_dropout(fluid, pp_cut=True):
    """Two isomorphic scale + dropout stages on an all-ones input.
    Returns (main, startup, loss name, the last cut's name)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        main.random_seed = startup.random_seed = 13
        x = layers.data("x", [64])
        cuts = [x]
        h = x
        for _ in range(2):
            h = layers.scale(h, scale=1.0)
            h = layers.dropout(h, 0.5,
                               dropout_implementation="upscale_in_train")
            cuts.append(h)
        loss = layers.reduce_mean(h)
        inner = fluid.optimizer.SGD(0.0)
        if pp_cut:
            inner = fluid.optimizer.PipelineOptimizer(
                inner, cut_list=cuts, num_microbatches=2)
        inner.minimize(loss)
    return main, startup, loss.name, cuts[-1].name


def build_seq_bert(fluid, drop=0.0, flash=False, tp_axis=None, layers_n=1,
                   opt="sgd"):
    """tests/test_parallel.py's sequence-axis BERT (hidden 16, 2 heads, B
    = 4, T = 8); with `flash` and `drop` the fused attention with dropout
    (hidden 32, 4 heads, T = 16)."""
    bert = _bert(fluid)
    if flash:
        cfg = bert.BertConfig(vocab_size=64, hidden_size=32,
                              num_layers=layers_n, num_heads=4, ffn_size=64,
                              max_position=16, hidden_dropout=drop,
                              attn_dropout=drop, use_flash_attention=True,
                              tp_axis=tp_axis)
        B, T = 4, 16
    else:
        cfg = bert.BertConfig(vocab_size=64, hidden_size=16,
                              num_layers=layers_n, num_heads=2, ffn_size=32,
                              max_position=16, hidden_dropout=drop,
                              attn_dropout=drop, use_flash_attention=False,
                              tp_axis=tp_axis)
        B, T = 4, 8
    factory = {"sgd": None,
               "adam": lambda: fluid.optimizer.Adam(1e-3)}[opt]
    kw = {"optimizer_factory": factory} if factory else {}
    main, startup, _, loss = bert.build_pretrain_program(cfg, B, T, **kw)
    main.random_seed = 7
    return main, startup, loss.name


def seq_bert_feed(B=4, T=8):
    """tests/test_parallel.py's seq_axis feed (and the same draws at other
    sizes; with T = 16 the last 3 positions are padding)."""
    rng = np.random.RandomState(0)
    feed = {"src_ids": rng.randint(0, 64, (B, T)).astype("int64"),
            "pos_ids": np.tile(np.arange(T), (B, 1)).astype("int64"),
            "sent_ids": np.zeros((B, T), "int64"),
            "input_mask": np.ones((B, T), "float32"),
            "mlm_labels": rng.randint(0, 64, (B, T, 1)).astype("int64")}
    if T == 16:
        feed["input_mask"][:, 13:] = 0.0
    return feed


def build_shared_table(fluid, spec=True):
    """Two isomorphic stages that read a [4, 4] prologue table whose
    leading dim equals the batch (4): by the shape rule it would be
    microbatched; ``capture_spec={name: "shared"}`` passes it whole."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        main.random_seed = startup.random_seed = 17
        x = layers.data("x", [4])
        tbl = layers.scale(layers.fill_constant([4, 4], "float32", 0.25),
                           scale=1.0)
        h = layers.scale(x, scale=1.0)   # the pipelined region starts here
        cuts = [h]
        for i in range(2):
            h = layers.fc(h, 4, param_attr=fluid.ParamAttr(name=f"sw{i}"),
                          bias_attr=False)
            h = layers.tanh(layers.reshape(layers.matmul(h, tbl), [-1, 4]))
            cuts.append(h)
        loss = layers.reduce_mean(h)
        fluid.optimizer.PipelineOptimizer(
            fluid.optimizer.SGD(0.5), cut_list=cuts, num_microbatches=2,
            capture_spec={tbl.name: "shared"} if spec else None
        ).minimize(loss)
    return main, startup, loss.name


def shared_table_feed():
    return {"x": np.random.RandomState(2).rand(4, 4).astype("float32")}


MODELS = {"pipe_bert": build_pipe_bert, "shared_table": build_shared_table,
          "hetero_mlp": build_hetero_mlp,
          "relu_tanh": build_relu_tanh, "fc_dropout": build_fc_dropout,
          "hetero_dropout": build_hetero_dropout,
          "iso_dropout": build_iso_dropout, "seq_bert": build_seq_bert}


def build(fluid, model, **kw):
    """(main, startup, loss name, other names) of a MODELS entry."""
    got = MODELS[model](fluid, **kw)
    return got[0], got[1], got[2], got[3:]


def jax_state(jfluid, model, **kw):
    """The JAX package's startup state of a model (numpy)."""
    from paddle_tpu.core import unique_name as jn

    with jn.guard():
        main, startup, _, _ = build(jfluid, model, **kw)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.TPUPlace()).run(startup)
        return {v.name: np.asarray(scope.find_var(v.name))
                for v in main.list_vars()
                if v.persistable and scope.find_var(v.name) is not None}


def jax_run(jfluid, model, feed, axes=None, data_axis=None, seq_axis=None,
            steps=3, state=None, fetch_other=False, **kw):
    """The JAX package's losses of a model on one device (`axes` None) or
    on a mesh of the test process's devices; with `fetch_other` also the
    build function's other names fetched at the last step."""
    from paddle_tpu.core import unique_name as jn
    from paddle_tpu.parallel import make_mesh

    with jn.guard():
        main, startup, loss, other = build(jfluid, model, **kw)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.TPUPlace())
        exe.run(startup)
        for n, v in (state or {}).items():
            scope.set_var(n, v)
        prog = main
        if axes is not None:
            prog = jfluid.CompiledProgram(main).with_mesh(
                make_mesh(axes), data_axis=data_axis, seq_axis=seq_axis)
        fl = [loss] + (list(other) if fetch_other else [])
        out = [exe.run(prog, feed=feed, fetch_list=fl) for _ in range(steps)]
    return ([float(np.asarray(o[0]).reshape(-1)[0]) for o in out],
            [np.asarray(v) for v in out[-1][1:]])


# -- cases (run on every rank) ------------------------------------------------

def _port():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import unique_name

    return fluid, unique_name


def _hashes(main, scope):
    """sha1 of the bytes of every persistable this rank holds whole and
    that no axis splits (no DTensor, no pipeline stage's value)."""
    from paddle_tpu_torch.core.dtypes import to_numpy
    from paddle_tpu_torch.core.mesh_step import StageValue, is_dtensor

    out = {}
    for v in main.list_vars():
        val = scope.find_var(v.name)
        if (not v.persistable or val is None or is_dtensor(val)
                or isinstance(val, StageValue) or not hasattr(val, "shape")):
            continue
        out[v.name] = hashlib.sha1(to_numpy(val).tobytes()).hexdigest()
    return out


def _stage_info(main, scope):
    """(names held as a pipeline stage's value, the ones this rank holds,
    their bytes on this rank)."""
    from paddle_tpu_torch.core.mesh_step import StageValue, is_dtensor

    staged, mine, nbytes = [], [], 0
    for v in main.list_vars():
        val = scope.find_var(v.name)
        if isinstance(val, StageValue):
            staged.append(v.name)
            if val.mine:
                mine.append(v.name)
                loc = val.local.to_local() if is_dtensor(val.local) \
                    else val.local
                nbytes += loc.numel() * loc.element_size()
    return sorted(staged), sorted(mine), nbytes


def _probe_attention(seen):
    """Record the query length of every fused-attention call (the port's
    ``flash_attention_packed`` in its op)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    real = fa.flash_attention_packed

    def probe(q, k, v, *a, **kw):
        seen.append((int(q.shape[1]), int(k.shape[1])))
        return real(q, k, v, *a, **kw)

    fa.flash_attention_packed = probe
    return lambda: setattr(fa, "flash_attention_packed", real)


def case_pipe(model, feed, axes=None, data_axis=None, seq_axis=None,
              model_kw=None, state=None, steps=3, fetch_other=False,
              fetch=(), save=None, restore=None, logical=False,
              probe=False, persist=None, load=None):
    """Build a MODELS model, start from `state` (the JAX startup's) or the
    port's startup, and run `steps` steps of this rank's `feed` on a mesh
    of `axes` (or the plain executor). Returns the losses, the hashes of
    the replicated persistables after each step, the build function's other
    names and `fetch` at the last step, the op types, the stage values
    (names, this rank's, their bytes), the restored step; with `logical`
    every persistable's whole value; `save` writes a checkpoint after the
    steps, `restore` reads one before them; `persist` has every rank write
    ``io.save_persistables`` into its own folder under it after the steps,
    `load` reads them with ``io.load_persistables`` before; with `probe`
    the (query, key) lengths of every fused-attention call."""
    fluid, names = _port()
    from paddle_tpu_torch.core.dtypes import to_numpy
    from paddle_tpu_torch.core.mesh_step import logical_value
    from paddle_tpu_torch.parallel import Checkpointer, make_mesh

    with names.guard():
        main, startup, loss, other = build(fluid, model, **(model_kw or {}))
    types = [op.type for op in main.global_block().ops]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    result = {"types": types}
    with fluid.scope_guard(scope):
        exe.run(startup)
        if state is not None:
            fluid.io.load_params_from_numpy(state, scope=scope)
        if restore is not None:
            result["restored"] = Checkpointer(restore).restore(
                program=main, scope=scope, place=fluid.CPUPlace())
        if load is not None:
            result["missing"] = fluid.io.load_persistables(exe, load, main)
        prog = main
        if axes is not None:
            prog = fluid.CompiledProgram(main).with_mesh(
                make_mesh(axes), data_axis=data_axis, seq_axis=seq_axis)
        fl = [loss] + (list(other) if fetch_other else []) + list(fetch)
        losses, hashes, out, seen = [], [], [], []
        undo = _probe_attention(seen) if probe else (lambda: None)
        try:
            for _ in range(steps):
                out = exe.run(prog, feed=feed, fetch_list=fl)
                losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
                hashes.append(_hashes(main, scope))
        finally:
            undo()
        result["attention"] = sorted(set(seen))
        result.update(losses=losses, hashes=hashes,
                      fetched=[np.asarray(o) for o in out[1:]],
                      stages=_stage_info(main, scope))
        if logical:
            state = {}
            for v in main.list_vars():
                val = scope.find_var(v.name)
                if v.persistable and hasattr(val, "shape"):
                    state[v.name] = to_numpy(logical_value(main, v.name,
                                                           val))
            result["state"] = state
        if save is not None:
            Checkpointer(save, keep=0).save(3, program=main, scope=scope,
                                            blocking=True)
            result["files"] = sorted(os.listdir(save))
        if persist is not None:
            import torch.distributed as dist

            rank = dist.get_rank() if dist.is_initialized() else 0
            fluid.io.save_persistables(
                exe, os.path.join(persist, f"rank{rank}"), main)
    return result


def _mesh(axes):
    from paddle_tpu_torch.parallel import make_mesh

    return make_mesh(axes)


def case_gpipe(w, xs, axes, grad=False):
    """parallel.GPipe(tanh(x @ w)) with this rank's stage weight `w[i]`:
    the outputs, and with `grad` the gradient of sum(out ** 2) for the
    rank's weight."""
    import torch

    from paddle_tpu_torch.parallel import GPipe
    from paddle_tpu_torch.parallel.collective import axis_index

    mesh = _mesh(axes)
    i = axis_index((mesh, "pp"))
    mine = torch.tensor(w[i]).requires_grad_(grad)
    pipe = GPipe(lambda p, x: torch.tanh(x @ p), mesh, "pp")
    out = pipe(mine, torch.tensor(xs))
    res = {"out": out.detach().numpy(), "stage": i}
    if grad:
        (out ** 2).sum().backward()
        res["grad"] = mine.grad.numpy()
    return res


def case_1f1b(w, b, xs, axes):
    """parallel.pipeline_1f1b on tanh(x @ w + b) stages, loss mean(out²):
    the loss, this rank's gradients and the schedule's info."""
    import torch

    from paddle_tpu_torch.parallel import pipeline_1f1b
    from paddle_tpu_torch.parallel.collective import axis_index

    mesh = _mesh(axes)
    i = axis_index((mesh, "pp"))

    def stage_fn(params, payload):
        wi, bi = params
        (x,) = payload
        return (torch.tanh(x @ wi + bi),)

    loss, grads, info = pipeline_1f1b(
        stage_fn, (torch.tensor(w[i]), torch.tensor(b[i])),
        (torch.tensor(xs),), lambda o: torch.mean(o ** 2), mesh, "pp")
    return {"loss": float(loss), "dW": grads[0].numpy(),
            "dB": grads[1].numpy(), "info": info, "stage": i}


def case_hetero(w0, w1, b1, xs, scale, axes):
    """parallel.pipeline_hetero over tanh(x @ w0) * s and relu(x @ w1 +
    b1) ** 2 (8 → 12 → 6): the outputs, the loss mean(out²) and this
    rank's stage gradients."""
    import torch

    from paddle_tpu_torch.parallel import pipeline_hetero
    from paddle_tpu_torch.parallel.collective import axis_index

    mesh = _mesh(axes)
    i = axis_index((mesh, "pp"))
    params = [torch.tensor(w0).requires_grad_(),
              (torch.tensor(w1).requires_grad_(),
               torch.tensor(b1).requires_grad_())]

    def stage0(p, x, cap):
        (s,) = cap
        return torch.tanh(x @ p) * s

    def stage1(p, x, cap):
        w, b = p
        return torch.relu(x @ w + b) ** 2

    out = pipeline_hetero([stage0, stage1], params, torch.tensor(xs), mesh,
                          "pp", caps=((torch.tensor(scale),), ()))
    loss = torch.mean(out ** 2)
    loss.backward()
    grads = ([params[0].grad.numpy()] if i == 0 else
             [params[1][0].grad.numpy(), params[1][1].grad.numpy()])
    return {"out": out.detach().numpy(), "loss": float(loss),
            "grads": grads, "stage": i}


def case_hetero_checks(axes):
    """The JAX package's ValueErrors of pipeline_hetero: a stage that
    changes the microbatch dim, one whose output dtype is not the
    payload's."""
    import torch

    from paddle_tpu_torch.parallel import pipeline_hetero

    mesh = _mesh(axes)
    xs = torch.zeros(2, 4, 8)
    got = {}
    for label, fns in (
            ("mb", [lambda p, x, c: x[:2], lambda p, x, c: x]),
            ("dtype", [lambda p, x, c: x.double(), lambda p, x, c: x])):
        try:
            pipeline_hetero(fns, [torch.zeros(1), torch.zeros(1)], xs, mesh,
                            "pp")
            got[label] = None
        except ValueError as e:
            got[label] = str(e)
    return got


def case_surface(world_axes):
    """What the pipeline and sequence surface refuses on a mesh, naming
    the JAX package's errors; and the meshes that run: seq_bert on an sp
    dim without seq_axis, an ep dim beside the data axis and two model
    axes no spec names (each computes replicated), a step each on this
    rank's rows, their losses beside the plain run's (``plain``)."""
    import torch.distributed as dist

    fluid, names = _port()
    from paddle_tpu_torch.parallel import make_mesh

    got = {}

    def attempt(label, fn):
        try:
            got[label] = fn()
        except (NotImplementedError, ValueError) as e:
            got[label] = f"{type(e).__name__}: {e}"

    def run_bert(micro, axes, data_axis=None, B=8):
        with names.guard():
            main, startup, loss, _ = build(fluid, "pipe_bert", micro=micro)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            prog = fluid.CompiledProgram(main).with_mesh(
                make_mesh(axes), data_axis=data_axis)
            exe.run(prog, feed=pipe_bert_feed(B), fetch_list=[loss])

    with names.guard():
        main, startup, loss, _ = build(fluid, "seq_bert")
    feed = seq_bert_feed()
    exe = fluid.Executor(fluid.CPUPlace())

    def step(axes, data_axis):
        prog = main if axes is None else fluid.CompiledProgram(
            main).with_mesh(make_mesh(axes), data_axis=data_axis)
        fd = feed if data_axis is None else {
            k: v.reshape((2, -1) + v.shape[1:])[dist.get_rank() // 2]
            for k, v in feed.items()}
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            return float(np.asarray(exe.run(prog, feed=fd,
                                            fetch_list=[loss])[0]))

    attempt("batch_micro", lambda: run_bert(3, world_axes))
    attempt("stages_axis", lambda: run_bert(2, {"pp": 4}))
    attempt("seq_is_data", lambda: fluid.CompiledProgram(main).with_mesh(
        make_mesh({"dp": 2, "sp": 2}), data_axis="sp", seq_axis="sp"))
    got["plain"] = step(None, None)
    attempt("sp_without_seq", lambda: step({"dp": 2, "sp": 2}, "dp"))
    attempt("ep_not_data", lambda: step({"dp": 2, "ep": 2}, "dp"))
    attempt("two_model_axes", lambda: step({"tp": 2, "mp": 2}, None))
    return got


def case_seq_feed_check():
    """check_feeds on a sequence axis: a feed whose dim 1 the axis does
    not divide raises on every rank."""
    fluid, names = _port()
    from paddle_tpu_torch.parallel import make_mesh

    with names.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [5, 4])
            loss = fluid.layers.mean(fluid.layers.fc(x, 3,
                                                     num_flatten_dims=2))
            fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        prog = fluid.CompiledProgram(main).with_mesh(
            make_mesh({"dp": 2, "sp": 2}), data_axis="dp", seq_axis="sp")
        try:
            exe.run(prog, feed={"x": np.ones((2, 5, 4), "float32")},
                    fetch_list=[loss])
        except ValueError as e:
            return str(e)
    return None


CASES = {n[5:]: f for n, f in dict(globals()).items()
         if n.startswith("case_") and callable(f)}
