"""Rank helper of the port's fleet-and-cluster tests
(``tests/test_torch_localsgd_dgc.py``, ``tests/test_torch_planner.py``,
``tests/test_torch_cluster.py``): model functions that take the package
(``build_*(fluid, ...)``, so a test builds the same program with the JAX
package) and the cases the ranks of a
``torch_dist_runner.World(n, tmp, cases="torch_cluster_runner")`` serve.
Each rank imports torch and the port only, never jax or paddle_tpu.
"""
from __future__ import annotations

import numpy as np

import torch_dist_runner as R

# -- models (either package) --------------------------------------------------

# tests/test_sparse_row_updates.py's sizes
DEF_V, DEF_D, DEF_F, DEF_BB = 50, 4, 3, 8


def build_deferred(fluid):
    """test_deferred_fold_fires_under_compiled_program's program: an
    is_sparse table on the deferred-row log (Adagrad, 3 segments), a
    slice of its rows, the sum of squares. Returns (main, startup, loss
    name)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = layers.data("ids", [DEF_F], dtype="int64")
        emb = layers.embedding(ids, [DEF_V, 2 * DEF_D], is_sparse=True,
                               param_attr=fluid.ParamAttr(name="tb"))
        emb = layers.slice(emb, axes=[2], starts=[0], ends=[DEF_D])
        loss = layers.reduce_sum(layers.square(emb))
        fluid.optimizer.Adagrad(0.05, deferred_rows={
            "rows_per_step": DEF_BB * DEF_F, "segments": 3}).minimize(loss)
    return main, startup, loss.name


def deferred_feeds():
    rng = np.random.RandomState(1)
    return [{"ids": rng.randint(0, DEF_V, (DEF_BB, DEF_F)).astype("int64")}
            for _ in range(9)]


def deferred_table(start):
    """The JAX test's table draw, on the visible columns only: its draw
    over the whole row overwrites the Adagrad state columns with negative
    accumulators, and every loss after the first step is NaN in both
    packages. The state columns keep `start`'s (the startup's) values."""
    t = np.array(start, dtype="float32", copy=True)
    t[:, :DEF_D] = np.random.RandomState(7).uniform(
        -1, 1, (DEF_V, 2 * DEF_D)).astype("float32")[:, :DEF_D]
    return t


def build_dgc_mlp(fluid, dgc=True, sparsity=(0.75,), rampup_begin=2,
                  rampup_step=1, lr=0.05):
    """The zero-sharding MLP's layers (fc 16→32→13→1, a 13-row weight and
    13- and 1-element biases) under DGCMomentumOptimizer (or Momentum)."""
    from_np = fluid.initializer.NumpyArrayInitializer
    rng = np.random.RandomState(7)

    def attr(name, shape):
        w = (rng.rand(*shape).astype("float32") - 0.5) * 0.2
        return fluid.ParamAttr(name=name, initializer=from_np(w))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 32, act="relu", param_attr=attr("dw0", (16, 32)),
                            bias_attr=attr("db0", (32,)))
        h = fluid.layers.fc(h, 13, act="relu", param_attr=attr("dw1", (32, 13)),
                            bias_attr=attr("db1", (13,)))
        out = fluid.layers.fc(h, 1, param_attr=attr("dw2", (13, 1)),
                              bias_attr=attr("db2", (1,)))
        loss = fluid.layers.mean(fluid.layers.square(out - y))
        if dgc:
            opt = fluid.optimizer.DGCMomentumOptimizer(
                lr, 0.9, rampup_begin_step=rampup_begin,
                rampup_step=rampup_step, sparsity=list(sparsity))
        else:
            opt = fluid.optimizer.Momentum(lr, 0.9)
        opt.minimize(loss)
    return main, startup, loss.name


def dgc_mlp_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.rand(32, 1).astype("float32")}


# -- cases (run on every rank) ------------------------------------------------

def _rank():
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def case_local_sgd(x, y, w0, k_steps=3, lr=0.2, steps=9):
    """tests/test_localsgd_dgc.py's linear regression under local SGD:
    this rank's replica trains on its rows of (x, y). Returns the mean
    loss a step, every replica after each step (an all-gather, for the
    spread) and the spread after an explicit average_params."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import (average_params, local_sgd_step,
                                           replicate_params)

    rank, n = _rank()
    rows = x.shape[0] // n
    bx = torch.from_numpy(x[rank * rows:(rank + 1) * rows])
    by = torch.from_numpy(y[rank * rows:(rank + 1) * rows])
    mine = torch.from_numpy(w0) if rank == 0 else torch.zeros_like(
        torch.from_numpy(w0))
    params = replicate_params({"w": mine}, n)

    def grad_fn(p, batch):
        w = p["w"].detach().requires_grad_()
        loss = torch.mean((batch[0] @ w - batch[1]) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        return loss.detach(), {"w": g}

    def replicas(p):
        out = [torch.empty_like(p["w"]) for _ in range(n)]
        dist.all_gather(out, p["w"].contiguous())
        return np.stack([o.numpy() for o in out])

    step = local_sgd_step(grad_fn, k_steps=k_steps, lr=lr)
    losses, reps = [], []
    for i in range(steps):
        params, loss = step(params, (bx, by), i)
        losses.append(float(loss))
        reps.append(replicas(params))
    avg = replicas(average_params(params))
    return {"losses": losses, "replicas": reps, "averaged": avg}


def case_dgc_exchange(g, ratio, residual=None):
    """Both exchanges of rank r's row of `g` (and of `residual`): the
    summed gradients, the new residuals and the bytes each form puts on
    the wire from this rank."""
    import torch

    from paddle_tpu_torch.parallel import (dgc_allreduce,
                                           sparse_allgather_exchange)

    rank, n = _rank()
    gi = torch.from_numpy(g[rank])
    ri = (torch.zeros_like(gi) if residual is None
          else torch.from_numpy(residual[rank]))
    dense, dres = dgc_allreduce(gi, ri, ratio=ratio)
    sparse, sres = sparse_allgather_exchange(gi, ri, ratio=ratio)
    k = max(1, int(gi.numel() * ratio))
    return {"dense": dense.numpy(), "dense_res": dres.numpy(),
            "sparse": sparse.numpy(), "sparse_res": sres.numpy(),
            "dense_bytes": gi.numel() * gi.element_size(),
            "sparse_bytes": k * (gi.element_size() + 8)}


def case_dgc_train(x, y, ratio=0.05, steps=60, lr=0.3):
    """tests/test_localsgd_dgc.py's DGC linear regression: this rank's
    gradient on its rows, exchanged by dgc_allreduce; the loss on the
    whole (x, y) after each step."""
    import torch

    from paddle_tpu_torch.parallel import dgc_allreduce

    rank, n = _rank()
    rows = x.shape[0] // n
    xs = torch.from_numpy(x[rank * rows:(rank + 1) * rows])
    ys = torch.from_numpy(y[rank * rows:(rank + 1) * rows])
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    w = torch.zeros((x.shape[1], 1))
    resid = torch.zeros_like(w)
    losses = []
    for _ in range(steps):
        wg = w.detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.mean((xs @ wg - ys) ** 2), [wg])
        summed, resid = dgc_allreduce(g, resid, ratio=ratio)
        w = w - lr * summed / n
        losses.append(float(torch.mean((X @ w - Y) ** 2)))
    return losses


def case_dgc_program(feed, stage, steps=4, dgc=True, kw=None):
    """build_dgc_mlp through with_data_parallel at ZeRO `stage` on this
    rank's `feed` rows: the losses (bytes) and the final logical state."""
    fluid, names = R._port()
    with names.guard():
        main, startup, loss = build_dgc_mlp(fluid, dgc, **(kw or {}))
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        bs = fluid.BuildStrategy()
        bs.sharding_strategy = stage
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss, build_strategy=bs)
        losses = [np.asarray(exe.run(prog, feed=feed,
                                     fetch_list=[loss])[0]).tobytes()
                  for _ in range(steps)]
        return {"losses": losses, "state": R._logical_state(main, scope),
                "info": R._state_info(main, scope)}


def case_deferred(feeds, compiled=True, how="run"):
    """build_deferred from `deferred_table` over this rank's rows of each
    feed,
    through with_data_parallel (or the plain executor): the loss a step
    (run, run_batched in drains of 3, or train_scanned with scan_steps
    3), the log count after the last step and the table."""
    import torch

    fluid, names = R._port()
    rank, n = _rank()
    with names.guard():
        main, startup, loss = build_deferred(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    mine = [R.rows(f, rank, n) for f in feeds] if compiled else feeds
    with fluid.scope_guard(scope):
        exe.run(startup)
        table = deferred_table(scope.find_var("tb").numpy())
        scope.set_var("tb", torch.from_numpy(table))
        prog = (fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss) if compiled else main)
        if how == "run":
            out = [float(np.asarray(exe.run(prog, feed=f,
                                            fetch_list=[loss])[0]))
                   for f in mine]
        elif how == "batched":
            out = []
            for i in range(0, len(mine), 3):
                got = exe.run_batched(prog, mine[i:i + 3], fetch_list=[loss])
                out += [float(v) for v in np.asarray(got[0]).reshape(-1)]
        else:
            got = exe.train_scanned(prog, reader=lambda: iter(mine),
                                    scan_steps=3, fetch_list=[loss])
            out = [float(v) for v in np.asarray(got[0]).reshape(-1)]
        count = int(np.asarray(R._logical_state(
            main, scope, ["tb@log_count"])["tb@log_count"]).ravel()[0])
        table_now = R._logical_state(main, scope, ["tb"])["tb"]
    return {"losses": out, "count": count, "table": table_now}


def case_plan_estimates(feed, stages=(0, 1, 3), budget=None, oom_rank=None):
    """planner.estimate_plan of build_zero_mlp (Adam) at each ZeRO stage
    on this rank's `feed` rows (the group's largest, on every rank), and,
    with `budget`, the plan plan_for chooses. On rank `oom_rank` each
    second (measured) step of stage 0 raises torch.cuda.OutOfMemoryError
    after it ran (its collectives done, as when the fetch fails)."""
    import torch

    fluid, names = R._port()
    from paddle_tpu_torch import planner
    from paddle_tpu_torch.parallel.env import get_rank

    with names.guard():
        main, _startup, loss = R.build_zero_mlp(fluid, "adam")
    if oom_rank == get_rank():
        real = fluid.Executor.run
        runs = []

        def run(self, program, *a, **kw):
            out = real(self, program, *a, **kw)
            if _stage(program) == 0:
                runs.append(1)
                if len(runs) % 2 == 0:  # each measured step
                    raise torch.cuda.OutOfMemoryError(
                        "CUDA out of memory. Tried to allocate 2.00 GiB")
            return out

        fluid.Executor.run = run
    est = {s: planner.estimate_plan(planner.Plan(s, "none", 1), main, feed,
                                    loss, place=fluid.CPUPlace()).to_dict()
           for s in stages}
    chosen = None
    if budget is not None:
        chosen = planner.plan_for(main, feed, loss, budget_bytes=budget,
                                  place=fluid.CPUPlace()).to_dict()
    return {"est": est, "chosen": chosen}


def _stage(program):
    """The ZeRO knob of a CompiledProgram's build strategy (None for a
    plain Program)."""
    bs = getattr(program, "build_strategy", None)
    return None if bs is None else int(bs.sharding_strategy)


CASES = {n[5:]: f for n, f in dict(globals()).items()
         if n.startswith("case_") and callable(f)}
