"""The port's Mixture-of-Experts (``parallel/moe.py``, the ``moe_ffn`` op,
``layers.moe_ffn``) against the JAX package on the CPU: twins of every
test of tests/test_moe.py. The router and the dense path run in this
process on the JAX tests' own inputs (numpy copies); the expert-parallel
path on gloo worlds of ep ranks (``torch_dist_runner.World``: one of 4 for
the file, one of 8 for the ep = 8 case), the JAX package on the same
number of its virtual devices.

Tolerances: the JAX tests' for expert-parallel against dense (values
rtol 2e-5, gradients rtol 5e-4 / atol 5e-5, the layer's losses rtol 2e-4);
the port against the JAX package on the same inputs rtol 1e-5 (single
ops) and 1e-4 (losses of several steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as jfluid
import torch_dist_runner as R
from paddle_tpu.parallel import moe as jmoe

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_worlds")
    live = {}

    def get(n=4):
        w = live.get(n)
        if w is None or not w.alive:
            w = live[n] = R.World(n, tmp)
        return w

    yield get
    for w in live.values():
        w.close()


def _params(d=16, h=32, e=8, seed=0):
    return [np.asarray(p) for p in jmoe.init_moe_params(
        jax.random.PRNGKey(seed), d, h, e)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_gating_capacity_and_weights():
    from paddle_tpu_torch.parallel import moe

    d, e, n = 16, 8, 64
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (n, d)))
    gw = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (d, e)) * 0.2)
    out = moe.top_k_gating(_t(x), _t(gw), k=2, capacity_factor=1.0)
    nc = out.dispatch.shape[2]
    assert out.dispatch.numpy().sum(axis=0).max() <= 1
    assert out.combine.numpy().sum(axis=(1, 2)).max() <= 1.0 + 1e-5
    assert nc == int(np.ceil(2 * n / e))
    assert np.isfinite(float(out.aux_loss))
    ref = jmoe.top_k_gating(jnp.asarray(x), jnp.asarray(gw), k=2,
                            capacity_factor=1.0)
    np.testing.assert_array_equal(out.dispatch.numpy(),
                                  np.asarray(ref.dispatch))
    np.testing.assert_allclose(out.combine.numpy(), np.asarray(ref.combine),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(out.aux_loss), float(ref.aux_loss),
                               rtol=1e-5)


def test_dense_moe_shapes_and_grads():
    from paddle_tpu_torch.parallel import moe

    d, h, e, n = 16, 32, 8, 32
    params = _params(d, h, e)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (n, d)))

    def jloss(ps):
        y, aux = jmoe.moe_ffn(jnp.asarray(x), *ps, k=2, capacity_factor=2.0)
        return jnp.mean(y ** 2) + 0.01 * aux

    jl, jg = jax.value_and_grad(jloss)(tuple(jnp.asarray(p) for p in params))
    ps = [_t(p).requires_grad_() for p in params]
    y, aux = moe.moe_ffn(_t(x), *ps, k=2, capacity_factor=2.0)
    loss = torch.mean(y ** 2) + 0.01 * aux
    loss.backward()
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for p, g in zip(ps, jg):
        assert np.isfinite(p.grad.numpy()).all()
        assert float(p.grad.abs().max()) > 0.0
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-6)


def _top1_frac(xs, gw, e):
    p = jax.nn.softmax(xs.astype(jnp.float32) @ gw, -1)
    return jnp.mean(jax.nn.one_hot(jnp.argmax(p, -1), e), axis=0)


def _prob_frac(xs, gw):
    return jnp.mean(jax.nn.softmax(xs.astype(jnp.float32) @ gw, -1), axis=0)


@pytest.mark.parametrize("ep", [4, 8])
def test_expert_parallel_matches_dense(worlds, ep):
    """The expert-parallel block on ep gloo ranks == the dense path on
    each rank's tokens (no token dropped); the aux loss is the pmean of
    the per-shard statistics. Against the JAX package's expert-parallel
    run on ep devices too."""
    d, h, e = 16, 32, 8
    n = 8 * 16
    params = _params(d, h, e)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (n, d)))
    got = worlds(ep).run("moe_expert_parallel", dict(
        x=x, params=params, k=2, cf=8.0))
    y_ep = np.concatenate([g["y"] for g in got])
    ys = [np.asarray(jmoe.moe_ffn(jnp.asarray(xs), *params, k=2,
                                  capacity_factor=8.0)[0])
          for xs in np.split(x, ep)]
    np.testing.assert_allclose(y_ep, np.concatenate(ys), rtol=2e-5,
                               atol=2e-5)
    jx = jnp.asarray(x)
    want_aux = float(e * jnp.sum(
        jnp.mean(jnp.stack([_top1_frac(s, params[0], e)
                            for s in jnp.split(jx, ep)]), 0)
        * jnp.mean(jnp.stack([_prob_frac(s, params[0])
                              for s in jnp.split(jx, ep)]), 0)))
    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))
    jy, jaux = jmoe.moe_ffn_expert_parallel(jx, *params, mesh, axis="ep",
                                            k=2, capacity_factor=8.0)
    np.testing.assert_allclose(y_ep, np.asarray(jy), rtol=1e-5, atol=1e-6)
    for g in got:
        np.testing.assert_allclose(g["aux"], want_aux, rtol=1e-4)
        np.testing.assert_allclose(g["aux"], float(jaux), rtol=1e-5)


def test_expert_parallel_grads_match_dense(worlds):
    """Gradients of sum(y²) + 0.1·aux through both all-to-alls: each
    rank's part summed over the ranks == the JAX package's expert-parallel
    gradients and its dense per-shard reference (rtol 5e-4, atol 5e-5)."""
    d, h, e, ep = 8, 16, 4, 4
    n = 4 * 8
    params = _params(d, h, e, seed=7)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (n, d)))
    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))

    def loss_ep(ps):
        y, aux = jmoe.moe_ffn_expert_parallel(
            jnp.asarray(x), *ps, mesh=mesh, axis="ep", k=1,
            capacity_factor=8.0)
        return jnp.sum(y ** 2) + 0.1 * aux

    def loss_dense(ps):
        tot = 0.0
        shards = jnp.split(jnp.asarray(x), ep)
        for xs in shards:
            y, _ = jmoe.moe_ffn(xs, *ps, k=1, capacity_factor=8.0)
            tot = tot + jnp.sum(y ** 2)
        f = jnp.mean(jnp.stack([_top1_frac(s, ps[0], e) for s in shards]), 0)
        p = jnp.mean(jnp.stack([_prob_frac(s, ps[0]) for s in shards]), 0)
        return tot + 0.1 * (e * jnp.sum(f * p))

    jp = tuple(jnp.asarray(p) for p in params)
    g_ep = jax.grad(loss_ep)(jp)
    g_dn = jax.grad(loss_dense)(jp)
    got = worlds(ep).run("moe_expert_parallel", dict(
        x=x, params=params, k=1, cf=8.0, grads=True))
    # each rank seeds its own sum(y²) and the whole aux term: the aux
    # term's gradient is counted once a rank, so take it out ep - 1 times
    summed = [sum(g["grads"][i] for g in got) for i in range(5)]
    aux_only = jax.grad(lambda ps: 0.1 * (e * jnp.sum(
        jnp.mean(jnp.stack([_top1_frac(s, ps[0], e)
                            for s in jnp.split(jnp.asarray(x), ep)]), 0)
        * jnp.mean(jnp.stack([_prob_frac(s, ps[0])
                              for s in jnp.split(jnp.asarray(x), ep)]), 0))))(
        jp)
    for i in range(5):
        port = summed[i] - (ep - 1) * np.asarray(aux_only[i])
        np.testing.assert_allclose(port, np.asarray(g_ep[i]), rtol=5e-4,
                                   atol=5e-5)
        np.testing.assert_allclose(port, np.asarray(g_dn[i]), rtol=5e-4,
                                   atol=5e-5)


def test_moe_under_jit_train_step(worlds):
    """The JAX test's jitted Adam step of the expert-parallel block, as a
    plain torch training step on 4 ranks (each rank's gradients summed,
    torch.optim.Adam(1e-3)): the loss falls, and both steps' losses equal
    the JAX package's same step on 4 devices (rtol 1e-4)."""
    import optax

    d, h, e, ep, n = 8, 16, 8, 4, 64
    params = _params(d, h, e, seed=9)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (n, d)))
    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))
    opt = optax.adam(1e-3)
    jp = tuple(jnp.asarray(p) for p in params)
    state = opt.init(jp)

    @jax.jit
    def step(ps, st, xv):
        def loss_fn(p):
            y, aux = jmoe.moe_ffn_expert_parallel(
                xv, *p, mesh=mesh, axis="ep", k=2, capacity_factor=2.0)
            return jnp.mean((y - xv) ** 2) + 0.01 * aux
        loss, grads = jax.value_and_grad(loss_fn)(ps)
        upd, st = opt.update(grads, st)
        return optax.apply_updates(ps, upd), st, loss

    p1, s1, l1 = step(jp, state, jnp.asarray(x))
    _, _, l2 = step(p1, s1, jnp.asarray(x))
    got = worlds().run("moe_train", dict(x=x, params=params))
    for losses in got:
        assert losses == got[0]
        assert losses[1] < losses[0]
        np.testing.assert_allclose(losses, [float(l1), float(l2)], rtol=1e-4)


def _layer_losses(fluid, steps, axes=None, state=None, **kw):
    """tests/test_moe.py's static-graph block (`R.build_moe_layer`) run on
    the plain executor of `fluid`, from `state` when given."""
    main, startup, loss = R.build_moe_layer(fluid, **kw)
    scope = fluid.Scope()
    feed = R.moe_feed(0)
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        if state is not None:
            fluid.io.load_params_from_numpy(state, scope=scope)
        return [float(np.asarray(exe.run(main, feed=feed,
                                         fetch_list=[loss])[0]))
                for _ in range(steps)]


def test_moe_layer_static_graph_trains():
    """layers.moe_ffn in a static program trains dense (the loss falls by
    a fifth in 15 Adam steps) and matches the JAX package's losses from
    the same parameters (rtol 1e-4)."""
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch.core import unique_name as tnames

    kw = dict(k=2, cf=4.0, experts=4, opt="adam")
    state = R.jax_state(jfluid, "moe", **kw)
    with tnames.guard():
        got = _layer_losses(tfluid, 15, state=state, **kw)
    want, _ = R.jax_run(jfluid, "moe", R.moe_feed(0), None, steps=15, **kw)
    assert got[-1] < got[0] * 0.8, (got[0], got[-1])
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_moe_layer_expert_parallel_matches_dense(worlds):
    """The same program over an ep mesh (the data axis, 4 gloo ranks, each
    rank its experts) == the plain executor's losses (rtol 2e-4, atol
    2e-5, the JAX test's) and the JAX package's run at the same mesh (rtol
    1e-5)."""
    feed = R.moe_feed()
    state = R.jax_state(jfluid, "moe")
    ref, _ = R.jax_run(jfluid, "moe", feed, None, steps=4)
    jep, _ = R.jax_run(jfluid, "moe", feed, {"ep": 4}, data_axis="ep",
                       steps=4)
    got = worlds().run("tp", [dict(model="moe", feed=R.rows(feed, r, 4),
                                   axes={"ep": 4}, data_axis="ep",
                                   state=state, steps=4, fetch_state=False)
                              for r in range(4)])
    for r in got:
        losses = [float(np.frombuffer(b, "float32").reshape(-1)[0])
                  for b in r["losses"]]
        np.testing.assert_allclose(losses, ref, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(losses, jep, rtol=1e-5, atol=1e-6)
        assert r["losses"] == got[0]["losses"]


def test_moe_layer_custom_param_attr_distinct_params():
    """A user-supplied param_attr yields five distinct parameters (a
    shared attr would alias all five under one name)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [8])
        h, aux = layers.moe_ffn(x, num_experts=2, hidden_size=4,
                                param_attr=fluid.ParamAttr(
                                    name="moe0", learning_rate=0.5))
    names = [v.name for v in main.global_block().all_parameters()]
    assert len(names) == len(set(names)) == 5, names
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        out = exe.run(main, feed={"x": np.zeros((4, 8), "float32")},
                      fetch_list=[h])
        assert out[0].shape == (4, 8)
