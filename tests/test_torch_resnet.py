"""The port's ResNet training path against the JAX package's, on the CPU.

Both switches of the fused path are on (``PDTPU_CONV_BN_FUSION=pallas`` when
the program is built, ``PDTPU_BN_MODE=pallas`` when it runs), and the JAX
package runs its Pallas kernels in interpret mode (``FORCE_PALLAS_INTERPRET``)
where their gates pass; the port runs the kernels' plain versions there.

- The depth-50 program built by both DSLs: the same ops (types, slots,
  attrs), 36 ``fused_conv_bn`` ops, the same var descs.
- A reduced program in which every fused-BN gate passes: two bottlenecks on
  a [64, 32, 32] input at B=4 (filters 64 stride 1, then 128 stride 2),
  global average pool, fc to 10 classes, softmax cross entropy, Momentum;
  3 f32 steps from the JAX startup scope. Losses rel 1e-4; running
  mean/var rel L2 1e-4 each; all parameters together rel L2 1e-4 and all
  velocities together 1e-3, each tensor of either 3e-3. Started from the
  same state, the two packages' gradients agree to ~3e-6 (rel L2) in the
  first and third step but up to 1.7e-3 in the second, where a relu mask
  flips at an activation within rounding of 0; the velocities carry that,
  and so do the BN biases, whose values are ~1e-4 after 3 steps.
- ``build_train_program(depth=50, num_classes=10, img_shape=(3, 32, 32))``,
  one step at B=16: loss rel 1e-4. (At B=4 the last stage normalizes over 4
  values per channel, and last-bit differences of the two CPU backends grow
  to ~7e-4 of the loss in the unfused graph as well.)
- bf16 AMP, one step of the reduced program (with a 3×3 conv + BN stem):
  a bf16 trunk and f32 statistics and grads in both packages; loss rel
  1e-2; every gradient within 0.2·max|gradient| of the JAX one.
  The two round to bf16 at other places; on this program each package's
  bf16 gradients are up to 0.24–0.27·max|gradient| away from its own f32
  ones, and the two packages' bf16 gradients 0.13 from each other.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as jnames
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops.pallas_kernels import fused_bn as jbn
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops.kernels import fused_bn as tbn

# One intra-op thread: a second torch worker thread beside JAX's runtime in
# one xdist worker was seen to compute some CPU matmuls ~1e-4 off.
torch.set_num_threads(1)

PACKAGES = ((jfluid, jnames, jresnet), (tfluid, tnames, tresnet))


@pytest.fixture(autouse=True)
def _fused_path():
    """Both switches on and the JAX kernels in interpret mode; all
    restored after the test."""
    saved = {k: os.environ.get(k) for k in ("PDTPU_CONV_BN_FUSION",
                                            "PDTPU_BN_MODE")}
    old = jbn.FORCE_PALLAS_INTERPRET
    os.environ["PDTPU_CONV_BN_FUSION"] = "pallas"
    os.environ["PDTPU_BN_MODE"] = "pallas"
    jbn.FORCE_PALLAS_INTERPRET = True
    yield
    jbn.FORCE_PALLAS_INTERPRET = old
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _run_both(build, feed, steps, extra_fetch=()):
    """Build with each DSL (`build(fluid, resnet)` returns (main, startup,
    loss)), run the JAX startup, copy every persistable into the port's
    scope, run `steps` steps in both. Returns per package: (losses, final
    persistables, the first step's extra fetches, main)."""
    out, state = [], None
    for fluid, names, resnet in PACKAGES:
        with names.guard():
            main, startup, loss = build(fluid, resnet)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        persist = sorted(v.name for v in main.list_vars() if v.persistable)
        with fluid.scope_guard(scope):
            if state is None:
                exe.run(startup)
                state = {n: np.asarray(scope.find_var(n)) for n in persist
                         if scope.find_var(n) is not None}
            else:
                fluid.io.load_params_from_numpy(state, scope=scope)
            losses, first = [], None
            for i in range(steps):
                got = exe.run(main, feed=feed,
                              fetch_list=[loss] + list(extra_fetch))
                losses.append(float(np.asarray(got[0])))
                first = got[1:] if i == 0 else first
            final = {n: np.asarray(scope.find_var(n), np.float32)
                     for n in state}
        out.append((losses, final, first, main))
    return out


def _reduced(amp=False):
    """Two bottlenecks on [64, 32, 32] (every fused-BN gate passes at B=4),
    global average pool, fc to 10 classes, softmax CE, Momentum. Under AMP
    the input is [3, 32, 32] and a 3×3 conv + BN (a stem) makes the 64
    channels, so that, as in ResNet-50, a white-listed conv turns the trunk
    bf16 before the first fused op (the JAX package's fused ops cannot take
    an f32 residual beside a bf16 input)."""
    def build(fluid, resnet):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            L = fluid.layers
            img = L.data("img", [3 if amp else 64, 32, 32])
            label = L.data("label", [1], dtype="int64")
            if amp:
                img = resnet.conv_bn(img, 64, 3, act="relu", name="stem")
            x = resnet.bottleneck(img, 64, 1, "b0")
            x = resnet.bottleneck(x, 128, 2, "b1")
            x = L.pool2d(x, global_pooling=True, pool_type="avg")
            logits = L.fc(x, 10, param_attr=fluid.ParamAttr(name="fc.w"),
                          bias_attr=fluid.ParamAttr(name="fc.b"))
            loss = L.mean(L.softmax_with_cross_entropy(logits, label))
            opt = fluid.optimizer.Momentum(0.01, 0.9)
            if amp:
                opt = fluid.contrib.mixed_precision.decorate(
                    opt, dtype="bfloat16", use_dynamic_loss_scaling=False)
            opt.minimize(loss)
        return main, startup, loss
    return build


def _feed(b, c, hw, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": np.abs(rng.randn(b, c, hw, hw)).astype("float32"),
            "label": rng.randint(0, 10, (b, 1)).astype("int64")}


def test_resnet50_program_same_as_jax():
    import json

    def canon(p):
        return json.loads(json.dumps(p.to_dict(), sort_keys=True))

    built = []
    for fluid, names, resnet in PACKAGES:
        with names.guard():
            built.append(resnet.build_train_program())
    (jmain, jstartup, jfeeds, jloss, jacc), (tmain, tstartup, tfeeds, tloss,
                                             tacc) = built
    assert tfeeds == jfeeds and (tloss.name, tacc.name) == (jloss.name,
                                                            jacc.name)
    for jp, tp in ((jmain, tmain), (jstartup, tstartup)):
        jd, td = canon(jp), canon(tp)
        assert [o["type"] for o in td["blocks"][0]["ops"]] == \
            [o["type"] for o in jd["blocks"][0]["ops"]]
        assert td == jd
    types = [o.type for o in tmain.global_block().ops]
    assert types.count("fused_conv_bn") == 36
    assert types.count("batch_norm") == 17
    assert types.count("momentum") == len(tmain.all_parameters())


def _s2d50(fluid, resnet):
    """ResNet-50 on the space-to-depth stem, the recipe of
    build_train_program with resnet(stem_s2d=True)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [3, 224, 224])
        label = fluid.layers.data("label", [1], dtype="int64")
        logits = resnet.resnet(img, 50, 1000, stem_s2d=True)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.layers.accuracy(fluid.layers.softmax(logits), label)
        fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
    return main, startup


def test_s2d_stem_is_not_ported_yet():
    """The space-to-depth stem is ported: resnet(stem_s2d=True) at depth 50
    builds the JAX package's program (same ops, attrs and var descs), its
    stem pad -> space_to_depth -> 4x4 conv (C_in = 12) -> batch_norm."""
    progs = []
    for fluid, names, resnet in PACKAGES:
        with names.guard():
            progs.append(_s2d50(fluid, resnet))
    (jmain, jstart), (tmain, tstart) = progs
    for jp, tp in ((jmain, tmain), (jstart, tstart)):
        assert tp.to_dict() == jp.to_dict()
    ops = tmain.global_block().ops
    assert [op.type for op in ops[:4]] == ["pad", "space_to_depth",
                                           "conv2d", "batch_norm"]
    assert tmain.global_block().var("stem.w").shape == (64, 12, 4, 4)
    assert [op.type for op in ops].count("fused_conv_bn") == 36


def _reduced_s2d(fluid, resnet):
    """The s2d stem on a [3, 32, 32] image (-> [64, 16, 16]: the stem BN
    normalizes 2048 rows at B=8, so it takes the fused-BN path), one
    bottleneck, pool, fc to 10 classes, softmax CE, Momentum."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        img = L.data("img", [3, 32, 32])
        label = L.data("label", [1], dtype="int64")
        x = resnet._s2d_stem(img, False)
        x = resnet.bottleneck(x, 64, 1, "b0")
        x = L.pool2d(x, global_pooling=True, pool_type="avg")
        logits = L.fc(x, 10, param_attr=fluid.ParamAttr(name="fc.w"),
                      bias_attr=fluid.ParamAttr(name="fc.b"))
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Momentum(0.01, 0.9).minimize(loss)
    return main, startup, loss


def test_reduced_s2d_resnet_three_steps_match_jax():
    """A reduced ResNet on the space-to-depth stem, 3 f32 steps from the
    JAX startup scope: losses rel 1e-4, every parameter and BN statistic
    rel L2 3e-3 (the tolerances of the 7x7 reduced test)."""
    assert tbn.supports((8, 64, 16, 16), None)
    (jl, jfinal, _, _), (tl, tfinal, _, _) = _run_both(
        _reduced_s2d, _feed(8, 3, 32), steps=3)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert np.isfinite(tl).all() and tl[-1] != tl[0]
    assert sorted(tfinal) == sorted(jfinal) and "stem.w" in tfinal
    for n in jfinal:
        assert _rel(tfinal[n], jfinal[n]) <= 3e-3, n


def test_reduced_resnet_three_steps_match_jax():
    # every op of the reduced program takes the fused kernels' path
    for s in ((4, 64, 32, 32), (4, 128, 16, 16)):
        assert tbn.supports(s, None) and jbn.supports(s, None)
    for xs, co, st in (((4, 64, 32, 32), 256, 1), ((4, 256, 32, 32), 512, 2),
                       ((4, 128, 16, 16), 512, 1)):
        assert tbn.conv_bn_supports(xs, (co, xs[1], 1, 1), st)
    (jl, jfinal, _, jmain), (tl, tfinal, _, _) = _run_both(
        _reduced(), _feed(4, 64, 32), steps=3)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert np.isfinite(tl).all()
    params = {p.name for p in jmain.all_parameters()}
    kinds = {"param": lambda n: n in params,
             "velocity": lambda n: n.endswith("_MomentumOptimizer_velocity"),
             "bn.mean": lambda n: n.endswith(".bn.mean"),
             "bn.var": lambda n: n.endswith(".bn.var")}
    together = {"param": 1e-4, "velocity": 1e-3, "bn.mean": 1e-4,
                "bn.var": 1e-4}
    each = {"param": 3e-3, "velocity": 3e-3, "bn.mean": 1e-4,
            "bn.var": 1e-4}
    for kind, pick in kinds.items():
        names = sorted(n for n in jfinal if pick(n))
        assert len(names) == {"bn.mean": 8, "bn.var": 8}.get(
            kind, len(params)), kind
        flat = [np.concatenate([np.ravel(d[n]) for n in names])
                for d in (tfinal, jfinal)]
        assert _rel(*flat) <= together[kind], kind
        for n in names:
            assert _rel(tfinal[n], jfinal[n]) <= each[kind], n


def test_build_train_program_one_step_matches_jax():
    def build(fluid, resnet):
        main, startup, _, loss, _ = resnet.build_train_program(
            depth=50, num_classes=10, img_shape=(3, 32, 32))
        return main, startup, loss

    rng = np.random.RandomState(1)
    feed = {"img": rng.randn(16, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (16, 1)).astype("int64")}
    (jl, _, _, _), (tl, _, _, _) = _run_both(build, feed, steps=1)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_reduced_resnet_bf16_amp_one_step_matches_jax():
    build = _reduced(amp=True)
    with tnames.guard():
        main, _, _ = build(tfluid, tresnet)
    grads = sorted(p.name + "@GRAD" for p in main.all_parameters())
    # the dtype flow: a bf16 trunk (the last fused op's output), f32 batch
    # statistics, f32 grads of the f32 master weights
    trunk = [op for op in main.global_block().ops
             if op.type == "fused_conv_bn"][-1].outputs
    flow = [trunk["Y"][0], trunk["SavedMean"][0]]
    (jl, _, jf, _), (tl, _, tf, _) = _run_both(
        build, _feed(4, 3, 32), steps=1, extra_fetch=flow + grads)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    for t, j, want in zip(tf[:2], jf[:2], ("bfloat16", "float32")):
        assert np.asarray(t).dtype.name == np.asarray(j).dtype.name == want
    for name, t, j in zip(grads, tf[2:], jf[2:]):
        assert np.asarray(t).dtype == np.asarray(j).dtype == np.float32
        t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
        assert np.abs(t - j).max() <= 0.2 * np.abs(j).max(), name
