"""LeNet/MNIST on the port (models/lenet.py): twins of the three tests of
tests/test_mnist.py on the CPU with their own assertions (synthetic
separable digits, no download: the loss halves and accuracy passes 0.9;
the clone(for_test) program is deterministic; a depth-50 ResNet at 32x32
trains with a falling loss), and the port's LeNet against the JAX
package's for 3 Adam steps from the same initial state (losses and
accuracies within 1e-5 relative, every parameter and Adam moment within
1e-4 relative, atol 1e-5: the convolutions' sum order differs from XLA's,
and Adam's normalized step turns a last-bit difference of a near-zero
gradient into a parameter difference of up to ~1e-3 of the lr, 5e-3).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from _torch_twin import assert_states_close, fresh_port_state, run_both

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


def _make_data(n, seed=0):
    """Synthetic 'digits': class k = template k + noise (tests/test_mnist.py
    :12)."""
    rng = np.random.RandomState(seed)
    templates = rng.rand(10, 1, 28, 28).astype("float32")
    labels = rng.randint(0, 10, size=n).astype("int64")
    imgs = templates[labels] + 0.1 * rng.randn(n, 1, 28, 28).astype("float32")
    return imgs, labels.reshape(-1, 1)


def test_mnist_lenet_converges():
    """Twin of tests/test_mnist.py::test_mnist_lenet_converges, through
    models.lenet (the same network)."""
    from paddle_tpu_torch.models import lenet

    main, startup, _, avg_loss, acc = lenet.build_train_program(lr=5e-3)
    main.random_seed = 42
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        imgs, labels = _make_data(256)
        bs = 64
        losses, accs = [], []
        for epoch in range(12):
            for i in range(0, len(imgs), bs):
                lv, av = exe.run(
                    main,
                    feed={"img": imgs[i:i + bs], "label": labels[i:i + bs]},
                    fetch_list=[avg_loss, acc])
                losses.append(float(lv))
                accs.append(float(av))
    first = np.mean(losses[:4])
    last = np.mean(losses[-4:])
    assert last < first * 0.5, f"loss did not converge: {first} -> {last}"
    assert np.mean(accs[-4:]) > 0.9, f"accuracy too low: {np.mean(accs[-4:])}"


def test_mnist_mlp_infer_matches_train_graph():
    """Twin of tests/test_mnist.py::test_mnist_mlp_infer_matches_train_graph:
    the clone(for_test) program shares the trained params."""
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [784])
        label = fluid.layers.data("label", [1], dtype="int64")
        h = fluid.layers.fc(img, 64, act="relu")
        h = fluid.layers.dropout(h, 0.3,
                                 dropout_implementation="upscale_in_train")
        logits = fluid.layers.fc(h, 10)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        test_prog = main.clone(for_test=True)
        opt = fluid.optimizer.SGD(0.1)
        opt.minimize(loss)

        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        x = np.random.rand(8, 784).astype("float32")
        y = np.random.randint(0, 10, (8, 1)).astype("int64")
        exe.run(main, feed={"img": x, "label": y}, fetch_list=[loss])
        # inference is deterministic (dropout off)
        (a,) = exe.run(test_prog, feed={"img": x, "label": y},
                       fetch_list=[logits])
        (b,) = exe.run(test_prog, feed={"img": x, "label": y},
                       fetch_list=[logits])
        np.testing.assert_allclose(a, b)


def test_resnet50_convergence_smoke():
    """Twin of tests/test_mnist.py::test_resnet50_convergence_smoke: the
    depth-50 static-graph ResNet trains and the loss decreases."""
    from paddle_tpu_torch.models import resnet

    with fluid.scope_guard(fluid.Scope()):
        main, startup, feeds, loss, acc = resnet.build_train_program(
            depth=50, num_classes=10, lr=0.01, img_shape=(3, 32, 32))
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        rng = np.random.RandomState(0)
        img = rng.randn(4, 3, 32, 32).astype("float32") * 0.1
        label = rng.randint(0, 10, (4, 1)).astype("int64")
        losses = []
        for _ in range(6):
            lv, _ = exe.run(main, feed={"img": img, "label": label},
                            fetch_list=[loss, acc])
            losses.append(float(lv))
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0], losses


def _lenet(pkg):
    from importlib import import_module

    lenet = import_module(pkg.__name__ + ".models.lenet")
    main, startup, _, loss, acc = lenet.build_train_program(lr=5e-3)
    return main, startup, [loss, acc]


def _lenet_feed(i):
    imgs, labels = _make_data(64 * 3, seed=1)
    s = slice(64 * i, 64 * (i + 1))
    return {"img": imgs[s], "label": labels[s]}


def test_lenet_matches_jax():
    (jouts, touts), (jfinal, tfinal), _ = run_both(_lenet, _lenet_feed, 3)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
        np.testing.assert_allclose(t[1], j[1], rtol=1e-5)
    assert_states_close(jfinal, tfinal, rtol=1e-4, atol=1e-5)
