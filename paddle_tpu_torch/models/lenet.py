"""LeNet / MNIST (reference book/test_recognize_digits.py): the port's copy
of ``paddle_tpu.models.lenet``."""
from __future__ import annotations

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers


def lenet5(img, num_classes: int = 10):
    conv1 = layers.conv2d(img, num_filters=6, filter_size=5, padding=2, act="relu")
    pool1 = layers.pool2d(conv1, pool_size=2, pool_stride=2)
    conv2 = layers.conv2d(pool1, num_filters=16, filter_size=5, act="relu")
    pool2 = layers.pool2d(conv2, pool_size=2, pool_stride=2)
    fc1 = layers.fc(pool2, size=120, act="relu")
    fc2 = layers.fc(fc1, size=84, act="relu")
    return layers.fc(fc2, size=num_classes)


def mlp(img, num_classes: int = 10):
    h = layers.fc(img, 200, act="relu")
    h = layers.fc(h, 200, act="relu")
    return layers.fc(h, num_classes)


def build_train_program(lr: float = 1e-3, net=lenet5):
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = layers.data("img", [1, 28, 28])
        label = layers.data("label", [1], dtype="int64")
        logits = net(img)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        fluid.optimizer.Adam(lr).minimize(loss)
    return main, startup, ["img", "label"], loss, acc
