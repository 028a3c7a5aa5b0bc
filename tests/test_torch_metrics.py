"""The port's metrics against the JAX package's: the in-graph streaming
`auc` (layers.auc, the `auc` op) over several batches, its stat buffers
bitwise equal to the JAX package's and to the host-side metrics.Auc's
(sums of 0/1 values, exact in float32), the AUC within 1e-6 relative; the
numpy-only fluid.metrics, fluid.evaluator and fluid.average classes equal
to the JAX package's on the same inputs. Twins of
tests/test_aux.py::test_metrics_accuracy_precision_recall_auc and of the
metrics half of
tests/test_api_parity.py::test_dygraph_decays_and_metrics_classes, with
their tolerances.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from _torch_twin import fresh_port_state, run_both

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


def _auc_program(num_thresholds, two_col):
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            p = fluid.layers.data("p", [2 if two_col else 1])
            label = fluid.layers.data("label", [1], dtype="int64")
            auc, batch_auc, (pos, neg) = fluid.layers.auc(
                p, label, num_thresholds=num_thresholds)
        return main, startup, [auc, pos, neg]
    return build


def _auc_feed(n, two_col):
    def feed(i):
        rng = np.random.RandomState(100 + i)
        lab = rng.randint(0, 2, (n, 1))
        pos = np.clip(lab * 0.3 + rng.rand(n, 1) * 0.7, 0, 1)
        pos[: n // 8] = rng.choice([0.0, 1.0, 0.5], (n // 8, 1))  # edges
        p = np.concatenate([1 - pos, pos], 1) if two_col else pos
        return {"p": p.astype("float32"), "label": lab.astype("int64")}
    return feed


@pytest.mark.parametrize("num_thresholds,two_col,n",
                         [(4095, True, 4096), (255, False, 1000),
                          (1023, True, 333)])
def test_auc_op_matches_jax_and_host_metric(num_thresholds, two_col, n):
    feed = _auc_feed(n, two_col)
    (jouts, touts), (jfinal, tfinal), _ = run_both(
        _auc_program(num_thresholds, two_col), feed, 3)
    host = tfluid.metrics.Auc(num_thresholds=num_thresholds)
    for step, (j, t) in enumerate(zip(jouts, touts)):
        f = feed(step)
        host.update(f["p"], f["label"])
        assert t[1].dtype == np.float32 and t[1].shape == (num_thresholds + 1,)
        assert t[1].tobytes() == j[1].tobytes()
        assert t[2].tobytes() == j[2].tobytes()
        np.testing.assert_array_equal(t[1], host._stat_pos)
        np.testing.assert_array_equal(t[2], host._stat_neg)
        np.testing.assert_allclose(t[0], j[0], rtol=1e-6)
        np.testing.assert_allclose(float(t[0]), host.eval(), rtol=1e-5)
    assert 0.5 < host.eval() < 1.0


def test_metrics_accuracy_precision_recall_auc():
    """Twin of tests/test_aux.py::test_metrics_accuracy_precision_recall_auc."""
    metrics = tfluid.metrics
    acc = metrics.Accuracy()
    acc.update(0.5, 10)
    acc.update(1.0, 10)
    assert abs(acc.eval() - 0.75) < 1e-9

    p = metrics.Precision()
    p.update([1, 1, 0, 1], [1, 0, 0, 1])
    assert abs(p.eval() - 2 / 3) < 1e-9

    r = metrics.Recall()
    r.update([1, 0, 0, 1], [1, 1, 0, 1])
    assert abs(r.eval() - 2 / 3) < 1e-9

    auc = metrics.Auc(num_thresholds=1023)
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 2, 1000)
    preds = np.clip(labels * 0.6 + rng.rand(1000) * 0.4, 0, 1)
    auc.update(preds, labels)
    assert auc.eval() > 0.8


def test_chunk_evaluator_and_detection_map():
    """Twin of the metrics half of
    tests/test_api_parity.py::test_dygraph_decays_and_metrics_classes (the
    dygraph decays are not ported)."""
    fluid = tfluid
    m = fluid.metrics.ChunkEvaluator()
    m.update(10, 10, 8)
    p, r, f1 = m.eval()
    assert abs(p - 0.8) < 1e-9 and abs(f1 - 0.8) < 1e-9

    dm = fluid.metrics.DetectionMAP()
    dm.update([[0, 0.9, 1], [0, 0.8, 0], [1, 0.7, 1]], [0, 1])
    assert 0.0 < dm.eval() <= 1.0


def _drive(pkg):
    """One result per class of fluid.metrics, fluid.evaluator and
    fluid.average of `pkg`, on fixed inputs."""
    rng = np.random.RandomState(7)
    out = {}
    comp = pkg.metrics.CompositeMetric()
    comp.add_metric(pkg.metrics.Precision())
    comp.add_metric(pkg.metrics.Recall())
    comp.add_metric(pkg.metrics.Auc(num_thresholds=63))
    for _ in range(3):
        preds = rng.rand(50)
        labels = rng.randint(0, 2, 50)
        comp.update(preds, labels)
    out["composite"] = comp.eval()
    ed = pkg.metrics.EditDistance()
    ed.update(np.array([0, 2, 1, 0]), 4)
    ed.update(np.array([3, 0]), 2)
    out["edit_distance"] = ed.eval()
    for version in ("integral", "11point"):
        dm = pkg.metrics.DetectionMAP(ap_version=version)
        dets = np.stack([rng.randint(0, 3, 30), rng.rand(30),
                         rng.randint(0, 2, 30)], 1)
        dm.update(dets, rng.randint(0, 3, 12))
        out[f"map_{version}"] = dm.eval()
    ev = pkg.evaluator.ChunkEvaluator()
    ev.update(7, 9, 5)
    out["evaluator_chunk"] = ev.eval()
    ev.reset()
    ev.update(3, 3, 3)
    out["evaluator_chunk_reset"] = ev.eval()
    ee = pkg.evaluator.EditDistance()
    ee.update(np.array([1, 0, 2]), 3)
    out["evaluator_edit"] = ee.eval()
    ed = pkg.evaluator.DetectionMAP(class_num=2)
    ed.update([[0, 0.9, 1], [1, 0.4, 0], [1, 0.3, 1]], [0, 1, 1])
    out["evaluator_map"] = ed.eval()
    wa = pkg.average.WeightedAverage()
    wa.add(np.array([1.0, 2.0]), 2)
    wa.add(np.array([4.0, 0.0]), 1)
    out["weighted_average"] = wa.eval()
    with pytest.raises(ValueError):
        pkg.average.WeightedAverage().eval()
    return out


def test_host_metric_classes_match_jax():
    got, want = _drive(tfluid), _drive(jfluid)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], dtype=float),
                                      np.asarray(want[k], dtype=float),
                                      err_msg=k)
