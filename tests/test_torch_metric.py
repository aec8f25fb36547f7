"""The port's metrics against the JAX package's `metric`, on the CPU:
the same numpy inputs (torch tensors on the port's side) give equal
values, exactly (the metrics count on the host in numpy in both
packages), tied scores included: `Accuracy` ranks with the JAX call
(`np.argsort(-p)`), the functional `accuracy` with `lax.top_k`'s order
(the lower index first among equal scores).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.metric as JM
import paddle_tpu_torch.metric as TM


def _tied_scores(n=64, c=7, seed=0):
    """Scores rounded to a few levels, so most rows hold ties, some at
    the label's score."""
    rs = np.random.RandomState(seed)
    p = np.round(rs.rand(n, c) * 3) / 3
    labels = rs.randint(0, c, (n, 1)).astype(np.int64)
    return p.astype(np.float32), labels


@pytest.mark.parametrize("topk", [(1,), (1, 2), (1, 3, 5)])
@pytest.mark.parametrize("label_shape", ["n1", "n"])
def test_accuracy_equals_jax_with_ties(topk, label_shape):
    jm, tm = JM.Accuracy(topk=topk), TM.Accuracy(topk=topk)
    for step in range(3):
        p, lab = _tied_scores(seed=step)
        if label_shape == "n":
            lab = lab[:, 0]
        jc = jm.compute(paddle.to_tensor(p), paddle.to_tensor(lab))
        tc = tm.compute(torch.tensor(p), torch.tensor(lab))
        np.testing.assert_array_equal(tc, np.asarray(jc))
        assert tm.update(tc) == jm.update(jc)
    assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name()
    tm.reset()
    assert tm.accumulate() == (0.0 if len(topk) == 1 else [0.0] * len(topk))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_functional_accuracy_equals_jax_with_ties(k):
    for seed in range(4):
        p, lab = _tied_scores(seed=seed)
        want = float(JM.accuracy(paddle.to_tensor(p), paddle.to_tensor(lab),
                                 k=k).numpy())
        got = TM.accuracy(torch.tensor(p), torch.tensor(lab), k=k)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == want
    # numpy inputs too
    assert float(TM.accuracy(p, lab[:, 0], k=k)) == float(
        JM.accuracy(paddle.to_tensor(p), paddle.to_tensor(lab), k=k).numpy())


def test_precision_recall_auc_equal_jax():
    rs = np.random.RandomState(1)
    jp, jr, ja = JM.Precision(), JM.Recall(), JM.Auc(num_thresholds=255)
    tp, tr, ta = TM.Precision(), TM.Recall(), TM.Auc(num_thresholds=255)
    for step in range(3):
        preds = rs.rand(40).astype(np.float32)
        labels = rs.randint(0, 2, (40, 1)).astype(np.int64)
        for j, t in ((jp, tp), (jr, tr)):
            j.update(preds, labels)
            t.update(torch.tensor(preds), torch.tensor(labels))
        two = np.stack([1 - preds, preds], 1)
        ja.update(two, labels)
        ta.update(torch.tensor(two), torch.tensor(labels))
    for j, t in ((jp, tp), (jr, tr), (ja, ta)):
        assert t.accumulate() == j.accumulate()
        assert t.name() == j.name()
    ta.reset()
    assert ta.accumulate() == 0.0


def test_chunk_evaluator_equals_jax_in_both_forms():
    rs = np.random.RandomState(2)
    j, t = JM.ChunkEvaluator(3), TM.ChunkEvaluator(3)
    for _ in range(3):
        pred = rs.randint(0, 7, (4, 12))
        gold = np.where(rs.rand(4, 12) < 0.7, pred, rs.randint(0, 7, (4, 12)))
        lens = rs.randint(5, 13, (4,))
        j.update(pred, gold, lens)
        t.update(torch.tensor(pred), torch.tensor(gold), torch.tensor(lens))
    j.update(np.array([5]), np.array([6]), np.array([4]))
    t.update(torch.tensor([5]), torch.tensor([6]), torch.tensor([4]))
    assert t.accumulate() == j.accumulate()
    assert TM.ChunkEvaluator.extract_chunks([0, 1, 3, 6, 2], 3) == \
        JM.ChunkEvaluator.extract_chunks([0, 1, 3, 6, 2], 3)
    with pytest.raises(ValueError, match="num_chunk_types"):
        TM.ChunkEvaluator().update(np.zeros((1, 2)), np.zeros((1, 2)),
                                   np.array([2]))


def test_composite_metric_fans_out():
    c = TM.CompositeMetric(TM.Precision(), name="pr")
    c.add_metric(TM.Recall())
    c.update(torch.tensor([0.9, 0.2, 0.7]), torch.tensor([1, 1, 0]))
    assert c.accumulate() == [0.5, 0.5] and c.name() == "pr"
    c.reset()
    assert c.accumulate() == [0.0, 0.0]


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
@pytest.mark.parametrize("difficult", [False, True])
def test_detection_map_equals_jax(ap_version, difficult):
    rs = np.random.RandomState(3)
    j = JM.DetectionMAP(0.5, evaluate_difficult=False, ap_version=ap_version)
    t = TM.DetectionMAP(0.5, evaluate_difficult=False, ap_version=ap_version)
    for _ in range(4):
        g = rs.randint(1, 5)
        xy = rs.rand(g, 2) * 50
        gt = np.concatenate([xy, xy + 10 + rs.rand(g, 2) * 20], 1)
        gl = rs.randint(0, 3, g)
        det = []
        for b, lab in zip(gt, gl):
            det.append([lab, rs.rand(), *(b + rs.randn(4) * 2)])
        det.append([rs.randint(0, 3), rs.rand(), 0, 0, 5, 5])
        det.append([-1, 0.9, 0, 0, 1, 1])           # a padded row
        det = np.asarray(det, np.float32)
        diff = rs.rand(g) < 0.3 if difficult else None
        j.update(det, gt, gl, diff)
        t.update(torch.tensor(det), torch.tensor(gt), torch.tensor(gl),
                 None if diff is None else torch.tensor(diff))
    assert t.accumulate() == j.accumulate()
