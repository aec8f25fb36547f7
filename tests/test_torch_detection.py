"""Parity of the port's detection ops (`ops/detection.py`,
`ops/detection_train.py`, `vision/ops.py`) with the JAX package's, on
the same seeded numpy inputs in float64: values and gradients within
rtol 1e-10 (atol 1e-12); indices, labels and counts equal, NMS keep
lists under the near-threshold rule (`testing.nms`: a list may part
only where an IoU against an earlier pick lies within 1e-6 of the
threshold; printed). `ssd_loss` computes in float32 whatever its
inputs (both packages), so it is held to 1e-5. Also: `generator=`
properties, the quirks that raise, and a port copy of the JAX package's
Faster R-CNN lite giving the JAX losses step for step."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.ops as JVO
from paddle_tpu.ops import detection as JD
from paddle_tpu.ops import detection_train as JDT
from paddle_tpu_torch.ops import detection as TD
from paddle_tpu_torch.ops import detection_train as TDT
from paddle_tpu_torch.testing import nms as tnms
from paddle_tpu_torch.vision import ops as TVO

from _torch_op_parity import compare, run_jax_ops
from _torch_parity import run_port

def _boxes(n, seed, size=100.0, lo=1.0, frac=0.4):
    rs = np.random.RandomState(seed)
    xy = rs.rand(n, 2) * size
    wh = rs.rand(n, 2) * size * frac + lo
    return np.concatenate([xy, xy + wh], 1)


def _keep_agree(boxes, thr, jkeep, tkeep, normalized=True):
    ok, diffs = tnms.agree(torch.as_tensor(boxes), torch.as_tensor(tkeep),
                           torch.as_tensor(np.array(jkeep)), thr,
                           normalized)
    for d in diffs:
        print("near-threshold NMS difference:", d)
    assert ok, diffs


@pytest.mark.parametrize("normalized", [True, False])
def test_iou_matrix(normalized):
    compare(lambda a, b: JD.iou_matrix(a, b, normalized),
            lambda a, b: TD.iou_matrix(a, b, normalized),
            [_boxes(5, 0), _boxes(7, 1)], wrt=(0, 1))


@pytest.mark.parametrize("thr,score_thr,max_out,normalized", [
    (0.4, None, None, True), (0.5, 0.3, 5, True), (0.3, None, 40, False),
    (0.0, 0.1, 12, True)])
def test_nms(thr, score_thr, max_out, normalized):
    boxes = _boxes(30, 2)
    scores = np.round(np.random.RandomState(3).rand(30), 1)   # ties
    jv, _ = run_jax_ops(lambda b, s: JD.nms(b, s, thr, score_thr, max_out,
                                            normalized), [boxes, scores])
    pv, _ = run_port(lambda b, s: TD.nms(b, s, thr, score_thr, max_out,
                                         normalized), [boxes, scores])
    _keep_agree(boxes, thr, jv[0][None], pv[0][None], normalized)
    assert int(pv[1]) == int(jv[1])


def test_nms_second_pass_over_all_candidates():
    """The best 4 * max_out candidates of a row all overlap one box, so
    the first pass keeps one and the row runs again over all N; rows
    that fill their picks in the window do not."""
    rs = np.random.RandomState(4)
    cluster = np.array([10.0, 10.0, 50.0, 50.0]) + rs.rand(150, 4)
    boxes = np.concatenate([cluster, _boxes(50, 5, size=400.0)])
    scores = np.concatenate([1 + rs.rand(150), rs.rand(50)])
    rows = np.stack([scores, rs.rand(200)])
    for r in range(2):
        jv, _ = run_jax_ops(lambda b, s: JD.nms(b, s, 0.5, max_out=10),
                            [boxes, rows[r]])
        pv, _ = run_port(lambda b, s: TD.nms(b, s, 0.5, max_out=10),
                         [boxes, rows[r]])
        np.testing.assert_array_equal(pv[0], jv[0])
    both, _ = run_port(lambda b, s: TD.nms(b, s, 0.5, max_out=10),
                       [np.broadcast_to(boxes, (2, 200, 4)).copy(), rows])
    single = [TD.nms(torch.from_numpy(boxes), torch.from_numpy(rows[r]),
                     0.5, max_out=10)[0].numpy() for r in range(2)]
    np.testing.assert_array_equal(both[0], np.stack(single))


@pytest.mark.parametrize("bg,keep_top_k,nms_top_k", [(0, 10, 64),
                                                     (-1, 200, 5),
                                                     (2, 7, 3)])
def test_multiclass_nms(bg, keep_top_k, nms_top_k):
    boxes = _boxes(16, 6)
    scores = np.random.RandomState(7).rand(4, 16)
    compare(lambda b, s: JD.multiclass_nms(b, s, 0.2, nms_top_k, keep_top_k,
                                           0.3, background_label=bg),
            lambda b, s: TD.multiclass_nms(b, s, 0.2, nms_top_k, keep_top_k,
                                           0.3, background_label=bg),
            [boxes, scores])


def test_multiclass_nms_batch_equals_each_image():
    boxes = np.stack([_boxes(20, 8 + i) for i in range(3)])
    scores = np.random.RandomState(11).rand(3, 5, 20)
    out, num = TD.multiclass_nms(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), 0.1, 6, 12, 0.4)
    for i in range(3):
        o, n = JD.multiclass_nms(boxes[i], scores[i], 0.1, 6, 12, 0.4)
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(o))
        assert int(num[i]) == int(n)
    only_bg = TD.multiclass_nms(torch.from_numpy(boxes[0]),
                                torch.from_numpy(scores[0, :1]))
    jo = JD.multiclass_nms(boxes[0], scores[0, :1])
    np.testing.assert_array_equal(only_bg[0].numpy(), np.asarray(jo[0]))


def test_box_clip_and_coder():
    boxes = _boxes(6, 12, size=150.0)
    compare(lambda b: JD.box_clip(b, np.array([100.0, 120.0])),
            lambda b: TD.box_clip(b, np.array([100.0, 120.0])), [boxes],
            wrt=(0,))
    priors, targets = _boxes(8, 13), _boxes(5, 14)
    for var in (None, [0.1, 0.1, 0.2, 0.2]):
        for norm in (True, False):
            compare(lambda p, t: JD.box_coder(p, var, t, "encode_center_size",
                                              norm),
                    lambda p, t: TD.box_coder(p, var, t, "encode_center_size",
                                              norm),
                    [priors, targets], wrt=(0, 1))
    deltas = np.random.RandomState(15).randn(8, 4) * 0.3
    pvar = np.random.RandomState(16).uniform(0.1, 0.3, (8, 4))
    for var in (None, [0.1, 0.1, 0.2, 0.2], pvar):
        compare(lambda p, d: JD.box_coder(p, var, d, "decode_center_size"),
                lambda p, d: TD.box_coder(p, var, d, "decode_center_size"),
                [priors, deltas], wrt=(0, 1))


def test_priors_and_anchors():
    kw = dict(min_sizes=[16.0, 30.0], max_sizes=[32.0, 60.0],
              aspect_ratios=(2.0, 3.0), flip=True)
    for order in (False, True):
        for clip in (False, True):
            j = JD.prior_box((4, 5), (64, 80), clip=clip,
                             min_max_aspect_ratios_order=order, **kw)
            t = TD.prior_box((4, 5), (64, 80), clip=clip,
                             min_max_aspect_ratios_order=order,
                             device="cpu", **kw)
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    j = JD.prior_box((3, 3), (300, 300), [60.0], steps=(100.0, 100.0))
    t = TD.prior_box((3, 3), (300, 300), [60.0], steps=(100.0, 100.0),
                     device="cpu")
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    j = JD.anchor_generator((5, 7), [32.0, 64.0], [0.5, 1.0, 2.0],
                            [16.0, 8.0])
    t = TD.anchor_generator((5, 7), [32.0, 64.0], [0.5, 1.0, 2.0],
                            [16.0, 8.0], device="cpu")
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    j = JD.density_prior_box((3, 4), (48, 64), [8.0, 16.0], [1.0, 2.0],
                             [2, 1], clip=True)
    t = TD.density_prior_box((3, 4), (48, 64), [8.0, 16.0], [1.0, 2.0],
                             [2, 1], clip=True, device="cpu")
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("clip,scale", [(True, 1.0), (False, 1.05)])
def test_yolo_box(clip, scale):
    rs = np.random.RandomState(17)
    x = rs.randn(2, 2 * (5 + 3), 3, 4)
    img = np.array([[96, 128], [64, 64]], "int32")
    compare(lambda a: JD.yolo_box(a, img, [10, 14, 23, 27], 3, 0.3, 32, clip,
                                  scale),
            lambda a: TD.yolo_box(a, img, [10, 14, 23, 27], 3, 0.3, 32, clip,
                                  scale),
            [x], wrt=(0,))


@pytest.mark.parametrize("aligned,sr,out,scale", [
    (False, -1, (2, 2), 1.0), (True, 3, (2, 3), 0.5), (True, -1, 3, 1.0)])
def test_roi_align(aligned, sr, out, scale):
    x = np.random.RandomState(18).randn(2, 3, 9, 10)
    rois = np.array([[0.0, 0.0, 4.0, 4.0], [2.5, 1.0, 8.5, 7.0],
                     [-2.0, 3.0, 12.0, 14.0], [5.0, 5.0, 5.2, 5.1]])
    bid = np.array([0, 1, 1, 0])
    compare(lambda a, r: JD.roi_align(a, r, bid, out, scale, sr, aligned),
            lambda a, r: TD.roi_align(a, r, bid, out, scale, sr, aligned),
            [x, rois], wrt=(0,), rtol=1e-10, atol=1e-12, ops="eager")


def test_roi_pool():
    """Distinct feature values (max has one winner a bin, so the gradient
    is defined); RoIs past the map, a one-pixel RoI, empty bins."""
    x = np.random.RandomState(19).permutation(2 * 3 * 9 * 10).reshape(
        2, 3, 9, 10) / 100.0 - 2.0
    rois = np.array([[0.0, 0.0, 7.0, 7.0], [2.4, 1.0, 9.6, 8.0],
                     [-4.0, 3.0, 14.0, 20.0], [5.0, 5.0, 5.0, 5.0],
                     [3.0, 2.0, 4.0, 3.0]])
    bid = np.array([0, 1, 1, 0, 1])
    for out, scale in (((2, 2), 1.0), ((3, 4), 0.5), (5, 1.0)):
        compare(lambda a, r: JD.roi_pool(a, r, bid, out, scale),
                lambda a, r: TD.roi_pool(a, r, bid, out, scale),
                [x, rois], wrt=(0,))


def test_bipartite_match():
    rs = np.random.RandomState(20)
    dist = np.round(rs.rand(4, 6), 1) - 0.2      # ties and non-positives
    compare(JD.bipartite_match, TD.bipartite_match, [dist])
    compare(JD.bipartite_match, TD.bipartite_match, [dist.T.copy()])
    batch = TD.bipartite_match(torch.from_numpy(np.stack([dist, dist * 2])))
    one = TD.bipartite_match(torch.from_numpy(dist * 2))
    assert torch.equal(batch[0][1], one[0])


# ----------------------------------------------------- detection_train

def _anchors(rs, n, lo=0, hi=60, smin=8, smax=28):
    x1 = rs.uniform(lo, hi - smax, n)
    y1 = rs.uniform(lo, hi - smax, n)
    w = rs.uniform(smin, smax, n)
    h = rs.uniform(smin, smax, n)
    return np.stack([x1, y1, x1 + w, y1 + h], 1)


def test_decode_proposals():
    rs = np.random.RandomState(21)
    anchors, deltas = _anchors(rs, 6), rs.randn(6, 4) * 0.5
    deltas[0, 2] = 9.0                         # past the exp clip
    var = rs.uniform(0.1, 1.0, (6, 4))
    compare(JDT.decode_proposals, TDT.decode_proposals, [anchors, deltas],
            wrt=(0, 1))
    compare(JDT.decode_proposals, TDT.decode_proposals,
            [anchors, deltas, var], wrt=(0, 1, 2))


def _proposal_case(seed, A=40):
    rs = np.random.RandomState(seed)
    anchors = _anchors(rs, A)
    scores = rs.rand(A)
    deltas = rs.randn(A, 4) * 0.1
    return scores, deltas, np.array([64.0, 64.0, 1.0]), anchors


@pytest.mark.parametrize("pre,post,thr,min_size", [(24, 10, 0.7, 4.0),
                                                   (0, 50, 0.5, 12.0)])
def test_generate_proposals(pre, post, thr, min_size):
    """Min-size-filtered candidates (-inf scores) stay out of the rows
    and the count, as in the JAX function."""
    sc, dl, info, anc = _proposal_case(22)
    jv, _ = run_jax_ops(lambda s, d, i, a: JDT.generate_proposals(
        s, d, i, a, None, pre, post, thr, min_size), [sc, dl, info, anc])
    pv, _ = run_port(lambda s, d, i, a: TDT.generate_proposals(
        s, d, i, a, None, pre, post, thr, min_size), [sc, dl, info, anc])
    for a, b in zip(pv, jv):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_generate_proposals_batch_equals_each_image():
    cases = [_proposal_case(23 + i) for i in range(3)]
    anc = cases[0][3]
    sc = torch.from_numpy(np.stack([c[0] for c in cases]))
    dl = torch.from_numpy(np.stack([c[1] for c in cases]))
    info = torch.from_numpy(np.stack([c[2] for c in cases]))
    rois, probs, num = TDT.generate_proposals(
        sc, dl, info, torch.from_numpy(anc), None, 30, 12, 0.6, 2.0)
    for i in range(3):
        o = TDT.generate_proposals(sc[i], dl[i], info[i],
                                   torch.from_numpy(anc), None, 30, 12, 0.6,
                                   2.0)
        assert torch.equal(rois[i], o[0]) and torch.equal(num[i], o[2])


def test_generate_proposals_refuses_eta():
    """The JAX function takes eta (adaptive NMS) and applies nothing; the
    port raises on eta other than 1."""
    sc, dl, info, anc = map(torch.from_numpy, _proposal_case(26))
    with pytest.raises(NotImplementedError):
        TDT.generate_proposals(sc, dl, info, anc, None, eta=0.5)


RPN_KEYS = ("labels", "bbox_targets", "bbox_inside_weight", "fg_num",
            "bg_num")


def _rpn_case():
    rs = np.random.RandomState(25)
    anchors = _anchors(rs, 48)
    gt = np.array([[5, 5, 25, 25], [30, 30, 55, 55], [0, 0, 0, 0]], "f8")
    return anchors, gt, np.zeros(3, "int32"), np.array([64.0, 64.0, 1.0])


@pytest.mark.parametrize("straddle,bs", [(0.0, 20), (-1.0, 256)])
def test_rpn_target_assign(straddle, bs):
    anchors, gt, crowd, info = _rpn_case()

    def j(a, g):
        o = JDT.rpn_target_assign(a, g, crowd, info, gt_count=2,
                                  rpn_batch_size_per_im=bs,
                                  rpn_straddle_thresh=straddle)
        return tuple(o[k] for k in RPN_KEYS)

    def t(a, g):
        o = TDT.rpn_target_assign(a, g, crowd, info, gt_count=2,
                                  rpn_batch_size_per_im=bs,
                                  rpn_straddle_thresh=straddle)
        return tuple(o[k] for k in RPN_KEYS)

    compare(j, t, [anchors, gt], wrt=(0, 1))


def test_rpn_target_assign_generator():
    """A seeded torch.Generator: fg within its quota and inside the fg
    candidates, fg + bg within the batch, bg inside the candidates; the
    same seed the same sample, another seed another."""
    anchors, gt, crowd, info = map(torch.as_tensor, _rpn_case())
    full = TDT.rpn_target_assign(anchors, gt, crowd, info, gt_count=2,
                                 rpn_batch_size_per_im=4800)
    cand_fg, cand_bg = full["labels"] == 1, full["labels"] == 0
    runs = []
    for seed in (0, 0, 1):
        o = TDT.rpn_target_assign(
            anchors, gt, crowd, info, gt_count=2, rpn_batch_size_per_im=8,
            generator=torch.Generator().manual_seed(seed))
        fg, bg = o["labels"] == 1, o["labels"] == 0
        assert int(o["fg_num"]) == int(fg.sum()) == min(4, int(cand_fg.sum()))
        assert int(o["fg_num"]) + int(o["bg_num"]) <= 8
        assert not (fg & ~cand_fg).any() and not (bg & ~(cand_bg | cand_fg)
                                                  ).any()
        runs.append(o["labels"])
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_retinanet_target_assign():
    anchors, gt, crowd, info = _rpn_case()
    keys = ("labels", "bbox_targets", "bbox_inside_weight", "fg_num")
    gl = np.array([3, 7, 0])
    compare(lambda a, g: tuple(JDT.retinanet_target_assign(
                a, g, gl, crowd, info, gt_count=2)[k] for k in keys),
            lambda a, g: tuple(TDT.retinanet_target_assign(
                a, g, gl, crowd, info, gt_count=2)[k] for k in keys),
            [anchors, gt], wrt=(0, 1))


PL_KEYS = ("rois", "labels_int32", "bbox_targets", "bbox_inside_weights",
           "bbox_outside_weights", "fg_num", "valid_num", "gt_index")


@pytest.mark.parametrize("use_gt,agnostic,bs", [(True, False, 16),
                                                (False, True, 16),
                                                (True, False, 40)])
def test_generate_proposal_labels(use_gt, agnostic, bs):
    """Padded gt rows never match; fg rows first; the class-slot
    scatter; fewer candidates than the batch pads."""
    rs = np.random.RandomState(26)
    rois = _anchors(rs, 24)
    gt = np.array([[5, 5, 25, 25], [35, 35, 58, 58], [0, 0, 0, 0]], "f8")
    cls, crowd = np.array([3, 7, 0]), np.zeros(3, "int32")

    def run(mod):
        def f(r, g):
            o = mod.generate_proposal_labels(
                r, 20, cls, crowd, g, 1.5, batch_size_per_im=bs,
                fg_fraction=0.5, class_nums=8, use_gt_as_rois=use_gt,
                is_cls_agnostic=agnostic)
            return tuple(o[k] for k in PL_KEYS)
        return f

    compare(run(JDT), run(TDT), [rois, gt], wrt=(0, 1))


def test_generate_proposal_labels_generator():
    rs = np.random.RandomState(27)
    rois = torch.from_numpy(_anchors(rs, 60))
    gt = torch.tensor([[5.0, 5, 25, 25], [35, 35, 58, 58]])
    args = (rois, 60, torch.tensor([3, 7]), torch.zeros(2), gt, 1.0)
    full = TDT.generate_proposal_labels(*args, batch_size_per_im=200,
                                        fg_fraction=0.5, class_nums=8)
    fg_rows = {tuple(r) for r, lab in zip(full["rois"].tolist(),
                                          full["labels_int32"].tolist())
               if lab > 0}
    o = TDT.generate_proposal_labels(*args, batch_size_per_im=16,
                                     fg_fraction=0.25, class_nums=8,
                                     generator=torch.Generator().manual_seed(3))
    lab = o["labels_int32"]
    fg = int(o["fg_num"])
    assert fg <= 4 and int((lab > 0).sum()) == fg and (lab[:fg] > 0).all()
    assert int((lab >= 0).sum()) == int(o["valid_num"]) <= 16
    assert {tuple(r) for r in o["rois"][:fg].tolist()} <= fg_rows


def test_generate_mask_labels():
    rs = np.random.RandomState(28)
    masks = (rs.rand(3, 20, 24) > 0.5).astype("int32")
    rois = _anchors(rs, 5, hi=24, smin=3, smax=10)
    compare(lambda m, r: JDT.generate_mask_labels(
                m, r, np.array([1, 0, 2, 5, 0]), np.array([0, 2, 1, 1, 0]),
                resolution=7),
            lambda m, r: TDT.generate_mask_labels(
                m, r, np.array([1, 0, 2, 5, 0]), np.array([0, 2, 1, 1, 0]),
                resolution=7),
            [masks, rois])


def test_fpn_distribute_and_collect():
    rois = np.array([[0, 0, 56, 56], [0, 0, 448, 448], [0, 0, 112, 112],
                     [0, 0, 7, 7], [0, 0, 224, 224], [0, 0, 9, 9]], "f8")

    def flat(outs_restore):
        outs, restore = outs_restore
        return tuple(t for o in outs for t in o) + (restore,)

    compare(lambda r: flat(JDT.distribute_fpn_proposals(r, 5, 2, 5, 4, 224)),
            lambda r: flat(TDT.distribute_fpn_proposals(r, 5, 2, 5, 4, 224)),
            [rois], wrt=(0,))
    r1, r2 = rois[:3], rois[3:]
    s1, s2 = np.array([0.9, 0.1, 0.4]), np.array([0.5, 0.7, 0.95])
    for k in (4, 10):
        compare(lambda a, b, x, y: JDT.collect_fpn_proposals(
                    [a, b], [x, y], [2, 3], k),
                lambda a, b, x, y: TDT.collect_fpn_proposals(
                    [a, b], [x, y], [2, 3], k),
                [r1, r2, s1, s2], wrt=(0, 1, 2, 3))


def test_target_assign_and_mining():
    rs = np.random.RandomState(29)
    x = rs.randn(2, 3, 5)
    mi = np.array([[2, -1, 0, 1], [1, 1, -1, 2]])
    compare(lambda a: JDT.target_assign(a, mi, 7.0, np.array([3, 2])),
            lambda a: TDT.target_assign(a, mi, 7.0, np.array([3, 2])), [x],
            wrt=(0,))
    cl = rs.rand(2, 8)
    mi = np.array([[0, -1, -1, -1, 1, -1, -1, -1],
                   [-1, -1, -1, -1, -1, -1, -1, 0]])
    md = rs.rand(2, 8)
    compare(lambda c, d: JDT.mine_hard_examples(c, mi, d, neg_pos_ratio=2.0),
            lambda c, d: TDT.mine_hard_examples(c, mi, d, neg_pos_ratio=2.0),
            [cl, md])
    ll = rs.rand(2, 8)
    compare(lambda c, d, l: JDT.mine_hard_examples(
                c, mi, d, l, sample_size=3, mining_type="hard_example"),
            lambda c, d, l: TDT.mine_hard_examples(
                c, mi, d, l, sample_size=3, mining_type="hard_example"),
            [cl, md, ll])


def _ssd_case(seed, B=3, P=16, C=4, G=3):
    rs = np.random.RandomState(seed)
    cy, cx = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    ctr = np.stack([cx, cy], -1).reshape(-1, 2) * 0.25 + 0.125
    priors = np.concatenate([ctr - 0.15, ctr + 0.15], 1)
    gt = np.zeros((B, G, 4))
    lab = np.zeros((B, G), "int64")
    for b in range(B):
        for g in range(b + 1):
            xy = rs.rand(2) * 0.6
            gt[b, g] = [*xy, *(xy + 0.2 + rs.rand(2) * 0.2)]
            lab[b, g] = rs.randint(1, C)
    return (rs.randn(B, P, 4) * 0.3, rs.randn(B, P, C), gt, lab, priors)


@pytest.mark.parametrize("match_type,var", [
    ("per_prediction", [0.1, 0.1, 0.2, 0.2]), ("bipartite", None),
    ("per_prediction", "per_prior")])
def test_ssd_loss(match_type, var):
    loc, conf, gt, lab, priors = _ssd_case(30)
    if var == "per_prior":
        var = np.random.RandomState(31).uniform(0.1, 0.3, priors.shape)
    kw = dict(prior_box_var=var, overlap_threshold=0.3, neg_pos_ratio=2.0,
              match_type=match_type)
    jv, jg = run_jax_ops(lambda l, c: JDT.ssd_loss(l, c, gt, lab, priors,
                                                   **kw), [loc, conf], (0, 1))
    pv, pg = run_port(lambda l, c: TDT.ssd_loss(l, c, torch.from_numpy(gt),
                                                lab, torch.from_numpy(priors),
                                                **kw), [loc, conf], (0, 1))
    np.testing.assert_allclose(pv[0], jv[0], rtol=1e-5)
    for a, b in zip(pg, jg):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("gauss,post", [(False, 0.0), (True, 0.3)])
def test_matrix_nms(gauss, post):
    boxes = _boxes(12, 32)
    scores = np.random.RandomState(33).rand(3, 12)
    compare(lambda b, s: JDT.matrix_nms(b, s, 0.2, post, 6, 10, gauss, 0.5),
            lambda b, s: TDT.matrix_nms(b, s, 0.2, post, 6, 10, gauss, 0.5),
            [boxes, scores])


# ------------------------------------------------------------ vision.ops

def test_vision_ops_wrappers():
    """The Tensor-level wrappers (the JAX ones take no gradient)."""
    def tcompare(*a, **kw):
        return compare(*a, ops=False, **kw)

    boxes = _boxes(12, 34)
    scores = np.random.RandomState(35).rand(12)
    cats = np.random.RandomState(36).randint(0, 3, 12)
    tcompare(lambda b, s: JVO.nms(b, 0.3, s, None, paddle.to_tensor(cats),
                                 top_k=8),
            lambda b, s: TVO.nms(b, 0.3, s, None, torch.tensor(cats),
                                 top_k=8), [boxes, scores])
    tcompare(lambda b: JVO.nms(b, 0.5), lambda b: TVO.nms(b, 0.5), [boxes])
    x = np.random.RandomState(37).randn(2, 3, 8, 8)
    rois = np.array([[0.0, 0, 4, 4], [1, 2, 7, 6], [3, 3, 6, 7]])
    bn = np.array([1, 2])
    tcompare(lambda a, r: JVO.roi_align(a, r, paddle.to_tensor(bn), 2),
            lambda a, r: TVO.roi_align(a, r, torch.tensor(bn), 2),
            [x, rois])
    tcompare(lambda a, r: JVO.roi_pool(a, r, paddle.to_tensor(bn), 2),
            lambda a, r: TVO.roi_pool(a, r, torch.tensor(bn), 2),
            [x, rois])
    feat, img = np.zeros((1, 2, 3, 4)), np.zeros((1, 3, 48, 64))
    tcompare(lambda f, i: JVO.prior_box(f, i, [12.0], [20.0], [2.0],
                                       steps=[16.0, 12.0]),
            lambda f, i: TVO.prior_box(f, i, [12.0], [20.0], [2.0],
                                       steps=[16.0, 12.0]), [feat, img])
    tcompare(lambda a, b: JVO.iou_similarity(a, b),
            lambda a, b: TVO.iou_similarity(a, b), [boxes, _boxes(4, 38)])
    tcompare(lambda p, t: JVO.box_coder(p, [0.1, 0.1, 0.2, 0.2], t),
            lambda p, t: TVO.box_coder(p, [0.1, 0.1, 0.2, 0.2], t),
            [boxes, _boxes(4, 39)])
    tcompare(lambda b: JVO.box_clip(b, paddle.to_tensor(np.array([50.0, 60]))),
            lambda b: TVO.box_clip(b, torch.tensor([50.0, 60])), [boxes])
    y = np.random.RandomState(40).randn(1, 16, 2, 2)
    tcompare(lambda a: JVO.yolo_box(a, paddle.to_tensor(np.array([[64, 64]])),
                                   [10, 14, 23, 27], 3),
            lambda a: TVO.yolo_box(a, torch.tensor([[64, 64]]),
                                   [10, 14, 23, 27], 3), [y])
    tcompare(lambda d: JVO.bipartite_match(d), lambda d: TVO.bipartite_match(d),
            [np.random.RandomState(41).rand(3, 5)])
    tcompare(lambda b, s: JVO.multiclass_nms(b, s, 0.1, 4, 6, 0.4),
            lambda b, s: TVO.multiclass_nms(b, s, 0.1, 4, 6, 0.4),
            [boxes, np.random.RandomState(42).rand(3, 12)])


def test_vision_nms_refuses_categories():
    """The JAX wrapper takes nms(categories=) and applies nothing (every
    category of category_idxs runs); the port raises on it."""
    b = torch.from_numpy(_boxes(4, 43))
    with pytest.raises(NotImplementedError):
        TVO.nms(b, 0.5, category_idxs=torch.zeros(4), categories=[0])


def test_vision_box_coder_refuses_axis():
    """The JAX wrapper takes box_coder(axis=) and applies nothing; the
    port raises on an axis other than 0."""
    b = torch.from_numpy(_boxes(4, 44))
    with pytest.raises(NotImplementedError):
        TVO.box_coder(b, None, b, "decode_center_size", axis=1)


def test_near_threshold_rule():
    """Two boxes at IoU 0.5 exactly: a threshold 1e-9 above keeps both, at
    0.5 one run may drop the second; the rule calls that a near case,
    and calls a real difference (thr 0.3) what it is."""
    boxes = torch.tensor([[0.0, 0.0, 2.0, 1.0], [0.0, 0.0, 1.0, 1.0],
                          [5.0, 5.0, 6.0, 6.0]], dtype=torch.float64)
    a = torch.tensor([[0, 1, 2]])
    b = torch.tensor([[0, 2, -1]])
    ok, d = tnms.agree(boxes, a, b, 0.5 + 1e-9)
    assert ok and d[0]["at"] == 1 and d[0]["near"]
    ok, d = tnms.agree(boxes, a, b, 0.3)
    assert not ok
    assert tnms.agree(boxes, a, a, 0.3) == (True, [])


# ------------------------------------------------- Faster R-CNN lite copy

IMG, A_PER, STRIDE = 32, 3, 8


def _frcnn_setup():
    hw = IMG // STRIDE
    cy, cx = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    cxy = np.stack([cx, cy], -1).reshape(-1, 2) * STRIDE + STRIDE / 2
    anchors = np.stack([np.concatenate([cxy - s / 2, cxy + s / 2], 1)
                        for s in (8.0, 16.0, 24.0)], 1).reshape(-1, 4)
    rs = np.random.RandomState(0)
    imgs = np.zeros((4, 1, IMG, IMG))
    gts = np.zeros((4, 1, 4))
    for i in range(4):
        s = rs.randint(8, 16)
        x, y = rs.randint(0, IMG - s), rs.randint(0, IMG - s)
        imgs[i, 0, y:y + s, x:x + s] = 1.0
        gts[i, 0] = [x, y, x + s, y + s]
    shapes = {"conv": (8, 1, 3, 3), "rpn_cls": (A_PER, 8, 1, 1),
              "rpn_reg": (4 * A_PER, 8, 1, 1), "head_w": (32, 16),
              "cls_w": (16, 2), "reg_w": (16, 4)}
    params = {k: rs.randn(*s) * np.sqrt(2.0 / (np.prod(s[1:]) + s[0]))
              for k, s in shapes.items()}
    return anchors, imgs, gts, params


def _frcnn_loss(lib, p, imgs, gts, anchors):
    """TestFasterRcnnLite's loss (tests/test_detection_train.py:403) over
    either package's ops: lib holds conv2d, relu, the op modules and
    the array helpers."""
    B, hw = imgs.shape[0], IMG // STRIDE
    feat = lib.relu(lib.conv2d(imgs, p["conv"], stride=STRIDE, padding=1))
    sc = lib.perm(lib.conv2d(feat, p["rpn_cls"]), (0, 2, 3, 1)).reshape(B,
                                                                         -1)
    dl = lib.perm(lib.conv2d(feat, p["rpn_reg"]).reshape(B, A_PER, 4, hw, hw),
                  (0, 3, 4, 1, 2)).reshape(B, -1, 4)
    info = lib.arr([IMG, IMG, 1.0])
    rpn_l, roi_l = [], []
    for b in range(B):
        tgt = lib.DT.rpn_target_assign(
            anchors, gts[b], lib.arr([0], int), info,
            rpn_batch_size_per_im=32, rpn_positive_overlap=0.5,
            rpn_negative_overlap=0.3)
        lab = tgt["labels"]
        use = lab >= 0
        ce = lib.where(use, lib.softplus0(sc[b]) - sc[b] * lab, 0.0)
        rpn_l.append(ce.sum() / lib.maximum(use.sum(), 1)
                     + lib.abs((dl[b] - tgt["bbox_targets"])
                               * tgt["bbox_inside_weight"]).sum()
                     / lib.maximum((lab == 1).sum() * 4, 1))
        rois, _, n = lib.DT.generate_proposals(
            lib.stop(sc[b]), lib.stop(dl[b]), info, anchors, None,
            pre_nms_top_n=48, post_nms_top_n=12, nms_thresh=0.7,
            min_size=2.0)
        o = lib.DT.generate_proposal_labels(
            rois, n, lib.arr([1], int), lib.arr([0], int), gts[b], 1.0,
            batch_size_per_im=8, fg_fraction=0.5, fg_thresh=0.5,
            class_nums=2)
        pooled = lib.D.roi_align(feat[b:b + 1], o["rois"] / STRIDE,
                                 lib.arr([0] * 8, int), (2, 2))
        hid = lib.relu(pooled.reshape(8, -1) @ p["head_w"])
        lp = lib.log_softmax(hid @ p["cls_w"])
        lab2 = o["labels_int32"]
        ok = lab2 >= 0
        pick = lib.take(lp, lib.clip01(lab2))
        cls_l = -lib.where(ok, pick, 0.0).sum() / lib.maximum(ok.sum(), 1)
        bt = o["bbox_targets"].reshape(8, 2, 4)
        biw = o["bbox_inside_weights"].reshape(8, 2, 4)
        reg = ((lib.abs((hid @ p["reg_w"])[:, None, :] - bt) * biw).sum()
               / lib.maximum((lab2 > 0).sum() * 4, 1))
        roi_l.append(cls_l + reg)
    rpn, roi = sum(rpn_l) / B, sum(roi_l) / B
    return rpn + roi, rpn, roi


class _JaxLib:
    def __init__(self):
        import jax
        import jax.numpy as jnp

        from paddle_tpu.ops import kernels as K

        self.jax, self.jnp = jax, jnp
        self.conv2d, self.relu = K.conv2d, jax.nn.relu
        self.D, self.DT = JD, JDT
        self.perm, self.where, self.maximum = jnp.transpose, jnp.where, \
            jnp.maximum
        self.abs, self.stop = jnp.abs, jax.lax.stop_gradient

    def arr(self, v, dtype=float):
        return self.jnp.asarray(np.asarray(v, dtype))

    def softplus0(self, x):
        return self.jnp.logaddexp(0.0, x)

    def log_softmax(self, x):
        return self.jax.nn.log_softmax(x, -1)

    def take(self, lp, idx):
        return self.jnp.take_along_axis(lp, idx[:, None], 1)[:, 0]

    def clip01(self, v):
        return self.jnp.clip(v, 0, 1)


class _TorchLib:
    def __init__(self):
        from paddle_tpu_torch.ops import kernels as K

        self.conv2d, self.relu = K.conv2d, torch.relu
        self.D, self.DT = TD, TDT
        self.perm, self.where = torch.permute, torch.where
        self.abs = torch.abs

    def arr(self, v, dtype=float):
        return torch.as_tensor(np.asarray(v, dtype))

    def maximum(self, a, b):
        return torch.clamp(a, min=b)

    def stop(self, x):
        return x.detach()

    def softplus0(self, x):
        return torch.logaddexp(torch.zeros_like(x), x)

    def log_softmax(self, x):
        return torch.log_softmax(x, -1)

    def take(self, lp, idx):
        return torch.gather(lp, 1, idx.long()[:, None])[:, 0]

    def clip01(self, v):
        return v.clamp(0, 1)


def test_faster_rcnn_lite_matches_jax_step_for_step():
    """A port copy of TestFasterRcnnLite (rpn_target_assign ->
    generate_proposals -> generate_proposal_labels -> roi_align -> heads,
    Adam 1e-2) in float64 from the same weights: the total, RPN and RoI
    losses of 4 steps within 1e-9 of the JAX ones."""
    import jax

    from paddle_tpu.optimizer import functional as JO
    from paddle_tpu_torch.optimizer import functional as TO

    anchors, imgs, gts, init = _frcnn_setup()
    jl, tl = _JaxLib(), _TorchLib()
    jp = {k: jl.jnp.asarray(v) for k, v in init.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    jtx, ttx = JO.adam(1e-2), TO.adam(1e-2)
    js, ts = jtx.init(jp), ttx.init(tp)
    ja, ti, tg, tanc = (jl.jnp.asarray(imgs), torch.from_numpy(imgs),
                        torch.from_numpy(gts), torch.from_numpy(anchors))

    @jax.jit
    def jstep(p, s):
        (loss, aux), g = jax.value_and_grad(
            lambda q: (lambda r: (r[0], r[1:]))(_frcnn_loss(
                jl, q, ja, jl.jnp.asarray(gts), jl.jnp.asarray(anchors))),
            has_aux=True)(p)
        p2, s2 = jtx.update(p, g, s)
        return p2, s2, loss, aux

    for _ in range(4):
        leaves = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
        total, rpn, roi = _frcnn_loss(tl, leaves, ti, tg, tanc)
        grads = dict(zip(leaves, torch.autograd.grad(total, list(
            leaves.values()))))
        tp, ts = ttx.update(tp, grads, ts)
        jp, js, jloss, (jrpn, jroi) = jstep(jp, js)
        np.testing.assert_allclose(
            [float(v.detach()) for v in (total, rpn, roi)],
            [float(jloss), float(jrpn), float(jroi)], rtol=1e-9)
