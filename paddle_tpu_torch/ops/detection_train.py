"""Training-side detection ops (the JAX package's `ops/detection_train.py`):
proposal generation, RPN / RetinaNet / RoI-head target assignment, mask
targets, FPN routing, SSD matching, hard-example mining, the SSD loss
and matrix NMS.

Outputs keep the JAX package's static shapes: variable-length results
are fixed buffers padded with -1 (indices) or 0 (values) plus a valid
count. Sampling is a top-k over masked keys: `generator=None` takes the
lowest-index candidates (the JAX `key=None`, keys -arange); a
`torch.Generator` on the inputs' device draws uniform keys from it (not
the draws of the JAX `key=`). Every op runs on its inputs' device.
"""
from __future__ import annotations

import numpy as np
import torch

from .detection import _div, bipartite_match, iou_matrix, nms

__all__ = ["decode_proposals", "generate_proposals", "rpn_target_assign",
           "retinanet_target_assign", "generate_proposal_labels",
           "generate_mask_labels", "distribute_fpn_proposals",
           "collect_fpn_proposals", "target_assign", "mine_hard_examples",
           "ssd_loss", "matrix_nms"]

_BBOX_CLIP = float(np.log(1000.0 / 16.0))
_INF = float("inf")


def _t(v, device, dtype=None):
    return torch.as_tensor(v, dtype=dtype, device=device)


def _encode_rowwise(targets, priors, box_normalized=False, weights=None):
    """Center-size encode of target[i] against prior[i] (the Faster R-CNN
    delta form of box_coder_op.h): [..., 4] -> [..., 4]."""
    off = 0.0 if box_normalized else 1.0
    pw = priors[..., 2] - priors[..., 0] + off
    ph = priors[..., 3] - priors[..., 1] + off
    pcx = priors[..., 0] + pw * 0.5
    pcy = priors[..., 1] + ph * 0.5
    tw = targets[..., 2] - targets[..., 0] + off
    th = targets[..., 3] - targets[..., 1] + off
    tcx = targets[..., 0] + tw * 0.5
    tcy = targets[..., 1] + th * 0.5
    out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                       torch.log((tw / pw).clamp(min=1e-10)),
                       torch.log((th / ph).clamp(min=1e-10))], -1)
    if weights is not None:
        out = out / _t(weights, out.device, out.dtype)
    return out


def _rank(keys):
    """Each entry's place in the stable descending order of keys [..., n]."""
    order = torch.sort(-keys, dim=-1, stable=True).indices
    ar = torch.arange(keys.shape[-1], device=keys.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def _sample_mask(cand, quota, generator):
    """Up to `quota` of the True entries of cand [n]: random under a
    generator, the lowest indices without. Returns (mask, count int32)."""
    n = cand.shape[0]
    quota = torch.minimum(_t(quota, cand.device).int(), cand.sum().int())
    if generator is None:
        keys = -torch.arange(n, dtype=torch.float32, device=cand.device)
    else:
        keys = torch.rand(n, generator=generator, device=cand.device)
    rank = _rank(torch.where(cand, keys, -_INF))
    return cand & (rank < quota), quota


def decode_proposals(anchors, deltas, variances=None):
    """generate_proposals_op.cc's BoxCoder: RPN deltas against anchors
    ((x1, y1, x2, y2), +1-pixel widths, exp clipped at log(1000 / 16)):
    [..., 4] -> [..., 4]."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    d = deltas if variances is None else variances * deltas
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    w = torch.exp(d[..., 2].clamp(max=_BBOX_CLIP)) * aw
    h = torch.exp(d[..., 3].clamp(max=_BBOX_CLIP)) * ah
    return torch.stack([cx - w / 2, cy - h / 2,
                        cx + w / 2 - 1, cy + h / 2 - 1], -1)


def _proposal_candidates(scores, bbox_deltas, im_info, anchors, variances,
                         pre_nms_top_n=6000, min_size=0.1):
    """The NMS input of `generate_proposals` for scores [B, N]: the
    pre_nms_top_n best anchors' decoded boxes clipped to the image
    [B, k, 4], their scores with the too-small and off-image boxes at
    -inf [B, k], and their scores as given [B, k]."""
    n = scores.shape[-1]
    k = min(int(pre_nms_top_n), n) if pre_nms_top_n > 0 else n
    top = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
    props = decode_proposals(
        anchors[top], torch.gather(bbox_deltas, 1, top[..., None].expand(
            -1, -1, 4)), None if variances is None else variances[top])
    info = _t(im_info, scores.device).reshape(-1, 3)
    h, w, scale = info[:, 0:1], info[:, 1:2], info[:, 2:3]

    def clip(v, hi):
        return torch.minimum(v.clamp(min=0.0), hi - 1)

    props = torch.stack([clip(props[..., 0], w), clip(props[..., 1], h),
                         clip(props[..., 2], w), clip(props[..., 3], h)], -1)
    ms = max(min_size, 1.0)
    ws = props[..., 2] - props[..., 0] + 1
    hs = props[..., 3] - props[..., 1] + 1
    keep = (((ws - 1) / scale + 1 >= ms) & ((hs - 1) / scale + 1 >= ms)
            & (props[..., 0] + ws / 2 <= w) & (props[..., 1] + hs / 2 <= h))
    top_sc = torch.gather(scores, 1, top)
    return props, torch.where(keep, top_sc, -_INF), top_sc


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0):
    """generate_proposals_op.cc:81. One image: scores [N] (objectness),
    bbox_deltas [N, 4] in the layout of anchors [N, 4] (variances [N, 4]
    or None), im_info [3] = (h, w, scale). Returns (rois [post_nms_top_n,
    4] zero-padded, roi_probs [post_nms_top_n], num_valid int32). A batch
    (scores [B, N], deltas [B, N, 4], im_info [B, 3]) runs its NMS in
    one call. `eta` (adaptive NMS) raises unless 1: the JAX function
    takes it and applies nothing."""
    if eta != 1.0:
        raise NotImplementedError(
            "generate_proposals(eta=) other than 1.0 is not supported: the "
            "JAX package takes it and applies nothing")
    single = scores.dim() == 1
    if single:
        scores, bbox_deltas, im_info = scores[None], bbox_deltas[None], \
            im_info[None]
    props, sc, top_sc = _proposal_candidates(
        scores, bbox_deltas, im_info, anchors, variances, pre_nms_top_n,
        min_size)
    k = props.shape[1]
    post = int(post_nms_top_n)
    keep_idx, cnt = nms(props, sc, nms_thresh, max_out=post,
                        normalized=False)
    valid = (torch.arange(post, device=sc.device) < cnt[:, None]) & \
        (keep_idx >= 0)
    sel = keep_idx.long().clamp(0, k - 1)
    real = valid & torch.isfinite(torch.where(
        valid, torch.gather(sc, 1, sel), 0.0))
    rois = torch.where(real[..., None], torch.gather(
        props, 1, sel[..., None].expand(-1, -1, 4)), 0.0)
    probs = torch.where(real, torch.gather(top_sc, 1, sel), 0.0)
    num = real.sum(1).int()
    return (rois[0], probs[0], num[0]) if single else (rois, probs, num)


def _gt_valid(G, gt_count, is_crowd, device):
    gv = torch.arange(G, device=device) < (G if gt_count is None else
                                           _t(gt_count, device))
    return gv & (_t(is_crowd, device) == 0)


def _best_anchor(iou, gvalid):
    """Detectron's rule: an anchor at some valid gt's best overlap."""
    g2a_max = iou.amax(0)
    return (((iou - g2a_max[None, :]).abs() < 1e-5) & gvalid[None, :]
            & (iou > 0)).any(1)


def rpn_target_assign(anchors, gt_boxes, is_crowd, im_info, gt_count=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, generator=None):
    """rpn_target_assign_op.cc:36, one image: anchors [A, 4], gt_boxes [G,
    4] (zero-padded; gt_count valid rows), is_crowd [G], im_info [3].
    Returns a dict: labels [A] int32 (1 fg, 0 bg, -1 ignored),
    bbox_targets [A, 4] (zero off fg), bbox_inside_weight [A, 4], fg_num,
    bg_num."""
    dev = anchors.device
    A, G = anchors.shape[0], gt_boxes.shape[0]
    gvalid = _gt_valid(G, gt_count, is_crowd, dev)
    info = _t(im_info, dev)
    h, w = info[0], info[1]
    t = rpn_straddle_thresh
    if t >= 0:
        inside = ((anchors[:, 0] >= -t) & (anchors[:, 1] >= -t)
                  & (anchors[:, 2] < w + t) & (anchors[:, 3] < h + t))
    else:
        inside = torch.ones(A, dtype=torch.bool, device=dev)
    iou = iou_matrix(anchors, gt_boxes, normalized=True)
    iou = torch.where(gvalid[None, :], iou, -1.0)
    iou = torch.where(inside[:, None], iou, -1.0)
    a2g_max, a2g_arg = iou.amax(1), iou.argmax(1)
    fg_cand = inside & (_best_anchor(iou, gvalid)
                        | (a2g_max >= rpn_positive_overlap))
    fg_quota = int(rpn_fg_fraction * rpn_batch_size_per_im) \
        if rpn_fg_fraction > 0 and rpn_batch_size_per_im > 0 else A
    fg_mask, fg_num = _sample_mask(fg_cand, fg_quota, generator)
    bg_cand = inside & (a2g_max < rpn_negative_overlap) & ~fg_mask
    bg_quota = rpn_batch_size_per_im - fg_num \
        if rpn_batch_size_per_im > 0 else A
    bg_mask, bg_num = _sample_mask(bg_cand, bg_quota, generator)
    labels = torch.full((A,), -1, dtype=torch.int32, device=dev)
    labels = torch.where(bg_mask, 0, labels)
    labels = torch.where(fg_mask, 1, labels).int()
    tgt = _encode_rowwise(gt_boxes[a2g_arg], anchors)
    return {"labels": labels,
            "bbox_targets": torch.where(fg_mask[:, None], tgt, 0.0),
            "bbox_inside_weight": fg_mask[:, None].expand(A, 4).to(
                anchors.dtype),
            "fg_num": fg_num, "bg_num": bg_num}


def retinanet_target_assign(anchors, gt_boxes, gt_labels, is_crowd, im_info,
                            gt_count=None, positive_overlap=0.5,
                            negative_overlap=0.4):
    """rpn_target_assign_op.cc:612: every non-ignored anchor is used (no
    sampling); fg labels carry the gt class. `im_info` is taken and, as
    in the JAX function, not applied (no straddle test)."""
    dev = anchors.device
    A, G = anchors.shape[0], gt_boxes.shape[0]
    gvalid = _gt_valid(G, gt_count, is_crowd, dev)
    iou = torch.where(gvalid[None, :],
                      iou_matrix(anchors, gt_boxes, normalized=True), -1.0)
    a2g_max, a2g_arg = iou.amax(1), iou.argmax(1)
    fg = _best_anchor(iou, gvalid) | (a2g_max >= positive_overlap)
    bg = ~fg & (a2g_max < negative_overlap) & (a2g_max >= 0)
    labels = torch.full((A,), -1, dtype=torch.int32, device=dev)
    labels = torch.where(bg, 0, labels)
    labels = torch.where(fg, _t(gt_labels, dev).int()[a2g_arg], labels)
    tgt = _encode_rowwise(gt_boxes[a2g_arg], anchors)
    return {"labels": labels.int(),
            "bbox_targets": torch.where(fg[:, None], tgt, 0.0),
            "bbox_inside_weight": fg[:, None].expand(A, 4).to(
                anchors.dtype),
            "fg_num": fg.sum().int()}


def generate_proposal_labels(rois, roi_count, gt_classes, is_crowd, gt_boxes,
                             im_scale, gt_count=None,
                             batch_size_per_im=512, fg_fraction=0.25,
                             fg_thresh=0.5, bg_thresh_hi=0.5,
                             bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=81, use_gt_as_rois=True,
                             generator=None, is_cls_agnostic=False):
    """generate_proposal_labels_op.cc:43, one image: rois [R, 4] with
    roi_count valid, gt_boxes [G, 4] at the original scale (scaled by
    im_scale here), gt_classes [G]. Returns a dict of static shapes
    (B = batch_size_per_im): rois [B, 4], labels_int32 [B] (0
    background, -1 pad; fg rows first), bbox_targets and the inside /
    outside weights [B, 4 * class_nums] (the label's slot), fg_num,
    valid_num, gt_index [B]."""
    dev = rois.device
    R, G = rois.shape[0], gt_boxes.shape[0]
    B = int(batch_size_per_im)
    gvalid = torch.arange(G, device=dev) < (G if gt_count is None else
                                            _t(gt_count, dev))
    nonzero = ((gt_boxes[:, 2] > gt_boxes[:, 0])
               & (gt_boxes[:, 3] > gt_boxes[:, 1]))
    not_crowd = gvalid & nonzero & (_t(is_crowd, dev) == 0)
    gt_scaled = gt_boxes * im_scale
    rvalid = torch.arange(R, device=dev) < _t(roi_count, dev)
    if use_gt_as_rois:
        allb = torch.cat([rois, gt_scaled], 0)
        bvalid = torch.cat([rvalid, not_crowd], 0)
    else:
        allb, bvalid = rois, rvalid
    N = allb.shape[0]
    if N < B:
        allb = torch.cat([allb, allb.new_zeros(B - N, 4)], 0)
        bvalid = torch.cat([bvalid, bvalid.new_zeros(B - N)], 0)
        N = B
    iou = iou_matrix(allb, gt_scaled, normalized=False)
    iou = torch.where(not_crowd[None, :], iou, -1.0)
    iou = torch.where(bvalid[:, None], iou, -1.0)
    b2g_max, b2g_arg = iou.amax(1), iou.argmax(1)
    fg_cand = bvalid & (b2g_max >= fg_thresh)
    bg_cand = bvalid & (b2g_max < bg_thresh_hi) & (b2g_max >= bg_thresh_lo)
    fg_mask, fg_num = _sample_mask(fg_cand, int(np.round(fg_fraction * B)),
                                   generator)
    bg_mask, bg_num = _sample_mask(bg_cand, B - fg_num, generator)
    skey = torch.where(fg_mask, 2.0, torch.where(bg_mask, 1.0, 0.0))
    tie = -torch.arange(N, dtype=torch.float32, device=dev) * 1e-9
    sel = torch.sort(-(skey + tie), stable=True).indices[:B]
    sel_fg = fg_mask[sel]
    sel_valid = (fg_mask | bg_mask)[sel]
    glab = _t(gt_classes, dev).int()[b2g_arg[sel]]
    labels = torch.where(sel_fg, glab, torch.where(sel_valid, 0, -1)).int()
    tgt = _encode_rowwise(gt_scaled[b2g_arg[sel]], allb[sel],
                          weights=bbox_reg_weights)
    C = 1 if is_cls_agnostic else int(class_nums)
    cls = torch.where(sel_fg, torch.ones_like(glab) if is_cls_agnostic
                      else glab, 0)
    slot = (torch.arange(B, device=dev), cls.long().clamp(0, C - 1))
    on = (cls > 0)[:, None, None]
    zeros = allb.new_zeros(B, C, 4)
    bt = zeros.index_put(slot, torch.where(sel_fg[:, None], tgt, 0.0)) * on
    inw = zeros.index_put(slot, sel_fg[:, None].expand(B, 4).to(
        allb.dtype)) * on
    return {"rois": torch.where(sel_valid[:, None], allb[sel], 0.0),
            "labels_int32": labels,
            "bbox_targets": bt.reshape(B, C * 4),
            "bbox_inside_weights": inw.reshape(B, C * 4),
            "bbox_outside_weights": inw.reshape(B, C * 4),
            "fg_num": fg_num, "valid_num": fg_num + bg_num,
            "gt_index": b2g_arg[sel]}


def generate_mask_labels(gt_masks, sampled_rois, sampled_labels, gt_index,
                         resolution=14, num_classes=81):
    """Mask-head targets (generate_mask_labels_op.cc, bitmask form): each
    sampled RoI cropped from its gt bitmask gt_masks [G, H, W] by the
    nearest pixel at resolution x resolution bin centers. Returns [B,
    resolution, resolution] float32 in {0, 1}, -1 on non-fg rows. The
    targets are class-agnostic; `num_classes` is taken and, as in the JAX
    function, not applied."""
    dev = sampled_rois.device
    B, res = sampled_rois.shape[0], int(resolution)
    x1, y1, x2, y2 = sampled_rois.unbind(-1)
    t = _div(torch.arange(res, dtype=torch.float64, device=dev) + 0.5,
             res).to(sampled_rois.dtype)
    gx = x1[:, None] + t[None, :] * (x2 - x1 + 1)[:, None]
    gy = y1[:, None] + t[None, :] * (y2 - y1 + 1)[:, None]
    masks = _t(gt_masks, dev)[_t(gt_index, dev).long()]
    H, W = masks.shape[1], masks.shape[2]
    xi = gx.int().clamp(0, W - 1).long()
    yi = gy.int().clamp(0, H - 1).long()
    out = masks[torch.arange(B, device=dev)[:, None, None], yi[:, :, None],
                xi[:, None, :]]
    fg = _t(sampled_labels, dev) > 0
    return torch.where(fg[:, None, None], out.float(), -1.0)


def distribute_fpn_proposals(rois, roi_count, min_level=2, max_level=5,
                             refer_level=4, refer_scale=224):
    """distribute_fpn_proposals_op.cc:24: route each RoI to an FPN level by
    sqrt(area). Returns ([(rois [R, 4] compacted to the front in their
    order, mask [R], count int32) a level], restore_index [R] int32:
    the input row of each concatenated output row, -1 past roi_count)."""
    dev = rois.device
    R = rois.shape[0]
    valid = torch.arange(R, device=dev) < _t(roi_count, dev)
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    scale = torch.sqrt(w.clamp(min=0) * h.clamp(min=0))
    lvl = torch.floor(torch.log2(_div(scale, refer_scale) + 1e-6)) + \
        refer_level
    lvl = torch.where(valid, lvl.clamp(min_level, max_level).int(),
                      max_level + 1)
    outs = []
    offset = torch.zeros((), dtype=torch.long, device=dev)
    # row R of each buffer takes the rows routed elsewhere and is dropped
    pos = torch.full((R,), R, dtype=torch.long, device=dev)
    for level in range(min_level, max_level + 1):
        m = lvl == level
        rank = torch.cumsum(m.long(), 0) - 1
        buf = rois.new_zeros(R + 1, 4).index_put(
            (torch.where(m, rank, R),), torch.where(m[:, None], rois, 0.0))
        pos = torch.where(m, offset + rank, pos)
        cnt = m.sum()
        offset = offset + cnt
        outs.append((buf[:R], m, cnt.int()))
    restore = torch.zeros(R + 1, dtype=torch.int32, device=dev).index_put(
        (pos,), torch.arange(R, dtype=torch.int32, device=dev))[:R]
    return outs, torch.where(valid, restore, -1)


def collect_fpn_proposals(multi_rois, multi_scores, counts,
                          post_nms_top_n=1000):
    """collect_fpn_proposals_op.cc:29: concatenate the levels' (rois,
    scores), counts[i] valid each, and keep the post_nms_top_n best.
    Returns (rois [K, 4], scores [K], num_valid int32)."""
    rois = torch.cat(list(multi_rois), 0)
    scores = torch.cat(list(multi_scores), 0)
    dev = rois.device
    valids = torch.cat([torch.arange(r.shape[0], device=dev) < _t(c, dev)
                        for r, c in zip(multi_rois, counts)], 0)
    sc = torch.where(valids, scores, -_INF)
    top = torch.sort(-sc, stable=True).indices[:int(post_nms_top_n)]
    ok = sc[top] > -_INF
    return (torch.where(ok[:, None], rois[top], 0.0),
            torch.where(ok, scores[top], 0.0), ok.sum().int())


def target_assign(x, match_indices, mismatch_value=0.0, x_count=None):
    """target_assign_op.cc:24, batched: x [B, M, K] (or [B, M]),
    match_indices [B, P] (-1 unmatched) -> (out [B, P, K]: x[b, match]
    or mismatch_value; weights [B, P] float32). x_count [B] treats rows
    past each count as unmatched."""
    mi = _t(match_indices, x.device).long()
    B, M = x.shape[0], x.shape[1]
    matched = mi >= 0
    if x_count is not None:
        matched = matched & (mi < _t(x_count, x.device)[:, None])
    out = x[torch.arange(B, device=x.device)[:, None], mi.clamp(0, M - 1)]
    cond = matched[..., None] if out.dim() == 3 else matched
    return torch.where(cond, out, mismatch_value), matched.float()


def mine_hard_examples(cls_loss, match_indices, match_dist, loc_loss=None,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5,
                       sample_size=0, mining_type="max_negative"):
    """mine_hard_examples_op.cc:268: the negative candidates (unmatched,
    match_dist < neg_dist_threshold) with the largest loss, neg_pos_ratio
    x the positives a row (or sample_size with "hard_example", whose loss
    adds loc_loss). Returns (neg_mask [B, P] bool, match_indices with
    the negatives at -1)."""
    cl = cls_loss
    if loc_loss is not None and mining_type == "hard_example":
        cl = cl + loc_loss
    mi = _t(match_indices, cl.device)
    md = _t(match_dist, cl.device)
    pos = mi >= 0
    neg_cand = ~pos & (md < neg_dist_threshold)
    if mining_type == "hard_example" and sample_size > 0:
        quota = torch.full((cl.shape[0],), int(sample_size),
                           dtype=torch.int32, device=cl.device)
    else:
        quota = torch.ceil(pos.sum(1).float() * neg_pos_ratio).int()
    quota = torch.minimum(quota, neg_cand.sum(1).int())
    rank = _rank(torch.where(neg_cand, cl, -_INF))
    return neg_cand & (rank < quota[:, None]), torch.where(pos, mi, -1)


def _ssd_targets(confidence, gt_box, gt_label, prior_box, prior_box_var,
                 background_label, overlap_threshold, neg_pos_ratio,
                 neg_overlap, match_type):
    """The matching half of `ssd_loss`, without gradients: (match [B, P]
    int32, pos, neg [B, P] bool, loc targets [B, P, 4], labels [B, P],
    conf_loss [B, P] float32 with its graph to confidence)."""
    B, P, C = confidence.shape
    dev = confidence.device
    G = gt_box.shape[1]
    if prior_box_var is None:
        var = torch.ones(4, device=dev)
    else:
        var = _t(prior_box_var, dev, torch.float32).reshape(-1, 4)
        if var.shape[0] == 1:
            var = var[0]
    with torch.no_grad():
        gv = (gt_box[..., 2] > gt_box[..., 0]) & \
            (gt_box[..., 3] > gt_box[..., 1])
        iou = torch.where(gv[..., None],
                          iou_matrix(gt_box, prior_box, normalized=True),
                          -1.0)                           # [B, G, P]
        match, _ = bipartite_match(iou)
        best, arg = iou.amax(1), iou.argmax(1)
        if match_type == "per_prediction":
            extra = (match < 0) & (best >= overlap_threshold)
            match = torch.where(extra, arg.int(), match)
        pos = match >= 0
        sel = match.long().clamp(0, G - 1)
        rows = torch.arange(B, device=dev)[:, None]
        tgt = _encode_rowwise(gt_box[rows, sel], prior_box, weights=var)
        lbl = torch.where(pos, _t(gt_label, dev).long()[rows, sel],
                          background_label)
    lp = torch.log_softmax(confidence.float(), -1)
    conf_loss = -torch.gather(lp, -1, lbl[..., None])[..., 0]
    neg_cand = ~pos & (best < neg_overlap)
    quota = torch.minimum(torch.ceil(pos.sum(1) * neg_pos_ratio).int(),
                          neg_cand.sum(1).int())
    rank = _rank(torch.where(neg_cand, conf_loss.detach(), -_INF))
    neg = neg_cand & (rank < quota[:, None])
    return match, pos, neg, tgt, lbl, conf_loss


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction"):
    """The SSD multibox loss in one op (fluid's ssd_loss composition over
    bipartite matching, target_assign and hard-negative mining):
    location [B, P, 4] deltas, confidence [B, P, C] logits, gt_box [B, G,
    4] (rows past the real count zero-area), gt_label [B, G], prior_box
    [P, 4]. The matching runs under no_grad; the loss is differentiable
    in location and confidence, and is computed in float32 whatever
    their type, as in the JAX function. Returns [1] in location's type."""
    _, pos, neg, tgt, _, conf_loss = _ssd_targets(
        confidence, gt_box.detach(), gt_label, prior_box, prior_box_var,
        background_label, overlap_threshold, neg_pos_ratio, neg_overlap,
        match_type)
    diff = (location - tgt).float()
    ad = diff.abs()
    sl1 = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5).sum(-1)
    denom = pos.sum(1).float().clamp(min=1.0)
    losses = (loc_loss_weight * (sl1 * pos).sum(1)
              + conf_loss_weight * (conf_loss * (pos | neg)).sum(1)) / denom
    return losses.mean().reshape(1).to(location.dtype)


def matrix_nms(bboxes, scores, score_threshold=0.05, post_threshold=0.0,
               nms_top_k=400, keep_top_k=100, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True):
    """matrix_nms_op.cc:87: parallel soft suppression: the decay of box j
    is min over higher-scored same-class boxes i of f(iou_ij) /
    f(iou_max_i), all classes in one batched matrix. bboxes [N, 4],
    scores [C, N]. Returns (out [keep_top_k, 6] rows [label, score, x1,
    y1, x2, y2] padded -1, index [keep_top_k] into N int32, num_valid)."""
    C, N = scores.shape
    dev = scores.device
    K = int(keep_top_k)
    classes = [c for c in range(C) if c != background_label]
    if not classes:
        return (torch.full((K, 6), -1.0, device=dev),
                torch.full((K,), -1, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    k = min(int(nms_top_k), N)
    cls = torch.tensor(classes, device=dev)
    sc = scores[cls]
    sck = torch.where(sc > score_threshold, sc, -_INF)
    top = torch.sort(-sck, dim=1, stable=True).indices[:, :k]
    svalid = torch.isfinite(torch.gather(sck, 1, top))
    b = bboxes[top]                                       # [C', k, 4]
    iou = iou_matrix(b, b, normalized)
    upper = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
    iou_u = torch.where(upper & svalid[:, :, None] & svalid[:, None, :],
                        iou, 0.0)
    comp = iou_u.amax(1)[:, :, None]
    if use_gaussian:
        decay = torch.exp(_div(-(iou_u ** 2 - comp ** 2), gaussian_sigma))
    else:
        decay = (1.0 - iou_u) / (1.0 - comp).clamp(min=1e-10)
    decay = torch.where(upper, decay, _INF).amin(1)
    decay = torch.where(torch.isinf(decay), 1.0, decay)
    newsc = torch.where(svalid, torch.gather(sc, 1, top) * decay, -1.0)
    if post_threshold > 0:
        newsc = torch.where(newsc >= post_threshold, newsc, -1.0)
    rows = torch.cat([cls.float()[:, None, None].expand(-1, k, 1),
                      newsc[..., None].float(), b.float()], -1).reshape(-1, 6)
    idx = top.reshape(-1)
    keyv = torch.where(rows[:, 1] > 0, rows[:, 1], -_INF)
    sel = torch.sort(-keyv, stable=True).indices[:K]
    ok = torch.isfinite(keyv[sel])
    out = torch.where(ok[:, None], rows[sel], -1.0)
    out_idx = torch.where(ok, idx[sel], -1)
    pad = K - out.shape[0]
    if pad > 0:
        out = torch.cat([out, out.new_full((pad, 6), -1.0)], 0)
        out_idx = torch.cat([out_idx, out_idx.new_full((pad,), -1)], 0)
    return out, out_idx.int(), ok.sum().int()
