"""paddle.vision.ops (the JAX package's `vision/ops.py`): the detection
operators at Paddle's signatures, over `ops/detection.py`. NMS results
keep the static form there (-1-padded buffers and counts) except
`nms`, which returns the kept indices alone."""
from __future__ import annotations

import torch

from ..ops import detection as D

__all__ = ["nms", "multiclass_nms", "roi_align", "roi_pool", "yolo_box",
           "prior_box", "box_coder", "iou_similarity", "bipartite_match",
           "box_clip"]


def nms(boxes, iou_threshold=0.3, scores=None, score_threshold=None,
        category_idxs=None, categories=None, top_k=None):
    """Greedy NMS; returns the kept indices (int32) in score order. With
    category_idxs, each category runs apart: the boxes are shifted onto
    disjoint canvases, so boxes of two categories never overlap.
    `categories` raises: the JAX function takes it and applies nothing."""
    if categories is not None:
        raise NotImplementedError(
            "nms(categories=) is not supported: the JAX package takes it "
            "and applies nothing (every category of category_idxs runs)")
    n = boxes.shape[0]
    s = scores if scores is not None else torch.ones(
        n, dtype=boxes.dtype, device=boxes.device)
    if category_idxs is not None:
        cats = torch.as_tensor(category_idxs, device=boxes.device).float()
        span = boxes.abs().max() + 1.0
        boxes = boxes + (cats.to(boxes.dtype) * 2.0 * span)[:, None]
    keep, cnt = D.nms(boxes, s, iou_threshold, score_threshold, top_k or n)
    return keep[:int(cnt)]


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=64,
                   keep_top_k=100, nms_threshold=0.3, background_label=0):
    return D.multiclass_nms(bboxes, scores, score_threshold, nms_top_k,
                            keep_top_k, nms_threshold,
                            background_label=background_label)


def _batch_ids(boxes, boxes_num):
    if boxes_num is None:
        return torch.zeros(boxes.shape[0], dtype=torch.long,
                           device=boxes.device)
    bn = torch.as_tensor(boxes_num, device=boxes.device).reshape(-1).long()
    return torch.repeat_interleave(torch.arange(len(bn), device=bn.device),
                                   bn)


def roi_align(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """RoI align with boxes_num [B] RoIs an image (all from image 0
    without); `aligned` is True by default at this layer."""
    return D.roi_align(x, boxes, _batch_ids(boxes, boxes_num), output_size,
                       spatial_scale, sampling_ratio, aligned)


def roi_pool(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0):
    return D.roi_pool(x, boxes, _batch_ids(boxes, boxes_num), output_size,
                      spatial_scale)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, name=None, scale_x_y=1.0):
    return D.yolo_box(x, img_size, anchors, class_num, conf_thresh,
                      downsample_ratio, clip_bbox, scale_x_y)


def prior_box(input, image, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD priors of the feature map `input` [B, C, H, W] over `image` [B,
    C, h, w]; steps is Paddle's [step_w, step_h]."""
    return D.prior_box(
        tuple(input.shape[2:4]), tuple(image.shape[2:4]), list(min_sizes),
        list(max_sizes) if max_sizes else None, tuple(aspect_ratios),
        tuple(variance), flip, clip,
        (steps[1] if len(steps) > 1 else steps[0], steps[0]), offset,
        min_max_aspect_ratios_order, device=input.device)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    """Box encode / decode. `axis` other than 0 raises: the JAX function
    takes it and applies nothing."""
    if axis != 0:
        raise NotImplementedError(
            "box_coder(axis=) other than 0 is not supported: the JAX "
            "package takes it and applies nothing")
    return D.box_coder(prior_box, prior_box_var, target_box, code_type,
                       box_normalized)


def iou_similarity(x, y, box_normalized=True):
    return D.iou_matrix(x, y, box_normalized)


def bipartite_match(dist_matrix):
    return D.bipartite_match(dist_matrix)


def box_clip(input, im_info, name=None):
    return D.box_clip(input, im_info)
