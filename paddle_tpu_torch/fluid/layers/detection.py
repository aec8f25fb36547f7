"""The detection builders (the JAX package's `fluid/layers/detection.py`).

They come with their lowerings in ROADMAP item 8b and raise until
then.
"""
from __future__ import annotations

from .control_flow import _waits

__all__ = [
    "iou_similarity", "box_coder", "box_clip", "multiclass_nms",
    "yolo_box", "prior_box", "anchor_generator", "roi_align",
    "roi_pool", "generate_proposals", "rpn_target_assign",
    "retinanet_target_assign", "generate_proposal_labels",
    "distribute_fpn_proposals", "collect_fpn_proposals",
    "generate_mask_labels", "target_assign", "mine_hard_examples",
    "matrix_nms", "ssd_loss", "bipartite_match",
]

iou_similarity = _waits("iou_similarity")
box_coder = _waits("box_coder")
box_clip = _waits("box_clip")
multiclass_nms = _waits("multiclass_nms")
yolo_box = _waits("yolo_box")
prior_box = _waits("prior_box")
anchor_generator = _waits("anchor_generator")
roi_align = _waits("roi_align")
roi_pool = _waits("roi_pool")
generate_proposals = _waits("generate_proposals")
rpn_target_assign = _waits("rpn_target_assign")
retinanet_target_assign = _waits("retinanet_target_assign")
generate_proposal_labels = _waits("generate_proposal_labels")
distribute_fpn_proposals = _waits("distribute_fpn_proposals")
collect_fpn_proposals = _waits("collect_fpn_proposals")
generate_mask_labels = _waits("generate_mask_labels")
target_assign = _waits("target_assign")
mine_hard_examples = _waits("mine_hard_examples")
matrix_nms = _waits("matrix_nms")
ssd_loss = _waits("ssd_loss")
bipartite_match = _waits("bipartite_match")
