"""Detection op library (the JAX package's `ops/detection.py`): IoU,
greedy NMS and multi-class NMS, box clip / coder, SSD priors, RPN
anchors, the YOLOv3 box decoder, RoI align / pool, bipartite matching.

Outputs keep the JAX package's static form: NMS returns index buffers
padded with -1 plus a valid count, `multiclass_nms` [keep_top_k, 6] rows
[label, score, x1, y1, x2, y2] padded with -1. Every op runs on its
inputs' device (the prior and anchor generators, which take none, on
`device`, the card by default).

Greedy NMS. The JAX `nms` builds the N x N IoU matrix and loops over all
N sorted candidates. Here each of at most `max_out` picks takes the
first live candidate in score order and clears the live candidates its
IoU row suppresses, batched over rows (classes x images), with no host
sync inside the loop: the launches grow with `max_out`, not with N, and
no N x N matrix is made. The picks are the JAX function's: a candidate
is kept iff it is valid and no earlier kept candidate overlaps it by
more than the threshold. The loop first runs over the 4 * max_out best
candidates of each row, which is exact for every row that fills its
max_out picks there (a pick depends only on earlier candidates) or has
no valid candidate past them; the other rows run once more over all N.
Every sort is stable, as `jnp.argsort` is (ties by lower index).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["box_area", "iou_matrix", "nms", "multiclass_nms", "box_clip",
           "box_coder", "prior_box", "anchor_generator", "yolo_box",
           "roi_align", "roi_pool", "bipartite_match", "density_prior_box"]

#: the first NMS pass runs over this many times max_out best candidates
NMS_WINDOW = 4


def _div(x, d):
    """x / d for a Python number d by true division on every device: CUDA
    would multiply by d's reciprocal, one rounding more than the JAX
    function's division."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def box_area(boxes):
    return ((boxes[..., 2] - boxes[..., 0]) *
            (boxes[..., 3] - boxes[..., 1]))


def iou_matrix(a, b, normalized=True):
    """Pairwise IoU: a [..., N, 4], b [..., M, 4] -> [..., N, M]
    (iou_similarity_op.h)."""
    off = 0.0 if normalized else 1.0
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + off).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0] + off) * (a[..., 3] - a[..., 1] + off)
    area_b = (b[..., 2] - b[..., 0] + off) * (b[..., 3] - b[..., 1] + off)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _picks(coords, live, k, thr, off):
    """k greedy picks over sorted candidates: coords [4, R, N] (x1, y1,
    x2, y2 in score order), live [R, N] bool. Returns the picks' sorted
    positions [R, k] (-1 past a row's last pick)."""
    x1, y1, x2, y2 = coords
    area = (x2 - x1 + off) * (y2 - y1 + off)
    table = torch.cat([coords, area[None]])
    R = live.shape[0]
    rows = torch.arange(R, device=live.device)
    live = live.to(torch.uint8)
    pos = torch.empty((R, k), dtype=torch.long, device=live.device)
    for p in range(k):
        j = live.argmax(1)                      # the first live candidate
        pos[:, p] = torch.where(live[rows, j].bool(), j, -1)
        bx1, by1, bx2, by2, barea = table[:, rows, j][..., None]
        live[rows, j] = 0
        w = torch.minimum(x2, bx2) - torch.maximum(x1, bx1)
        h = torch.minimum(y2, by2) - torch.maximum(y1, by1)
        if off:
            w, h = w + off, h + off
        inter = w.clamp_(min=0.0) * h.clamp_(min=0.0)
        union = area + barea - inter
        iou = torch.where(union > 0, inter / union, 0.0)
        live.masked_fill_(iou > thr, 0)
    return pos


def _nms_rows(boxes, scores, valid, max_out, thr, normalized, box_row=None):
    """Greedy NMS of each row of scores [R, N] over boxes [Rb, N, 4]
    (row r's boxes are boxes[box_row[r]]; box_row None: Rb == R).
    Returns (keep [R, max_out] int32 padded -1, count [R] int32)."""
    R, N = scores.shape
    off = 0.0 if normalized else 1.0
    k = min(max_out, N)
    order = torch.sort(-scores, dim=1, stable=True).indices
    coords = boxes.permute(2, 0, 1)
    if box_row is not None:
        coords = coords[:, box_row]
    coords = torch.gather(coords, 2, order[None].expand(4, R, N))
    live = torch.gather(valid, 1, order)
    win = min(N, NMS_WINDOW * k)
    pos = _picks(coords[:, :, :win], live[:, :win], k, thr, off)
    if win < N:
        done = (pos[:, -1] >= 0) | ~live[:, win:].any(1)
        redo = (~done).nonzero()[:, 0]
        if redo.numel():
            pos[redo] = _picks(coords[:, redo], live[redo], k, thr, off)
    keep = torch.where(pos >= 0, torch.gather(order, 1, pos.clamp(min=0)),
                       -1)
    if max_out > k:
        keep = torch.cat([keep, keep.new_full((R, max_out - k), -1)], 1)
    return keep.int(), (pos >= 0).sum(1).int()


def nms(boxes, scores, iou_threshold=0.3, score_threshold=None,
        max_out=None, normalized=True):
    """Greedy hard NMS: boxes [..., N, 4], scores [..., N] -> (keep
    [..., max_out] int32 padded -1, count [...] int32). Candidates in
    stable score order; only scores above score_threshold are kept;
    a kept box suppresses every later one with IoU > iou_threshold; at
    most max_out picks (default N)."""
    N = boxes.shape[-2]
    lead = scores.shape[:-1]
    max_out = int(max_out or N)
    sc = scores.reshape(-1, N)
    valid = sc > score_threshold if score_threshold is not None else \
        torch.ones_like(sc, dtype=torch.bool)
    bx = boxes.expand(lead + (N, 4)).reshape(-1, N, 4)
    keep, cnt = _nms_rows(bx, sc, valid, max_out, iou_threshold,
                          normalized)
    return keep.reshape(lead + (max_out,)), cnt.reshape(lead)


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=64,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   background_label=0):
    """multiclass_nms_op.cc with a static output: bboxes [N, 4], scores
    [C, N] -> (out [keep_top_k, 6] rows [label, score, x1, y1, x2, y2]
    padded with -1, num_valid). A batch of images, bboxes [B, N, 4] and
    scores [B, C, N], gives [B, keep_top_k, 6] and [B] in one call.
    `nms_top_k` caps each class's picks (the JAX function's reading; the
    reference caps the candidates before NMS)."""
    single = bboxes.dim() == 2
    if single:
        bboxes, scores = bboxes[None], scores[None]
    B, C, N = scores.shape
    dev = scores.device
    classes = [c for c in range(C) if c != background_label]
    if not classes:
        out = torch.full((B, keep_top_k, 6), -1.0, device=dev)
        num = torch.zeros(B, dtype=torch.int32, device=dev)
        return (out[0], num[0]) if single else (out, num)
    cls = torch.tensor(classes, device=dev)
    sc = scores[:, cls].reshape(B * len(classes), N)
    k = min(nms_top_k, N)
    valid = sc > score_threshold if score_threshold is not None else \
        torch.ones_like(sc, dtype=torch.bool)
    box_row = torch.arange(B, device=dev).repeat_interleave(len(classes))
    keep, cnt = _nms_rows(bboxes, sc, valid, k,
                          nms_threshold, normalized, box_row)
    sel = keep.long().clamp(min=0)
    valid = (torch.arange(k, device=dev)[None, :] < cnt[:, None]) & \
        (keep >= 0)
    rows = torch.cat([
        cls.float().repeat(B)[:, None, None].expand(-1, k, 1),
        torch.gather(sc, 1, sel)[..., None].float(),
        bboxes[box_row[:, None], sel].float()], -1)
    rows = torch.where(valid[..., None], rows, -1.0)
    rows = rows.reshape(B, len(classes) * k, 6)
    key = torch.where(rows[..., 0] >= 0, rows[..., 1], -float("inf"))
    top = torch.sort(-key, dim=1, stable=True).indices[:, :keep_top_k]
    out = torch.gather(rows, 1, top[..., None].expand(-1, -1, 6))
    if out.shape[1] < keep_top_k:
        out = torch.cat([out, out.new_full(
            (B, keep_top_k - out.shape[1], 6), -1.0)], 1)
    num = (out[..., 0] >= 0).sum(1).int()
    return (out[0], num[0]) if single else (out, num)


def box_clip(boxes, im_shape):
    """box_clip_op.h: clip to [0, w - 1] x [0, h - 1]; im_shape (h, w)."""
    hw = torch.as_tensor(im_shape, device=boxes.device)
    h, w = hw[0], hw[1]

    def clip(v, hi):
        return torch.minimum(v.clamp(min=0), hi - 1)

    return torch.stack([clip(boxes[..., 0], w), clip(boxes[..., 1], h),
                        clip(boxes[..., 2], w), clip(boxes[..., 3], h)], -1)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True):
    """box_coder_op.h: encode targets [N, 4] against priors [M, 4] into
    [N, M, 4], or decode deltas [..., M, 4] against the priors."""
    dev = prior_box.device
    off = 0.0 if box_normalized else 1.0
    pw = prior_box[:, 2] - prior_box[:, 0] + off
    ph = prior_box[:, 3] - prior_box[:, 1] + off
    pcx = prior_box[:, 0] + pw * 0.5
    pcy = prior_box[:, 1] + ph * 0.5
    if prior_box_var is None:
        var = torch.ones((1, 4), device=dev)
    elif np.ndim(prior_box_var) == 1:
        var = torch.as_tensor(prior_box_var, dtype=torch.float32,
                              device=dev).reshape(-1, 4)
    else:
        var = torch.as_tensor(prior_box_var, device=dev)
    if code_type.lower() in ("encode_center_size", "encode"):
        tw = target_box[:, 2] - target_box[:, 0] + off
        th = target_box[:, 3] - target_box[:, 1] + off
        tcx = target_box[:, 0] + tw * 0.5
        tcy = target_box[:, 1] + th * 0.5
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log((tw[:, None] / pw[None, :]).clamp(min=1e-10))
        dh = torch.log((th[:, None] / ph[None, :]).clamp(min=1e-10))
        return torch.stack([dx, dy, dw, dh], -1) / var[None, :, :]
    d = target_box * (var if var.shape[0] != 1 else var[0])
    cx = d[..., 0] * pw + pcx
    cy = d[..., 1] * ph + pcy
    w = torch.exp(d[..., 2]) * pw
    h = torch.exp(d[..., 3]) * ph
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5 - off, cy + h * 0.5 - off], -1)


def _centers(H, W, step_h, step_w, offset, dev):
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offset) * step_h
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")
    return cxg[..., None], cyg[..., None]


def _variances(variances, H, W, P, dev):
    return torch.tensor(variances, dtype=torch.float32,
                        device=dev).expand(H, W, P, 4)


def prior_box(input_hw, image_hw, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variances=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, device=None):
    """prior_box_op.h: SSD priors of one feature map. Returns (boxes [H,
    W, P, 4] normalized to the image, variances [H, W, P, 4])."""
    dev = resolve_device(device)
    H, W = input_hw
    img_h, img_w = image_hw
    step_h = steps[0] or img_h / H
    step_w = steps[1] or img_w / W
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    whs = []
    for ms in min_sizes:
        whs.append((ms, ms))
        if min_max_aspect_ratios_order and max_sizes:
            mx = max_sizes[min_sizes.index(ms)]
            whs.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        if max_sizes and not min_max_aspect_ratios_order:
            mx = max_sizes[min_sizes.index(ms)]
            whs.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
    whs = torch.from_numpy(np.asarray(whs, np.float32)).to(dev)
    cxg, cyg = _centers(H, W, step_h, step_w, offset, dev)
    w_half, h_half = whs[:, 0] * 0.5, whs[:, 1] * 0.5
    boxes = torch.stack([_div(cxg - w_half, img_w), _div(cyg - h_half, img_h),
                         _div(cxg + w_half, img_w), _div(cyg + h_half, img_h)],
                        -1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes, _variances(variances, H, W, len(whs), dev)


def anchor_generator(input_hw, anchor_sizes, aspect_ratios, stride,
                     variances=(0.1, 0.1, 0.2, 0.2), offset=0.5,
                     device=None):
    """anchor_generator_op.h: RPN anchors in input-image pixels. Returns
    (anchors [H, W, A, 4], variances [H, W, A, 4])."""
    dev = resolve_device(device)
    H, W = input_hw
    whs = []
    for ar in aspect_ratios:
        for sz in anchor_sizes:
            w = np.sqrt(sz * sz / ar)
            whs.append((w, w * ar))
    wh = torch.from_numpy(np.asarray(whs, np.float32)).to(dev) * 0.5
    cxg, cyg = _centers(H, W, stride[1], stride[0], offset, dev)
    anchors = torch.stack([cxg - wh[:, 0], cyg - wh[:, 1],
                           cxg + wh[:, 0], cyg + wh[:, 1]], -1)
    return anchors, _variances(variances, H, W, len(whs), dev)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0):
    """yolo_box_op.h: decode one YOLOv3 head. x [B, A * (5 + C), H, W],
    img_size [B, 2] (h, w). Returns (boxes [B, H * W * A, 4], scores [B,
    H * W * A, C]); boxes and scores of a confidence at or below
    conf_thresh are zero."""
    B, _, H, W = x.shape
    dev = x.device
    A, C = len(anchors) // 2, class_num
    x = x.reshape(B, A, 5 + C, H, W)
    grid_x = torch.arange(W, dtype=torch.float32, device=dev)
    grid_y = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    an = torch.tensor(anchors, dtype=torch.float32, device=dev)
    an_w, an_h = an[0::2, None, None], an[1::2, None, None]
    sig = torch.sigmoid
    shift = (scale_x_y - 1) * 0.5
    bx = _div(grid_x + sig(x[:, :, 0]) * scale_x_y - shift, W)
    by = _div(grid_y + sig(x[:, :, 1]) * scale_x_y - shift, H)
    bw = _div(torch.exp(x[:, :, 2]) * an_w, downsample_ratio * W)
    bh = _div(torch.exp(x[:, :, 3]) * an_h, downsample_ratio * H)
    conf = sig(x[:, :, 4])
    probs = sig(x[:, :, 5:]) * conf[:, :, None]
    size = torch.as_tensor(img_size, device=dev).float()
    img_h, img_w = size[:, 0, None, None, None], size[:, 1, None, None, None]
    x1 = (bx - bw * 0.5) * img_w
    y1 = (by - bh * 0.5) * img_h
    x2 = (bx + bw * 0.5) * img_w
    y2 = (by + bh * 0.5) * img_h
    if clip_bbox:
        x1 = torch.minimum(x1.clamp(min=0.0), img_w - 1)
        y1 = torch.minimum(y1.clamp(min=0.0), img_h - 1)
        x2 = torch.minimum(x2.clamp(min=0.0), img_w - 1)
        y2 = torch.minimum(y2.clamp(min=0.0), img_h - 1)
    mask = (conf > conf_thresh)[..., None]
    boxes = torch.where(mask, torch.stack([x1, y1, x2, y2], -1), 0.0)
    probs = torch.where(mask, probs.movedim(2, -1), 0.0)
    return (boxes.permute(0, 2, 3, 1, 4).reshape(B, H * W * A, 4),
            probs.permute(0, 2, 3, 1, 4).reshape(B, H * W * A, C))


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def roi_align(x, rois, roi_batch_id, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=False):
    """roi_align_op: bilinear-sampled average pooling per RoI. x [B, C, H,
    W], rois [R, 4] (x1, y1, x2, y2 in input coordinates), roi_batch_id
    [R] -> [R, C, ph, pw]. sr x sr samples a bin (sr = sampling_ratio,
    or 2 where it is not positive). Every RoI's samples come from one
    indexed read of x; the sample grid and the bilinear weights are
    float32, as in the JAX op (its RoIs are cast to float32)."""
    B, C, H, W = x.shape
    dev, dt = x.device, x.dtype
    ph, pw = _pair(output_size)
    offset = 0.5 if aligned else 0.0
    sr = sampling_ratio if sampling_ratio > 0 else 2
    x1, y1, x2, y2 = (rois.float() * spatial_scale - offset).unbind(1)
    least = 1e-6 if aligned else 1.0
    bin_w = _div((x2 - x1).clamp(min=least), pw)
    bin_h = _div((y2 - y1).clamp(min=least), ph)
    f64 = dict(dtype=torch.float64, device=dev)
    frac = _div(torch.arange(sr, **f64) + 0.5, sr)
    iy = (torch.arange(ph, **f64)[:, None] + frac).float()
    ix = (torch.arange(pw, **f64)[:, None] + frac).float()
    sy = y1[:, None, None] + iy * bin_h[:, None, None]
    sx = x1[:, None, None] + ix * bin_w[:, None, None]
    R = rois.shape[0]
    yy = sy[:, :, None, :, None].expand(R, ph, pw, sr, sr).reshape(R, -1)
    xx = sx[:, None, :, None, :].expand(R, ph, pw, sr, sr).reshape(R, -1)
    y0 = yy.floor().clamp(0, H - 1)
    x0 = xx.floor().clamp(0, W - 1)
    ly = (yy - y0).clamp(0.0, 1.0)
    lx = (xx - x0).clamp(0.0, 1.0)
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = (y0i + 1).clamp(max=H - 1), (x0i + 1).clamp(max=W - 1)
    base = torch.as_tensor(roi_batch_id, device=dev).long()[:, None] * \
        (H * W)
    flat = x.permute(1, 0, 2, 3).reshape(C, B * H * W)
    hy, hx = (1 - ly).to(dt), (1 - lx).to(dt)
    ly, lx = ly.to(dt), lx.to(dt)

    def at(yi, xi):        # backward: index_add_ (no sort of the indices)
        return flat.index_select(1, (base + yi * W + xi).reshape(-1)
                                 ).reshape(C, R, -1)

    val = (at(y0i, x0i) * hy * hx + at(y0i, x1i) * hy * lx
           + at(y1i, x0i) * ly * hx + at(y1i, x1i) * ly * lx)
    val = val.reshape(C, R, ph, pw, sr * sr).mean(-1)
    return val.permute(1, 0, 2, 3).contiguous()


def _log2_table(n, dev):
    """floor(log2(m)) for m in [0, n] (0 for m <= 1)."""
    return torch.tensor([max(m, 1).bit_length() - 1 for m in range(n + 1)],
                        device=dev)


def _bin_ranges(lo_f, hi_f, extent, bins, size):
    """Each bin's [first, last] pixel of roi_pool's quantized bins: a
    pixel p in [lo, hi] (rounded RoI bounds) falls in bin
    clip(floor((p - lo) / (extent / bins)), 0, bins - 1), as in the JAX
    op; the bins are contiguous. Returns (first, last, empty) [R, bins]."""
    p = torch.arange(size, dtype=torch.float32, device=lo_f.device)
    b = torch.floor((p[None, :] - lo_f[:, None]) /
                    _div(extent, bins)[:, None]).clamp(0, bins - 1)
    inside = (p[None, :] >= lo_f[:, None]) & (p[None, :] <= hi_f[:, None])
    b = torch.where(inside, b, -1.0)
    member = b[:, None, :] == torch.arange(bins, device=lo_f.device,
                                           dtype=b.dtype)[None, :, None]
    empty = ~member.any(-1)
    first = member.int().argmax(-1)
    last = size - 1 - member.flip(-1).int().argmax(-1)
    return first, last, empty


def roi_pool(x, rois, roi_batch_id, output_size, spatial_scale=1.0):
    """roi_pool_op: max over each quantized RoI bin (0 for an empty bin).
    The bins are rectangles of pixels, so each max is read from a 2-D
    sparse table of x (the max over every 2^a x 2^b window, built once)
    at the bin's four corners: no [R, C, ph, pw, H, W] mask."""
    B, C, H, W = x.shape
    dev = x.device
    ph, pw = _pair(output_size)
    r = torch.round(rois.float() * spatial_scale)
    rw = (r[:, 2] - r[:, 0] + 1).clamp(min=1.0)
    rh = (r[:, 3] - r[:, 1] + 1).clamp(min=1.0)
    y_lo, y_hi, y_empty = _bin_ranges(r[:, 1], r[:, 3], rh, ph, H)
    x_lo, x_hi, x_empty = _bin_ranges(r[:, 0], r[:, 2], rw, pw, W)
    lh, lw = _log2_table(H, dev), _log2_table(W, dev)
    n_a, n_b = int(lh[H]) + 1, int(lw[W]) + 1
    grid, offs, total = [], [], 0
    row = [x]
    for b in range(1, n_b):
        s = 1 << (b - 1)
        row.append(torch.maximum(row[-1][..., :-s], row[-1][..., s:]))
    for a in range(n_a):
        if a:
            s = 1 << (a - 1)
            row = [torch.maximum(t[..., :-s, :], t[..., s:, :]) for t in row]
        for t in row:
            offs.append(total)
            total += t.shape[2] * t.shape[3]
            grid.append(t.permute(0, 2, 3, 1).reshape(B, -1, C))
    flat = torch.cat(grid, 1).reshape(-1, C)
    offs = torch.tensor(offs, device=dev).reshape(n_a, n_b)
    widths = W - 2 ** torch.arange(n_b, device=dev) + 1
    y_lo, y_hi = y_lo[:, :, None], y_hi[:, :, None]      # [R, ph, 1]
    x_lo, x_hi = x_lo[:, None, :], x_hi[:, None, :]      # [R, 1, pw]
    empty = y_empty[:, :, None] | x_empty[:, None, :]
    a = lh[(y_hi - y_lo + 1).clamp(min=0)]
    b = lw[(x_hi - x_lo + 1).clamp(min=0)]
    ya, yb = y_lo, (y_hi - 2 ** a + 1).clamp(min=0)
    xa, xb = x_lo, (x_hi - 2 ** b + 1).clamp(min=0)
    bid = torch.as_tensor(roi_batch_id, device=dev).long()
    base = bid[:, None, None] * total + offs[a, b]
    wb = widths[b]
    idx = torch.stack([base + ya * wb + xa, base + yb * wb + xa,
                       base + ya * wb + xb, base + yb * wb + xb], -1)
    idx = torch.where(empty[..., None], 0, idx)
    out = flat.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + (C,)).amax(3)                        # [R, ph, pw, C]
    out = torch.where(empty[..., None], -float("inf"), out)
    out = torch.where(torch.isfinite(out), out, 0.0)
    return out.permute(0, 3, 1, 2).contiguous()


def bipartite_match(dist):
    """bipartite_match_op.cc greedy max matching, in float32 as in the
    JAX op: dist [..., N, M] -> (match_indices [..., M] int32, -1
    unmatched; match_dist [..., M] float32). min(N, M) rounds, each
    matching the largest remaining positive entry (first in row-major
    order on ties) and clearing its row and column."""
    N, M = dist.shape[-2:]
    lead = dist.shape[:-2]
    d = dist.reshape(-1, N, M).float().clone()
    nb = d.shape[0]
    dev = d.device
    rows = torch.arange(nb, device=dev)
    idx = torch.full((nb, M), -1, dtype=torch.int32, device=dev)
    md = torch.zeros((nb, M), device=dev)
    ar_n, ar_m = torch.arange(N, device=dev), torch.arange(M, device=dev)
    for _ in range(min(N, M)):
        flat = d.reshape(nb, -1).argmax(1)
        i, j = flat // M, flat % M
        v = d[rows, i, j]
        ok = v > 0
        idx[rows, j] = torch.where(ok, i.int(), idx[rows, j])
        md[rows, j] = torch.where(ok, v, md[rows, j])
        clear = ((ar_n[None, :] == i[:, None])[:, :, None]
                 | (ar_m[None, :] == j[:, None])[:, None, :]) & \
            ok[:, None, None]
        d.masked_fill_(clear, -1.0)
    return idx.reshape(lead + (M,)), md.reshape(lead + (M,))


def density_prior_box(input_hw, image_hw, fixed_sizes, fixed_ratios,
                      densities, variances=(0.1, 0.1, 0.2, 0.2),
                      steps=(0.0, 0.0), offset=0.5, clip=False,
                      device=None):
    """density_prior_box_op.h: dense-grid SSD priors. Returns (boxes [H,
    W, P, 4], variances [H, W, P, 4])."""
    dev = resolve_device(device)
    H, W = input_hw
    img_h, img_w = image_hw
    step_h = steps[0] or img_h / H
    step_w = steps[1] or img_w / W
    whs, shifts = [], []
    for size, density in zip(fixed_sizes, densities):
        for ratio in fixed_ratios:
            w, h = size * np.sqrt(ratio), size / np.sqrt(ratio)
            step = 1.0 / density
            for di in range(density):
                for dj in range(density):
                    whs.append((w, h))
                    shifts.append(((dj + 0.5) * step - 0.5,
                                   (di + 0.5) * step - 0.5))
    wh = torch.from_numpy(np.asarray(whs, np.float32)).to(dev) * 0.5
    shifts = torch.from_numpy(np.asarray(shifts, np.float32)).to(dev)
    cxg, cyg = _centers(H, W, step_h, step_w, offset, dev)
    cxg = cxg + shifts[:, 0] * step_w
    cyg = cyg + shifts[:, 1] * step_h
    boxes = torch.stack([_div(cxg - wh[:, 0], img_w),
                         _div(cyg - wh[:, 1], img_h),
                         _div(cxg + wh[:, 0], img_w),
                         _div(cyg + wh[:, 1], img_h)], -1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes, _variances(variances, H, W, len(whs), dev)
