"""Detection ops over plain tensors (the port of
``mxnet_tpu/ops/detection.py``): box IoU, NMS and the box codec, anchor
matching, the SSD target and detection heads, ROIAlign (plain and
rotated), the RPN proposal layer and deformable PS-ROI pooling.

The reference computes all of them with ``jnp``/``lax`` outside any
Pallas kernel, ``vmap``-ing over the batch or the ROIs; here the batch
(the ROIs) is one dimension of each tensor. Its sequential phases
(``lax.fori_loop`` in ``box_nms`` and ``bipartite_matching``) become a
loop over the step count on the whole batch at once, with no host sync
in the loop body: on the card each step is a few kernel launches, and
their number decides the loop's time. Tie order follows the reference:
``box_nms`` sorts stably (``jnp.argsort``), ``bipartite_matching``
takes ``argmin``'s first minimum, and ``proposal``'s top-k keeps the
lower index first among equal scores (``lax.top_k``), as a stable
descending sort does.

Box formats: ``corner`` = (xmin, ymin, xmax, ymax); ``center`` =
(cx, cy, w, h).
"""
from __future__ import annotations

import math

import numpy as onp
import torch

__all__ = ["corner_to_center", "center_to_corner", "box_iou", "box_encode",
           "box_decode", "box_nms", "bipartite_matching", "multibox_target",
           "multibox_detection", "roi_align", "rroi_align", "proposal",
           "deformable_psroi_pooling"]


def corner_to_center(b):
    xmin, ymin, xmax, ymax = b.split(1, dim=-1)
    return torch.cat([(xmin + xmax) / 2, (ymin + ymax) / 2,
                      xmax - xmin, ymax - ymin], -1)


def center_to_corner(b):
    cx, cy, w, h = b.split(1, dim=-1)
    return torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _area(b):
    return (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)


def box_iou(lhs, rhs, fmt="corner"):
    """Pairwise IoU: lhs (..., N, 4), rhs (..., M, 4) -> (..., N, M)."""
    if fmt == "center":
        lhs, rhs = center_to_corner(lhs), center_to_corner(rhs)
    lo = [torch.maximum(lhs[..., :, None, k], rhs[..., None, :, k])
          for k in (0, 1)]
    hi = [torch.minimum(lhs[..., :, None, k], rhs[..., None, :, k])
          for k in (2, 3)]
    inter = (hi[0] - lo[0]).clamp(min=0) * (hi[1] - lo[1]).clamp(min=0)
    del lo, hi
    union = _area(lhs)[..., :, None] + _area(rhs)[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


#: elements of the IoU block ``box_nms`` computes at once
_NMS_BLOCK = 1 << 25


def _vec(v, like):
    return torch.as_tensor(v, dtype=like.dtype).to(like.device)


def box_encode(samples, matches, anchors, refs, means, stds):
    """SSD regression targets: samples (B, N) in {0 ignore, -1
    negative, 1 positive}, matches (B, N) the GT index of each anchor,
    anchors (B, N, 4) and refs (B, M, 4) corner boxes. Returns
    (targets (B, N, 4), masks (B, N, 4))."""
    idx = matches.to(torch.int64).clamp(min=0)[..., None]
    ref = refs.gather(1, idx.expand(idx.shape[:-1] + (4,)))
    a_c = corner_to_center(anchors)
    g_c = corner_to_center(ref)
    t_xy = (g_c[..., :2] - a_c[..., :2]) / a_c[..., 2:].clamp(min=1e-12)
    t_wh = torch.log(g_c[..., 2:].clamp(min=1e-12)
                     / a_c[..., 2:].clamp(min=1e-12))
    t = (torch.cat([t_xy, t_wh], -1) - _vec(means, a_c)) / _vec(stds, a_c)
    mask = (samples > 0.5)[..., None].expand(t.shape).to(t.dtype)
    return t * mask, mask


def box_decode(data, anchors, stds=(1.0, 1.0, 1.0, 1.0),
               means=(0.0, 0.0, 0.0, 0.0), clip=-1.0, fmt="corner"):
    """Invert ``box_encode``: data (B, N, 4) deltas, anchors (1, N, 4)."""
    a = anchors if fmt == "center" else corner_to_center(anchors)
    d = data * _vec(stds, data) + _vec(means, data)
    xy = d[..., :2] * a[..., 2:] + a[..., :2]
    wh = torch.exp(d[..., 2:]) * a[..., 2:]
    out = center_to_corner(torch.cat([xy, wh], -1))
    if clip > 0:
        out = out.clamp(0.0, clip)
    return out


def _take_rows(x, idx):
    """``x`` (B, N, ...) with each batch's rows in the order ``idx``
    (B, N)."""
    shape = idx.shape + x.shape[2:]
    i = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return x.gather(1, i)


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner"):
    """Greedy NMS over ``data`` (..., N, K): rows scoring at most
    ``valid_thresh`` are invalid; the valid rows are sorted by score
    (stably, descending); a row is suppressed when its IoU with a kept
    row earlier in that order (of its class, or of any class with
    ``force_suppress``) exceeds ``overlap_thresh``. Suppressed and
    invalid rows are all -1; the kept rows come first, in score order.
    The output has the input's shape."""
    shape = data.shape
    batch = data.reshape((-1,) + tuple(shape[-2:]))
    n = batch.shape[1]
    dev = batch.device
    score = batch[:, :, score_index]
    boxes = batch[:, :, coord_start:coord_start + 4]
    if in_format == "center":
        boxes = center_to_corner(boxes)
    valid = score > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid = valid & (batch[:, :, id_index] != background_id)
    key = -torch.where(valid, score, -math.inf)
    order = torch.argsort(key, dim=1, stable=True)
    sboxes = _take_rows(boxes, order)
    keep = valid.gather(1, order)
    ar = torch.arange(n, device=dev)
    # only the first m rows in score order can be kept (topk), and a row
    # that cannot be kept suppresses none: the rest of the greedy pass is
    # the m x m block's
    m = min(n, topk) if topk > 0 else n
    keep = keep & (ar < m)
    # over[b, i, j]: row j (later in score order than i) overlaps row i
    # past the threshold, in i's class unless force_suppress
    cls = batch[:, :, id_index].gather(1, order[:, :m]) \
        if id_index >= 0 and not force_suppress else None
    over = torch.empty((batch.shape[0], m, m), dtype=torch.bool, device=dev)
    step = max(1, _NMS_BLOCK // max(1, batch.shape[0] * m))
    for r0 in range(0, m, step):
        r1 = min(m, r0 + step)
        blk = (box_iou(sboxes[:, r0:r1], sboxes[:, :m]) > overlap_thresh) \
            & (ar[None, :m] > ar[r0:r1, None])
        if cls is not None:
            blk &= cls[:, r0:r1, None] == cls[:, None, :]
        over[:, r0:r1] = blk
    head = keep[:, :m]
    for i in range(m):
        head = head & ~(over[:, i] & head[:, i:i + 1])
    keep = torch.cat([head, keep[:, m:]], 1)
    sorted_rows = _take_rows(batch, order)
    sorted_rows = torch.where(keep[..., None], sorted_rows, -1.0)
    rank = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    return _take_rows(sorted_rows, rank).reshape(shape)


def bipartite_matching(score, threshold, is_ascend=False, topk=-1):
    """Greedy bipartite matching of ``score`` (..., N, M): repeatedly
    take the best remaining pair (the first in row-major order among
    equals) and match it if it passes ``threshold``. Returns
    (row_match (..., N), col_match (..., M)) of int32, -1 where
    unmatched."""
    shape = score.shape
    s = score.reshape((-1,) + tuple(shape[-2:]))
    B, n, m = s.shape
    dev = s.device
    iters = min(n, m) if topk <= 0 else min(topk, min(n, m))
    key = s * (1.0 if is_ascend else -1.0)
    flat_s = s.reshape(B, n * m)
    row = torch.full((B, n), -1, dtype=torch.int32, device=dev)
    col = torch.full((B, m), -1, dtype=torch.int32, device=dev)
    ar_n = torch.arange(n, device=dev)
    ar_m = torch.arange(m, device=dev)
    for _ in range(iters):
        idx = key.reshape(B, n * m).argmin(1)
        i, j = idx // m, idx % m
        v = flat_s.gather(1, idx[:, None])[:, 0]
        ok = (v <= threshold) if is_ascend else (v >= threshold)
        hit_r = (ar_n[None, :] == i[:, None])
        hit_c = (ar_m[None, :] == j[:, None])
        row = torch.where(hit_r & ok[:, None], j[:, None].to(torch.int32),
                          row)
        col = torch.where(hit_c & ok[:, None], i[:, None].to(torch.int32),
                          col)
        pair = hit_r[:, :, None] & hit_c[:, None, :]
        line = (hit_r[:, :, None] | hit_c[:, None, :]) & ok[:, None, None]
        key = key.masked_fill(line | pair, math.inf)
    return row.reshape(shape[:-1]), col.reshape(shape[:-2] + (m,))


def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets: anchor (1, A, 4) corner; label (B, N, 5)
    rows [cls, xmin, ymin, xmax, ymax] padded with cls < 0; cls_pred
    (B, C, A) (hard negative mining when negative_mining_ratio > 0).
    Returns (box_target (B, A*4), box_mask (B, A*4), cls_target (B, A))."""
    a = anchor[0]
    B = label.shape[0]
    A = a.shape[0]
    gt_valid = label[:, :, 0] >= 0
    gt_boxes = label[:, :, 1:5]
    iou = box_iou(a[None].expand(B, A, 4), gt_boxes)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    matches, _ = bipartite_matching(iou, 1e-12)
    best_iou = iou.amax(dim=2)
    best_gt = iou.argmax(dim=2)
    stage2 = (matches < 0) & (best_iou >= overlap_threshold)
    matches = torch.where(stage2, best_gt.to(matches.dtype), matches)
    positive = matches >= 0
    samples = torch.where(positive, 1.0, -1.0).to(label.dtype)
    if negative_mining_ratio > 0:
        max_pos = positive.sum(1, dtype=torch.int32)
        quota = (torch.tensor(negative_mining_ratio, dtype=torch.float32)
                 * max_pos).to(torch.int32).clamp(
                     min=int(minimum_negative_samples))
        neg_ok = ~positive & (best_iou < negative_mining_thresh)
        hardness = torch.where(neg_ok, cls_pred.amax(dim=1), -math.inf)
        order = torch.argsort(-hardness, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=order.device).expand(B, A))
        chosen = neg_ok & (rank < quota[:, None])
        samples = torch.where(positive, 1.0,
                              torch.where(chosen, -1.0, 0.0)).to(label.dtype)
    targets, masks = box_encode(samples, matches, a[None].expand(B, A, 4),
                                gt_boxes, (0.0, 0.0, 0.0, 0.0), variances)
    gt_cls = label[:, :, 0].gather(1, matches.to(torch.int64).clamp(min=0)) \
        + 1.0
    cls_t = torch.where(positive, gt_cls,
                        torch.where(samples < -0.5, 0.0,
                                    float(ignore_label)))
    return targets.reshape(B, -1), masks.reshape(B, -1), cls_t


def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """SSD inference, the box decode and a per-class NMS: cls_prob
    (B, C, A), loc_pred (B, A*4), anchor (1, A, 4) corner. Returns
    (B, A, 6) rows [class_id, score, xmin, ymin, xmax, ymax], suppressed
    rows -1."""
    B, C, A = cls_prob.shape
    boxes = box_decode(loc_pred.reshape(B, A, 4), corner_to_center(anchor),
                       stds=variances, fmt="center",
                       clip=1.0 if clip else -1.0)
    has_bg = 0 <= background_id < C
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], 1) if has_bg \
        else cls_prob
    cls_id = fg.argmax(dim=1).to(cls_prob.dtype)
    if has_bg:
        cls_id = torch.where(cls_id >= background_id, cls_id + 1, cls_id)
    score = cls_prob.gather(1, cls_id.to(torch.int64)[:, None])[:, 0]
    keep = score > threshold
    fg_id = torch.where(cls_id > background_id, cls_id - 1, cls_id) \
        if has_bg else cls_id
    out_id = torch.where(keep, fg_id, -1.0)
    out = torch.cat([out_id[..., None], score[..., None], boxes], -1)
    out = torch.where(keep[..., None], out, -1.0)
    return box_nms(out, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   background_id=-1, force_suppress=force_suppress)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _gather_pixels(data, bidx, y, x):
    """``data[bidx, :, y, x]`` for integer tensors ``y``/``x`` of shape
    (R, ...) and ``bidx`` (R,): (R, ..., C)."""
    B, C, H, W = data.shape
    flat = data.permute(0, 2, 3, 1).reshape(B * H * W, C)
    b = bidx.reshape((-1,) + (1,) * (y.dim() - 1))
    return flat[(b * H + y) * W + x]


def roi_align(data, rois, pooled_size, spatial_scale=1.0, sample_ratio=-1,
              position_sensitive=False, aligned=False):
    """ROIAlign (average, bilinear samples): data (B, C, H, W), rois
    (N, 5) rows [batch_idx, x1, y1, x2, y2]. Returns (N, C, ph, pw), or
    (N, C / (ph pw), ph, pw) when position-sensitive. ``sample_ratio``
    <= 0 takes a 2 x 2 grid a bin, as the reference does here."""
    ph, pw = _pair(pooled_size)
    sr = int(sample_ratio) if sample_ratio and sample_ratio > 0 else 2
    _, C, H, W = data.shape
    dev, dt = data.device, rois.dtype
    bidx = rois[:, 0].to(torch.int64)
    off = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (rois[:, k] * spatial_scale - off for k in (1, 2, 3, 4))
    rw = x2 - x1 if aligned else (x2 - x1).clamp(min=1.0)
    rh = y2 - y1 if aligned else (y2 - y1).clamp(min=1.0)
    bw, bh = rw / pw, rh / ph
    i_s = (torch.arange(sr, device=dev, dtype=dt) + 0.5) / sr
    by = y1[:, None, None] + (torch.arange(ph, device=dev, dtype=dt)[:, None]
                              + i_s[None, :])[None] * bh[:, None, None]
    bx = x1[:, None, None] + (torch.arange(pw, device=dev, dtype=dt)[:, None]
                              + i_s[None, :])[None] * bw[:, None, None]
    y = by.reshape(-1, ph * sr).clamp(0.0, H - 1.0)
    x = bx.reshape(-1, pw * sr).clamp(0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1i = (y0 + 1).clamp(max=H - 1)
    x1i = (x0 + 1).clamp(max=W - 1)
    wy = (y - y0)[:, :, None, None]
    wx = (x - x0)[:, None, :, None]

    def at(yy, xx):
        return _gather_pixels(data, bidx, yy[:, :, None], xx[:, None, :])

    top = at(y0, x0) * (1 - wx) + at(y0, x1i) * wx
    bot = at(y1i, x0) * (1 - wx) + at(y1i, x1i) * wx
    smp = top * (1 - wy) + bot * wy                   # (N, Y, X, C)
    smp = smp.permute(0, 3, 1, 2).reshape(-1, C, ph, sr, pw, sr)
    pooled = smp.mean(dim=(3, 5))                      # (N, C, ph, pw)
    if position_sensitive:
        c = C // (ph * pw)
        pooled = pooled.reshape(-1, c, ph, pw, ph, pw)
        ih = torch.arange(ph, device=dev)[:, None]
        iw = torch.arange(pw, device=dev)[None, :]
        pooled = pooled[:, :, ih, iw, ih, iw]
    return pooled


def rroi_align(data, rois, pooled_size, spatial_scale=1.0,
               sampling_ratio=-1):
    """Rotated ROIAlign: rois (N, 6) [batch_idx, cx, cy, w, h,
    theta_degrees]; each bin's sample grid lives in the ROI's frame,
    rotated by theta around its centre. Samples past the one-pixel
    apron read 0; those in it clamp to the border."""
    ph, pw = _pair(pooled_size)
    sr = int(sampling_ratio) if sampling_ratio and sampling_ratio > 0 \
        else 2
    _, C, H, W = data.shape
    dev, dt = data.device, rois.dtype
    bidx = rois[:, 0].to(torch.int64)
    cx = rois[:, 1] * spatial_scale
    cy = rois[:, 2] * spatial_scale
    rw = (rois[:, 3] * spatial_scale).clamp(min=1.0)
    rh = (rois[:, 4] * spatial_scale).clamp(min=1.0)
    theta = rois[:, 5] * (math.pi / 180.0)
    bh, bw = rh / ph, rw / pw
    ar_s = torch.arange(sr, device=dev, dtype=dt)[None, None, :] + 0.5
    yy = (-rh[:, None, None] / 2.0
          + torch.arange(ph, device=dev, dtype=dt)[None, :, None]
          * bh[:, None, None]
          + ar_s * bh[:, None, None] / sr).reshape(-1, ph * sr)
    xx = (-rw[:, None, None] / 2.0
          + torch.arange(pw, device=dev, dtype=dt)[None, :, None]
          * bw[:, None, None]
          + ar_s * bw[:, None, None] / sr).reshape(-1, pw * sr)
    ct = torch.cos(theta)[:, None, None]
    st = torch.sin(theta)[:, None, None]
    xs = xx[:, None, :] * ct + yy[:, :, None] * st + cx[:, None, None]
    ys = yy[:, :, None] * ct - xx[:, None, :] * st + cy[:, None, None]
    inside = (ys >= -1.0) & (ys <= H) & (xs >= -1.0) & (xs <= W)
    y = ys.clamp(0.0, H - 1.0)
    x = xs.clamp(0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = (y0 + 1).clamp(max=H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    smp = (_gather_pixels(data, bidx, y0, x0) * (1 - wy) * (1 - wx)
           + _gather_pixels(data, bidx, y0, x1) * (1 - wy) * wx
           + _gather_pixels(data, bidx, y1, x0) * wy * (1 - wx)
           + _gather_pixels(data, bidx, y1, x1) * wy * wx)
    smp = torch.where(inside[..., None], smp, 0.0)     # (N, Y, X, C)
    smp = smp.permute(0, 3, 1, 2).reshape(-1, C, ph, sr, pw, sr)
    return smp.mean(dim=(3, 5))


def _rpn_anchors(h, w, feature_stride, scales, ratios, device):
    """The RPN's base anchors shifted over the feature grid: (h w A, 4)
    corner boxes in image coordinates, and A."""
    base = feature_stride - 1.0
    cx = cy = base / 2.0
    anchors = []
    for r in ratios:
        size_r = feature_stride * feature_stride / r
        # the reference takes the root in float32
        ws = round(float(onp.sqrt(onp.float32(size_r))))
        hs = round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - (wss - 1) / 2.0, cy - (hss - 1) / 2.0,
                            cx + (wss - 1) / 2.0, cy + (hss - 1) / 2.0])
    anc = torch.tensor(anchors, dtype=torch.float32, device=device)
    sx = torch.arange(w, device=device) * feature_stride
    sy = torch.arange(h, device=device) * feature_stride
    shift = torch.stack([sx[None, :].expand(h, w).reshape(-1),
                         sy[:, None].expand(h, w).reshape(-1)], -1)
    shift4 = torch.cat([shift, shift], -1)
    return (anc[None] + shift4[:, None]).reshape(-1, 4), len(anchors)


def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
             feature_stride=16):
    """RPN proposals: decode the anchor deltas, clip to the image, drop
    boxes under ``rpn_min_size``, keep the top ``rpn_pre_nms_top_n`` by
    objectness (the lower index first among equal scores), NMS at
    ``threshold``, and emit ``rpn_post_nms_top_n`` rows [batch_idx, x1,
    y1, x2, y2] an image. cls_prob (B, 2A, h, w) with the objectness in
    its second A channels, bbox_pred (B, 4A, h, w), im_info (B, 3)
    [height, width, scale]."""
    B, _, h, w = cls_prob.shape
    anchors, A = _rpn_anchors(h, w, feature_stride,
                              [float(s) for s in scales],
                              [float(r) for r in ratios], cls_prob.device)
    N = anchors.shape[0]
    scores = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(B, -1)
    deltas = bbox_pred.permute(0, 2, 3, 1).reshape(B, -1, 4)
    ih, iw = im_info[:, 0:1], im_info[:, 1:2]
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + 0.5 * (aw - 1.0)
    acy = anchors[:, 1] + 0.5 * (ah - 1.0)
    cx = deltas[..., 0] * aw + acx
    cy = deltas[..., 1] * ah + acy
    bw = torch.exp(deltas[..., 2]) * aw
    bh = torch.exp(deltas[..., 3]) * ah
    zero = torch.zeros((), dtype=cx.dtype, device=cx.device)
    x1 = torch.minimum(torch.maximum(cx - 0.5 * (bw - 1.0), zero), iw - 1.0)
    y1 = torch.minimum(torch.maximum(cy - 0.5 * (bh - 1.0), zero), ih - 1.0)
    x2 = torch.minimum(torch.maximum(cx + 0.5 * (bw - 1.0), zero), iw - 1.0)
    y2 = torch.minimum(torch.maximum(cy + 0.5 * (bh - 1.0), zero), ih - 1.0)
    min_size = rpn_min_size * im_info[:, 2:3]
    valid = ((x2 - x1 + 1.0) >= min_size) & ((y2 - y1 + 1.0) >= min_size)
    scores_v = torch.where(valid, scores, -math.inf)
    pre = min(rpn_pre_nms_top_n, N)
    top, order = torch.sort(scores_v, dim=1, descending=True, stable=True)
    top, order = top[:, :pre], order[:, :pre]
    rows = torch.stack([torch.zeros_like(top), top,
                        x1.gather(1, order), y1.gather(1, order),
                        x2.gather(1, order), y2.gather(1, order)], -1)
    kept = box_nms(rows, overlap_thresh=threshold, valid_thresh=-math.inf,
                   topk=rpn_post_nms_top_n, coord_start=2, score_index=1)
    boxes = kept[:, :rpn_post_nms_top_n, 2:6]
    bidx = torch.arange(B, dtype=boxes.dtype, device=boxes.device)
    bidx = bidx[:, None, None].expand(B, rpn_post_nms_top_n, 1)
    return torch.cat([bidx, boxes], -1).reshape(-1, 5)


def deformable_psroi_pooling(data, rois, trans, spatial_scale, output_dim,
                             group_size, pooled_size, part_size=0,
                             sample_per_part=1, trans_std=0.0,
                             no_trans=False):
    """Deformable position-sensitive ROI pooling: data (B, C, H, W) with
    C = output_dim * group_size^2, rois (N, 5) [batch, x1, y1, x2, y2],
    trans (N, 2 num_classes, P, P) the learned offsets of each part
    (unused with ``no_trans``). Returns (N, output_dim, pooled,
    pooled); a bin with no sample inside reads 0."""
    P = int(part_size) or int(pooled_size)
    ps, gs, od = int(pooled_size), int(group_size), int(output_dim)
    spp = int(sample_per_part)
    B, C, H, W = data.shape
    dev, dt = data.device, data.dtype
    num_classes = 1 if no_trans else trans.shape[1] // 2
    ch_each = max(od // num_classes, 1)
    bin_i = torch.arange(ps, device=dev)
    gh = ((bin_i * gs) // ps).clamp(0, gs - 1)
    part = ((bin_i * P) // ps).clamp(0, P - 1)
    cls = (torch.arange(od, device=dev) // ch_each).clamp(0, num_classes - 1)
    c_map = (torch.arange(od, device=dev)[:, None, None] * gs
             + gh[None, :, None]) * gs + gh[None, None, :]
    bidx = rois[:, 0].to(torch.int64)
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = (x2 - x1).clamp(min=0.1)[:, None, None, None]
    rh = (y2 - y1).clamp(min=0.1)[:, None, None, None]
    bh, bw = rh / ps, rw / ps
    sub_h, sub_w = bh / spp, bw / spp
    if no_trans:
        tx = torch.zeros((rois.shape[0], od, ps, ps), dtype=dt, device=dev)
        ty = tx
    else:
        t = trans[:, :, part][:, :, :, part] * trans_std  # (N, 2K, ps, ps)
        tx, ty = t[:, cls * 2], t[:, cls * 2 + 1]
    binf = bin_i.to(dt)
    wstart = binf[None, None, None, :] * bw + x1[:, None, None, None] \
        + tx * rw
    hstart = binf[None, None, :, None] * bh + y1[:, None, None, None] \
        + ty * rh
    base = (bidx[:, None, None, None] * C + c_map[None]) * H
    flat = data.reshape(-1)
    acc = cnt = None
    for ih in range(spp):
        for iw in range(spp):
            wv = wstart + iw * sub_w
            hv = hstart + ih * sub_h
            ok = (wv >= -0.5) & (wv <= W - 0.5) & (hv >= -0.5) & \
                (hv <= H - 0.5)
            wc = wv.clamp(0.0, W - 1.0)
            hc = hv.clamp(0.0, H - 1.0)
            x0 = torch.floor(wc).to(torch.int64)
            y0 = torch.floor(hc).to(torch.int64)
            x1i = (x0 + 1).clamp(max=W - 1)
            y1i = (y0 + 1).clamp(max=H - 1)
            fx = wc - x0
            fy = hc - y0
            v = (flat[(base + y0) * W + x0] * (1 - fy) * (1 - fx)
                 + flat[(base + y0) * W + x1i] * (1 - fy) * fx
                 + flat[(base + y1i) * W + x0] * fy * (1 - fx)
                 + flat[(base + y1i) * W + x1i] * fy * fx)
            v = torch.where(ok, v, 0.0)
            acc = v if acc is None else acc + v
            okf = ok.to(dt)
            cnt = okf if cnt is None else cnt + okf
    return torch.where(cnt > 0, acc / cnt.clamp(min=1.0), 0.0)
