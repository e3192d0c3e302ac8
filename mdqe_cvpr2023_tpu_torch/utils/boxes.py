"""Box conversions and the IoU family (counterpart of
``mdqe_cvpr2023_tpu/utils/boxes.py``). Boxes are xyxy unless named otherwise;
the pairwise functions take any leading batch axes."""
from __future__ import annotations

import torch

from . import tracing


def box_cxcywh_to_xyxy(x):
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h],
                       dim=-1)


def box_xyxy_to_cxcywh(x):
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(boxes):
    return (boxes[..., 2:] - boxes[..., :2]).prod(-1)


def box_iou(boxes1, boxes2):
    """Pairwise IoU of (..., N, 4) and (..., M, 4) -> iou, union (..., N, M)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0.0).prod(-1)
    union = (area1[..., :, None] + area2[..., None, :] - inter).clamp(min=1e-3)
    return inter / union, union


def generalized_box_iou(boxes1, boxes2):
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    area = (rb - lt).clamp(min=0.0).prod(-1)
    return iou - (area - union) / area.clamp(min=1e-3)


def video_box_iou(boxes1, boxes2):
    """(..., N, T, 4) and (..., M, T, 4) -> iou, inter, union, each (..., N, M, T)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :, :2], boxes2[..., None, :, :, :2])
    rb = torch.minimum(boxes1[..., :, None, :, 2:], boxes2[..., None, :, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = (area1[..., :, None, :] + area2[..., None, :, :] - inter).clamp(min=1e-3)
    return inter / union, inter, union


def video_generalized_box_iou(out_bbox, tgt_bbox, valid=None):
    """(..., N, T, 4), (..., M, T, 4), valid (..., M, T) or None -> (..., N, M):
    the frame mean of the GIoU (over valid frames), 0 where boxes do not meet."""
    iou, inter, union = video_box_iou(out_bbox, tgt_bbox)
    lt = torch.minimum(out_bbox[..., :, None, :, :2], tgt_bbox[..., None, :, :, :2])
    rb = torch.maximum(out_bbox[..., :, None, :, 2:], tgt_bbox[..., None, :, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    giou = torch.where(inter > 0, iou - (area - union) / area.clamp(min=1e-3),
                       torch.zeros_like(iou))
    if valid is not None:
        giou = torch.where(valid[..., None, :, :], giou, torch.zeros_like(giou))
        return giou.sum(-1) / valid.to(giou.dtype).sum(-1).clamp(min=1.0)[..., None, :]
    return giou.mean(-1)


def masks_to_boxes(masks):
    """Tight xyxy boxes in pixel units of binary masks (..., H, W) -> (..., 4)
    fp32; zeros for empty masks."""
    H, W = masks.shape[-2], masks.shape[-1]
    any_y = masks.any(-1)                                   # (..., H)
    any_x = masks.any(-2)                                   # (..., W)
    ys = torch.arange(H, dtype=torch.float32, device=masks.device)
    xs = torch.arange(W, dtype=torch.float32, device=masks.device)
    with tracing.wait("boxes.wait", syncs=int(masks.is_cuda)):   # an upload
        big = torch.tensor(1e9, dtype=torch.float32, device=masks.device)
    y0 = torch.where(any_y, ys, big).amin(-1)
    y1 = torch.where(any_y, ys + 1.0, -big).amax(-1)
    x0 = torch.where(any_x, xs, big).amin(-1)
    x1 = torch.where(any_x, xs + 1.0, -big).amax(-1)
    box = torch.stack([x0, y0, x1, y1], -1)
    return torch.where(any_y.any(-1)[..., None], box, torch.zeros_like(box))
