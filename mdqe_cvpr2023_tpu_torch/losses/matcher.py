"""Matchers (counterpart of ``mdqe_cvpr2023_tpu/losses/matcher.py``), on the
device with no host assignment.

  - ``hungarian_match_costs`` + ``dynamic_k_matching``: the one-to-many
    dynamic-k assignment (cost = class + 2 (L1 + GIoU of the video boxes)
    + 4 (BCE + dice of the masks), gated by in-box / in-centre tests; the
    top-10-IoU-sum dynamic k; conflicts resolved; at least one query per
    ground truth).
  - ``clip_peak_match``: per-pixel ground-truth assignment on the stride-8 map
    for the query-init supervision (area-sorted sequential assignment).

Every function takes leading batch axes (videos); the JAX package's take one
video and are vmapped. Invalid ground-truth slots are masked with large costs,
and the data-dependent loops are fixed-trip Python loops over the instance
capacity N with tensor ops inside. Ties break as in JAX: stable sorts, and
first-occurrence ``argmin`` / ``argmax``.

``compute_dtype`` bfloat16 (mixed precision) runs the large (Q, THW) x
(THW, N) mask products on bf16 operands with fp32 sums (``matmul_f32``, the
JAX package's ``preferred_element_type=float32``), and every sum over THW in
fp32; float32 (the default) takes the same products in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.boxes import box_xyxy_to_cxcywh, video_generalized_box_iou

INF = 1e5
BIG = 1e9


class _MatmulF32(torch.autograd.Function):
    """bf16 a (..., M, K) @ b (..., K, N) with an fp32 result: on the card one
    bf16 tensor-core GEMM that writes fp32 (``torch.bmm(..., out_dtype=
    torch.float32)``); on the CPU, where that form is not implemented, the
    product of the fp32 upcasts (exact: a product of two bf16 values fits
    fp32's mantissa, so only the order of the fp32 sums differs). The
    gradients are those of JAX's transpose rule: the fp32 output gradient
    times the other operand upcast to fp32, cast to the operand's type."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cuda":
            lead = a.shape[:-2]
            out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                            out_dtype=torch.float32)
            return out.reshape(*lead, *out.shape[-2:])
        return torch.matmul(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def matmul_f32(a, b):
    """a (..., M, K) @ b (..., K, N) as fp32: the fp32 product of fp32
    operands, or of two bf16 operands the fp32-output product of
    ``_MatmulF32`` (``jnp.einsum(..., preferred_element_type=float32)``)."""
    if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return _MatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


def pair_products(a, b):
    """a (..., Q, P), b (..., N, P) -> (..., Q, N) fp32 sums over P: the
    criterion's and matcher's (Q, THW) x (THW, N) mask products."""
    return matmul_f32(a, b.transpose(-1, -2))


def batch_dice_cost(inputs, targets, compute_dtype=torch.float32):
    """inputs (..., Q, THW) logits, targets (..., N, THW) -> (..., Q, N) fp32;
    sigmoid and products in ``compute_dtype``, sums in fp32."""
    p = torch.sigmoid(inputs.to(compute_dtype))
    t = targets.to(compute_dtype)
    num = 2.0 * pair_products(p, t)
    den = (p.sum(-1, dtype=torch.float32)[..., :, None]
           + t.sum(-1, dtype=torch.float32)[..., None, :])
    return 1.0 - (num + 1.0) / (den + 1.0)


def batch_sigmoid_ce_cost(inputs, targets, compute_dtype=torch.float32):
    """inputs (..., Q, THW) logits, targets (..., N, THW) -> (..., Q, N) mean
    BCE: BCE(x, 1) = softplus(-x), BCE(x, 0) = softplus(x), in
    ``compute_dtype`` with fp32 sums."""
    x = inputs.to(compute_dtype)
    t = targets.to(compute_dtype)
    pos = F.softplus(-x)
    neg = F.softplus(x)
    return (pair_products(pos, t) + pair_products(neg, 1.0 - t)) / x.shape[-1]


def get_in_boxes_info(boxes, gt_boxes, expanded_strides: int = 32):
    """boxes (..., Q, T, 4) xyxy, gt_boxes (..., N, T, 4) -> (..., Q, T) bool:
    the query's centre lies in some ground-truth box, or near its centre."""
    gt_c = box_xyxy_to_cxcywh(gt_boxes)[..., None, :, :, :]     # (...,1,N,T,4)
    gt = gt_boxes[..., None, :, :, :]
    c = box_xyxy_to_cxcywh(boxes)
    ax = c[..., 0][..., :, None, :]                              # (...,Q,1,T)
    ay = c[..., 1][..., :, None, :]
    in_boxes = ((ax > gt[..., 0]) & (ax < gt[..., 2])
                & (ay > gt[..., 1]) & (ay < gt[..., 3]))
    r = 2.5 / expanded_strides
    in_centers = ((ax > gt_c[..., 0] - r) & (ax < gt_c[..., 0] + r)
                  & (ay > gt_c[..., 1] - r) & (ay < gt_c[..., 1] + r))
    return in_boxes.any(-2) | in_centers.any(-2)


def dynamic_k_matching(cost, ious, gt_valid, n_candidate_k: int = 10):
    """cost (..., Q, N), ious (..., Q, N), gt_valid (..., N) bool -> the
    assignment (..., Q, N) in {0, 1}: rows sum to at most 1, and every valid
    ground truth gets at least one query while free queries remain."""
    Q, N = cost.shape[-2:]
    valid = gt_valid[..., None, :]
    cost = torch.where(valid, cost, torch.full_like(cost, INF * 10))
    ious = torch.where(valid, ious.clamp(min=0.0), torch.zeros_like(ious))

    k = min(n_candidate_k, Q)
    topk_ious = torch.topk(ious.transpose(-1, -2), k, dim=-1).values    # (..., N, k)
    dynamic_ks = topk_ious.sum(-1).to(torch.int32).clamp(min=2)        # (..., N)

    # per ground truth, its dynamic_k lowest-cost queries (rank within a column)
    order = torch.argsort(cost, dim=-2, stable=True)
    rank = torch.argsort(order, dim=-2, stable=True)
    matching = (rank < dynamic_ks[..., None, :]) & valid
    best = torch.argmin(cost, dim=-1)                                  # (..., Q)
    keep = F.one_hot(best, N).bool()

    def resolve(m):
        """A query matched to several ground truths keeps its min-cost one."""
        over = m.sum(-1) > 1
        return torch.where(over[..., None], keep, m)

    matching = resolve(matching)
    c = cost
    for _ in range(N):
        unmatched_gt = (matching.sum(-2) == 0) & gt_valid              # (..., N)
        free_q = matching.sum(-1) == 0                                 # (..., Q)
        need = (unmatched_gt.any(-1) & free_q.any(-1))[..., None, None]
        c2 = torch.where(free_q[..., None], c, c + INF)
        masked = torch.where(unmatched_gt[..., None, :], c2,
                             torch.full_like(c2, INF * 100))
        pick = torch.argmin(masked, dim=-2)                            # (..., N)
        add = F.one_hot(pick, Q).bool().transpose(-1, -2) & unmatched_gt[..., None, :]
        matching = torch.where(need, resolve(matching | add), matching)
        c = torch.where(need, c2, c)
    return matching.float()


def hungarian_match_costs(out_prob, out_boxes, out_masks, tgt_labels, tgt_boxes,
                          tgt_match_masks, gt_valid, compute_dtype=torch.float32):
    """Cost assembly. out_prob (..., Q, K) sigmoid; out_boxes (..., Q, T, 4)
    xyxy; out_masks (..., Q, T, h, w) logits; tgt_labels (..., N); tgt_boxes
    (..., N, T, 4); tgt_match_masks (..., N, T, h, w); gt_valid (..., N).
    The mask costs run in ``compute_dtype`` with fp32 sums. Returns (cost
    (..., Q, N), giou (..., Q, N)) fp32."""
    Q, K = out_prob.shape[-2:]
    labels = tgt_labels.long().clamp(0, K - 1)
    idx = labels[..., None, :].expand(*labels.shape[:-1], Q, labels.shape[-1])
    cost_class = -torch.gather(out_prob, -1, idx)                       # (..., Q, N)

    tm = tgt_match_masks.flatten(-3).to(compute_dtype)
    om = out_masks.flatten(-3)
    cost_mask = (batch_sigmoid_ce_cost(om, tm, compute_dtype)
                 + batch_dice_cost(om, tm, compute_dtype))

    gt_wh = box_xyxy_to_cxcywh(tgt_boxes)[..., 2:]
    valid_box = (gt_wh > 0).all(-1)                                     # (..., N, T)
    cost_l1 = (out_boxes.flatten(-2)[..., :, None, :]
               - tgt_boxes.flatten(-2)[..., None, :, :]).abs().sum(-1)  # p=1 on T*4
    giou = video_generalized_box_iou(out_boxes, tgt_boxes, valid_box)
    cost_bbox = cost_l1 + (1.0 - giou)

    in_boxes = get_in_boxes_info(out_boxes, tgt_boxes)                  # (..., Q, T)
    C = cost_class + 2.0 * cost_bbox + 4.0 * cost_mask
    C = torch.where(torch.isfinite(C), C, torch.full_like(C, 1000.0))
    C = C + 100.0 * (~in_boxes).sum(-1)[..., None].to(C.dtype)
    return C, giou


def clip_peak_match(gt_labels, gt_boxes, gt_ids, gt_masks8, gt_valid, ref_points,
                    num_classes: int):
    """Per-pixel ground-truth assignment on the stride-8 map, a batch of videos.

    gt_labels (B, N); gt_boxes (B, N, T, 4) xyxy; gt_ids (B, N, T); gt_masks8
    (B, N, T, P) bool (downsampled to the rpn map, flattened); gt_valid (B, N);
    ref_points (P, 2) normalized pixel centres. Instances are visited by
    increasing area; each claims its mask pixels (or its nearest pixel when the
    mask is empty), which later instances can overwrite.
    Returns (labels (B, T, P) long, dist_weight (B, T, P, K), ids (B, T, P) long)."""
    B, N, T, P = gt_masks8.shape
    K = num_classes
    boxes_c = box_xyxy_to_cxcywh(gt_boxes)
    area = torch.where(gt_valid, boxes_c[..., 2:].prod(-1).mean(-1),
                       torch.full(gt_valid.shape, BIG, device=gt_boxes.device))
    order = torch.argsort(area, dim=-1, stable=True)   # ascending, invalid last

    def take(x):
        idx = order.reshape(B, N, *([1] * (x.dim() - 2))).expand(B, N, *x.shape[2:])
        return torch.gather(x, 1, idx)

    labels_s = take(gt_labels.long())
    boxes_s = take(boxes_c)
    ids_s = take(gt_ids.long())
    masks_s = take(gt_masks8)
    valid_s = take(gt_valid) & (boxes_s[..., 2:] > 0).all(-1).any(-1) & (labels_s >= 0)

    d = (boxes_s[..., None, :2] - ref_points) / boxes_s[..., None, 2:].clamp(min=0.05)
    dist = (d * d).sum(-1)                                              # (B, N, T, P)

    dev = gt_boxes.device
    labels_t = torch.full((B, T, P), -1, dtype=torch.long, device=dev)
    ids_t = torch.full((B, T, P), -1, dtype=torch.long, device=dev)
    weight_t = torch.zeros((B, T, P, K), dtype=torch.float32, device=dev)
    for n in range(N):
        use = valid_s[:, n, None] & (ids_s[:, n] != -1)                 # (B, T)
        mask_px = masks_s[:, n]                                         # (B, T, P)
        nearest = F.one_hot(torch.argmin(dist[:, n], dim=-1), P).bool()
        pos = torch.where(mask_px.any(-1, keepdim=True), mask_px, nearest)
        pos = pos & use[..., None]
        lbl = labels_s[:, n].clamp(0, K - 1)                            # (B,)
        w = 1.0 - 2.0 * dist[:, n].clamp(0.0, 0.5)                      # (B, T, P)
        labels_t = torch.where(pos, lbl[:, None, None], labels_t)
        ids_t = torch.where(pos, ids_s[:, n, :, None], ids_t)
        # only this instance's class channel; the others keep earlier weights
        sel = pos[..., None] & F.one_hot(lbl, K).bool()[:, None, None, :]
        weight_t = torch.where(sel, w[..., None], weight_t)
        dist = torch.where(pos[:, None], torch.full_like(dist, BIG), dist)
    return labels_t, weight_t, ids_t
