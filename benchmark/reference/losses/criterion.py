"""Training criterion (counterpart of ``mdqe_cvpr2023_tpu/losses/criterion.py``):
the query-init losses plus the dynamic-k matched losses of the final and every
auxiliary decoder layer, with the loss weights of the reference (sem_cls_init
2, cls 2, bbox / giou 2, mask 4, dice 4, the reid losses 0.5).

As in the JAX package, every mask loss is linear in the (Q, N) assignment, so
each is a (Q, THW) x (THW, N) product contracted with it; the reid loss's
random sampling is a masked top-k over random priorities with fixed caps (50T
negatives, 10T positives per instance). The priorities come from the caller's
``torch.Generator``, or are given as a tensor (a test feeds the draws JAX makes
from the same key). Videos are a batch axis here where the JAX package vmaps.

``amp`` (mixed precision) keeps the large (Q, THW) mask tensors and their
(Q, THW) x (THW, N) products in bf16 with fp32 sums (``matmul_f32``), and
every sum over THW in fp32; the box and class terms and the final sums stay
fp32. ``amp=False`` takes the same products in fp32.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..utils.boxes import box_xyxy_to_cxcywh, video_box_iou
from ..utils.misc import grid_sample, make_reference_points
from .matcher import (batch_dice_cost, clip_peak_match, dynamic_k_matching,
                      hungarian_match_costs, matmul_f32, pair_products)


@dataclass(frozen=True)
class CriterionCfg:
    num_classes: int = 25
    eos_coef: float = 1.0
    n_frames: int = 4
    n_query: int = 196
    window_inter_frame_asso: int = 5
    interinst_enabled: bool = True
    interinst_threshold: float = 0.1
    num_points: int = 12544
    box_weight: float = 2.0
    mask_weight: float = 4.0
    dice_weight: float = 4.0
    sem_cls_weight: float = 2.0
    cls_weight: float = 2.0
    aux_weight: float = 0.5  # weight of the losses not in the map (reid)


def top_k(x, k: int):
    """``jax.lax.top_k`` on the last axis: the k largest, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _normalize(x):
    """x / max(|x|, 1e-12) along the last axis, as the JAX package writes it:
    x * rsqrt(max(|x|^2, 1e-24)), finite (no NaN) gradient at a zero row."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True).clamp(min=1e-24))


# ---------------------------------------------------------------------------
# elementary losses
# ---------------------------------------------------------------------------

def sigmoid_focal_sums(logits, targets, no_obj_weight, alpha=0.25, gamma=2.0):
    """(BQ, K) focal loss with the per-query no-object down-weight, as
    (weighted sum, sum of the weights): the loss is their ratio, the weight
    sum clamped at 1."""
    x = logits.float()
    p = torch.sigmoid(x)
    ce = F.softplus(x) - x * targets
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    loss = alpha_t * loss
    is_obj = (targets > 0).any(-1)
    weight = is_obj.float() + no_obj_weight * (~is_obj).float()
    return (loss.sum(-1) * weight).sum(), weight.sum()


def weighted_sigmoid_focal_loss(logits, targets, dist_weight, num_boxes,
                                alpha=2.0, gamma=2.0):
    """Point-sampled query-init semantic loss. logits / targets / dist_weight
    (BT, P, K); num_boxes (BT,)."""
    x = logits.float()
    p = torch.sigmoid(x)
    ce = F.softplus(x) - x * targets
    p_t = (1 - p) * targets + p * (1 - targets)
    loss = ce * p_t ** alpha
    gamma_t = dist_weight * targets + (1 - dist_weight) * (1 - targets)
    loss = loss * gamma_t ** gamma
    return (loss.sum((-2, -1)) / num_boxes).mean()


# ---------------------------------------------------------------------------
# per-layer matched losses
# ---------------------------------------------------------------------------

def hungarian_layer_sums(cfg: CriterionCfg, cls_l, boxes_l, coeff_l, proto,
                         targets, amp: bool = False):
    """One decoder layer over the batch, before its normalization. cls_l
    (B,Q,K) logits; boxes_l (B,Q,T,4) xyxy; coeff_l (B,Q,M); proto
    (B,T,h,w,M); targets as ``criterion_apply`` takes them. ``amp``: the mask
    terms in bf16 with fp32 sums (the JAX package's ``_per_video_layer(...,
    amp=True)``). Returns (sums by loss name, matched pairs, focal weight
    sum): ``loss_cls`` is its sum over the weight sum, ``loss_bbox`` and
    ``loss_giou`` their sums over T x matched pairs, the mask losses theirs
    over the matched pairs (each denominator clamped at 1)."""
    cdt = torch.bfloat16 if amp else torch.float32
    B, Q, K = cls_l.shape
    T = boxes_l.shape[2]
    gt_valid = targets["valid"]
    gt_boxes = targets["boxes"]
    N = gt_valid.shape[1]
    boxes = boxes_l.float()
    prob = torch.sigmoid(cls_l.float())
    # (B,Q,M) x (B,M,THW): under amp the product's fp32 sums rounded to bf16 once
    _, Tp, h, w, M = proto.shape
    out_masks = matmul_f32(coeff_l.to(cdt),
                           proto.to(cdt).reshape(B, Tp * h * w, M).transpose(-1, -2))
    out_masks = out_masks.to(cdt).reshape(B, Q, Tp, h, w)

    with torch.no_grad():  # the assignment takes no gradient
        cost, giou = hungarian_match_costs(prob, boxes, out_masks, targets["labels"],
                                           gt_boxes, targets["match_masks"], gt_valid,
                                           compute_dtype=cdt)
        A = dynamic_k_matching(cost, giou, gt_valid)                   # (B,Q,N)
    num_matched = A.sum()

    # classification (focal)
    labels_oh = F.one_hot(targets["labels"].long().clamp(0, K - 1), K).float() \
        * gt_valid[..., None]
    target_classes = A @ labels_oh                                      # (B,Q,K)

    # boxes
    gt_wh = box_xyxy_to_cxcywh(gt_boxes)[..., 2:]
    valid_ft = (gt_wh > 0).all(-1) & gt_valid[..., None]                # (B,N,T)
    l1_pair = ((boxes[:, :, None] - gt_boxes[:, None]).abs().sum(-1)
               * valid_ft[:, None]).sum(-1)                             # (B,Q,N)
    loss_bbox_sum = (A * l1_pair).sum()

    _, inter, union = video_box_iou(boxes, gt_boxes)                    # (B,Q,N,T)
    lt = torch.minimum(boxes[:, :, None, :, :2], gt_boxes[:, None, :, :, :2])
    rb = torch.maximum(boxes[:, :, None, :, 2:], gt_boxes[:, None, :, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    giou_ft = torch.where(inter > 0, inter / union.clamp(min=1e-3)
                          - (area - union) / area.clamp(min=1e-3),
                          torch.zeros_like(inter))
    loss_giou_sum = (A[..., None] * (1.0 - giou_ft) * valid_ft[:, None]).sum()

    # masks (with the inter-instance repulsion when enabled)
    tm = (targets["match_masks"].to(cdt)
          * gt_valid[:, :, None, None, None].to(cdt)).reshape(B, N, -1)  # (B,N,THW)
    om = out_masks.reshape(B, Q, -1)
    thw = om.shape[-1]
    pos = F.softplus(-om)
    neg = F.softplus(om)
    mm = pair_products  # (B,Q,THW) x (B,N,THW) -> (B,Q,N) fp32

    if cfg.interinst_enabled:
        # neighbour union (self included) per ground truth: video-box IoU of
        # the w/h-clamped boxes above the threshold
        wh_c = box_xyxy_to_cxcywh(gt_boxes)[..., 2:].clamp(min=0.05)
        xy_c = 0.5 * (gt_boxes[..., 2:] + gt_boxes[..., :2])
        adj = torch.cat([xy_c - 0.5 * wh_c, xy_c + 0.5 * wh_c], -1)
        biou = video_box_iou(adj, adj)[0].amax(-1)                      # (B,N,N)
        neighbor = (biou > cfg.interinst_threshold) & gt_valid[:, None] \
            & gt_valid[:, :, None]
        u = (matmul_f32(neighbor.to(cdt), (tm > 0.5).to(cdt)) > 0).to(cdt)
        # BCE with pixel weights (1 + union)
        w_t = tm * (1.0 + u)
        w_nt = (1.0 - tm) * (1.0 + u)
        bce_pair = mm(pos, w_t) + mm(neg, w_nt)
        wsum = (1.0 + u).sum(-1, dtype=torch.float32).clamp(min=1.0)   # (B,N)
        loss_mask_sum = (A * (bce_pair / wsum[:, None])).sum()
        # dice with the background-repulsion term (u' = u and not t)
        up = u * (1.0 - (tm > 0.5).to(cdt))
        fg = torch.sigmoid(om)
        bg = torch.sigmoid(-om)
        num_pair = 2.0 * mm(fg, tm) + mm(bg, up)
        den_pair = (fg.sum(-1, dtype=torch.float32)[:, :, None]
                    + tm.sum(-1, dtype=torch.float32)[:, None]
                    + up.sum(-1, dtype=torch.float32)[:, None])
        dice_pair = 1.0 - (num_pair + 1.0) / (den_pair + 1.0)
        loss_dice_sum = (A * dice_pair).sum()
    else:
        bce_pair = (mm(pos, tm) + mm(neg, 1.0 - tm)) / thw
        loss_mask_sum = (A * bce_pair).sum()
        loss_dice_sum = (A * batch_dice_cost(om, tm, cdt)).sum()

    loss_cls_sum, cls_weight = sigmoid_focal_sums(cls_l.reshape(B * Q, K),
                                                  target_classes.reshape(B * Q, K),
                                                  cfg.eos_coef)
    return ({"loss_cls": loss_cls_sum, "loss_bbox": loss_bbox_sum,
             "loss_giou": loss_giou_sum, "loss_mask": loss_mask_sum,
             "loss_dice": loss_dice_sum}, num_matched, cls_weight)


def _layer_losses(sums, num_masks, cls_weight, T: int, world: int = 1):
    """A layer's losses from its sums and its clamped denominators; with
    ``world`` > 1 each numerator is taken ``world`` times (see
    ``criterion_apply``)."""
    if world > 1:
        sums = {k: world * v for k, v in sums.items()}
    return {
        "loss_cls": sums["loss_cls"] / cls_weight,
        "loss_bbox": sums["loss_bbox"] / (T * num_masks),
        "loss_giou": sums["loss_giou"] / (T * num_masks),
        "loss_mask": sums["loss_mask"] / num_masks,
        "loss_dice": sums["loss_dice"] / num_masks,
    }



# ---------------------------------------------------------------------------
# query-initialization losses
# ---------------------------------------------------------------------------

def reid_losses(cfg: CriterionCfg, embeds, q_ids, gt_ids, gt_valid, relpos_grid,
                priorities):
    """Contrastive reid loss of the query-init embeddings, a batch of videos.
    embeds (B,T,Q,E); q_ids (B,T,Q) instance id under each query; gt_ids
    (B,N,T); gt_valid (B,N); relpos_grid (Q,Q,2); priorities (B,N,2,T*Q):
    random numbers ranking each instance's positive (0) and negative (1)
    candidates. Returns (ctt sum, aux sum, number of instances used)."""
    B, T, Q, E = embeds.shape
    N = gt_ids.shape[1]
    TQ = T * Q
    dev = embeds.device
    flat_ids = q_ids.reshape(B, 1, TQ)
    flat_emb = embeds.reshape(B, TQ, E)
    w = max(cfg.window_inter_frame_asso, 2)
    K_neg = min(50 * T, TQ)
    K_pos = min(max(K_neg // 5, 2), TQ)

    inst_ids = torch.where(gt_ids >= 0, gt_ids, torch.full_like(gt_ids, -1)).amax(-1)
    present = flat_ids == inst_ids[..., None]                           # (B,N,TQ)
    use = gt_valid & (inst_ids >= 0) & present.any(-1)                  # (B,N)
    anchor = torch.argmax(present.to(torch.int32), dim=-1)              # first occurrence
    anchor_t = anchor // Q
    anchor_q = anchor % Q

    # fired area: relpos <= w * (|t - anchor_t| + 1) on both axes, per frame
    t_idx = torch.arange(T, device=dev)
    lim = w * ((t_idx - anchor_t[..., None]).abs() + 1)                 # (B,N,T)
    rel = relpos_grid.transpose(0, 1)[anchor_q]                         # (B,N,Q,2)
    fired = (rel[:, :, None] <= lim[..., None, None]).all(-1).reshape(B, N, TQ)
    all_same = torch.where(fired, present, torch.ones_like(present)).all(-1)
    fired = fired | all_same[..., None]
    same = fired & present
    diff = fired & ~present

    n_neg = diff.sum(-1).clamp(max=K_neg)
    n_pos = (n_neg // 5).clamp(min=2)
    neg_inf = torch.full_like(priorities[:, :, 0], float("-inf"))
    pos_vals, pos_idx = top_k(torch.where(same, priorities[:, :, 0], neg_inf), K_pos)
    neg_vals, neg_idx = top_k(torch.where(diff, priorities[:, :, 1], neg_inf), K_neg)
    pos_sel = (torch.arange(K_pos, device=dev) < torch.minimum(
        n_pos, same.sum(-1))[..., None]) & torch.isfinite(pos_vals)
    neg_sel = (torch.arange(K_neg, device=dev) < n_neg[..., None]) \
        & torch.isfinite(neg_vals)

    def rows(idx):  # (B,N,K) indices into TQ -> (B,N,K,E)
        flat = idx.reshape(B, -1, 1).expand(-1, -1, E)
        return torch.gather(flat_emb, 1, flat).reshape(*idx.shape, E)

    target_e = rows(anchor[..., None])[:, :, 0]                         # (B,N,E)
    pos_e, neg_e = rows(pos_idx), rows(neg_idx)
    pos_dot = torch.einsum("bnke,bne->bnk", pos_e, target_e)
    neg_dot = torch.einsum("bnke,bne->bnk", neg_e, target_e)

    # ctt: mean over the selected positives of log(1 + min(sum_neg exp(neg - pos), 1e3))
    expsum = (torch.exp(neg_dot[..., :, None] - pos_dot[..., None, :])
              * neg_sel[..., None]).sum(-2)                             # (B,N,K_pos)
    ctt = torch.log1p(expsum.clamp(max=1e3))
    ctt = (ctt * pos_sel).sum(-1) / pos_sel.sum(-1).clamp(min=1)

    # aux: cosine regression over the selected positives and negatives
    tn = _normalize(target_e)
    cand = _normalize(torch.cat([pos_e, neg_e], 2))
    cos = torch.einsum("bnke,bne->bnk", cand, tn)
    lbl = torch.cat([torch.ones(K_pos, device=dev), torch.zeros(K_neg, device=dev)])
    sel = torch.cat([pos_sel, neg_sel], -1)
    aux = ((cos - lbl).abs() ** 2 * sel).sum(-1) / sel.sum(-1).clamp(min=1)

    zero = torch.zeros_like(ctt)
    return (torch.where(use, ctt, zero).sum(), torch.where(use, aux, zero).sum(),
            use.float().sum())


def query_init_sums(cfg: CriterionCfg, rpn_logits, query_init_embed,
                    query_coords_grid, targets, relpos_grid, priorities):
    """rpn_logits (BT,H,W,K); query_init_embed (BT,Q,E); query_coords_grid
    (BT,nb,nb,2) in [-1, 1]; targets with the stride-8 masks 'masks8'
    (B,N,T,H*W); priorities as ``reid_losses``. Returns (the semantic loss, a
    mean over the BT frames, the reid ctt and aux sums, the number of
    instances they sum over)."""
    BT, H, W, K = rpn_logits.shape
    T = cfg.n_frames
    B = BT // T
    P = H * W
    ref_points = make_reference_points((H, W), rpn_logits.device)
    labels, dist_w, ids = clip_peak_match(targets["labels"], targets["boxes"],
                                          targets["ids"], targets["masks8"],
                                          targets["valid"], ref_points,
                                          cfg.num_classes)

    # semantic loss on the most uncertain points
    logits = rpn_logits.reshape(BT, P, K)
    tgt_oh = (F.one_hot(labels.clamp(0, K - 1), K).float()
              * (labels >= 0)[..., None]).reshape(BT, P, K)
    dist_w = dist_w.reshape(BT, P, K)
    with torch.no_grad():
        p = torch.sigmoid(logits.float())
        uncertainty = (K * (1 - p) * tgt_oh + p * (1 - tgt_oh)).sum(-1)  # (BT,P)
        _, point_idx = top_k(uncertainty, min(cfg.num_points, P))

    def take(arr):
        return torch.gather(arr, 1, point_idx[..., None].expand(-1, -1, K))

    pt_logits, pt_tgt, pt_dist = take(logits), take(tgt_oh), take(dist_w)
    num_boxes = (pt_tgt > 0).any(-1).sum(-1).float().clamp(min=1.0)
    sem_loss = weighted_sigmoid_focal_loss(pt_logits, pt_tgt, pt_dist, num_boxes)

    # instance id under each selected query position (nearest, border)
    id_map = ids.reshape(BT, H, W, 1).float()
    q_ids = grid_sample(id_map, query_coords_grid, padding_mode="border",
                        mode="nearest").reshape(B, T, cfg.n_query).long()

    emb = query_init_embed.reshape(B, T, cfg.n_query, -1).float()
    ctt, aux, cnt = reid_losses(cfg, emb, q_ids, targets["ids"].long(),
                                targets["valid"], relpos_grid, priorities)
    return sem_loss, ctt, aux, cnt


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def criterion_apply(cfg: CriterionCfg, outputs, targets, relpos_grid,
                    generator=None, reid_priorities=None, amp: bool = False,
                    group=None):
    """outputs: the decoder's training dict ('cls' (L,B,Q,K), 'boxes'
    (L,B,Q,T,4), 'mask_coeff' (L,B,Q,M), 'proto' (BT,h,w,M), 'query_init').
    targets: 'labels' (B,N), 'ids' (B,N,T), 'boxes' (B,N,T,4) xyxy, 'valid'
    (B,N), 'match_masks' (B,N,T,h,w), 'masks8' (B,N,T,P8). relpos_grid (Q,Q,2)
    on the device. The reid priorities (B,N,2,T*Q) are drawn uniformly from
    ``generator`` unless ``reid_priorities`` gives them. ``amp``: the matched
    mask losses in bf16 with fp32 sums (``hungarian_layer_sums``). Returns
    (total, the weighted losses by name).

    ``group`` (a ``torch.distributed`` process group of W ranks, each with
    its own rows of the global batch): the losses' denominators are the
    global batch's, as the JAX package's global-batch loss has them. The
    2L+1 counts (the reid instances, and each layer's matched pairs and
    focal weight sum) are summed over the ranks in one all-reduce, then
    clamped at 1. Each rank's term is W x (its sum) / (global denominator),
    so with g_r the gradient of rank r's loss, mean_r g_r = grad(sum_r s_r /
    D), the gradient of the global-batch loss. The semantic loss stays a
    mean over the rank's BT rows: the ranks hold equal numbers of rows, so
    the mean of their means is the global mean. With no group the counts are
    the batch's own."""
    L, B, Q, K = outputs["cls"].shape
    T = cfg.n_frames
    proto = outputs["proto"].reshape(B, T, *outputs["proto"].shape[1:])
    if reid_priorities is None:
        if generator is None:
            raise ValueError("the reid loss needs a generator or reid_priorities")
        N = targets["valid"].shape[1]
        reid_priorities = torch.rand((B, N, 2, T * cfg.n_query), generator=generator,
                                     device=outputs["cls"].device)

    qi = outputs["query_init"]
    sem_loss, ctt, aux, cnt = query_init_sums(cfg, qi["rpn_sem_cls"],
                                              qi["query_init_embed"],
                                              qi["query_coords_grid"], targets,
                                              relpos_grid, reid_priorities)
    layers = [hungarian_layer_sums(cfg, outputs["cls"][l], outputs["boxes"][l],
                                   outputs["mask_coeff"][l], proto, targets, amp)
              for l in range(L)]
    # [reid count, matched pairs per layer, focal weight sum per layer]
    counts = torch.stack([cnt] + [m for _, m, _ in layers]
                         + [w for _, _, w in layers]).detach()
    world = 1
    if group is not None:
        torch.distributed.all_reduce(counts, group=group)
        world = torch.distributed.get_world_size(group)
    counts = counts.clamp(min=1.0)
    if world > 1:
        ctt, aux = world * ctt, world * aux
    losses = {"loss_sem_cls_query_init": sem_loss,
              "loss_reid_query_init": ctt / counts[0],
              "loss_reid_query_init_aux": aux / counts[0]}
    for l, (sums, _, _) in enumerate(layers):
        ld = _layer_losses(sums, counts[1 + l], counts[1 + L + l],
                           outputs["boxes"].shape[3], world)
        suffix = "" if l == L - 1 else f"_{l}"
        for k, v in ld.items():
            losses[k + suffix] = v

    weight_map = {
        "loss_sem_cls_query_init": cfg.sem_cls_weight,
        "loss_cls": cfg.cls_weight,
        "loss_bbox": cfg.box_weight,
        "loss_giou": cfg.box_weight,
        "loss_mask": cfg.mask_weight,
        "loss_dice": cfg.dice_weight,
    }
    weighted = {}
    total = 0.0
    for k, v in losses.items():
        base = k[:k.rfind("_")] if k[-1].isdigit() else k  # strip the layer suffix
        weighted[k] = weight_map.get(k, weight_map.get(base, cfg.aux_weight)) * v
        total = total + weighted[k]
    return total, weighted
