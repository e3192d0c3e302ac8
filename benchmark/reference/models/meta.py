"""Windowed near-online VIS inference, plain PyTorch: the benchmark's
reference copy of ``models/meta.py::inference_vis`` of the port (frame
preprocessing, window encode, batched clip decode with fixed-slab
post-processing, the device tracker, per-window mask finalization and the
video-level merge), on one device, without the port's kernels, stage timers,
encode sharding or cached encode copies.

The encode runs in bf16, as the configurations state (``bf16_encode``: bf16
copies of the backbone's, input projections' and encoder's weights, bf16
frames), or, one step lower, with those weights and frames rounded to fp8
(e4m3, one scale a tensor) and computed in bf16 (the control,
``encode="fp8"``); the rest in fp32 with TF32 off, or TF32 on (``tf32=True``,
the control). ``inference_vis`` also returns what the
benchmark's comparison needs beyond the video's result: the merged class
scores of every track row and the masks of the rows that the comparison may
match.
"""
from __future__ import annotations

import contextlib
import itertools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..tracking.device_tracker import (TrackerCfg, tracker_state_init,
                                       tracker_step, tracker_window_average)
from ..utils.misc import aligned_bilinear, interpolate_nearest
from .detr import MDQEModel, MDQEModelCfg, detr_mask_feats

S_BATCH = 8                 # clips of one window decoded together
ABSENT = -1e4               # the mask logit of a row in a window it is absent from
# the parameters and buffers of the window encode (rounded to fp8 in the control)
ENCODE_PREFIXES = ("backbone.", "input_proj.", "transformer_enc.")


@dataclass(frozen=True)
class InferenceCfg:
    clip_stride: int = 1
    n_frames_test: int = 4
    n_frames_window_test: int = 30
    max_num_instances: int = 120
    apply_cls_thres: float = 0.1
    match_stride: int = 4
    clip_topk: int = 32            # fixed per-clip detection slab
    encode_chunk: int = 10         # frames per backbone/encoder call
    num_classes: int = 25
    # the clip's query-similarity dedup and the tracker's repeat suppression
    dedup_sim: float = 0.99
    suppress_siou: float = 0.4
    suppress_ctt: float = 0.6


def preprocess_frames(frames_u8, size_divisibility: int = 32):
    """frames_u8 (T, H, W, 3) uint8 RGB -> zero-padded uint8 (T, Hp, Wp, 3) and
    per-frame sizes (T, 2). Normalization runs on the device."""
    T, H, W, _ = frames_u8.shape
    Hp = -(-H // size_divisibility) * size_divisibility
    Wp = -(-W // size_divisibility) * size_divisibility
    out = np.zeros((T, Hp, Wp, 3), np.uint8)
    out[:, :H, :W] = frames_u8
    return out, np.tile(np.asarray([[H, W]], np.int32), (T, 1))


def spatial_shapes_for(model_cfg: MDQEModelCfg, padded_hw) -> Tuple[Tuple[int, int], ...]:
    """The pyramid levels' (h, w) for padded frames: ceil(Hp / s) at each of
    ``model_cfg.level_strides`` (the backbone's strides and the extra level)."""
    Hp, Wp = padded_hw
    return tuple((-(-Hp // s), -(-Wp // s)) for s in model_cfg.level_strides)


def postprocess_clip(cls_probs, mask_coeff, query_embeds, mask_feats,
                     apply_cls_thres: float, topk: int, dedup_sim: float = 0.99):
    """Batched over S clips: cls_probs (S,Q,K) sigmoid, mask_coeff (S,Q,M),
    query_embeds (S,Q,C), mask_feats (S,T,H,W,M). Returns fixed top-k slabs:
    scores (S,k), classes (S,k), cls_probs (S,k,K), masks (S,k,T,H,W),
    query_embeds (S,k,C), valid (S,k)."""
    S, Q, K = cls_probs.shape
    T = mask_feats.shape[1]
    dev = cls_probs.device
    neg = torch.tensor(-1e9, dtype=torch.float32, device=dev)

    # stage 1: keep >= min(thres, best)
    base = cls_probs.amax(-1)
    keep = base >= base.amax(-1, keepdim=True).clamp(max=apply_cls_thres)

    # stage 2: query-similarity dedup against higher-scored kept queries
    emb_n = query_embeds / query_embeds.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    sim = emb_n @ emb_n.transpose(1, 2)
    order = torch.argsort(-torch.where(keep, base, neg), dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    higher = (rank[:, None, :] < rank[:, :, None]) & keep[:, None, :]
    keep = keep & (torch.where(higher, sim, neg).amax(-1) < dedup_sim)

    masks = torch.einsum("sqm,sthwm->sqthw", mask_coeff, mask_feats)

    # stage 3: drop blank masks
    keep = keep & (masks > 0).reshape(S, Q, -1).any(-1)

    # stage 4: soft-mask-IoU NMS among kept, in score order
    m_nms = masks[:, :, ::2] if T >= 5 else masks
    soft = torch.sigmoid(m_nms[..., ::2, ::2]).reshape(S, Q, -1)
    hard = (soft > 0.5).float()
    inter = soft @ hard.transpose(1, 2)
    denom = soft.sum(-1)[:, :, None] + hard.sum(-1)[:, None, :] - inter
    siou = inter / (denom + 1.0)
    higher = (rank[:, None, :] < rank[:, :, None]) & keep[:, None, :]
    max_iou = torch.where(higher, siou.transpose(1, 2), torch.zeros_like(siou)).amax(-1)
    cls = cls_probs * (1 - max_iou)[..., None]
    keep = keep & (max_iou < 0.5)

    # stage 5: mask-aware rescoring
    soft_full = torch.sigmoid(masks).reshape(S, Q, -1)
    hard_full = (soft_full > 0.5).float()
    mask_scores = (soft_full * hard_full).sum(-1) / (hard_full.sum(-1) + 1e-6)
    cls = cls * mask_scores[..., None]

    # stage 6: fixed top-k (lower index first among equal scores)
    scores = torch.where(keep, cls.amax(-1), neg)
    labels = cls.argmax(-1)
    k_eff = min(topk, Q)
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k_eff], top_idx[:, :k_eff]
    if k_eff < topk:  # tiny-Q configs: pad the slab to the fixed capacity
        top_scores = torch.cat([top_scores, neg.expand(S, topk - k_eff)], 1)
        top_idx = torch.cat([top_idx, top_idx.new_zeros(S, topk - k_eff)], 1)
    n_above = (top_scores > apply_cls_thres).sum(-1).clamp(min=1)
    valid = (torch.arange(topk, device=dev)[None] < n_above[:, None]) \
        & (top_scores > neg / 2)
    s_idx = torch.arange(S, device=dev)[:, None]
    return {
        "scores": top_scores,
        "classes": labels[s_idx, top_idx],
        "cls_probs": cls[s_idx, top_idx],
        "masks": masks[s_idx, top_idx],
        "query_embeds": query_embeds[s_idx, top_idx],
        "valid": valid,
    }


def fp8_round(t):
    """``t`` rounded to fp8 e4m3 with one scale for the tensor (its largest
    magnitude to 448, e4m3's largest finite value), returned in bf16."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).bfloat16()


def encode_params(detr: nn.Module, encode: str):
    """The window encode's floating-point parameters and buffers in bf16
    (``encode="bf16"``), or rounded to fp8 and returned in bf16
    (``encode="fp8"``, ``fp8_round``)."""
    cast = fp8_round if encode == "fp8" else (lambda t: t.bfloat16())
    named = itertools.chain(detr.named_parameters(), detr.named_buffers())
    return {n: cast(t) for n, t in named
            if n.startswith(ENCODE_PREFIXES) and t.is_floating_point()}


@contextlib.contextmanager
def fp8_inputs(detr: nn.Module):
    """Every floating-point tensor that enters a module of the window encode
    rounded to fp8 (``fp8_round``): the control's encode computes on fp8
    operands, as fp8 products take both of theirs."""
    def hook(_module, args):
        return tuple(fp8_round(a) if torch.is_tensor(a) and a.is_floating_point() else a
                     for a in args)
    handles = [m.register_forward_pre_hook(hook) for name, m in detr.named_modules()
               if name.startswith(tuple(p[:-1] for p in ENCODE_PREFIXES))]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def encode_window(detr: nn.Module, frames_u8, image_sizes, pixel_mean,
                  pixel_std, spatial_shapes, params, encode: str = "bf16"):
    """Backbone + encoder + mask head for a chunk of frames (T,Hp,Wp,3) uint8
    on the device, normalized here. The backbone, input projections and
    encoder run in bf16 on ``params`` (``encode_params``), the frames cast to
    bf16 (or, ``encode="fp8"``, the frames and every module's inputs rounded
    to fp8, ``fp8_inputs``); the mask head runs in fp32 on the fp32
    encoding. Returns (encoded (T,N,C) fp32, mask_flat (T,N), mask
    feats (T,h4,w4,M))."""
    images = (frames_u8.float() - pixel_mean) / pixel_std
    images = fp8_round(images) if encode == "fp8" else images.bfloat16()
    with (fp8_inputs(detr) if encode == "fp8" else contextlib.nullcontext()):
        encoded, mask_flat, _ = torch.func.functional_call(detr, params, (images, image_sizes))
    encoded = encoded.float()
    return encoded, mask_flat, detr_mask_feats(detr, encoded, spatial_shapes)


def decode_clips_batched(model: MDQEModel, window_encoded, window_mask_flat,
                         window_mask_feats, offsets, spatial_shapes, n_frames: int,
                         apply_cls_thres: float, topk: int, dedup_sim: float = 0.99):
    """Decode the S clips starting at ``offsets`` (frames within the window) in
    one batch of S * n_frames frames; returns the (S, ...) slabs."""
    idx = [o + t for o in offsets for t in range(n_frames)]
    idx = torch.as_tensor(idx, device=window_encoded.device)
    S = len(offsets)
    enc = window_encoded.index_select(0, idx)
    mfl = window_mask_flat.index_select(0, idx)
    mfe = window_mask_feats.index_select(0, idx)
    out = model.detr.transformer_dec(enc, mfl, spatial_shapes, n_frames)
    return postprocess_clip(out["cls"], out["mask_coeff"], out["query_embed"],
                            mfe.reshape(S, n_frames, *mfe.shape[1:]),
                            apply_cls_thres, topk, dedup_sim)


def _encode_gaps(got, own):
    """(relative gap of the encoding, of the mask features) of one encode
    call's outputs ``got`` against the reference's ``own``."""
    if got[1].shape != own[1].shape or not torch.equal(got[1].to(own[1].device), own[1]):
        return float("inf"), float("inf")
    return tuple(float(torch.linalg.vector_norm((g.to(o.device).double() - o.double()))
                       / torch.linalg.vector_norm(o.double()).clamp(min=1e-30))
                 for g, o in ((got[0], own[0]), (got[2], own[2])))


def _finalize_logits(window_out, rows, image_size, ori_size, match_stride: int):
    """The mask logits (len(rows), len_frames, oh, ow) of the given rows of a
    window's average slab at the original size: what the port's
    ``finalize_from_avg`` thresholds at 0 (the same upsample, crop and
    nearest resize)."""
    _, _, avg, len_frames = window_out
    idx = torch.as_tensor(rows, device=avg.device)
    up = aligned_bilinear(avg.index_select(0, idx), match_stride)
    up = up[:, :, :image_size[0], :image_size[1]]
    return interpolate_nearest(up, ori_size)[:, :len_frames]


def merged_scores(pred_cls_clips):
    """The video's merged class scores (total rows, K) from the per-window
    (n_w, K) class scores: 0.75 of the mean plus 0.25 of the max over
    windows, a row absent from a window counting 0 there."""
    total = pred_cls_clips[-1].shape[0]
    padded = [np.concatenate([c, np.zeros((total - c.shape[0], c.shape[1]), c.dtype)])
              for c in pred_cls_clips]
    cls_stack = np.stack(padded)
    return 0.75 * cls_stack.mean(0) + 0.25 * cls_stack.max(0)


def inference_video(pred_cls_clips):
    """Final score merge and top-k: pred_cls_clips is the per-window (n_w, K)
    class scores. Returns (scores, labels, instance rows, total rows)."""
    out_cls = merged_scores(pred_cls_clips)
    total, K = out_cls.shape
    labels = np.tile(np.arange(K), total)
    flat = out_cls.reshape(-1)
    num_topk = max(int((flat > 0.05).sum()), 10)
    top_idx = np.argsort(-flat)[:num_topk]
    return (flat[top_idx].tolist(), labels[top_idx].tolist(),
            top_idx // K if total else top_idx, int(total))


@torch.no_grad()
def inference_vis(model: MDQEModel, inf_cfg: InferenceCfg, frames: np.ndarray,
                  image_size: Tuple[int, int], ori_size: Tuple[int, int],
                  pixel_mean=(123.675, 116.28, 103.53),
                  pixel_std=(58.395, 57.12, 57.375), encode: str = "bf16",
                  tf32: bool = False, extra_rows: int = 0, given=None):
    """Near-online VIS on one video, on the model's device.

    frames: (T, Hp, Wp, 3) padded uint8 on the host; image_size: true (h, w)
    before padding; ori_size: the video's original (h, w). ``encode``:
    "bf16" or "fp8" (``encode_window``); ``tf32``: TF32 products in the
    fp32 parts. Returns {image_size, pred_scores, pred_labels, pred_masks
    (list of (T, oh, ow) bool), num_tracks} and, for the comparison,
    ``row_scores`` (total rows, K) the merged class scores of every track
    row and ``row_masks`` {row: (T, oh, ow) bool} for the rows of the top
    (number of results + ``extra_rows``) (row, class) scores.
    """
    if encode not in ("bf16", "fp8"):
        raise ValueError(f"encode is bf16 or fp8, not {encode}")
    dev = model.device
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    model_cfg = model.cfg
    detr = model.detr
    params = encode_params(detr, encode)
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=dev)

    T_clip = inf_cfg.n_frames_test
    real_len = frames.shape[0]
    if real_len < T_clip:  # pad very short videos by repeating the last frame
        frames = np.concatenate([frames] + [frames[-1:]] * (T_clip - real_len))
    video_len = frames.shape[0]
    W_win = inf_cfg.n_frames_window_test
    stride = inf_cfg.clip_stride
    shapes = spatial_shapes_for(model_cfg, frames.shape[1:3])

    mask_hw = (2 * shapes[0][0], 2 * shapes[0][1])  # mask head output is stride 4
    tr_cfg = TrackerCfg(num_max_inst=inf_cfg.max_num_instances, num_frames=T_clip,
                        window_frames=W_win, clip_stride=stride,
                        num_classes=inf_cfg.num_classes,
                        embed_dim=model_cfg.hidden_dim, mask_hw=mask_hw,
                        apply_cls_thres=inf_cfg.apply_cls_thres,
                        suppress_siou=inf_cfg.suppress_siou,
                        suppress_ctt=inf_cfg.suppress_ctt)
    state = tracker_state_init(tr_cfg, dev)
    start_frame = 0
    saved_idx: set = set()
    saved_clips = 0
    window_outputs = []  # (out_cls, num_inst, avg, len_frames)

    # clip/window schedule: (start_idx, start_eff, window_start, window_end)
    schedule = []
    wstart, wend = 0, 0
    for start_idx in range(0, video_len, stride):
        end_idx = min(start_idx + T_clip, video_len)
        if end_idx > wend:
            wstart = start_idx
            wend = min(start_idx + W_win, video_len)
        # a tail clip that would be short is shifted back to the last full clip
        start_eff = max(0, min(start_idx, video_len - T_clip))
        schedule.append((start_idx, start_eff, wstart, wend))
        if start_idx + T_clip >= video_len:
            break

    chunk = max(int(inf_cfg.encode_chunk), 1)
    sizes = torch.tensor([list(image_size)] * chunk, dtype=torch.int32, device=dev)
    window = {}  # the current window only: clips visit windows in order
    enc_gaps = []

    def get_window(ws, we):
        if ws not in window:
            window.clear()
            wf = frames[ws:we]
            wlen = -(-wf.shape[0] // chunk) * chunk
            if wf.shape[0] < wlen:  # pad the tail window to a chunk multiple
                wf = np.concatenate([wf] + [wf[-1:]] * (wlen - wf.shape[0]))
            parts = []
            for c0 in range(0, wlen, chunk):
                f = torch.from_numpy(np.ascontiguousarray(wf[c0:c0 + chunk])).to(dev)
                own = encode_window(detr, f, sizes, mean, std, shapes, params, encode)
                if given is not None:
                    gf, got = given[len(enc_gaps)]
                    if gf.shape != f.shape or not torch.equal(gf.to(dev), f):
                        raise ValueError("the given encode calls do not follow the video's chunks")
                    enc_gaps.append(_encode_gaps(got, own))
                    own = tuple(t.to(dev) for t in got)
                parts.append(own)
            window[ws] = tuple(torch.cat([p[j] for p in parts]) for j in range(3))
        return window[ws]

    groups = []  # (window key, schedule indices), at most S_BATCH clips each
    for i, (_, _, ws, we) in enumerate(schedule):
        if groups and groups[-1][0] == (ws, we) and len(groups[-1][1]) < S_BATCH:
            groups[-1][1].append(i)
        else:
            groups.append(((ws, we), [i]))
    batch_of_clip = {i: (g, j) for g, (_, idxs) in enumerate(groups)
                     for j, i in enumerate(idxs)}
    batch_res = {}

    for i, (start_idx, start_eff, _, _) in enumerate(schedule):
        is_last_clip = i == len(schedule) - 1
        frame_idx = list(range(start_eff, start_eff + T_clip))
        f0 = max(frame_idx[0] - start_frame, 0)
        ov = torch.tensor([f in saved_idx and f >= start_frame for f in frame_idx],
                          dtype=torch.bool, device=dev)

        g, j = batch_of_clip[i]
        if g not in batch_res:
            (ws, we), idxs = groups[g]
            enc, mflat, maskf = get_window(ws, we)
            # clamped into the window, as the port and the JAX package clamp
            offs = [min(max(schedule[k][1] - ws, 0), enc.shape[0] - T_clip)
                    for k in idxs]
            offs += [offs[-1]] * (S_BATCH - len(offs))
            res = decode_clips_batched(model, enc, mflat, maskf, offs, shapes,
                                       T_clip, inf_cfg.apply_cls_thres,
                                       inf_cfg.clip_topk, inf_cfg.dedup_sim)
            batch_res = {g: res}
        res = batch_res[g]
        state = tracker_step(state, tr_cfg, res["scores"][j], res["cls_probs"][j],
                             res["masks"][j], res["query_embeds"][j],
                             res["valid"][j], f0, ov)
        saved_idx.update(frame_idx)

        is_output = start_idx + stride >= W_win * (saved_clips + 1)
        if is_last_clip or is_output:
            n_valid = max(saved_idx) - start_frame + 1
            len_frames = W_win if not is_last_clip else int(n_valid)
            out_cls, num_inst, avg, state = tracker_window_average(
                state, tr_cfg, is_last_clip)
            window_outputs.append((out_cls, num_inst, avg, len_frames))
            saved_clips += 1
            if not is_last_clip:
                start_frame += W_win
                saved_idx = {f for f in saved_idx if f >= start_frame}
        if is_last_clip:
            break

    # video end: merge the windows' class scores, then the masks of the rows
    win_cls = [wo[0].float().cpu().numpy()[:int(wo[1])] for wo in window_outputs]
    out_scores, out_labels, inst_idx, total = inference_video(win_cls)
    row_scores = merged_scores(win_cls)
    flat = row_scores.reshape(-1)
    K = row_scores.shape[1]
    wide = np.argsort(-flat, kind="stable")[:len(out_scores) + int(extra_rows)] // K
    rows = sorted({int(r) for r in inst_idx} | {int(r) for r in wide})
    row_logits = {r: [] for r in rows}
    for wo in window_outputs:
        n, len_frames = int(wo[1]), wo[3]
        have = [r for r in rows if r < n]
        logits = (_finalize_logits(wo, have, image_size, ori_size, inf_cfg.match_stride)
                  if have else None)
        for r in rows:
            row_logits[r].append(logits[have.index(r)] if r < n else torch.full(
                (len_frames,) + tuple(ori_size), ABSENT, device=dev))
    row_logits = {r: torch.cat(p)[:real_len] for r, p in row_logits.items()}
    row_masks = {r: (x > 0).cpu().numpy() for r, x in row_logits.items()}
    out_masks = [row_masks[int(r)] for r in inst_idx]
    return {"image_size": ori_size, "pred_scores": out_scores,
            "pred_labels": out_labels, "pred_masks": out_masks,
            "num_tracks": int(total), "row_scores": row_scores, "row_masks": row_masks,
            "row_logits": row_logits, "enc_gaps": enc_gaps}
