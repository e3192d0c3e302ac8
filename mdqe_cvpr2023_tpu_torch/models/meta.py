"""Windowed near-online VIS inference (counterpart of
``mdqe_cvpr2023_tpu/models/meta.py``, VIS path): frame preprocessing, window
encode, batched clip decode with fixed-slab post-processing, the device
tracker, deferred per-window mask finalization and the video-level merge.

The schedule is the JAX package's: clips of ``n_frames_test`` frames every
``clip_stride`` frames, a tail clip shifted back to the last full clip,
windows of ``n_frames_window_test`` frames encoded ``encode_chunk`` frames at
a time, S = 8 clips of a window decoded in one batch, and at the video end the
final top-k chosen first so that only the selected rows of deferred windows
are upsampled and copied to the host.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..tracking.device_tracker import (TrackerCfg, tracker_state_init,
                                       tracker_step, tracker_window_average)
from ..tracking.mask_memory import finalize_from_avg
from ..utils.misc import resolve_device
from .detr import MDQEModel, MDQEModelCfg, detr_mask_feats

S_BATCH = 8                 # clips of one window decoded together
FINALIZE_CHUNK = 8          # rows per mask-finalize call
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
    bf16_encode: bool = True       # fp32 backbone + encoder when False
    # reference thresholds: the clip's 0.99 query-similarity dedup and the
    # tracker's repeat suppression
    dedup_sim: float = 0.99
    suppress_siou: float = 0.4
    suppress_ctt: float = 0.6
    # device memory allowed for deferred per-window average slabs
    # ((M+1, W+T, h4, w4) fp32); past it the oldest window finalizes all its
    # live rows at once (exact, slower)
    slab_hbm_budget: int = 2 << 30


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
    Hp, Wp = padded_hw
    strides = [8, 16, 32, 64][:model_cfg.n_feature_levels]
    return tuple((-(-Hp // s), -(-Wp // s)) for s in strides)


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


def encode_window(model: MDQEModel, frames_u8, image_sizes, pixel_mean,
                  pixel_std, spatial_shapes, bf16_params=None):
    """Backbone + encoder + mask head for a chunk of frames. frames_u8
    (T,Hp,Wp,3) uint8 on the device, normalized here. With ``bf16_params``
    (bf16 copies of the encode weights) backbone, input projections and
    encoder run in bf16; the mask head runs in fp32 on the fp32 encoding.
    Returns (encoded (T,N,C) fp32, mask_flat (T,N), mask feats (T,h4,w4,M))."""
    detr = model.detr
    images = (frames_u8.float() - pixel_mean) / pixel_std
    if bf16_params is not None:
        encoded, mask_flat, _ = torch.func.functional_call(
            detr, bf16_params, (images.bfloat16(), image_sizes))
    else:
        encoded, mask_flat, _ = detr(images, image_sizes)
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


class _Stages:
    """Host time per stage. With a dict, each stage ends in a device
    synchronize so its time covers its device work; without one, no-op."""

    def __init__(self, timers: Optional[dict], device: torch.device):
        self.timers = timers
        self.device = device

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.timers is None:
            yield
            return
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timers[name] = self.timers.get(name, 0.0) + time.perf_counter() - t0
        self.timers[name + "_n"] = self.timers.get(name + "_n", 0) + 1


def _finalize_rows(window_out, rows, inf_cfg: InferenceCfg, image_size, ori_size):
    """Bit-packed masks (len(rows), len_frames, oh, ceil(ow/8)) of the given
    rows of a window's average slab, on the device."""
    _, _, avg, len_frames = window_out
    idx = torch.as_tensor(rows, device=avg.device)
    parts = [finalize_from_avg(avg.index_select(0, idx[c:c + FINALIZE_CHUNK]),
                               inf_cfg.match_stride, image_size, ori_size)
             for c in range(0, len(rows), FINALIZE_CHUNK)]
    return torch.cat(parts)[:, :len_frames]


def inference_video(pred_cls_clips):
    """Final score merge and top-k: pred_cls_clips is the per-window (n_w, K)
    class scores. Returns (scores, labels, instance rows, total rows)."""
    total = pred_cls_clips[-1].shape[0]
    padded = [np.concatenate([c, np.zeros((total - c.shape[0], c.shape[1]), c.dtype)])
              for c in pred_cls_clips]
    cls_stack = np.stack(padded)
    out_cls = 0.75 * cls_stack.mean(0) + 0.25 * cls_stack.max(0)
    K = out_cls.shape[1]
    labels = np.tile(np.arange(K), total)
    flat = out_cls.reshape(-1)
    num_topk = max(int((flat > 0.05).sum()), 10)
    top_idx = np.argsort(-flat)[:num_topk]
    return (flat[top_idx].tolist(), labels[top_idx].tolist(),
            top_idx // K if total else top_idx, int(total))


@torch.inference_mode()
def inference_vis(model: MDQEModel, inf_cfg: InferenceCfg, frames: np.ndarray,
                  image_size: Tuple[int, int], ori_size: Tuple[int, int],
                  pixel_mean=(123.675, 116.28, 103.53),
                  pixel_std=(58.395, 57.12, 57.375), device=None,
                  timers: Optional[dict] = None):
    """Near-online VIS on one video.

    frames: (T, Hp, Wp, 3) padded uint8 on the host; image_size: true (h, w)
    before padding; ori_size: the video's original (h, w). Runs on the card
    unless ``device="cpu"``; the model must be on that device. ``timers``: a
    dict that receives host seconds per stage (each stage then ends in a
    device synchronize). Returns {image_size, pred_scores, pred_labels,
    pred_masks (list of (T, oh, ow) bool), num_tracks}.
    """
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, inference asked for {dev}")
    # Full fp32 matmuls and convolutions (no TF32): the fp32 parts (decoder,
    # mask head, tracker, mask finalize) are those the JAX package keeps in
    # fp32, and their mask logits are thresholded at 0. The heavy backbone and
    # encoder run in bf16 under bf16_encode.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stage = _Stages(timers, dev)
    model_cfg = model.cfg

    T_clip = inf_cfg.n_frames_test
    real_len = frames.shape[0]
    if real_len < T_clip:  # pad very short videos by repeating the last frame
        frames = np.concatenate([frames] + [frames[-1:]] * (T_clip - real_len))
    video_len = frames.shape[0]
    W_win = inf_cfg.n_frames_window_test
    stride = inf_cfg.clip_stride
    shapes = spatial_shapes_for(model_cfg, frames.shape[1:3])
    mean_dev = torch.tensor(pixel_mean, dtype=torch.float32, device=dev)
    std_dev = torch.tensor(pixel_std, dtype=torch.float32, device=dev)
    bf16_params = None
    if inf_cfg.bf16_encode:
        named = itertools.chain(model.detr.named_parameters(),
                                model.detr.named_buffers())
        bf16_params = {n: t.bfloat16() for n, t in named
                       if n.startswith(ENCODE_PREFIXES) and t.is_floating_point()}

    mask_hw = (2 * shapes[0][0], 2 * shapes[0][1])  # mask head output is stride 4
    tr_cfg = TrackerCfg(num_max_inst=inf_cfg.max_num_instances, num_frames=T_clip,
                        window_frames=W_win, clip_stride=stride,
                        num_classes=inf_cfg.num_classes,
                        embed_dim=model_cfg.hidden_dim, mask_hw=mask_hw,
                        apply_cls_thres=inf_cfg.apply_cls_thres,
                        suppress_siou=inf_cfg.suppress_siou,
                        suppress_ctt=inf_cfg.suppress_ctt)
    state = tracker_state_init(tr_cfg, dev)
    slab_bytes = 4 * (inf_cfg.max_num_instances + 1) * tr_cfg.mem_length \
        * mask_hw[0] * mask_hw[1]
    keep_slabs = max(2, int(inf_cfg.slab_hbm_budget) // slab_bytes)
    start_frame = 0
    saved_idx: set = set()
    saved_clips = 0
    window_outputs = []  # deferred (out_cls, num_inst, avg, len_frames)
    finalized = []       # (out_cls, n, packed masks on device, len_frames)

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
    window = {}  # the current window only: clips visit windows in order

    def get_window(ws, we):
        if ws not in window:
            window.clear()
            wf = frames[ws:we]
            wlen = -(-wf.shape[0] // chunk) * chunk
            if wf.shape[0] < wlen:  # pad the tail window to a chunk multiple
                wf = np.concatenate([wf] + [wf[-1:]] * (wlen - wf.shape[0]))
            sizes = torch.tensor([list(image_size)] * chunk, dtype=torch.int32,
                                 device=dev)
            parts = []
            for c0 in range(0, wlen, chunk):
                with stage("upload"):
                    f = torch.from_numpy(np.ascontiguousarray(wf[c0:c0 + chunk])).to(dev)
                with stage("encode"):
                    parts.append(encode_window(model, f, sizes, mean_dev, std_dev,
                                               shapes, bf16_params))
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
    overlap_cache = {}

    for i, (start_idx, start_eff, _, _) in enumerate(schedule):
        is_last_clip = i == len(schedule) - 1
        frame_idx = list(range(start_eff, start_eff + T_clip))
        f0 = max(frame_idx[0] - start_frame, 0)
        ov = tuple(f in saved_idx and f >= start_frame for f in frame_idx)
        if ov not in overlap_cache:
            overlap_cache[ov] = torch.tensor(ov, dtype=torch.bool, device=dev)

        g, j = batch_of_clip[i]
        if g not in batch_res:
            (ws, we), idxs = groups[g]
            enc, mflat, maskf = get_window(ws, we)
            # Clamped into the window as the JAX package's dynamic_slice clamps:
            # a shifted tail clip that starts before its window decodes the
            # window's first frames (ROADMAP, "Faults found").
            offs = [min(max(schedule[k][1] - ws, 0), enc.shape[0] - T_clip)
                    for k in idxs]
            offs += [offs[-1]] * (S_BATCH - len(offs))
            with stage("decode"):
                res = decode_clips_batched(model, enc, mflat, maskf, offs, shapes,
                                           T_clip, inf_cfg.apply_cls_thres,
                                           inf_cfg.clip_topk, inf_cfg.dedup_sim)
            batch_res = {g: res}
        res = batch_res[g]
        with stage("track"):
            state = tracker_step(state, tr_cfg, res["scores"][j], res["cls_probs"][j],
                                 res["masks"][j], res["query_embeds"][j],
                                 res["valid"][j], f0, overlap_cache[ov])
        saved_idx.update(frame_idx)

        is_output = start_idx + stride >= W_win * (saved_clips + 1)
        if is_last_clip or is_output:
            n_valid = max(saved_idx) - start_frame + 1
            len_frames = W_win if not is_last_clip else int(n_valid)
            with stage("window"):
                out_cls, num_inst, avg, state = tracker_window_average(
                    state, tr_cfg, is_last_clip)
            window_outputs.append((out_cls, num_inst, avg, len_frames))
            # defer mask finalization to the video end while the slabs fit
            # the budget; past it the oldest window finalizes all live rows
            if len(window_outputs) > keep_slabs:
                with stage("finalize"):
                    wo = window_outputs.pop(0)
                    n = int(wo[1])
                    packed = (_finalize_rows(wo, list(range(n)), inf_cfg,
                                             image_size, ori_size) if n else None)
                    finalized.append((wo[0], n, packed, wo[3]))
            saved_clips += 1
            if not is_last_clip:  # host shadow of the tracker's rollover
                start_frame += W_win
                saved_idx = {f for f in saved_idx if f >= start_frame}
        if is_last_clip:
            break

    # video end: select first (tiny class scores, one host read), then
    # materialize masks of the selected rows only
    with stage("merge"):
        pend_cls = [fin[0] for fin in finalized] + [wo[0] for wo in window_outputs]
        pend_num = [wo[1] for wo in window_outputs]
        packed_host = torch.cat([c.reshape(-1).float() for c in pend_cls]
                                + [torch.stack(pend_num).float().reshape(-1)]
                                ).cpu().numpy()
        cls_sz = [c.numel() for c in pend_cls]
        offs = np.concatenate([[0], np.cumsum(cls_sz)]).astype(np.int64)
        counts = packed_host[offs[-1]:]
        win_cls, win_len, win_src = [], [], []
        for k, (out_cls, n, packed, len_frames) in enumerate(finalized):
            win_cls.append(packed_host[offs[k]:offs[k + 1]].reshape(out_cls.shape)[:n])
            win_len.append(len_frames)
            win_src.append(("full", n, packed))
        for k, wo in enumerate(window_outputs):
            kk = len(finalized) + k
            n = int(counts[k])
            win_cls.append(packed_host[offs[kk]:offs[kk + 1]].reshape(wo[0].shape)[:n])
            win_len.append(wo[3])
            win_src.append(("slab", n, wo))

        out_scores, out_labels, inst_idx, total = inference_video(win_cls)
        sel_rows = sorted({int(r) for r in inst_idx})
        win_masks = []  # per window: {row: (L, oh, pw) uint8}
        for (kind, n, src), len_frames in zip(win_src, win_len):
            if kind == "full":
                host = src.cpu().numpy() if n else None
                win_masks.append({r: host[r] for r in range(n)})
            else:
                rows = [r for r in sel_rows if r < n]
                host = (_finalize_rows(src, rows, inf_cfg, image_size,
                                       ori_size).cpu().numpy() if rows else None)
                win_masks.append({r: host[a] for a, r in enumerate(rows)})

        ow = ori_size[1]
        out_masks = []
        for r in inst_idx:
            parts = []
            for rowmap, len_frames in zip(win_masks, win_len):
                m = rowmap.get(int(r))
                if m is None:
                    parts.append(np.zeros((len_frames,) + tuple(ori_size), bool))
                else:
                    parts.append(np.unpackbits(m, axis=-1)[..., :ow].view(bool))
            out_masks.append(np.concatenate(parts, axis=0))
        if real_len < video_len:  # drop the short-video padding frames
            out_masks = [m[:real_len] for m in out_masks]
    return {"image_size": ori_size, "pred_scores": out_scores,
            "pred_labels": out_labels, "pred_masks": out_masks,
            "num_tracks": int(total)}
