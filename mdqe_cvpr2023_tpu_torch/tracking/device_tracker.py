"""Device-resident OverTracker (counterpart of
``mdqe_cvpr2023_tpu/tracking/device_tracker.py``): the per-clip association
and memory update run on the device as masked fixed-shape tensors; only the
exact assignment runs on the host, on the gated (M, K) score matrix, which is
copied to the host once per clip. On the port's tracer
(``utils/tracing.py``) ``tracker_step`` records ``vis.track.wait`` (that
copy), ``vis.track.assign`` (the host assignment) and
``vis.track.upload.wait`` (the assignment's upload), and counts the cells
of the matrices it solves in ``vis.lsa_cells``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.hungarian import lsa_maximize
from ..utils import tracing
from .mask_memory import (mem_average, mem_finalize_masks, mem_init, mem_siou,
                          mem_update, rollover_from_avg)


@dataclass(frozen=True)
class TrackerCfg:
    num_max_inst: int
    num_frames: int            # clip length T
    window_frames: int
    clip_stride: int
    num_classes: int
    embed_dim: int
    mask_hw: Tuple[int, int]
    apply_cls_thres: float
    siou_match_threshold: float = 0.1
    ctt_match_threshold: float = 0.5
    suppress_siou: float = 0.4
    suppress_ctt: float = 0.6
    beta_siou: float = 1.0
    beta_ctt: float = 1.0

    @property
    def mem_length(self) -> int:
        return self.window_frames + self.num_frames

    @property
    def num_clip_mem_long(self) -> int:
        return 15 // self.clip_stride

    @property
    def num_clip_mem_short(self) -> int:
        return max(self.num_frames, 5) // self.clip_stride

    @property
    def ring(self) -> int:
        return max(3, (self.num_frames - 1) // self.clip_stride)

    @property
    def ema_window(self) -> int:
        return min(3, self.ring)


def tracker_state_init(cfg: TrackerCfg, device):
    M = cfg.num_max_inst
    H, W = cfg.mask_hw
    f32 = dict(dtype=torch.float32, device=device)
    # mask memory (running sums; row M is the dump row of unmatched detections)
    logit_sum, valid_count, clip_count_mem = mem_init(M + 1, cfg.mem_length, H, W, device)
    return {
        "logit_sum": logit_sum,
        "valid_count": valid_count,
        "clip_count_mem": clip_count_mem,
        "embeds_mem": torch.zeros((M, cfg.embed_dim), **f32),
        "untracked": torch.zeros((M,), **f32),
        "ring_embeds": torch.zeros((cfg.ring, M, cfg.embed_dim), **f32),
        "ring_valid": torch.zeros((cfg.ring, M), dtype=torch.bool, device=device),
        "cls_sum": torch.zeros((M, cfg.num_classes), **f32),
        "clip_count": torch.zeros((M,), **f32),
        "num_inst": torch.zeros((), dtype=torch.int64, device=device),
        "num_clip": torch.zeros((), dtype=torch.int64, device=device),
    }


def _masked_softmax(f, mask, dim):
    fm = torch.where(mask, f, torch.full_like(f, -1e30))
    e = torch.exp(fm - fm.amax(dim, keepdim=True)) * mask
    den = e.sum(dim, keepdim=True)
    return torch.where(den > 0, e / den.clamp(min=1e-30), torch.zeros_like(e))


def _ctt_masked(f, rowmask, colmask):
    """Bi-directional softmax similarity over the (rowmask x colmask)
    submatrix, zero outside."""
    mask2d = rowmask[:, None] & colmask[None, :]
    d2t = _masked_softmax(f, mask2d, 0)
    t2d = _masked_softmax(f, mask2d, 1)
    ns, ni = rowmask.sum(), colmask.sum()
    ws = (ns > 1).float()
    wi = (ni > 1).float()
    general = (ws * d2t + wi * t2d) / torch.clamp(ws + wi, min=1.0)
    single = 0.5 * (d2t + t2d)
    sim = torch.where((ns == 1) & (ni == 1), single, general)
    return sim * mask2d


def _scatter_set(size: int, fill: int, index, src):
    """``out[index] = src`` into a (size,) int64 tensor filled with ``fill``;
    indices equal to ``size`` are dropped (JAX ``.at[].set(mode="drop")``)."""
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=src.device)
    out[index] = src
    return out[:size]


def tracker_step(state, cfg: TrackerCfg, scores, cls_probs, masks, embeds, valid,
                 f0: int, overlap):
    """One clip's association and memory update. scores (K,), cls_probs
    (K, Kc), masks (K, T, h, w) logits, embeds (K, C), valid (K,) bool, f0 the
    memory offset of the clip's first frame, overlap (T,) bool. The mask memory
    is updated in place; the returned dict is the new state, with ``slots``
    (K,): each detection's instance row (M for none) in this clip."""
    M = cfg.num_max_inst
    K = scores.shape[0]
    dev = scores.device
    num_inst = state["num_inst"]
    rows = torch.arange(M, device=dev)
    row_lt = rows < num_inst

    f = state["embeds_mem"] @ embeds.T                                   # (M, K)
    long_rows = row_lt & (state["untracked"] < cfg.num_clip_mem_long)
    short_rows = row_lt & (state["untracked"] < cfg.num_clip_mem_short)
    sim_long = _ctt_masked(f, long_rows, valid)
    sim_short = _ctt_masked(f, short_rows, valid)
    scores_mem = torch.where(short_rows[:, None] & valid[None, :],
                             0.5 * (sim_long + sim_short), sim_long)

    siou_full = mem_siou(state["logit_sum"], state["valid_count"],
                         state["clip_count_mem"], masks, f0, overlap)
    siou_scores = siou_full[:M] * valid[None, :] * row_lt[:, None]

    score_mat = cfg.beta_siou * siou_scores + cfg.beta_ctt * scores_mem
    thres = (cfg.beta_siou * cfg.siou_match_threshold
             + cfg.beta_ctt * cfg.ctt_match_threshold)
    gated = score_mat * (score_mat > thres)

    # exact assignment on the host: the clip's one device-to-host read
    with tracing.wait("vis.track.wait"):
        g = gated.cpu().numpy()
    with tracing.span("vis.track.assign"):
        if M <= K:
            col4row = lsa_maximize(g, g.any(axis=1)).astype(np.int64)
            matched_np = np.where(g[np.arange(M), col4row] > 0, col4row, -1)
        else:
            row4col = lsa_maximize(g.T, g.any(axis=0)).astype(np.int64)
            c_ok = g[row4col, np.arange(K)] > 0
            matched_np = np.full(M, -1, np.int64)
            matched_np[row4col[c_ok]] = np.nonzero(c_ok)[0]
        matched = torch.from_numpy(matched_np)
    tracing.count("vis.lsa_cells", M * K)
    with tracing.wait("vis.track.upload.wait"):   # from pageable memory: it synchronizes
        matched_col = matched.to(dev)

    is_matched_row = matched_col >= 0
    safe_c = matched_col.clamp(0, K - 1)
    pair = torch.zeros((M, K), dtype=torch.bool, device=dev)
    pair[rows, safe_c] = is_matched_row
    slots = _scatter_set(K, M, torch.where(is_matched_row, matched_col, K), rows)
    col_matched = slots < M

    # repeated-detection suppression
    siou_p = torch.where(pair, torch.full_like(siou_scores, -1.0), siou_scores)
    mem_p = torch.where(pair, torch.zeros_like(scores_mem), scores_mem)
    repeated = valid & ~col_matched & ((siou_p.amax(0) > cfg.suppress_siou)
                                       | (mem_p.amax(0) > cfg.suppress_ctt))

    # new IDs; on the very first clip every valid detection registers
    eligible = valid & ~col_matched & ~repeated
    eligible = eligible & ((num_inst == 0) | (scores > 2.0 * cfg.apply_cls_thres))
    new_id = num_inst + torch.cumsum(eligible.long(), 0) - 1
    ok_new = eligible & (new_id < M)
    slots = torch.where(ok_new, new_id, slots)
    n_new = ok_new.sum()

    mem_update(state["logit_sum"], state["valid_count"], state["clip_count_mem"],
               masks, slots, f0)

    row_det = _scatter_set(M, -1, torch.where(slots < M, slots, M),
                           torch.arange(K, device=dev))
    row_matched = row_det >= 0
    safe_d = row_det.clamp(0, K - 1)
    untracked = torch.where(row_matched, torch.zeros_like(state["untracked"]),
                            state["untracked"] + 1.0)
    clip_count = state["clip_count"] + row_matched.float()
    zero = torch.zeros((), device=dev)
    cls_sum = state["cls_sum"] + torch.where(row_matched[:, None],
                                             cls_probs[safe_d], zero)
    embeds_row = torch.where(row_matched[:, None], embeds[safe_d], zero)
    ring_embeds = torch.cat([state["ring_embeds"][1:], embeds_row[None]])
    ring_valid = torch.cat([state["ring_valid"][1:], row_matched[None]])

    # exponential-weighted embedding memory over the last nc ring rows
    RW = cfg.ema_window
    nc = torch.clamp(state["num_clip"] + 1, max=RW)
    s = torch.arange(RW, dtype=torch.float32, device=dev)
    start = RW - nc.float()
    w = torch.exp(0.25 * (s - start)) * (s >= start)
    tail_e = ring_embeds[-RW:]
    tail_v = (tail_e != 0).any(-1).float()   # nonzero-embed test, as the reference
    num = (tail_e * w[:, None, None]).sum(0)
    den = (tail_v * w[:, None]).sum(0).clamp(min=1.0)
    embeds_mem = torch.where(row_matched[:, None], num / den[:, None],
                             state["embeds_mem"])

    return dict(state, embeds_mem=embeds_mem, untracked=untracked,
                ring_embeds=ring_embeds, ring_valid=ring_valid, cls_sum=cls_sum,
                clip_count=clip_count, num_inst=num_inst + n_new,
                num_clip=state["num_clip"] + 1, slots=slots)


def tracker_window_average(state, cfg: TrackerCfg, is_last: bool):
    """Per-window output and rollover. Returns (out_cls (M, Kc), num_inst,
    avg logits (M+1, L, h, w), new_state)."""
    M = cfg.num_max_inst
    dev = state["cls_sum"].device
    rows = torch.arange(M, device=dev)
    num_inst = state["num_inst"]
    row_lt = rows < num_inst
    out_cls = state["cls_sum"] / state["clip_count"].clamp(min=1.0)[:, None]

    # window-level weighted embedding
    R = cfg.ring
    nc = torch.clamp(state["num_clip"], max=R)
    s = torch.arange(R, dtype=torch.float32, device=dev)
    start = R - nc.float()
    w = torch.exp(0.25 * (s - start)) * (s >= start)
    tv = state["ring_valid"].float()
    den = (tv * w[:, None]).sum(0).clamp(min=1.0)
    emb = (state["ring_embeds"] * w[:, None, None]).sum(0) / den[:, None]

    avg = mem_average(state["logit_sum"], state["valid_count"])
    if is_last:
        return out_cls, num_inst, avg, state

    W = cfg.window_frames
    new_ls, new_vc, new_cc = rollover_from_avg(avg, state["valid_count"],
                                               state["clip_count_mem"], W)

    # a row carries its class average and embedding into the next window only
    # when it has valid residual frames (the reference weights the rolled slot
    # by saved_valid[0].any(-1))
    has_res = (state["valid_count"][:M, W:] > 0).any(-1)
    gate = row_lt & has_res
    ring_embeds = torch.zeros_like(state["ring_embeds"])
    ring_embeds[-1] = torch.where(row_lt[:, None], emb, torch.zeros_like(emb))
    ring_valid = torch.zeros_like(state["ring_valid"])
    ring_valid[-1] = gate
    new_state = dict(state, logit_sum=new_ls, valid_count=new_vc,
                     clip_count_mem=new_cc, ring_embeds=ring_embeds,
                     ring_valid=ring_valid,
                     cls_sum=torch.where(gate[:, None], out_cls,
                                         torch.zeros_like(out_cls)),
                     clip_count=gate.float(),
                     num_clip=torch.ones_like(state["num_clip"]))
    return out_cls, num_inst, avg, new_state


def tracker_window_output(state, cfg: TrackerCfg, match_stride: int, image_size,
                          ori_size, is_last: bool, chunk: int = 8):
    """Average + finalize of every row in one call (inference_vis finalizes
    lazily per chunk of live rows instead)."""
    out_cls, num_inst, avg, new_state = tracker_window_average(state, cfg, is_last)
    packed = mem_finalize_masks(avg, match_stride, image_size, ori_size, chunk)
    return out_cls, num_inst, packed, new_state
