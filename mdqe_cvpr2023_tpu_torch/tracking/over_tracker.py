"""The host clip-by-clip tracker (counterpart of
``mdqe_cvpr2023_tpu/tracking/over_tracker.py``), the behavioural spec of the
device tracker (``tracking/device_tracker.py``).

Match score = binarized mask soft-IoU on the frames already in memory +
bi-directional-softmax embedding similarity with long (15-clip) and short
memories; the assignment by ``scipy.optimize.linear_sum_assignment`` on the
thresholded scores (as the JAX package and the reference do), repeated-
detection suppression, registration of new IDs, an exponentially weighted
embedding memory, and windowed results with residual-frame rollover.

The embeddings, classes, ring, memory weights and the assignment are host
numpy. The mask memory (running logit sums, valid-frame and matched-clip
counts: ``tracking/mask_memory.py``) lives on the tracker's device, which is
the device of every clip's ``mask_logits``: the host reads an (M+1, K) score
matrix a clip and, per window, bit-packed masks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..utils.misc import resolve_device
from .mask_memory import (mem_average, mem_init, mem_rollover, mem_siou, mem_update,
                          mem_window_output)


def ctt_similarity(saved_embeds: np.ndarray, input_embeds: np.ndarray) -> np.ndarray:
    """Bi-directional softmax similarity (reference OverTracker.py:228-242)."""
    feats = saved_embeds @ input_embeds.T  # (Ns, Ni)
    Ns, Ni = feats.shape
    ws = 1 if Ns > 1 else 0
    wi = 1 if Ni > 1 else 0
    d2t = _softmax(feats, axis=0)
    t2d = _softmax(feats, axis=1)
    if Ns == 1 and Ni == 1:
        return 0.5 * (d2t + t2d)
    return (ws * d2t + wi * t2d) / max(ws + wi, 1)


def _softmax(x, axis):
    m = x.max(axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


@dataclass
class ClipResults:
    """One clip's outputs: host numpy metadata with a fixed detection capacity
    K, and the mask logits (K, T, H, W) at stride 4 as a torch tensor on the
    tracker's device."""
    frame_idx: List[int]          # real frames covered (may be < T for last clip)
    scores: np.ndarray            # (K,)
    classes: np.ndarray           # (K,)
    cls_probs: np.ndarray         # (K, Kcls)
    mask_logits: torch.Tensor     # (K, T, H, W)
    query_embeds: np.ndarray      # (K, C)
    valid: np.ndarray             # (K,) bool

    @property
    def num_instance(self) -> int:
        return int(self.valid.sum())


class OverTracker:
    """``device``: where the mask memory lives and the clips' mask logits must
    be (the card unless ``"cpu"``, by ``resolve_device``)."""

    def __init__(self, num_max_inst, num_frames, window_frames, clip_stride,
                 num_classes, embed_dim, mask_size, apply_cls_thres, device=None):
        self.device = resolve_device(device)
        self.num_frames = num_frames
        self.window_frames = window_frames
        self.clip_stride = clip_stride
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.mask_size = tuple(mask_size)
        self.apply_cls_thres = apply_cls_thres

        self.num_max_inst = num_max_inst
        self.num_inst = 0
        self.mem_length = window_frames + num_frames
        self.saved_idx_set: set = set()
        self.start_frame = 0

        # matching hyper-parameters (reference :36-44)
        self.siou_match_threshold = 0.1
        self.ctt_match_threshold = 0.5
        self.beta_siou = 1.0
        self.beta_ctt = 1.0
        self.num_clip_mem_long = 15 // clip_stride
        self.num_clip_mem_short = max(num_frames, 5) // clip_stride
        self.ring = max(3, (num_frames - 1) // clip_stride)
        self.weights_mem = np.exp(np.arange(self.num_clip_mem_long) * 0.25)

        self.untracked_clips = np.zeros(num_max_inst, np.float64)
        self.embeds_mem = np.zeros((num_max_inst, embed_dim), np.float32)
        self._init_host_memory(is_first=True)
        H, W = self.mask_size
        # one extra dump row for unmatched detections
        self.logit_sum, self.valid_count, self.clip_count_dev = mem_init(
            num_max_inst + 1, self.mem_length, H, W, self.device)

    def _init_host_memory(self, is_first: bool):
        M = self.num_max_inst
        self.num_clip = 0 if is_first else 1
        if not is_first:
            self.start_frame += self.window_frames
        self.saved_idx_set = set(f for f in self.saved_idx_set
                                 if f >= self.start_frame)
        self.clip_count = np.zeros((M,), np.float32)
        self.cls_sum = np.zeros((M, self.num_classes), np.float32)
        self.ring_embeds = np.zeros((self.ring, M, self.embed_dim), np.float32)
        self.ring_valid = np.zeros((self.ring, M), bool)

    def _push_ring(self, embeds_row, valid_row):
        self.ring_embeds = np.roll(self.ring_embeds, -1, axis=0)
        self.ring_valid = np.roll(self.ring_valid, -1, axis=0)
        self.ring_embeds[-1] = embeds_row
        self.ring_valid[-1] = valid_row

    # ------------------------------------------------------------------
    def clip_offsets(self, frame_idx: List[int]):
        """(f0, overlap) for a clip about to be processed: memory offset of its first
        frame and which clip frames are already present in memory."""
        f0 = max(min(frame_idx) - self.start_frame, 0)
        overlap = np.array([f in self.saved_idx_set and f >= self.start_frame
                            for f in frame_idx], bool)
        return f0, overlap

    def update(self, clip: ClipResults) -> np.ndarray:
        """Associate one clip and update the memories. Returns the clip's
        slots (K,) int64: each detection's instance ID, ``num_max_inst`` for
        none."""
        masks = clip.mask_logits
        if masks.device != self.device:
            raise ValueError(f"mask logits on {masks.device}, the tracker's memory on "
                             f"{self.device}")
        K = clip.valid.shape[0]
        det_idx = np.nonzero(clip.valid)[0]
        n_in = len(det_idx)
        f0, overlap = self.clip_offsets(clip.frame_idx)

        if self.num_inst == 0:
            matched_ID = list(range(n_in))[:self.num_max_inst]
            matched_det = det_idx.tolist()[:self.num_max_inst]
            self.num_inst = len(matched_ID)
            new_assign: List[int] = []
        else:
            emb_mem = self.embeds_mem[:self.num_inst]
            long_ok = np.nonzero(self.untracked_clips[:self.num_inst]
                                 < self.num_clip_mem_long)[0]
            short_ok = np.nonzero(self.untracked_clips[:self.num_inst]
                                  < self.num_clip_mem_short)[0]
            scores_mem = np.zeros((self.num_inst, K), np.float32)
            if n_in > 0:
                emb_in = clip.query_embeds[det_idx]
                if len(long_ok) > 0:
                    scores_mem[np.ix_(long_ok, det_idx)] = ctt_similarity(
                        emb_mem[long_ok], emb_in)
                if len(short_ok) > 0:
                    short = ctt_similarity(emb_mem[short_ok], emb_in)
                    scores_mem[np.ix_(short_ok, det_idx)] = \
                        0.5 * (scores_mem[np.ix_(short_ok, det_idx)] + short)

            # a short last clip covers fewer real frames than its T
            overlap = np.pad(overlap, (0, masks.shape[1] - len(overlap)))
            siou_scores = np.zeros((self.num_inst, K), np.float32)
            if overlap.any() and n_in > 0 and self.beta_siou > 0:
                siou_full = mem_siou(
                    self.logit_sum, self.valid_count, self.clip_count_dev, masks, f0,
                    torch.from_numpy(overlap).to(self.device)).cpu().numpy()
                siou_scores = siou_full[:self.num_inst] * clip.valid[None]

            scores = self.beta_siou * siou_scores + self.beta_ctt * scores_mem
            thres = (self.beta_siou * self.siou_match_threshold
                     + self.beta_ctt * self.ctt_match_threshold)
            above = scores > thres
            scores = scores * above

            row_idx, col_idx = linear_sum_assignment(scores[:, det_idx],
                                                     maximize=True)
            matched_ID, matched_det = [], []
            for r, c in zip(row_idx, col_idx):
                d = det_idx[c]
                if not above[r, d]:
                    continue
                matched_ID.append(int(r))
                matched_det.append(int(d))
                siou_scores[r, d] = -1.0
                scores_mem[r, d] = 0.0

            # repeated-detection suppression (reference :170-181)
            repeated = []
            for d in det_idx:
                if d in matched_det:
                    continue
                if siou_scores[:, d].max() > 0.4 or scores_mem[:, d].max() > 0.6:
                    repeated.append(d)

            unmatched = [d for d in det_idx
                         if d not in matched_det and d not in repeated
                         and clip.scores[d] > 2 * self.apply_cls_thres]
            unmatched = unmatched[:self.num_max_inst - self.num_inst]
            new_assign = list(range(self.num_inst, self.num_inst + len(unmatched)))
            matched_ID = matched_ID + new_assign
            matched_det = matched_det + unmatched

        # ---- device mask-memory update (one small upload: the slot vector) ----
        slots = np.full((K,), self.num_max_inst, np.int64)  # dump row
        for inst, d in zip(matched_ID, matched_det):
            slots[d] = inst
        mem_update(self.logit_sum, self.valid_count, self.clip_count_dev, masks,
                   torch.from_numpy(slots).to(self.device), f0)

        # ---- host memory update (embeds / cls / counters, reference :78-90) ----
        embeds_row = np.zeros((self.num_max_inst, self.embed_dim), np.float32)
        valid_row = np.zeros(self.num_max_inst, bool)
        self.untracked_clips += 1
        if matched_ID:
            r = np.asarray(matched_ID)
            c = np.asarray(matched_det)
            self.clip_count[r] += 1.0
            self.cls_sum[r] += clip.cls_probs[c]
            embeds_row[r] = clip.query_embeds[c]
            valid_row[r] = True
            self.untracked_clips[r] = 0
        self._push_ring(embeds_row, valid_row)
        if matched_ID:
            nc = min(self.num_clip + 1, 3, self.ring)
            emb = self.ring_embeds[-nc:][:, r]
            # reference valid_mem is a NONZERO-embed test (OverTracker.py:85):
            # differs from mask-validity only for the rolled window slot
            vw = (emb != 0).any(-1, keepdims=True).astype(np.float32)
            w = self.weights_mem[:nc].reshape(-1, 1, 1)
            denom = np.clip((vw * w).sum(0), 1.0, None)
            self.embeds_mem[r] = (emb * w).sum(0) / denom

        self.saved_idx_set.update(clip.frame_idx)
        self.num_clip += 1
        self.num_inst += len(new_assign)
        return slots

    # ------------------------------------------------------------------
    def get_result(self, is_last_clip=False, finalize_args=None):
        """Returns (out_cls (N, Kcls) numpy, masks on the device, len_frames)
        and rolls the residual frames over. With finalize_args=(match_stride,
        image_size, ori_size) ``masks`` are bit-packed binary masks at the
        original size over the full memory length (``mem_window_output``;
        slice [:num_inst, :len_frames]); without it, averaged logits (M1, L,
        H, W)."""
        n = self.num_inst
        n_frames_valid = max(self.saved_idx_set) - self.start_frame + 1
        len_frames = self.window_frames if not is_last_clip else int(n_frames_valid)

        if finalize_args is not None:
            match_stride, image_size, ori_size = finalize_args
            masks, self.logit_sum, self.valid_count, self.clip_count_dev = \
                mem_window_output(self.logit_sum, self.valid_count,
                                  self.clip_count_dev, self.window_frames,
                                  match_stride, tuple(image_size),
                                  tuple(ori_size), rollover=not is_last_clip)
        else:
            masks = mem_average(self.logit_sum, self.valid_count)
            if not is_last_clip:
                self.logit_sum, self.valid_count, self.clip_count_dev = \
                    mem_rollover(self.logit_sum, self.valid_count,
                                 self.clip_count_dev, self.window_frames)

        out_cls = self.cls_sum[:n] / np.clip(self.clip_count[:n], 1.0, None)[:, None]

        nc = min(max(3, (self.num_frames - 1) // self.clip_stride), self.num_clip,
                 self.ring)
        qw = self.ring_valid[-nc:][:, :n, None] * self.weights_mem[:nc].reshape(-1, 1, 1)
        emb = (self.ring_embeds[-nc:][:, :n] * qw).sum(0) / np.clip(qw.sum(0), 1.0,
                                                                    None)

        if not is_last_clip:
            # the rolled slot counts for a row only if it has valid RESIDUAL
            # frames (reference weights slot 0 by saved_valid[0].any(-1),
            # OverTracker.py:206-213); valid_count was rolled above, so its
            # leading `roll` columns hold exactly that residual validity.
            # embeds_mem is NOT touched at window boundaries (reference only
            # updates it on matches, :81-90).
            roll = self.mem_length - self.window_frames
            has_res = (self.valid_count[:self.num_max_inst, :roll] > 0).any(1).cpu().numpy()
            self._init_host_memory(is_first=False)
            self.clip_count[:n] = has_res[:n].astype(np.float32)
            self.cls_sum[:n] = out_cls * has_res[:n, None]
            self.ring_embeds[-1, :n] = emb
            self.ring_valid[-1, :n] = has_res[:n]

        return out_cls, masks, len_frames
