"""Device-resident tracker mask memory (counterpart of
``mdqe_cvpr2023_tpu/tracking/mask_memory.py``): running logit sums at stride 4
stay on the device; the host receives small score matrices and the results'
binary masks (``packbits`` keeps a window finalized early small on the
device). Binarization is logit > 0 (== sigmoid > 0.5), which commutes with
the final nearest resize.

Unlike the JAX versions, ``mem_update`` adds into the memory in place (the JAX
package donates the buffers to the same effect). The memory lives on the
device its caller allocates it on (``mem_init``); every function here works
on that device.
"""
from __future__ import annotations

import torch

from ..utils.misc import aligned_bilinear, interpolate_nearest


def mem_init(m1: int, mem_length: int, h: int, w: int, device):
    """The zeroed mask memory on ``device``: logit sums (m1, L, h, w), valid
    frame counts (m1, L) and matched-clip counts (m1,), all float32."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((m1, mem_length, h, w), **f32),
            torch.zeros((m1, mem_length), **f32),
            torch.zeros((m1,), **f32))


def mem_update(logit_sum, valid_count, clip_count, masks, slots, f0: int):
    """In place. logit_sum (M1, L, H, W), valid_count (M1, L), clip_count (M1,);
    masks (K, T, H, W) logits; slots (K,) int64 in [0, M1-1] (last row = dump);
    f0 the memory offset of the clip's first frame."""
    M1 = logit_sum.shape[0]
    K, T = masks.shape[:2]
    active = slots < M1 - 1
    t_idx = torch.arange(f0, f0 + T, device=masks.device)
    rows = slots[:, None].expand(K, T)
    cols = t_idx[None, :].expand(K, T)
    logit_sum.index_put_((rows, cols), masks * active[:, None, None, None],
                         accumulate=True)
    valid_count.index_put_((rows, cols),
                           active[:, None].expand(K, T).to(valid_count.dtype),
                           accumulate=True)
    clip_count.index_put_((slots,), active.to(clip_count.dtype), accumulate=True)


def mem_siou(logit_sum, valid_count, clip_count, masks, f0: int, overlap):
    """Binarized soft-IoU between the saved averaged masks and the clip's masks
    on the frames already in memory. overlap (T,) bool. Returns (M1, K)."""
    T = masks.shape[1]
    f32 = logit_sum.dtype
    avg = logit_sum[:, f0:f0 + T]
    vc = valid_count[:, f0:f0 + T]
    denom = clip_count.clamp(min=1.0)[:, None, None, None]
    ov = overlap[None, :, None, None]
    sm = ((avg / denom > 0) & (vc > 0)[:, :, None, None] & ov).to(f32)
    im = ((masks > 0) & ov).to(f32)
    smf = sm.reshape(sm.shape[0], -1)
    imf = im.reshape(im.shape[0], -1)
    inter = smf @ imf.T
    union = smf.sum(-1)[:, None] + imf.sum(-1)[None] - inter
    valid = (smf > 0).any(-1)[:, None] & (imf > 0).any(-1)[None]
    return torch.where(valid, inter / (union + 1e-6), torch.zeros_like(inter))


def mem_average(logit_sum, valid_count):
    """(M1, L, H, W) running sums -> per-frame averaged logits."""
    return logit_sum / valid_count.clamp(min=1.0)[:, :, None, None]


def rollover_from_avg(avg, valid_count, clip_count, window_frames: int):
    """The memory of the next window from this one's averages: the residual
    frames (beyond the window) move to the front and re-enter with count 1
    (they hold averaged logits); every existing instance restarts at clip
    count 1."""
    roll = avg.shape[1] - window_frames
    new_ls = torch.zeros_like(avg)
    new_ls[:, :roll] = avg[:, window_frames:]
    new_vc = torch.zeros_like(valid_count)
    new_vc[:, :roll] = (valid_count[:, window_frames:] > 0).to(valid_count.dtype)
    return new_ls, new_vc, (clip_count > 0).to(clip_count.dtype)


def mem_rollover(logit_sum, valid_count, clip_count, window_frames: int):
    """Roll the memory over to the next window (new tensors; the reference's
    OverTracker.py:216-223)."""
    return rollover_from_avg(mem_average(logit_sum, valid_count), valid_count,
                             clip_count, window_frames)


def packbits(x_bool):
    """(..., W) bool -> (..., ceil(W/8)) uint8, big-endian bit order."""
    W = x_bool.shape[-1]
    pad = (-W) % 8
    if pad:
        x_bool = torch.nn.functional.pad(x_bool, (0, pad))
    x = x_bool.reshape(*x_bool.shape[:-1], -1, 8).to(torch.uint8)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=x.device)
    return (x << shifts).sum(-1, dtype=torch.uint8)


def unpackbits(packed, width: int):
    """``packbits`` undone: (..., ceil(width/8)) uint8, big-endian bit order
    -> (..., width) bool, on the tensor's device."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :width].bool()


def finalize_bool_from_avg(avg_logits, match_stride: int, image_size, ori_size):
    """avg_logits (m, F, h4, w4) -> binary masks at the original size
    (m, F, oh, ow) bool: aligned-bilinear upsample, crop the padding,
    threshold at logit 0, nearest resize (an index gather; the JAX package
    used one-hot matmuls for the TPU)."""
    up = aligned_bilinear(avg_logits, match_stride)
    up = up[:, :, :image_size[0], :image_size[1]]
    return interpolate_nearest(up > 0, ori_size)


def finalize_from_avg(avg_logits, match_stride: int, image_size, ori_size):
    """``finalize_bool_from_avg`` bit-packed: (m, F, oh, ceil(ow/8)) uint8.
    The port's ``finalize_avg_chunk`` as well: without jit, one function
    serves both."""
    return packbits(finalize_bool_from_avg(avg_logits, match_stride, image_size,
                                           ori_size))


def mem_finalize_masks(avg_logits, match_stride: int, image_size, ori_size,
                       inst_chunk: int = 8):
    """``finalize_from_avg`` of every row, ``inst_chunk`` rows at a time to
    bound the full-resolution intermediate."""
    return torch.cat([finalize_from_avg(avg_logits[c:c + inst_chunk], match_stride,
                                        image_size, ori_size)
                      for c in range(0, avg_logits.shape[0], inst_chunk)])


def mem_window_output(logit_sum, valid_count, clip_count, window_frames: int,
                      match_stride: int, image_size, ori_size, rollover: bool,
                      inst_chunk: int = 8):
    """A window's output in one call: average, finalize every row and, with
    ``rollover``, roll the memory over. Returns (packed masks (M1, L, oh,
    ceil(ow/8)) uint8 over the full memory length, and the memory: the next
    window's, or the given tensors unchanged)."""
    avg = mem_average(logit_sum, valid_count)
    packed = mem_finalize_masks(avg, match_stride, image_size, ori_size, inst_chunk)
    if rollover:
        return (packed, *rollover_from_avg(avg, valid_count, clip_count, window_frames))
    return packed, logit_sum, valid_count, clip_count
