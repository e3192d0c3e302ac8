"""Clip-consistent augmentations (host numpy), the port's own copy of
``mdqe_cvpr2023_tpu/data/augmentation.py``. Each transform draws its
parameters once per clip at construction and applies them to every frame of
the clip: resize by the shortest edge, flip, relative or absolute crop with an
anchor that pans across the clip, LSJ resize and fixed-size crop, rotation
with a sorted (possibly reversed) angle sequence (OpenCV only, as in the JAX
package), and colour jitter. ``AugmentationPipeline.sample`` draws from its
``np.random.Generator`` in the JAX package's order, so one generator state
gives the same transforms in both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .image import BACKEND, cv2
from .image import resize_image as _resize_image, resize_mask as _resize_mask

_HAS_CV2 = BACKEND == "cv2"


class ClipTransform:
    """A transform with per-clip parameters fixed at construction."""

    def apply_image(self, img: np.ndarray, frame_idx: int) -> np.ndarray:
        raise NotImplementedError

    def apply_box(self, boxes: np.ndarray, frame_idx: int) -> np.ndarray:
        """boxes (N, 4) xyxy in pixels."""
        raise NotImplementedError

    def apply_mask(self, masks: np.ndarray, frame_idx: int) -> np.ndarray:
        """masks (N, H, W) bool."""
        raise NotImplementedError


class ResizeShortestEdge(ClipTransform):
    def __init__(self, rng, in_hw, min_sizes: Sequence[int], max_size: int):
        short = int(rng.choice(list(min_sizes)))
        h, w = in_hw
        scale = short / min(h, w)
        if max(h, w) * scale > max_size:
            scale = max_size / max(h, w)
        self.out_hw = (int(round(h * scale)), int(round(w * scale)))
        self.in_hw = in_hw

    def apply_image(self, img, frame_idx=0):
        return _resize_image(img, *self.out_hw)

    def apply_box(self, boxes, frame_idx=0):
        sy = self.out_hw[0] / self.in_hw[0]
        sx = self.out_hw[1] / self.in_hw[1]
        return boxes * np.array([sx, sy, sx, sy])

    def apply_mask(self, masks, frame_idx=0):
        return np.stack([_resize_mask(m, *self.out_hw) for m in masks]) \
            if len(masks) else masks.reshape((0,) + self.out_hw)


class RandomFlip(ClipTransform):
    def __init__(self, rng, in_hw, prob=0.5):
        self.do = bool(rng.random() < prob)
        self.w = in_hw[1]

    def apply_image(self, img, frame_idx=0):
        return img[:, ::-1] if self.do else img

    def apply_box(self, boxes, frame_idx=0):
        if not self.do or len(boxes) == 0:
            return boxes
        x0, y0, x1, y1 = boxes.T
        return np.stack([self.w - x1, y0, self.w - x0, y1], axis=1)

    def apply_mask(self, masks, frame_idx=0):
        return masks[:, :, ::-1] if self.do else masks


class RandomCrop(ClipTransform):
    """relative_range: crop size uniform in [size, 1]*HW; absolute_range: pixel
    range. The crop SIZE is drawn once per clip; the crop anchor MOVES linearly
    between two random positions across the clip's frames with sorted (possibly
    reversed) interpolation fractions — simulated camera panning (reference
    RandomCropClip, augmentation.py:190-246)."""

    def __init__(self, rng, in_hw, crop_type: str, size, n_frames: int = 1):
        h, w = in_hw
        if crop_type == "relative_range":
            ch = int(h * (size[0] + rng.random() * (1 - size[0])) + 0.5)
            cw = int(w * (size[1] + rng.random() * (1 - size[1])) + 0.5)
        elif crop_type == "relative":
            ch, cw = int(h * size[0] + 0.5), int(w * size[1] + 0.5)
        elif crop_type == "absolute_range":
            ch = min(h, int(rng.integers(min(size[0], h), min(size[1], h) + 1)))
            cw = min(w, int(rng.integers(min(size[0], w), min(size[1], w) + 1)))
        elif crop_type == "absolute":
            ch, cw = min(h, int(size[0])), min(w, int(size[1]))
        else:
            raise ValueError(crop_type)
        # moving anchor: start (y0,x0), end (y1,x1) with y1>=y0, x1>=x0
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        y1 = int(rng.integers(y0, h - ch + 1))
        x1 = int(rng.integers(x0, w - cw + 1))
        frac = np.sort(rng.random(max(n_frames, 1)))
        ys = np.round(y0 * frac + y1 * (1 - frac)).astype(int)
        xs = np.round(x0 * frac + x1 * (1 - frac)).astype(int)
        if rng.random() < 0.5:
            ys, xs = ys[::-1], xs[::-1]
        self.ys, self.xs = ys, xs
        self.ch, self.cw = ch, cw
        self.out_hw = (ch, cw)

    def _yx(self, frame_idx):
        i = min(frame_idx, len(self.ys) - 1)
        return int(self.ys[i]), int(self.xs[i])

    def apply_image(self, img, frame_idx=0):
        y0, x0 = self._yx(frame_idx)
        return img[y0:y0 + self.ch, x0:x0 + self.cw]

    def apply_box(self, boxes, frame_idx=0):
        if len(boxes) == 0:
            return boxes
        y0, x0 = self._yx(frame_idx)
        b = boxes - np.array([x0, y0, x0, y0])
        b[:, 0::2] = b[:, 0::2].clip(0, self.cw)
        b[:, 1::2] = b[:, 1::2].clip(0, self.ch)
        return b

    def apply_mask(self, masks, frame_idx=0):
        y0, x0 = self._yx(frame_idx)
        return masks[:, y0:y0 + self.ch, x0:x0 + self.cw]


class ResizeScale(ClipTransform):
    """LSJ resize: one random scale per clip; the image is scaled to fit inside
    scale*(target_h, target_w) keeping aspect ratio (reference ResizeScaleClip,
    augmentation.py:131-188)."""

    def __init__(self, rng, in_hw, min_scale: float, max_scale: float,
                 target_h: int, target_w: int):
        scale = float(rng.uniform(min_scale, max_scale))
        h, w = in_hw
        out_scale = min(target_h * scale / h, target_w * scale / w)
        self.out_hw = (int(round(h * out_scale)), int(round(w * out_scale)))
        self.in_hw = in_hw

    def apply_image(self, img, frame_idx=0):
        return _resize_image(img, *self.out_hw)

    def apply_box(self, boxes, frame_idx=0):
        sy = self.out_hw[0] / self.in_hw[0]
        sx = self.out_hw[1] / self.in_hw[1]
        return boxes * np.array([sx, sy, sx, sy])

    def apply_mask(self, masks, frame_idx=0):
        return np.stack([_resize_mask(m, *self.out_hw) for m in masks]) \
            if len(masks) else masks.reshape((0,) + self.out_hw)


class FixedSizeCrop(ClipTransform):
    """Crop to a fixed (h, w) with one random offset per clip; images smaller
    than the target are padded bottom/right with pad_value (reference
    FixedSizeCropClip, augmentation.py:274-330)."""

    def __init__(self, rng, in_hw, crop_hw: Tuple[int, int],
                 pad_value: float = 128.0):
        h, w = in_hw
        th, tw = crop_hw
        off = rng.uniform(0.0, 1.0)
        self.y0 = int(round(max(h - th, 0) * off))
        self.x0 = int(round(max(w - tw, 0) * off))
        self.out_hw = (th, tw)
        self.pad_value = pad_value

    def apply_image(self, img, frame_idx=0):
        th, tw = self.out_hw
        crop = img[self.y0:self.y0 + th, self.x0:self.x0 + tw]
        if crop.shape[0] < th or crop.shape[1] < tw:
            pad = [(0, th - crop.shape[0]), (0, tw - crop.shape[1])]
            pad += [(0, 0)] * (crop.ndim - 2)
            crop = np.pad(crop, pad, constant_values=self.pad_value)
        return crop

    def apply_box(self, boxes, frame_idx=0):
        if len(boxes) == 0:
            return boxes
        th, tw = self.out_hw
        b = boxes - np.array([self.x0, self.y0, self.x0, self.y0])
        b[:, 0::2] = b[:, 0::2].clip(0, tw)
        b[:, 1::2] = b[:, 1::2].clip(0, th)
        return b

    def apply_mask(self, masks, frame_idx=0):
        th, tw = self.out_hw
        if len(masks) == 0:
            return masks.reshape((0, th, tw))
        crop = masks[:, self.y0:self.y0 + th, self.x0:self.x0 + tw]
        if crop.shape[1] < th or crop.shape[2] < tw:
            crop = np.pad(crop, [(0, 0), (0, th - crop.shape[1]),
                                 (0, tw - crop.shape[2])])
        return crop


class RandomRotation(ClipTransform):
    """Per-frame rotation with a sorted (possibly reversed) angle sequence across
    the clip — simulated camera motion for pseudo-clips (augmentation.py:68-130)."""

    def __init__(self, rng, in_hw, angle_range=(-30, 30), n_frames=1):
        angles = np.sort(rng.uniform(angle_range[0], angle_range[1], n_frames))
        if rng.random() < 0.5:
            angles = angles[::-1]
        self.angles = angles
        self.in_hw = in_hw

    def _mat(self, frame_idx):
        h, w = self.in_hw
        return cv2.getRotationMatrix2D((w / 2, h / 2), float(self.angles[frame_idx]),
                                       1.0)

    def apply_image(self, img, frame_idx=0):
        if not _HAS_CV2:
            return img
        h, w = self.in_hw
        return cv2.warpAffine(img, self._mat(frame_idx), (w, h))

    def apply_box(self, boxes, frame_idx=0):
        if not _HAS_CV2 or len(boxes) == 0:
            return boxes
        M = self._mat(frame_idx)
        corners = np.stack([boxes[:, [0, 1]], boxes[:, [2, 1]],
                            boxes[:, [0, 3]], boxes[:, [2, 3]]], axis=1)  # (N,4,2)
        ones = np.ones((*corners.shape[:2], 1))
        pts = np.concatenate([corners, ones], -1) @ M.T  # (N,4,2)
        return np.concatenate([pts.min(1), pts.max(1)], -1)

    def apply_mask(self, masks, frame_idx=0):
        if not _HAS_CV2 or len(masks) == 0:
            return masks
        h, w = self.in_hw
        M = self._mat(frame_idx)
        return np.stack([cv2.warpAffine(m.astype(np.uint8), M, (w, h)) > 0.5
                         for m in masks])


class ColorJitter(ClipTransform):
    def __init__(self, rng, in_hw, kinds: Sequence[str]):
        self.brightness = rng.uniform(0.9, 1.1) if "brightness" in kinds else 1.0
        self.contrast = rng.uniform(0.9, 1.1) if "contrast" in kinds else 1.0
        self.saturation = rng.uniform(0.9, 1.1) if "saturation" in kinds else 1.0

    def apply_image(self, img, frame_idx=0):
        out = img.astype(np.float32)
        out = out * self.brightness
        mean = out.mean()
        out = (out - mean) * self.contrast + mean
        gray = out.mean(axis=-1, keepdims=True)
        out = (out - gray) * self.saturation + gray
        return out.clip(0, 255).astype(img.dtype)

    def apply_box(self, boxes, frame_idx=0):
        return boxes

    def apply_mask(self, masks, frame_idx=0):
        return masks


@dataclass
class AugmentationPipeline:
    """Build-per-clip pipeline: call sample(rng, in_hw, n_frames) to fix parameters,
    then apply to every frame of the clip (crop -> resize -> flip [-> jitter])."""
    min_sizes: Sequence[int]
    max_size: int
    crop_enabled: bool = False
    crop_type: str = "relative_range"
    crop_size: Tuple = (0.8, 0.8)
    rotation: bool = False
    color_kinds: Sequence[str] = ()
    is_train: bool = True
    # LSJ (large-scale jitter) mode: flip -> ResizeScale -> FixedSizeCrop
    # (reference build_augmentation use_lsj branch, augmentation.py:435-461)
    lsj_enabled: bool = False
    lsj_image_size: int = 1024
    lsj_min_scale: float = 0.1
    lsj_max_scale: float = 2.0

    def sample(self, rng, in_hw, n_frames: int,
               min_size: Optional[int] = None) -> List[ClipTransform]:
        """min_size pins the short-side draw (the loader draws one per batch so
        every clip in a batch lands in the same resolution bucket)."""
        tfms: List[ClipTransform] = []
        hw = in_hw
        if not self.is_train:
            tfms.append(ResizeShortestEdge(rng, hw, [self.min_sizes[0]],
                                           self.max_size))
            return tfms
        if self.lsj_enabled:
            flip = RandomFlip(rng, hw)
            tfms.append(flip)
            scale = ResizeScale(rng, hw, self.lsj_min_scale, self.lsj_max_scale,
                                self.lsj_image_size, self.lsj_image_size)
            tfms.append(scale)
            tfms.append(FixedSizeCrop(rng, scale.out_hw,
                                      (self.lsj_image_size,
                                       self.lsj_image_size)))
            return tfms
        if self.rotation and _HAS_CV2:
            tfms.append(RandomRotation(rng, hw, n_frames=n_frames))
        if self.crop_enabled:
            crop = RandomCrop(rng, hw, self.crop_type, self.crop_size,
                              n_frames=n_frames)
            tfms.append(crop)
            hw = crop.out_hw
        sizes = [min_size] if min_size is not None else self.min_sizes
        resize = ResizeShortestEdge(rng, hw, sizes, self.max_size)
        tfms.append(resize)
        hw = resize.out_hw
        tfms.append(RandomFlip(rng, hw))
        if self.color_kinds:
            tfms.append(ColorJitter(rng, hw, self.color_kinds))
        return tfms


def apply_transforms(tfms: List[ClipTransform], img, boxes, masks, frame_idx: int):
    for t in tfms:
        img = t.apply_image(img, frame_idx)
        boxes = t.apply_box(boxes, frame_idx)
        masks = t.apply_mask(masks, frame_idx)
    return img, boxes, masks
