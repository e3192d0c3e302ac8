"""TrackVisualizer: labelled, metadata-aware instance drawing for the video
demo (counterpart of the repository's ``demo/visualizer.py``; the reference
demo/visualizer.py:46-123 without the detectron2 / matplotlib stack).

  - per-track colour = the class's metadata colour, jittered by a fixed
    per-id vector scaled to 0.5 (the same seeded tables as the JAX
    package's), so a track keeps its colour in every frame;
  - alpha-blended mask overlay (alpha 0.5) with the mask boundary drawn;
  - a "[track] class score%" label at the mask's median point.

Colours and labels are numpy; ``draw_frame`` imports OpenCV when it runs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_N_JITTERS = 256


def _id_jitters():
    """Fixed per-id jitter vectors (reference _ID_JITTERS is a frozen random
    table; ours is seeded so colors are stable across runs)."""
    rng = np.random.default_rng(1234)
    return rng.random((_N_JITTERS, 3))


_JITTERS = _id_jitters()


def _default_palette(n):
    rng = np.random.default_rng(5489)
    return rng.integers(50, 230, (n, 3)).astype(np.float32)


class TrackVisualizer:
    """Draws per-frame instance predictions with track-stable colors + labels.

    metadata: optional dict with 'thing_classes' (list of names) and
    'thing_colors' (list of RGB 0-255 triples), like detectron2 metadata.
    """

    def __init__(self, metadata: Optional[dict] = None, alpha: float = 0.5,
                 draw_labels: bool = True, draw_boundaries: bool = True):
        self.metadata = metadata or {}
        self.alpha = alpha
        self.draw_labels = draw_labels
        self.draw_boundaries = draw_boundaries
        self._palette = None

    # ------------------------------------------------------------------
    def track_color(self, track_id: int, class_id: int) -> np.ndarray:
        """RGB uint8 color for a track: class base color jittered by track id
        (reference _jitter: color + unit(jitter)*0.5, clipped to [0,1])."""
        colors = self.metadata.get("thing_colors")
        if colors is not None and 0 <= class_id < len(colors):
            base = np.asarray(colors[class_id], np.float32) / 255.0
        else:
            if self._palette is None:
                self._palette = _default_palette(_N_JITTERS) / 255.0
            base = self._palette[track_id % _N_JITTERS]
        vec = _JITTERS[track_id % _N_JITTERS]
        vec = vec / np.linalg.norm(vec) * 0.5
        return (np.clip(base + vec, 0.0, 1.0) * 255.0).astype(np.uint8)

    def _label_text(self, track_id: int, class_id: int, score: float) -> str:
        names = self.metadata.get("thing_classes")
        name = (names[class_id] if names is not None and
                0 <= class_id < len(names) else str(class_id))
        return f"[{track_id}] {name} {score * 100.0:.0f}%"

    # ------------------------------------------------------------------
    def draw_frame(self, frame_rgb: np.ndarray, masks: Sequence[np.ndarray],
                   classes: Sequence[int], scores: Sequence[float],
                   track_ids: Optional[Sequence[int]] = None) -> np.ndarray:
        """frame_rgb (H,W,3) uint8; masks: per-instance (H,W) bool for THIS frame;
        classes/scores per instance; track_ids default to enumeration order
        (the reference labels instances by their position in the Instances list).
        Returns a new (H,W,3) uint8 frame."""
        import cv2
        visf = frame_rgb.astype(np.float32).copy()
        if track_ids is None:
            track_ids = list(range(len(masks)))
        order = np.argsort([-float(s) for s in scores]) if len(scores) else []
        labels_to_draw = []
        for i in order:
            m = np.asarray(masks[i], bool)
            if not m.any():
                continue
            col = self.track_color(int(track_ids[i]), int(classes[i])) \
                .astype(np.float32)
            visf[m] = (1.0 - self.alpha) * visf[m] + self.alpha * col
            if self.draw_labels:
                ys, xs = np.nonzero(m)
                anchor = (int(np.median(xs)), int(np.median(ys)))
                labels_to_draw.append(
                    (anchor, self._label_text(int(track_ids[i]),
                                              int(classes[i]),
                                              float(scores[i])), col))
        vis = np.clip(visf, 0, 255).astype(np.uint8)
        if self.draw_boundaries:
            for i in order:
                m = np.asarray(masks[i], bool)
                if not m.any():
                    continue
                col = self.track_color(int(track_ids[i]), int(classes[i]))
                contours, _ = cv2.findContours(m.astype(np.uint8),
                                               cv2.RETR_EXTERNAL,
                                               cv2.CHAIN_APPROX_SIMPLE)
                cv2.drawContours(vis, contours, -1,
                                 tuple(int(c) for c in col), 1)
        # text last so overlays never cover it; dark outline for contrast
        for (x, y), text, col in labels_to_draw:
            scale = max(0.4, min(frame_rgb.shape[:2]) / 800.0)
            cv2.putText(vis, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, scale,
                        (0, 0, 0), 2, cv2.LINE_AA)
            cv2.putText(vis, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, scale,
                        tuple(int(c) for c in col), 1, cv2.LINE_AA)
        return vis

    # ------------------------------------------------------------------
    def draw_video(self, frames: Sequence[np.ndarray], pred_masks,
                   pred_labels, pred_scores, score_threshold: float = 0.3):
        """Render a whole video from inference_vis output: pred_masks is a list
        of (T,H,W) bool per track. Yields rendered RGB frames."""
        keep = [i for i, s in enumerate(pred_scores) if s > score_threshold]
        for t, frame in enumerate(frames):
            yield self.draw_frame(
                frame,
                [pred_masks[i][t] for i in keep],
                [int(pred_labels[i]) for i in keep],
                [float(pred_scores[i]) for i in keep],
                track_ids=keep)
