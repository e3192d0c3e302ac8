"""Figures (counterpart of ``mdqe_cvpr2023_tpu/utils/plot.py``; the
reference mdqe/util/plot_utils.py): training curves from a Trainer's
``metrics.jsonl``, mask-feature grids, query locations and deformable-
attention sampling points over an image.

Each function returns a matplotlib figure (saved too when ``out_path`` is
given) and takes numpy arrays or CPU tensors; matplotlib is imported when
a function runs.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np


def _np(x) -> np.ndarray:
    """A numpy array of ``x`` (a CPU tensor or anything ``np.asarray`` takes)."""
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_training_curves(metrics_jsonl: str, keys: Sequence[str] = ("total_loss",),
                         out_path: Optional[str] = None):
    """Loss curves from the trainer's metrics.jsonl (reference plot_utils.py:21-81
    plotted D2's metrics.json the same way)."""
    plt = _plt()
    rows = [json.loads(l) for l in open(metrics_jsonl)]
    fig, ax = plt.subplots(figsize=(8, 5))
    for k in keys:
        xs = [r["iteration"] for r in rows if k in r]
        ys = [r[k] for r in rows if k in r]
        ax.plot(xs, ys, label=k)
    ax.set_xlabel("iteration")
    ax.legend()
    ax.grid(alpha=0.3)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig


def plot_mask_features(proto: np.ndarray, n: int = 16, out_path: Optional[str] = None):
    """Grid of proto-mask feature channels (reference plot_utils.py:118-162).
    proto: (H, W, M)."""
    plt = _plt()
    proto = _np(proto)
    n = min(n, proto.shape[-1])
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows))
    for i, ax in enumerate(np.atleast_1d(axes).ravel()):
        ax.axis("off")
        if i < n:
            ax.imshow(proto[..., i])
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig


def plot_query_init(image: np.ndarray, query_coords: np.ndarray,
                    out_path: Optional[str] = None):
    """Selected query locations over the image (reference plot_utils.py:260-317).
    query_coords: (Q, 2) normalized xy."""
    plt = _plt()
    image, query_coords = _np(image), _np(query_coords)
    H, W = image.shape[:2]
    fig, ax = plt.subplots(figsize=(8, 8 * H / W))
    ax.imshow(image)
    ax.scatter(query_coords[:, 0] * W, query_coords[:, 1] * H, s=12, c="red",
               marker="x")
    ax.axis("off")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig


def plot_sampling_locations(image: np.ndarray, ref_points: np.ndarray,
                            sampling_locations: np.ndarray, query_idx: int = 0,
                            out_path: Optional[str] = None):
    """Deformable-attention sampling points of one query over the image
    (reference plot_utils.py:165-258). sampling_locations: (Q, H, L, P, 2) in [0,1]."""
    plt = _plt()
    image, ref_points = _np(image), _np(ref_points)
    sampling_locations = _np(sampling_locations)
    H, W = image.shape[:2]
    fig, ax = plt.subplots(figsize=(8, 8 * H / W))
    ax.imshow(image)
    pts = sampling_locations[query_idx].reshape(-1, 2)
    ax.scatter(pts[:, 0] * W, pts[:, 1] * H, s=8, c="cyan", alpha=0.7)
    ax.scatter([ref_points[query_idx, 0] * W], [ref_points[query_idx, 1] * H],
               s=60, c="red", marker="*")
    ax.axis("off")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig
