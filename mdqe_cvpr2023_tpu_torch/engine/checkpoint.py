"""Released Detectron2/torch ``.pth`` checkpoints -> the port's model
(counterpart of ``mdqe_cvpr2023_tpu/engine/checkpoint.py``).

The port's modules carry the Detectron2 names, so a checkpoint's state dict
loads with no renaming: ``load_torch_checkpoint`` unwraps ``{"model": ...}``,
drops the buffers that are recomputed (``SKIP``), casts floating tensors to
fp32 and applies the temporal inflation (``inflate_temporal_weights``) when
the checkpoint was trained on another number of frames. ``merge_state_dict``
overlays it on an initialized model as the JAX Trainer's ``_merge_params``
does: a key the checkpoint lacks keeps its init, and a shape mismatch keeps
its init and prints.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

# buffers that are recomputed from shapes and never loaded
SKIP = (
    "query_relpos_grid",
    "pixel_mean",
    "pixel_std",
    "criterion.",
    # Swin window-attention index/coordinate buffers
    "relative_position_index",
    "relative_coords_table",
)


def inflate_temporal_weights(state_dict: Dict[str, np.ndarray], f_pretrain: int,
                             f_target: int, n_heads: int = 8,
                             n_points: int = 4) -> Dict[str, np.ndarray]:
    """Inflate the temporal deformable-attention weights from f_pretrain to
    f_target frames. The temporal attention treats frames as levels, so the
    frame axis inside the flattened (H, F, K, D) head layout is tiled
    T = max((f_target + 1) // f_pretrain, 1) times and cut to f_target. It
    applies to ``temp_attn_inst.{attention_weights,sampling_grid_offsets}``
    weight and bias, the ``sampling_offsets`` grid buffer,
    ``lvl_spatial_scales`` and ``temp_embed``. Values are numpy arrays (or
    anything ``np.asarray`` takes)."""
    if f_pretrain == f_target:
        return dict(state_dict)
    T = max((f_target + 1) // f_pretrain, 1)
    out = {}
    for name, tensor in state_dict.items():
        arr = np.asarray(tensor)
        parts = name.split(".")
        if "temp_attn" in name:
            if parts[-2] in {"attention_weights", "sampling_grid_offsets"}:
                # layout (H, F, K, D[, C]): tile F T times, cut to f_target
                d = arr.shape[0] // (n_heads * f_pretrain * n_points)
                rest = arr.shape[1:]
                v = arr.reshape(n_heads, f_pretrain, n_points, d, *rest)
                v = np.repeat(v, T, axis=1)[:, :f_target]
                arr = v.reshape(n_heads * f_target * n_points * d, *rest)
            elif parts[-1] == "sampling_offsets":
                # buffer (1, 1, H, F, K, 2): tile the frame axis (axis 3)
                arr = np.repeat(arr, T, axis=3)[:, :, :, :f_target]
            elif parts[-1] == "lvl_spatial_scales" and parts[-2] == "temp_attn_inst":
                arr = np.repeat(arr, T, axis=0)[:f_target]
        if "temp_embed" in name:
            arr = np.repeat(arr, T, axis=0)[:f_target]
        out[name] = arr
    return out


def load_torch_checkpoint(path: str, f_pretrain: int | None = None,
                          f_target: int | None = None) -> Dict[str, torch.Tensor]:
    """A released ``.pth`` checkpoint -> a flat state dict under the
    Detectron2 names, floating tensors in fp32, the ``SKIP`` buffers dropped,
    temporally inflated when f_pretrain != f_target."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    state = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
             for k, v in state.items() if not any(s in k for s in SKIP)}
    if f_pretrain is not None and f_target is not None and f_pretrain != f_target:
        state = inflate_temporal_weights(state, f_pretrain, f_target)
    out = {}
    for name, arr in state.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out[name] = t.float() if t.is_floating_point() else t
    return out


@torch.no_grad()
def merge_state_dict(model: nn.Module, loaded: Dict[str, torch.Tensor]) -> List[str]:
    """Copy each entry of ``loaded`` whose name and shape match one of
    ``model``'s parameters or buffers into it. A name the model lacks is
    ignored, a name ``loaded`` lacks keeps its init, and a shape mismatch
    keeps its init and prints. Returns the names copied."""
    copied = []
    for name, dst in model.state_dict().items():
        src = loaded.get(name)
        if src is None:
            continue
        if tuple(src.shape) != tuple(dst.shape):
            print(f"[checkpoint] shape mismatch {name}: {tuple(src.shape)} vs "
                  f"{tuple(dst.shape)}; keeping init", flush=True)
            continue
        dst.copy_(src)
        copied.append(name)
    return copied
