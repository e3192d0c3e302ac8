"""Tensor utilities (counterpart of ``mdqe_cvpr2023_tpu/utils/misc.py``) and
the device rule of the port's entry points."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU. With
    no card and no explicit ``device="cpu"`` they raise; they never move to
    the CPU on their own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


@functools.lru_cache(maxsize=None)
def aligned_bilinear_matrix(size: int, factor: int) -> np.ndarray:
    """Dense (factor*size, size) matrix of the reference's aligned-bilinear
    upsampling: replicate-pad right by 1, resize to factor*size+1 with
    align_corners=True, replicate-pad left by factor//2, crop to factor*size.
    With align_corners=True the source coordinate of resized index i is i/factor,
    so the chain is one sparse matrix M with out[o] = sum_s M[o, s] * in[s]."""
    assert factor >= 1 and int(factor) == factor
    out = factor * size
    shift = factor // 2
    M = np.zeros((out, size + 1), dtype=np.float32)
    for o in range(out):
        i = max(o - shift, 0)
        s = i / factor
        s0 = int(np.floor(s))
        frac = s - s0
        M[o, s0] += 1.0 - frac
        if frac > 0:
            M[o, s0 + 1] += frac
    M[:, size - 1] += M[:, size]  # fold the replicate pad
    return np.ascontiguousarray(M[:, :size])


@functools.lru_cache(maxsize=32)
def _aligned_bilinear_tensor(size: int, factor: int, dtype: torch.dtype,
                             device: str) -> torch.Tensor:
    """Device copy of the matrix, cached so repeated calls copy nothing."""
    return torch.from_numpy(aligned_bilinear_matrix(size, factor)).to(
        device=device, dtype=dtype)


def aligned_bilinear(x, factor: int):
    """Upsample the trailing two axes (..., H, W) by ``factor`` with the
    reference's aligned-bilinear semantics, as two matrix products."""
    if factor == 1:
        return x
    h, w = x.shape[-2], x.shape[-1]
    My = _aligned_bilinear_tensor(h, factor, x.dtype, str(x.device))
    Mx = _aligned_bilinear_tensor(w, factor, x.dtype, str(x.device))
    x = torch.matmul(My, x)                    # (..., fH, W)
    return torch.matmul(x, Mx.transpose(0, 1))  # (..., fH, fW)


def make_reference_points(spatial_shape, device) -> torch.Tensor:
    """Normalized pixel-centre reference points of an (H, W) map -> (H*W, 2) xy."""
    H, W = int(spatial_shape[0]), int(spatial_shape[1])
    ref_y = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) / max(H, 1)
    ref_x = (torch.arange(W, dtype=torch.float32, device=device) + 0.5) / max(W, 1)
    yy, xx = torch.meshgrid(ref_y, ref_x, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def grid_sample(img, grid, padding_mode: str = "zeros", mode: str = "bilinear"):
    """grid_sample with align_corners=False, as the JAX package computes it.
    Bilinear: corner indices are clamped and the corner weights kept
    (``border``), or out-of-range corners weigh zero (``zeros``). Nearest (with
    ``border`` only): the pixel at round-half-to-even of the coordinate,
    clamped.

    img (B, H, W, C) channel-last; grid (B, Hg, Wg, 2) in [-1, 1], (x, y)
    -> (B, Hg, Wg, C)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(padding_mode)
    if mode not in ("bilinear", "nearest") or (mode, padding_mode) == ("nearest", "zeros"):
        raise ValueError(f"mode {mode} with padding {padding_mode}")
    B, H, W, C = img.shape
    gx = (grid[..., 0] + 1.0) * (W * 0.5) - 0.5
    gy = (grid[..., 1] + 1.0) * (H * 0.5) - 0.5
    flat = img.reshape(B, H * W, C)

    def gather(ix, iy):
        lin = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, -1, 1)
        vals = torch.gather(flat, 1, lin.expand(-1, -1, C))
        return vals.reshape(B, *grid.shape[1:3], C)

    def inside(ix, iy):
        return ((ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)).to(img.dtype)

    if mode == "nearest":
        return gather(torch.round(gx).long(), torch.round(gy).long())

    x0f, y0f = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - x0f, gy - y0f
    x0, y0 = x0f.long(), y0f.long()

    def corner(ix, iy, w):
        wm = w if padding_mode == "border" else w * inside(ix, iy)
        return gather(ix, iy) * wm[..., None]

    return (corner(x0, y0, (1 - fx) * (1 - fy))
            + corner(x0 + 1, y0, fx * (1 - fy))
            + corner(x0, y0 + 1, (1 - fx) * fy)
            + corner(x0 + 1, y0 + 1, fx * fy))


def interpolate_bilinear(x, size):
    """Bilinear resize of the trailing two axes (half-pixel centres, no
    antialiasing): the JAX package's ``jax.image.resize(..., "linear",
    antialias=False)`` and torch's align_corners=False interpolation."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=tuple(int(s) for s in size),
                      mode="bilinear", align_corners=False)
    return y.reshape(*lead, *y.shape[-2:])


def interpolate_nearest(x, size):
    """torch F.interpolate(mode='nearest') on the trailing two axes:
    src = floor(dst * in / out)."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = int(size[0]), int(size[1])
    iy = torch.floor(torch.arange(oh, device=x.device) * (h / oh)).long()
    ix = torch.floor(torch.arange(ow, device=x.device) * (w / ow)).long()
    return x.index_select(-2, iy).index_select(-1, ix)
