"""Multi-scale deformable attention: the plain PyTorch version, the wrapper of
the hand-written CUDA kernel (``csrc/ms_deform_attn.cu``) and the dispatcher.

Contract (that of ``mdqe_cvpr2023_tpu/ops/deform_attn.py``):
  value               (B, N, H, D)   N = sum_l h_l * w_l; fp32 or bf16
  spatial_shapes      static tuple of (h_l, w_l)
  sampling_locations  (B, Q, H, L, P, 2) normalized [0, 1], last axis (x, y)
  attention_weights   (B, Q, H, L, P), softmaxed over L * P
  returns             (B, Q, H * D) fp32 (f64 when an input is f64)

Sampling = grid_sample(bilinear, padding_mode="zeros", align_corners=False):
pixel coordinate = loc * size - 0.5; a corner outside the level counts zero.

``ms_deform_attn`` sends a CPU tensor to the plain version and a CUDA tensor to
the kernel; it never falls back. Each call site keeps its own launch count in
``LAUNCHES``, raised only where the kernel is launched.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from . import _build

LAUNCHES = {"encoder": 0, "decoder_box": 0, "decoder_inst": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ms_deform_attn_plain(value, spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations, attention_weights):
    """4-corner gather per level (mirrors ``_ms_deform_attn_xla``). Computes in
    fp32, or in f64 when given f64."""
    B, N, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes):
        raise ValueError(f"{L} levels in locations, shapes {spatial_shapes}")
    cdt = (torch.float64 if torch.float64 in (value.dtype, sampling_locations.dtype)
           else torch.float32)
    loc = sampling_locations.to(cdt)
    attw = attention_weights.to(cdt)
    out = torch.zeros((B, Q, H, D), dtype=cdt, device=value.device)
    b_idx = torch.arange(B, device=value.device).view(B, 1, 1, 1)
    h_idx = torch.arange(H, device=value.device).view(1, 1, H, 1)
    start = 0
    for l, (h_l, w_l) in enumerate(spatial_shapes):
        h_l, w_l = int(h_l), int(w_l)
        hw = h_l * w_l
        v_flat = value[:, start:start + hw].reshape(B * hw * H, D)
        start += hw
        x = loc[:, :, :, l, :, 0] * w_l - 0.5          # (B, Q, H, P)
        y = loc[:, :, :, l, :, 1] * h_l - 0.5
        x0f, y0f = torch.floor(x), torch.floor(y)
        fx, fy = x - x0f, y - y0f
        x0, y0 = x0f.long(), y0f.long()
        a = attw[:, :, :, l]                            # (B, Q, H, P)
        for cx, cy, wgt in ((x0, y0, (1 - fx) * (1 - fy)),
                            (x0 + 1, y0, fx * (1 - fy)),
                            (x0, y0 + 1, (1 - fx) * fy),
                            (x0 + 1, y0 + 1, fx * fy)):
            ok = (cx >= 0) & (cx < w_l) & (cy >= 0) & (cy < h_l)
            pix = cy.clamp(0, h_l - 1) * w_l + cx.clamp(0, w_l - 1)
            rows = v_flat[((b_idx * hw + pix) * H + h_idx).reshape(-1)]
            rows = rows.view(B, Q, H, P, D).to(cdt)
            out += ((wgt * ok * a)[..., None] * rows).sum(dim=3)
    return out.reshape(B, Q, H * D)


@functools.lru_cache(maxsize=64)
def _level_meta(spatial_shapes: Tuple[Tuple[int, int], ...], device: str):
    """(L, 3) int32 device tensor of (h, w, start row) per level. Cached so the
    hot path makes no host-to-device copy per call."""
    rows, start = [], 0
    for h, w in spatial_shapes:
        rows.append((int(h), int(w), start))
        start += int(h) * int(w)
    return torch.tensor(rows, dtype=torch.int32, device=device)


def ms_deform_attn_cuda(value, spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations, attention_weights,
                        site: Optional[str] = None):
    """Launch ``msda_fwd`` on the current stream. ``site`` names the call site
    whose launch count goes up by one; comparisons pass ``None``."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    B, N, H, D = value.shape
    if sampling_locations.dim() != 6 or sampling_locations.shape[-1] != 2:
        raise ValueError(f"locations must be (B,Q,H,L,P,2), got "
                         f"{tuple(sampling_locations.shape)}")
    _, Q, _, L, P, _ = sampling_locations.shape
    if tuple(sampling_locations.shape[:3]) != (B, Q, H) or L != len(shapes):
        raise ValueError(f"locations {tuple(sampling_locations.shape)} do not fit "
                         f"value {tuple(value.shape)} and shapes {shapes}")
    if tuple(attention_weights.shape) != (B, Q, H, L, P):
        raise ValueError(f"weights {tuple(attention_weights.shape)} != "
                         f"{(B, Q, H, L, P)}")
    if sum(h * w for h, w in shapes) != N:
        raise ValueError(f"value has N={N}, shapes {shapes} sum to another")
    if not (1 <= D <= 64 and L <= 32):
        raise ValueError(f"kernel takes D <= 64 and L <= 32, got D={D} L={L}")
    for name, t in (("value", value), ("locations", sampling_locations),
                    ("weights", attention_weights)):
        if t.device.type != "cuda" or t.device != value.device:
            raise ValueError(f"{name} must be on {value.device}, is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sampling_locations.dtype != torch.float32 \
            or attention_weights.dtype != torch.float32:
        raise TypeError("locations and weights must be float32")
    if value.dtype == torch.float32:
        fn_name = "msda_fwd_f32"
    elif value.dtype == torch.bfloat16:
        fn_name = "msda_fwd_bf16"
    else:
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")

    lib = _build.load("ms_deform_attn")
    meta = _level_meta(shapes, str(value.device))
    out = torch.empty((B, Q, H * D), dtype=torch.float32, device=value.device)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = getattr(lib, fn_name)(value.data_ptr(), meta.data_ptr(),
                                sampling_locations.data_ptr(),
                                attention_weights.data_ptr(), out.data_ptr(),
                                B, N, Q, H, D, L, P, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.msda_error_string(err).decode()} ({err})")
    if site is not None:
        LAUNCHES[site] += 1
    return out


def ms_deform_attn(value, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations, attention_weights, site: str):
    """Deformable attention for the call site ``site`` (a key of LAUNCHES):
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if site not in LAUNCHES:
        raise KeyError(site)
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"no deformable-attention path for {value.device}")
    return ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                               attention_weights, site)
