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

``ms_deform_attn`` sends a CPU tensor to the plain version (autograd
differentiates it) and a CUDA tensor to ``MSDeformAttnFunction``, whose forward
launches ``msda_fwd_*`` and whose backward launches ``msda_bwd_f32`` (fp32
value) or ``msda_bwd_bf16`` (bf16 value: the mixed-precision training step);
it never falls back. Each call site keeps its own forward launch count in
``LAUNCHES`` and backward launch counts in ``BWD_LAUNCHES`` (fp32) and
``BWD_BF16_LAUNCHES`` (bf16), raised only where the kernel is launched.
``ms_deform_attn_cuda_block`` launches the forward kernel at a chosen block
size for the kernel tools, counted in ``BLOCK_LAUNCHES``. The backward
kernels sum d(value) in fp32: ``msda_bwd_f32`` with 16-byte vector atomics
per tap; ``msda_bwd_bf16`` at the encoder (Q == N) merges each tile's taps
of a row on the SM before one vector atomic per row, into an fp32 buffer
cast to bf16 once, and at the decoder sites owns each row in a block that
writes it once as bf16 (``bwd_bf16_plan``). Where atomics sum, the order,
and the last bits, vary from run to run. The
kernels take D % 8 == 0, D <= 64, L <= 32 and 16-byte aligned inputs, the
backward's output gradient included (``_check_kernel_inputs``); the outputs
are allocated here.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from . import _build

LAUNCHES = {"encoder": 0, "decoder_box": 0, "decoder_inst": 0}
BWD_LAUNCHES = {"encoder": 0, "decoder_box": 0, "decoder_inst": 0}
BWD_BF16_LAUNCHES = {"encoder": 0, "decoder_box": 0, "decoder_inst": 0}
VALUE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
BLOCK_THREADS = (64, 128, 256, 512)
# launches of the block-size launchers (the kernel tools), per value type and
# block size: "f32_t64" ... "bf16_t512"
BLOCK_LAUNCHES = {f"{v}_t{t}": 0 for v in VALUE_DTYPES.values() for t in BLOCK_THREADS}


def reset_launches() -> None:
    """Zero the forward and the backward counts (both value types) of every
    site, and the block launchers' counts."""
    for counts in (LAUNCHES, BWD_LAUNCHES, BWD_BF16_LAUNCHES, BLOCK_LAUNCHES):
        for k in counts:
            counts[k] = 0


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


# msda_bwd_bf16's blocks, as ms_deform_attn.cu counts them (kTileH, kTileW,
# kWindow, kValRows there): a query tile of BF16_TILE pixels of one level at
# Q == N (its taps of a sampled level merged when they span at most
# BF16_WINDOW rows),
# else BF16_VALUE_ROWS rows of one level of d(value); per (b, head). The
# decoder sites' d(value) kernel takes the queries in segments of at most
# BF16_VALUE_POINTS points and BF16_VALUE_QUERIES queries (kValPoints,
# kValQueries), and needs an fp32 scratch where there are several.
BF16_TILE = (4, 8)
BF16_WINDOW = 512
BF16_VALUE_ROWS = 2048
BF16_VALUE_POINTS = 1024
BF16_VALUE_QUERIES = 256


@functools.lru_cache(maxsize=64)
def bwd_bf16_plan(spatial_shapes: Tuple[Tuple[int, int], ...],
                  tiled: bool) -> Tuple[Tuple[int, ...], ...]:
    """One (b, head)'s blocks of ``msda_bwd_bf16`` in the kernel's order
    (its ``blockIdx.x``). ``tiled`` (Q == N, the queries being the levels'
    pixels in order): (level, y0, x0, tile height, tile width) per tile, the
    levels' tiles row-major, the last row and column of a level cut at its
    edge. Otherwise: (level, first row, rows) per block of d(value) rows."""
    blocks = []
    for l, (h, w) in enumerate(spatial_shapes):
        if tiled:
            th, tw = BF16_TILE
            blocks += [(l, y0, x0, min(th, h - y0), min(tw, w - x0))
                       for y0 in range(0, h, th) for x0 in range(0, w, tw)]
        else:
            rows = BF16_VALUE_ROWS
            blocks += [(l, r0, min(rows, h * w - r0)) for r0 in range(0, h * w, rows)]
    return tuple(blocks)


def bwd_bf16_segments(Q: int, P: int) -> int:
    """Segments of the queries the decoder sites' d(value) kernel takes."""
    per = min(BF16_VALUE_POINTS // P, BF16_VALUE_QUERIES)
    return -(-Q // per)


def _check_kernel_inputs(value, shapes, sampling_locations, attention_weights,
                         grad_output=None):
    """Raise on what the kernels do not take; returns (B, N, Q, H, D, L, P).
    The kernels read and write 8 channels a thread with 16-byte vector loads
    and atomics, so D must be a multiple of 8 (and at most 64) and every
    tensor, the backward's ``grad_output`` included, 16-byte aligned (a
    contiguous view at an offset may not be). These rules depend only on
    shapes and data pointers and are checked before the device."""
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
    if not (D % 8 == 0 and 8 <= D <= 64 and L <= 32):
        raise ValueError(f"kernel takes D % 8 == 0, D <= 64 and L <= 32, got D={D} L={L}")
    tensors = [("value", value), ("locations", sampling_locations),
               ("weights", attention_weights)]
    if grad_output is not None:
        tensors.append(("grad_output", grad_output))
    for name, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (data_ptr % 16 == 0)")
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != value.device:
            raise ValueError(f"{name} must be on {value.device}, is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sampling_locations.dtype != torch.float32 \
            or attention_weights.dtype != torch.float32:
        raise TypeError("locations and weights must be float32")
    return B, N, Q, H, D, L, P


def _raise_on(lib, fn_name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.msda_error_string(err).decode()} ({err})")


def _fwd_launch(value, spatial_shapes, sampling_locations, attention_weights,
                threads: Optional[int]):
    """Launch the forward kernel on the current stream: ``msda_fwd_*`` (128
    threads) when ``threads`` is None, else ``msda_fwd_*_block``."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    B, N, Q, H, D, L, P = _check_kernel_inputs(value, shapes, sampling_locations,
                                               attention_weights)
    if value.dtype not in VALUE_DTYPES:
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    fn_name = f"msda_fwd_{VALUE_DTYPES[value.dtype]}"
    extra = ()
    if threads is not None:
        if threads not in BLOCK_THREADS:
            raise ValueError(f"block size {threads} not in {BLOCK_THREADS}")
        fn_name += "_block"
        extra = (threads,)
    lib = _build.load("ms_deform_attn")
    meta = _level_meta(shapes, str(value.device))
    out = torch.empty((B, Q, H * D), dtype=torch.float32, device=value.device)
    err = _build.launch(getattr(lib, fn_name), value.device, value.data_ptr(),
                        meta.data_ptr(), sampling_locations.data_ptr(),
                        attention_weights.data_ptr(), out.data_ptr(),
                        B, N, Q, H, D, L, P, *extra)
    _raise_on(lib, fn_name, err)
    return out


def ms_deform_attn_cuda(value, spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations, attention_weights,
                        site: Optional[str] = None):
    """Launch ``msda_fwd`` on the current stream. ``site`` names the call site
    whose launch count goes up by one; comparisons pass ``None``."""
    out = _fwd_launch(value, spatial_shapes, sampling_locations, attention_weights,
                      None)
    if site is not None:
        LAUNCHES[site] += 1
    return out


def block_variant(dtype: torch.dtype, threads: int) -> str:
    """Key of ``BLOCK_LAUNCHES`` for a value type and block size."""
    return f"{VALUE_DTYPES[dtype]}_t{threads}"


def ms_deform_attn_cuda_block(value, spatial_shapes: Sequence[Tuple[int, int]],
                              sampling_locations, attention_weights, threads: int,
                              count: bool = True):
    """The forward kernel at a block size of ``threads`` (one of
    ``BLOCK_THREADS``), for the kernel tools (``tools/tune_deform_kernel.py``,
    ``tools/probe_band_primitives.py``). Counts the launch in
    ``BLOCK_LAUNCHES[block_variant(value.dtype, threads)]`` unless ``count``
    is False (comparisons)."""
    out = _fwd_launch(value, spatial_shapes, sampling_locations, attention_weights,
                      threads)
    if count:
        BLOCK_LAUNCHES[block_variant(value.dtype, threads)] += 1
    return out


def ms_deform_attn_bwd_cuda(value, spatial_shapes: Sequence[Tuple[int, int]],
                            sampling_locations, attention_weights, grad_output,
                            site: Optional[str] = None):
    """Launch the backward kernel on the current stream: ``msda_bwd_f32`` for
    a float32 value, ``msda_bwd_bf16`` for a bfloat16 one. Returns the
    gradients of the forward's output, given ``grad_output`` (B, Q, H*D)
    float32, with respect to value (in the value's type; the bf16 kernel sums
    in float32 and rounds once), locations and weights. At Q == N (the
    encoder: the queries are the levels' pixels in order) ``msda_bwd_bf16``
    runs its tiled kernel, which merges neighbouring queries' taps, else the
    decoder sites' kernels. ``site`` as in
    ``ms_deform_attn_cuda``, counted in ``BWD_LAUNCHES`` (fp32) or
    ``BWD_BF16_LAUNCHES`` (bf16)."""
    if value.dtype not in VALUE_DTYPES:
        raise TypeError(f"the backward kernel takes float32 or bfloat16 value, got "
                        f"{value.dtype}")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    B, N, Q, H, D, L, P = _check_kernel_inputs(value, shapes, sampling_locations,
                                               attention_weights, grad_output)
    if tuple(grad_output.shape) != (B, Q, H * D) or grad_output.dtype != torch.float32:
        raise ValueError(f"grad_output must be float32 {(B, Q, H * D)}, got "
                         f"{grad_output.dtype} {tuple(grad_output.shape)}")

    fn_name = f"msda_bwd_{VALUE_DTYPES[value.dtype]}"
    lib = _build.load("ms_deform_attn")
    meta = _level_meta(shapes, str(value.device))
    grad_loc = torch.empty_like(sampling_locations)
    grad_attw = torch.empty_like(attention_weights)
    ptrs = (value.data_ptr(), meta.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), grad_output.data_ptr())
    if value.dtype == torch.float32:
        grad_value = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
        err = _build.launch(lib.msda_bwd_f32, value.device, *ptrs, grad_value.data_ptr(),
                            grad_loc.data_ptr(), grad_attw.data_ptr(), B, N, Q, H, D, L, P)
    else:
        tiled = Q == N
        grad_value = torch.empty(value.shape, dtype=torch.bfloat16, device=value.device)
        work = (torch.empty(value.shape, dtype=torch.float32, device=value.device)
                if tiled or bwd_bf16_segments(Q, P) > 1 else None)
        err = _build.launch(lib.msda_bwd_bf16, value.device, *ptrs, grad_value.data_ptr(),
                            grad_loc.data_ptr(), grad_attw.data_ptr(),
                            None if work is None else work.data_ptr(), B, N, Q, H, D, L, P,
                            int(tiled), len(bwd_bf16_plan(shapes, tiled)))
    _raise_on(lib, fn_name, err)
    if site is not None:
        counts = BWD_LAUNCHES if value.dtype == torch.float32 else BWD_BF16_LAUNCHES
        counts[site] += 1
    return grad_value, grad_loc, grad_attw


class MSDeformAttnFunction(torch.autograd.Function):
    """The CUDA kernels as one differentiable op: forward ``msda_fwd_*``,
    backward ``msda_bwd_f32`` or ``msda_bwd_bf16`` by the value's type."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights,
                site):
        ctx.spatial_shapes = spatial_shapes
        ctx.site = site
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                                   attention_weights, site)

    @staticmethod
    def backward(ctx, grad_output):
        value, loc, attw = ctx.saved_tensors
        grads = ms_deform_attn_bwd_cuda(value, ctx.spatial_shapes, loc, attw,
                                        grad_output.contiguous(), ctx.site)
        return grads[0], None, grads[1], grads[2], None


def ms_deform_attn(value, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations, attention_weights, site: str):
    """Deformable attention for the call site ``site`` (a key of LAUNCHES):
    the plain version for CPU tensors, the CUDA kernels (forward, and backward
    under autograd) for CUDA tensors."""
    if site not in LAUNCHES:
        raise KeyError(site)
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"no deformable-attention path for {value.device}")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return MSDeformAttnFunction.apply(value, shapes, sampling_locations,
                                      attention_weights, site)
