"""A chain of bf16 tensor-core products accumulated in fp32: the plain PyTorch
version and the wrapper of the hand-written CUDA kernel
(``csrc/tc_kdepth.cu``), the counterpart of the TPU kernel of
``tools/probe_mxu_kdepth.py``.

Contract:
  a     (M, K) fp32, offset by i and rounded to bf16 for the i-th product
  b     (K, N) bf16
  reps  number of products
  returns (M, N) fp32 = sum_{i < reps} bf16(a + i) @ b

``tc_kdepth_cuda`` takes CUDA tensors only and never falls back: K % 16 == 0,
N % 8 == 0, a fp32 and b bf16, contiguous and 16-byte aligned (the kernel
reads them with vector loads). The shape, type and alignment rules are
checked before the device. Each kernel launch is counted in ``LAUNCHES``
under its ``shape_key``.
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def shape_key(K: int, N: int) -> str:
    return f"K{K}_N{N}"


def tc_kdepth_plain(a, b, reps: int):
    """The products in fp32 on the bf16-rounded operands (exact products, so
    only the order of the sums differs from the kernel)."""
    bf = b.float()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for i in range(reps):
        acc += (a + float(i)).to(torch.bfloat16).float() @ bf
    return acc


def tc_kdepth_cuda(a, b, reps: int, count: bool = True):
    """Launch ``tc_kdepth_bf16`` on the current stream; count the launch in
    ``LAUNCHES`` unless ``count`` is False (comparisons)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not chain")
    M, K = a.shape
    N = b.shape[1]
    if K % 16 or N % 8 or reps < 1:
        raise ValueError(f"kernel takes K % 16 == 0, N % 8 == 0, reps >= 1; got K={K} "
                         f"N={N} reps={reps}")
    if a.dtype != torch.float32 or b.dtype != torch.bfloat16:
        raise TypeError(f"a must be float32 and b bfloat16, got {a.dtype}, {b.dtype}")
    for name, t in (("a", a), ("b", b)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (data_ptr % 16 == 0)")
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name} must be on {a.device}, is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _build.load("tc_kdepth")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.tc_kdepth_bf16(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, reps,
                             stream)
    if err != 0:
        raise RuntimeError(f"tc_kdepth_bf16 launch failed: "
                           f"{lib.tc_error_string(err).decode()} ({err})")
    if count:
        key = shape_key(K, N)
        LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return out
