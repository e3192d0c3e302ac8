"""The port's CUDA deformable-attention kernel against its plain PyTorch
version, on the card.

These tests need an NVIDIA card with nvcc (the kernel has no CPU or interpret
mode): they carry the ``cuda`` marker and skip where no card is present. They
import torch only, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(B, Q, H, D, P, shapes, loc_mode, seed=0):
    rng = np.random.default_rng(seed)
    N = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.standard_normal((B, N, H, D)).astype(np.float32)
    if loc_mode == "local":  # encoder-like: pixel centres + small offsets
        refs = [np.stack([(np.mgrid[0:h, 0:w][1].ravel() + 0.5) / w,
                          (np.mgrid[0:h, 0:w][0].ravel() + 0.5) / h], -1)
                for h, w in shapes]
        ref = np.concatenate(refs)[:Q]
        off = rng.uniform(-0.05, 0.05, (B, Q, H, L, P, 2))
        loc = ref[None, :, None, None, None, :] + off
    else:
        loc = rng.uniform(-0.1, 1.1, (B, Q, H, L, P, 2))
    attw = rng.dirichlet(np.ones(L * P), (B, Q, H)).reshape(B, Q, H, L, P)
    return value, loc.astype(np.float32), attw.astype(np.float32)


# (B, Q, H, D, P, shapes, value dtype, loc mode, atol). fp32 sums differ from
# the plain version only in order (1e-4); bf16 values are exact in both, so
# bf16 differs by order too, over larger magnitudes of summed terms.
CASES = {
    "odd_d16_q70": (2, 70, 2, 16, 4, ((10, 6), (3, 5), (7, 11)), "f32", "uniform", 1e-4),
    "d64": (1, 33, 3, 64, 2, ((9, 13), (5, 4)), "f32", "uniform", 1e-4),
    "temporal": (2, 40, 4, 32, 4, ((12, 20),) * 4, "f32", "uniform", 1e-4),
    "encoder_like_bf16": (2, 639, 4, 32, 4, ((24, 20), (12, 10), (6, 5), (3, 3)),
                          "bf16", "local", 1e-3),
    "encoder_like_f32": (2, 639, 4, 32, 4, ((24, 20), (12, 10), (6, 5), (3, 3)),
                         "f32", "local", 1e-4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda_device, case):
    B, Q, H, D, P, shapes, vdt, mode, atol = CASES[case]
    value, loc, attw = _inputs(B, Q, H, D, P, shapes, mode)
    v = torch.from_numpy(value).to(cuda_device)
    if vdt == "bf16":
        v = v.to(torch.bfloat16)
    lo = torch.from_numpy(loc).to(cuda_device)
    aw = torch.from_numpy(attw).to(cuda_device)
    got = da.ms_deform_attn_cuda(v, shapes, lo, aw)
    want = da.ms_deform_attn_plain(v, shapes, lo, aw)
    torch.cuda.synchronize()
    assert got.shape == (B, Q, H * D) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_dispatcher_counts_only_kernel_launches(cuda_device):
    shapes = ((6, 8), (3, 4))
    value, loc, attw = _inputs(1, 10, 2, 32, 2, shapes, "uniform")
    da.reset_launches()
    args = [torch.from_numpy(a).to(cuda_device) for a in (value, loc, attw)]
    da.ms_deform_attn(args[0], shapes, args[1], args[2], site="decoder_box")
    da.ms_deform_attn_cuda(args[0], shapes, args[1], args[2])
    torch.cuda.synchronize()
    assert da.LAUNCHES == {"encoder": 0, "decoder_box": 1, "decoder_inst": 0}


def test_wrapper_rejects_bad_input(cuda_device):
    shapes = ((6, 8),)
    value, loc, attw = _inputs(1, 10, 2, 32, 2, shapes, "uniform")
    v = torch.from_numpy(value).to(cuda_device)
    lo = torch.from_numpy(loc).to(cuda_device)
    aw = torch.from_numpy(attw).to(cuda_device)
    with pytest.raises(TypeError):
        da.ms_deform_attn_cuda(v.half(), shapes, lo, aw)
    with pytest.raises(ValueError):
        da.ms_deform_attn_cuda(v, ((6, 7),), lo, aw)
    with pytest.raises(ValueError):
        da.ms_deform_attn_cuda(v, shapes, lo.transpose(1, 2), aw)
