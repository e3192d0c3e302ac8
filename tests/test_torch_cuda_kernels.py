"""The port's CUDA kernels against their plain PyTorch versions, on the card:
deformable attention (forward at every block size, and backward against
autograd of the plain version) and the tensor-core product chain
(``tc_kdepth``).

These tests need an NVIDIA card with nvcc (the kernel has no CPU or interpret
mode): they carry the ``cuda`` marker and skip where no card is present. They
import torch only, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da
from mdqe_cvpr2023_tpu_torch.ops import tc_kdepth as tc

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


# The forward kernel's input grid: D (threads per (query, head) = D / 8), P
# (the point unroll's vector and scalar paths: 4 / 2 per step), L; both value
# types. Locations in [-0.3, 1.3], so corners fall in and out of range.
FWD_GRID = [(D, P, L, vdt) for D in (8, 16, 32, 48, 64) for P in (1, 2, 3, 4)
            for L in (1, 4, 5) for vdt in ("f32", "bf16")]
GRID_SHAPES = ((11, 7), (6, 9), (3, 5), (2, 2), (1, 3))


@pytest.mark.parametrize("D,P,L,vdt", FWD_GRID)
def test_kernel_matches_plain_over_the_input_grid(cuda_device, D, P, L, vdt):
    shapes = GRID_SHAPES[:L]
    B, Q, H = 2, 37, 3
    rng = np.random.default_rng(D * 100 + P * 10 + L)
    value = rng.standard_normal((B, sum(h * w for h, w in shapes), H, D)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (B, Q, H, L, P, 2)).astype(np.float32)
    attw = rng.dirichlet(np.ones(L * P), (B, Q, H)).reshape(B, Q, H, L, P).astype(np.float32)
    v = torch.from_numpy(value).to(cuda_device)
    if vdt == "bf16":
        v = v.to(torch.bfloat16)
    lo, aw = (torch.from_numpy(a).to(cuda_device) for a in (loc, attw))
    want = da.ms_deform_attn_plain(v, shapes, lo, aw)
    got = da.ms_deform_attn_cuda_block(v, shapes, lo, aw, 256, count=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3 if vdt == "bf16" else 1e-4)
    torch.testing.assert_close(da.ms_deform_attn_cuda(v, shapes, lo, aw), want, rtol=0,
                               atol=1e-3 if vdt == "bf16" else 1e-4)


@pytest.mark.parametrize("vdt", ["f32", "bf16"])
def test_kernel_mixed_corners_within_a_warp(cuda_device, vdt):
    """The heads of one query share a warp: odd heads sample well inside the
    level, even heads on or across its border and far outside, so in-range
    and out-of-range corners meet in every warp."""
    shapes = ((9, 13), (4, 6))
    B, Q, H, D, P = 2, 24, 8, 32, 4
    rng = np.random.default_rng(7)
    value = rng.standard_normal((B, 9 * 13 + 4 * 6, H, D)).astype(np.float32)
    loc = rng.uniform(0.2, 0.8, (B, Q, H, 2, P, 2))
    edge = rng.choice([-0.02, 0.0, 1.0, 1.03, -2.0, 3.0], (B, Q, H, 2, P, 2))
    loc[:, :, 0::2] = edge[:, :, 0::2] + rng.uniform(-0.01, 0.01, edge[:, :, 0::2].shape)
    loc = loc.astype(np.float32)
    attw = rng.dirichlet(np.ones(2 * P), (B, Q, H)).reshape(B, Q, H, 2, P).astype(np.float32)
    v = torch.from_numpy(value).to(cuda_device)
    if vdt == "bf16":
        v = v.to(torch.bfloat16)
    lo, aw = (torch.from_numpy(a).to(cuda_device) for a in (loc, attw))
    got = da.ms_deform_attn_cuda(v, shapes, lo, aw)
    want = da.ms_deform_attn_plain(v, shapes, lo, aw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3 if vdt == "bf16" else 1e-4)
    assert float(got.reshape(B, Q, H, D)[:, :, 0::2].abs().max()) > 0  # some border taps


def test_kernel_rejects_misaligned_views_and_d12(cuda_device):
    shapes = ((6, 8),)
    value, loc, attw = _inputs(1, 10, 2, 32, 2, shapes, "uniform")
    v = torch.from_numpy(value).to(cuda_device)
    lo = torch.from_numpy(loc).to(cuda_device)
    aw = torch.from_numpy(attw).to(cuda_device)
    shifted = torch.empty(v.numel() + 1, device=cuda_device)[1:].view(v.shape)
    shifted.copy_(v)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.ms_deform_attn_cuda(shifted, shapes, lo, aw)
    lo_s = torch.empty(lo.numel() + 2, device=cuda_device)[2:].view(lo.shape)
    lo_s.copy_(lo)
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.ms_deform_attn_cuda(v, shapes, lo_s, aw)
    v12 = torch.zeros(1, 48, 2, 12, device=cuda_device)
    with pytest.raises(ValueError, match="D % 8"):
        da.ms_deform_attn_cuda(v12, shapes, lo, aw)
    with pytest.raises(ValueError, match="D % 8"):
        da.ms_deform_attn_cuda_block(v12, shapes, lo, aw, 256)


def test_dispatcher_counts_only_kernel_launches(cuda_device):
    shapes = ((6, 8), (3, 4))
    value, loc, attw = _inputs(1, 10, 2, 32, 2, shapes, "uniform")
    da.reset_launches()
    args = [torch.from_numpy(a).to(cuda_device) for a in (value, loc, attw)]
    da.ms_deform_attn(args[0], shapes, args[1], args[2], site="decoder_box")
    da.ms_deform_attn_cuda(args[0], shapes, args[1], args[2])
    torch.cuda.synchronize()
    assert da.LAUNCHES == {"encoder": 0, "decoder_box": 1, "decoder_inst": 0}
    assert da.BWD_LAUNCHES == {"encoder": 0, "decoder_box": 0, "decoder_inst": 0}
    assert da.BWD_BF16_LAUNCHES == {"encoder": 0, "decoder_box": 0, "decoder_inst": 0}


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


# Backward: (B, Q, H, D, P, shapes, loc mode). Locations up to well outside
# the levels, so zero padding and the far clamp are exercised. Tolerances:
# d(loc) and d(weights) are shuffle sums in another order than autograd's
# (1e-4 of the largest entry); d(value) sums with vector atomics in an order
# that changes from run to run (the same 1e-4).
BWD_CASES = {
    "odd_d16_q70": (2, 70, 2, 16, 4, ((10, 6), (3, 5), (7, 11)), "uniform"),
    "odd_d48": (2, 45, 2, 48, 2, ((9, 4), (2, 11)), "uniform"),
    "far_out": (1, 33, 3, 32, 3, ((9, 13), (5, 4)), "far"),
    "encoder_like": (2, 639, 4, 32, 4, ((24, 20), (12, 10), (6, 5), (3, 3)), "local"),
    "temporal": (2, 40, 4, 32, 4, ((12, 20),) * 4, "uniform"),
}


def _grads_of(fn, value, loc, attw, gout):
    leaves = [t.detach().clone().requires_grad_(True) for t in (value, loc, attw)]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, gout)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_kernel_matches_plain_autograd(cuda_device, case):
    B, Q, H, D, P, shapes, mode = BWD_CASES[case]
    if mode == "far":
        value, _, attw = _inputs(B, Q, H, D, P, shapes, "uniform", seed=1)
        loc = np.random.default_rng(2).uniform(
            -1.5, 2.5, (B, Q, H, len(shapes), P, 2)).astype(np.float32)
    else:
        value, loc, attw = _inputs(B, Q, H, D, P, shapes, mode, seed=1)
    gout = np.random.default_rng(3).standard_normal((B, Q, H * D)).astype(np.float32)
    v, lo, aw, go = (torch.from_numpy(a).to(cuda_device) for a in (value, loc, attw, gout))
    da.reset_launches()
    got = _grads_of(lambda *a: da.ms_deform_attn(a[0], shapes, a[1], a[2], "encoder"),
                    v, lo, aw, go)
    want = _grads_of(lambda *a: da.ms_deform_attn_plain(a[0], shapes, a[1], a[2]),
                     v, lo, aw, go)
    torch.cuda.synchronize()
    assert da.LAUNCHES["encoder"] == 1 and da.BWD_LAUNCHES["encoder"] == 1
    _assert_grads_close(got, want)


def test_backward_takes_noncontiguous_grad_and_rejects_float16(cuda_device):
    shapes = ((6, 8), (3, 4))
    value, loc, attw = _inputs(1, 10, 2, 32, 2, shapes, "uniform")
    v, lo, aw = (torch.from_numpy(a).to(cuda_device) for a in (value, loc, attw))
    gout = torch.randn(64, 10, device=cuda_device).t()  # (10, 64), strided
    got = _grads_of(lambda *a: da.ms_deform_attn(a[0], shapes, a[1], a[2],
                                                 "decoder_box"),
                    v, lo, aw, gout[None])
    want = _grads_of(lambda *a: da.ms_deform_attn_plain(a[0], shapes, a[1], a[2]),
                     v, lo, aw, gout[None])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)
    # bf16 has its own kernel (msda_bwd_bf16, tested below); float16 has none
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        da.ms_deform_attn_bwd_cuda(v.half(), shapes, lo, aw,
                                   torch.zeros(1, 10, 64, device=cuda_device))


# The backward kernel's input grid: D (threads per (query, head) = D / 8,
# padded to a power of two: D = 48 runs groups of 8 with 2 spare threads), P
# (the point pairs' vector and scalar paths), L. Locations in [-0.3, 1.3], so
# corners fall in and out of range. B * Q * H = 222 (query, head) pairs, so
# the last warp is cut short at every D. Tolerance: 1e-4 of each output's
# largest entry (at least 1e-4): the group's shuffle sums run in another
# order than autograd's, and d(value)'s vector atomics in an order that
# changes from run to run.
BWD_GRID = [(D, P, L) for D in (8, 16, 32, 48, 64) for P in (1, 2, 3, 4) for L in (1, 4, 5)]


def _assert_grads_close(got, want):
    for name, g, w in zip(("value", "loc", "attw"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        tol = 1e-4 * max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g, w, rtol=0, atol=tol, msg=name)


def _bwd_check(device, B, Q, H, D, P, shapes, loc, seed):
    rng = np.random.default_rng(seed)
    L = len(shapes)
    value = rng.standard_normal((B, sum(h * w for h, w in shapes), H, D)).astype(np.float32)
    attw = rng.dirichlet(np.ones(L * P), (B, Q, H)).reshape(B, Q, H, L, P).astype(np.float32)
    gout = rng.standard_normal((B, Q, H * D)).astype(np.float32)
    v, lo, aw, go = (torch.from_numpy(a).to(device) for a in (value, loc, attw, gout))
    got = da.ms_deform_attn_bwd_cuda(v, shapes, lo, aw, go)
    want = _grads_of(lambda *a: da.ms_deform_attn_plain(a[0], shapes, a[1], a[2]),
                     v, lo, aw, go)
    torch.cuda.synchronize()
    _assert_grads_close(got, want)
    return got


@pytest.mark.parametrize("D,P,L", BWD_GRID)
def test_backward_kernel_matches_plain_over_the_input_grid(cuda_device, D, P, L):
    shapes = GRID_SHAPES[:L]
    B, Q, H = 2, 37, 3
    loc = np.random.default_rng(D * 100 + P * 10 + L + 1).uniform(
        -0.3, 1.3, (B, Q, H, L, P, 2)).astype(np.float32)
    _bwd_check(cuda_device, B, Q, H, D, P, shapes, loc, seed=D * 100 + P * 10 + L)


def test_backward_mixed_corners_within_a_warp(cuda_device):
    """The backward twin of test_kernel_mixed_corners_within_a_warp: odd heads
    sample well inside the level, even heads on or across its border and far
    outside, so in-range and out-of-range corners meet in every warp (and in
    its shuffles and atomics)."""
    shapes = ((9, 13), (4, 6))
    B, Q, H, D, P = 2, 24, 8, 32, 4
    rng = np.random.default_rng(8)
    loc = rng.uniform(0.2, 0.8, (B, Q, H, 2, P, 2))
    edge = rng.choice([-0.02, 0.0, 1.0, 1.03, -2.0, 3.0], (B, Q, H, 2, P, 2))
    loc[:, :, 0::2] = edge[:, :, 0::2] + rng.uniform(-0.01, 0.01, edge[:, :, 0::2].shape)
    got = _bwd_check(cuda_device, B, Q, H, D, P, shapes, loc.astype(np.float32), seed=9)
    assert float(got[2][:, :, 0::2].abs().max()) > 0  # some border taps have weight


@pytest.mark.parametrize("D", [16, 48, 64])
def test_backward_kernel_with_the_last_warp_cut_short(cuda_device, D):
    """B * Q * H * Gp not a multiple of 32 (39 pairs of 2, 8 or 8 threads):
    the threads past the last pair stay in the shuffles and add nothing."""
    shapes = ((7, 5), (3, 4))
    B, Q, H, P = 1, 13, 3, 4
    assert (B * Q * H * {16: 2, 48: 8, 64: 8}[D]) % 32
    loc = np.random.default_rng(D).uniform(-0.3, 1.3, (B, Q, H, 2, P, 2)).astype(np.float32)
    _bwd_check(cuda_device, B, Q, H, D, P, shapes, loc, seed=D + 1)


# msda_bwd_bf16 (the mixed-precision step's backward) against its oracle:
# autograd of the plain version on f64 copies of the same bf16 value,
# locations, weights and output gradient. d(value): the kernel sums in fp32
# and rounds once to bf16, so its error is within one bf16 step of the
# largest entry (2^-8 of it) and no larger than the plain version's in bf16,
# whose index backward sums in bf16 (or within half a step, 2^-9, where that
# rounds once too). d(loc), d(weights) are fp32: against the plain version
# on the same bf16 value (fp32 arithmetic, the corners it picks are the
# kernel's), 1e-4 of the largest entry as for fp32; the f64 oracle picks
# other corners where a location's product sits on a pixel boundary.
def _bwd_bf16_check(device, B, Q, H, D, P, shapes, loc, seed, site=None):
    rng = np.random.default_rng(seed)
    L = len(shapes)
    value = rng.standard_normal((B, sum(h * w for h, w in shapes), H, D)).astype(np.float32)
    attw = rng.dirichlet(np.ones(L * P), (B, Q, H)).reshape(B, Q, H, L, P).astype(np.float32)
    gout = rng.standard_normal((B, Q, H * D)).astype(np.float32)
    v = torch.from_numpy(value).to(device).bfloat16()
    lo, aw, go = (torch.from_numpy(a).to(device) for a in (loc, attw, gout))
    if site is None:
        got = da.ms_deform_attn_bwd_cuda(v, shapes, lo, aw, go)
    else:
        got = _grads_of(lambda *a: da.ms_deform_attn(a[0], shapes, a[1], a[2], site),
                        v, lo, aw, go)
    plain = _grads_of(lambda *a: da.ms_deform_attn_plain(a[0], shapes, a[1], a[2]),
                      v, lo, aw, go)
    oracle = _grads_of(lambda *a: da.ms_deform_attn_plain(a[0], shapes, a[1], a[2]),
                       v.double(), lo.double(), aw.double(), go.double())
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16 and got[0].shape == v.shape
    assert got[1].dtype == got[2].dtype == torch.float32
    scale = float(oracle[0].abs().max())
    err = float((got[0].double() - oracle[0]).abs().max())
    err_plain = float((plain[0].double() - oracle[0]).abs().max())
    assert err <= 2.0 ** -8 * scale and err <= max(err_plain, 2.0 ** -9 * scale), \
        (err, err_plain, scale)
    for name, g, w in zip(("loc", "attw"), got[1:], plain[1:]):
        tol = 1e-4 * max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g, w, rtol=0, atol=tol, msg=name)
    return got


@pytest.mark.parametrize("D,P,L", BWD_GRID)
def test_backward_bf16_matches_the_oracle_over_the_input_grid(cuda_device, D, P, L):
    shapes = GRID_SHAPES[:L]
    B, Q, H = 2, 37, 3
    loc = np.random.default_rng(D * 100 + P * 10 + L + 2).uniform(
        -0.3, 1.3, (B, Q, H, L, P, 2)).astype(np.float32)
    _bwd_bf16_check(cuda_device, B, Q, H, D, P, shapes, loc, seed=D * 100 + P * 10 + L + 1)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_bf16_through_autograd_counts_its_own_launches(cuda_device, case):
    """A bf16 value through ``ms_deform_attn`` under autograd: the forward
    kernel and msda_bwd_bf16, counted in BWD_BF16_LAUNCHES and not in
    BWD_LAUNCHES (the fp32 kernel's)."""
    B, Q, H, D, P, shapes, mode = BWD_CASES[case]
    if mode == "far":
        loc = np.random.default_rng(2).uniform(
            -1.5, 2.5, (B, Q, H, len(shapes), P, 2)).astype(np.float32)
    else:
        loc = _inputs(B, Q, H, D, P, shapes, mode, seed=1)[1]
    da.reset_launches()
    _bwd_bf16_check(cuda_device, B, Q, H, D, P, shapes, loc, seed=5, site="encoder")
    assert da.LAUNCHES["encoder"] == 1 and da.BWD_BF16_LAUNCHES["encoder"] == 1
    assert sum(da.BWD_LAUNCHES.values()) == 0


# msda_bwd_bf16's tiled kernel (Q == N: the queries are the levels' pixels in
# order; a block serves a 4x8 tile of one level and merges its taps' rows per
# round of 4 points). Levels that are no multiple of the tile (tail tiles),
# every D (24: a spare thread in each group of 4; 48: two in each group of
# 8), P (rounds of 4 points; odd P on the scalar path), encoder-like
# locations and locations spread over a level of more than 512 pixels (a
# bounding box wider than the merge window: one reduction per tap).
TAIL_SHAPES = ((13, 21), (7, 11), (3, 5))     # N = 365; tails of 1 / 5, 3 / 3, 3 / 5
WIDE_SHAPES = ((24, 41), (11, 19))            # N = 1193; 984 pixels at level 0
BF16_TILED_GRID = [(D, P, shapes, mode) for D in (8, 16, 24, 32, 48, 64) for P in (1, 3, 4, 5)
                   for shapes, mode in (("tail", "local"), ("wide", "uniform"))]


@pytest.mark.parametrize("D,P,shapes,mode", BF16_TILED_GRID)
def test_backward_bf16_tiled_over_the_input_grid(cuda_device, D, P, shapes, mode):
    shapes = {"tail": TAIL_SHAPES, "wide": WIDE_SHAPES}[shapes]
    N = sum(h * w for h, w in shapes)
    B, H = 2, 3
    loc = _inputs(B, N, H, D, P, shapes, mode, seed=D + P)[1]
    _bwd_bf16_check(cuda_device, B, N, H, D, P, shapes, loc, seed=D * 10 + P)


def test_backward_bf16_tiled_on_a_crowded_input(cuda_device):
    """Every query of a level samples inside one 2x2 patch, so those rows sum
    Q * P = 2092 taps of a (b, head) each, merged per tile (4 rows, 128 taps
    a row) before their reductions."""
    shapes = ((24, 40), (12, 21), (5, 7))
    N = sum(h * w for h, w in shapes)
    B, H, D, P = 2, 4, 32, 4
    u = np.random.default_rng(11).uniform(0.05, 0.95, (B, N, H, len(shapes), P, 2))
    size = np.array([[w, h] for h, w in shapes], dtype=np.float64)
    loc = ((size // 2)[:, None] + u + 0.5) / size[:, None]
    _bwd_bf16_check(cuda_device, B, N, H, D, P, shapes, loc.astype(np.float32), seed=12)


@pytest.mark.parametrize("D,Q,P", [(32, 256, 4), (32, 257, 4), (16, 700, 4), (48, 300, 3),
                                   (64, 1030, 1)])
def test_backward_bf16_decoder_kernels_over_query_segments(cuda_device, D, Q, P):
    """Q != N: the decoder sites' kernels. Their d(value) kernel stages at
    most 256 queries and 1024 points at a time; past that its partial sums go
    through the fp32 scratch (257 queries of 4 points: two segments; 1030 of
    1: five)."""
    shapes = WIDE_SHAPES
    B, H = 2, 2
    loc = np.random.default_rng(Q).uniform(-0.2, 1.2, (B, Q, H, 2, P, 2)).astype(np.float32)
    _bwd_bf16_check(cuda_device, B, Q, H, D, P, shapes, loc, seed=Q + D)


# Block-size launchers (the kernel tools): every block size and value type at
# a tool-like level and at odd shapes, against the plain version; the same
# tolerances as the main paths' launchers.
BLOCK_CASES = {
    "tune_level": (2, 300, 4, 32, 4, ((12, 20),), "uniform"),
    "odd_d48_q70": (2, 70, 3, 48, 3, ((10, 6), (3, 5)), "uniform"),
    "encoder_like": (2, 639, 4, 32, 4, ((24, 20), (12, 10), (6, 5), (3, 3)), "local"),
}


@pytest.mark.parametrize("vdt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_size_launchers_match_plain(cuda_device, case, vdt):
    B, Q, H, D, P, shapes, mode = BLOCK_CASES[case]
    value, loc, attw = _inputs(B, Q, H, D, P, shapes, mode, seed=4)
    v = torch.from_numpy(value).to(cuda_device)
    if vdt == "bf16":
        v = v.to(torch.bfloat16)
    lo = torch.from_numpy(loc).to(cuda_device)
    aw = torch.from_numpy(attw).to(cuda_device)
    want = da.ms_deform_attn_plain(v, shapes, lo, aw)
    da.reset_launches()
    for t in da.BLOCK_THREADS:
        got = da.ms_deform_attn_cuda_block(v, shapes, lo, aw, t)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3 if vdt == "bf16" else 1e-4)
    assert all(da.BLOCK_LAUNCHES[da.block_variant(v.dtype, t)] == 1
               for t in da.BLOCK_THREADS)
    assert sum(da.BLOCK_LAUNCHES.values()) == len(da.BLOCK_THREADS)
    assert sum(da.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        da.ms_deform_attn_cuda_block(v, shapes, lo, aw, 96)


# tc_kdepth: (M, N, K). Products of bf16 values are exact in fp32; only the
# order of the sums differs: relative 1e-4 of the largest |out|.
TC_CASES = {"k16": (256, 128, 16), "k48_ragged_m": (100, 72, 48), "k256": (192, 264, 256)}


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tc_kdepth_matches_plain(cuda_device, case):
    M, N, K = TC_CASES[case]
    rng = np.random.default_rng(len(case))
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(cuda_device)
    b = b.to(torch.bfloat16)
    tc.reset_launches()
    got = tc.tc_kdepth_cuda(a, b, 48)
    want = tc.tc_kdepth_plain(a, b, 48)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert tc.LAUNCHES == {tc.shape_key(K, N): 1}


# The tile choice (64, 128 or 192 columns), ragged M and N edges, K slices of
# 256 (K = 512), an odd number of products (the last rep has no partner).
TC_GRID = [(M, N, K) for M in (1, 100, 1024) for N in (8, 200, 1000, 1024, 1536)
           for K in (16, 80, 256, 512)]


@pytest.mark.parametrize("M,N,K", TC_GRID)
def test_tc_kdepth_matches_plain_over_the_grid(cuda_device, M, N, K):
    rng = np.random.default_rng(M + 7 * N + 13 * K)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(cuda_device)
    b = b.to(torch.bfloat16)
    got = tc.tc_kdepth_cuda(a, b, 7, count=False)
    want = tc.tc_kdepth_plain(a, b, 7)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_tc_kdepth_rejects_bad_shapes(cuda_device):
    a = torch.zeros(64, 24, device=cuda_device)
    b = torch.zeros(24, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tc.tc_kdepth_cuda(a, b, 4)                       # K % 16
    with pytest.raises(ValueError):
        tc.tc_kdepth_cuda(a[:, :16], b[:16, :60], 4)    # N % 8
    with pytest.raises(TypeError):
        tc.tc_kdepth_cuda(a[:, :16], b[:16].float(), 4)
    shifted = torch.zeros(64 * 16 + 1, device=cuda_device)[1:].view(64, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tc.tc_kdepth_cuda(shifted, b[:16], 4)


# The VIS decode batch (S_BATCH clips of 4 frames at R50 widths) at 360p and
# 720p (N = 5,100 / 15,300 tokens a frame) in a window of 30 / 20 frames: a
# full stride-1 batch (11 distinct frames) and a padded tail (6).
DECODE_GEOMETRY = {"360p": ((384, 640), 30), "720p": ((640, 1152), 20)}
DECODE_BATCHES = {"full": [5 + s for s in range(8)], "padded_tail": [14, 15] + [16] * 6}


@pytest.mark.parametrize("batch", sorted(DECODE_BATCHES))
@pytest.mark.parametrize("res", sorted(DECODE_GEOMETRY))
def test_frame_map_decode_is_bit_equal_to_the_per_clip_decode(cuda_device, monkeypatch, res,
                                                              batch):
    """``decode_clips_batched`` projects each distinct frame once and
    gathers the clips' values: every value the deformable attention takes
    (both sites, each level of the temporal one) is ``torch.equal`` to the
    per-clip projection, masked fill and level copy, and so are the slabs."""
    from mdqe_cvpr2023_tpu_torch.models import attention, meta
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    padded, W = DECODE_GEOMETRY[res]
    cfg = MDQEModelCfg(num_classes=25, n_frames=4)
    model = MDQEModel(cfg, device=cuda_device, seed=0)
    dec = model.detr.transformer_dec
    shapes = meta.spatial_shapes_for(cfg, padded)
    N = sum(h * w for h, w in shapes)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    enc = torch.randn(W, N, cfg.hidden_dim, generator=g, device=cuda_device)
    mflat = torch.rand(W, N, generator=g, device=cuda_device) < 0.1
    M = dec.mask_embed.layers[-1].out_features
    maskf = torch.randn(W, 2 * shapes[0][0], 2 * shapes[0][1], M, generator=g,
                        device=cuda_device)
    offsets, T = DECODE_BATCHES[batch], 4

    values = []
    fwd = attention.ms_deform_attn

    def recorded(value, *args):
        values[-1].append(value)
        return fwd(value, *args)

    monkeypatch.setattr(attention, "ms_deform_attn", recorded)
    with torch.inference_mode():
        values.append([])
        S = len(offsets)
        idx = torch.tensor([o + t for o in offsets for t in range(T)], device=cuda_device)
        out = dec(enc.index_select(0, idx), mflat.index_select(0, idx), shapes, T)
        mfe = maskf.index_select(0, idx)
        want = meta.postprocess_clip(out["cls"], out["mask_coeff"], out["query_embed"],
                                     mfe.reshape(S, T, *mfe.shape[1:]), 0.2, 150)
        values.append([])
        got = meta.decode_clips_batched(model, enc, mflat, maskf, offsets, shapes, T, 0.2, 150)
    torch.cuda.synchronize()
    per_clip, mapped = values
    assert len(per_clip) == len(mapped) == cfg.dec_layers * (1 + len(shapes))
    for k, (a, b) in enumerate(zip(per_clip, mapped)):
        assert a.shape == b.shape and b.is_contiguous(), k
        assert torch.equal(a, b), k
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
