"""The CUDA kernels' input rules, held by their wrappers on the CPU.

The deformable-attention kernels read and write 8 channels a thread with
16-byte vector loads and atomics, and ``tc_kdepth`` reads its operands with
vector loads, so their wrappers raise on D % 8 != 0 and on tensors that are
not 16-byte aligned (a contiguous view at an offset may not be), the
backward's output gradient included, for either value type (the bf16
backward is the mixed-precision step's). Those rules depend only on shapes,
types and data pointers and are checked before the device, so they hold here
on CPU tensors; tensors that pass them fail on the device check instead (no
fallback to the plain version).
"""
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da
from mdqe_cvpr2023_tpu_torch.ops import tc_kdepth as tc

SHAPES = ((6, 8), (3, 4))
N = 6 * 8 + 3 * 4


def _inputs(D=32, H=2, Q=5, P=4, dtype=torch.float32):
    rng = np.random.default_rng(0)
    value = torch.from_numpy(rng.standard_normal((1, N, H, D)).astype(np.float32)).to(dtype)
    loc = torch.from_numpy(rng.uniform(0, 1, (1, Q, H, 2, P, 2)).astype(np.float32))
    attw = torch.full((1, Q, H, 2, P), 1.0 / (2 * P))
    return value, loc, attw


def _shifted(t, elems):
    """A contiguous copy of ``t`` whose data starts ``elems`` elements past an
    aligned allocation."""
    out = torch.empty(t.numel() + elems, dtype=t.dtype)[elems:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("D", [4, 12, 20, 33, 72])
def test_forward_rejects_d_not_a_multiple_of_8_or_above_64(D):
    value, loc, attw = _inputs(D=D)
    with pytest.raises(ValueError, match="D % 8"):
        da._check_kernel_inputs(value, SHAPES, loc, attw)
    with pytest.raises(ValueError, match="D % 8"):
        da.ms_deform_attn_cuda(value, SHAPES, loc, attw)


@pytest.mark.parametrize("D", [8, 16, 48, 64])
def test_forward_takes_d_multiple_of_8_up_to_the_device_check(D):
    value, loc, attw = _inputs(D=D)
    with pytest.raises(ValueError, match="must be on"):
        da._check_kernel_inputs(value, SHAPES, loc, attw)


@pytest.mark.parametrize("which,elems", [("value", 1), ("value", 2), ("locations", 1),
                                         ("locations", 2), ("weights", 3)])
def test_forward_rejects_misaligned_views(which, elems):
    value, loc, attw = _inputs()
    args = {"value": value, "locations": loc, "weights": attw}
    args[which] = _shifted(args[which], elems)
    assert args[which].is_contiguous() and args[which].data_ptr() % 16
    with pytest.raises(ValueError, match=f"{which} must be 16-byte aligned"):
        da._check_kernel_inputs(args["value"], SHAPES, args["locations"], args["weights"])
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.ms_deform_attn_cuda_block(args["value"], SHAPES, args["locations"],
                                     args["weights"], 256)


def test_forward_takes_an_aligned_view_at_an_offset():
    """A bf16 view 8 elements (16 bytes) into its allocation is aligned."""
    value, loc, attw = _inputs(dtype=torch.bfloat16)
    view = _shifted(value, 8)
    assert view.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="must be on"):
        da._check_kernel_inputs(view, SHAPES, loc, attw)


@pytest.mark.parametrize("D", [12, 72])
def test_backward_applies_the_same_rules(D):
    value, loc, attw = _inputs(D=D)
    gout = torch.zeros(1, 5, 2 * D)
    with pytest.raises(ValueError, match="D % 8"):
        da.ms_deform_attn_bwd_cuda(value, SHAPES, loc, attw, gout)


def test_backward_takes_d48_up_to_the_device_check():
    """D = 48: 6 threads a (query, head), padded to a group of 8 in the kernel."""
    value, loc, attw = _inputs(D=48)
    with pytest.raises(ValueError, match="must be on"):
        da.ms_deform_attn_bwd_cuda(value, SHAPES, loc, attw, torch.zeros(1, 5, 2 * 48))


@pytest.mark.parametrize("elems", [1, 2, 3])
def test_backward_rejects_a_misaligned_grad_output_view(elems):
    """The backward kernel reads the output gradient as float4 vectors."""
    value, loc, attw = _inputs()
    gout = _shifted(torch.zeros(1, 5, 2 * 32), elems)
    assert gout.is_contiguous() and gout.data_ptr() % 16
    with pytest.raises(ValueError, match="grad_output must be 16-byte aligned"):
        da.ms_deform_attn_bwd_cuda(value, SHAPES, loc, attw, gout)


def test_backward_rejects_a_misaligned_value_view():
    value, loc, attw = _inputs()
    gout = torch.zeros(1, 5, 2 * 32)
    with pytest.raises(ValueError, match="value must be 16-byte aligned"):
        da.ms_deform_attn_bwd_cuda(_shifted(value, 1), SHAPES, loc, attw, gout)


@pytest.mark.parametrize("D", [12, 20, 72])
def test_backward_bf16_applies_the_same_rules(D):
    """The bf16 backward (msda_bwd_bf16, the AMP step's) reads 8 bf16 channels
    as one 16-byte vector: the same D rule."""
    value, loc, attw = _inputs(D=D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D % 8"):
        da.ms_deform_attn_bwd_cuda(value, SHAPES, loc, attw, torch.zeros(1, 5, 2 * D))


@pytest.mark.parametrize("elems", [1, 2, 4])
def test_backward_bf16_rejects_a_misaligned_value_view(elems):
    """A bf16 view 1, 2 or 4 elements (2, 4 or 8 bytes) into its allocation
    is not 16-byte aligned."""
    value, loc, attw = _inputs(dtype=torch.bfloat16)
    view = _shifted(value, elems)
    assert view.is_contiguous() and view.data_ptr() % 16
    with pytest.raises(ValueError, match="value must be 16-byte aligned"):
        da.ms_deform_attn_bwd_cuda(view, SHAPES, loc, attw, torch.zeros(1, 5, 2 * 32))


def test_backward_bf16_aligned_value_reaches_the_device_check():
    """bf16 at D = 16 and 48, and a bf16 view 8 elements (16 bytes) in: the
    rules pass, and the CPU tensors fail on the device check (no fallback)."""
    for D, elems in ((16, 0), (48, 0), (32, 8)):
        value, loc, attw = _inputs(D=D, dtype=torch.bfloat16)
        value = _shifted(value, elems) if elems else value
        with pytest.raises(ValueError, match="must be on"):
            da.ms_deform_attn_bwd_cuda(value, SHAPES, loc, attw, torch.zeros(1, 5, 2 * D))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_backward_rejects_a_value_type_it_has_no_kernel_for(dtype):
    """Only float32 (msda_bwd_f32) and bfloat16 (msda_bwd_bf16) values have
    a backward kernel; the type is checked before anything else."""
    value, loc, attw = _inputs(dtype=dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        da.ms_deform_attn_bwd_cuda(value, SHAPES, loc, attw, torch.zeros(1, 5, 2 * 32))


def test_bwd_split_finds_the_backward_scatter_in_the_source():
    """``chip_smoke.py --bwd-split`` rewrites the backward kernels' d(value)
    scatters by text (plain stores; nothing): the source holds msda_bwd_f32's
    vector reductions once and msda_bwd_bf16's merged-row reductions once
    (the earlier lane atomics not at all), and the bf16 entry point and tile
    constants as the split's variants expect them."""
    import chip_smoke
    from mdqe_cvpr2023_tpu_torch.ops import _build
    src = (_build.CSRC / "ms_deform_attn.cu").read_text()
    assert [src.count(sc[0]) for sc in chip_smoke.SCATTERS] == [1, 0, 1]
    assert src.count(chip_smoke.BF16_ENTRY) == 1 and src.count(chip_smoke.BF16_TILE_TEXT) == 1
    for sc in chip_smoke.SCATTERS:  # no entry's text is part of another's
        assert sum(sc[0] in other[0] for other in chip_smoke.SCATTERS) == 1


def test_bwd_split_variants_find_their_constants():
    """Each of ``--bwd-split``'s msda_bwd_bf16 variants replaces constants
    that the source holds once, so every variant differs from the source."""
    import chip_smoke
    from mdqe_cvpr2023_tpu_torch.ops import _build
    src = (_build.CSRC / "ms_deform_attn.cu").read_text()
    for name, (tile, changes) in chip_smoke.BF16_VARIANTS.items():
        assert changes and all(src.count(old) == 1 for old in changes), name
        assert len(tile) == 2 and tile[0] * tile[1] >= 32, name


def _square(D=32, dtype=torch.bfloat16):
    """Inputs with Q == N (the encoder's layout, where msda_bwd_bf16 runs its
    tiled kernel) on SHAPES."""
    value, _, _ = _inputs(D=D, dtype=dtype)
    loc = torch.rand(1, N, 2, 2, 4, 2)
    return value, loc, torch.full((1, N, 2, 2, 4), 0.125), torch.zeros(1, N, 2 * D)


@pytest.mark.parametrize("D", [8, 24, 48, 64])
def test_backward_bf16_at_q_equal_n_reaches_the_device_check(D):
    """The encoder's layout takes the same rules, D = 24 and 48 with spare
    threads in their groups: CPU tensors then fail on the device check (no
    fallback)."""
    value, loc, attw, gout = _square(D=D)
    with pytest.raises(ValueError, match="must be on"):
        da.ms_deform_attn_bwd_cuda(value, SHAPES, loc, attw, gout)


@pytest.mark.parametrize("D", [12, 20])
def test_backward_bf16_at_q_equal_n_applies_the_d_rule(D):
    value, loc, attw, gout = _square(D=D)
    with pytest.raises(ValueError, match="D % 8"):
        da.ms_deform_attn_bwd_cuda(value, SHAPES, loc, attw, gout)


@pytest.mark.parametrize("which", ["a", "b"])
def test_tc_kdepth_rejects_misaligned_operands(which):
    a = torch.zeros(64, 32)
    b = torch.zeros(32, 128, dtype=torch.bfloat16)
    ops = {"a": a, "b": b}
    ops[which] = _shifted(ops[which], 2 if which == "a" else 4)
    assert ops[which].data_ptr() % 16
    with pytest.raises(ValueError, match=f"{which} must be 16-byte aligned"):
        tc.tc_kdepth_cuda(ops["a"], ops["b"], 3)


@pytest.mark.parametrize("K,N", [(24, 128), (32, 60), (8, 64)])
def test_tc_kdepth_rejects_shapes(K, N):
    with pytest.raises(ValueError, match="K % 16"):
        tc.tc_kdepth_cuda(torch.zeros(64, K), torch.zeros(K, N, dtype=torch.bfloat16), 3)


def test_tc_kdepth_aligned_operands_reach_the_device_check():
    a = _shifted(torch.zeros(64, 32), 4)  # 16 bytes in: aligned
    with pytest.raises(ValueError, match="must be on"):
        tc.tc_kdepth_cuda(a, torch.zeros(32, 128, dtype=torch.bfloat16), 3)
