"""The port's plain deformable-attention op against the JAX package's oracle
(``ms_deform_attn_ref``), its XLA gather formulation and its Pallas kernels
run through the Pallas interpreter (banded and fused)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu.ops import deform_attn_pallas as dap
from mdqe_cvpr2023_tpu.ops.deform_attn import (_ms_deform_attn_xla,
                                               ms_deform_attn_ref)
from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da

torch.set_num_threads(2)


@pytest.fixture
def _interpret_mode():
    old = dap._INTERPRET
    dap._INTERPRET = True
    yield
    dap._INTERPRET = old


def _inputs(B, Q, H, D, P, shapes, loc_lo=-0.1, loc_hi=1.1, dtype=np.float64,
            seed=0):
    rng = np.random.default_rng(seed)
    N = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.standard_normal((B, N, H, D)).astype(dtype)
    loc = rng.uniform(loc_lo, loc_hi, (B, Q, H, L, P, 2)).astype(dtype)
    attw = rng.dirichlet(np.ones(L * P), (B, Q, H)).reshape(B, Q, H, L, P)
    return value, loc, attw.astype(dtype)


def _clustered_loc(shapes, B, H, P, rng, scatter=0.08):
    """Encoder-like: the queries are the pixels, sampled near themselves."""
    refs = []
    for h, w in shapes:
        yy, xx = np.mgrid[0:h, 0:w]
        refs.append(np.stack([(xx.ravel() + 0.5) / w, (yy.ravel() + 0.5) / h], -1))
    ref = np.concatenate(refs)
    off = rng.uniform(-scatter, scatter, (B, len(ref), H, len(shapes), P, 2))
    return (ref[None, :, None, None, None, :] + off).astype(np.float32)


# name: (B, Q, H, D, P, shapes, loc range)
F64_CASES = {
    "q_eq_n": (2, 92, 2, 8, 3, ((8, 9), (4, 5)), (-0.1, 1.1)),
    "small_q": (2, 7, 3, 16, 4, ((6, 10), (3, 5), (2, 2)), (-0.1, 1.1)),
    "temporal_frames": (2, 11, 2, 8, 4, ((5, 7),) * 4, (-0.1, 1.1)),
    "out_of_range": (1, 13, 2, 8, 4, ((6, 4), (3, 2)), (-1.5, 2.5)),
}


@pytest.mark.parametrize("oracle", ["ref", "xla"])
@pytest.mark.parametrize("case", sorted(F64_CASES))
def test_plain_matches_jax_f64(case, oracle):
    """f64 end to end, so only summation order differs: 1e-10."""
    B, Q, H, D, P, shapes, (lo, hi) = F64_CASES[case]
    value, loc, attw = _inputs(B, Q, H, D, P, shapes, lo, hi)
    got = da.ms_deform_attn_plain(torch.from_numpy(value), shapes,
                                  torch.from_numpy(loc), torch.from_numpy(attw))
    assert got.dtype == torch.float64 and got.shape == (B, Q, H * D)
    fn = ms_deform_attn_ref if oracle == "ref" else _ms_deform_attn_xla
    want = np.asarray(fn(jnp.asarray(value), shapes, jnp.asarray(loc),
                         jnp.asarray(attw)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_dispatcher_takes_plain_version_on_cpu():
    shapes = ((6, 8), (3, 4))
    value, loc, attw = (torch.from_numpy(a) for a in
                        _inputs(1, 10, 2, 8, 2, shapes, dtype=np.float32))
    da.reset_launches()
    got = da.ms_deform_attn(value, shapes, loc, attw, site="encoder")
    torch.testing.assert_close(got, da.ms_deform_attn_plain(value, shapes, loc, attw),
                               rtol=0, atol=0)
    assert da.LAUNCHES == {"encoder": 0, "decoder_box": 0, "decoder_inst": 0}
    with pytest.raises(KeyError):
        da.ms_deform_attn(value, shapes, loc, attw, site="nowhere")


BANDED_SHAPES = ((24, 40), (12, 20))  # level 0 is row-banded in the Pallas kernel


@pytest.mark.parametrize("loc_mode", ["clustered", "scattered"])
def test_plain_matches_pallas_banded_interpret(_interpret_mode, loc_mode):
    """fp32 Pallas compute (hats and V rounded nowhere): 1e-4."""
    rng = np.random.default_rng(3)
    B, H, D, P = 1, 2, 32, 4
    N = sum(h * w for h, w in BANDED_SHAPES)
    L = len(BANDED_SHAPES)
    value = rng.standard_normal((B, N, H, D)).astype(np.float32)
    if loc_mode == "clustered":
        loc = _clustered_loc(BANDED_SHAPES, B, H, P, rng)
    else:
        loc = rng.uniform(-0.1, 1.1, (B, N, H, L, P, 2)).astype(np.float32)
    attw = rng.dirichlet(np.ones(L * P), (B, N, H)).reshape(B, N, H, L, P)
    attw = attw.astype(np.float32)
    want = np.asarray(dap.ms_deform_attn_pallas(
        jnp.asarray(value), BANDED_SHAPES, jnp.asarray(loc), jnp.asarray(attw),
        dap.Q_TILE, "float32", True))
    got = da.ms_deform_attn_plain(torch.from_numpy(value), BANDED_SHAPES,
                                  torch.from_numpy(loc), torch.from_numpy(attw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_plain_matches_pallas_fused_interpret(_interpret_mode):
    shapes = ((10, 6), (3, 5))
    value, loc, attw = _inputs(1, 70, 2, 32, 4, shapes, dtype=np.float32)
    want = np.asarray(dap.ms_deform_attn_pallas(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attw), 64,
        "float32", False))
    got = da.ms_deform_attn_plain(torch.from_numpy(value), shapes,
                                  torch.from_numpy(loc), torch.from_numpy(attw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
