"""Gradients of the port's plain deformable-attention op (autograd of
``ms_deform_attn_plain``, the function the CUDA backward kernel is held to on
the card) against the JAX package: ``jax.vjp`` of its XLA gather formulation in
f64, and its Pallas backward kernels (fused ``_backward`` and banded
``_backward_banded``) run through the Pallas interpreter in fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu.ops import deform_attn_pallas as dap
from mdqe_cvpr2023_tpu.ops.deform_attn import _ms_deform_attn_xla
from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da

torch.set_num_threads(2)


@pytest.fixture
def _interpret_mode():
    old = dap._INTERPRET
    dap._INTERPRET = True
    yield
    dap._INTERPRET = old


def _inputs(B, Q, H, D, P, shapes, lo, hi, dtype, seed):
    rng = np.random.default_rng(seed)
    N = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.standard_normal((B, N, H, D)).astype(dtype)
    loc = rng.uniform(lo, hi, (B, Q, H, L, P, 2)).astype(dtype)
    attw = rng.dirichlet(np.ones(L * P), (B, Q, H)).reshape(B, Q, H, L, P).astype(dtype)
    gout = rng.standard_normal((B, Q, H * D)).astype(dtype)
    return value, loc, attw, gout


def _plain_grads(shapes, value, loc, attw, gout):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (value, loc, attw)]
    out = da.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2], site="encoder")
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(gout))
    return [g.numpy() for g in grads]


# name: (B, Q, H, D, P, shapes, loc range); "q_eq_n" is the encoder's case
F64_CASES = {
    "q_eq_n": (2, 92, 2, 8, 3, ((8, 9), (4, 5)), (-0.1, 1.1)),
    "small_q": (2, 7, 3, 16, 4, ((6, 10), (3, 5), (2, 2)), (-0.1, 1.1)),
    "temporal_frames": (2, 11, 2, 8, 4, ((5, 7),) * 4, (-0.1, 1.1)),
    "out_of_range": (1, 13, 2, 8, 4, ((6, 4), (3, 2)), (-1.5, 2.5)),
}


@pytest.mark.parametrize("case", sorted(F64_CASES))
def test_plain_grads_match_jax_vjp_f64(case):
    """f64 on both sides, so only summation order differs: 1e-10."""
    B, Q, H, D, P, shapes, (lo, hi) = F64_CASES[case]
    value, loc, attw, gout = _inputs(B, Q, H, D, P, shapes, lo, hi, np.float64, 0)
    got = _plain_grads(shapes, value, loc, attw, gout)
    _, vjp = jax.vjp(lambda v, lc, a: _ms_deform_attn_xla(v, shapes, lc, a),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attw))
    want = vjp(jnp.asarray(gout))
    for name, g, w in zip(("value", "loc", "attw"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-10, err_msg=name)
    if case == "out_of_range":  # points wholly outside a level have no gradient
        x = loc[..., 0] * np.asarray([w for _, w in shapes])[:, None] - 0.5
        far = (x < -1) | (x > np.asarray([w for _, w in shapes])[:, None])
        assert far.any() and np.all(got[2][far] == 0) and np.all(got[1][far] == 0)


def test_plain_grads_match_pallas_fused_backward_interpret(_interpret_mode):
    """fp32 Pallas compute (the hats and V rounded nowhere): 1e-4."""
    shapes = ((10, 6), (3, 5))
    value, loc, attw, gout = _inputs(1, 70, 2, 32, 4, shapes, -0.1, 1.1, np.float32, 1)
    got = _plain_grads(shapes, value, loc, attw, gout)
    want = dap._backward(jnp.asarray(value), shapes, jnp.asarray(loc),
                         jnp.asarray(attw), jnp.asarray(gout), 64, "float32")
    for name, g, w in zip(("value", "loc", "attw"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4, err_msg=name)


BANDED_SHAPES = ((24, 40), (12, 20))  # level 0 is row-banded in the Pallas kernel


@pytest.mark.parametrize("loc_mode", ["clustered", "scattered"])
def test_plain_grads_match_pallas_banded_backward_interpret(_interpret_mode, loc_mode):
    """The encoder's case, Q == N. fp32 Pallas compute: 1e-4 (d(loc) entries
    reach a few hundred; they agree to 1e-7 of that)."""
    rng = np.random.default_rng(3)
    B, H, D, P = 1, 2, 32, 4
    L = len(BANDED_SHAPES)
    value, loc, attw, gout = _inputs(B, sum(h * w for h, w in BANDED_SHAPES), H, D, P,
                                     BANDED_SHAPES, -0.1, 1.1, np.float32, 4)
    if loc_mode == "clustered":  # the queries are the pixels, sampled near themselves
        refs = [np.stack([(np.mgrid[0:h, 0:w][1].ravel() + 0.5) / w,
                          (np.mgrid[0:h, 0:w][0].ravel() + 0.5) / h], -1)
                for h, w in BANDED_SHAPES]
        off = rng.uniform(-0.08, 0.08, loc.shape)
        loc = (np.concatenate(refs)[None, :, None, None, None] + off).astype(np.float32)
    assert loc.shape[3] == L
    got = _plain_grads(BANDED_SHAPES, value, loc, attw, gout)
    want = dap._backward_banded(jnp.asarray(value), BANDED_SHAPES, jnp.asarray(loc),
                                jnp.asarray(attw), jnp.asarray(gout), dap.Q_TILE,
                                "float32")
    for name, g, w in zip(("value", "loc", "attw"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4, err_msg=name)


def test_backward_counts_stay_zero_on_cpu():
    shapes = ((6, 8), (3, 4))
    value, loc, attw, gout = _inputs(1, 10, 2, 8, 2, shapes, -0.1, 1.1, np.float32, 5)
    da.reset_launches()
    _plain_grads(shapes, value, loc, attw, gout)
    assert set(da.BWD_LAUNCHES) == set(da.LAUNCHES)
    assert not any(da.LAUNCHES.values()) and not any(da.BWD_LAUNCHES.values())
