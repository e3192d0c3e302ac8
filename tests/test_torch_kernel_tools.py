"""The plain versions of the port's kernel tools against the JAX tools' own
Pallas kernels in interpret mode, on the CPU.

The JAX tool scripts (tools/tune_deform_kernel.py, probe_band_primitives.py,
probe_mxu_kdepth.py) run their sweeps when imported, so each is parsed with
``ast`` and only its imports and the named function definitions are
executed; its module constants are set here, and ``pl.pallas_call`` runs
with ``interpret=True``.

Tolerances: the tune and probe kernels round to bf16 inside (hats, value and
the intermediate product), so the port's fp32 plain version is held to them
at 2e-2 of the largest |out| (the probe tool's own gate); against JAX's
``ms_deform_attn(impl="xla")`` on the same locations, fp32 on both sides, at
1e-5. The depth probe's products of bf16 values are exact in fp32 and only the
order of the sums differs: relative 1e-4."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mdqe_cvpr2023_tpu.ops.deform_attn import ms_deform_attn as jax_ms_deform_attn
from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da
from mdqe_cvpr2023_tpu_torch.ops import tc_kdepth as tc
from mdqe_cvpr2023_tpu_torch.tools import probe_band_primitives as pbp
from mdqe_cvpr2023_tpu_torch.tools import probe_mxu_kdepth as pmk
from mdqe_cvpr2023_tpu_torch.tools import tune_deform_kernel as tdk

torch.set_num_threads(2)

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _load_tool(name: str, functions, **constants):
    """Exec the imports and the named function definitions of tools/<name>.py
    (nothing else) in a namespace that holds ``constants``."""
    tree = ast.parse((TOOLS / name).read_text())
    keep = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom))
            or (isinstance(n, ast.FunctionDef) and n.name in functions)]
    ns = dict(constants)
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(TOOLS / name), "exec"), ns)
    missing = set(functions) - set(ns)
    assert not missing, missing
    return ns


def _rel_err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


# ---- row 7: tools/tune_deform_kernel.py (one level of the hat-matmul) --------

# (h, w, Qt): the encoder's level 2 and 3 shapes at a small batch and query count
TUNE_CASES = {"12x20": (12, 20, 64), "6x10": (6, 10, 32)}


@pytest.mark.parametrize("case", sorted(TUNE_CASES))
def test_tune_level_plain_matches_tool_kernel(case):
    h, w, qt = TUNE_CASES[case]
    heads, bh, q, d, p = 2, 4, 128, 8, 4
    ns = _load_tool("tune_deform_kernel.py", ["make"])
    v_cm, g = tdk.tool_inputs(h, w, seed=3, bh=bh, q=q, d=d, p=p)
    g[:, 2 * p:] = np.random.default_rng(4).random((bh, p, q))  # weights in [0, 1)
    comb = (jax.lax.broadcasted_iota(jnp.int32, (d * w, d), 0) // w
            == jax.lax.broadcasted_iota(jnp.int32, (d * w, d), 1)).astype(jnp.bfloat16)
    f = pl.pallas_call(
        ns["make"](h, w, d, p, qt, True),
        out_shape=jax.ShapeDtypeStruct((bh, q, d), jnp.float32),
        grid=(bh, q // qt),
        in_specs=[pl.BlockSpec((1, 3 * p, qt), lambda b, i: (b, 0, i)),
                  pl.BlockSpec((1, h, d * w), lambda b, i: (b, 0, 0)),
                  pl.BlockSpec((d * w, d), lambda b, i: (0, 0))],
        out_specs=pl.BlockSpec((1, qt, d), lambda b, i: (b, i, 0)),
        interpret=True)
    want = np.asarray(f(jnp.asarray(g), jnp.asarray(v_cm), comb), np.float64)

    value, loc, attw = (torch.from_numpy(a) for a in
                        tdk.to_port_layout(v_cm, g, h, w, heads=heads))
    assert value.shape == (bh // heads, h * w, heads, d)
    assert loc.shape == (bh // heads, q, heads, 1, p, 2)
    out = da.ms_deform_attn_plain(value, ((h, w),), loc, attw)
    got = tdk.from_port_output(out, heads=heads).numpy()
    assert _rel_err(got, want) <= 2e-2

    xla = jax_ms_deform_attn(jnp.asarray(value.numpy()), ((h, w),), jnp.asarray(loc.numpy()),
                             jnp.asarray(attw.numpy()), impl="xla")
    xla = np.asarray(xla, np.float64)
    assert np.abs(out.numpy() - xla).max() <= 1e-5 * max(1.0, np.abs(xla).max())


def test_tune_layout_round_trip():
    """The value layout conversion is a pure permutation, and pixel
    coordinate g lands on loc * size - 0.5 = g."""
    h, w, heads = 3, 5, 2
    v_cm, g = tdk.tool_inputs(h, w, seed=0, bh=4, q=6, d=4, p=2)
    value, loc, _ = tdk.to_port_layout(v_cm, g, h, w, heads=heads)
    # value[b, y*w + x, head, d] == v_cm[b*heads + head, y, d*w + x]
    assert value[1, 2 * w + 3, 1, 2] == v_cm[3, 2, 2 * w + 3]
    np.testing.assert_allclose(loc[1, 4, 1, 0, 1, 0] * w - 0.5, g[3, 2 + 1, 4], atol=1e-5)
    np.testing.assert_allclose(loc[1, 4, 1, 0, 1, 1] * h - 0.5, g[3, 1, 4], atol=1e-5)


# ---- row 8: tools/probe_band_primitives.py (one-point gather) ------------------

@pytest.fixture(scope="module")
def probe_tool():
    ns = _load_tool("probe_band_primitives.py", ["kernel", "run", "oracle"],
                    D=pbp.D, H=pbp.H, W=pbp.W, WD=pbp.W * pbp.D, BY=32, BX=32,
                    BXD=32 * pbp.D, Qt=pbp.QT, INTERPRET=True)
    return ns


@pytest.mark.parametrize("spread", pbp.SPREADS)
def test_probe_plain_matches_tool_kernel_and_oracle(probe_tool, spread):
    v, gs = pbp.probe_inputs()
    g = gs[spread]
    want = np.asarray(probe_tool["run"](jnp.asarray(g), jnp.asarray(v)), np.float64)
    value, loc, attw = (torch.from_numpy(a) for a in pbp.to_port_layout(g, v))
    out = da.ms_deform_attn_plain(value, pbp.SHAPES, loc, attw)
    got = out.reshape(want.shape).numpy()
    assert _rel_err(got, want) <= 2e-2
    # the port's oracle is the tool's, at the coordinates the port samples
    eff = pbp.effective_coords(g)
    np.testing.assert_allclose(pbp.oracle(eff, v), probe_tool["oracle"](eff, v), rtol=0,
                               atol=1e-12)
    assert np.abs(eff - g).max() <= 1e-5 * max(pbp.H, pbp.W)
    assert _rel_err(got, pbp.oracle(eff, v)) <= 1e-5
    xla = np.asarray(jax_ms_deform_attn(jnp.asarray(value.numpy()), pbp.SHAPES,
                                        jnp.asarray(loc.numpy()), jnp.asarray(attw.numpy()),
                                        impl="xla"), np.float64)
    assert np.abs(out.numpy() - xla).max() <= 1e-5 * max(1.0, np.abs(xla).max())
    lib = pbp.grid_sample_probe(value, loc).reshape(want.shape).numpy()
    assert _rel_err(lib, pbp.oracle(eff, v)) <= 1e-5


# ---- row 9: tools/probe_mxu_kdepth.py (bf16 product chain) ---------------------

@pytest.mark.parametrize("K", [16, 48])
def test_kdepth_plain_matches_tool_kernel(K):
    M, N, reps = 128, 64, 48
    ns = _load_tool("probe_mxu_kdepth.py", ["make_kernel"], M=M, REPS=reps)
    rng = np.random.default_rng(K)
    a = (0.01 * rng.standard_normal((M, K))).astype(np.float32)
    a[:, :3] += rng.standard_normal((M, 3)).astype(np.float32)  # some rows unlike others
    b = jnp.asarray(rng.standard_normal((K, N)).astype(np.float32)).astype(jnp.bfloat16)
    f = pl.pallas_call(
        ns["make_kernel"](K, N),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        grid=(1,),
        in_specs=[pl.BlockSpec((M, K), lambda i: (0, 0)),
                  pl.BlockSpec((K, N), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((M, N), lambda i: (0, 0)),
        interpret=True)
    want = np.asarray(f(jnp.asarray(a), b), np.float64)
    b_t = torch.from_numpy(np.array(b.astype(jnp.float32))).to(torch.bfloat16)
    got = tc.tc_kdepth_plain(torch.from_numpy(a), b_t, reps)
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= 1e-4


def test_kdepth_tool_operands_and_yardstick():
    """The port tool's operands are the TPU tool's, and its cuBLAS form (one
    product over the concatenated depth) computes the same function."""
    a, b = pmk.operands(16, 64, "cpu")
    A = np.random.default_rng(0).standard_normal((16, 128)).astype(np.float32)
    np.testing.assert_array_equal(a.numpy(), np.tile(A[:, :1], (1, pmk.M)).T * np.float32(0.01))
    stk = pmk.stacked_lhs(a)
    assert stk.shape == (pmk.REPS * pmk.M, 16) and stk.dtype == torch.bfloat16
    cat = stk.reshape(pmk.REPS, pmk.M, 16).permute(1, 0, 2).reshape(pmk.M, -1)
    want = tc.tc_kdepth_plain(a, b, pmk.REPS)
    got = cat.float() @ b.repeat(pmk.REPS, 1).float()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


def test_tool_wrappers_raise_on_cpu_tensors():
    a, b = pmk.operands(16, 64, "cpu")
    with pytest.raises(ValueError):
        tc.tc_kdepth_cuda(a, b, 2)
    with pytest.raises(ValueError):
        tc.tc_kdepth_cuda(a[:, :15], b[:15], 2)
    v, gs = pbp.probe_inputs()
    value, loc, attw = (torch.from_numpy(x) for x in pbp.to_port_layout(gs["tight"], v))
    with pytest.raises(ValueError):
        da.ms_deform_attn_cuda_block(value, pbp.SHAPES, loc, attw, 256)
