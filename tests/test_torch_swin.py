"""The port's Swin backbone (``models/swin.py``) against the JAX package's
``swin_apply`` on the CPU, with the same weights (``swin_init`` plus noise,
loaded by name) and inputs from a numpy seed.

A tiny geometry (embed 32, depths 2-2-2, heads 2-4-8, window 4) on 42x53
frames: the patch grid (11x14) and every stage's grid are not multiples of
the window, so the padding, the shift masks on the padded grid and the odd
patch merges all run. Bounds: fp32 max |err| <= 1e-4 on outputs of size ~4
(measured: 1e-5 at most). bf16 against bf16 (the cast of ``bf16_encode``):
the port's bf16 output is as close to the fp32 output as the JAX package's
bf16 output is (RMS error at most 1.2 times JAX's; measured at most 1.03
times over 8 inputs), and max |err| / max |JAX output| <= 5e-2 for v1
(measured 0.017 at most) and 1e-1 for v2. v2's post-norm cosine attention
rounds q.k in bf16 on both sides: JAX's own bf16 output lies up to 0.061
(max) and 0.041 (RMS) of its scale from its fp32 output at this geometry,
and the two bf16 runs round independently (measured: up to 0.089 apart, on
the input used here, the worst of 8). Stochastic depth cannot draw the same
numbers in the two frameworks, so parity holds at rate 0 and in eval, and at
rate > 0 the mask, the scale and the per-block rates are checked."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mdqe_cvpr2023_tpu.models import MDQEModelCfg as JaxModelCfg
from mdqe_cvpr2023_tpu.models import swin as jswin
from mdqe_cvpr2023_tpu_torch.engine.weights import jax_tree_to_state_dict
from mdqe_cvpr2023_tpu_torch.models import swin as tswin
from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg, is_frozen
from mdqe_cvpr2023_tpu_torch.utils import nn as tnn

torch.set_num_threads(2)

TINY = dict(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 8), window_size=4)
PREFIX = "detr.backbone.0.backbone."


def _pair(**kw):
    """The JAX tree (swin_init plus noise, so that the zero q / v biases and
    the constant logit scale take part) and the port's module holding it."""
    jc = jswin.SwinCfg(**kw)
    rng = np.random.default_rng(1)
    tree = jax.tree.map(np.asarray, jswin.swin_init(jax.random.PRNGKey(0), jc))
    tree = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)
    model = tswin.SwinTransformer(tswin.SwinCfg(**kw))
    sd = {k[len(PREFIX):]: torch.from_numpy(np.array(v))
          for k, v in jax_tree_to_state_dict({"backbone": tree}).items()}
    model.load_state_dict(sd, strict=True)
    return jc, tree, model


def _frames(seed=2):
    return np.random.default_rng(seed).standard_normal((2, 42, 53, 3)).astype(np.float32)


def _port(model, x, params=None, generator=None):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        if params is None:
            outs = model(xt, generator)
        else:
            outs = torch.func.functional_call(model, params, (xt.to(torch.bfloat16),))
    return [o.permute(0, 2, 3, 1).float().numpy() for o in outs]


@pytest.mark.parametrize("ape", [False, True], ids=["no_ape", "ape"])
@pytest.mark.parametrize("version", [2, 1], ids=["v2", "v1"])
def test_swin_matches_swin_apply(version, ape):
    kw = dict(TINY, version=version, ape=ape, pretrain_img_size=32)
    jc, tree, model = _pair(**kw)
    x = _frames()
    want = [np.asarray(o) for o in jswin.swin_apply(tree, jnp.asarray(x), jc)]
    got = _port(model, x)
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (2, 11, 14, 32), (2, 6, 7, 64), (2, 3, 4, 128)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("version", [2, 1], ids=["v2", "v1"])
def test_swin_bf16_matches_swin_apply_bf16(version, monkeypatch):
    """Every floating parameter in bf16 on both sides (the port's through
    ``functional_call``, as ``inference_vis`` runs its encode), bf16 frames.
    The port's shape constants are fp32 and every softmax (the attention
    logits after the bias and the mask) takes fp32."""
    jc, tree, model = _pair(**dict(TINY, version=version))
    x = _frames(3)
    tree16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    want = [np.asarray(o.astype(jnp.float32))
            for o in jswin.swin_apply(tree16, jnp.asarray(x, jnp.bfloat16), jc)]
    params16 = {n: t.bfloat16() for n, t in model.named_parameters()}
    assert not list(model.buffers())
    softmax_in = []
    softmax = torch.softmax

    def spy(t, *args, **kw):
        softmax_in.append(t.dtype)
        return softmax(t, *args, **kw)

    monkeypatch.setattr(torch, "softmax", spy)
    got = _port(model, x, params16)
    assert softmax_in and set(softmax_in) == {torch.float32}
    for fn, args in ((tswin.coords_table, (4, 4)), (tswin.shift_attn_mask, (12, 16, 4, 2)),
                     (tswin.bicubic_matrix, (11, 8))):
        assert tswin._const(fn, args, "cpu").dtype == torch.float32
    want32 = [np.asarray(o) for o in jswin.swin_apply(tree, jnp.asarray(x), jc)]

    def rel_rms(a, b):
        return np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean())

    for g, w, w32 in zip(got, want, want32):
        assert np.isfinite(g).all()
        assert rel_rms(g, w32) <= 1.2 * rel_rms(w, w32)
        assert np.abs(g - w).max() / np.abs(w).max() <= (5e-2 if version == 1 else 1e-1)


def test_shape_constants_equal_jax():
    for wh, ww in ((4, 4), (12, 12), (6, 6), (3, 5)):
        np.testing.assert_array_equal(tswin.coords_table(wh, ww),
                                      jswin._coords_table(wh, ww)[0])
        np.testing.assert_array_equal(tswin.rel_pos_index(wh, ww),
                                      jswin._rel_pos_index(wh, ww).reshape(-1))
    for args in ((12, 16, 4, 2), (24, 36, 12, 6), (8, 8, 2, 1)):
        np.testing.assert_array_equal(tswin.shift_attn_mask(*args),
                                      jswin._shift_attn_mask(*args))
    for n_out, n_in in ((11, 8), (120, 96), (5, 8)):
        np.testing.assert_array_equal(tswin.bicubic_matrix(n_out, n_in),
                                      jswin._bicubic_matrix(n_out, n_in))


def test_ape_resize_is_torch_bicubic():
    """The APE resize by the dense matrices equals F.interpolate's bicubic
    (align_corners=False), up and down."""
    ape = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 8, 12, 12))
                           .astype(np.float32))
    for size in ((30, 54), (7, 5)):
        ky = torch.from_numpy(tswin.bicubic_matrix(size[0], 12))
        kx = torch.from_numpy(tswin.bicubic_matrix(size[1], 12))
        got = torch.einsum("hH,cHW,wW->chw", ky, ape[0], kx)
        want = F.interpolate(ape, size=size, mode="bicubic", align_corners=False)[0]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_drop_path_keeps_whole_samples_at_its_rate():
    x = torch.ones(4000, 3, 5, 2)
    assert tnn.drop_path(x, 0.0, torch.Generator().manual_seed(0)) is x
    assert tnn.drop_path(x, 0.3) is x  # eval: no generator
    a = tnn.drop_path(x, 0.3, torch.Generator().manual_seed(5))
    b = tnn.drop_path(x, 0.3, torch.Generator().manual_seed(5))
    c = tnn.drop_path(x, 0.3, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    per_sample = a.reshape(4000, -1)
    assert torch.equal(per_sample.amin(1), per_sample.amax(1))  # all or nothing
    kept = per_sample[:, 0] != 0
    assert torch.allclose(per_sample[kept], torch.full_like(per_sample[kept], 1 / 0.7))
    assert abs(float((~kept).float().mean()) - 0.3) < 5 * (0.3 * 0.7 / 4000) ** 0.5


def test_block_drop_path_rates_equal_jax():
    for kw in (dict(drop_path_rate=0.2), dict(TINY, drop_path_rate=0.3), dict(TINY)):
        jc, tc = jswin.SwinCfg(**kw), tswin.SwinCfg(**kw)
        for i, depth in enumerate(tc.depths):
            for j in range(depth):
                assert tc.block_drop_path(i, j) == jc.block_drop_path(i, j)
    large = tswin.SwinCfg(drop_path_rate=0.2)
    assert large.block_drop_path(0, 0) == 0.0 and large.block_drop_path(3, 1) == 0.2


def test_stochastic_depth_in_the_backbone():
    """Rate 0 with a generator is eval; at rate 0.5 a generator changes the
    output, repeats under its seed, and stays finite."""
    _, _, model = _pair(**dict(TINY, drop_path_rate=0.0))
    x = _frames(5)
    eval_out = _port(model, x)
    for g, e in zip(_port(model, x, generator=torch.Generator().manual_seed(1)), eval_out):
        np.testing.assert_array_equal(g, e)
    model.cfg = dataclasses.replace(model.cfg, drop_path_rate=0.5)
    d1 = _port(model, x, generator=torch.Generator().manual_seed(1))
    d2 = _port(model, x, generator=torch.Generator().manual_seed(1))
    assert all(np.array_equal(a, b) and np.isfinite(a).all() for a, b in zip(d1, d2))
    assert not np.allclose(d1[-1], eval_out[-1])


@pytest.mark.parametrize("kind", ["tiny", "small", "base", "large"])
def test_presets_channels_and_strides_equal_jax(kind):
    assert dataclasses.asdict(tswin.SWIN_PRESETS[kind]) == dataclasses.asdict(
        jswin.SWIN_PRESETS[kind])
    got, want = MDQEModelCfg(backbone=f"swin_{kind}"), JaxModelCfg(backbone=f"swin_{kind}")
    assert got.backbone_channels == want.backbone_channels
    assert got.feature_strides == want.feature_strides == (8, 16, 32)
    assert got.level_strides == (8, 16, 32, 64)
    v1 = dataclasses.replace(tswin.SWIN_PRESETS[kind], version=1)
    assert MDQEModelCfg(backbone=f"swin_{kind}", swin=v1).backbone_channels == \
        JaxModelCfg(backbone=f"swin_{kind}", swin=jswin.SwinCfg(
            **dataclasses.asdict(v1))).backbone_channels


@pytest.mark.parametrize("version", [2, 1], ids=["v2", "v1"])
def test_swin_model_names_and_nothing_frozen(version):
    """A Swin MDQE model's backbone holds exactly the JAX tree's leaves under
    the Detectron2 prefix, and no parameter of it is frozen at any
    FREEZE_AT."""
    kw = dict(TINY, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16), version=version,
              ape=True, pretrain_img_size=64)
    cfg = MDQEModelCfg(backbone="swin_tiny", swin=tswin.SwinCfg(**kw), hidden_dim=64,
                       n_heads=4, enc_layers=1, dec_layers=1, n_query=16,
                       query_embed_dim=8)
    model = MDQEModel(cfg, device="cpu")
    tree = jax.eval_shape(lambda k: jswin.swin_init(k, jswin.SwinCfg(**kw)),
                          jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in jax_tree_to_state_dict(
        {"backbone": jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)}).items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items() if k.startswith(PREFIX)}
    assert got == want
    for freeze_at in (0, 1, 2, 5):
        assert not any(is_frozen(n, freeze_at) for n in got)
        model.set_trainable(freeze_at)
        assert all(p.requires_grad for n, p in model.named_parameters()
                   if n.startswith(PREFIX))
