"""Module-by-module parity of the PyTorch port with the JAX package on the CPU,
at tiny widths, fp32 on both sides. Weights are made by the port (seeded init
plus noise, so no parameter sits at a degenerate zero) and handed to JAX
through the JAX package's own Detectron2-name converter, which also checks
the port's parameter names. Inputs are made with numpy from a seed.

Tolerances: 1e-5 where the two compute the same fp32 expression; looser where
XLA and PyTorch accumulate long sums in another order (stated per test)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mdqe_cvpr2023_tpu.engine.checkpoint import convert_torch_state_dict
from mdqe_cvpr2023_tpu.models import attention as jatt
from mdqe_cvpr2023_tpu.models import decoder as jdec
from mdqe_cvpr2023_tpu.models import detr as jdetr
from mdqe_cvpr2023_tpu.models.resnet import resnet_apply
from mdqe_cvpr2023_tpu.utils import misc as jmisc
from mdqe_cvpr2023_tpu.utils import nn as jnn
from mdqe_cvpr2023_tpu_torch.models import attention as tatt
from mdqe_cvpr2023_tpu_torch.models import detr as tdetr
from mdqe_cvpr2023_tpu_torch.models.resnet import ResNet
from mdqe_cvpr2023_tpu_torch.utils import misc as tmisc
from mdqe_cvpr2023_tpu_torch.utils import nn as tnn

torch.set_num_threads(2)

TINY = dict(backbone="resnet50", num_classes=5, hidden_dim=64, n_heads=4,
            enc_layers=1, dec_layers=1, n_frames=2, n_query=16,
            query_embed_dim=8, dec_temporal=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nest(flat):
    """Flat dotted names -> nested dicts, digit-keyed levels as lists."""
    tree = {}
    for name, arr in flat.items():
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(arr.numpy())

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(re.fullmatch(r"\d+", k) for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out
    return listify(tree)


@torch.no_grad()
def _perturb_(module, seed):
    """Noise on every weight (variances scaled, not shifted) so zero-initialized
    heads take part in the comparison."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in module.state_dict().items():
        if not t.is_floating_point():
            continue
        if name.endswith(("sampling_offsets", "lvl_spatial_scales")):
            continue  # fixed buffers (the rotational grid, level scales)
        if name.endswith("running_var"):
            t.mul_(torch.empty_like(t).uniform_(0.5, 1.5, generator=gen))
        else:
            t.add_(0.05 * torch.randn(t.shape, generator=gen))


@pytest.fixture(scope="module")
def tiny_model():
    model = tdetr.MDQEModel(tdetr.MDQEModelCfg(**TINY), device="cpu", seed=0)
    _perturb_(model, 1)
    params = convert_torch_state_dict({k: v.numpy() for k, v in
                                       model.state_dict().items()})
    return model, params


# --------------------------------------------------------------------------
# utils
# --------------------------------------------------------------------------

@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_matches_torch_and_jax(padding_mode):
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 6, 2)).astype(np.float32)
    got = tmisc.grid_sample(_t(img), _t(grid), padding_mode)
    oracle = F.grid_sample(_t(img).permute(0, 3, 1, 2), _t(grid), mode="bilinear",
                           padding_mode=padding_mode, align_corners=False)
    np.testing.assert_allclose(got.numpy(), oracle.permute(0, 2, 3, 1).numpy(),
                               rtol=0, atol=1e-5)
    want = jmisc.grid_sample(jnp.asarray(img), jnp.asarray(grid), padding_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [(20, 28), (3, 5), (17, 11)])
def test_interpolate_bilinear_matches_jax_resize(size):
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 8)).astype(np.float32)
    got = tmisc.interpolate_bilinear(_t(x), size)
    want = jmisc.interpolate_bilinear(jnp.asarray(x), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("factor", [2, 4])
def test_aligned_bilinear_and_nearest_match_jax(factor):
    x = np.random.default_rng(2).standard_normal((3, 2, 6, 5)).astype(np.float32)
    np.testing.assert_allclose(tmisc.aligned_bilinear(_t(x), factor).numpy(),
                               np.asarray(jmisc.aligned_bilinear(jnp.asarray(x), factor)),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tmisc.interpolate_nearest(_t(x), (13, 7)).numpy(),
        np.asarray(jmisc.interpolate_nearest(jnp.asarray(x), (13, 7))))


def test_nn_layers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)      # NHWC
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    p = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
    np.testing.assert_allclose(
        tnn.layer_norm(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(jnn.layer_norm(p, jnp.asarray(x))), rtol=0, atol=1e-5)
    gn = tnn.group_norm(_t(x).permute(0, 3, 1, 2), _t(w), _t(b), 4)
    np.testing.assert_allclose(gn.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jnn.group_norm(p, jnp.asarray(x), 4)),
                               rtol=0, atol=1e-5)
    up = tnn.conv_transpose2d_up2(_t(x).permute(0, 3, 1, 2),
                                  _t(w.reshape(16, 1, 1, 1)), _t(b))
    np.testing.assert_allclose(
        up.permute(0, 2, 3, 1).numpy(),
        np.asarray(jnn.conv_transpose2d_up2(
            {"weight": jnp.asarray(w.reshape(16, 1, 1, 1)), "bias": p["bias"]},
            jnp.asarray(x))), rtol=0, atol=1e-6)
    mask = rng.random((2, 5, 6)) > 0.3
    np.testing.assert_allclose(
        tnn.position_embedding_sine(_t(mask), 8).numpy(),
        np.asarray(jnn.position_embedding_sine(jnp.asarray(mask), 8)),
        rtol=0, atol=1e-5)
    q = rng.standard_normal((2, 7, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 9, 16)).astype(np.float32)
    mp = {"in_proj_weight": rng.standard_normal((48, 16)).astype(np.float32) * 0.2,
          "in_proj_bias": rng.standard_normal(48).astype(np.float32),
          "out_proj": {"weight": rng.standard_normal((16, 16)).astype(np.float32),
                       "bias": rng.standard_normal(16).astype(np.float32)}}
    got = tnn.mha(_t(q), _t(kv), _t(kv), _t(mp["in_proj_weight"]),
                  _t(mp["in_proj_bias"]), _t(mp["out_proj"]["weight"]),
                  _t(mp["out_proj"]["bias"]), 4)
    want = jnn.mha({"in_proj_weight": jnp.asarray(mp["in_proj_weight"]),
                    "in_proj_bias": jnp.asarray(mp["in_proj_bias"]),
                    "out_proj": {k: jnp.asarray(v) for k, v in mp["out_proj"].items()}},
                   jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# MSDeformAttn
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pred_offsets", [True, False])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_msdeformattn_matches_jax(mode, pred_offsets):
    shapes = ((6, 8), (3, 4))
    cfg_kw = dict(d_model=32, n_levels=2, n_heads=4, n_points=2, n_frames=3,
                  pred_offsets=pred_offsets, mode=mode)
    module = tatt.MSDeformAttn(tatt.MSDeformAttnCfg(**cfg_kw), site="decoder_box")
    module.reset_parameters(torch.Generator().manual_seed(0))
    _perturb_(module, 2)
    params = _nest(module.state_dict())

    rng = np.random.default_rng(4)
    B, Q, N, C = 2, 5, 60, 32
    query = rng.standard_normal((B, Q, C)).astype(np.float32)
    ref = np.concatenate([rng.uniform(0.2, 0.8, (B, Q, 2)),
                          rng.uniform(0.05, 0.4, (B, Q, 2))], -1).astype(np.float32)
    lead = (B, N) if mode == "spatial" else (B, 3, N)
    src = rng.standard_normal(lead + (C,)).astype(np.float32)
    pmask = rng.random(lead) < 0.15
    if mode == "spatial":
        got = module(_t(query), _t(ref), _t(src), shapes, _t(pmask))
    else:   # the clips' B*3 frames, each clip's levels read through their own rows
        got = module(_t(query), _t(ref), _t(src).reshape(B * 3, N, C), shapes,
                     _t(pmask).reshape(B * 3, N), torch.arange(B * 3))
    want = jatt.ms_deform_attn_module(params, jatt.MSDeformAttnCfg(**cfg_kw),
                                      jnp.asarray(query), jnp.asarray(ref),
                                      jnp.asarray(src), shapes, jnp.asarray(pmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# --------------------------------------------------------------------------
# backbone, encoder, mask head, decoder
# --------------------------------------------------------------------------

def test_resnet_res3_to_res5_match_jax():
    """50 layers of fp32 convolutions: 1e-4 relative to each map's scale."""
    net = ResNet(50)
    net.reset_parameters(torch.Generator().manual_seed(0))
    _perturb_(net, 3)
    x = np.random.default_rng(5).standard_normal((1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = net(_t(x).permute(0, 3, 1, 2))
    want = resnet_apply(_nest(net.state_dict()), jnp.asarray(x))
    for g, name in zip(got, ("res3", "res4", "res5")):
        w = np.asarray(want[name])
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def _frames(rng, n=2):
    images = rng.standard_normal((n, 64, 64, 3)).astype(np.float32)
    sizes = np.asarray([[60, 62], [50, 64], [64, 40], [33, 33]][:n], np.int32)
    return images, sizes


def test_detr_encode_and_mask_feats_match_jax(tiny_model):
    """Backbone + encoder + mask head: 2e-4 (long fp32 sums, other order)."""
    model, params = tiny_model
    jcfg = jdetr.MDQEModelCfg(**TINY)
    images, sizes = _frames(np.random.default_rng(6))
    with torch.no_grad():
        enc, mflat, shapes = tdetr.detr_encode(model.detr, _t(images), _t(sizes))
        feats = tdetr.detr_mask_feats(model.detr, enc, shapes)
    jenc, jmflat, jshapes = jdetr.detr_encode(params, jcfg, jnp.asarray(images),
                                              jnp.asarray(sizes))
    assert shapes == tuple(jshapes) == ((8, 8), (4, 4), (2, 2), (1, 1))
    np.testing.assert_array_equal(mflat.numpy(), np.asarray(jmflat))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), rtol=0, atol=2e-4)
    jfeats = jdetr.detr_mask_feats(params, jcfg, jnp.asarray(enc.numpy()), shapes)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0, atol=2e-4)


def test_decoder_eval_matches_jax(tiny_model):
    """decoder_apply(training=False) on the same encoding: 1e-4."""
    model, params = tiny_model
    jcfg = jdetr.MDQEModelCfg(**TINY)
    rng = np.random.default_rng(7)
    shapes = ((8, 8), (4, 4), (2, 2), (1, 1))
    enc = rng.standard_normal((4, 85, 64)).astype(np.float32)
    sizes = np.asarray([[60, 62], [60, 62], [50, 64], [50, 64]], np.int32)
    mask = torch.cat([m.reshape(4, -1) for m in tdetr.padding_masks(
        _t(sizes), (64, 64), (8, 16, 32, 64))], 1)
    with torch.no_grad():
        got = model.detr.transformer_dec(_t(enc), mask, shapes, 2)
    want = jdec.decoder_apply(params["transformer_dec"], jcfg.decoder_cfg,
                              jnp.asarray(enc), jnp.asarray(mask.numpy()), shapes, 2,
                              training=False)
    for key in ("cls", "mask_coeff", "query_embed"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=1e-4, err_msg=key)


def test_query_selection_keeps_the_true_division_quirk():
    rng = np.random.default_rng(8)
    conf = rng.standard_normal((3, 8, 8, 5)).astype(np.float32)
    cfg = jdec.DecoderCfg(num_classes=5, dim=16, n_query=16)
    from mdqe_cvpr2023_tpu_torch.models import decoder as tdec
    got = tdec.grid_guided_query_selection(tdec.DecoderCfg(num_classes=5, dim=16,
                                                           n_query=16), _t(conf))
    want = jdec.grid_guided_query_selection(cfg, jnp.asarray(conf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    assert tdec.tca_frames(4, 4) == jdec._tca_frames(4, 4)
    assert tdec.tca_frames(5, 2) == jdec._tca_frames(5, 2)


def test_bf16_encode_as_close_to_fp32_as_jax(tiny_model):
    """bf16_encode (the default on the card) runs backbone, input projections
    and encoder on bf16 copies of their weights through functional_call, and
    leaves the fp32 weights untouched. The two frameworks round to bf16 at
    other places, so the check is statistical: the port's bf16 encoding and
    mask features are no further from its fp32 ones (relative RMS) than the
    JAX package's bf16 path is from its fp32 path, within 25%."""
    import itertools
    from mdqe_cvpr2023_tpu.models import meta as jmeta
    from mdqe_cvpr2023_tpu_torch.models import meta as tmeta
    model, params = tiny_model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    images, sizes = _frames(np.random.default_rng(9))
    frames = np.clip(images * 50 + 120, 0, 255).astype(np.uint8)
    mean = np.array([123.675, 116.28, 103.53], np.float32)
    std = np.array([58.395, 57.12, 57.375], np.float32)
    shapes = ((8, 8), (4, 4), (2, 2), (1, 1))
    named = itertools.chain(model.detr.named_parameters(), model.detr.named_buffers())
    bf16 = {n: t.bfloat16() for n, t in named
            if n.startswith(tmeta.ENCODE_PREFIXES) and t.is_floating_point()}
    args = (_t(frames), _t(sizes), _t(mean), _t(std), shapes)
    with torch.no_grad():
        t32 = tmeta.encode_window(model.detr, *args)
        t16 = tmeta.encode_window(model.detr, *args, bf16)
    jargs = (params, jdetr.MDQEModelCfg(**TINY), jnp.asarray(frames), jnp.asarray(sizes),
             jnp.asarray(mean), jnp.asarray(std), shapes)
    j32 = jmeta._encode_window_core(*jargs, False)
    j16 = jmeta._encode_window_core(*jargs, True)
    assert t16[0].dtype == torch.float32
    np.testing.assert_array_equal(t16[1].numpy(), t32[1].numpy())
    for k in (0, 2):  # encoding, mask features
        port = float((t16[k] - t32[k]).norm() / t32[k].norm())
        ref = np.asarray(j32[k])
        jax_rel = float(np.linalg.norm(np.asarray(j16[k]) - ref) / np.linalg.norm(ref))
        assert port <= 1.25 * jax_rel, (k, port, jax_rel)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
