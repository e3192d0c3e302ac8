"""The port's three paths with a Swin backbone against the JAX package's, on
the CPU, at a tiny Swin MDQE configuration (4 stages as Swin-L's, so strides
8 / 16 / 32: embed 32, depths 2-2-2-2, heads 2-4-8-16, window 4; hidden 64,
1 + 1 layers, 16 queries), fp32 on both sides, the same weights on both
sides (loaded by name):

  - windowed VIS inference (v2, ``bf16_encode=False``) on 9 frames of 70x90
    (padded to 96x96: the stage grids 12 / 6 / 3 pad to their windows): the
    same tracks and labels, scores within 1e-4, mask IoU >= 0.99;
  - COCO image inference (v1, with APE) on one 56x60 image: the same
    detections (label, score within 5e-3, mask IoU >= 0.99, boxes within 1
    px; near-equal scores may order differently);
  - one training step (dropout and drop path 0) on 2 clips of 2 frames, v2 on
    128x128 frames and v1 on 128x160 (its stage grids 8x10 and 4x5 pad to
    their windows): the loss dict within rtol 1e-4, the gradients and the
    parameters after one AdamW step within the bounds of
    tests/test_torch_train_step.py.

v2 trains on padded windows only in the port: there the JAX package's
gradient is NaN. A padded token is zero, its k has no bias, and
``jnp.linalg.norm``'s gradient at a zero vector is 0/0, which the clip at
1e-12 multiplies by 0 and keeps NaN; torch's norm takes the subgradient 0
there, as the reference's ``F.normalize`` does
(``test_v2_padded_window_gradient``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu.engine.checkpoint import convert_torch_state_dict
from mdqe_cvpr2023_tpu.losses import CriterionCfg as JCritCfg
from mdqe_cvpr2023_tpu.losses.criterion import criterion_apply as j_criterion
from mdqe_cvpr2023_tpu.models import MDQEModelCfg as JaxModelCfg
from mdqe_cvpr2023_tpu.models import decoder as jdec
from mdqe_cvpr2023_tpu.models import detr as jdetr
from mdqe_cvpr2023_tpu.models import detr_init
from mdqe_cvpr2023_tpu.models import meta as jmeta
from mdqe_cvpr2023_tpu.models import swin as jswin
from mdqe_cvpr2023_tpu.parallel import train as jtrain
from mdqe_cvpr2023_tpu_torch.engine.weights import (grad_state_dict, jax_tree_to_state_dict,
                                                    load_jax_params)
from mdqe_cvpr2023_tpu_torch.losses.criterion import CriterionCfg
from mdqe_cvpr2023_tpu_torch.models import meta as tmeta
from mdqe_cvpr2023_tpu_torch.models import swin as tswin
from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg
from mdqe_cvpr2023_tpu_torch.parallel import train as ttrain

torch.set_num_threads(2)

SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16), window_size=4)
MODEL = dict(backbone="swin_tiny", hidden_dim=64, n_heads=4, enc_layers=1, dec_layers=1,
             n_query=16, query_embed_dim=8, window_inter_frame_asso=5, dec_temporal=True)


def _cfgs(swin_kw, **kw):
    return (JaxModelCfg(swin=jswin.SwinCfg(**swin_kw), **MODEL, **kw),
            MDQEModelCfg(swin=tswin.SwinCfg(**swin_kw), **MODEL, **kw))


def _pair(swin_kw, zero_cls_bias=False, **kw):
    """JAX detr_init weights (class bias zeroed if asked: random weights score
    0.01 under the focal prior) and the port's model holding them."""
    jcfg, tcfg = _cfgs(swin_kw, **kw)
    params = jax.tree.map(np.asarray, jax.jit(detr_init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    if zero_cls_bias:
        head = params["transformer_dec"]["cls_embed"]["layers"][-1]
        head["bias"] = np.zeros_like(head["bias"])
    model = MDQEModel(tcfg, device="cpu", seed=1)
    load_jax_params(model, params)
    return jcfg, params, model


def test_inference_vis_swin_matches_jax():
    jcfg, params, model = _pair(SWIN, num_classes=5, n_frames=2)
    inf = dict(clip_stride=2, n_frames_test=2, n_frames_window_test=4, max_num_instances=20,
               apply_cls_thres=0.05, clip_topk=8, encode_chunk=2, num_classes=5,
               bf16_encode=False)
    video = np.random.default_rng(0).integers(0, 255, (9, 70, 90, 3)).astype(np.uint8)
    frames, _ = tmeta.preprocess_frames(video)
    assert tmeta.spatial_shapes_for(model.cfg, frames.shape[1:3]) == \
        jmeta.spatial_shapes_for(jcfg, frames.shape[1:3]) == ((12, 12), (6, 6), (3, 3), (2, 2))
    want = jmeta.inference_vis(params, jcfg, jmeta.InferenceCfg(**inf), frames,
                               image_size=(70, 90), ori_size=(70, 90))
    got = tmeta.inference_vis(model, tmeta.InferenceCfg(**inf), frames, image_size=(70, 90),
                              ori_size=(70, 90), device="cpu")
    assert got["num_tracks"] == want["num_tracks"]
    assert len(got["pred_scores"]) == len(want["pred_scores"]) >= 1
    assert got["pred_labels"] == want["pred_labels"]
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], rtol=0, atol=1e-4)
    for mg, mw in zip(got["pred_masks"], want["pred_masks"]):
        assert mg.shape == mw.shape == (9, 70, 90)
        union = np.logical_or(mg, mw).sum()
        assert union == 0 or np.logical_and(mg, mw).sum() / union >= 0.99


def test_inference_image_swin_v1_ape_matches_jax():
    swin_kw = dict(SWIN, version=1, ape=True, pretrain_img_size=32)
    jcfg, params, model = _pair(swin_kw, zero_cls_bias=True, num_classes=3, n_frames=1)
    inf = dict(num_classes=3, apply_cls_thres=0.05, multi_cls_on=True, coco_topk=100)
    img = np.random.default_rng(0).integers(0, 255, (1, 56, 60, 3)).astype(np.uint8)
    frames, _ = tmeta.preprocess_frames(img)
    want = jmeta.inference_image(params, jcfg, jmeta.InferenceCfg(**inf), frames,
                                 (56, 60), (84, 90))
    got = tmeta.inference_image(model, tmeta.InferenceCfg(**inf), frames, (56, 60),
                                (84, 90), device="cpu")
    n = len(want["scores"])
    assert n >= 1 and len(got["scores"]) == n
    free = set(range(n))
    for i, (s, c) in enumerate(zip(got["scores"], got["classes"])):
        match = None
        for j in sorted(free):
            if want["classes"][j] != c or abs(want["scores"][j] - s) > 5e-3:
                continue
            a, b = got["masks"][i], want["masks"][j]
            union = np.logical_or(a, b).sum()
            if (union == 0 or np.logical_and(a, b).sum() / union >= 0.99) and \
                    np.abs(got["boxes"][i] - want["boxes"][j]).max() <= 1.0:
                match = j
                break
        assert match is not None, f"detection {i} ({c}, {s:.4f}) has no JAX partner"
        free.discard(match)


# --------------------------------------------------------------------------
# one training step
# --------------------------------------------------------------------------

B, T, HP, N, Q = 2, 2, 128, 3, 16
STEP_CASES = {"v2": (dict(SWIN), 128), "v1": (dict(SWIN, version=1), 160)}
CRIT = dict(num_classes=5, n_frames=T, n_query=Q, window_inter_frame_asso=5, num_points=64)


def reid_priorities(key):
    """The uniform draws ``criterion_apply`` makes from ``key`` for the reid
    loss, as a (B, N, 2, T*Q) array."""
    out = np.zeros((B, N, 2, T * Q))
    for b, kb in enumerate(jax.random.split(key, B)):
        for n, kn in enumerate(jax.random.split(kb, N)):
            k1, k2 = jax.random.split(kn)
            out[b, n, 0] = np.asarray(jax.random.uniform(k1, (T * Q,)))
            out[b, n, 1] = np.asarray(jax.random.uniform(k2, (T * Q,)))
    return out


def _new_model(swin_kw):
    """The port's seeded init plus noise on every weight, so that the zero
    q / v biases and the constant logit scales take part."""
    model = MDQEModel(_cfgs(swin_kw, num_classes=5, n_frames=T)[1], device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if t.is_floating_point() and not name.endswith(("sampling_offsets",
                                                            "lvl_spatial_scales")):
                t.add_(0.05 * torch.randn(t.shape, generator=gen))
    return model


def _tree(model):
    """The model's state as a JAX tree, copied (on the CPU ``.numpy()`` shares
    the tensors' memory, which the optimizer step updates in place)."""
    return convert_torch_state_dict({k: v.detach().numpy().copy()
                                     for k, v in model.state_dict().items()})


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def steps(request):
    """Both sides from one state: JAX's loss dict, gradients (value_and_grad
    of make_train_step's loss, drop path and dropout 0) and the parameters
    after its optimizer's update; the port's loss dict, gradients and the
    parameters after its step."""
    swin_kw, WP = STEP_CASES[request.param]
    batch = ttrain.synthetic_batch(seed=3, clips=B, frames=T, hp=HP, wp=WP, slots=N,
                                   n_inst=2, num_classes=5)
    model = _new_model(swin_kw)
    params = _tree(model)
    jcfg = _cfgs(swin_kw, num_classes=5, n_frames=T)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)
    relpos = jnp.asarray(jdec.query_relpos_grid(4))
    mean = jnp.asarray(ttrain.PIXEL_MEAN, jnp.float32)
    std = jnp.asarray(ttrain.PIXEL_STD, jnp.float32)

    def loss_fn(p):
        images = (jb["images"].astype(jnp.float32) - mean) / std
        out = jdetr.detr_apply_backbone(p, jcfg, images, jb["image_sizes"], n_frames=T,
                                        training=True, drop_rate=0.0,
                                        rng=jax.random.fold_in(key, 999))
        mm, m8 = jtrain.prepare_targets_device(jb["masks"], (HP, WP), 4)
        tg = {"labels": jb["labels"], "ids": jb["ids"], "boxes": jb["boxes"],
              "valid": jb["valid"], "match_masks": mm, "masks8": m8}
        return j_criterion(JCritCfg(**CRIT), out, tg, relpos, key)

    (total, ldict), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jtrain.make_optimizer(jtrain.TrainCfg())
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    params1 = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)

    opt = ttrain.make_optimizer(model, ttrain.TrainCfg())
    opt.zero_grad()
    t_total, t_ldict = ttrain.loss_fn(
        model, CriterionCfg(**CRIT), {k: torch.from_numpy(np.ascontiguousarray(v))
                                      for k, v in batch.items()},
        dropout_rate=0.0, reid_priorities=torch.from_numpy(reid_priorities(key)))
    t_total.backward()
    t_grads = convert_torch_state_dict(grad_state_dict(model))
    opt.step()
    return {"total": (t_total.item(), float(total)),
            "ldict": ({k: v.item() for k, v in t_ldict.items()},
                      {k: float(v) for k, v in ldict.items()}),
            "grads": (t_grads, grads), "params1": (_tree(model), params1),
            "frozen": jtrain.frozen_leaf_mask(params, 2)}


def _leaves(pair, frozen):
    flat = jax.tree_util.tree_flatten_with_path(pair[1])[0]
    port = jax.tree_util.tree_leaves(pair[0])
    fro = jax.tree_util.tree_leaves(frozen)
    assert len(flat) == len(port) == len(fro)
    return [(jax.tree_util.keystr(kp), np.asarray(a, np.float64), np.asarray(w, np.float64), f)
            for (kp, w), a, f in zip(flat, port, fro)]


def test_swin_step_loss_dict_matches_jax(steps):
    got, want = steps["ldict"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(*steps["total"], rtol=1e-4)


def test_swin_step_grads_match_jax(steps):
    """The bounds of test_param_grads_match_jax_value_and_grad: per trainable
    leaf max |err| <= 0.1 s + 1e-6 G, at most 0.5% of entries off by more
    than 0.01 s, cosine >= 0.9999 where s > 1e-4 G; every Swin leaf takes a
    gradient (nothing of the backbone is frozen)."""
    leaves = [(p, g, w) for p, g, w, f in _leaves(steps["grads"], steps["frozen"]) if not f]
    G = max(np.abs(w).max() for _, _, w in leaves)
    swin = [p for p, _, w in leaves if p.startswith("['backbone']") and np.abs(w).max() > 0]
    assert len(swin) > 100
    for path, g, w in leaves:
        s = np.abs(w).max()
        err = np.abs(g - w)
        assert err.max() <= 0.1 * s + 1e-6 * G, f"{path}: err {err.max():.3e} s {s:.3e}"
        if s > 1e-4 * G:
            assert (err > 1e-2 * s).mean() <= 5e-3, path
            cos = (g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w))
            assert cos >= 0.9999, f"{path}: cosine {cos:.6f}"


def test_swin_step_params_match_jax(steps):
    """After one step at TrainCfg() (lr 1e-4, backbone x0.1): frozen leaves
    equal; of the trainable entries 99% within 0.01 lr, 99.9% within 0.05 lr,
    all within 1.0 lr (Adam's first step is about lr * sign(g))."""
    lr = ttrain.TrainCfg().base_lr
    diffs = []
    for path, a, w, frozen in _leaves(steps["params1"], steps["frozen"]):
        d = np.abs(a - w)
        if frozen:
            assert d.max() == 0, path
        else:
            assert d.max() <= lr, f"{path}: {d.max() / lr:.3f} lr"
            diffs.append(d.ravel())
    q99, q999 = np.quantile(np.concatenate(diffs), [0.99, 0.999])
    assert q99 <= 0.01 * lr and q999 <= 0.05 * lr, (q99 / lr, q999 / lr)


def test_v2_padded_window_gradient():
    """A v2 block on a 6x7 grid, padded to its 8x8 window: the port's
    parameter gradients are finite; JAX's are NaN on the leaves the padded
    tokens reach through k (the fault the module docstring describes) and
    equal the port's on every other leaf."""
    tree = jax.tree.map(np.asarray, jswin.swin_init(jax.random.PRNGKey(0), jswin.SwinCfg(
        **SWIN))["layers"][0]["blocks"][0])
    blk = tswin.SwinBlock(32, 2, 4, 4.0, 2)
    prefix = "detr.backbone.0.backbone.layers.0.blocks.0."
    blk.load_state_dict({k[len(prefix):]: torch.from_numpy(np.array(v)) for k, v in
                         jax_tree_to_state_dict({"backbone": {"layers": [
                             {"blocks": [tree]}]}}).items()})
    x = np.random.default_rng(0).standard_normal((1, 6, 7, 32)).astype(np.float32)
    blk(torch.from_numpy(x), 4, 2).square().sum().backward()
    loss = lambda p: jnp.sum(jswin._block(p, jnp.asarray(x), 6, 7, 4, 2, 2) ** 2)  # noqa: E731
    want = jax.jit(jax.grad(loss))(tree)
    want = jax_tree_to_state_dict({"backbone": {"layers": [{"blocks": [want]}]}})
    nan_leaves = []
    for name, p in blk.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        w = want[prefix + name]
        if np.isnan(w).any():
            nan_leaves.append(name)
        else:
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=name)
    assert "attn.qkv.weight" in nan_leaves
