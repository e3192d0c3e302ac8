"""The PyTorch port's COCO image inference against the JAX package's, on the
CPU, at a tiny R50 COCO configuration (hidden 64, 4 heads, 1 + 1 layers, 16
queries, 3 classes, query embedding 8, one frame) with the same detr_init
weights and the same 64x64 image.

The class head's bias is zeroed in the shared weights (random weights with
the focal prior score 0.01, below every threshold, and would leave nothing
to compare). Bounds: masks_to_boxes equal; the is_coco decoder outputs within
1e-4 of each output's scale (fp32 on both sides, sums in another order);
inference_image gives the same detections, matched by (label, score within
5e-3, mask IoU >= 0.99, boxes within 1 px) since near-equal scores may order
differently between the frameworks. Masks come from logits thresholded at 0,
so a logit within float noise of 0 may flip a pixel.

Random-weight masks span the whole image, so their boxes coincide and the
box-IoU decay leaves one query standing. The post-processing is therefore
also held to JAX on decoder outputs made to look like a detector's (distinct
blob masks whose boxes overlap in part), with the model forward replaced on
both sides."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu.models import MDQEModelCfg as JaxModelCfg
from mdqe_cvpr2023_tpu.models import detr_init
from mdqe_cvpr2023_tpu.models import meta as jmeta
from mdqe_cvpr2023_tpu.models.decoder import decoder_apply
from mdqe_cvpr2023_tpu.utils.boxes import masks_to_boxes as jax_masks_to_boxes
from mdqe_cvpr2023_tpu_torch import configs
from mdqe_cvpr2023_tpu_torch.engine.weights import (jax_tree_to_state_dict,
                                                    load_jax_params)
from mdqe_cvpr2023_tpu_torch.models import meta as tmeta
from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg, padding_masks
from mdqe_cvpr2023_tpu_torch.utils.boxes import masks_to_boxes

torch.set_num_threads(2)

MODEL_KW = dict(backbone="resnet50", num_classes=3, hidden_dim=64, n_heads=4,
                enc_layers=1, dec_layers=1, n_frames=1, n_query=16,
                query_embed_dim=8, window_inter_frame_asso=5, dec_temporal=True)
INF_KW = dict(num_classes=3, apply_cls_thres=0.05, multi_cls_on=True, coco_topk=100)
IMAGE_SIZE, ORI_SIZE = (56, 60), (84, 90)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxModelCfg(**MODEL_KW)
    params = jax.tree.map(np.asarray, jax.jit(detr_init, static_argnums=1)(
        jax.random.PRNGKey(0), cfg))
    head = params["transformer_dec"]["cls_embed"]["layers"][-1]
    head["bias"] = np.zeros_like(head["bias"])
    return params


@pytest.fixture(scope="module")
def port_model(jax_params):
    model = MDQEModel(MDQEModelCfg(**MODEL_KW), device="cpu", seed=1)
    load_jax_params(model, jax_params)
    return model


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (1,) + IMAGE_SIZE + (3,)).astype(np.uint8)
    frames, _ = tmeta.preprocess_frames(img)
    jframes, _ = jmeta.preprocess_frames(img)
    np.testing.assert_array_equal(frames, jframes)
    return frames


def test_coco_config_is_the_yaml():
    cfg, inf = configs.R50_COCO, configs.R50_COCO_INF
    assert (cfg.num_classes, cfg.hidden_dim, cfg.n_heads, cfg.enc_layers, cfg.dec_layers,
            cfg.n_query, cfg.query_embed_dim, cfg.n_frames) == (80, 256, 8, 6, 6, 196, 64, 1)
    assert (inf.apply_cls_thres, inf.multi_cls_on, inf.coco_topk) == (0.05, True, 100)
    assert configs.coco_test_size(480, 720) == (800, 1200)
    assert configs.coco_test_size(400, 1200) == (444, 1333)


def test_load_jax_params_is_strict_for_coco(jax_params, port_model):
    sd = port_model.state_dict()
    flat = jax_tree_to_state_dict(jax_params)
    assert set(flat) == set(sd)
    for name, arr in flat.items():
        np.testing.assert_array_equal(sd[name].numpy(), arr, err_msg=name)
    tree = dict(jax_params, extra={"w": np.zeros(1, np.float32)})
    with pytest.raises(KeyError):
        load_jax_params(MDQEModel(MDQEModelCfg(**MODEL_KW), device="cpu"), tree)


@pytest.mark.parametrize("kind", ["random", "with_empty"])
def test_masks_to_boxes_matches_jax(kind):
    rng = np.random.default_rng(3)
    masks = rng.random((2, 6, 17, 23)) < 0.02
    if kind == "with_empty":
        masks[0, 1] = False
        masks[1, 4] = False
        masks[1, 5] = False
        masks[1, 5, 16, 22] = True          # one pixel in the corner
    got = masks_to_boxes(torch.from_numpy(masks)).numpy()
    want = np.asarray(jax_masks_to_boxes(masks))
    np.testing.assert_array_equal(got, want)


def test_is_coco_decoder_matches_jax(jax_params, port_model):
    cfg = JaxModelCfg(**MODEL_KW)
    shapes = ((8, 8), (4, 4), (2, 2), (1, 1))
    N = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(5)
    encoded = rng.standard_normal((1, N, 64)).astype(np.float32)
    sizes = torch.tensor([list(IMAGE_SIZE)], dtype=torch.int32)
    masks = padding_masks(sizes, (64, 64), (8, 16, 32, 64))
    mask_flat = torch.cat([m.reshape(1, -1) for m in masks], 1)
    want = jax.jit(decoder_apply, static_argnums=(1, 4, 5, 6, 7))(
        jax_params["transformer_dec"], cfg.decoder_cfg, encoded, mask_flat.numpy(), shapes,
        1, False, True)
    got = port_model.detr.transformer_dec(torch.from_numpy(encoded), mask_flat, shapes, 1,
                                          is_coco=True)
    assert set(got) == {"cls", "masks", "boxes"}
    assert got["masks"].shape == (1, 16, 1, 16, 16) and got["boxes"].shape == (1, 16, 1, 4)
    for key in ("cls", "masks", "boxes"):
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape, key
        assert np.abs(g - w).max() <= 1e-4 * max(1.0, np.abs(w).max()), key


def _match(got, want):
    """Pair each port detection with a JAX one of the same label, score within
    5e-3, mask IoU >= 0.99 and boxes within 1 px; fail on any left over."""
    assert len(got["scores"]) == len(want["scores"])
    free = set(range(len(want["scores"])))
    for i, (s, c) in enumerate(zip(got["scores"], got["classes"])):
        best, best_iou = None, -1.0
        for j in free:
            if want["classes"][j] != c or abs(want["scores"][j] - s) > 5e-3:
                continue
            a, b = got["masks"][i], want["masks"][j]
            union = np.logical_or(a, b).sum()
            iou = 1.0 if union == 0 else np.logical_and(a, b).sum() / union
            if iou > best_iou:
                best, best_iou = j, iou
        assert best is not None and best_iou >= 0.99, (i, s, c, best_iou)
        assert np.abs(got["boxes"][i] - want["boxes"][best]).max() <= 1.0
        free.discard(best)


@pytest.mark.parametrize("multi_cls_on", [True, False])
def test_inference_image_matches_jax(jax_params, port_model, image, multi_cls_on):
    inf = dict(INF_KW, multi_cls_on=multi_cls_on)
    want = jmeta.inference_image(jax_params, JaxModelCfg(**MODEL_KW),
                                 jmeta.InferenceCfg(**inf), image, IMAGE_SIZE, ORI_SIZE)
    got = tmeta.inference_image(port_model, tmeta.InferenceCfg(**inf), image,
                                IMAGE_SIZE, ORI_SIZE, device="cpu")
    n = len(got["scores"])
    assert n >= 3 and len(got["classes"]) == n
    assert got["masks"].shape == (n,) + ORI_SIZE and got["masks"].dtype == bool
    assert got["boxes"].shape == (n, 4) and got["boxes"].dtype == np.float32
    assert all(0 <= c < 3 for c in got["classes"])
    assert got["scores"] == sorted(got["scores"], reverse=True)
    _match(got, want)


def _blob_outputs(n_query, n_cls, hw4, valid_hw4, seed):
    """Decoder outputs of a model that finds objects: class scores (1, Q, K)
    in (0, 1), a few queries below the threshold, and per query an elliptic
    mask-logit blob (1, Q, 1, h4, w4) of its own centre and radii inside the
    valid region, so masks differ and their boxes overlap in part."""
    rng = np.random.default_rng(seed)
    cls = rng.uniform(0.06, 0.9, (n_query, n_cls)).astype(np.float32)
    cls[rng.choice(n_query, 3, replace=False)] = 0.02
    yy, xx = np.mgrid[0:hw4[0], 0:hw4[1]].astype(np.float32)
    cy = rng.uniform(0, valid_hw4[0], n_query)[:, None, None]
    cx = rng.uniform(0, valid_hw4[1], n_query)[:, None, None]
    ry = rng.uniform(1.5, valid_hw4[0] / 2.5, n_query)[:, None, None]
    rx = rng.uniform(1.5, valid_hw4[1] / 2.5, n_query)[:, None, None]
    m4 = 4.0 * (1.0 - ((yy - cy) / ry) ** 2 - ((xx - cx) / rx) ** 2)
    return cls[None], m4.astype(np.float32)[None, :, None]


def _box_iou(a, b):
    inter = np.prod(np.clip(np.minimum(a[2:], b[2:]) - np.maximum(a[:2], b[:2]), 0, None))
    union = np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2]) - inter
    return inter / union


@pytest.mark.parametrize("multi_cls_on", [True, False])
def test_inference_image_post_matches_jax_on_object_masks(monkeypatch, port_model, image,
                                                          multi_cls_on):
    """The post-processing (mask-quality rescoring, box-IoU decay in score
    order, the top-k slab, bit-packed masks, the host resize and boxes) on
    decoder outputs of distinct, partly overlapping masks, 40 queries (two
    row chunks) and 5 classes, against JAX: the model forward is replaced on
    both sides by the same outputs."""
    import mdqe_cvpr2023_tpu.models.detr as jdetr
    from mdqe_cvpr2023_tpu_torch.models import meta as meta_mod
    cls, masks = _blob_outputs(40, 5, (16, 16), (14, 15), seed=7)
    monkeypatch.setattr(jdetr, "detr_apply_backbone",
                        lambda params, *a, **k: {"cls": params["cls"], "masks": params["masks"]})
    monkeypatch.setattr(meta_mod, "detr_apply_coco", lambda *a: {
        "cls": torch.from_numpy(cls), "masks": torch.from_numpy(masks)})
    inf = dict(INF_KW, num_classes=5, multi_cls_on=multi_cls_on)
    want = jmeta.inference_image({"cls": cls, "masks": masks}, JaxModelCfg(**MODEL_KW),
                                 jmeta.InferenceCfg(**inf), image, IMAGE_SIZE, ORI_SIZE)
    got = tmeta.inference_image(port_model, tmeta.InferenceCfg(**inf), image,
                                IMAGE_SIZE, ORI_SIZE, device="cpu")
    n = len(got["scores"])
    assert got["scores"] == sorted(got["scores"], reverse=True)
    _match(got, want)
    # several queries survive the decay, and some of their boxes overlap in part
    distinct = {m.tobytes(): i for i, m in enumerate(got["masks"])}
    assert len(distinct) >= 8, len(distinct)
    boxes = [got["boxes"][i] for i in distinct.values()]
    ious = [_box_iou(a, b) for k, a in enumerate(boxes) for b in boxes[k + 1:]]
    assert any(0.0 < x < 1.0 for x in ious)
    assert n >= len(distinct) and min(got["scores"]) > (0.05 if multi_cls_on else -1.0)


def test_coco_slab_caps(port_model, image):
    """coco_topk caps the multi-class slab at the best detections; the
    per-query branch gives one detection per query at most."""
    inf = tmeta.InferenceCfg(**INF_KW)
    full = tmeta.inference_image(port_model, inf, image, IMAGE_SIZE, ORI_SIZE, device="cpu")
    capped = tmeta.inference_image(port_model, dataclasses.replace(inf, coco_topk=2), image,
                                   IMAGE_SIZE, ORI_SIZE, device="cpu")
    assert len(full["scores"]) > 2
    assert capped["scores"] == full["scores"][:2]
    assert capped["classes"] == full["classes"][:2]
    np.testing.assert_array_equal(capped["masks"], full["masks"][:2])
    single = tmeta.inference_image(port_model, dataclasses.replace(inf, multi_cls_on=False),
                                   image, IMAGE_SIZE, ORI_SIZE, device="cpu")
    assert len(single["scores"]) <= 16
