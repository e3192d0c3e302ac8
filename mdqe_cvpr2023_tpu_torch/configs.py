"""Configurations the port runs, read by hand from the repository's
``configs/*.yaml`` (no config engine) with the defaults of
``mdqe_cvpr2023_tpu/engine/config.py`` and the derivations of
``mdqe_cvpr2023_tpu/engine/build.py``.

R50 COCO (``configs/R50_coco.yaml``): ResNet-50, hidden 256, 8 heads, 6 + 6
layers, 4 levels, 4 + 4 points, NUM_OBJECT_QUERIES 200 -> floor(sqrt(200))^2
= 196 queries, 80 classes, query embedding 64, WINDOW_INTER_FRAME_ASSOCIATION
5, DEC_TEMPORAL, SAMPLING_FRAME_NUM 1 (one frame per clip); test size 800 on
the short side and at most 1333 on the long one; APPLY_CLS_THRES 0.05 and
MULTI_CLS_ON (the defaults); at most 100 detections per image (``coco_topk``).

Swin-L COCO (``configs/swinl_coco.yaml`` on R50_coco.yaml): the same detector
on a Swin-L v2 backbone (``build_swinv2_backbone``: embed 192, depths 2-2-18-2,
heads 6-12-24-48, window 12, patch 4; the defaults DROP_PATH_RATE 0.2, no
APE, PRETRAIN_IMG_SIZE 384), the same test size and post-processing.

Swin-L OVIS (``configs/swinl_ovis.yaml`` on swinl_coco.yaml): 25 classes,
SAMPLING_FRAME_NUM 2 (the model's ``n_frames``), test clips of 2 frames
(SAMPLING_FRAME_NUM_TEST) every frame (CLIP_STRIDE 1), windows of 20 frames
(WINDOW_FRAME_NUM_TEST), 120 instances, APPLY_CLS_THRES 0.1, a clip slab of
min(10 x DETECTIONS_PER_IMAGE 15, 196) = 150, MIN_SIZE_TEST 480 (and the
default MAX_SIZE_TEST 1333).
"""
from __future__ import annotations

import dataclasses
import math

from .data.image import size_for_test
from .models.detr import MDQEModelCfg
from .models.meta import InferenceCfg
from .models.swin import SWIN_PRESETS

R50_COCO = MDQEModelCfg(backbone="resnet50", num_classes=80, hidden_dim=256, n_heads=8,
                        n_feature_levels=4, enc_layers=6, dec_layers=6, enc_points=4,
                        dec_points=4, n_frames=1, n_query=int(math.sqrt(200)) ** 2,
                        query_embed_dim=64, window_inter_frame_asso=5, dec_temporal=True)
R50_COCO_INF = InferenceCfg(num_classes=80, apply_cls_thres=0.05, multi_cls_on=True,
                            match_stride=4, coco_topk=100)
COCO_MIN_SIZE_TEST = 800
COCO_MAX_SIZE_TEST = 1333

SWINL = dataclasses.replace(SWIN_PRESETS["large"], drop_path_rate=0.2, pretrain_img_size=384)
SWINL_COCO = dataclasses.replace(R50_COCO, backbone="swin_large", swin=SWINL)
SWINL_OVIS = dataclasses.replace(SWINL_COCO, num_classes=25, n_frames=2)
SWINL_OVIS_INF = InferenceCfg(clip_stride=1, n_frames_test=2, n_frames_window_test=20,
                              max_num_instances=120, apply_cls_thres=0.1, multi_cls_on=True,
                              match_stride=4, clip_topk=150, num_classes=25)


def coco_test_size(h: int, w: int):
    """The (h, w) an image of size (h, w) is resized to for COCO testing: the
    short side to ``COCO_MIN_SIZE_TEST`` unless the long side would pass
    ``COCO_MAX_SIZE_TEST`` (``Trainer.test_coco`` of the JAX package)."""
    return size_for_test(h, w, COCO_MIN_SIZE_TEST, COCO_MAX_SIZE_TEST)
