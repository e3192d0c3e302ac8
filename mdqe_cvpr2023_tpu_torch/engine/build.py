"""Config -> the port's dataclasses (counterpart of
``mdqe_cvpr2023_tpu/engine/build.py``): the model, criterion, training and
inference configurations read from a ``CfgNode``, with the same derivations
(floor(sqrt(NUM_OBJECT_QUERIES))^2 queries, a per-clip detection slab of
min(10 * DETECTIONS_PER_IMAGE, queries)).
"""
from __future__ import annotations

import math

from ..losses.criterion import CriterionCfg
from ..models.detr import MDQEModelCfg
from ..models.meta import InferenceCfg
from ..models.swin import SwinCfg
from ..parallel.train import TrainCfg
from .config import CfgNode


def build_model_cfg(cfg: CfgNode) -> MDQEModelCfg:
    """A Swin backbone (MODEL.BACKBONE.NAME holding "swin") takes its preset
    name from MODEL.SWIN.TYPE and its configuration from MODEL.SWIN; it is v2
    only when the name holds "swinv2" (build_swin_backbone builds v1)."""
    name = cfg.MODEL.BACKBONE.NAME
    swin = None
    if "swin" in name.lower():
        sw = cfg.MODEL.SWIN
        backbone = f"swin_{sw.TYPE}"
        swin = SwinCfg(embed_dim=sw.EMBED_DIM, depths=tuple(sw.DEPTHS),
                       num_heads=tuple(sw.NUM_HEADS), window_size=sw.WINDOW_SIZE,
                       patch_size=sw.get("PATCH_SIZE", 4),
                       version=2 if "swinv2" in name.lower() else 1,
                       drop_path_rate=float(sw.get("DROP_PATH_RATE", 0.0)),
                       ape=bool(sw.get("APE", False)),
                       pretrain_img_size=int(sw.get("PRETRAIN_IMG_SIZE", 224)))
    else:
        backbone = f"resnet{cfg.MODEL.RESNETS.DEPTH}"
    m = cfg.MODEL.MDQE
    return MDQEModelCfg(
        backbone=backbone,
        swin=swin,
        num_classes=m.NUM_CLASSES,
        hidden_dim=m.HIDDEN_DIM,
        n_heads=m.NHEADS,
        n_feature_levels=m.NUM_FEATURE_LEVELS,
        enc_layers=m.ENC_LAYERS,
        dec_layers=m.DEC_LAYERS,
        enc_points=m.ENC_NUM_POINTS,
        dec_points=m.DEC_NUM_POINTS,
        n_frames=cfg.INPUT.SAMPLING_FRAME_NUM,
        n_query=int(math.sqrt(m.NUM_OBJECT_QUERIES)) ** 2,
        query_embed_dim=m.QUERY_EMBED_DIM,
        window_inter_frame_asso=m.WINDOW_INTER_FRAME_ASSOCIATION,
        mlp_ratio=float(m.MLP_RATIO),
        dec_temporal=m.DEC_TEMPORAL,
        mask_on=cfg.MODEL.MASK_ON,
    )


def build_criterion_cfg(cfg: CfgNode) -> CriterionCfg:
    m = cfg.MODEL.MDQE
    return CriterionCfg(
        num_classes=m.NUM_CLASSES,
        eos_coef=float(m.NO_OBJECT_WEIGHT),
        n_frames=cfg.INPUT.SAMPLING_FRAME_NUM,
        n_query=int(math.sqrt(m.NUM_OBJECT_QUERIES)) ** 2,
        window_inter_frame_asso=m.WINDOW_INTER_FRAME_ASSOCIATION,
        interinst_enabled=m.INTERINST_MASK_LOSS_ENABLED,
        interinst_threshold=m.INTERINST_MASK_THRESHOLD,
        box_weight=float(m.BOX_WEIGHT),
        mask_weight=float(m.MASK_WEIGHT),
        dice_weight=float(m.DICE_WEIGHT),
    )


def build_train_cfg(cfg: CfgNode) -> TrainCfg:
    """SOLVER.AMP.ENABLED is carried as ``amp``: the mixed-precision step
    (``make_train_step(amp=...)``); parameters and AdamW state stay fp32."""
    s = cfg.SOLVER
    return TrainCfg(
        base_lr=float(s.BASE_LR),
        weight_decay=float(s.WEIGHT_DECAY),
        backbone_multiplier=float(s.BACKBONE_MULTIPLIER),
        clip_norm=float(s.CLIP_GRADIENTS.CLIP_VALUE) if s.CLIP_GRADIENTS.ENABLED
        else 0.0,
        steps=tuple(s.STEPS),
        max_iter=int(s.MAX_ITER),
        warmup_iters=int(s.WARMUP_ITERS),
        warmup_factor=float(s.WARMUP_FACTOR),
        amp=bool(s.AMP.ENABLED),
        freeze_at=int(cfg.MODEL.BACKBONE.FREEZE_AT),
    )


def build_inference_cfg(cfg: CfgNode) -> InferenceCfg:
    m = cfg.MODEL.MDQE
    n_query = int(math.sqrt(m.NUM_OBJECT_QUERIES)) ** 2
    # the per-clip detection slab: up to 10 * DETECTIONS_PER_IMAGE deduped
    # candidates a clip go to the tracker, never more than the queries
    clip_topk = min(10 * cfg.TEST.DETECTIONS_PER_IMAGE, n_query)
    return InferenceCfg(
        clip_stride=m.CLIP_STRIDE,
        n_frames_test=m.SAMPLING_FRAME_NUM_TEST,
        n_frames_window_test=m.WINDOW_FRAME_NUM_TEST,
        max_num_instances=m.MAX_NUM_INSTANCES,
        apply_cls_thres=float(m.APPLY_CLS_THRES),
        multi_cls_on=m.MULTI_CLS_ON,
        match_stride=m.MATCH_STRIDE,
        clip_topk=clip_topk,
        num_classes=m.NUM_CLASSES,
    )
