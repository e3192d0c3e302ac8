"""Config system, the port's own copy of ``mdqe_cvpr2023_tpu/engine/config.py``:
a small yacs-style ``CfgNode`` with the schema defaults, YAML loading with
``_BASE_`` inheritance and dotted ``KEY VALUE`` overrides. PyYAML is imported
only by the functions that parse or write YAML, so a machine without it can
still build a config from a dict (``get_default_config`` and
``merge_from_other``).
"""
from __future__ import annotations

import copy
import os
from typing import List


class CfgNode(dict):
    """Attribute-access dict with recursive merge."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    @staticmethod
    def from_dict(d):
        node = CfgNode()
        for k, v in d.items():
            node[k] = CfgNode.from_dict(v) if isinstance(v, dict) else v
        return node

    def clone(self):
        return copy.deepcopy(self)

    def merge_from_other(self, other):
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), dict):
                self[k].merge_from_other(v)
            else:
                self[k] = CfgNode.from_dict(v) if isinstance(v, dict) else v

    def merge_from_list(self, opts: List[str]):
        import yaml
        if len(opts) % 2:
            raise ValueError(f"override list must be KEY VALUE pairs: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"unknown config key: {key}")
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config key: {key}")
            node[parts[-1]] = yaml.safe_load(value)

    def dump(self):
        import yaml

        def plain(d):
            return {k: plain(v) if isinstance(v, dict) else v for k, v in d.items()}
        return yaml.safe_dump(plain(self))


def get_default_config() -> CfgNode:
    """Schema defaults mirroring mdqe/config.py:5-85 + the D2 keys MDQE reads."""
    return CfgNode.from_dict({
        "MODEL": {
            "META_ARCHITECTURE": "MDQE",
            "WEIGHTS": "",
            "PIXEL_MEAN": [123.675, 116.280, 103.530],
            "PIXEL_STD": [58.395, 57.120, 57.375],
            "MASK_ON": True,
            "BACKBONE": {"NAME": "build_resnet_backbone", "FREEZE_AT": 2},
            "RESNETS": {"DEPTH": 50, "STRIDE_IN_1X1": False,
                        "OUT_FEATURES": ["res3", "res4", "res5"]},
            "SWIN": {"TYPE": "large", "PRETRAIN_IMG_SIZE": 384, "PATCH_SIZE": 4,
                     "EMBED_DIM": 192, "DEPTHS": [2, 2, 18, 2],
                     "NUM_HEADS": [6, 12, 24, 48], "WINDOW_SIZE": 12,
                     "DROP_PATH_RATE": 0.2, "APE": False,
                     "OUT_FEATURES": ["stage3", "stage4", "stage5"]},
            "MDQE": {
                "NUM_CLASSES": 80,
                "BOX_WEIGHT": 2.0, "MASK_WEIGHT": 4.0, "DICE_WEIGHT": 4.0,
                "DEEP_SUPERVISION": True, "NO_OBJECT_WEIGHT": 1,
                "MASK_STRIDE": 4, "MATCH_STRIDE": 4, "MASK_DIM": 32,
                "NUM_MASK_LAYERS": 1,
                "NHEADS": 8, "DROPOUT": 0.1, "MLP_RATIO": 4,
                "ENC_LAYERS": 6, "DEC_LAYERS": 6, "PRE_NORM": False,
                "HIDDEN_DIM": 256, "NUM_OBJECT_QUERIES": 200,
                "NUM_FEATURE_LEVELS": 4, "ENC_NUM_POINTS": 4, "DEC_NUM_POINTS": 4,
                "DEC_TEMPORAL": True,
                "QUERY_EMBED_DIM": 64, "WINDOW_INTER_FRAME_ASSOCIATION": 5,
                "INTERINST_MASK_LOSS_ENABLED": True, "INTERINST_MASK_THRESHOLD": 0.1,
                "CLIP_STRIDE": 1, "SAMPLING_FRAME_NUM_TEST": 5,
                "WINDOW_FRAME_NUM_TEST": 20, "MAX_NUM_INSTANCES": 50,
                # MERGE_ON_CPU is accepted (the mirrored reference configs set
                # it) but deliberately ignored: it existed to dodge GPU OOM by
                # keeping tracker memory on CPU (reference mdqe.py:185-186);
                # here the tracker is fixed-shape with instance-chunked
                # finalization, so its device footprint is statically bounded
                # and the CPU fallback is obsolete (see PARITY.md).
                "MERGE_ON_CPU": False, "MULTI_CLS_ON": True, "APPLY_CLS_THRES": 0.05,
            },
        },
        "DATASETS": {"TRAIN": [], "TEST": [], "DATASET_RATIO": []},
        "DATALOADER": {"FILTER_EMPTY_ANNOTATIONS": True, "NUM_WORKERS": 4},
        "INPUT": {
            "FORMAT": "RGB",
            "PRETRAIN_FRAME_NUM": 1,
            "SAMPLING_FRAME_NUM": 3, "SAMPLING_FRAME_RANGE": 10,
            "SAMPLING_FRAME_SHUFFLE": False,
            "AUGMENTATIONS": [], "RANDOM_FLIP": "flip_by_clip",
            "MIN_SIZE_TRAIN": [320, 352, 384, 416, 448, 480, 512],
            "MIN_SIZE_TRAIN_SAMPLING": "choice_by_clip",
            "MAX_SIZE_TRAIN": 800, "MIN_SIZE_TEST": 360, "MAX_SIZE_TEST": 1333,
            "CROP": {"ENABLED": False, "TYPE": "relative_range", "SIZE": [0.8, 0.8]},
            # large-scale-jitter pipeline (reference mdqe/config.py:33-37;
            # flip -> ResizeScale -> FixedSizeCrop when enabled)
            "LSJ_AUG": {"ENABLED": False, "IMAGE_SIZE": 1024,
                        "MIN_SCALE": 0.1, "MAX_SCALE": 2.0},
            "PSEUDO": {
                "AUGMENTATIONS": ["rotation"],
                "MIN_SIZE_TRAIN": [480, 512, 544, 576, 608, 640, 672, 704, 736, 768],
                "MAX_SIZE_TRAIN": 768,
                "MIN_SIZE_TRAIN_SAMPLING": "choice_by_clip",
                "CROP": {"ENABLED": False, "TYPE": "absolute_range",
                         "SIZE": [384, 600]},
            },
        },
        "SOLVER": {
            "IMS_PER_BATCH": 16, "BASE_LR": 1e-4, "STEPS": [10000], "MAX_ITER": 12000,
            "WARMUP_FACTOR": 1.0, "WARMUP_ITERS": 10, "WEIGHT_DECAY": 1e-4,
            "OPTIMIZER": "ADAMW", "BACKBONE_MULTIPLIER": 0.1,
            "CLIP_GRADIENTS": {"ENABLED": True, "CLIP_TYPE": "full_model",
                               "CLIP_VALUE": 0.01, "NORM_TYPE": 2.0},
            # bf16 model + bf16-matmul criterion with fp32 islands (reference SOLVER.AMP,
            # configs/R50_coco.yaml:41-42; off by default like the reference)
            "AMP": {"ENABLED": False},
            "CHECKPOINT_PERIOD": 2000, "NUM_PRETRAIN_FRAMES": 1,
        },
        "TEST": {"EVAL_PERIOD": 2000, "DETECTIONS_PER_IMAGE": 15},
        "OUTPUT_DIR": "output/",
        "SEED": 0,
    })


def load_config(path: str, opts: List[str] | None = None) -> CfgNode:
    """Load a YAML config with `_BASE_` inheritance onto the schema defaults."""
    cfg = get_default_config()
    cfg.merge_from_other(_load_yaml_chain(path))
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg


def _load_yaml_chain(path: str) -> dict:
    import yaml
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    base = data.pop("_BASE_", None)
    if base:
        base_data = _load_yaml_chain(os.path.join(os.path.dirname(path), base))
        merged = CfgNode.from_dict(base_data)
        merged.merge_from_other(data)
        return merged
    return data
