#!/usr/bin/env python3
"""Weight conversion (counterpart of the repository's
``tools/convert_weights.py``; the reference convert_inflated_weights.py):

1. ``inflate``: temporal inflation of the temp_attn_inst / temp_embed
   weights from --pretrain-frames to --num-frames
   (``engine/checkpoint.py::inflate_temporal_weights``); writes
   ``<source>_inflated_to_f<N>.pth`` (the Trainer also inflates on load when
   INPUT.PRETRAIN_FRAME_NUM != SAMPLING_FRAME_NUM);
2. ``to-d2``: prefix a raw Swin checkpoint's keys with
   ``detr.backbone.0.backbone.``; writes ``<source>_d2.pth``.

The JAX tool's third subcommand, ``to-jax`` (an orbax tree of the JAX
parameters), writes the JAX package's own format; the port loads ``.pth``
checkpoints directly (``engine/checkpoint.py::load_torch_checkpoint``).

Usage:
  python3 -m mdqe_cvpr2023_tpu_torch.tools.convert_weights inflate --source model.pth
      --num-frames 4 [--pretrain-frames 1]
  python3 -m mdqe_cvpr2023_tpu_torch.tools.convert_weights to-d2 --source swin.pth
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..engine.checkpoint import inflate_temporal_weights


def _state(path: str):
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("model", ckpt)


def inflate(source: str, num_frames: int, pretrain_frames: int = 1) -> str:
    state = {k: np.asarray(v) for k, v in _state(source).items()}
    out = inflate_temporal_weights(state, pretrain_frames, num_frames)
    path = source[:-4] + f"_inflated_to_f{num_frames}.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}, path)
    return path


def to_d2(source: str) -> str:
    out = {"detr.backbone.0.backbone." + k: v for k, v in _state(source).items()}
    path = source[:-4] + "_d2.pth"
    torch.save(out, path)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description="checkpoint conversion")
    sub = p.add_subparsers(dest="cmd", required=True)
    i = sub.add_parser("inflate")
    i.add_argument("--source", required=True)
    i.add_argument("--num-frames", type=int, required=True)
    i.add_argument("--pretrain-frames", type=int, default=1)
    d = sub.add_parser("to-d2")
    d.add_argument("--source", required=True)
    args = p.parse_args(argv)
    if args.cmd == "inflate":
        path = inflate(args.source, args.num_frames, args.pretrain_frames)
    else:
        path = to_d2(args.source)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
