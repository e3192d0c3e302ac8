"""Training / evaluation CLI of the port (counterpart of the repository's
``train_net.py``), on one card unless ``--device cpu``, or data-parallel over
the processes that ``python -m torch.distributed.run`` starts: with
WORLD_SIZE > 1 each rank joins the process group (``utils/dist.py``) and runs
on ``cuda:<LOCAL_RANK>`` unless ``--device`` names a device; the backend is
nccl on cards and gloo on the CPU unless ``--dist-backend`` says otherwise
(gloo for several ranks on one card). SOLVER.IMS_PER_BATCH is the global
batch.

Usage:
  python -m mdqe_cvpr2023_tpu_torch.train_net --config-file configs/R50_ovis_360.yaml
      [--eval-only] [--resume CKPT.pth] [--datasets-root DIR] [--max-iter N]
      [--max-videos N] [--profile-at I] [--log-every N] [--device cuda|cpu]
      [--dist-backend nccl|gloo] [KEY VALUE ...]
  python -m torch.distributed.run --nproc_per_node 2 -m mdqe_cvpr2023_tpu_torch.train_net
      --config-file ... [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from .utils import dist


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="MDQE training and testing (PyTorch)")
    p.add_argument("--config-file", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", default=None, help="checkpoint (.pth) to resume from")
    p.add_argument("--datasets-root", default=None)
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--max-videos", type=int, default=None,
                   help="cap eval videos (smoke tests)")
    p.add_argument("--profile-at", type=int, default=None,
                   help="capture a torch.profiler trace of 3 iterations from this one")
    p.add_argument("--log-every", type=int, default=20,
                   help="iterations per metrics.jsonl row")
    p.add_argument("--device", default=None,
                   help="cuda (the default; cuda:<LOCAL_RANK> under torch.distributed.run) "
                        "or cpu (the plain PyTorch path)")
    p.add_argument("--dist-backend", default=None, choices=dist.BACKENDS,
                   help="with WORLD_SIZE > 1: nccl (the default on cards, one rank per "
                        "card) or gloo (the CPU, or several ranks on one card)")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides: KEY VALUE pairs")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Returns the Trainer and the last test's metrics."""
    args = parse_args(argv)
    from .engine.config import load_config
    from .engine.trainer import Trainer

    cfg = load_config(args.config_file, args.opts or None)
    device = args.device
    distributed = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if distributed:
        import torch
        device = torch.device(device or f"cuda:{os.environ.get('LOCAL_RANK', '0')}")
        if device.type == "cuda":
            torch.cuda.set_device(device)  # before the model is built
        dist.init_from_env(device, args.dist_backend)
    try:
        trainer = Trainer(cfg, datasets_root=args.datasets_root, device=device)
        if args.resume:
            trainer.load_checkpoint(args.resume)
        if not args.eval_only:
            trainer.train(max_iter=args.max_iter, log_every=args.log_every,
                          profile_at=args.profile_at)
        metrics, _ = trainer.test(max_videos=args.max_videos)
    finally:
        if distributed:
            dist.destroy()
    return trainer, metrics


if __name__ == "__main__":
    main()
