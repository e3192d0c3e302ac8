"""Tiny versions of the benchmark's cells for the CPU tests: the same
configuration and traffic files with widths, depths, frames and sizes cut,
run through the harness on the CPU (the harness's look for a card
skipped)."""
from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import manifest  # noqa: E402

SEED = 2 ** 31 + 11   # past 32 signed bits, as a run's seed may be


def shrink(cell):
    """Cut ``cell`` (a ``manifest.Cell``) to a size a CPU test holds; its
    limits stay the cell's own."""
    c = cell.config
    c["model"].update(hidden_dim=64, n_heads=8, enc_layers=1, dec_layers=1, n_query=16,
                      query_embed_dim=8, num_classes=3)
    if "swin" in c["model"]:
        c["model"]["swin"].update(embed_dim=32, depths=[2, 2, 2, 2], num_heads=[2, 4, 8, 16],
                                  window_size=4)
    c["inference"].update(n_frames_test=2, n_frames_window_test=4, max_num_instances=6,
                          clip_topk=8, encode_chunk=4, num_classes=3)
    c["model"]["n_frames"] = 2
    c["test_size"] = [64, 96]
    if "train" in c:  # 128 and up: a smaller frame's extra level is 1x1, and
        # GroupNorm over so few values makes that level's gradient ill-conditioned
        c["train"].update(buckets=[[128, 128], [128, 160], [160, 128]], n_frames=2, slots=3)
    if cell.traffic["kind"] == "vis_stream":
        cell.traffic.update(frames=7, pool=2, objects=3)
    return cell


def tiny_cell(name: str):
    return shrink(manifest.load_cell(name))


def run_tiny(cell, seed: int = SEED, seconds: float = 0.0, trace: bool = False,
             sut: str = "program") -> dict:
    import run
    return run.run_cell(cell, seed, seconds, trace, "cpu", sut)
