"""The traffic generators are deterministic in the seed (large seeds
included), and different seeds make different inputs of the same sizes."""
from __future__ import annotations

import numpy as np
import torch
from bench_tiny import SEED, tiny_cell

from benchlib import common, manifest


def _videos(seed):
    cell = tiny_cell("r50_ovis360.vis_crowded")
    kind = manifest.kind_module(cell)
    return list(kind.make_videos(cell.traffic, tuple(cell.config["test_size"]), seed, "cpu", 2))


def test_videos_deterministic_in_the_seed():
    a, b, c = _videos(SEED), _videos(SEED), _videos(SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(x.shape == z.shape and x.dtype == np.uint8 for x, z in zip(a, c))
    assert not np.array_equal(a[0], c[0])


def _pool(seed):
    cell = tiny_cell("r50_ovis360.train")
    kind = manifest.kind_module(cell)
    ctx = common.Ctx(cell=cell, seed=seed, seconds=0, trace=False, device="cpu")
    pool, schedule = kind.make_pool(ctx)
    return pool, [schedule(k) for k in range(9)], kind


def test_training_batches_deterministic_in_the_seed():
    (a, sa, kind), (b, sb, _), (c, sc, _) = _pool(SEED), _pool(SEED), _pool(SEED + 1)
    assert sa == sb
    for key in a:
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name])
            assert a[key][name].shape == c[key][name].shape
    assert not torch.equal(a[(0, 0)]["images"], c[(0, 0)]["images"])
    # every seed the same instance counts, in another order
    counts = [sorted(int(n) for p in pool.values() for n in p["valid"].sum(1)) for pool in (a, c)]
    assert counts[0] == counts[1]
    # every round takes every bucket once; the first three steps differ
    for r in range(3):
        assert sorted(x[0] for x in sa[3 * r:3 * r + 3]) == [0, 1, 2]
    assert len(set(sa[:3])) == 3


def test_training_targets_are_consistent():
    pool, _, _ = _pool(SEED)
    for batch in pool.values():
        valid = batch["valid"]
        assert valid.sum(1).min() >= 1
        areas = batch["masks"].flatten(3).sum(-1)             # (B, N, T)
        assert bool(((areas > 0) == valid[..., None]).all())
        assert bool(((batch["ids"] >= 0) == valid[..., None]).all())
        b = batch["boxes"][valid]
        assert bool((b[..., 2] > b[..., 0]).all() and (b[..., 3] > b[..., 1]).all())
