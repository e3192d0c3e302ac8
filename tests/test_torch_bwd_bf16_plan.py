"""msda_bwd_bf16's host-side plan and its merge count, on the CPU.

The bf16 backward kernel (``ops/csrc/ms_deform_attn.cu``) launches one block
per entry of ``deform_attn.bwd_bf16_plan``: at Q == N (the encoder: the
queries are the levels' pixels in order) one per 4x8 tile of query pixels of
a level, the last row and column of tiles cut at the level's edge; at the
decoder sites one per block of d(value) rows of a level. The kernel maps
``blockIdx.x`` to its tile or rows with the same arithmetic, so the plan must
partition every level exactly, tails included; here it is held to a numpy
enumeration of the pixels. ``measure.msda_bf16_reds`` predicts the vector
reductions the tiled kernel sends (``chip_smoke.py --bwd-split`` counts them
on the card); here it is held to a plain loop.
"""
import collections
import re

import numpy as np
import pytest
import torch

import chip_smoke
from mdqe_cvpr2023_tpu_torch.ops import _build
from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da
from mdqe_cvpr2023_tpu_torch.tools import measure

TRAIN_SHAPES = ((64, 100), (32, 50), (16, 25), (8, 13))     # the R50 training encoder
SHAPE_SETS = {
    "r50_train": TRAIN_SHAPES,
    "swinl_train": ((92, 128), (46, 64), (23, 32), (12, 16)),
    "vis": ((48, 80), (24, 40), (12, 20), (6, 10)),
    "coco": ((100, 152), (50, 76), (25, 38), (13, 19)),
    "tails": ((13, 21), (7, 11), (3, 5), (1, 1)),
    "temporal": ((64, 100),) * 4,
}


def _label_tiles(shapes):
    """Per level, a (h, w) array of tile indices (-1 where none) painted from
    the plan, and the plan's rows of that level."""
    plan = da.bwd_bf16_plan(shapes, True)
    maps = [np.full((h, w), -1) for h, w in shapes]
    for t, (l, y0, x0, th, tw) in enumerate(plan):
        assert (maps[l][y0:y0 + th, x0:x0 + tw] == -1).all(), "tiles overlap"
        maps[l][y0:y0 + th, x0:x0 + tw] = t
    return plan, maps


@pytest.mark.parametrize("name", sorted(SHAPE_SETS))
def test_tile_plan_partitions_every_level(name):
    shapes = SHAPE_SETS[name]
    th, tw = da.BF16_TILE
    plan, maps = _label_tiles(shapes)
    first = 0
    for l, ((h, w), labels) in enumerate(zip(shapes, maps)):
        assert (labels >= 0).all(), f"level {l}: a pixel in no tile"
        yy, xx = np.mgrid[0:h, 0:w]
        nx = -(-w // tw)
        # row-major tiles of th x tw pixels from the level's corner, levels in order
        np.testing.assert_array_equal(labels, first + yy // th * nx + xx // tw)
        rows = [r for r in plan if r[0] == l]
        assert len(rows) == -(-h // th) * nx
        # tails: the last row and column of tiles are cut at the edge
        ny = -(-h // th)
        for _, y0, x0, t_h, t_w in rows:
            assert t_h == (h - (ny - 1) * th if y0 == (ny - 1) * th else th)
            assert t_w == (w - (nx - 1) * tw if x0 == (nx - 1) * tw else tw)
        first += len(rows)
    assert len(plan) == first == chip_smoke.n_tiles(shapes, da.BF16_TILE)


def test_tile_plan_of_the_training_encoder():
    """R50 at 512x800: 16 x 13 + 8 x 7 + 4 x 4 + 2 x 2 tiles; the last column
    of each level is cut to 4, 2, 1 and 5 pixels, the 16x25 level's rows are
    whole and the 8x13's too."""
    plan = da.bwd_bf16_plan(TRAIN_SHAPES, True)
    assert len(plan) == 208 + 56 + 16 + 4 == 284
    last_cols = [max((r for r in plan if r[0] == l), key=lambda r: r[2])[4] for l in range(4)]
    assert last_cols == [4, 2, 1, 5]
    assert all(r[3] == 4 for r in plan)


@pytest.mark.parametrize("name", sorted(SHAPE_SETS))
def test_value_plan_partitions_every_level(name):
    """The decoder sites' d(value) blocks: BF16_VALUE_ROWS rows each, the
    last block of a level cut at its end, every row of every level in exactly
    one block."""
    shapes = SHAPE_SETS[name]
    plan = da.bwd_bf16_plan(shapes, False)
    R = da.BF16_VALUE_ROWS
    seen = [np.zeros(h * w, int) for h, w in shapes]
    for l, r0, rows in plan:
        assert 0 < rows <= R and r0 % R == 0
        seen[l][r0:r0 + rows] += 1
    assert all((s == 1).all() for s in seen)
    assert len(plan) == sum(-(-h * w // R) for h, w in shapes)


@pytest.mark.parametrize("Q,P,segments", [(196, 4, 1), (256, 4, 1), (257, 4, 2), (256, 1, 1),
                                          (257, 1, 2), (200, 5, 1), (205, 5, 2),
                                          (1193, 4, 5), (1, 1024, 1), (2, 1024, 2)])
def test_value_segments(Q, P, segments):
    """The decoder sites' d(value) kernel stages at most 1024 points and 256
    queries at a time; with several segments it needs the fp32 scratch (the
    decoder sites' 196 queries of 4 points take one)."""
    assert da.bwd_bf16_segments(Q, P) == segments


def test_plan_constants_are_the_kernel_sources():
    """BF16_TILE, BF16_WINDOW and the BF16_VALUE_* constants are the
    kernel's kTileH, kTileW, kWindow, kValRows, kValPoints and kValQueries
    (the block counts, the merge and the scratch depend on them), and
    chip_smoke's tile text finds them."""
    src = (_build.CSRC / "ms_deform_attn.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kTileH"], const["kTileW"]) == da.BF16_TILE
    assert (const["kValRows"], const["kValPoints"], const["kValQueries"]) == (
        da.BF16_VALUE_ROWS, da.BF16_VALUE_POINTS, da.BF16_VALUE_QUERIES)
    assert (const["kTileH"], const["kTileW"], const["kWindow"]) == (*da.BF16_TILE,
                                                                    da.BF16_WINDOW)
    assert chip_smoke.BF16_TILE_TEXT in src
    # measure.msda_bf16_reds' slots: 4 a tap of a round
    assert "constexpr int kSlots = 4 * kRoundTaps;" in src


def _loop_reds(loc, shapes, D, tile):
    """The tiled kernel's reductions, counted one (b, head, tile, level,
    round) at a time with numpy: where the taps' bounding box spans W <= 512
    rows, distinct rows and the taps past a row's first slots // W (slots: 4
    a tap of the round); else taps; D / 4 each."""
    B, Q, H, L, P, _ = loc.shape
    slots = 4 * tile[0] * tile[1] * 16
    plan = [(l, y0, x0, th, tw) for l, (h, w) in enumerate(shapes)
            for y0 in range(0, h, tile[0]) for x0 in range(0, w, tile[1])
            for th, tw in [(min(tile[0], h - y0), min(tile[1], w - x0))]]
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    reds = 0
    for b in range(B):
        for hd in range(H):
            for ql, y0, x0, th, tw in plan:
                qs = [starts[ql] + (y0 + dy) * shapes[ql][1] + x0 + dx
                      for dy in range(th) for dx in range(tw)]
                for l, (h, w) in enumerate(shapes):
                    for p0 in range(0, P, 4):
                        pts = loc[b, qs, hd, l, p0:p0 + 4].reshape(-1, 2)
                        x = pts[:, 0] * np.float32(w) - np.float32(0.5)
                        y = pts[:, 1] * np.float32(h) - np.float32(0.5)
                        taps = [(int(np.floor(yy)) + cy, int(np.floor(xx)) + cx)
                                for xx, yy in zip(x, y) for cy in (0, 1) for cx in (0, 1)]
                        inside = [(r, c) for r, c in taps if 0 <= r < h and 0 <= c < w]
                        if not inside:
                            continue
                        rs, cs = zip(*inside)
                        span = (max(rs) - min(rs) + 1) * (max(cs) - min(cs) + 1)
                        if span <= 512:
                            counts = collections.Counter(inside)
                            reds += len(counts) + sum(max(0, n - slots // span)
                                                      for n in counts.values())
                        else:
                            reds += len(inside)
    return reds * (D // 4)


def _merge_inputs(kind, shapes, B, H, P, seed):
    """Q == N locations: encoder-like ("local"), spread over the levels
    ("spread": boxes wider than 512 rows on a level of 984 pixels), or a
    crowd ("crowd": each query's points on one pixel, a tenth of them on
    another 12 rows and 24 columns away, so that boxes of a few hundred rows
    hold rows with more taps than their slots)."""
    N = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(seed)
    ref = np.concatenate([np.stack([(np.mgrid[0:h, 0:w][1].ravel() + 0.5) / w,
                                    (np.mgrid[0:h, 0:w][0].ravel() + 0.5) / h], -1)
                          for h, w in shapes])
    L = len(shapes)
    if kind == "local":
        off = rng.uniform(-0.15, 0.15, (B, N, H, L, P, 2))
        return (ref[None, :, None, None, None, :] + off).astype(np.float32)
    if kind == "spread":
        return rng.uniform(-0.1, 1.1, (B, N, H, L, P, 2)).astype(np.float32)
    size = np.array([[w, h] for h, w in shapes], dtype=np.float64)[:, None]  # (L, 1, 2)
    pix = np.where(rng.random((B, N, H, L, P, 1)) < 0.1, [24.0, 12.0], [2.0, 2.0])
    return ((np.minimum(pix, size - 2) + 0.5 + rng.uniform(0.1, 0.4, (B, N, H, L, P, 2)))
            / size).astype(np.float32)


@pytest.mark.parametrize("kind", ["local", "spread", "crowd"])
@pytest.mark.parametrize("tile", [(4, 8), (8, 16)])
def test_merge_model_matches_a_loop(kind, tile):
    """measure.msda_bf16_reds against the loop on small Q == N problems with
    tail tiles and two rounds of points (P = 5): local samples (merged),
    spread ones (some boxes too wide: one reduction per tap) and a crowd (some
    taps past their row's slots)."""
    shapes = ((24, 41), (9, 19))
    N = 24 * 41 + 9 * 19
    B, H, D, P = 1, 1, 16, 5
    loc = _merge_inputs(kind, shapes, B, H, P, seed=len(kind))
    got, per_tap = measure.msda_bf16_reds(torch.zeros(B, N, H, D), shapes,
                                          torch.from_numpy(loc), tile)
    assert got == _loop_reds(loc, shapes, D, tile)
    assert per_tap == measure.msda_taps(torch.zeros(B, N, H, D), shapes,
                                        torch.from_numpy(loc))[1] * (D // 4)
    assert got <= per_tap


def test_merge_model_at_the_training_encoder():
    """On chip_smoke.py's encoder inputs (two of its (b, head) pairs) the 4x8
    tile, with its 512-row window and 4 slots a tap, sends 6.63x fewer
    reductions than one per tap, the 8x16 tile 7.66x (PERF.md: the predicted
    7.2x and 11.6x had no window and unbounded slots)."""
    rng = np.random.default_rng(300)  # chip_smoke.make_inputs' draws at seed 300
    rng.standard_normal((8, 8504, 8, 32), dtype=np.float32)  # the value
    refs = [np.stack([(np.mgrid[0:h, 0:w][1].ravel() + 0.5) / w,
                      (np.mgrid[0:h, 0:w][0].ravel() + 0.5) / h], -1) for h, w in TRAIN_SHAPES]
    ref = np.concatenate(refs).astype(np.float32)
    loc = ref[None, :, None, None, None, :] + rng.uniform(
        -0.05, 0.05, (8, 8504, 8, 4, 4, 2)).astype(np.float32)
    lo = torch.from_numpy(np.ascontiguousarray(loc[[0, 3]][:, :, [0, 5]]))
    value = torch.zeros(2, 8504, 2, 32)
    for tile, factor in (((4, 8), 6.63), ((8, 16), 7.66)):
        reds, per_tap = measure.msda_bf16_reds(value, TRAIN_SHAPES, lo, tile)
        assert per_tap / reds == pytest.approx(factor, abs=0.01)
