"""The frozen bounds (``benchlib/roofline.py``) against a count by hand on
a tiny input, and the peaks as published."""
from __future__ import annotations

import pytest
import torch
from bench_tiny import BENCH  # noqa: F401  (puts the benchmark on the path)

from benchlib import roofline


def _inputs():
    shapes = [(2, 3)]
    value = torch.zeros(1, 6, 1, 8)                     # B=1, N=6, H=1, D=8, fp32
    # query 0 at the level's centre: x = 0.5*3 - 0.5 = 1, y = 0.5*2 - 0.5 = 0.5,
    # corners (1,0) (2,0) (1,1) (2,1), all in range; query 1 at the corner
    # (0, 0): x = y = -0.5, only corner (0, 0) in range
    loc = torch.tensor([[0.5, 0.5], [0.0, 0.0]]).view(1, 2, 1, 1, 1, 2)
    attw = torch.ones(1, 2, 1, 1, 1)
    return value, shapes, loc, attw


def test_taps_by_hand():
    value, shapes, loc, _ = _inputs()
    assert roofline.msda_taps(value, shapes, loc) == (5, 5)   # rows (1,0)... and (0,0)


def test_forward_bound_by_hand():
    value, shapes, loc, attw = _inputs()
    nbytes = 5 * 8 * 4 + 4 * 4 + 2 * 4 + 2 * 8 * 4           # rows, loc, attw, output
    ms, by, got = roofline.msda_bound(value, shapes, loc, attw)
    assert got == nbytes and by == "bytes"
    assert ms == pytest.approx(max(nbytes / 3.35e12, 2 * 8 * 5 / 67e12) * 1e3)


def test_backward_bound_by_hand():
    value, shapes, loc, attw = _inputs()
    nbytes = 5 * 8 * 4 + 6 * 8 * 4 + 2 * 4 * 4 + 2 * 2 * 4 + 2 * 8 * 4
    ms, by, got, reds = roofline.msda_bwd_bound(value, shapes, loc, attw)
    assert got == nbytes and reds == 5 * 8 // 4
    assert ms == pytest.approx(max(nbytes / 3.35e12, 8 * 8 * 5 / 67e12) * 1e3)


def test_bf16_value_counts_two_bytes():
    value, shapes, loc, attw = _inputs()
    assert roofline.msda_bound(value.bfloat16(), shapes, loc, attw)[2] == \
        5 * 8 * 2 + 4 * 4 + 2 * 4 + 2 * 8 * 4


def test_peaks():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.PEAK_FLOP_PER_S == {"fp32": 67e12, "bf16": 989e12}
