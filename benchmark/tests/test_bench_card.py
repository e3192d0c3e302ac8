"""On a card: a cell at its published widths and a smaller input runs the
port's kernels through the harness and comes out correct, and its control
(the reference one precision step lower in the program's place) does not.
Marked ``cuda``; skips where no card is present."""
from __future__ import annotations

import pytest
import torch
from bench_tiny import SEED

from benchlib import manifest

pytestmark = pytest.mark.cuda

SMALL = {"r50_ovis360.vis_crowded": {"test_size": [192, 320], "frames": 12, "pool": 4},
         "swinl_ovis.vis": {"test_size": [192, 320], "frames": 8, "pool": 4},
         "r50_ovis360.train": {"buckets": [[192, 320], [224, 320], [192, 352]]}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _small(name):
    cell = manifest.load_cell(name)
    size = SMALL[name]
    if "buckets" in size:
        cell.config["train"]["buckets"] = size["buckets"]
    else:
        cell.config["test_size"] = size["test_size"]
        cell.traffic.update(frames=size["frames"], pool=size["pool"])
    return cell


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("sut", ["program", "control"])
def test_card_run(card, name, sut):
    import run
    out = run.run_cell(_small(name), SEED, 1.0, False, card, sut)
    assert out["device"]["platform"] == "gpu"
    if sut == "program":
        assert out["correct"], out["compared"]
    else:
        assert not out["correct"], out["compared"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_card_traced_run_reads_every_per_layer_metric(card, name):
    """A traced run on the card reads each per-layer metric the cell lists,
    the rooflines from the trace's kernels inside the benchmark's ranges,
    and no share of a roofline or a peak above 100%."""
    import run
    cell = _small(name)
    out = run.run_cell(cell, SEED, 1.0, True, card)
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer}
    for metric, v in out["metrics"].items():
        if "roofline" in metric or "mfu" in metric or "idle_share" in metric:
            assert 0.0 < v["value"] <= 100.0, (metric, v)
    assert 0.0 < out["device"]["busy_s"] <= out["device"]["window_s"]
