"""The cell ``r50_ovis720.vis_long``: its files resolve, the new readers
read the port's tracer, and on the CPU at a tiny size (the harness's look for
a card skipped) the long-video cell finalizes windows early and comes out
correct."""
from __future__ import annotations

import collections
import json

import pytest
from bench_tiny import ROOT, run_tiny, tiny_cell

from benchlib import manifest
from mdqe_cvpr2023_tpu_torch.utils import tracing

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
VIS_LONG = "r50_ovis720.vis_long"
NEW = {"vis.evict_rows_per_clip", "vis.finalize_host_ms_per_clip"}


def test_cells_resolve_with_their_metrics_and_limits():
    cell = manifest.load_cell(VIS_LONG)
    assert cell.traffic["kind"] == "vis_stream" and manifest.kind_module(cell).run
    assert {m["name"] for m in cell.end_to_end} == {"vis_clips_per_s", "setup_s"}
    assert set(cell.limits) == {"enc_gap", "score_gap", "mask_gap"}
    assert NEW <= {m["name"] for m in cell.per_layer}
    for m in cell.per_layer:
        reader = manifest.metric_reader(cell, m["name"])
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
    for m in MAN["per_layer"]:   # the new metrics are read in their cell alone
        if m["name"] in NEW:
            assert m["workloads"] == [VIS_LONG]
    assert all(0 < v < 1 for v in cell.limits.values())


def test_the_720p_configuration_as_published():
    cell = manifest.load_cell(VIS_LONG)
    c = cell.config
    assert c["test_size"] == [640, 1138] and c["reduced"] == []
    assert c["inference"]["n_frames_window_test"] == 20
    assert c["inference"]["apply_cls_thres"] == 0.2
    assert cell.traffic["frames"] == 100 and cell.traffic["gates"] == "off"
    assert cell.chips == 1


@pytest.fixture
def ring(monkeypatch):
    ring = collections.deque(maxlen=tracing.RING)
    monkeypatch.setattr(tracing, "_ring", ring)
    return ring


def _reader(name):
    return manifest.metric_reader(manifest.load_cell(VIS_LONG), name)


def _request(kind, spans, counters, rid):
    r = tracing.Request(kind, rid, {}, False)
    r.spans = {k: list(v) for k, v in spans.items()}
    r.counters = dict(counters)
    return r


@pytest.mark.parametrize("name", sorted(NEW))
def test_none_without_a_request_of_its_kind(ring, name):
    assert _reader(name).read({}) is None
    ring.append(_request("train.step", {"train.step": [1, 1e6, 1e6]}, {"vis.clips": 3}, 1))
    assert _reader(name).read({}) is None


def _video(rid, clips, rows, finalize_ms, wait_ms):
    ns = 1e6
    spans = {"vis.video": [1, 100 * ns, 10 * ns]}
    counters = {"vis.clips": clips}
    if rows is not None:
        spans["vis.finalize"] = [1, finalize_ms * ns, (finalize_ms - wait_ms) * ns]
        spans["vis.finalize.wait"] = [1, wait_ms * ns, wait_ms * ns]
        counters.update({"vis.evict_windows": 1, "vis.evict_rows": rows,
                         "vis.evict_bytes": rows * 1000})
    return _request("vis.video", spans, counters, rid)


def test_eviction_readers_take_the_median_per_clip(ring):
    # rows / clips 1.0, 1.2, 1.4 and finalize host ms / clip 0.1, 0.2, 0.3; a
    # video with no early finalize is left out
    for rid, (rows, fin, wait) in enumerate([(97, 12.7, 3.0), (116.4, 24.4, 5.0),
                                             (135.8, 35.1, 6.0)]):
        ring.append(_video(rid, 97, rows, fin, wait))
    ring.append(_video(9, 97, None, 0, 0))
    assert _reader("vis.evict_rows_per_clip").read({}) == pytest.approx(1.2)
    assert _reader("vis.finalize_host_ms_per_clip").read({}) == pytest.approx(0.2)


def test_tiny_long_video_finalizes_early_and_is_correct():
    """The long-video cell at a tiny size with a budget of two slabs: every
    video finalizes windows early; the traced run reads both eviction
    metrics and comes out correct."""
    cell = tiny_cell(VIS_LONG)
    cell.traffic.update(frames=18)
    cell.config["inference"]["slab_hbm_budget"] = 20000
    out = run_tiny(cell, trace=True)
    assert out["correct"], out["compared"]
    assert out["metrics"]["vis.evict_rows_per_clip"]["value"] > 0
    assert out["metrics"]["vis.finalize_host_ms_per_clip"]["value"] > 0
