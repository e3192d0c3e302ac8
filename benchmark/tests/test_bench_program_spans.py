"""The readers of the port's own spans and counters
(``benchlib/program_spans.py`` and the metrics that use it) on a synthetic
ring of requests: the median over the requests of their kind, None with no
such request or no tracer, and ``LAYER`` / ``MOVES`` as the manifest has
them."""
from __future__ import annotations

import collections
import json
import sys

import pytest
from bench_tiny import ROOT

from benchlib import manifest

from mdqe_cvpr2023_tpu_torch.utils import tracing

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {"vis.host_busy_ms_per_clip", "vis.host_wait_ms_per_clip", "vis.loop_ms_per_clip",
       "vis.syncs_per_clip", "track.assign_ms_per_clip", "train.loss_host_ms_per_step",
       "train.backward_host_ms_per_step", "train.optimizer_host_ms_per_step"}


def _entry(name):
    return next(m for m in MAN["per_layer"] if m["name"] == name)


def _reader(name):
    return manifest.metric_reader(manifest.load_cell(_entry(name)["workloads"][0]), name)


def _request(kind, spans, counters, rid):
    r = tracing.Request(kind, rid, {}, False)
    r.spans = {k: list(v) for k, v in spans.items()}
    r.counters = dict(counters)
    return r


def _video(rid, total, self_, waits, assign, clips, syncs):
    """A ``vis.video`` request: times in ms, each wait split over two names."""
    ns = 1e6
    spans = {"vis.video": [1, total * ns, self_ * ns],
             "vis.track.wait": [clips, waits / 2 * ns, waits / 2 * ns],
             "decoder.tca.wait": [3, waits / 2 * ns, waits / 2 * ns],
             "vis.track": [clips, (assign + waits / 2) * ns, 0],
             "vis.track.assign": [clips, assign * ns, assign * ns]}
    return _request("vis.video", spans, {"vis.clips": clips, "vis.syncs": syncs}, rid)


def _step(rid, loss, backward, optimizer):
    ns = 1e6
    spans = {"train.step": [1, (loss + backward + optimizer + 1) * ns, ns],
             "train.loss": [1, loss * ns, 0], "train.backward": [1, backward * ns, backward * ns],
             "train.optimizer": [1, optimizer * ns, optimizer * ns]}
    return _request("train.step", spans, {}, rid)


@pytest.fixture
def ring(monkeypatch):
    ring = collections.deque(maxlen=tracing.RING)
    monkeypatch.setattr(tracing, "_ring", ring)
    return ring


def test_the_new_metrics_are_listed_with_their_readers():
    listed = {m["name"] for m in MAN["per_layer"]}
    assert NEW <= listed
    for name in NEW:
        m, r = _entry(name), _reader(name)
        assert r.LAYER == m["layer"] and r.MOVES == m["moves"]
        assert m["source"] == ("program_counter" if "syncs" in name else "program_span")
        assert m["unit"] == ("count" if "syncs" in name else "ms")
        want = (["r50_ovis360.train"] if name.startswith("train.")
                else ["r50_ovis360.vis_crowded", "swinl_ovis.vis"])
        assert m["workloads"] == want


@pytest.mark.parametrize("name", sorted(NEW))
def test_none_without_a_request_of_its_kind(ring, name):
    assert _reader(name).read({}) is None
    ring.append(_request("image.infer", {"image.infer": [1, 5e6, 5e6]}, {}, 1))
    assert _reader(name).read({}) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_none_without_the_tracer(monkeypatch, name):
    """A port that has no tracer (an older checkout) reads None, and does
    not raise."""
    import mdqe_cvpr2023_tpu_torch.utils as utils
    monkeypatch.setitem(sys.modules, "mdqe_cvpr2023_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(utils, "tracing")
    with pytest.raises(ImportError):
        from mdqe_cvpr2023_tpu_torch.utils import tracing as _  # noqa: F401
    assert _reader(name).read({}) is None


def test_vis_readers_take_the_median_per_clip(ring):
    # (total, self, waits, assign) in ms, clips, syncs; the first and last
    # stand for the warm-up and the profiled passes
    rows = [(900.0, 90.0, 30.0, 40.0, 30, 300), (330.0, 33.0, 66.0, 99.0, 33, 132),
            (264.0, 66.0, 33.0, 33.0, 33, 99), (297.0, 99.0, 99.0, 66.0, 33, 165),
            (2000.0, 500.0, 900.0, 300.0, 33, 400)]
    for i, row in enumerate(rows):
        ring.append(_video(i, *row))
    ring.append(_step(99, 1.0, 2.0, 3.0))
    per = {"vis.host_busy_ms_per_clip": [(t - w) / c for t, _, w, _, c, _ in rows],
           "vis.host_wait_ms_per_clip": [w / c for _, _, w, _, c, _ in rows],
           "vis.loop_ms_per_clip": [s / c for _, s, _, _, c, _ in rows],
           "track.assign_ms_per_clip": [a / c for _, _, _, a, c, _ in rows],
           "vis.syncs_per_clip": [n / c for *_, c, n in rows]}
    for name, vals in per.items():
        got = _reader(name).read({})
        assert got == pytest.approx(sorted(vals)[2]), name
    assert _reader("vis.host_busy_ms_per_clip").read({}) == pytest.approx(8.0)
    assert _reader("vis.syncs_per_clip").read({}) == pytest.approx(5.0)


def test_a_request_without_clips_is_left_out(ring):
    ring.append(_video(1, 330.0, 33.0, 66.0, 99.0, 33, 132))
    ring.append(_request("vis.video", {"vis.video": [1, 1e6, 1e6]}, {}, 2))
    assert _reader("vis.host_wait_ms_per_clip").read({}) == pytest.approx(2.0)


def test_train_readers_take_the_median_per_step(ring):
    for i, (lo, bw, op) in enumerate([(300.0, 20.0, 9.0), (280.0, 18.0, 7.0),
                                      (290.0, 25.0, 8.0), (5000.0, 900.0, 90.0)]):
        ring.append(_step(i, lo, bw, op))
    ring.append(_video(9, 330.0, 33.0, 66.0, 99.0, 33, 132))
    assert _reader("train.loss_host_ms_per_step").read({}) == pytest.approx(295.0)
    assert _reader("train.backward_host_ms_per_step").read({}) == pytest.approx(22.5)
    assert _reader("train.optimizer_host_ms_per_step").read({}) == pytest.approx(8.5)


def test_a_traced_run_of_the_tracer_reads_back(ring):
    """Requests the tracer itself records read back as they were recorded."""
    with tracing.request("vis.video"):
        tracing.count("vis.clips", 4)
        tracing.count("vis.syncs", 6)
        with tracing.wait("vis.track.wait"):
            pass
    r = ring[-1]
    assert _reader("vis.syncs_per_clip").read({}) == pytest.approx(7 / 4)
    assert _reader("vis.host_wait_ms_per_clip").read({}) == pytest.approx(r.wait_ms() / 4)
    assert _reader("vis.host_busy_ms_per_clip").read({}) == pytest.approx(
        (r.total_ms("vis.video") - r.wait_ms()) / 4)
