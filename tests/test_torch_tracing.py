"""The port's tracer (``mdqe_cvpr2023_tpu_torch/utils/tracing.py``): spans,
waits, counters and requests; the ``record_function`` ranges it opens while
a profiler runs and their clock; the Chrome export; and what
``inference_vis`` and ``train_step`` record, on the CPU at a tiny size.

The tests marked ``cuda`` need a card (they skip without one) and import
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""
import dataclasses
import json
import time
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from mdqe_cvpr2023_tpu_torch.losses.criterion import CriterionCfg
from mdqe_cvpr2023_tpu_torch.models import meta
from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg
from mdqe_cvpr2023_tpu_torch.ops import deform_attn
from mdqe_cvpr2023_tpu_torch.parallel import train as ptrain
from mdqe_cvpr2023_tpu_torch.utils import tracing

torch.set_num_threads(2)

TINY = dict(backbone="resnet50", num_classes=5, hidden_dim=64, n_heads=4, enc_layers=1,
            dec_layers=1, n_frames=2, n_query=16, query_embed_dim=8, dec_temporal=True)
INF = meta.InferenceCfg(clip_stride=2, n_frames_test=2, n_frames_window_test=4,
                        max_num_instances=20, apply_cls_thres=0.05, clip_topk=8,
                        encode_chunk=2, num_classes=5, bf16_encode=False)
# the gates open: every detection registers, so the tracker and the merge fill
CROWD = dataclasses.replace(INF, apply_cls_thres=0.0, dedup_sim=2.0, suppress_siou=2.0,
                            suppress_ctt=2.0)
VIS_SPANS = {"vis.video", "vis.encode_weights", "vis.upload", "vis.encode", "vis.decode",
             "vis.track", "vis.track.wait", "vis.track.assign", "vis.window", "vis.merge"}
CRIT = CriterionCfg(num_classes=5, n_frames=2, n_query=16, num_points=64)


def _busy(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def test_nesting_and_self_time():
    with tracing.request("t.req", tag=1) as req:
        with tracing.span("t.a"):
            _busy(0.002)
            with tracing.span("t.b"):
                _busy(0.003)
            with tracing.wait("t.c.wait"):
                _busy(0.001)
        with tracing.span("t.d"):
            for _ in range(3):
                with tracing.span("t.e"):
                    _busy(0.0005)
    assert tracing.last("t.req") is req and req.attrs == {"tag": 1}
    sp = req.spans
    assert set(sp) == {"t.req", "t.a", "t.b", "t.c.wait", "t.d", "t.e"}
    assert [sp[k][0] for k in ("t.req", "t.a", "t.b", "t.c.wait", "t.d", "t.e")] == \
        [1, 1, 1, 1, 1, 3]
    # self = total less the child spans, exactly
    assert sp["t.req"][2] == sp["t.req"][1] - sp["t.a"][1] - sp["t.d"][1]
    assert sp["t.a"][2] == sp["t.a"][1] - sp["t.b"][1] - sp["t.c.wait"][1]
    assert sp["t.d"][2] == sp["t.d"][1] - sp["t.e"][1]
    for k in ("t.b", "t.c.wait", "t.e"):
        assert sp[k][1] == sp[k][2]
    assert sp["t.a"][1] >= 6e6 and sp["t.e"][1] >= 1.5e6 and sp["t.a"][2] >= 2e6
    assert req.total_ms("t.a") == sp["t.a"][1] / 1e6 and req.self_ms("t.d") >= 0
    assert req.wait_ms() == sp["t.c.wait"][1] / 1e6
    assert req.counters == {"t.syncs": 1}
    assert req.end_ns - req.start_ns >= sp["t.req"][1]
    assert req.seconds()["t.b"] == sp["t.b"][1] / 1e9


def test_events_in_full_mode_name_their_parent():
    """In full mode every span is an event whose parent is the innermost
    span open around it; the aggregates are the events' sums."""
    tracing.clear_events()
    with tracing.full_mode():
        with tracing.request("t.req") as req:
            with tracing.span("t.a"):
                with tracing.span("t.b"):
                    _busy(0.001)
                with tracing.wait("t.b.wait", syncs=2):
                    assert tracing.open_spans() == ["t.req", "t.a", "t.b.wait"]
            with tracing.span("t.b"):
                _busy(0.001)
    assert tracing.mode() == {"full": False, "device": False}
    evs = tracing.events(req.id)
    tracing.clear_events()
    by = {(e["name"], e["parent"]): e for e in evs}
    root = by[("t.req", 0)]
    a = by[("t.a", root["id"])]
    assert by[("t.b.wait", a["id"])]["wait"] and not a["wait"]
    b_both = [by[("t.b", a["id"])], by[("t.b", root["id"])]]
    dur = {k: e["end_ns"] - e["start_ns"] for k, e in by.items()}
    assert req.spans["t.b"][:2] == [2, sum(e["end_ns"] - e["start_ns"] for e in b_both)]
    assert req.spans["t.a"][2] == dur[("t.a", root["id"])] - dur[("t.b", a["id"])] \
        - dur[("t.b.wait", a["id"])]
    assert req.counters == {"t.syncs": 2}
    for e in evs:
        assert root["start_ns"] <= e["start_ns"] <= e["end_ns"] <= root["end_ns"]
        assert "device_start_ns" not in e and e["request"] == req.id


def test_spans_outside_a_request_record_nothing():
    before = len(tracing.requests())
    with tracing.span("t.lone"), tracing.wait("t.lone.wait"):
        tracing.count("t.lone")
        assert tracing.open_spans() == []
    assert len(tracing.requests()) == before


def test_request_ring_keeps_the_last_4096():
    tracing.clear()
    for i in range(tracing.RING + 5):
        with tracing.request("t.ring", i=i):
            tracing.count("t.n", i)
    reqs = tracing.requests("t.ring")
    assert len(reqs) == tracing.RING == 4096
    assert [r.attrs["i"] for r in reqs] == list(range(5, tracing.RING + 5))
    assert all(r.counters.get("t.n", 0) == r.attrs["i"] for r in reqs)
    assert all(r.spans["t.ring"][0] == 1 for r in reqs)
    assert len({r.id for r in reqs}) == len(reqs)
    tracing.clear()
    assert tracing.requests() == [] and tracing.last() is None


def test_counters_and_a_registered_dict():
    counts = tracing.register("t.reg", {"x": 0, "y": 5})
    assert tracing.register("t.reg", counts) is counts
    assert sum(c is counts for _, c in tracing._REGISTERED) == 1
    with tracing.request("t.c") as req:
        tracing.count("t.k")
        tracing.count("t.k", 4)
        counts["x"] += 2
    assert req.counters == {"t.k": 5, "t.reg.x": 2}
    with tracing.request("t.c") as req:
        counts["y"] = 0          # reset inside the request
        counts["y"] += 3
    assert req.counters == {"t.reg.y": 3}
    # the deformable attention's launch counts are registered as they are
    for prefix, d in (("msda.fwd", deform_attn.LAUNCHES), ("msda.bwd", deform_attn.BWD_LAUNCHES),
                      ("msda.bwd_bf16", deform_attn.BWD_BF16_LAUNCHES)):
        assert any(p == prefix and c is d for p, c in tracing._REGISTERED)
    try:
        with tracing.request("t.c") as req:
            deform_attn.LAUNCHES["encoder"] += 1
            deform_attn.BWD_LAUNCHES["decoder_box"] += 2
    finally:
        deform_attn.LAUNCHES["encoder"] -= 1
        deform_attn.BWD_LAUNCHES["decoder_box"] -= 2
    assert req.counters == {"msda.fwd.encoder": 1, "msda.bwd.decoder_box": 2}


def test_a_nested_request_is_its_own():
    with tracing.request("t.outer") as outer:
        with tracing.span("t.s"):
            with tracing.request("t.inner") as inner:
                with tracing.span("t.s"):
                    tracing.count("t.k")
        tracing.count("t.k", 2)
    assert inner.counters == {"t.k": 1} and outer.counters == {"t.k": 2}
    assert inner.spans["t.s"][0] == 1 and outer.spans["t.s"][0] == 1
    assert tracing.last("t.outer") is outer and tracing.requests()[-2] is inner


def test_record_function_ranges_only_while_profiling(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    with tracing.request("t.rf"):
        with tracing.span("t.rf.a"), tracing.wait("t.rf.wait"):
            pass
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.request("t.rf"):
            with tracing.span("t.rf.a"), tracing.wait("t.rf.wait"):
                torch.ones(2) + 1
    assert opened == ["t.rf", "t.rf.a", "t.rf.wait"]
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert set(opened) <= names
    with tracing.request("t.rf"):
        with tracing.span("t.rf.a"):
            pass
    assert len(opened) == 3


def _clock_offsets():
    """Profile 7 spans; for each, (its host start and end less the
    profiler's range of the same span's, in ns)."""
    tracing.clear_events()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.full_mode():
            with tracing.request("t.clk") as req:
                for _ in range(3):
                    with tracing.span("t.clk.a"):
                        _busy(0.002)
                        with tracing.wait("t.clk.wait"):
                            _busy(0.001)
    evs = tracing.events(req.id)
    tracing.clear_events()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("t.clk"):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    assert sorted(ranges) == ["t.clk", "t.clk.a", "t.clk.wait"] and len(evs) == 7
    out = []
    for e in evs:
        r0, r1 = min(ranges[e["name"]], key=lambda r: abs(r[0] - e["start_ns"]))
        out.append((e["name"], e["start_ns"] - r0, e["end_ns"] - r1))
    return out


def test_spans_share_the_profiler_clock():
    """Each span's host start and end lie within 100 µs of the profiler's
    range of the same span. A first profiled span takes the profiler's
    one-time set-up (about a millisecond); and a host loaded by other
    processes may preempt the thread between the range's stamp and the
    span's, a few µs apart, so the 7 spans are measured up to 3 times and
    one measurement must hold for every span (a clock offset fails all)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.request("t.clk.first"), tracing.span("t.clk.first.a"):
            pass
    tries = []
    for _ in range(3):
        tries.append(_clock_offsets())
        if all(abs(d0) < 100_000 and abs(d1) < 100_000 for _, d0, d1 in tries[-1]):
            break
    assert all(abs(d0) < 100_000 and abs(d1) < 100_000 for _, d0, d1 in tries[-1]), tries


def test_export_chrome_round_trip(tmp_path):
    tracing.clear_events()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.full_mode():
            with tracing.request("t.ex") as req:
                with tracing.span("t.ex.a"):
                    _busy(0.001)
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    tracing.export_chrome(str(tmp_path / "spans.json"), like=str(tmp_path / "prof.json"))
    evs = tracing.events(req.id)
    tracing.clear_events()
    prof_trace = json.loads((tmp_path / "prof.json").read_text())
    ours = json.loads((tmp_path / "spans.json").read_text())
    base = ours["baseTimeNanoseconds"]
    assert base == prof_trace["baseTimeNanoseconds"]
    got = [e for e in ours["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in got] == [e["name"] for e in evs] == ["t.ex.a", "t.ex"]
    for g, e in zip(got, evs):
        assert g["tid"] == 0 and g["args"]["request"] == req.id
        assert g["args"]["parent"] == e["parent"] and g["args"]["id"] == e["id"]
        assert g["ts"] == pytest.approx((e["start_ns"] - base) / 1e3)
        assert g["dur"] == pytest.approx((e["end_ns"] - e["start_ns"]) / 1e3)
    # the profiler's range of the same span lies at the same µs: the two
    # overlap over nine tenths of the span (the clock test holds the edges)
    theirs = [e for e in prof_trace["traceEvents"] if e.get("name") == "t.ex.a"]
    assert len(theirs) == 1
    t, g = theirs[0], got[0]
    overlap = min(t["ts"] + t["dur"], g["ts"] + g["dur"]) - max(t["ts"], g["ts"])
    assert overlap >= 0.9 * g["dur"] and g["dur"] >= 1000, (t, g)
    tracing.export_chrome(str(tmp_path / "bare.json"))
    assert json.loads((tmp_path / "bare.json").read_text())["baseTimeNanoseconds"] == 0


def _n_clips(video_len, inf):
    n = 0
    for start in range(0, max(video_len, inf.n_frames_test), inf.clip_stride):
        n += 1
        if start + inf.n_frames_test >= max(video_len, inf.n_frames_test):
            break
    return n


def _list_index(idx):
    parts = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(p, (list, np.ndarray)) for p in parts)


class _DeviceReads(TorchFunctionMode):
    """The calls that would synchronize on a card, counted on the CPU: a
    read of a tensor on the host (``.cpu()``, ``int()``, ``.item()``, ...)
    and an upload of host data (``torch.tensor(device=)``, ``.to(device)``,
    an index given as a list), with the spans open at each. A
    ``.to(device, non_blocking=True)`` (the frames' upload from pinned
    memory) does not synchronize."""
    READS = {"cpu", "item", "tolist", "__int__", "__float__", "__bool__", "__index__"}

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if (name in self.READS
                or (name in ("tensor", "as_tensor") and "device" in kwargs)
                or (name == "to" and not kwargs.get("non_blocking") and (
                    "device" in kwargs or any(
                        isinstance(a, (torch.device, str)) for a in args[1:])))
                or (name in ("__getitem__", "__setitem__") and _list_index(args[1]))):
            self.reads.append((name, tracing.open_spans()))
        return func(*args, **kwargs)


@pytest.fixture(scope="module")
def tiny_model():
    return MDQEModel(MDQEModelCfg(**TINY), device="cpu", seed=0)


def _video(n=9, hw=(60, 62)):
    video = np.random.default_rng(0).integers(0, 255, (n,) + hw + (3,)).astype(np.uint8)
    return meta.preprocess_frames(video)[0]


@pytest.mark.parametrize("gates", ["config", "open"])
def test_inference_vis_records_its_spans_and_one_sync_per_device_read(tiny_model, gates):
    """A 9-frame video: the request ``vis.video`` with the stages' spans,
    ``vis.clips`` equal to the schedule's clips, ``vis.lsa_cells`` M x K a
    clip, and every call that would synchronize on a card made inside a
    ``*.wait`` span, one ``vis.syncs`` each."""
    inf = INF if gates == "config" else CROWD
    frames = _video()
    meta.inference_vis(tiny_model, inf, frames, (60, 62), (120, 124), device="cpu")
    mode = _DeviceReads()
    with mode:
        out = meta.inference_vis(tiny_model, inf, frames, (60, 62), (120, 124), device="cpu")
    req = tracing.last("vis.video")
    clips = _n_clips(9, inf)
    assert clips == 5 and req.attrs == {"frames": 9, "clips": clips, "windows": 3}
    assert VIS_SPANS <= set(req.spans), sorted(req.spans)
    assert req.counters["vis.clips"] == clips
    assert req.counters["vis.lsa_cells"] == clips * inf.max_num_instances * inf.clip_topk
    assert req.spans["vis.track"][0] == req.spans["vis.track.wait"][0] == clips
    assert req.spans["vis.track.assign"][0] == clips
    assert req.spans["vis.window"][0] == 3 and req.spans["vis.merge"][0] == 1
    outside = [(n, s) for n, s in mode.reads if not s or not s[-1].endswith(".wait")]
    assert outside == [], outside
    assert req.counters["vis.syncs"] == len(mode.reads)
    assert sum(n for k, (n, _, _) in req.spans.items() if k.endswith(".wait")) \
        <= req.counters["vis.syncs"]
    # the waits and the stages lie inside the request; its self time is the
    # loop between the stages
    total = req.spans["vis.video"][1]
    assert 0 < req.wait_ms() * 1e6 < total
    direct = ("vis.encode_weights", "vis.upload", "vis.encode", "vis.decode", "vis.track",
              "vis.window", "vis.merge")
    assert 0 <= req.spans["vis.video"][2] <= total - sum(req.spans[k][1] for k in direct)
    assert req.counters.get("msda.fwd.encoder", 0) == 0   # the CPU runs the plain version
    assert len(out["pred_scores"]) > 0


@pytest.mark.parametrize("n_frames", [9, 1])
def test_inference_vis_counts_what_the_merge_carries(tiny_model, n_frames):
    """``vis.merge_results`` is the results, ``vis.merge_bytes`` their bool
    masks' bytes over the padded video (a 1-frame video is padded to a
    clip), before the cut to the video's own frames."""
    out = meta.inference_vis(tiny_model, CROWD, _video(n_frames), (60, 62), (120, 124),
                             device="cpu")
    req = tracing.last("vis.video")
    video_len = max(n_frames, CROWD.n_frames_test)
    assert req.counters["vis.merge_results"] == len(out["pred_scores"]) > 0
    assert req.counters["vis.merge_bytes"] == sum(
        m.nbytes for m in out["pred_masks"]) * video_len // n_frames
    assert all(m.shape == (n_frames, 120, 124) for m in out["pred_masks"])


def test_train_step_records_its_phases():
    model = MDQEModel(MDQEModelCfg(**TINY), device="cpu", seed=0)
    opt = ptrain.make_optimizer(model, ptrain.TrainCfg())
    step = ptrain.make_train_step(CRIT, dropout_rate=0.1)
    batch = ptrain.to_device(ptrain.synthetic_batch(0, clips=2, frames=2, hp=64, wp=64,
                                                    slots=3, n_inst=2, num_classes=5), "cpu")
    gen = torch.Generator().manual_seed(0)
    n_before = len(tracing.requests("train.step"))
    for _ in range(2):
        total, _ = step(model, opt, batch, gen)
    reqs = tracing.requests("train.step")
    assert len(reqs) - n_before == 2 and np.isfinite(float(total))
    sp = reqs[-1].spans
    assert {"train.step", "train.loss", "train.forward", "train.criterion", "train.backward",
            "train.optimizer"} <= set(sp)
    assert "train.allreduce" not in sp          # one process: no exchange
    assert all(sp[k][0] == 1 for k in ("train.loss", "train.backward", "train.optimizer"))
    # the forward and the criterion lie under the loss
    assert sp["train.loss"][2] == sp["train.loss"][1] - sp["train.forward"][1] \
        - sp["train.criterion"][1]
    assert sp["train.step"][2] == sp["train.step"][1] - sp["train.loss"][1] \
        - sp["train.backward"][1] - sp["train.optimizer"][1]
    assert reqs[-1].counters["train.syncs"] >= 2     # the forward's uploads
    assert tracing.span_s(reqs[-1], "train.allreduce") == 0.0
    assert tracing.span_s(reqs[-1], "train.backward") == pytest.approx(sp["train.backward"][1] / 1e9)


# --- on a card -------------------------------------------------------------

@pytest.fixture
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the deformable attention has no CPU kernel")
    return MDQEModel(MDQEModelCfg(**TINY), device="cuda", seed=0)


def _syncs_reported(fn):
    """(fn's result, the synchronizing calls ``set_sync_debug_mode("warn")``
    reports while it runs, each with the port's frames of its stack)."""
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        port = [f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno}" for f in stack
                if "mdqe_cvpr2023_tpu_torch" in f.filename]
        seen.append(port[-3:] or [f"{f.filename}:{f.lineno}:{f.name}" for f in stack[-6:]])
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        seen.clear()    # switching the mode on may report once, from torch's own frames
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, seen


@pytest.mark.cuda
@pytest.mark.parametrize("gates", ["config", "open"])
def test_card_vis_syncs_equal_the_synchronizing_calls(cuda_model, gates):
    inf = dataclasses.replace(INF if gates == "config" else CROWD, bf16_encode=True)
    frames = _video()

    def run():
        return meta.inference_vis(cuda_model, inf, frames, (60, 62), (120, 124),
                                  device="cuda")
    run()
    _, seen = _syncs_reported(run)
    req = tracing.last("vis.video")
    assert req.counters["vis.syncs"] == len(seen), seen
    assert req.counters.get("msda.fwd.encoder", 0) > 0


@pytest.mark.cuda
def test_card_full_mode_with_device_timing_adds_no_sync(cuda_model):
    frames = _video()

    def run():
        return meta.inference_vis(cuda_model, CROWD, frames, (60, 62), (120, 124),
                                  device="cuda")
    run()
    _, plain = _syncs_reported(run)
    tracing.clear_events()

    def run_full():
        with tracing.full_mode(device=True):
            return run()
    _, full = _syncs_reported(run_full)
    req = tracing.last("vis.video")
    assert len(full) == len(plain) == req.counters["vis.syncs"]
    evs = tracing.events(req.id)
    tracing.clear_events()
    dev_ms = tracing.device_ms(evs)
    assert {"vis.video", "vis.encode", "vis.decode", "vis.track"} <= set(dev_ms)
    assert all(v >= 0 for v in dev_ms.values())
    root = [e for e in evs if e["name"] == "vis.video"][0]
    assert root["device_end_ns"] >= root["device_start_ns"] >= root["start_ns"] - 1_000_000


@pytest.mark.cuda
def test_card_train_step_device_times():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = MDQEModel(MDQEModelCfg(**TINY), device="cuda", seed=0)
    opt = ptrain.make_optimizer(model, ptrain.TrainCfg())
    step = ptrain.make_train_step(CRIT, dropout_rate=0.1)
    batch = ptrain.to_device(ptrain.synthetic_batch(0, clips=2, frames=2, hp=128, wp=128,
                                                    slots=3, n_inst=2, num_classes=5), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(model, opt, batch, gen)
    tracing.clear_events()
    with tracing.full_mode(device=True):
        total, _ = step(model, opt, batch, gen)
    float(total)
    req = tracing.last("train.step")
    ms = tracing.device_ms(tracing.events(req.id))
    tracing.clear_events()
    assert {"train.loss", "train.backward", "train.optimizer"} <= set(ms)
    assert ms["train.step"] >= ms["train.loss"] > 0
    assert req.counters["msda.bwd.encoder"] > 0
