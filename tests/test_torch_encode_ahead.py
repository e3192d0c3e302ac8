"""The window encode queued one window ahead of the clip loop
(``models/meta.py::_inference_vis``): as the loop enters encode window w it
queues window w + 1's uploads and ``encode_window`` calls (on a card on a
side stream) before w's decode batches and tracker steps.

On the CPU at a tiny size: the order of the calls to ``encode_window``,
``decode_clips_batched`` and ``tracker_step``, the encode calls against the
schedule's chunks (the same frames in the same order as one window at a
time), the counter ``vis.encode_ahead_frames``, and the sharded encode,
which keeps one window at a time. The tests marked ``cuda`` need a card
(they skip without one) and import neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_encode_ahead.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu_torch.models import meta
from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg
from mdqe_cvpr2023_tpu_torch.utils import tracing

torch.set_num_threads(2)

TINY = dict(backbone="resnet50", num_classes=5, hidden_dim=64, n_heads=4, enc_layers=1,
            dec_layers=1, n_frames=2, n_query=16, query_embed_dim=8, dec_temporal=True)
# windows of 4 frames, two chunks of 2 each; the gates open so the tracker fills
INF = meta.InferenceCfg(clip_stride=1, n_frames_test=2, n_frames_window_test=4,
                        max_num_instances=20, apply_cls_thres=0.0, clip_topk=8,
                        encode_chunk=2, num_classes=5, bf16_encode=False, dedup_sim=2.0,
                        suppress_siou=2.0, suppress_ctt=2.0)
HW = (40, 44)


def _video(n, hw=HW, seed=0):
    video = np.random.default_rng(seed).integers(0, 255, (n,) + hw + (3,)).astype(np.uint8)
    return meta.preprocess_frames(video)[0]


def _windows(n, inf):
    """The encode windows (start, end) of an n-frame video, in the clip
    loop's order: the schedule of ``_inference_vis``."""
    n = max(n, inf.n_frames_test)
    out, wend = [], 0
    for start in range(0, n, inf.clip_stride):
        if min(start + inf.n_frames_test, n) > wend:
            wend = min(start + inf.n_frames_window_test, n)
            out.append((start, wend))
        if start + inf.n_frames_test >= n:
            break
    return out


def _chunks(frames, inf):
    """(window index, frames) of each encode call one window at a time
    encodes: each window padded with its last frame to a chunk multiple."""
    out = []
    for w, (ws, we) in enumerate(_windows(frames.shape[0], inf)):
        wf = frames[ws:we]
        wlen = -(-wf.shape[0] // inf.encode_chunk) * inf.encode_chunk
        wf = np.concatenate([wf] + [wf[-1:]] * (wlen - wf.shape[0]))
        out += [(w, wf[c:c + inf.encode_chunk]) for c in range(0, wlen, inf.encode_chunk)]
    return out


@pytest.fixture
def calls(monkeypatch):
    """The calls to the three seams in order: ("encode", frames),
    ("decode", the window's encodings) and ("track",). The recorder keeps
    every tensor it sees, so no two windows share an object."""
    seen = []

    def spy(kind, fn, keep):
        def wrapped(*args, **kwargs):
            seen.append((kind, keep(args)))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(meta, "encode_window",
                        spy("encode", meta.encode_window, lambda a: a[1].clone()))
    monkeypatch.setattr(meta, "decode_clips_batched",
                        spy("decode", meta.decode_clips_batched, lambda a: a[1]))
    monkeypatch.setattr(meta, "tracker_step", spy("track", meta.tracker_step, lambda a: None))
    return seen


def _order(seen, chunks):
    """For each call its window: an encode call's from the schedule's chunks,
    a decode's from the order in which the loop reaches its encodings, a
    tracker step's from the decode before it."""
    out, enc_i, dec_objs, w_dec = [], 0, [], None
    for kind, x in seen:
        if kind == "encode":
            out.append(("encode", chunks[enc_i][0]))
            enc_i += 1
        elif kind == "decode":
            if not any(x is o for o in dec_objs):
                dec_objs.append(x)
            w_dec = next(i for i, o in enumerate(dec_objs) if x is o)
            out.append(("decode", w_dec))
        else:
            out.append(("track", w_dec))
    return out


@pytest.fixture(scope="module")
def model():
    return MDQEModel(MDQEModelCfg(**TINY), device="cpu", seed=0)


@pytest.mark.parametrize("n_frames", [15, 16])
def test_each_window_is_encoded_before_the_window_before_it_is_tracked(model, calls,
                                                                        n_frames):
    """A video of five windows (15 frames: the tail window 3 frames, padded
    to 4; 16 frames: 4): every window's encode calls come
    before the first tracker step of the window before it, the encode calls
    are the schedule's chunks in order, and ``vis.encode_ahead_frames`` is
    the padded frames of windows 2..n."""
    frames = _video(n_frames)
    chunks = _chunks(frames, INF)
    meta.inference_vis(model, INF, frames, HW, HW, device="cpu")
    req = tracing.last("vis.video")
    n_win = req.attrs["windows"]
    assert n_win == len(_windows(n_frames, INF)) == 5

    encodes = [x for kind, x in calls if kind == "encode"]
    assert len(encodes) == len(chunks)
    for got, (_, want) in zip(encodes, chunks):
        assert torch.equal(got, torch.from_numpy(want))

    order = _order(calls, chunks)
    first_track = {w: order.index(("track", w)) for w in range(n_win)}
    last_encode = {w: max(i for i, c in enumerate(order) if c == ("encode", w))
                   for w in range(n_win)}
    for w in range(1, n_win):
        assert last_encode[w] < first_track[w - 1], (w, order)
    # no window is queued two ahead: w's encode waits until the loop has
    # tracked every clip of w - 2
    for w in range(2, n_win):
        first_encode = order.index(("encode", w))
        last_track = max(i for i, c in enumerate(order) if c == ("track", w - 2))
        assert first_encode > last_track, (w, order)
    assert [w for kind, w in order if kind == "decode"] == sorted(
        w for kind, w in order if kind == "decode")

    ahead = sum(INF.encode_chunk for w, _ in chunks if w >= 1)
    assert req.counters["vis.encode_ahead_frames"] == ahead
    assert ahead == sum(f.shape[0] for w, f in chunks if w >= 1)


@pytest.mark.parametrize("n_frames", [4, 1])
def test_a_one_window_video_encodes_nothing_ahead(model, calls, n_frames):
    """One encode window (4 frames; 1 frame, padded to a clip): the encode
    calls are the window's chunks, before the first decode, and the counter
    reads 0."""
    frames = _video(n_frames)
    chunks = _chunks(np.concatenate([frames] + [frames[-1:]] * (2 - n_frames))
                     if n_frames < 2 else frames, INF)
    meta.inference_vis(model, INF, frames, HW, HW, device="cpu")
    req = tracing.last("vis.video")
    assert req.attrs["windows"] == 1
    assert req.counters["vis.encode_ahead_frames"] == 0
    kinds = [kind for kind, _ in calls]
    assert kinds[:len(chunks)] == ["encode"] * len(chunks)
    assert kinds.count("encode") == len(chunks)
    for (_, got), (_, want) in zip(calls, chunks):
        assert torch.equal(got, torch.from_numpy(want))


def test_the_sharded_encode_keeps_one_window_at_a_time(model, calls):
    """``devices=["cpu"] * 2``: each window is encoded when the loop
    reaches it, after the window before it is tracked, and the counter
    reads 0."""
    frames = _video(11)
    inf = dataclasses.replace(INF, encode_chunk=4)   # two frames a device
    meta.inference_vis(model, inf, frames, HW, HW, device="cpu", devices=["cpu"] * 2)
    req = tracing.last("vis.video")
    assert req.counters["vis.encode_ahead_frames"] == 0
    # each chunk's two shares, one call a device
    shares = [(w, f[k * 2:(k + 1) * 2]) for w, f in _chunks(frames, inf) for k in range(2)]
    order = _order(calls, shares)
    encodes = [x for kind, x in calls if kind == "encode"]
    assert len(encodes) == len(shares)
    for got, (_, want) in zip(encodes, shares):
        assert torch.equal(got, torch.from_numpy(want))
    n_win = req.attrs["windows"]
    for w in range(1, n_win):
        first_encode = order.index(("encode", w))
        last_track = max(i for i, c in enumerate(order) if c == ("track", w - 1))
        assert first_encode > last_track, (w, order)


# the three VIS cells' schedules: (video frames, clip frames, window frames,
# clips, frames queued ahead: windows 2..n padded to the chunk of 10)
CELLS = {
    "r50_ovis360": (36, 4, 30, 33, 10),
    "swinl_ovis": (36, 2, 20, 35, 20),
    "r50_ovis720": (100, 4, 20, 97, 100),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_cells_schedule_counts_the_frames_encoded_ahead(cell):
    """The cell's schedule at a tiny frame size: ``vis.encode_ahead_frames``
    over ``vis.clips`` is what ``vis.encode_ahead_frames_per_clip`` reads
    in the cell (100/97 at 720p, 20/35 Swin-L, 10/33 ``vis_crowded``)."""
    n, T, W, clips, ahead = CELLS[cell]
    model = MDQEModel(MDQEModelCfg(**dict(TINY, n_frames=T)), device="cpu", seed=0)
    inf = dataclasses.replace(INF, n_frames_test=T, n_frames_window_test=W, encode_chunk=10,
                              apply_cls_thres=0.05, dedup_sim=0.99, suppress_siou=0.4,
                              suppress_ctt=0.6)
    meta.inference_vis(model, inf, _video(n, (32, 32), seed=1), (32, 32), (32, 32),
                       device="cpu")
    req = tracing.last("vis.video")
    assert req.counters["vis.clips"] == clips
    assert req.counters["vis.encode_ahead_frames"] == ahead
    wins = _windows(n, inf)
    assert ahead == sum(-(-(we - ws) // 10) * 10 for ws, we in wins[1:])


# --- on a card -------------------------------------------------------------

@pytest.fixture
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the deformable attention has no CPU kernel")
    return MDQEModel(MDQEModelCfg(**TINY), device="cuda", seed=0)


def _assert_equal(got, want):
    assert got["num_tracks"] == want["num_tracks"]
    assert got["pred_scores"] == want["pred_scores"] and len(want["pred_scores"]) > 0
    assert got["pred_labels"] == want["pred_labels"]
    assert len(got["pred_masks"]) == len(want["pred_masks"])
    for a, b in zip(got["pred_masks"], want["pred_masks"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_card_side_stream_results_equal_the_loops_own_stream(cuda_model, monkeypatch, bf16):
    """Eleven windows of 4 frames, a chunk of 2 (the allocator hands the
    freed windows' blocks out again): the tracks, scores and masks with the
    encode on its side stream are bit-equal to the run with the encode on
    the loop's own stream, video after video; after the first video no
    pinned block is allocated or freed, and the counter reads the frames of
    windows 2..11."""
    inf = dataclasses.replace(INF, bf16_encode=bf16)
    frames = _video(33, (64, 96), seed=2)
    size = (64, 96)

    def run():
        out = meta.inference_vis(cuda_model, inf, frames, size, size, device="cuda")
        # copied out of the merge's pinned block, which is then free again
        return dict(out, pred_masks=[np.array(m) for m in out["pred_masks"]])
    side = [run()]
    stats = torch.cuda.host_memory_stats()
    side += [run(), run()]
    after = torch.cuda.host_memory_stats()
    assert after.get("num_host_alloc", 0) == stats.get("num_host_alloc", 0)
    assert after.get("num_host_free", 0) == stats.get("num_host_free", 0)
    req = tracing.last("vis.video")
    assert req.attrs["windows"] == len(_windows(33, inf)) == 11
    assert req.counters["vis.encode_ahead_frames"] == 10 * 4
    monkeypatch.setattr(meta, "_encode_stream",
                        lambda device: torch.cuda.current_stream(device))
    own = run()
    torch.cuda.synchronize()
    for out in side:
        _assert_equal(out, own)


@pytest.mark.cuda
def test_card_encode_runs_on_the_side_stream_below_the_loops(cuda_model, monkeypatch):
    """Every ``encode_window`` call runs with the side stream current, every
    decode batch and tracker step on the loop's stream, which the card
    serves first (a lower priority number), and the caller's stream is
    current again after the call."""
    seen = []

    def spy(kind, fn):
        def wrapped(*args, **kwargs):
            seen.append((kind, torch.cuda.current_stream()))
            return fn(*args, **kwargs)
        return wrapped

    for name in ("encode_window", "decode_clips_batched", "tracker_step"):
        monkeypatch.setattr(meta, name, spy(name, getattr(meta, name)))
    caller = torch.cuda.current_stream()
    meta.inference_vis(cuda_model, INF, _video(15), HW, HW, device="cuda")
    assert torch.cuda.current_stream() == caller
    side = meta._encode_stream(torch.device("cuda", torch.cuda.current_device()))
    enc = {s for kind, s in seen if kind == "encode_window"}
    rest = {s for kind, s in seen if kind != "encode_window"}
    assert enc == {side} and len(rest) == 1
    loop = rest.pop()
    assert loop not in (side, caller) and loop.priority < side.priority
    torch.cuda.synchronize()
