"""The port's demos against the repository's JAX-side demos, on the CPU:
AsyncPredictor's ordered put/get contract, TrackVisualizer's colours and
labels (and, with OpenCV, its drawing), the clip demo's ``pseudo_clip``
against the same steps on the JAX package's augmentation, the video demo's
``predict`` against ``inference_vis``, ``build_metadata`` and
``dedup_tracks``; the demos' entry points raise without a card unless
``--device cpu``."""
import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu.data.augmentation import AugmentationPipeline as JPipeline
from mdqe_cvpr2023_tpu.data.augmentation import apply_transforms as japply
from mdqe_cvpr2023_tpu_torch.data.image import resize_image, size_for_test
from mdqe_cvpr2023_tpu_torch.demo import clip_demo, demo, visualizer_from_json
from mdqe_cvpr2023_tpu_torch.demo.predictor import AsyncPredictor
from mdqe_cvpr2023_tpu_torch.demo.visualizer import TrackVisualizer
from mdqe_cvpr2023_tpu_torch.engine import config as tconfig
from mdqe_cvpr2023_tpu_torch.engine.trainer import Trainer
from mdqe_cvpr2023_tpu_torch.models.meta import inference_vis, preprocess_frames
from synth_dataset import TINY_OVERRIDES

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_demo(name):
    """A module of the repository's ``demo/`` (a directory of scripts, not a
    package), loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_demo_{name}",
                                                  os.path.join(ROOT, "demo", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


META = {"thing_classes": ["cat", "dog", "bird"],
        "thing_colors": [[220, 20, 60], [0, 82, 0], [119, 11, 32]]}


# ---------------------------------------------------------------------------
# AsyncPredictor (tests/test_async_predictor.py's cases)
# ---------------------------------------------------------------------------

def test_results_come_back_in_submission_order():
    def predict(x):
        time.sleep(0.05 if x == 0 else 0.0)  # later submissions finish first
        return x * 10

    p = AsyncPredictor(predict)
    for i in range(5):
        p.put(i)
    assert [p.get() for _ in range(5)] == [0, 10, 20, 30, 40]
    assert len(p) == 0
    p.shutdown()


def test_call_is_synchronous_and_reusable():
    p = AsyncPredictor(lambda x: x + 1)
    assert p(41) == 42
    assert p(1) == 2
    p.shutdown()


def test_worker_exception_reraised_from_get():
    def predict(x):
        if x == "bad":
            raise ValueError("boom")
        return x

    p = AsyncPredictor(predict)
    p.put("ok")
    p.put("bad")
    assert p.get() == "ok"
    with pytest.raises(ValueError, match="boom"):
        p.get()
    assert p("after") == "after"  # the worker survives and keeps serving
    p.shutdown()


# ---------------------------------------------------------------------------
# TrackVisualizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metadata", [META, None], ids=["metadata", "palette"])
def test_track_colors_and_labels_match_jax(metadata):
    jviz = _jax_demo("visualizer").TrackVisualizer(metadata=metadata)
    viz = TrackVisualizer(metadata=metadata)
    rng = np.random.default_rng(0)
    pairs = list(zip(rng.integers(0, 600, 50), rng.integers(-1, 5, 50)))
    for track, cls in pairs:
        np.testing.assert_array_equal(viz.track_color(int(track), int(cls)),
                                      jviz.track_color(int(track), int(cls)))
        score = float(rng.random())
        assert viz._label_text(int(track), int(cls), score) == \
            jviz._label_text(int(track), int(cls), score)


def _masks(t):
    m0 = np.zeros((64, 96), bool)
    m0[10:30, 10 + 2 * t:30 + 2 * t] = True
    m1 = np.zeros((64, 96), bool)
    m1[40:60, 50 - t:70 - t] = True
    return [m0, m1]


def test_draw_frame_and_video_match_jax():
    pytest.importorskip("cv2")
    jviz = _jax_demo("visualizer").TrackVisualizer(metadata=META)
    viz = TrackVisualizer(metadata=META)
    frames = [np.full((64, 96, 3), 60 + 20 * t, np.uint8) for t in range(3)]
    pred_masks = [np.stack([_masks(t)[i] for t in range(3)]) for i in range(2)]
    got = list(viz.draw_video(frames, pred_masks, [0, 1], [0.9, 0.5], score_threshold=0.3))
    want = list(jviz.draw_video(frames, pred_masks, [0, 1], [0.9, 0.5], score_threshold=0.3))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the clip demo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("no_aug", [True, False], ids=["no_aug", "aug"])
@pytest.mark.parametrize("n_frames", [1, 3])
def test_pseudo_clip_matches_jax_augmentation(no_aug, n_frames):
    """The JAX clip demo's steps (demo/clip_demo.py:67-107) on the JAX
    package's AugmentationPipeline and apply_transforms: the same uint8 batch
    and size for three images drawn in turn from one default_rng(0)."""
    cfg = tconfig.load_config(os.path.join(ROOT, "configs", "R50_coco.yaml"))
    pipe = clip_demo.clip_pipeline(cfg, no_aug)
    jpipe = JPipeline(
        min_sizes=[cfg.INPUT.MIN_SIZE_TEST] if no_aug else list(cfg.INPUT.MIN_SIZE_TRAIN),
        max_size=cfg.INPUT.MAX_SIZE_TRAIN, crop_enabled=not no_aug and cfg.INPUT.CROP.ENABLED,
        crop_type=cfg.INPUT.CROP.TYPE, crop_size=tuple(cfg.INPUT.CROP.SIZE),
        is_train=not no_aug)
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    images = np.random.default_rng(1).integers(0, 255, (3, 90, 120, 3)).astype(np.uint8)
    for img in images:
        batch, size = clip_demo.pseudo_clip(pipe, rng, img, n_frames)
        tfms = jpipe.sample(jrng, (90, 120), n_frames=n_frames)
        frames = [japply(tfms, img, np.zeros((0, 4)), np.zeros((0, 90, 120), bool), t)[0]
                  for t in range(n_frames)]
        fh, fw = max(f.shape[0] for f in frames), max(f.shape[1] for f in frames)
        want = np.zeros((n_frames, -(-fh // 32) * 32, -(-fw // 32) * 32, 3), np.uint8)
        for t, f in enumerate(frames):
            want[t, :f.shape[0], :f.shape[1]] = f
        assert size == (fh, fw)
        assert batch.dtype == np.uint8
        np.testing.assert_array_equal(batch, want)
    if no_aug:
        assert size == size_for_test(90, 120, 800, 1333)


# ---------------------------------------------------------------------------
# the video demo
# ---------------------------------------------------------------------------

def _tiny_vis_cfg(out_dir):
    cfg = tconfig.load_config(os.path.join(ROOT, "configs", "R50_ovis_360.yaml"))
    cfg.merge_from_list(TINY_OVERRIDES + ["MODEL.MDQE.APPLY_CLS_THRES", "0.0",
                                          "OUTPUT_DIR", str(out_dir)])
    return cfg


def test_predict_equals_inference_vis(tmp_path):
    """The demo's ``predict`` (test-size resize, padding, the Trainer's model)
    gives what ``inference_vis`` gives on the same resized frames."""
    trainer = Trainer(_tiny_vis_cfg(tmp_path), device="cpu")
    frames = list(np.random.default_rng(0).integers(0, 255, (5, 48, 60, 3)).astype(np.uint8))
    out, stats = demo.predict(trainer, frames)
    th, tw = size_for_test(48, 60, 64, 1333)
    proc, _ = preprocess_frames(np.stack([resize_image(f, th, tw) for f in frames]))
    want = inference_vis(trainer.model, trainer.inf_cfg, proc, (th, tw), (48, 60),
                         device="cpu")
    assert out["num_tracks"] == want["num_tracks"] and out["num_tracks"] >= 1
    assert out["pred_scores"] == want["pred_scores"]
    assert out["pred_labels"] == want["pred_labels"]
    for a, b in zip(out["pred_masks"], want["pred_masks"]):
        assert a.shape == (5, 48, 60)
        np.testing.assert_array_equal(a, b)
    assert stats["infer_s"] > 0
    t0, t1 = stats["infer_span"]
    assert t1 - t0 == stats["infer_s"]
    assert stats["msda_launches"] == {"encoder": 0, "decoder_box": 0, "decoder_inst": 0}
    rows = demo.track_results(out, 3)
    assert [r["score"] for r in rows] == out["pred_scores"]
    assert {r["video_id"] for r in rows} == {3}
    assert all(len(r["segmentations"]) == 5 for r in rows)


def test_read_frames_reads_a_directory_in_name_order(tmp_path):
    from PIL import Image
    frames = np.random.default_rng(0).integers(0, 255, (3, 8, 10, 3)).astype(np.uint8)
    for t in (2, 0, 1):
        Image.fromarray(frames[t]).save(tmp_path / f"f{t}.png")
    got = demo.read_frames(str(tmp_path))
    np.testing.assert_array_equal(np.stack(got), frames)


@pytest.mark.parametrize("names", [["ytvis_ovis_val"], ["ytvis_2019_val"],
                                   ["ytvis_2021_val"], []])
def test_build_metadata_matches_jax(names):
    assert demo.build_metadata(names) == _jax_demo("demo").build_metadata(names)


@pytest.mark.parametrize("module,extra", [
    (demo, ["--input", "x"]),
    (clip_demo, ["--input", "x.jpg"]),
], ids=["demo", "clip_demo"])
def test_demos_need_a_card_unless_device_cpu(module, extra, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the demos run there by default")
    if module is clip_demo:
        pytest.importorskip("cv2")
    config = "R50_ovis_360.yaml" if module is demo else "R50_coco.yaml"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--config-file", os.path.join(ROOT, "configs", config), *extra,
                     "--output", str(tmp_path)])


@pytest.mark.parametrize("spans,others,want", [
    ([(0.0, 2.0)], [(1.0, 3.0)], 1.0),
    ([(0.0, 1.0), (2.0, 4.0)], [(0.5, 2.5), (3.0, 3.5)], 1.5),
    ([(0.0, 1.0)], [(1.0, 2.0), (5.0, 6.0)], 0.0),
    ([(1.0, 2.0)], [(0.0, 9.0)], 1.0),
    ([], [(0.0, 1.0)], 0.0),
], ids=["partial", "several", "touching", "inside", "none"])
def test_overlap_s(spans, others, want):
    """The seconds that inference (the worker's spans) runs beside the main
    thread's reading, rendering and writing."""
    assert demo.overlap_s(spans, others) == want
    assert demo.overlap_s(others, spans) == want


def test_video_demo_cli_on_the_cpu(tmp_path, capsys):
    pytest.importorskip("cv2")
    from PIL import Image
    for v in range(2):
        os.makedirs(tmp_path / f"v{v}")
        for t, f in enumerate(np.random.default_rng(v).integers(0, 255, (5, 48, 60, 3))):
            Image.fromarray(f.astype(np.uint8)).save(tmp_path / f"v{v}" / f"f{t}.png")
    out = tmp_path / "out"
    demo.main(["--config-file", os.path.join(ROOT, "configs", "R50_ovis_360.yaml"),
               "--input", str(tmp_path / "v0"), str(tmp_path / "v1"), "--output", str(out),
               "--device", "cpu", "--confidence-threshold", "0",
               *TINY_OVERRIDES, "MODEL.MDQE.APPLY_CLS_THRES", "0.0"])
    for v in range(2):
        assert (out / f"v{v}.mp4").exists()
        assert json.loads((out / f"v{v}.json").read_text())
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    videos, run = lines[:-1], lines[-1]
    assert [v["video"] for v in videos] == ["v0", "v1"] and run["videos"] == 2
    for v in videos:
        assert v["infer_at"][1] - v["infer_at"][0] == pytest.approx(v["infer_s"])
        assert v["render_at"][1] - v["render_at"][0] == pytest.approx(v["render_s"])
    # video 1 is inferred while video 0 renders: the worker starts it as
    # soon as video 0's inference ends
    assert videos[1]["infer_at"][0] < videos[0]["render_at"][1]
    assert 0 < run["infer_in_render_s"] <= run["infer_hidden_s"] <= run["infer_s"]
    busy = sum(run[f"{k}_s"] for k in ("read", "infer", "render", "json"))
    assert busy - run["infer_hidden_s"] <= run["wall_s"] + 1e-6


# ---------------------------------------------------------------------------
# visualizer_from_json
# ---------------------------------------------------------------------------

def test_dedup_tracks_matches_jax():
    jmod = _jax_demo("visualizer_from_json")
    rng = np.random.default_rng(0)
    base = rng.random((30, 12, 14)) > 0.5
    masks = [base, base.copy(), rng.random((30, 12, 14)) > 0.5, base ^ (rng.random(
        (30, 12, 14)) > 0.9), np.zeros((30, 12, 14), bool), rng.random((30, 12, 14)) > 0.3]
    scores = list(rng.random(len(masks)))
    got = visualizer_from_json.dedup_tracks(masks, scores)
    assert got == jmod.dedup_tracks(masks, scores)
    assert got[0] == 0 and 1 not in got
    assert visualizer_from_json.dedup_tracks([], []) == jmod.dedup_tracks([], []) == []
