"""The port's host data path against the JAX package's, on the CPU: the RLE
codec (golden vectors through both of the port's codecs) and its ops, the
YTVIS evaluator, dataset loading, the clip mapper, collation and the loader's
``batch_at(k)`` (bit-equal for k = 0..3, with 0 and 2 worker threads)."""
import json
import os

import numpy as np
import pytest

from mdqe_cvpr2023_tpu.data import augmentation as jaug
from mdqe_cvpr2023_tpu.data import dataset as jds
from mdqe_cvpr2023_tpu.data import rle as jrle
from mdqe_cvpr2023_tpu.data import ytvis_eval as jeval
from mdqe_cvpr2023_tpu_torch.data import augmentation as taug
from mdqe_cvpr2023_tpu_torch.data import dataset as tds
from mdqe_cvpr2023_tpu_torch.data import rle as trle
from mdqe_cvpr2023_tpu_torch.data import ytvis_eval as teval
from test_rle_golden import COUNTS_VECTORS

cv2 = pytest.importorskip("cv2")


def random_mask(rng, h, w, blobs=3):
    m = np.zeros((h, w), bool)
    for _ in range(blobs):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        m[y0:y0 + rng.integers(1, h // 2 + 2), x0:x0 + rng.integers(1, w // 2 + 2)] = True
    return m


# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------

@pytest.fixture(params=["python", "native"])
def codec(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(trle, "_LIB", False)
    elif not trle.load_native():
        pytest.fail("the native codec did not build with the host C++ compiler")
    return request.param


def test_golden_vectors_both_codecs(codec):
    for counts, s in COUNTS_VECTORS:
        assert trle.counts_to_string(counts) == s, (codec, counts)
        np.testing.assert_array_equal(trle.string_to_counts(s), counts, err_msg=codec)
    m = np.zeros((4, 4), bool)
    m[0, 0] = True
    assert trle.encode(m) == {"size": [4, 4], "counts": "01?"}
    assert trle.encode(np.ones((10, 10), bool)) == {"size": [10, 10], "counts": "0T3"}


def test_native_codec_is_built_from_source_under_build_host():
    lib = trle.load_native()
    assert lib
    assert "build/host/librle_codec_" in lib._name


def test_codecs_agree_on_random_masks():
    rng = np.random.default_rng(0)
    for _ in range(50):
        m = random_mask(rng, int(rng.integers(1, 70)), int(rng.integers(1, 70)),
                        blobs=int(rng.integers(0, 6)))
        counts = trle._runs(m.reshape(-1, order="F"))
        s = trle.counts_to_string(counts)
        assert s == trle.counts_to_string_py(counts) == jrle.counts_to_string(counts)
        np.testing.assert_array_equal(trle.string_to_counts(s), trle.string_to_counts_py(s))


def test_intersection_area_matches_jax_on_noise_and_edge_masks():
    """The sweep over interval end points against JAX's per-interval loop:
    pixel noise (thousands of runs), full, empty and one-pixel masks."""
    rng = np.random.default_rng(2)
    masks = [rng.random((37, 53)) < p for p in (0.1, 0.5, 0.9)]
    masks += [np.ones((37, 53), bool), np.zeros((37, 53), bool)]
    one = np.zeros((37, 53), bool)
    one[36, 52] = True
    masks.append(one)
    for a in masks:
        for b in masks:
            ra, rb = trle.encode(a), trle.encode(b)
            got = trle.intersection_area(ra, rb)
            assert got == jrle.intersection_area(ra, rb) == (a & b).sum()


def test_rle_ops_match_jax(codec):
    rng = np.random.default_rng(1)
    for _ in range(12):
        h, w = int(rng.integers(5, 50)), int(rng.integers(5, 50))
        a, b = random_mask(rng, h, w), random_mask(rng, h, w)
        ra, rb = trle.encode(a), trle.encode(b)
        assert ra == jrle.encode(a) and rb == jrle.encode(b)
        np.testing.assert_array_equal(trle.decode(ra), a.astype(np.uint8))
        assert trle.area(ra) == jrle.area(ra) == a.sum()
        assert trle.intersection_area(ra, rb) == jrle.intersection_area(ra, rb)
        for crowd in (False, True):
            assert trle.iou(ra, rb, crowd) == jrle.iou(ra, rb, crowd)
        for inter in (False, True):
            assert trle.merge([ra, rb], inter) == jrle.merge([ra, rb], inter)
        assert trle.encode_mask_batch(np.stack([a, b])) == jrle.encode_mask_batch(
            np.stack([a, b]))
    d = [trle.encode(random_mask(rng, 30, 30)) for _ in range(4)] + [None]
    g = [trle.encode(random_mask(rng, 30, 30)) for _ in range(3)] + [None, None]
    for crowd in (False, True):
        assert trle.video_iou(d, g, crowd) == jrle.video_iou(d, g, crowd)


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------

def assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "per_category":
            assert_metrics_equal(got[k], want[k])
        else:
            np.testing.assert_equal(got[k], want[k], err_msg=k)


def _gt_and_preds(seed=5):
    rng = np.random.default_rng(seed)
    videos = [{"id": v, "height": 40, "width": 40, "length": 3} for v in (1, 2)]
    cats = [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}, {"id": 3, "name": "c"}]
    anns, preds = [], []
    for v in (1, 2):
        for k, cat in enumerate([1, 2, 3]):
            masks = [random_mask(rng, 40, 40, blobs=1) for _ in range(3)]
            segs = [jrle.encode(m) for m in masks]
            segs[1] = None if k == 2 else segs[1]  # absent in one frame
            anns.append({"id": 10 * v + k, "video_id": v, "category_id": cat,
                         "segmentations": segs, "iscrowd": int(k == 1 and v == 2),
                         "areas": [int(m.sum()) for m in masks]})
            preds.append({"video_id": v, "category_id": cat,
                          "score": float(rng.uniform(0.3, 1.0)), "segmentations": list(segs)})
    return {"videos": videos, "annotations": anns, "categories": cats}, preds


def _wrong(preds):
    out = []
    for p in preds:
        masks = [np.zeros((40, 40), bool) for _ in p["segmentations"]]
        for m in masks:
            m[:2, :2] = True
        out.append({**p, "segmentations": [jrle.encode(m) for m in masks]})
    return out


@pytest.mark.parametrize("case", ["perfect", "missing", "wrong", "mixed"])
def test_evaluator_matches_jax(case):
    gt, preds = _gt_and_preds()
    if case == "missing":
        preds = preds[:2] + preds[4:]
    elif case == "wrong":
        preds = _wrong(preds)
    elif case == "mixed":
        rng = np.random.default_rng(9)
        preds = preds + _wrong(preds[:3]) + [
            {**p, "score": p["score"] * 0.5,
             "segmentations": [jrle.encode(random_mask(rng, 40, 40)) for _ in range(3)]}
            for p in preds]
    got = teval.YTVISEvaluator(gt).evaluate(preds)
    want = jeval.YTVISEvaluator(gt).evaluate(preds)
    assert_metrics_equal(got, want)
    if case == "perfect":
        assert got["AP"] == pytest.approx(100.0)


def test_evaluator_polygon_and_uncompressed_gt_match_jax():
    gt, preds = _gt_and_preds(seed=6)
    gt["annotations"][0]["segmentations"][0] = [[5, 5, 30, 5, 30, 25, 5, 25]]
    first = gt["annotations"][1]["segmentations"][0]
    gt["annotations"][1]["segmentations"][0] = {
        "size": first["size"], "counts": jrle.string_to_counts(first["counts"]).tolist()}
    assert_metrics_equal(teval.YTVISEvaluator(gt).evaluate(preds),
                         jeval.YTVISEvaluator(gt).evaluate(preds))


# ---------------------------------------------------------------------------
# datasets, mapper, collation, loader
# ---------------------------------------------------------------------------

def _rich_dataset(root):
    """3 videos x 8 frames of 48x80 (PNG files), 3 moving instances each:
    one absent from some frames, one with uncompressed RLE, one with a
    polygon in its first frame."""
    rng = np.random.default_rng(3)
    H, W, T = 48, 80, 8
    videos, anns = [], []
    os.makedirs(os.path.join(root, "frames"), exist_ok=True)
    for v in range(1, 4):
        names = []
        inst = [dict(y=int(rng.integers(0, 30)), x=int(rng.integers(0, 60)),
                     h=int(rng.integers(6, 18)), w=int(rng.integers(6, 20)),
                     dy=int(rng.integers(-2, 3)), dx=int(rng.integers(-3, 4)))
                for _ in range(3)]
        segs = [[] for _ in inst]
        boxes = [[] for _ in inst]
        for t in range(T):
            img = rng.integers(0, 60, (H, W, 3)).astype(np.uint8)
            for k, o in enumerate(inst):
                y, x = np.clip(o["y"] + o["dy"] * t, 0, H - o["h"]), \
                    np.clip(o["x"] + o["dx"] * t, 0, W - o["w"])
                m = np.zeros((H, W), bool)
                m[y:y + o["h"], x:x + o["w"]] = True
                img[m] = 80 + 50 * k
                if k == 0 and t in (2, 3):
                    segs[k].append(None)
                    boxes[k].append(None)
                    continue
                r = jrle.encode(m)
                if k == 1:
                    r = {"size": r["size"], "counts": jrle.string_to_counts(r["counts"]).tolist()}
                if k == 2 and t == 0:
                    r = [[float(x), float(y), float(x + o["w"]), float(y),
                          float(x + o["w"]), float(y + o["h"]), float(x), float(y + o["h"])]]
                segs[k].append(r)
                boxes[k].append([float(x), float(y), float(o["w"]), float(o["h"])])
            name = f"v{v}_{t}.png"
            cv2.imwrite(os.path.join(root, "frames", name), img[:, :, ::-1])
            names.append(name)
        videos.append({"id": v, "file_names": names, "height": H, "width": W, "length": T})
        for k in range(3):
            anns.append({"id": 10 * v + k, "video_id": v, "category_id": k + 1,
                         "segmentations": segs[k], "bboxes": boxes[k], "iscrowd": 0})
    gt = {"videos": videos, "annotations": anns,
          "categories": [{"id": k + 1, "name": f"c{k}"} for k in range(3)]}
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(gt, f)
    return path, os.path.join(root, "frames")


@pytest.fixture(scope="module")
def rich(tmp_path_factory):
    return _rich_dataset(str(tmp_path_factory.mktemp("rich")))


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    from synth_dataset import build_mini_dataset
    root = build_mini_dataset(tmp_path_factory.mktemp("mini"))
    return os.path.join(root, "ovis", "annotations_train.json"), os.path.join(
        root, "ovis", "train")


PIPELINES = {
    # configs/R50_ovis_360.yaml's INPUT, scaled to the tiny frames
    "relative_crop": dict(min_sizes=[32, 40, 48], max_size=96, crop_enabled=True,
                          crop_type="relative_range", crop_size=(0.8, 0.8)),
    "absolute_crop_color": dict(min_sizes=[40, 56], max_size=90, crop_enabled=True,
                                crop_type="absolute_range", crop_size=(24, 40),
                                color_kinds=["brightness", "contrast", "saturation"]),
    "lsj": dict(min_sizes=[48], max_size=96, lsj_enabled=True, lsj_image_size=64,
                lsj_min_scale=0.5, lsj_max_scale=1.5),
}


def _loader(mod_ds, mod_aug, records, pipe, workers, n_frames=3, batch=3):
    aug = mod_aug.AugmentationPipeline(**PIPELINES[pipe])
    mapper = mod_ds.ClipMapper(aug, n_frames, frame_range=3)
    buckets = [(64, 96), (96, 96)]
    return mod_ds.CombinedClipLoader([(records, mapper)], [1.0], batch, max_instances=4,
                                     seed=11, size_buckets=buckets, num_workers=workers)


def assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("which", ["mini", "rich"])
def test_load_ytvis_json_matches_jax(which, mini, rich):
    path, root = mini if which == "mini" else rich
    assert tds.load_ytvis_json(path, root) == jds.load_ytvis_json(path, root)


@pytest.mark.parametrize("pipe", sorted(PIPELINES))
def test_clip_mapper_and_collate_match_jax(pipe, rich):
    records = jds.load_ytvis_json(*rich)
    tmap = tds.ClipMapper(taug.AugmentationPipeline(**PIPELINES[pipe]), 3, frame_range=3)
    jmap = jds.ClipMapper(jaug.AugmentationPipeline(**PIPELINES[pipe]), 3, frame_range=3)
    tsamples, jsamples = [], []
    for i, rec in enumerate(records * 2):
        ts = tmap(rec, np.random.default_rng([4, i]), min_size=None)
        js = jmap(rec, np.random.default_rng([4, i]), min_size=None)
        assert ts["frame_idx"] == js["frame_idx"] and ts["video_id"] == js["video_id"]
        assert (ts["height"], ts["width"]) == (js["height"], js["width"])
        for k in ("images", "labels", "ids", "boxes", "masks"):
            assert ts[k].dtype == js[k].dtype, k
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
        tsamples.append(ts)
        jsamples.append(js)
    assert_batches_equal(tds.collate_clips(tsamples[:3], 4),
                         jds.collate_clips(jsamples[:3], 4))
    assert_batches_equal(tds.collate_clips(tsamples[3:], 2, pad_hw=(96, 128)),
                         jds.collate_clips(jsamples[3:], 2, pad_hw=(96, 128)))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("pipe", sorted(PIPELINES))
def test_batch_at_matches_jax(pipe, workers, mini, rich):
    for path, root in (mini, rich):
        records = jds.load_ytvis_json(path, root)
        tl = _loader(tds, taug, records, pipe, workers)
        jl = _loader(jds, jaug, records, pipe, 0)
        for k in range(4):
            assert_batches_equal(tl.batch_at(k), jl.batch_at(k))
        it = tl.iter_from(1)  # the stream (worker threads with workers > 0)
        for k in (1, 2, 3):
            assert_batches_equal(next(it), jl.batch_at(k))
        it.close()


def test_collated_batch_has_the_train_step_layout(rich):
    from mdqe_cvpr2023_tpu_torch.parallel.train import synthetic_batch
    b = _loader(tds, taug, tds.load_ytvis_json(*rich), "relative_crop", 0).batch_at(0)
    s = synthetic_batch(clips=3, frames=3, hp=b["images"].shape[1], wp=b["images"].shape[2],
                        slots=4, n_inst=2)
    for k in s:
        assert b[k].dtype == s[k].dtype and b[k].shape == s[k].shape, k


def test_coco_pseudo_videos_match_jax(tmp_path):
    """COCO images as one-frame videos (polygon and RLE segmentations, a
    crowd annotation dropped, a category map) and the pseudo-clip mapper with
    rotation."""
    rng = np.random.default_rng(2)
    images, anns = [], []
    for i in range(1, 4):
        img = rng.integers(0, 255, (40, 56, 3)).astype(np.uint8)
        cv2.imwrite(str(tmp_path / f"{i}.png"), img)
        images.append({"id": i, "file_name": f"{i}.png", "height": 40, "width": 56})
        m = random_mask(rng, 40, 56, blobs=1)
        anns.append({"id": 10 * i, "image_id": i, "category_id": 1, "iscrowd": 0,
                     "segmentation": jrle.encode(m), "bbox": [1.0, 2.0, 20.0, 10.0]})
        anns.append({"id": 10 * i + 1, "image_id": i, "category_id": 3, "iscrowd": 0,
                     "segmentation": [[3.0, 3.0, 30.0, 4.0, 20.0, 30.0]]})
        anns.append({"id": 10 * i + 2, "image_id": i, "category_id": 1, "iscrowd": 1,
                     "segmentation": jrle.encode(m)})
    path = str(tmp_path / "coco.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1}, {"id": 3}]}, f)
    for cmap in (None, {1: 7, 3: 2}):
        got = tds.load_coco_json_as_pseudo_videos(path, str(tmp_path), cmap)
        assert got == jds.load_coco_json_as_pseudo_videos(path, str(tmp_path), cmap)
    pipe = dict(min_sizes=[40, 48], max_size=80, rotation=True, crop_enabled=True,
                crop_type="absolute_range", crop_size=(24, 36))
    tmap = tds.ClipMapper(taug.AugmentationPipeline(**pipe), 3, pseudo=True)
    jmap = jds.ClipMapper(jaug.AugmentationPipeline(**pipe), 3, pseudo=True)
    for i, rec in enumerate(got):
        ts = tmap(rec, np.random.default_rng(i))
        js = jmap(rec, np.random.default_rng(i))
        for k in ("images", "labels", "ids", "boxes", "masks"):
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def test_builtin_registry_matches_jax():
    from mdqe_cvpr2023_tpu.data import builtin as jb
    from mdqe_cvpr2023_tpu.data import categories as jc
    from mdqe_cvpr2023_tpu_torch.data import builtin as tb
    from mdqe_cvpr2023_tpu_torch.data import categories as tc
    assert tb.DATASET_SPLITS == jb.DATASET_SPLITS
    assert tb.CATEGORY_MAPS == jb.CATEGORY_MAPS
    for name in ("COCO_TO_YTVIS_2019", "COCO_TO_YTVIS_2021", "COCO_TO_OVIS",
                 "OVIS_CATEGORIES"):
        assert getattr(tc, name) == getattr(jc, name)
