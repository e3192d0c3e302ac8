"""The port's ``inference_vis`` with windows finalized early under
``slab_hbm_budget`` against the benchmark's plain reference
(``benchmark/reference/models/meta.py::inference_vis``), which keeps every
window's slab to the video's end: a tiny R50-shaped model, 16:9 frames of
50x89 (a width that is not a multiple of 8, as 640x1138 is not), 5-frame
windows and a video of six windows. Under a budget of four slabs the port
finalizes the two oldest windows early, as the 720p configuration's two-GiB
budget does one window of five; under the default budget it finalizes none.
Either way the results agree with the reference within the limits of the
benchmark's cell ``r50_ovis720.vis_long``, and the eviction counters count
the windows, the live rows and the packed bytes finalized early."""
import copy
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from benchlib import common, manifest, weights  # noqa: E402
from reference.models import detr as rdetr  # noqa: E402
from reference.models import meta as rmeta  # noqa: E402
from reference.models import swin as rswin  # noqa: E402

from mdqe_cvpr2023_tpu_torch.models import detr, meta, swin  # noqa: E402
from mdqe_cvpr2023_tpu_torch.utils import tracing  # noqa: E402

torch.set_num_threads(2)

CELL = "r50_ovis720.vis_long"
SIZE = (50, 89)        # 16:9 as Detectron2 rounds it (50 x 16/9 = 88.9)
FRAMES = 28            # clips of 2 frames at stride 1: windows of 5, six of them
SLABS_KEPT = 4         # the 720p configuration's keep_slabs
SEED = 2 ** 31 + 29


def _config():
    cfg = copy.deepcopy(json.loads((BENCH / "configs" / "r50_ovis720.json").read_text()))
    cfg["model"].update(hidden_dim=64, n_heads=8, enc_layers=1, dec_layers=1, n_query=16,
                        query_embed_dim=8, num_classes=3, n_frames=2)
    cfg["inference"].update(n_frames_test=2, n_frames_window_test=5, max_num_instances=6,
                            clip_topk=8, encode_chunk=5, num_classes=3)
    return cfg


def _video():
    rng = np.random.default_rng(19)
    base = rng.integers(0, 255, (1, SIZE[0], SIZE[1], 3)).astype(np.int16)
    drift = rng.integers(-12, 12, (FRAMES, SIZE[0], SIZE[1], 3)).astype(np.int16)
    return meta.preprocess_frames(np.clip(base + drift, 0, 255).astype(np.uint8))[0]


def _slab_bytes(inf, frames):
    """A window's average slab: (M + 1, W + T, h4, w4) fp32."""
    shapes = meta.spatial_shapes_for(common.model_cfg(_config(), detr, swin), frames.shape[1:3])
    mem = inf.n_frames_window_test + inf.n_frames_test
    return 4 * (inf.max_num_instances + 1) * mem * (2 * shapes[0][0]) * (2 * shapes[0][1])


@pytest.fixture(scope="module")
def models():
    cfg = _config()
    port = detr.MDQEModel(common.model_cfg(cfg, detr, swin), device="cpu", seed=0)
    w = weights.make_weights(weights.param_shapes(port), cfg["model"], SEED, "cpu")
    weights.load(port, w)
    ref = rdetr.MDQEModel(common.model_cfg(cfg, rdetr, rswin), device="cpu")
    weights.load(ref, w)
    return port, ref


@pytest.mark.parametrize("evicting", [True, False], ids=["budget_evicts", "budget_holds"])
def test_evicted_port_agrees_with_the_unevicted_reference(models, monkeypatch, evicting):
    vis_stream = manifest.kind_module(manifest.load_cell(CELL))
    port, ref = models
    cfg = _config()
    inf = common.inference_cfg(cfg, "off", meta.InferenceCfg)
    rinf = common.inference_cfg(cfg, "off", rmeta.InferenceCfg)
    frames = _video()
    if evicting:
        inf = dataclasses.replace(inf, slab_hbm_budget=SLABS_KEPT * _slab_bytes(inf, frames))
    finalized, averaged = [], []
    orig, orig_avg = meta._finalize_live, meta.tracker_window_average

    def spy(avg, n, len_frames, *a, **k):
        finalized.append((n, len_frames))
        return orig(avg, n, len_frames, *a, **k)

    def avg_spy(*a, **k):
        averaged.append(1)
        return orig_avg(*a, **k)
    monkeypatch.setattr(meta, "_finalize_live", spy)
    monkeypatch.setattr(meta, "tracker_window_average", avg_spy)

    got = meta.inference_vis(port, inf, frames, SIZE, SIZE, device="cpu")
    req = tracing.last("vis.video")
    want = rmeta.inference_vis(ref, rinf, frames, SIZE, SIZE,
                               extra_rows=2 * len(got["pred_scores"]))

    windows = len(averaged)     # the tracker's windows, each averaged once
    assert windows == 6
    assert len(finalized) == (windows - SLABS_KEPT if evicting else 0)
    if evicting:
        oh, ow = SIZE
        rows = sum(n for n, _ in finalized)
        assert rows > 0
        assert req.counters["vis.evict_windows"] == len(finalized)
        assert req.counters["vis.evict_rows"] == rows
        assert req.counters["vis.evict_bytes"] == sum(n * f * oh * -(-ow // 8)
                                                      for n, f in finalized)
    else:
        assert not {"vis.evict_windows", "vis.evict_rows", "vis.evict_bytes"} & set(req.counters)

    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    gaps = vis_stream.compare_video(got, want, "cpu")
    assert gaps["score_gap"] <= limits["score_gap"], gaps
    assert gaps["mask_gap"] <= limits["mask_gap"], gaps
    assert got["pred_labels"] == want["pred_labels"]
    assert len(got["pred_masks"]) == len(want["pred_masks"])
    for a, b in zip(got["pred_masks"], want["pred_masks"]):
        assert a.shape == (FRAMES,) + SIZE
        np.testing.assert_array_equal(a, b)
