"""The port's model tools and figures against the repository's JAX-side tools
(``tools/*.py``) and ``utils/plot.py``, on the CPU: dataset conversion,
weight conversion, parameter counts and FLOPs, the parity runner's ``diff``
(report and exit code) and ``run``, and the figures' data."""
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu.models import MDQEModelCfg as JaxModelCfg
from mdqe_cvpr2023_tpu.models import detr_init
from mdqe_cvpr2023_tpu.models import swin as jswin
from mdqe_cvpr2023_tpu.models.detr import detr_apply_backbone as jax_apply_backbone
from mdqe_cvpr2023_tpu_torch.data import rle
from mdqe_cvpr2023_tpu_torch.engine import config as tconfig
from mdqe_cvpr2023_tpu_torch.engine.checkpoint import load_torch_checkpoint
from mdqe_cvpr2023_tpu_torch.engine.trainer import Trainer
from mdqe_cvpr2023_tpu_torch.models import swin as tswin
from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg
from mdqe_cvpr2023_tpu_torch.tools import (analyze_model, convert_dataset, convert_weights,
                                           eval_parity)
from synth_dataset import TINY_OVERRIDES, build_mini_dataset

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """A script of the repository's ``tools/``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    try:
        return mod.main()
    except SystemExit as e:
        return e.code


# ---------------------------------------------------------------------------
# convert_dataset
# ---------------------------------------------------------------------------

def _coco_json(path):
    rng = np.random.default_rng(0)
    cats = [1, 2, 3, 5, 7, 18, 44, 90]
    images = [{"id": i, "file_name": f"{i}.jpg", "height": 10, "width": 12} for i in range(12)]
    anns = [{"id": k, "image_id": int(rng.integers(0, 12)), "category_id": int(rng.choice(cats)),
             "bbox": [1, 2, 3, 4], "area": 12, "iscrowd": 0} for k in range(40)]
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": c, "name": str(c)} for c in cats]}))
    return str(path)


def _vis_json(path):
    rng = np.random.default_rng(1)
    videos = [{"id": v, "file_names": [f"{v}/0.jpg"], "height": 10, "width": 12, "length": 1}
              for v in range(1, 31)]
    anns = [{"id": k, "video_id": int(rng.integers(1, 29)), "category_id": int(rng.integers(1, 5)),
             "segmentations": [None], "bboxes": [None], "areas": [None], "iscrowd": 0}
            for k in range(50)]
    path.write_text(json.dumps({"videos": videos, "annotations": anns,
                                "categories": [{"id": c, "name": str(c)} for c in range(1, 5)]}))
    return str(path)


@pytest.mark.parametrize("target", ["ytvis19", "ytvis21", "ovis"])
def test_coco2vis_matches_jax(tmp_path, target):
    src = _coco_json(tmp_path / "coco.json")
    convert_dataset.coco2vis(src, target, str(tmp_path / "ours.json"))
    _jax_tool("convert_dataset").coco2vis(src, target, str(tmp_path / "theirs.json"))
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()
    assert json.loads((tmp_path / "ours.json").read_text())["annotations"]


@pytest.mark.parametrize("ratio,seed", [(0.1, 0), (0.3, 5)])
def test_split_matches_jax(tmp_path, ratio, seed):
    src = _vis_json(tmp_path / "train.json")
    convert_dataset.main(["split", "--train-json", src, "--out-dir", str(tmp_path / "ours"),
                          "--ratio", str(ratio), "--seed", str(seed)])
    _jax_tool("convert_dataset").split(src, str(tmp_path / "theirs"), ratio, seed)
    for name in ("train_sub.json", "valid_sub.json"):
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes(), name


# ---------------------------------------------------------------------------
# convert_weights
# ---------------------------------------------------------------------------

TINY = dict(backbone="resnet50", num_classes=3, hidden_dim=64, n_heads=8, enc_layers=1,
            dec_layers=1, n_frames=1, n_query=16, query_embed_dim=8, dec_temporal=True)


@pytest.mark.parametrize("wrap", [True, False], ids=["model_key", "flat"])
def test_inflate_matches_jax(tmp_path, monkeypatch, wrap):
    state = MDQEModel(MDQEModelCfg(**TINY), device="cpu", seed=1).state_dict()
    for name, d in (("ours", tmp_path / "ours"), ("theirs", tmp_path / "theirs")):
        d.mkdir()
        torch.save({"model": state} if wrap else state, d / "m.pth")
    path = convert_weights.main(["inflate", "--source", str(tmp_path / "ours" / "m.pth"),
                                 "--num-frames", "4"])
    _run_jax_main(_jax_tool("convert_weights"),
                  ["inflate", "--source", str(tmp_path / "theirs" / "m.pth"),
                   "--num-frames", "4"], monkeypatch)
    got = torch.load(path, weights_only=False)
    want = torch.load(tmp_path / "theirs" / "m_inflated_to_f4.pth", weights_only=False)
    assert path.endswith("m_inflated_to_f4.pth") and got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    inflated = [k for k in got if got[k].shape != state[k].shape]
    assert inflated  # the temporal weights grew from 1 to 4 frames
    loaded = load_torch_checkpoint(path)
    assert all(torch.equal(loaded[k], got[k].float()) for k in loaded)


def test_to_d2_matches_jax(tmp_path, monkeypatch):
    state = {"layers.0.blocks.0.attn.qkv.weight": torch.ones(6, 2),
             "patch_embed.proj.bias": torch.arange(3.0)}
    for d in ("ours", "theirs"):
        (tmp_path / d).mkdir()
        torch.save({"model": state}, tmp_path / d / "swin.pth")
    path = convert_weights.main(["to-d2", "--source", str(tmp_path / "ours" / "swin.pth")])
    _run_jax_main(_jax_tool("convert_weights"),
                  ["to-d2", "--source", str(tmp_path / "theirs" / "swin.pth")], monkeypatch)
    got = torch.load(path, weights_only=False)
    want = torch.load(tmp_path / "theirs" / "swin_d2.pth", weights_only=False)
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# analyze_model
# ---------------------------------------------------------------------------

R50 = dict(backbone="resnet50", num_classes=25, hidden_dim=256, n_heads=8, enc_layers=6,
           dec_layers=6, n_frames=4, n_query=196, query_embed_dim=64, dec_temporal=True)


@pytest.mark.parametrize("backbone", ["resnet50", "swin_tiny"])
def test_parameter_counts_match_jax(backbone):
    """Totals and per-group counts of the state dict equal the JAX tool's
    ``count_params(detr_init(...))``; R50 at the published widths and the
    Swin-T preset (v2)."""
    kw = dict(R50, backbone=backbone)
    jkw = dict(kw)
    if backbone.startswith("swin"):
        kw["swin"] = tswin.SWIN_PRESETS["tiny"]
        jkw["swin"] = jswin.SWIN_PRESETS["tiny"]
    tree = jax.eval_shape(lambda k: detr_init(k, JaxModelCfg(**jkw)), jax.random.PRNGKey(0))
    want_total, want_rows = _jax_tool("analyze_model").count_params(tree)
    want_groups = {}
    for name, _, n in want_rows:
        want_groups[name.split(".")[0]] = want_groups.get(name.split(".")[0], 0) + n
    total, rows = analyze_model.count_params(MDQEModel(MDQEModelCfg(**kw), device="cpu"))
    assert total == want_total
    assert analyze_model.group_counts(rows) == want_groups
    assert set(want_groups) == {"backbone", "input_proj", "transformer_enc",
                                "transformer_dec"}


def test_forward_flops_against_xla_cost_analysis():
    """At 2 x 64 x 96 on the tiny model the port's count is within 12% of
    XLA's cost analysis of the same JAX forward (every output kept, so XLA
    prunes nothing). The two count differently: FlopCounterMode counts the
    full kernel window of a convolution at every output, XLA leaves out the
    taps that fall on padding (at 64 x 96 the backbone's late maps are a few
    pixels wide, so the port counts about 10% more there); XLA also counts
    elementwise work, norms and softmaxes, which FlopCounterMode does not;
    and the deformable-attention sampling is the port's analytic 8 x D a
    point (exactly the hooked calls' shapes) against XLA's count of the
    gather formulation."""
    kw = dict(TINY, num_classes=5, n_heads=4, n_frames=2)
    model = MDQEModel(MDQEModelCfg(**kw), device="cpu", seed=0)
    got = analyze_model.forward_flops(model, 2, 64, 96)
    cfg = model.cfg
    levels = [-(-64 // s) * -(-96 // s) for s in (8, 16, 32, 64)]
    D = cfg.hidden_dim // cfg.n_heads
    enc = 2 * sum(levels) * cfg.n_heads * 4 * 4 * 8 * D       # B=2 frames, Q=N
    box = 2 * cfg.n_query * cfg.n_heads * 4 * 4 * 8 * D        # B=2 frames
    temporal = 4 * cfg.n_query * cfg.n_heads * 2 * 4 * 8 * D   # 4 levels, 2 frames
    assert got["sampling"] == enc + box + temporal
    assert got["msda_calls"] == 6 and got["total"] == got["counted"] + got["sampling"]

    jcfg = JaxModelCfg(**kw)
    params = detr_init(jax.random.PRNGKey(0), jcfg)
    images = jnp.zeros((2, 64, 96, 3), jnp.float32)
    sizes = jnp.asarray([[64, 96]] * 2, jnp.int32)
    fwd = lambda p, i, s: jax_apply_backbone(p, jcfg, i, s, n_frames=2, training=False)
    cost = jax.jit(fwd).lower(params, images, sizes).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    assert abs(got["total"] / cost["flops"] - 1.0) <= 0.12, (got, cost["flops"])


def test_analyze_model_cli(capsys):
    res = analyze_model.main(["--config-file", os.path.join(ROOT, "configs", "R50_ovis_360.yaml"),
                              "--tasks", "parameter", "structure", "--device", "cpu",
                              *TINY_OVERRIDES])
    out = capsys.readouterr().out
    assert f"total parameters: {res['total'] / 1e6:.2f}M" in out
    assert "detr.transformer_enc.level_embed" in out
    assert sum(res["groups"].values()) == res["total"]


# ---------------------------------------------------------------------------
# eval_parity
# ---------------------------------------------------------------------------

def _track(mask, cat=2, score=0.9, vid=1, frames=2):
    return {"video_id": vid, "category_id": cat, "score": score,
            "segmentations": [rle.encode(mask)] * frames}


def _box(y0, y1, x0, x1):
    m = np.zeros((10, 12), bool)
    m[y0:y1, x0:x1] = True
    return m


DIFF_CASES = {
    "identical": ([_track(_box(2, 7, 3, 9))], [_track(_box(2, 7, 3, 9))]),
    "unmatched": ([_track(_box(2, 7, 3, 9))], [_track(_box(0, 2, 0, 2))]),
    "category_mismatch": ([_track(_box(2, 7, 3, 9))], [_track(_box(2, 7, 3, 9), cat=3)]),
    "shifted_with_gt": ([_track(_box(2, 7, 3, 9), score=0.8), _track(_box(0, 3, 0, 4), vid=2)],
                        [_track(_box(2, 7, 4, 9), score=0.7), _track(_box(0, 3, 0, 4), vid=2)]),
}


@pytest.mark.parametrize("case", list(DIFF_CASES))
def test_eval_parity_diff_matches_jax(case, tmp_path, monkeypatch, capsys):
    """tests/test_eval_parity_tool.py's diff cases and one with a ground truth
    (AP on both sides): the same report and exit code as the JAX tool."""
    a, b = DIFF_CASES[case]
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    argv = ["diff", str(pa), str(pb), "--per-video"]
    if case == "shifted_with_gt":
        gt = {"videos": [{"id": v, "file_names": ["f0", "f1"], "height": 10, "width": 12,
                          "length": 2} for v in (1, 2)],
              "annotations": [{"id": v, "video_id": v, "category_id": 2, "iscrowd": 0,
                               "segmentations": t["segmentations"], "areas": [1, 1],
                               "bboxes": [[0, 0, 1, 1]] * 2}
                              for v, t in ((1, a[0]), (2, a[1]))],
              "categories": [{"id": 2, "name": "x"}]}
        (tmp_path / "gt.json").write_text(json.dumps(gt))
        argv += ["--gt", str(tmp_path / "gt.json")]
    with pytest.raises(SystemExit) as got_exit:
        eval_parity.main(argv)
    got = json.loads(capsys.readouterr().out)
    want_code = _run_jax_main(_jax_tool("eval_parity"), argv, monkeypatch)
    want = json.loads(capsys.readouterr().out)
    assert got == want
    assert got_exit.value.code == want_code == (0 if case == "identical" else 1)
    if case == "shifted_with_gt":  # matched, but the AP moved by more than 0.3
        assert got["matched_tracks"] == 2 and abs(got["AP_a"] - got["AP_b"]) > 0.3


def test_eval_parity_run_equals_trainer_test(tmp_path):
    """``run`` on the synthetic dataset with the tiny config on the CPU writes
    results_<dataset>.json, equal to ``Trainer.test``'s predictions on the
    same (seed 0) weights."""
    ds = build_mini_dataset(tmp_path / "ds")
    opts = TINY_OVERRIDES + ["MODEL.MDQE.APPLY_CLS_THRES", "0.0"]
    config = os.path.join(ROOT, "configs", "R50_ovis_360.yaml")
    with pytest.raises(SystemExit) as code:
        eval_parity.main(["run", "--config", config, "--dataset", "ytvis_ovis_dev",
                          "--datasets-root", ds, "--output", str(tmp_path / "out"),
                          "--max-videos", "1", "--device", "cpu", *opts])
    assert code.value.code == 0
    got = json.loads((tmp_path / "out" / "results_ytvis_ovis_dev.json").read_text())
    cfg = tconfig.load_config(config, opts + ["OUTPUT_DIR", str(tmp_path / "ref")])
    _, want = Trainer(cfg, datasets_root=ds, device="cpu").test("ytvis_ovis_dev", max_videos=1)
    assert got and got == want


# ---------------------------------------------------------------------------
# utils/plot.py
# ---------------------------------------------------------------------------

def _jax_plot():
    from mdqe_cvpr2023_tpu.utils import plot
    return plot


def _axes_data(fig):
    """Per axis: its lines' (x, y), scatter offsets and image arrays."""
    out = []
    for ax in fig.axes:
        out.append(([np.asarray(l.get_xydata()) for l in ax.get_lines()],
                    [np.asarray(c.get_offsets()) for c in ax.collections],
                    [np.asarray(im.get_array()) for im in ax.get_images()]))
    return out


def _assert_same_figure(got, want):
    g, w = _axes_data(got), _axes_data(want)
    assert len(g) == len(w)
    for (gl, gc, gi), (wl, wc, wi) in zip(g, w):
        for a, b in zip((gl, gc, gi), (wl, wc, wi)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_plots_match_jax(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt
    from mdqe_cvpr2023_tpu_torch.utils import plot
    jplot = _jax_plot()
    rng = np.random.default_rng(0)
    metrics = tmp_path / "metrics.jsonl"
    metrics.write_text("".join(json.dumps({"iteration": i, "total_loss": float(v),
                                           "loss_ce": float(v) / 2}) + "\n"
                               for i, v in enumerate(rng.random(6))))
    image = rng.integers(0, 255, (40, 60, 3)).astype(np.uint8)
    proto = rng.standard_normal((12, 14, 8)).astype(np.float32)
    coords = rng.random((16, 2)).astype(np.float32)
    ref = rng.random((5, 2)).astype(np.float32)
    locs = rng.random((5, 4, 3, 2, 2)).astype(np.float32)
    pairs = [
        (plot.plot_training_curves(str(metrics), ("total_loss", "loss_ce")),
         jplot.plot_training_curves(str(metrics), ("total_loss", "loss_ce"))),
        (plot.plot_mask_features(torch.from_numpy(proto), n=5),
         jplot.plot_mask_features(proto, n=5)),
        (plot.plot_query_init(torch.from_numpy(image), torch.from_numpy(coords)),
         jplot.plot_query_init(image, coords)),
        (plot.plot_sampling_locations(image, torch.from_numpy(ref), torch.from_numpy(locs),
                                      query_idx=2, out_path=str(tmp_path / "s.png")),
         jplot.plot_sampling_locations(image, ref, locs, query_idx=2)),
    ]
    for got, want in pairs:
        _assert_same_figure(got, want)
        plt.close(got)
        plt.close(want)
    assert (tmp_path / "s.png").stat().st_size > 0
