"""The port's engine against the JAX package's, on the CPU: configs (every
``configs/*.yaml``) and the ``build_*_cfg`` mappings, the frozen set at each
FREEZE_AT, temporal inflation, ``.pth`` loading, and the Trainer: checkpoint
restore failure modes, the tiny end-to-end run (train, save, test with AP,
restore), exact resume and the CLI."""
import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu.engine import build as jbuild
from mdqe_cvpr2023_tpu.engine import checkpoint as jckpt
from mdqe_cvpr2023_tpu.engine import config as jconfig
from mdqe_cvpr2023_tpu_torch.data import ytvis_eval as teval
from mdqe_cvpr2023_tpu_torch.engine import build as tbuild
from mdqe_cvpr2023_tpu_torch.engine import checkpoint as tckpt
from mdqe_cvpr2023_tpu_torch.engine import config as tconfig
from mdqe_cvpr2023_tpu_torch.engine.trainer import Trainer
from mdqe_cvpr2023_tpu_torch.engine.weights import jax_tree_to_state_dict, load_jax_params
from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg, is_frozen
from synth_dataset import TINY_OVERRIDES, build_mini_dataset

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_and_builds_match_jax(path):
    got, want = tconfig.load_config(path), jconfig.load_config(path)
    assert got == want
    got.merge_from_list(TINY_OVERRIDES)
    want.merge_from_list(TINY_OVERRIDES)
    assert got == want
    for name in ("build_criterion_cfg", "build_train_cfg", "build_inference_cfg"):
        t = dataclasses.asdict(getattr(tbuild, name)(got))
        j = dataclasses.asdict(getattr(jbuild, name)(want))
        assert t == {k: v for k, v in j.items() if k in t}, name
        assert set(j) - set(t) <= {"detections_per_image"}, name
    t = dataclasses.asdict(tbuild.build_model_cfg(got))
    j = dataclasses.asdict(jbuild.build_model_cfg(want))
    assert t == j  # the SwinCfg too, field by field
    assert (j["swin"] is None) == ("swin" not in os.path.basename(path))


@pytest.mark.parametrize("name", ["swinl_ovis", "swinl_coco"])
@pytest.mark.parametrize("backbone_name", ["build_swinv2_backbone", "build_swin_backbone"])
def test_swin_model_cfg_matches_jax_and_configs(name, backbone_name):
    """The Swin branch of build_model_cfg: MODEL.SWIN.TYPE selects the preset
    name, v2 only for a backbone name holding "swinv2", the SwinCfg from
    MODEL.SWIN (DROP_PATH_RATE 0.2 and PRETRAIN_IMG_SIZE 384 by default); the
    yaml's own backbone name gives the port's hand-read configs."""
    from mdqe_cvpr2023_tpu_torch import configs
    path = os.path.join(ROOT, "configs", f"{name}.yaml")
    opts = ["MODEL.BACKBONE.NAME", backbone_name]
    got = tbuild.build_model_cfg(tconfig.load_config(path, opts))
    want = jbuild.build_model_cfg(jconfig.load_config(path, opts))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.backbone == "swin_large" and got.swin.version == (2 if "v2" in backbone_name else 1)
    assert (got.swin.drop_path_rate, got.swin.pretrain_img_size, got.swin.ape) == \
        (0.2, 384, False)
    assert got.backbone_channels == want.backbone_channels == (384, 768, 1536)
    if "v2" in backbone_name:
        assert got == {"swinl_ovis": configs.SWINL_OVIS, "swinl_coco": configs.SWINL_COCO}[name]
    if name == "swinl_ovis":
        inf = tbuild.build_inference_cfg(tconfig.load_config(path))
        assert inf == configs.SWINL_OVIS_INF
        assert (inf.n_frames_test, inf.n_frames_window_test, inf.clip_topk,
                inf.max_num_instances, inf.apply_cls_thres) == (2, 20, 150, 120, 0.1)
        assert tconfig.load_config(path).INPUT.MIN_SIZE_TEST == 480


def test_merge_from_list_rejects_bad_overrides():
    cfg = tconfig.get_default_config()
    with pytest.raises(KeyError, match="unknown config key"):
        cfg.merge_from_list(["MODEL.NOPE", "1"])
    with pytest.raises(ValueError, match="KEY VALUE"):
        cfg.merge_from_list(["SEED"])
    cfg.merge_from_list(["SEED", "3", "INPUT.MIN_SIZE_TRAIN", "[64, 96]"])
    assert cfg.SEED == 3 and cfg.INPUT.MIN_SIZE_TRAIN == [64, 96]


# ---------------------------------------------------------------------------
# frozen set, inflation, .pth loading
# ---------------------------------------------------------------------------

TINY8 = dict(backbone="resnet50", num_classes=3, hidden_dim=64, n_heads=8, enc_layers=1,
             dec_layers=1, n_frames=2, n_query=16, query_embed_dim=8, dec_temporal=True)


@pytest.fixture(scope="module")
def tiny_model():
    return MDQEModel(MDQEModelCfg(**TINY8), device="cpu", seed=5)


@pytest.mark.parametrize("freeze_at", [-1, 0, 1, 2, 5])
def test_frozen_set_matches_jax(tiny_model, freeze_at):
    from mdqe_cvpr2023_tpu.parallel.train import frozen_leaf_mask
    tree = jckpt.convert_torch_state_dict(
        {k: v.numpy() for k, v in tiny_model.state_dict().items()})
    mask = jax_tree_to_state_dict(jax.tree.map(np.asarray, frozen_leaf_mask(tree, freeze_at)))
    params = dict(tiny_model.named_parameters())
    want = {k for k, v in mask.items() if bool(v) and k in params}
    assert {k for k in params if is_frozen(k, freeze_at)} == want
    # every leaf the JAX mask freezes that is no parameter here is a buffer
    assert {k for k, v in mask.items() if bool(v)} - want <= {
        k for k, _ in tiny_model.named_buffers()}


SWIN_TINY = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16), window_size=4)


@pytest.fixture(scope="module")
def swin_model():
    from mdqe_cvpr2023_tpu_torch.models.swin import SwinCfg
    return MDQEModel(MDQEModelCfg(**dict(TINY8, backbone="swin_tiny",
                                         swin=SwinCfg(**SWIN_TINY))), device="cpu", seed=5)


@pytest.mark.parametrize("freeze_at", [0, 2, 5])
def test_swin_frozen_set_matches_jax(swin_model, freeze_at):
    """frozen_leaf_mask freezes no Swin leaf at any FREEZE_AT, and neither
    does the port: every backbone parameter trains."""
    from mdqe_cvpr2023_tpu.parallel.train import frozen_leaf_mask
    tree = jckpt.convert_torch_state_dict(
        {k: v.numpy() for k, v in swin_model.state_dict().items()})
    mask = jax_tree_to_state_dict(jax.tree.map(np.asarray, frozen_leaf_mask(tree, freeze_at)))
    backbone = [k for k, _ in swin_model.named_parameters()
                if k.startswith("detr.backbone.")]
    assert len(backbone) > 100
    assert not any(bool(mask[k]) or is_frozen(k, freeze_at) for k in backbone)


@pytest.mark.parametrize("wrap", [False, True])
def test_swin_checkpoint_loads_as_jax(swin_model, tmp_path, wrap):
    """A Swin .pth as the reference saves it: the model's state plus the
    window attention's relative_position_index / relative_coords_table
    buffers (recomputed, never loaded), optionally under {"model": ...}. The
    port's load_torch_checkpoint + merge_state_dict fills every entry of a
    fresh model exactly as JAX load_torch_checkpoint + load_jax_params."""
    sd = dict(swin_model.state_dict())
    for i in range(4):
        for j in range(2):
            blk = f"detr.backbone.0.backbone.layers.{i}.blocks.{j}.attn."
            sd[blk + "relative_position_index"] = torch.arange(16 * 16).reshape(16, 16)
            sd[blk + "relative_coords_table"] = torch.rand(1, 7, 7, 2)
    path = str(tmp_path / "swin.pth")
    torch.save({"model": sd} if wrap else sd, path)
    got = tckpt.load_torch_checkpoint(path)
    assert set(got) == set(swin_model.state_dict())
    target = MDQEModel(swin_model.cfg, device="cpu", seed=7)
    assert set(tckpt.merge_state_dict(target, got)) == set(target.state_dict())
    ref = MDQEModel(swin_model.cfg, device="cpu", seed=8)
    load_jax_params(ref, jckpt.load_torch_checkpoint(path))
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(target.state_dict()[k], v, rtol=0, atol=0)
        torch.testing.assert_close(v, swin_model.state_dict()[k], rtol=0, atol=0)


@pytest.mark.parametrize("f_pre,f_tgt", [(4, 4), (1, 4), (2, 5), (3, 2)])
def test_inflate_temporal_weights_matches_jax(tiny_model, f_pre, f_tgt):
    rng = np.random.default_rng(f_pre * 10 + f_tgt)
    H, K, D = 8, 4, 2
    state = {
        "detr.transformer_dec.decoder.layers.0.temp_attn_inst.attention_weights.weight":
            rng.standard_normal((H * f_pre * K, 16)).astype(np.float32),
        "detr.transformer_dec.decoder.layers.0.temp_attn_inst.sampling_grid_offsets.bias":
            rng.standard_normal((H * f_pre * K * D,)).astype(np.float32),
        "detr.transformer_dec.decoder.layers.0.temp_attn_inst.sampling_offsets":
            rng.standard_normal((1, 1, H, f_pre, K, 2)).astype(np.float32),
        "detr.transformer_dec.decoder.layers.0.temp_attn_inst.lvl_spatial_scales":
            rng.standard_normal((f_pre, 2)).astype(np.float32),
        "detr.transformer_dec.temp_embed.weight":
            rng.standard_normal((f_pre, 16)).astype(np.float32),
        "detr.input_proj.0.0.weight": rng.standard_normal((3, 2)).astype(np.float32),
    }
    got = tckpt.inflate_temporal_weights(state, f_pre, f_tgt)
    want = jckpt.inflate_temporal_weights(state, f_pre, f_tgt)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("f_tgt", [2, 4])
def test_load_torch_checkpoint_matches_jax(tiny_model, tmp_path, wrap, f_tgt):
    sd = tiny_model.state_dict()
    sd = dict(sd, **{"criterion.empty_weight": torch.ones(4), "pixel_mean": torch.zeros(3)})
    path = str(tmp_path / "w.pth")
    torch.save({"model": sd, "iteration": 9} if wrap else sd, path)
    got = tckpt.load_torch_checkpoint(path, f_pretrain=2, f_target=f_tgt)
    tree = jckpt.load_torch_checkpoint(path, f_pretrain=2, f_target=f_tgt)
    want = jax_tree_to_state_dict(jax.tree.map(np.asarray, tree))
    assert set(got) == set(want) == set(tiny_model.state_dict())
    for k, v in want.items():
        assert got[k].dtype == (torch.float32 if np.issubdtype(v.dtype, np.floating)
                                else got[k].dtype)
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    target = MDQEModel(dataclasses.replace(MDQEModelCfg(**TINY8), n_frames=f_tgt),
                       device="cpu", seed=7)
    copied = tckpt.merge_state_dict(target, got)
    assert set(copied) == set(target.state_dict())  # the inflated shapes fit
    if f_tgt == 2:
        ref = MDQEModel(MDQEModelCfg(**TINY8), device="cpu", seed=8)
        load_jax_params(ref, tree)
        for k, v in ref.state_dict().items():
            torch.testing.assert_close(target.state_dict()[k], v, rtol=0, atol=0)


def test_merge_state_dict_keeps_init_on_missing_and_mismatch(tiny_model, capsys):
    model = MDQEModel(MDQEModelCfg(**TINY8), device="cpu", seed=9)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    src = dict(tiny_model.state_dict())
    cls = "detr.input_proj.1.0.weight"
    src[cls] = torch.zeros(7, 7)
    gone = "detr.input_proj.0.0.bias"
    del src[gone]
    src["extra.key"] = torch.zeros(2)
    copied = tckpt.merge_state_dict(model, src)
    assert cls not in copied and gone not in copied and "extra.key" not in copied
    assert "shape mismatch" in capsys.readouterr().out
    out = model.state_dict()
    torch.testing.assert_close(out[cls], init[cls], rtol=0, atol=0)
    torch.testing.assert_close(out[gone], init[gone], rtol=0, atol=0)
    k = "detr.input_proj.0.0.weight"
    torch.testing.assert_close(out[k], tiny_model.state_dict()[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mini_dataset(tmp_path_factory):
    return build_mini_dataset(tmp_path_factory.mktemp("ds"))


def tiny_cfg(out_dir, num_classes=1, workers=0, extra=()):
    cfg = tconfig.load_config(os.path.join(ROOT, "configs", "R50_ovis_360.yaml"))
    overrides = [x for x in TINY_OVERRIDES]
    overrides[overrides.index("MODEL.MDQE.NUM_CLASSES") + 1] = str(num_classes)
    cfg.merge_from_list(overrides + [
        "SOLVER.IMS_PER_BATCH", "2", "SOLVER.CHECKPOINT_PERIOD", "1000",
        "TEST.EVAL_PERIOD", "0", "DATALOADER.NUM_WORKERS", str(workers),
        "OUTPUT_DIR", str(out_dir), *extra])
    return cfg


def test_mismatched_checkpoint_raises(tmp_path):
    t_a = Trainer(tiny_cfg(tmp_path / "a", num_classes=5), device="cpu")
    t_a.iteration = 3
    ckpt = t_a.save_checkpoint()
    assert ckpt.endswith("ckpt_0000003.pth") and os.path.exists(ckpt)
    t_b = Trainer(tiny_cfg(tmp_path / "b", num_classes=3), device="cpu")
    with pytest.raises(RuntimeError, match="params_only"):
        t_b.load_checkpoint(ckpt)
    with pytest.raises(ValueError, match="shape"):  # names the entry
        t_b.load_checkpoint(ckpt, params_only=True)


def test_params_only_checkpoint(tmp_path, capsys):
    t_a = Trainer(tiny_cfg(tmp_path / "a"), device="cpu")
    legacy = str(tmp_path / "legacy.pth")
    torch.save({"model": t_a.model.state_dict(), "iteration": 7}, legacy)
    t_b = Trainer(tiny_cfg(tmp_path / "b", extra=("SEED", "1")), device="cpu")
    with pytest.raises(RuntimeError, match="params_only"):
        t_b.load_checkpoint(legacy)
    t_b.load_checkpoint(legacy, params_only=True)
    assert "RE-INITIALIZED" in capsys.readouterr().out
    assert t_b.iteration == 7 and t_b.optimizer.step_count == 0
    assert not t_b.optimizer.adamw.state  # a fresh AdamW
    for k, v in t_a.model.state_dict().items():
        torch.testing.assert_close(t_b.model.state_dict()[k], v, rtol=0, atol=0)


def test_corrupted_checkpoint_raises(tmp_path):
    t = Trainer(tiny_cfg(tmp_path / "a"), device="cpu")
    bad = tmp_path / "bad.pth"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        t.load_checkpoint(str(bad))
    torch.save({"weights": 1}, str(tmp_path / "nomodel.pth"))
    with pytest.raises(ValueError, match="'model'"):
        t.load_checkpoint(str(tmp_path / "nomodel.pth"), params_only=True)


def test_trainer_amp_trains_saves_and_resumes(mini_dataset, tmp_path):
    """SOLVER.AMP.ENABLED True: the Trainer runs the mixed-precision step
    (``train_cfg.amp`` reaches ``make_train_step``), 2 iterations with
    finite losses; its checkpoint holds fp32 parameters and AdamW moments;
    a new Trainer resumed from it restores them exactly and takes a third
    AMP step."""
    cfg = tiny_cfg(tmp_path / "amp", extra=("SOLVER.AMP.ENABLED", "True"))
    trainer = Trainer(cfg, datasets_root=str(mini_dataset), device="cpu")
    assert trainer.train_cfg.amp
    trainer.train(max_iter=2, log_every=1)
    rows = [json.loads(line) for line in open(tmp_path / "amp" / "metrics.jsonl")]
    assert [r["iteration"] for r in rows] == [1, 2]
    assert all(np.isfinite(r[k]) for r in rows for k in ("total_loss", "loss_mask", "loss_dice"))
    ckpt = torch.load(str(tmp_path / "amp" / "ckpt_0000002.pth"), weights_only=True)
    assert all(v.dtype == torch.float32 for v in ckpt["model"].values()
               if v.is_floating_point())
    moments = [s for st in ckpt["optimizer"]["state"].values() for k, s in st.items()
               if k in ("exp_avg", "exp_avg_sq")]
    assert moments and all(m.dtype == torch.float32 for m in moments)
    resumed = Trainer(cfg, datasets_root=str(mini_dataset), device="cpu")
    resumed.load_checkpoint(str(tmp_path / "amp" / "ckpt_0000002.pth"))
    assert resumed.iteration == 2 and resumed.optimizer.step_count == 2
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v, rtol=0, atol=0)
    resumed.train(max_iter=3, log_every=1)
    assert resumed.iteration == 3
    assert all(p.dtype == torch.float32 for p in resumed.model.parameters())
    row = [json.loads(line) for line in open(tmp_path / "amp" / "metrics.jsonl")][-1]
    assert row["iteration"] == 3 and np.isfinite(row["total_loss"])


def test_trainer_end_to_end(mini_dataset, tmp_path, monkeypatch):
    from mdqe_cvpr2023_tpu.data.ytvis_eval import YTVISEvaluator as JaxEvaluator
    cfg = tiny_cfg(tmp_path / "out", workers=2)
    trainer = Trainer(cfg, datasets_root=str(mini_dataset), device="cpu")
    trainer.train(max_iter=2, log_every=1)
    assert trainer.iteration == 2 and trainer.optimizer.step_count == 2
    rows = [json.loads(l) for l in open(tmp_path / "out" / "metrics.jsonl")]
    assert [r["iteration"] for r in rows] == [1, 2]
    for key in ("total_loss", "sec_per_iter", "data_wait_sec_per_iter", "data_wait_frac",
                "loss_cls", "loss_mask", "loss_dice"):
        assert all(np.isfinite(r[key]) for r in rows), key
    assert rows[0]["msda_launches"] == {d: {"encoder": 0, "decoder_box": 0, "decoder_inst": 0}
                                        for d in ("fwd", "bwd", "bwd_bf16")}
    ckpts = sorted(glob.glob(str(tmp_path / "out" / "ckpt_*.pth")))
    assert [os.path.basename(p) for p in ckpts] == ["ckpt_0000002.pth"]

    metrics, preds = trainer.test(max_videos=1)
    assert metrics is not None and 0.0 <= metrics["AP"] <= 100.0
    assert preds and all(p["category_id"] == 1 and p["video_id"] == 1 for p in preds)
    assert all(len(p["segmentations"]) == 6 for p in preds)
    assert trainer.test_stats["clips"] == 5
    row = [json.loads(l) for l in open(tmp_path / "out" / "metrics.jsonl")][-1]
    assert row["test"] == "ytvis_ovis_dev" and row["clips"] == 5 and row["AP"] == metrics["AP"]
    assert row["rle_s"] >= 0 and row["evaluate_s"] > 0 and row["clips_per_s"] > 0
    # the CPU runs the plain version: no kernel launches
    assert all(n == 0 for d in row["msda_launches"].values() for n in d.values())
    with open(tmp_path / "out" / "results_ytvis_ovis_dev.json") as f:
        assert json.load(f) == preds
    gt = json.load(open(os.path.join(mini_dataset, "ovis", "valid_sub.json")))
    gt = dict(gt, videos=gt["videos"][:1])
    from test_torch_data import assert_metrics_equal
    assert_metrics_equal(teval.YTVISEvaluator(gt).evaluate(preds),
                         JaxEvaluator(gt).evaluate(preds))

    trainer2 = Trainer(cfg, datasets_root=str(mini_dataset), device="cpu")
    trainer2.load_checkpoint(ckpts[-1])
    assert trainer2.iteration == 2 and trainer2.optimizer.step_count == 2
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(trainer2.model.state_dict()[k], v, rtol=0, atol=0)


def test_resume_equals_unbroken_run(mini_dataset, tmp_path):
    """2 iterations, a checkpoint, a new Trainer resumed from it and 1 more
    iteration: the same parameters (within 1e-6) and AdamW moments as 3
    iterations unbroken. Dropout is on, so the per-iteration draws replay."""
    cfg = tiny_cfg(tmp_path / "a", extra=("SOLVER.WARMUP_ITERS", "2"))
    unbroken = Trainer(cfg, datasets_root=str(mini_dataset), device="cpu")
    unbroken.train(max_iter=3, log_every=100)
    cfg_b = tiny_cfg(tmp_path / "b", extra=("SOLVER.WARMUP_ITERS", "2"))
    first = Trainer(cfg_b, datasets_root=str(mini_dataset), device="cpu")
    first.train(max_iter=2, log_every=100)
    resumed = Trainer(cfg_b, datasets_root=str(mini_dataset), device="cpu")
    resumed.load_checkpoint(str(tmp_path / "b" / "ckpt_0000002.pth"))
    resumed.train(max_iter=3, log_every=100)
    assert resumed.iteration == unbroken.iteration == 3
    assert resumed.optimizer.step_count == unbroken.optimizer.step_count == 3
    want = unbroken.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=1e-6, msg=k)
    for p, q in zip(resumed.optimizer.params, unbroken.optimizer.params):
        for m in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(resumed.optimizer.adamw.state[p][m],
                                       unbroken.optimizer.adamw.state[q][m],
                                       rtol=0, atol=1e-6)


def test_cli_main(mini_dataset, tmp_path):
    from mdqe_cvpr2023_tpu_torch import train_net
    base = ["--config-file", os.path.join(ROOT, "configs", "R50_ovis_360.yaml"),
            "--datasets-root", str(mini_dataset), "--max-videos", "1", "--device", "cpu"]
    opts = TINY_OVERRIDES + ["SOLVER.IMS_PER_BATCH", "2", "TEST.EVAL_PERIOD", "0",
                             "DATALOADER.NUM_WORKERS", "0", "OUTPUT_DIR", str(tmp_path)]
    trainer, metrics = train_net.main(base + ["--max-iter", "1"] + opts)
    assert trainer.iteration == 1 and metrics is not None
    assert os.path.exists(tmp_path / "ckpt_0000001.pth")
    trainer, metrics = train_net.main(
        base + ["--eval-only", "--resume", str(tmp_path / "ckpt_0000001.pth")] + opts)
    assert trainer.iteration == 1 and metrics is not None


def test_cli_swinl_ovis_trains_and_tests(mini_dataset, tmp_path):
    """train_net with configs/swinl_ovis.yaml (its Swin cut to a tiny width)
    runs 2 iterations, saves and tests on the CPU."""
    from mdqe_cvpr2023_tpu_torch import train_net
    swin = ["MODEL.SWIN.EMBED_DIM", "32", "MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]",
            "MODEL.SWIN.NUM_HEADS", "[2, 4, 8, 16]", "MODEL.SWIN.WINDOW_SIZE", "4"]
    opts = TINY_OVERRIDES + swin + ["SOLVER.IMS_PER_BATCH", "2", "TEST.EVAL_PERIOD", "0",
                                    "DATALOADER.NUM_WORKERS", "0", "OUTPUT_DIR", str(tmp_path)]
    trainer, metrics = train_net.main(
        ["--config-file", os.path.join(ROOT, "configs", "swinl_ovis.yaml"), "--datasets-root",
         str(mini_dataset), "--max-videos", "1", "--device", "cpu", "--max-iter", "2",
         "--log-every", "1"] + opts)
    assert trainer.model_cfg.backbone == "swin_large" and trainer.model_cfg.swin.version == 2
    assert trainer.model_cfg.swin.drop_path_rate == 0.2
    assert trainer.iteration == 2 and os.path.exists(tmp_path / "ckpt_0000002.pth")
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["iteration"] for r in rows if "test" not in r] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in rows if "test" not in r)
    assert metrics is not None and 0.0 <= metrics["AP"] <= 100.0
