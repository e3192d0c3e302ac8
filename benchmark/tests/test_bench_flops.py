"""``benchmark/flops.py`` against ``torch.utils.flop_counter`` on the plain
reference at a tiny size, the deformable attention's sampling (and Swin
v2's position-bias MLP, counted there once a call) added by hand."""
from __future__ import annotations

import pytest
import torch
from bench_tiny import SEED, tiny_cell
from torch.utils.flop_counter import FlopCounterMode

import flops
from benchlib import common, manifest, weights


def _model(cell):
    from reference.models import detr as rdetr, swin as rswin
    m = rdetr.MDQEModel(common.model_cfg(cell.config, rdetr, rswin), device="cpu")
    weights.load(m, weights.make_weights(weights.param_shapes(m), cell.config["model"], 3, "cpu"))
    return m


def _sampling(model, n_tokens, queries, T, L):
    d, H = model["hidden_dim"], model["n_heads"]
    return 8.0 * (d // H) * H * (n_tokens * L * model["enc_points"] if queries is None
                                 else queries * L * model["dec_points"] * T)


@pytest.mark.parametrize("name", ["r50_ovis360.vis_crowded", "swinl_ovis.vis"])
def test_vis_encode_and_decode(name):
    from reference.models import meta as rmeta
    cell = tiny_cell(name)
    model = cell.config["model"]
    m = _model(cell)
    H, W = cell.config["test_size"]
    T, F = 2, 4
    frames = torch.randint(0, 255, (F, H, W, 3), dtype=torch.uint8)
    sizes = torch.tensor([[H, W]] * F, dtype=torch.int32)
    shapes = rmeta.spatial_shapes_for(m.cfg, (H, W))
    mean, std = torch.tensor([120.0, 110, 100]), torch.tensor([58.0, 57, 57])
    fc = FlopCounterMode(display=False)
    with fc, torch.no_grad():
        enc, mfl, mfe = rmeta.encode_window(m.detr, frames, sizes, mean, std, shapes,
                                            rmeta.encode_params(m.detr, "bf16"))
    L, nl = model["n_feature_levels"], model["enc_layers"]
    N = sum(h * w for h, w in shapes)
    frozen, rest = flops.encode_frame(model, H, W)
    cpb = 0.0
    if "swin" in model:
        sw = model["swin"]
        for i, depth in enumerate(sw["depths"]):
            win = sw["window_size"] // 2 if i == len(sw["depths"]) - 1 else sw["window_size"]
            cpb += depth * 2.0 * (2 * win - 1) ** 2 * 512 * (2 + sw["num_heads"][i])
    mine = F * (frozen + rest - nl * _sampling(model, N, None, 1, L)
                + flops.mask_head_frame(model, H, W)) + cpb
    assert mine == pytest.approx(fc.get_total_flops(), rel=1e-9)

    inf = common.inference_cfg(cell.config, "off", rmeta.InferenceCfg)
    fc = FlopCounterMode(display=False)
    with fc, torch.no_grad():
        rmeta.decode_clips_batched(m, enc, mfl, mfe, [0, 1], shapes, T, 0.0, inf.clip_topk, 2.0)
    Q, nf = model["n_query"], model["n_frames"]
    samp = model["dec_layers"] * (_sampling(model, 0, Q, T, L) + _sampling(model, 0, Q, nf, L))
    mine = 2 * (flops.decoder_clip(model, T, H, W) - samp + flops.postprocess_clip(model, T, H, W))
    assert mine == pytest.approx(fc.get_total_flops(), rel=1e-9)


def test_training_forward():
    cell = tiny_cell("r50_ovis360.train")
    cfg, model = cell.config, cell.config["model"]
    kind = manifest.kind_module(cell)
    ctx = common.Ctx(cell=cell, seed=SEED, seconds=0, trace=False, device="cpu")
    rmodel, _, rcrit, rtrain, _ = kind._reference(ctx)
    pool, schedule = kind.make_pool(ctx)
    b, k = schedule(0)
    hw = cfg["train"]["buckets"][b]
    fc = FlopCounterMode(display=False)
    with fc, torch.no_grad():
        rtrain.loss_fn(rmodel, rcrit, pool[(b, k)], torch.Generator().manual_seed(1), 0.1)
    clips, T = cfg["IMS_PER_BATCH"], cfg["train"]["n_frames"]
    L = model["n_feature_levels"]
    N = sum(h * w for h, w in flops._levels(model, *hw))
    samp = clips * T * model["enc_layers"] * _sampling(model, N, None, 1, L) \
        + clips * model["dec_layers"] * (_sampling(model, 0, model["n_query"], T, L)
                                         + _sampling(model, 0, model["n_query"],
                                                     model["n_frames"], L))
    mine = sum(flops.train_forward(cfg, hw)) - samp
    # the criterion's few small products (the reid and semantic losses) are not counted
    assert mine == pytest.approx(fc.get_total_flops(), rel=1e-4)
    assert mine <= fc.get_total_flops()


def test_full_size_orders_of_magnitude():
    """The published geometry: ~3.2 TFLOP of bf16 encode a 36-frame R50 video,
    ~26 TFLOP a Swin-L one, 3.4-4.3 TFLOP a training step."""
    r50 = manifest.load_cell("r50_ovis360.vis_crowded").config
    swl = manifest.load_cell("swinl_ovis.vis").config

    class Inf:
        clip_stride = 1

    Inf.n_frames_test = 4
    v = flops.vis_video(r50, Inf, 36, (384, 640))
    assert 3.0e12 < v["bf16"] < 3.5e12 and 1.5e12 < v["fp32"] < 2.5e12
    Inf.n_frames_test = 2
    assert 24e12 < flops.vis_video(swl, Inf, 36, (480, 864))["bf16"] < 28e12
    for hw in r50["train"]["buckets"]:
        assert 3.0e12 < flops.train_step(r50, hw)["fp32"] < 4.5e12
